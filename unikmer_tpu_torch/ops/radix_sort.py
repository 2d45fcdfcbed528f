"""K2 and K3: ascending sorts of u64 codes (int64 bit patterns).

K2 (:func:`radix_sort_u64`) is the port of unikmer_tpu/ops/pallas_sort.py
``sort_codes_pallas`` (:378), whose bitonic kernels reach
``pl.pallas_call`` through ``_block_call`` (:271): ``_sort_block_kernel``
(:235, looped :174) and ``_merge_block_kernel`` (:255, looped :211), keys
only.  K3 (:func:`radix_sort_kv_u64`) is the port of
``sort_codes_taxids_pallas`` (:399), the same network with a value plane
(``_exchange`` :104-125): (u64 key, u32 value) pairs sorted by key.

Both are onesweep LSD radix sorts over 8-bit digits (csrc/radix_sort.cu),
bound on the card by device memory: one read of the keys for every
pass's histogram, then per pass 16 B a key (read and write), 24 B a
pair.  :func:`_radix_passes` launches ``ukt_radix_upfront`` (the [P, 256]
histograms, their digit bases and a per-pass "one digit holds every key"
flag, read back in one small copy) and then ``ukt_radix_onesweep`` for
each pass that is not trivial: a tile of 4096 keys is ranked in shared
memory, takes its global offsets by a decoupled look-back over the
earlier tiles, and writes through a shared-memory stage so the stores
coalesce.  (The earlier design, a histogram launch and a ``torch.cumsum``
over a [256, tiles] table each pass and uncoalesced stores, is gone.)
Any length is taken; nothing is padded.  The passes are stable, so K3
keeps equal keys' values in input order (the TPU kernel did not).

``code_bits`` is the true width of the real codes (2k for 2-bit codes,
64 for hashed ones; not the TPU's rounded ``sort_code_bits``): with a
value below 64 every key must be < 2^code_bits or the all-ones
sentinel, and the sort then runs at most ceil((code_bits+1)/8) passes.

On a CUDA tensor each wrapper launches its kernels or raises; on a CPU
tensor it runs its plain version (:func:`sort_u64_plain`,
:func:`sort_kv_plain`).  Besides ``.launches``, each wrapper counts the
digit passes its launches ran (``.passes_run``) and skipped as trivial
(``.passes_skipped``).
"""

from __future__ import annotations

from .. import _kernels
from .._lazy import torch
from .codec import SIGN

RADIX_BITS = 8


def sort_u64_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: sort in unsigned order via the sign flip."""
    return torch.sort(keys ^ SIGN).values ^ SIGN


def sort_kv_plain(keys: torch.Tensor, values: torch.Tensor):
    """Plain PyTorch version of K3: a stable unsigned sort of the keys,
    the values gathered in the same order."""
    s, order = torch.sort(keys ^ SIGN, stable=True)
    return s ^ SIGN, values[order]


def radix_shifts(code_bits: int = 64) -> list[int]:
    """Bit offsets of the digit passes for keys of ``code_bits`` bits.
    Below 64 the sentinel is ranked as 2^code_bits, one more bit."""
    if not 1 <= code_bits <= 64:
        raise ValueError(f"code_bits must be in [1, 64], got {code_bits}")
    bits = min(code_bits + 1, 64) if code_bits < 64 else 64
    return list(range(0, bits, RADIX_BITS))


_TILE_KEYS = _kernels.Kernel("ukt_radix_tile")  # a query, not a launch
_UPFRONT = _kernels.Kernel("ukt_radix_upfront")
_ONESWEEP = _kernels.Kernel("ukt_radix_onesweep")


def _radix_passes(keys: torch.Tensor, values: torch.Tensor | None,
                  code_bits: int):
    """The onesweep passes on the card: (sorted keys, sorted values or
    None, passes run, passes skipped).  n >= 2; the outputs never alias
    the inputs."""
    n = keys.shape[0]
    dev = keys.device
    shifts = radix_shifts(code_bits)
    tiles = -(-n // _TILE_KEYS.bound()())
    hist = torch.empty(len(shifts) * 256, dtype=torch.int64, device=dev)
    bases = torch.empty_like(hist)
    trivial = torch.empty(len(shifts), dtype=torch.int32, device=dev)
    _UPFRONT(dev, keys.data_ptr(), n, len(shifts), code_bits, hist.data_ptr(),
             bases.data_ptr(), trivial.data_ptr())
    run = [p for p, t in enumerate(trivial.tolist()) if not t]
    if not run:  # every pass trivial: the input is already in order
        return (keys.clone(), None if values is None else values.clone(),
                0, len(shifts))
    # tile counter and look-back status words, zeroed by each pass
    scratch = torch.empty((tiles + 1) * 256, dtype=torch.int64, device=dev)
    kbufs = (torch.empty_like(keys), torch.empty_like(keys))
    vbufs = (None, None) if values is None else (
        torch.empty_like(values), torch.empty_like(values))
    src, vsrc = keys, values
    for i, p in enumerate(run):
        dst, vdst = kbufs[i % 2], vbufs[i % 2]
        _ONESWEEP(dev, src.data_ptr(), dst.data_ptr(),
                  None if vsrc is None else vsrc.data_ptr(),
                  None if vdst is None else vdst.data_ptr(), n, shifts[p],
                  code_bits, bases.data_ptr() + 8 * 256 * p,
                  scratch.data_ptr(), tiles)
        src, vsrc = dst, vdst
    return src, vsrc, len(run), len(shifts) - len(run)


def _check_device(name: str, dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def radix_sort_u64(keys: torch.Tensor, code_bits: int = 64) -> torch.Tensor:
    """K2: ascending unsigned sort of a 1-D int64 tensor of u64 bit
    patterns; returns a new tensor (the input is left as it is)."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("radix_sort_u64 takes a 1-D int64 tensor")
    radix_shifts(code_bits)  # raises on a bad code_bits
    _check_device("radix_sort_u64", keys.device)
    if keys.device.type == "cpu":
        return sort_u64_plain(keys)
    if keys.shape[0] <= 1:
        return keys.clone()
    out, _, ran, skipped = _radix_passes(keys.contiguous(), None, code_bits)
    radix_sort_u64.launches += 1
    radix_sort_u64.passes_run += ran
    radix_sort_u64.passes_skipped += skipped
    return out


radix_sort_u64.launches = 0
radix_sort_u64.passes_run = 0
radix_sort_u64.passes_skipped = 0


def radix_sort_kv_u64(keys: torch.Tensor, values: torch.Tensor,
                      code_bits: int = 64):
    """K3: (keys, values) sorted by ascending unsigned key, stably.
    ``keys`` is a 1-D int64 tensor of u64 bit patterns, ``values`` an
    int32 tensor of u32 bit patterns of the same length and device.
    Returns new tensors (the inputs are left as they are)."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("radix_sort_kv_u64 takes 1-D int64 keys")
    if values.dtype != torch.int32 or values.shape != keys.shape:
        raise ValueError("radix_sort_kv_u64 takes int32 values shaped "
                         "like the keys")
    if values.device != keys.device:
        raise ValueError("keys and values must be on one device")
    radix_shifts(code_bits)  # raises on a bad code_bits
    _check_device("radix_sort_kv_u64", keys.device)
    if keys.device.type == "cpu":
        return sort_kv_plain(keys, values)
    if keys.shape[0] <= 1:
        return keys.clone(), values.clone()
    ok, ov, ran, skipped = _radix_passes(keys.contiguous(),
                                         values.contiguous(), code_bits)
    radix_sort_kv_u64.launches += 1
    radix_sort_kv_u64.passes_run += ran
    radix_sort_kv_u64.passes_skipped += skipped
    return ok, ov


radix_sort_kv_u64.launches = 0
radix_sort_kv_u64.passes_run = 0
radix_sort_kv_u64.passes_skipped = 0
