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
histograms, their digit bases and the pass plan, written on the card:
which passes run, since a pass whose keys share one digit changes
nothing, and which buffer each reads and writes) and then
``ukt_radix_onesweep``, which queues every pass: a pass the plan skips
returns at once, and a copy kernel fills the output when none runs.  A
tile of 4096 keys is ranked in shared memory, takes its global offsets
by a decoupled look-back over the earlier tiles, and writes through a
shared-memory stage so the stores coalesce.  Nothing is read back to
the host, so a call queues its work and returns without waiting on the
card.  (The earlier design, a histogram launch and a ``torch.cumsum``
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
digit passes its launches ran (``.passes_run``) and skipped
(``.passes_skipped``): the kernels add them to counters on the card,
which are read (a wait on the card) only when the attribute is read;
setting an attribute sets its count.
"""

from __future__ import annotations

import functools

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


class _SortEntry:
    """A sort wrapper: the function, ``.launches``, and ``.passes_run`` /
    ``.passes_skipped`` kept on the card (an int64 pair a device, added
    to by the plan's kernel) beside a host offset.  Reading a pass count
    waits on the card; setting one zeroes the device pairs without a
    wait."""

    def __init__(self, fn):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.launches = 0
        self._pairs: dict = {}  # device -> int64 [passes run, skipped]
        self._offset = [0, 0]

    def __call__(self, *args, **kwargs):
        return self._fn(self, *args, **kwargs)

    def pair(self, dev: torch.device) -> torch.Tensor:
        """The device counters of ``dev``, made zero at first use."""
        got = self._pairs.get(dev)
        if got is None:
            got = self._pairs[dev] = torch.zeros(2, dtype=torch.int64,
                                                 device=dev)
        return got

    def _read(self, i: int) -> int:
        return self._offset[i] + sum(int(p[i]) for p in self._pairs.values())

    def _set(self, i: int, value: int) -> None:
        for p in self._pairs.values():
            p[i].zero_()
        self._offset[i] = int(value)

    passes_run = property(lambda self: self._read(0),
                          lambda self, v: self._set(0, v))
    passes_skipped = property(lambda self: self._read(1),
                              lambda self, v: self._set(1, v))


def _radix_passes(keys: torch.Tensor, values: torch.Tensor | None,
                  code_bits: int, pair: torch.Tensor):
    """The onesweep passes on the card: (sorted keys, sorted values or
    None), the passes run and skipped added to ``pair``.  n >= 2; the
    outputs never alias the inputs.  Queues its kernels and returns."""
    n = keys.shape[0]
    dev = keys.device
    passes = len(radix_shifts(code_bits))
    tiles = -(-n // _TILE_KEYS.bound()())
    hist = torch.empty(passes * 256, dtype=torch.int64, device=dev)
    bases = torch.empty_like(hist)
    plan = torch.empty(passes + 1, dtype=torch.int32, device=dev)
    _UPFRONT(dev, keys.data_ptr(), n, passes, code_bits, hist.data_ptr(),
             bases.data_ptr(), plan.data_ptr(), pair.data_ptr())
    # tile counter and look-back status words, zeroed before each pass
    scratch = torch.empty((tiles + 1) * 256, dtype=torch.int64, device=dev)
    temp, out = torch.empty_like(keys), torch.empty_like(keys)
    vtemp = vout = None
    if values is not None:
        vtemp, vout = torch.empty_like(values), torch.empty_like(values)
    _ONESWEEP(dev, keys.data_ptr(), temp.data_ptr(), out.data_ptr(),
              None if values is None else values.data_ptr(),
              None if vtemp is None else vtemp.data_ptr(),
              None if vout is None else vout.data_ptr(), n, passes,
              code_bits, bases.data_ptr(), plan.data_ptr(),
              scratch.data_ptr(), tiles)
    return out, vout


def _check_device(name: str, dev: torch.device) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


@_SortEntry
def radix_sort_u64(self, keys: torch.Tensor,
                   code_bits: int = 64) -> torch.Tensor:
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
    out, _ = _radix_passes(keys.contiguous(), None, code_bits,
                           self.pair(keys.device))
    self.launches += 1
    return out


@_SortEntry
def radix_sort_kv_u64(self, keys: torch.Tensor, values: torch.Tensor,
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
    out = _radix_passes(keys.contiguous(), values.contiguous(), code_bits,
                        self.pair(keys.device))
    self.launches += 1
    return out
