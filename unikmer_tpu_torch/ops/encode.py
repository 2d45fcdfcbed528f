"""K1: fused 2-bit ingress unpack + window encode + canonical + keying.

The port of unikmer_tpu/ops/pallas_encode.py (``encode_canonical_pallas``)
together with the device unpack of unikmer_tpu/models/count.py:278.  It
reads the host 2-bit pack directly (``packed2``: base j at bits
2*(j%4) of byte j//4; ``validmask``: bit j%8 of byte j//8) and returns,
for every window [i, i+k):

  keyed  int64 [n]  u64 code (first base in the top group; the canonical
                    min when asked), or CODE_SENTINEL (-1) where invalid
  valid  uint8 [n]  1 when all k bases are valid and i <= n-k

On a CUDA tensor :func:`encode_2bit` launches the kernel of
csrc/encode.cu or raises; on a CPU tensor it runs the plain version
:func:`encode_2bit_plain` (unpack + kmer_codes + window_valid +
canonical_code + where).
"""

from __future__ import annotations

from .. import _kernels
from .._lazy import torch
from . import codec
from .codec import INVALID_BASE


def unpack_bases_2bit(packed2: torch.Tensor, validmask: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Inverse of the host 2-bit pack: uint8 base codes of length ``n``
    with INVALID_BASE on invalid slots."""
    shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=packed2.device)
    q = packed2.to(torch.int32)
    b = ((q[:, None] >> shifts[None, :]) & 3).reshape(-1)[:n]
    bits = torch.arange(8, dtype=torch.int32, device=validmask.device)
    m = validmask.to(torch.int32)
    v = ((m[:, None] >> bits[None, :]) & 1).reshape(-1)[:n].bool()
    return torch.where(v, b, int(INVALID_BASE)).to(torch.uint8)


def encode_2bit_plain(packed2: torch.Tensor, validmask: torch.Tensor, n: int,
                      k: int, canonical: bool):
    """Plain PyTorch version of K1: (keyed int64 [n], valid uint8 [n])."""
    bases = unpack_bases_2bit(packed2, validmask, n)
    code = codec.kmer_codes(bases, k)
    if canonical:
        code = codec.canonical_code(code, k)
    valid = codec.window_valid(bases, k)
    keyed = torch.where(valid, code, codec.SENTINEL)
    return keyed, valid.to(torch.uint8)


def _check_inputs(packed2, validmask, n: int, k: int,
                  max_k: int = codec.MAX_K_ENCODED) -> None:
    if not 0 < k <= max_k:
        raise ValueError(f"k must be in [1,{max_k}], got {k}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    for name, t, need in (("packed2", packed2, -(-n // 4)),
                          ("validmask", validmask, -(-n // 8))):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 tensor")
        if t.shape[0] < need:
            raise ValueError(f"{name} holds {t.shape[0]} bytes, needs {need}")
    if packed2.device != validmask.device:
        raise ValueError("packed2 and validmask must be on one device")


_ENCODE = _kernels.Kernel("ukt_encode_2bit")


def encode_2bit(packed2: torch.Tensor, validmask: torch.Tensor, n: int,
                k: int, canonical: bool):
    """K1 on CUDA tensors, its plain version on CPU tensors:
    (keyed int64 [n], valid uint8 [n])."""
    _check_inputs(packed2, validmask, n, k)
    dev = packed2.device
    if dev.type == "cpu":
        return encode_2bit_plain(packed2, validmask, n, k, canonical)
    packed2, validmask, keyed, valid = _launch_buffers("encode_2bit", packed2,
                                                       validmask, n)
    if n == 0:
        return keyed, valid
    _ENCODE(dev, packed2.data_ptr(), packed2.shape[0], validmask.data_ptr(),
            validmask.shape[0], n, k, int(bool(canonical)), keyed.data_ptr(),
            valid.data_ptr())
    encode_2bit.launches += 1
    return keyed, valid


encode_2bit.launches = 0


def _launch_buffers(name: str, packed2: torch.Tensor, validmask: torch.Tensor,
                    n: int):
    """(packed2, validmask, keyed, valid) for a launch of K1 or H1 on a
    CUDA device: the inputs on 16-byte boundaries (the kernels read
    16-byte words, so a view off one is cloned) and the empty outputs."""
    dev = packed2.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if packed2.data_ptr() % 16:
        packed2 = packed2.clone()
    if validmask.data_ptr() % 16:
        validmask = validmask.clone()
    return (packed2, validmask, torch.empty(n, dtype=torch.int64, device=dev),
            torch.empty(n, dtype=torch.uint8, device=dev))
