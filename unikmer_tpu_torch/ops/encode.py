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

import torch

from .. import _kernels
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


def _check_inputs(packed2, validmask, n: int, k: int) -> None:
    codec._check_k(k)
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


def encode_2bit(packed2: torch.Tensor, validmask: torch.Tensor, n: int,
                k: int, canonical: bool):
    """K1 on CUDA tensors, its plain version on CPU tensors:
    (keyed int64 [n], valid uint8 [n])."""
    _check_inputs(packed2, validmask, n, k)
    dev = packed2.device
    if dev.type == "cpu":
        return encode_2bit_plain(packed2, validmask, n, k, canonical)
    if dev.type != "cuda":
        raise ValueError(f"encode_2bit: unsupported device {dev}")
    for name, t in (("packed2", packed2), ("validmask", validmask)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned")
    keyed = torch.empty(n, dtype=torch.int64, device=dev)
    valid = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return keyed, valid
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ukt_encode_2bit(
            packed2.data_ptr(), packed2.shape[0], validmask.data_ptr(),
            validmask.shape[0], n, k, int(bool(canonical)), keyed.data_ptr(),
            valid.data_ptr(), stream)
    _kernels.check(lib, err, "encode_2bit")
    encode_2bit.launches += 1
    return keyed, valid


encode_2bit.launches = 0
