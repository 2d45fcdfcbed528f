"""2-bit k-mer codec in plain PyTorch (device half of unikmer_tpu/ops/codec.py).

Same contract as the JAX module: bases A=0, C=1, G=2, T=3, any value
>= 4 is invalid; a k-mer's code packs its first base into the highest
2-bit group; canonical(code) = min(code, revcomp(code)); k <= 32.

Codes travel as int64 tensors holding u64 bit patterns: torch's uint64
lacks shifts and ordered compares.  Right shifts are arithmetic on
int64, so every one below is masked to make it logical, and unsigned
order is taken by flipping the sign bit (``SIGN``) before comparing.

These functions are the plain version of the K1 kernel
(ops/encode.py, csrc/encode.cu).  The host tables below (``BASE_LUT``,
``INVALID_BASE``, ``RECORD_SEP``, the k limits) are the port's own copy
of those of ``unikmer_tpu/ops/codec.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# Invalid-base sentinel in base-code space (valid codes are 0..3).
INVALID_BASE = np.uint8(255)
# Distinct invalid value marking record boundaries in packed base
# buffers (io/fastx.pack_records); every value >= 4 is invalid to the
# window kernels.
RECORD_SEP = np.uint8(254)

MAX_K_ENCODED = 32
MAX_K_HASHED = 64


def _build_base_lut() -> np.ndarray:
    lut = np.full(256, INVALID_BASE, dtype=np.uint8)
    for chars, code in (("Aa", 0), ("Cc", 1), ("Gg", 2), ("TtUu", 3)):
        for ch in chars:
            lut[ord(ch)] = code
    # '\n' is pack_records' record-separator join byte (it never occurs
    # inside a sequence line): it maps to RECORD_SEP
    lut[ord("\n")] = RECORD_SEP
    return lut


# ASCII byte -> 2-bit base code (255 = invalid).
BASE_LUT = _build_base_lut()

# CODE_SENTINEL (2^64-1) as an int64 bit pattern.
SENTINEL = -1
# Sign bit: x ^ SIGN maps unsigned order onto signed order.
SIGN = -(1 << 63)

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def _check_k(k: int) -> None:
    if not 0 < k <= MAX_K_ENCODED:
        raise ValueError(f"k must be in [1,{MAX_K_ENCODED}], got {k}")


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a static 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit integers."""
    return (a ^ SIGN) < (b ^ SIGN)


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[i] = x[i+s], zero-padded at the tail."""
    if s == 0:
        return x
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[s:], x.new_zeros(s)])


def kmer_codes(bases: torch.Tensor, k: int) -> torch.Tensor:
    """All sliding-window codes of a uint8 base-code tensor (int64 bit
    patterns).  Slot i holds window [i, i+k); slots past len-k and
    windows over invalid bases hold garbage that ``window_valid`` masks."""
    _check_k(k)
    x = bases.to(torch.int64) & 3
    acc = None
    acc_w = 0
    pow_codes = x
    pow_w = 1
    for b in range(6):
        if (k >> b) & 1:
            if acc is None:
                acc, acc_w = pow_codes, pow_w
            else:
                acc = (pow_codes << (2 * acc_w)) | _shift_up(acc, pow_w)
                acc_w += pow_w
        if (k >> (b + 1)) != 0:
            pow_codes = (pow_codes << (2 * pow_w)) | _shift_up(pow_codes, pow_w)
            pow_w *= 2
    return acc


def window_valid(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Bool mask: window [i, i+k) holds only valid bases and fits
    (k <= 64: the hashed windows share it)."""
    if not 0 < k <= MAX_K_HASHED:
        raise ValueError(f"k must be in [1,{MAX_K_HASHED}], got {k}")
    n = bases.shape[0]
    bad = (bases >= 4).to(torch.int32)
    prefix = torch.cat([bad.new_zeros(1), torch.cumsum(bad, 0, dtype=torch.int32)])
    ok = (prefix[k:] - prefix[: n + 1 - k]) == 0 if n >= k else prefix[:0] == 0
    return torch.cat([ok, ok.new_zeros(n - ok.shape[0])])


def revcomp_code(code: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2-bit codes (int64 bit patterns)."""
    _check_k(k)
    c = ~code
    c = (shr(c, 2) & _M2) | ((c & _M2) << 2)
    c = (shr(c, 4) & _M4) | ((c & _M4) << 4)
    c = (shr(c, 8) & _M8) | ((c & _M8) << 8)
    c = (shr(c, 16) & _M16) | ((c & _M16) << 16)
    c = (shr(c, 32) & _M32) | (c << 32)
    return shr(c, 64 - 2 * k)


def canonical_code(code: torch.Tensor, k: int) -> torch.Tensor:
    """min(code, revcomp(code)) in unsigned order."""
    rc = revcomp_code(code, k)
    return torch.where(ult(rc, code), rc, code)
