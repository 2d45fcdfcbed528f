"""2-bit k-mer codec in plain PyTorch (device half of unikmer_tpu/ops/codec.py).

Same contract as the JAX module: bases A=0, C=1, G=2, T=3, any value
>= 4 is invalid; a k-mer's code packs its first base into the highest
2-bit group; canonical(code) = min(code, revcomp(code)); k <= 32.

Codes travel as int64 tensors holding u64 bit patterns: torch's uint64
lacks shifts and ordered compares.  Right shifts are arithmetic on
int64, so every one below is masked to make it logical, and unsigned
order is taken by flipping the sign bit (``SIGN``) before comparing.

These functions are the plain version of the K1 kernel
(ops/encode.py, csrc/encode.cu); ``seq_to_bases`` maps ASCII to base
codes on a device.  The host tables below (``BASE_LUT``,
``INVALID_BASE``, ``RECORD_SEP``, ``CODE_SENTINEL``, the k limits) and
the numpy helpers for text interop at the end (``max_code``, ``encode_kmer``,
``decode_codes``, ``decode_kmer``, ``bits_string``, ``revcomp_np``,
``canonical_np``: the encode/decode/view/dump/grep commands) are the
port's own copy of those of ``unikmer_tpu/ops/codec.py``.
"""

from __future__ import annotations

import numpy as np

from .._lazy import torch

# Invalid-base sentinel in base-code space (valid codes are 0..3).
INVALID_BASE = np.uint8(255)
# Distinct invalid value marking record boundaries in packed base
# buffers (io/fastx.pack_records); every value >= 4 is invalid to the
# window kernels.
RECORD_SEP = np.uint8(254)

MAX_K_ENCODED = 32
MAX_K_HASHED = 64


def max_code(k: int) -> int:
    """MaxCode[k] = 4^k - 1 (reference: kmers.MaxCode, cmd/decode.go:99-106)."""
    if not 0 < k <= MAX_K_ENCODED:
        raise ValueError(f"k must be in [1,{MAX_K_ENCODED}], got {k}")
    return (1 << (2 * k)) - 1


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
# 2-bit base code -> ASCII byte.
BASE_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)

# Sentinel code for masked-out slots in uint64 code space: all ones.
# Real codes are < 4^k <= 2^64, and hashes may be any uint64, so the
# sentinel is only used together with an explicit count or mask.
CODE_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
# CODE_SENTINEL as an int64 bit pattern.
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


def seq_to_bases(seq_ascii, device=None) -> torch.Tensor:
    """Map ASCII sequence bytes to 2-bit base codes (uint8; 255 =
    invalid).  ``seq_ascii`` is bytes, a numpy uint8 array or a uint8
    tensor; the codes lie on the tensor's device, else on ``device``
    (by default ``_device.get_device()``)."""
    if isinstance(seq_ascii, torch.Tensor):
        seq = seq_ascii.to(torch.uint8)
    else:
        from .._device import get_device

        arr = np.frombuffer(seq_ascii, np.uint8) if isinstance(
            seq_ascii, (bytes, bytearray, memoryview)) else seq_ascii
        seq = torch.from_numpy(np.array(arr, np.uint8)).to(
            get_device(device))
    lut = torch.from_numpy(BASE_LUT).to(seq.device)
    return lut[seq.long()]


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


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers for text interop: encode/decode of explicit
# k-mer strings.  These serve the encode/decode/view/dump/grep commands;
# the device path above never materializes strings.
# ---------------------------------------------------------------------------

_M2_NP = np.uint64(_M2)
_M4_NP = np.uint64(_M4)
_M8_NP = np.uint64(_M8)
_M16_NP = np.uint64(_M16)


def encode_kmer(kmer: bytes | str) -> int:
    """Encode one k-mer string to its code. Raises on invalid base."""
    if isinstance(kmer, str):
        kmer = kmer.encode()
    b = BASE_LUT[np.frombuffer(kmer, dtype=np.uint8)]
    if (b >= 4).any():
        bad = kmer[int(np.argmax(b >= 4))]
        raise ValueError(f"invalid DNA base {chr(bad)!r} in k-mer {kmer!r}")
    if len(kmer) > MAX_K_ENCODED:
        raise ValueError(f"k-mer longer than {MAX_K_ENCODED}: {len(kmer)}")
    code = 0
    for v in b:
        code = (code << 2) | int(v)
    return code


def decode_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """Decode uint64 codes to an (n, k) array of ASCII bytes, from the
    little-endian byte view with uint8 column ops only (no (n, k) uint64
    temporary)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint64).reshape(-1)
    byte_view = codes.view(np.uint8).reshape(-1, 8)  # little-endian
    n = len(codes)
    out = np.empty((n, k), np.uint8)
    for j in range(k):
        bit = 2 * (k - 1 - j)
        out[:, j] = (byte_view[:, bit >> 3] >> (bit & 7)) & 3
    return BASE_CHARS[out]


def decode_kmer(code: int, k: int) -> str:
    """Decode a single code to its k-mer string."""
    if code > max_code(k):
        raise ValueError(f"code {code} overflows k={k} (max {max_code(k)})")
    return decode_codes(np.array([code], dtype=np.uint64), k)[0].tobytes().decode()


def bits_string(code: int, k: int) -> str:
    """Bit representation grouped per base (reference: encode -a)."""
    s = format(code, f"0{2 * k}b")
    return " ".join(s[i : i + 2] for i in range(0, len(s), 2))


def revcomp_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Numpy twin of revcomp_code for host-side paths."""
    c = ~np.asarray(codes, dtype=np.uint64)
    c = ((c >> np.uint64(2)) & _M2_NP) | ((c & _M2_NP) << np.uint64(2))
    c = ((c >> np.uint64(4)) & _M4_NP) | ((c & _M4_NP) << np.uint64(4))
    c = ((c >> np.uint64(8)) & _M8_NP) | ((c & _M8_NP) << np.uint64(8))
    c = ((c >> np.uint64(16)) & _M16_NP) | ((c & _M16_NP) << np.uint64(16))
    c = (c >> np.uint64(32)) | (c << np.uint64(32))
    return c >> np.uint64(64 - 2 * k)


def canonical_np(codes: np.ndarray, k: int) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint64)
    return np.minimum(codes, revcomp_np(codes, k))
