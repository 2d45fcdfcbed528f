"""ntHash v1 on PyTorch (port of unikmer_tpu/ops/nthash.py), and H1.

Behavior contract (reference: will-rowe/nthash v0.4.0, the Go port of
ntHash 1.0): for a k-mer s[0..k-1]

  forward  NTF64(s,k) = XOR_{j<k} rol64(seed[s[j]],   k-1-j)
  reverse  NTR64(s,k) = XOR_{j<k} rol64(seed[rc(s[j])],    j)
  canonical NTC64     = min(NTF64, NTR64)

with seeds seedA/C/G/T below and seed 0 for any other byte; k <= 64.

:func:`nthash_windows` hashes every window of a base tensor by the
JAX package's doubling composition (rotate-weighted XOR windows compose:
F_{a+b}[i] = rol(F_a[i], b) ^ F_b[i+a], R_{a+b}[i] = R_a[i] ^
rol(R_b[i+a], a)), on int64 bit patterns: ``>>`` is arithmetic there, so
rotations mask it (codec.shr), and the canonical min and the scaled
threshold compare in unsigned order (codec.ult).  The numpy twins and
:func:`nthash_kmer` are the host helpers of dump, encode and grep.

H1 (:func:`encode_nthash`, csrc/nthash.cu) is the counterpart of what
XLA fuses in the JAX count program: the 2-bit ingress unpack
(unikmer_tpu/models/count.py:278), ``nthash_windows`` and the scaled
threshold (:195-197), with the sentinel keying before the sort.  On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
the plain version :func:`encode_nthash_plain`.
"""

from __future__ import annotations

import numpy as np

from .. import _kernels
from .._lazy import torch
from . import codec
from .codec import (
    BASE_LUT, MAX_K_HASHED, SENTINEL, SIGN, shr, ult,
)
from .encode import _check_inputs, _launch_buffers, unpack_bases_2bit

SEED_A = np.uint64(0x3C8BFBB395C60474)
SEED_C = np.uint64(0x3193C18562A02B4C)
SEED_G = np.uint64(0x20323ED082572324)
SEED_T = np.uint64(0x295549F54BE24456)
SEED_N = np.uint64(0)

# Indexed by 2-bit base code (A,C,G,T); slot 4 = invalid/N -> 0.
_SEEDS_FWD = np.array([SEED_A, SEED_C, SEED_G, SEED_T, SEED_N], dtype=np.uint64)
# Complement seeds: rc(A)=T etc.; invalid complements to invalid.
_SEEDS_RC = np.array([SEED_T, SEED_G, SEED_C, SEED_A, SEED_N], dtype=np.uint64)

MAX_K = MAX_K_HASHED  # 64
MAX_HASH = (1 << 64) - 1  # max_hash of scale 1: every code kept


def _check_hash_k(k: int) -> None:
    if not 0 < k <= MAX_K:
        raise ValueError(f"k must be in [1,{MAX_K}], got {k}")


def _rol(x: torch.Tensor, s: int) -> torch.Tensor:
    """Rotate int64 bit patterns left by s (mod 64)."""
    s &= 63
    if s == 0:
        return x
    return (x << s) | shr(x, 64 - s)


def nthash_windows(bases: torch.Tensor, k: int,
                   canonical: bool) -> torch.Tensor:
    """ntHash of every window [i, i+k) of a uint8 base-code tensor, as
    int64 bit patterns of the same length.  Positions past len-k and
    windows over invalid bases (hashed with seed 0) are masked by the
    caller through codec.window_valid."""
    _check_hash_k(k)
    idx = torch.clamp(bases.to(torch.int64), max=4)
    f_pow = torch.from_numpy(_SEEDS_FWD.view(np.int64)).to(bases.device)[idx]
    r_pow = torch.from_numpy(_SEEDS_RC.view(np.int64)).to(bases.device)[idx]
    pow_w = 1
    f_acc = r_acc = None
    acc_w = 0
    for b in range(7):
        if (k >> b) & 1:
            if f_acc is None:
                f_acc, r_acc, acc_w = f_pow, r_pow, pow_w
            else:
                # new window: pow block (front, width pow_w) ++ acc (back)
                f_acc = _rol(f_pow, acc_w) ^ codec._shift_up(f_acc, pow_w)
                r_acc = r_pow ^ _rol(codec._shift_up(r_acc, pow_w), pow_w)
                acc_w += pow_w
        if (k >> (b + 1)) != 0:
            f_pow = _rol(f_pow, pow_w) ^ codec._shift_up(f_pow, pow_w)
            r_pow = r_pow ^ _rol(codec._shift_up(r_pow, pow_w), pow_w)
            pow_w *= 2
    if canonical:
        return torch.where(ult(r_acc, f_acc), r_acc, f_acc)
    return f_acc


def at_most(codes: torch.Tensor, max_hash: int) -> torch.Tensor:
    """codes <= max_hash in unsigned order: both sides moved by -2^63
    onto signed order (max_hash < 2^64 may exceed 2^63 - 1)."""
    return (codes ^ SIGN) <= max_hash - (1 << 63)


# ---------------------------------------------------------------------
# H1: fused 2-bit ingress unpack + ntHash + scaled threshold + keying


def encode_nthash_plain(packed2: torch.Tensor, validmask: torch.Tensor,
                        n: int, k: int, canonical: bool,
                        max_hash: int = MAX_HASH):
    """Plain PyTorch version of H1: (keyed int64 [n], valid uint8 [n]),
    a window valid when its k bases are and its code <= max_hash."""
    bases = unpack_bases_2bit(packed2, validmask, n)
    code = nthash_windows(bases, k, canonical)
    valid = codec.window_valid(bases, k)
    if max_hash != MAX_HASH:
        valid &= at_most(code, max_hash)
    keyed = torch.where(valid, code, SENTINEL)
    return keyed, valid.to(torch.uint8)


_ENCODE_NTHASH = _kernels.Kernel("ukt_encode_nthash")


def encode_nthash(packed2: torch.Tensor, validmask: torch.Tensor, n: int,
                  k: int, canonical: bool, max_hash: int = MAX_HASH):
    """H1 on CUDA tensors, its plain version on CPU tensors:
    (keyed int64 [n], valid uint8 [n])."""
    _check_inputs(packed2, validmask, n, k, MAX_K)
    if not 0 <= max_hash <= MAX_HASH:
        raise ValueError(f"max_hash must be in [0, 2^64), got {max_hash}")
    if packed2.device.type == "cpu":
        return encode_nthash_plain(packed2, validmask, n, k, canonical,
                                   max_hash)
    packed2, validmask, keyed, valid = _launch_buffers("encode_nthash",
                                                       packed2, validmask, n)
    if n == 0:
        return keyed, valid
    _ENCODE_NTHASH(packed2.device, packed2.data_ptr(), packed2.shape[0],
                   validmask.data_ptr(), validmask.shape[0], n, k,
                   int(bool(canonical)), max_hash, keyed.data_ptr(),
                   valid.data_ptr())
    encode_nthash.launches += 1
    return keyed, valid


encode_nthash.launches = 0


# ---------------------------------------------------------------------
# host helpers (numpy): the port's copy of the JAX package's


def _rol_np(x: np.ndarray, s: int) -> np.ndarray:
    s &= 63
    if s == 0:
        return x
    return (x << np.uint64(s)) | (x >> np.uint64(64 - s))


def _shift_up_np(x: np.ndarray, s: int) -> np.ndarray:
    if s == 0:
        return x
    out = np.zeros_like(x)
    out[:-s] = x[s:]
    return out


def nthash_windows_np(bases: np.ndarray, k: int, canonical: bool) -> np.ndarray:
    """Numpy twin of nthash_windows for host-side bulk paths (e.g. the
    dump command's -H re-hash), same doubling composition, bit-exact."""
    _check_hash_k(k)
    idx = np.minimum(np.asarray(bases), np.uint8(4)).astype(np.int32)
    f_pow = _SEEDS_FWD[idx]
    r_pow = _SEEDS_RC[idx]
    pow_w = 1
    f_acc = r_acc = None
    acc_w = 0
    for b in range(7):
        if (k >> b) & 1:
            if f_acc is None:
                f_acc, r_acc, acc_w = f_pow, r_pow, pow_w
            else:
                f_acc = _rol_np(f_pow, acc_w) ^ _shift_up_np(f_acc, pow_w)
                r_acc = r_pow ^ _rol_np(_shift_up_np(r_acc, pow_w), pow_w)
                acc_w += pow_w
        if (k >> (b + 1)) != 0:
            f_pow = _rol_np(f_pow, pow_w) ^ _shift_up_np(f_pow, pow_w)
            r_pow = r_pow ^ _rol_np(_shift_up_np(r_pow, pow_w), pow_w)
            pow_w *= 2
    if canonical:
        return np.minimum(f_acc, r_acc)
    return f_acc


def nthash_rows_np(rows: np.ndarray, canonical: bool) -> np.ndarray:
    """ntHash of each row of an (n, k) 2-bit base matrix (host-side)."""
    n, k = rows.shape
    flat = np.full((n, k + 1), 4, np.uint8)
    flat[:, :k] = rows
    hashes = nthash_windows_np(flat.reshape(-1), k, canonical)
    return hashes[:: k + 1][:n].copy()


def nthash_kmer(kmer: bytes | str, canonical: bool = False) -> int:
    """Host-side single k-mer ntHash (encode/dump commands)."""
    if isinstance(kmer, str):
        kmer = kmer.encode()
    k = len(kmer)
    b = np.minimum(BASE_LUT[np.frombuffer(kmer, dtype=np.uint8)], 4)
    f = np.uint64(0)
    r = np.uint64(0)
    for j in range(k):
        f ^= np.uint64(_rol_int(int(_SEEDS_FWD[b[j]]), k - 1 - j))
        r ^= np.uint64(_rol_int(int(_SEEDS_RC[b[j]]), j))
    if canonical:
        return int(min(f, r))
    return int(f)


def _rol_int(x: int, s: int) -> int:
    s &= 63
    return ((x << s) | (x >> (64 - s))) & 0xFFFFFFFFFFFFFFFF


def scaled_max_hash(scale: int) -> int:
    """maxHash = uint64(float64(MaxUint64) / float64(scale)).

    Matches Go's float math exactly (unikmer/cmd/count.go:98): the
    division is done in float64 and truncated toward zero.
    """
    if scale <= 1:
        return MAX_HASH
    f = np.float64(np.float64(18446744073709551615) / np.float64(scale))
    return min(int(f), MAX_HASH)
