"""The plain reference's k-mer encoders, in plain PyTorch, written from
their definitions (no kernel, library or module of the program).

A FASTA file's records are read as bytes and mapped to base codes (A, C,
G, T -> 0, 1, 2, 3, either case; any other byte -> 4, invalid).  A
window of k bases is a k-mer when all its bases are valid; windows never
span records.

2-bit codes (k <= 32): the forward code of bases b_0..b_{k-1} is
sum_j b_j * 4^(k-1-j) (the first base in the high bits), its reverse
complement's sum_j (3 - b_j) * 4^j, the canonical code the smaller.

ntHash v1 (k <= 64): with the 64-bit seeds h(A), h(C), h(G), h(T) and
rol(x, s) the left rotation by s bits, the forward hash is
XOR_j rol(h(b_j), k-1-j), the reverse complement's XOR_j rol(h(comp
b_j), j), the canonical hash the smaller (as unsigned 64-bit numbers).

All windows are computed at once by doubling: the code of a window of
a + L bases at i joins the code of the a bases at i with the code of the
L bases at i + a, so a k-mer takes O(log k) tensor passes.

Codes are u64 values held as int64 bit patterns.  Sets are held
*flipped* (``code ^ 2^63``), so that torch's signed order is the codes'
unsigned order; :func:`unflip` turns them back.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -(1 << 63)  # 2^63 as an int64 bit pattern
NTHASH_SEEDS = (0x3C8BFBB395C60474, 0x3193C18562A02B4C,
                0x20323ED082572324, 0x295549F54BE24456)

_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _LUT[_c] = _i
    _LUT[_c + 32] = _i  # lower case


def _i64(u: int) -> int:
    """A u64 value as the int64 with its bit pattern."""
    return u - (1 << 64) if u >= 1 << 63 else u


def unflip(t: torch.Tensor) -> np.ndarray:
    """A flipped int64 tensor of codes as a numpy uint64 array."""
    return (t ^ SIGN).cpu().numpy().view(np.uint64)


def read_fasta(path: str, device) -> list[torch.Tensor]:
    """The base codes (uint8) of each record of a plain FASTA file."""
    with open(path, "rb") as f:
        data = f.read()
    lut = torch.from_numpy(_LUT).to(device)
    out = []
    for chunk in data.split(b"\n>"):
        start = chunk.find(b"\n")
        if start < 0:
            continue
        raw = torch.frombuffer(bytearray(chunk[start + 1:]), dtype=torch.uint8)
        raw = raw.to(device)
        raw = raw[(raw != ord("\n")) & (raw != ord("\r"))]
        out.append(lut[raw.long()])
    return out


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rol(x: torch.Tensor, s: int) -> torch.Tensor:
    s %= 64
    if s == 0:
        return x
    return (x << s) | _shr(x, 64 - s)


def _valid_windows(bases: torch.Tensor, k: int) -> torch.Tensor:
    """Whether each of the len - k + 1 windows holds only valid bases."""
    bad = torch.cumsum((bases >= 4).to(torch.int64), 0)
    bad = torch.cat([bad.new_zeros(1), bad])
    return (bad[k:] - bad[:-k]) == 0


def _doubling(first: torch.Tensor, k: int, join) -> torch.Tensor:
    """Codes of every window of k elements, from the 1-element codes
    ``first`` and ``join(left, a, right, L)``, the code of a window of
    a + L elements from its left a-element and right L-element parts."""
    powers = {1: first}
    length = 1
    while length * 2 <= k:
        p = powers[length]
        powers[length * 2] = join(p[:-length], length, p[length:], length)
        length *= 2
    acc, a = None, 0
    for length in sorted(powers, reverse=True):
        if not k & length:
            continue
        part = powers[length]
        if acc is None:
            acc, a = part, length
            continue
        n = min(acc.shape[0], part.shape[0] - a)
        acc = join(acc[:n], a, part[a:a + n], length)
        a += length
    return acc


def _umin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The smaller of two int64 bit patterns as unsigned numbers."""
    return torch.minimum(x ^ SIGN, y ^ SIGN) ^ SIGN


def kmer_codes(bases: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """The 2-bit codes of every valid window of one record."""
    if not 1 <= k <= 32:
        raise ValueError("2-bit codes need 1 <= k <= 32")
    if bases.shape[0] < k:
        return bases.new_zeros(0, dtype=torch.int64)
    b = torch.where(bases < 4, bases, 0).to(torch.int64)
    out = _doubling(b, k, lambda x, a, y, L: (x << (2 * L)) | y)
    if canonical:
        rc = _doubling(3 - b, k, lambda x, a, y, L: x | (y << (2 * a)))
        out = _umin(out, rc)
    return out[_valid_windows(bases, k)]


def nthash_codes(bases: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """The ntHash v1 hashes of every valid window of one record."""
    if not 1 <= k <= 64:
        raise ValueError("ntHash needs 1 <= k <= 64")
    if bases.shape[0] < k:
        return bases.new_zeros(0, dtype=torch.int64)
    seeds = torch.tensor([_i64(s) for s in NTHASH_SEEDS], dtype=torch.int64,
                         device=bases.device)
    idx = torch.where(bases < 4, bases, 0).long()
    out = _doubling(seeds[idx], k, lambda x, a, y, L: _rol(x, L) ^ y)
    if canonical:
        rc = _doubling(seeds[3 - idx], k, lambda x, a, y, L: x ^ _rol(y, a))
        out = _umin(out, rc)
    return out[_valid_windows(bases, k)]


def genome_set(path: str, k: int, canonical: bool, hashed: bool,
               device) -> torch.Tensor:
    """The distinct k-mer codes of a FASTA file, what ``count -k k [-K]
    [-H]`` keeps, flipped and sorted ascending."""
    encode = nthash_codes if hashed else kmer_codes
    parts = [encode(rec, k, canonical) for rec in read_fasta(path, device)]
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=device)
    return torch.unique(torch.cat(parts) ^ SIGN)
