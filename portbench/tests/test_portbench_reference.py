"""The plain reference: its encoders against a brute force a window,
written from the definitions, and its set algebra against Python sets."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.reference.compare import members_wrong  # noqa: E402
from portbench.reference.encode import (  # noqa: E402
    NTHASH_SEEDS, genome_set, kmer_codes, nthash_codes, unflip,
)
from portbench.reference.sets import ReferenceSets, popcount  # noqa: E402

CPU = torch.device("cpu")
M64 = (1 << 64) - 1
COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def brute_2bit(seq: str, k: int, canonical: bool) -> list[int]:
    out = []
    for i in range(len(seq) - k + 1):
        w = seq[i:i + k].upper()
        if any(c not in "ACGT" for c in w):
            continue
        f = int("".join("ACGT".index(c).__format__("02b") for c in w), 2)
        r = int("".join("ACGT".index(COMP[c]).__format__("02b")
                        for c in reversed(w)), 2)
        out.append(min(f, r) if canonical else f)
    return out


def rol(x: int, s: int) -> int:
    s %= 64
    return ((x << s) | (x >> (64 - s))) & M64 if s else x


def brute_nthash(seq: str, k: int, canonical: bool) -> list[int]:
    out = []
    for i in range(len(seq) - k + 1):
        w = seq[i:i + k].upper()
        if any(c not in "ACGT" for c in w):
            continue
        f = r = 0
        for j, c in enumerate(w):
            f ^= rol(int(NTHASH_SEEDS["ACGT".index(c)]), k - 1 - j)
            r ^= rol(int(NTHASH_SEEDS["ACGT".index(COMP[c])]), j)
        out.append(min(f, r) if canonical else f)
    return out


def bases(seq: str) -> torch.Tensor:
    lut = {c: i for i, c in enumerate("ACGT")}
    return torch.tensor([lut.get(c.upper(), 4) for c in seq],
                        dtype=torch.uint8)


def as_u64(t: torch.Tensor) -> list[int]:
    return [int(x) for x in t.numpy().view(np.uint64)]


SEQS = ["ACGTTGCAACGTACGGTACCATGACTTTGACCAGT" * 3,
        "acgtNNacgtacgtRacgttgcatgcaTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTAAAA",
        "GATTACA"]


@pytest.mark.parametrize("k", [1, 2, 5, 7, 16, 23, 31, 32])
@pytest.mark.parametrize("canonical", [False, True])
def test_2bit_codes_match_a_brute_force(k, canonical):
    for s in SEQS:
        got = as_u64(kmer_codes(bases(s), k, canonical))
        assert got == brute_2bit(s, k, canonical)


@pytest.mark.parametrize("k", [1, 3, 21, 31, 33, 63, 64])
@pytest.mark.parametrize("canonical", [False, True])
def test_nthash_matches_a_brute_force(k, canonical):
    for s in SEQS:
        got = as_u64(nthash_codes(bases(s), k, canonical))
        assert got == brute_nthash(s, k, canonical)


def test_genome_set_reads_records_apart(tmp_path):
    p = tmp_path / "x.fa"
    p.write_bytes(b">a one\nACGTACGTAC\nGTTT\n>b\nacgtacgtacgtaaaa\r\n")
    got = genome_set(str(p), 5, True, False, CPU)
    want = set(brute_2bit("ACGTACGTACGTTT", 5, True)) | set(
        brute_2bit("acgtacgtacgtaaaa", 5, True))
    assert list(unflip(got)) == sorted(want)
    # flipped and sorted: signed order is the codes' unsigned order
    assert bool(torch.all(got[1:] > got[:-1]))


def test_set_algebra_matches_python_sets():
    rng = np.random.default_rng(3)
    pool = rng.integers(0, 1 << 64, 400, dtype=np.uint64)
    pool[:3] = [0, (1 << 63), M64 - 1]
    members = [sorted(set(rng.choice(pool, rng.integers(1, 120)).tolist()))
               for _ in range(70)]  # 70 genomes: two words, bit 63 used
    flip = [torch.from_numpy(np.array(m, np.uint64).view(np.int64))
            ^ -(1 << 63) for m in members]
    ref = ReferenceSets(flip)
    py = [set(m) for m in members]

    def codes(x):
        return [int(v) for v in ref.codes(x)]

    S = [0, 5, 63, 64, 69]
    assert codes(ref.union_all(S)) == sorted(set().union(*(py[i] for i in S)))
    for t in (1, 2, 3, 5):
        want = sorted(v for v in set().union(*(py[i] for i in S))
                      if sum(v in py[i] for i in S) >= t)
        assert codes(ref.common(S, t)) == want
    assert codes(ref.common(S, 0)) == sorted(
        set.intersection(*(py[i] for i in S)))
    u = ref.union_all([1, 2])
    assert codes(ref.intersect(63, u)) == sorted(py[63] & (py[1] | py[2]))
    assert codes(ref.subtract(64, u)) == sorted(py[64] - (py[1] | py[2]))
    assert codes(ref.union_all([u, 3])) == sorted(py[1] | py[2] | py[3])
    assert codes(ref.common([u, 1, 4], 2)) == sorted(
        v for v in py[1] | py[2] | py[4]
        if (v in py[1] | py[2]) + (v in py[1]) + (v in py[4]) >= 2)
    assert ref.size(u) == len(py[1] | py[2]) and ref.size(7) == len(py[7])


def test_popcount():
    x = np.array([0, 1, 3, M64, 1 << 63, 0x0F0F], np.uint64)
    got = popcount(torch.from_numpy(x.view(np.int64)))
    assert got.tolist() == [0, 1, 2, 64, 1, 8]


def test_members_wrong_counts_missing_extra_and_order():
    want = np.array([1, 5, 9, 12], np.uint64)
    assert members_wrong(want.copy(), want) == 0
    assert members_wrong(np.array([1, 5, 12], np.uint64), want) == 1
    assert members_wrong(np.array([1, 5, 9, 12, 20], np.uint64), want) == 1
    assert members_wrong(np.array([1, 9, 5, 12], np.uint64), want) == 1
    assert members_wrong(np.array([1, 5, 5, 12], np.uint64), want) == 2
    assert members_wrong(np.zeros(0, np.uint64), want) == 4
