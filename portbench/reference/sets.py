"""The plain reference's set algebra, in plain PyTorch.

The semantics, for sets of k-mer codes:

- union of sets: the codes in any of them;
- common(sets, t): the codes in at least t of them (`unikmer common`;
  t <= 0 means all of them);
- intersect(a, b), subtract(a, b): the codes of a that b holds, or does
  not hold.

Every set of a run is made from the genomes' sets, so it is a subset of
their union, the universe.  :class:`Universe` holds the universe sorted
(one ``torch.sort`` of all the genomes' codes) and beside each code a
bit a genome: whether that genome holds it.  A set is then a boolean
mask over the universe: a union of genomes is the codes whose bits meet
the genomes' bits, common() those with at least t of them, intersect and
subtract are AND and AND NOT of masks.  No binary search is used, so the
reference shares no search with the program's membership path.

Codes are flipped int64 (reference/encode.py): signed order is the
codes' unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import unflip

_M1, _M2, _M4 = (0x5555555555555555, 0x3333333333333333,
                 0x0F0F0F0F0F0F0F0F)
_H01 = 0x0101010101010101


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 bit pattern (SWAR), as int64."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return ((x * _H01) >> 56) & 0xFF


def _bit(g: int) -> int:
    """Bit g % 64 of a word as an int64 value."""
    b = 1 << (g % 64)
    return b - (1 << 64) if b >= 1 << 63 else b


class Universe:
    """The union of the genomes' sorted distinct code tensors (``codes``),
    and for each code a bit a genome (``bits``, [codes, words] int64).

    Given ``taxids`` (one int64 column a set, a taxid a member), it also
    keeps each set's taxid column (``taxids``) beside its members' places
    in the universe (``slots``), for reference/taxa.py."""

    def __init__(self, sets: list[torch.Tensor],
                 taxids: list[torch.Tensor] | None = None):
        device = sets[0].device
        self.words = -(-len(sets) // 64)
        codes = torch.cat(sets)
        owner = torch.cat([torch.full((len(s),), g, dtype=torch.int64,
                                      device=device)
                           for g, s in enumerate(sets)])
        codes, order = torch.sort(codes)
        owner = owner[order]
        if taxids is None:
            del order
        self.codes, slot = torch.unique_consecutive(codes, return_inverse=True)
        del codes
        if taxids is not None:
            at = torch.empty_like(slot)
            at[order] = slot  # each member's place, in the sets' order
            del order
            self.slots = list(torch.split(at, [len(s) for s in sets]))
            self.taxids = list(taxids)
        self.bits = torch.zeros(len(self.codes), self.words, dtype=torch.int64,
                                device=device)
        for w in range(self.words):
            mine = (owner >= 64 * w) & (owner < 64 * (w + 1))
            g = owner[mine] - 64 * w
            bit = torch.where(g == 63, torch.full_like(g, _bit(63)),
                              torch.ones_like(g) << g.clamp(max=62))
            # each (code, genome) pair is distinct: the bits' sum is their OR
            self.bits[:, w].index_add_(0, slot[mine], bit)

    def _selector(self, genomes) -> list[int]:
        sel = [0] * self.words
        for g in genomes:
            sel[g // 64] |= 1 << (g % 64)
        return [s - (1 << 64) if s >= 1 << 63 else s for s in sel]

    def count(self, genomes) -> torch.Tensor:
        """How many of ``genomes`` hold each code (int64)."""
        out = torch.zeros(len(self.codes), dtype=torch.int64,
                          device=self.codes.device)
        for w, sel in enumerate(self._selector(genomes)):
            if sel:
                out += popcount(self.bits[:, w] & sel)
        return out

    def any(self, genomes) -> torch.Tensor:
        """Whether any of ``genomes`` holds each code."""
        out = torch.zeros(len(self.codes), dtype=torch.bool,
                          device=self.codes.device)
        for w, sel in enumerate(self._selector(genomes)):
            if sel:
                out |= (self.bits[:, w] & sel) != 0
        return out


class ReferenceSets:
    """The set operations as the harness's backend (gen/traffic.py): a
    value is a genome's index or a mask over the universe."""

    def __init__(self, genome_sets: list[torch.Tensor]):
        self.genome_sets = genome_sets
        self.universe = Universe(genome_sets)

    def genome(self, i: int):
        return int(i)

    @staticmethod
    def _split(items):
        genomes = [x for x in items if isinstance(x, int)]
        masks = [x for x in items if not isinstance(x, int)]
        return genomes, masks

    def mask(self, x) -> torch.Tensor:
        return self.universe.any([x]) if isinstance(x, int) else x

    def union_all(self, items):
        genomes, masks = self._split(items)
        out = self.universe.any(genomes)
        for m in masks:
            out |= m
        return out

    def common(self, items, threshold: int):
        items = list(items)
        t = len(items) if threshold <= 0 else int(threshold)
        genomes, masks = self._split(items)
        held = self.universe.count(genomes)
        for m in masks:
            held += m
        return held >= t

    def intersect(self, a, b):
        return self.mask(a) & self.mask(b)

    def subtract(self, a, b):
        return self.mask(a) & ~self.mask(b)

    def size(self, x) -> int:
        if isinstance(x, int):
            return len(self.genome_sets[x])
        return int(x.sum())

    def codes(self, x) -> np.ndarray:
        """The set's codes, ascending, as numpy uint64."""
        if isinstance(x, int):
            return unflip(self.genome_sets[x])
        return unflip(self.universe.codes[x])
