"""The plain reference's taxids, in plain PyTorch: the LCA over a
taxonomy read from its ``nodes.dmp``, and set algebra over genome sets
that carry a taxid a member.

The LCA comes from root paths: each node's row holds its ancestors from
the root down to itself (row[d] the ancestor at depth d), so the LCA of
two nodes is the deepest entry their rows share (in a tree the shared
entries are a prefix).  Taxid 0 is the identity: LCA(0, x) = x.  Every
taxid handed to it must be a node of the taxonomy; any other raises.

The semantics follow the port and the JAX package (``KmerSet``):

- union: a code's taxid is the LCA of its holders' taxids (a set
  without taxids holds 0, the identity); the union of sets none of
  which carries taxids carries none;
- intersect: the LCA of the two sides' taxids, or the one side's where
  only one carries them;
- subtract: the left side's taxids (upstream's ``diff`` keeps the
  query's);
- common: no taxids, as in both packages (upstream's ``common``
  LCA-merges them).

A value is a genome's index or a :class:`Tagged` mask over the universe
(reference/sets.py) with its taxid column.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import unflip
from .sets import ReferenceSets, Universe

LOW32 = (1 << 32) - 1


def read_nodes(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(taxids, parents) of an NCBI ``nodes.dmp`` (``taxid | parent |
    rank | ...``), as int64."""
    taxids, parents = [], []
    with open(path, "rb") as f:
        for line in f:
            fields = line.split(b"\t|\t", 2)
            if len(fields) >= 2:
                taxids.append(int(fields[0]))
                parents.append(int(fields[1]))
    return np.array(taxids, np.int64), np.array(parents, np.int64)


class Lineages:
    """Every node's root path: ``rows`` [nodes, depth + 1] int64 of
    taxids, -1 past the node's own depth; ``row_of`` maps a taxid to its
    row (-1 for none)."""

    def __init__(self, taxids: np.ndarray, parents: np.ndarray, device):
        n = taxids.size
        row_of = np.full(int(taxids.max()) + 1, -1, np.int64)
        row_of[taxids] = np.arange(n)
        if (row_of[parents] < 0).any():
            raise ValueError("nodes.dmp names a parent it does not hold")
        up = row_of[parents]  # each row's parent row
        root = np.flatnonzero(up == np.arange(n))
        if root.size != 1:
            raise ValueError("nodes.dmp needs exactly one root")
        depth = np.zeros(n, np.int64)
        cur = np.arange(n)
        for _ in range(n):
            live = cur != root[0]
            if not live.any():
                break
            depth += live
            cur = up[cur]
        else:
            raise ValueError("nodes.dmp holds a cycle")
        rows = np.full((n, int(depth.max()) + 1), -1, np.int64)
        cur = np.arange(n)
        for j in range(int(depth.max()) + 1):
            at = depth - j  # the j-th ancestor sits at depth - j
            ok = at >= 0
            rows[np.flatnonzero(ok), at[ok]] = taxids[cur[ok]]
            cur = up[cur]
        self.rows = torch.from_numpy(rows).to(device)
        self.row_of = torch.from_numpy(row_of).to(device)

    @classmethod
    def read(cls, path: str, device) -> "Lineages":
        return cls(*read_nodes(path), device)

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        top = self.row_of.shape[0] - 1
        r = torch.where(t <= top, self.row_of[t.clamp(0, top)], -1)
        if bool(((r < 0) & (t != 0)).any()):
            raise ValueError("a taxid that the taxonomy does not hold")
        return r

    def lca(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise LCA of two int64 tensors of taxids (0 the
        identity), worked out once for each distinct pair."""
        pairs, back = torch.unique((a << 32) | b, return_inverse=True)
        x, y = pairs >> 32, pairs & LOW32
        rx, ry = self._rows(x), self._rows(y)
        px = self.rows[rx.clamp(min=0)]
        py = self.rows[ry.clamp(min=0)]
        shared = ((px == py) & (px >= 0)).sum(1)
        deepest = px.gather(1, (shared - 1).clamp(min=0)[:, None])[:, 0]
        out = torch.where(x == 0, y, torch.where(y == 0, x, deepest))
        return out[back]


class Tagged:
    """A set as a mask over the universe, with its taxid column over the
    universe (0 off the mask), or None where it carries no taxids."""

    def __init__(self, mask: torch.Tensor, tax: torch.Tensor | None):
        self.mask, self.tax = mask, tax


class TaxaSets(ReferenceSets):
    """The set operations with taxids, as the harness's backend: genome
    g's members carry ``genome_taxids[g]`` (int64, one a member)."""

    def __init__(self, genome_sets: list[torch.Tensor],
                 genome_taxids: list[torch.Tensor], lineages: Lineages):
        self.genome_sets = genome_sets
        self.universe = Universe(genome_sets, genome_taxids)
        self.lineages = lineages

    @classmethod
    def one_taxid_a_genome(cls, genome_sets: list[torch.Tensor], taxids,
                           nodes_dmp: str) -> "TaxaSets":
        """Every member of genome g carries ``taxids[g]``, over the
        taxonomy read from ``nodes_dmp``."""
        device = genome_sets[0].device
        tags = [torch.full((len(s),), int(t), dtype=torch.int64,
                           device=device)
                for s, t in zip(genome_sets, taxids)]
        return cls(genome_sets, tags, Lineages.read(nodes_dmp, device))

    def _lca_into(self, acc: torch.Tensor, at: torch.Tensor,
                  tax: torch.Tensor) -> None:
        acc[at] = self.lineages.lca(acc[at], tax)

    def _tagged(self, x) -> Tagged:
        if not isinstance(x, int):
            return x
        u = self.universe
        tax = torch.zeros(len(u.codes), dtype=torch.int64,
                          device=u.codes.device)
        tax[u.slots[x]] = u.taxids[x]
        return Tagged(u.any([x]), tax)

    def union_all(self, items):
        u = self.universe
        genomes = [x for x in items if isinstance(x, int)]
        others = [x for x in items if not isinstance(x, int)]
        mask = u.any(genomes)
        acc = torch.zeros(len(u.codes), dtype=torch.int64,
                          device=u.codes.device)
        for g in genomes:
            self._lca_into(acc, u.slots[g], u.taxids[g])
        for x in others:
            mask |= x.mask
            if x.tax is not None:
                at = torch.nonzero(x.mask).squeeze(1)
                self._lca_into(acc, at, x.tax[at])
        carries = bool(genomes) or any(x.tax is not None for x in others)
        return Tagged(mask, acc if carries else None)

    def common(self, items, threshold: int):
        items = list(items)
        t = len(items) if threshold <= 0 else int(threshold)
        genomes = [x for x in items if isinstance(x, int)]
        held = self.universe.count(genomes)
        for x in items:
            if not isinstance(x, int):
                held += x.mask
        return Tagged(held >= t, None)

    def intersect(self, a, b):
        a, b = self._tagged(a), self._tagged(b)
        mask = a.mask & b.mask
        if a.tax is None or b.tax is None:
            one = a.tax if b.tax is None else b.tax
            return Tagged(mask, None if one is None
                          else torch.where(mask, one, 0))
        tax = torch.zeros_like(a.tax)
        at = torch.nonzero(mask).squeeze(1)
        tax[at] = self.lineages.lca(a.tax[at], b.tax[at])
        return Tagged(mask, tax)

    def subtract(self, a, b):
        a, b = self._tagged(a), self._tagged(b)
        mask = a.mask & ~b.mask
        return Tagged(mask, None if a.tax is None
                      else torch.where(mask, a.tax, 0))

    def size(self, x) -> int:
        if isinstance(x, int):
            return len(self.genome_sets[x])
        return int(x.mask.sum())

    def codes(self, x) -> np.ndarray:
        if isinstance(x, int):
            return unflip(self.genome_sets[x])
        return unflip(self.universe.codes[x.mask])

    def taxids(self, x) -> np.ndarray | None:
        """The set's taxids in its codes' order, as numpy uint32, or None
        where it carries none."""
        if isinstance(x, int):
            return self.universe.taxids[x].cpu().numpy().astype(np.uint32)
        if x.tax is None:
            return None
        return x.tax[x.mask].cpu().numpy().astype(np.uint32)
