"""A seeded NCBI-style taxonomy, written as ``nodes.dmp``, and the taxid
of each genome of the pan-genome (gen/genomes.py).

A configuration that carries taxids holds two more keys (read only
where present; a configuration without them takes none of this):

- ``taxonomy``: the tree.
  - ``nodes``: how many nodes it has, the root included;
  - ``max_taxid``: the taxids are drawn, distinct, from 2 ..
    ``max_taxid`` (the root is 1), so they lie sparse below it as
    NCBI's do, and a program's dense parent and depth tables take
    ``max_taxid + 1`` rows;
  - ``ranks``: the rank ladder below the root, top first (e.g.
    superkingdom ... species, strain); every lineage passes each rank
    once;
  - ``depth``: ``[lo, hi]``, the depths (the root at 0) of the nodes of
    the ladder's last rank; no node lies deeper than ``hi``;
  - ``unranked_max``: the most unranked nodes ("clade") drawn between a
    ranked node and its ranked parent, as NCBI's lineages hold between
    their ranks (more only where ``lo`` needs them).
- ``genome_taxa``: the rule that gives each genome its taxid.  Genome j
  of clade c is a node of the last rank under clade c's node of the
  rank before it; ``clades_per_genus`` clades share a node of the rank
  two above the last, ``genera_per_family`` of those share one three
  above it, and all of those sit under one node four above it.  With the
  ladder ``... order, family, genus, species, strain``: strains under a
  clade's species, two species a genus, two genera a family, one order.

The tree grows rank by rank. Rank r holds about a share ``GROWTH``^r of
the nodes, each with its chain of unranked nodes; a rank's nodes after
the genomes' lineage pick their parents uniformly among the rank above.
Nodes that a rank's share leaves over are "no rank" children of the root
(NCBI's "unclassified" and "other" entries), so the tree has ``nodes``
nodes exactly. Taxids rise with the tree's level order, so that higher
ranks hold the lower numbers, as in NCBI.

The draws come from a child of the seed's ``SeedSequence`` of its own
(spawn key ``TAXONOMY_CHILD``, one grandchild for the tree and one for
the taxids), which no draw of the genomes or of the requests reaches.
``nodes.dmp`` has NCBI's columns ``taxid | parent | rank |``, sorted by
taxid.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .genomes import clade_of

TAXONOMY_CHILD = 1 << 20  # spawn key of the tree's draws
GROWTH = 3  # a rank holds about 3 times the nodes of the rank above
UNRANKED = "clade"
LEFT_OVER = "no rank"


@dataclass
class Taxa:
    """A written taxonomy: its directory (holding ``nodes.dmp``), each
    genome's taxid, and the deepest node's depth."""

    directory: str
    genome_taxids: np.ndarray  # uint32, one a genome
    max_depth: int

    @property
    def nodes_dmp(self) -> str:
        return os.path.join(self.directory, "nodes.dmp")


def _rng(seed: int, part: int) -> np.random.Generator:
    """The draws of ``part`` (0 the tree, 1 the taxids)."""
    entropy = int(seed) % (1 << 64)
    return np.random.default_rng(np.random.SeedSequence(
        entropy, spawn_key=(TAXONOMY_CHILD, part)))


def _shares(total: int, levels: int, least: int) -> np.ndarray:
    """Nodes a rank: GROWTH^r shares of ``total``, each but the last at
    least ``least``, the last the rest."""
    w = float(GROWTH) ** np.arange(levels)
    out = np.maximum(np.floor(total * w / w.sum()).astype(np.int64), least)
    out[-1] = total - out[:-1].sum()
    return out


def _lineage(cfg: dict) -> list[np.ndarray]:
    """The genomes' lineage at each of the ladder's last five ranks: the
    parents of its nodes there, as indices into its nodes of the rank
    above.  One node four ranks above the last (on a drawn parent), the
    families under it, the genera, a species a clade, a strain a
    genome."""
    rule = cfg["genome_taxa"]
    per_genus, per_family = rule["clades_per_genus"], rule["genera_per_family"]
    clades = cfg["clades"]
    if clades % (per_genus * per_family):
        raise ValueError("clades must fill whole genera and families")
    genera = clades // per_genus
    return [np.zeros(0, np.int64),
            np.zeros(genera // per_family, np.int64),
            np.arange(genera, dtype=np.int64) // per_family,
            np.arange(clades, dtype=np.int64) // per_genus,
            np.array([clade_of(cfg, j) for j in range(cfg["genomes"])],
                     np.int64)]


def build_tree(cfg: dict, seed: int):
    """(parent index, rank name, depth) of every node, in level order;
    node 0 is the root, its own parent.  Also the index of each genome's
    node."""
    tax = cfg["taxonomy"]
    ranks = list(tax["ranks"])
    levels = len(ranks)
    lo, hi = (int(d) for d in tax["depth"])
    umax = int(tax["unranked_max"])
    total = int(tax["nodes"])
    if levels < 5:
        raise ValueError("the rank ladder needs five ranks at least")
    if not levels <= lo <= hi:
        raise ValueError("depth needs len(ranks) <= lo <= hi")
    rng = _rng(seed, 0)
    lineage = _lineage(cfg)
    # a rank's share holds one node on the longest chain at least
    budgets = _shares(total - 1, levels, 1 + hi - levels)
    if budgets[-1] < 1:
        raise ValueError(f"{total} nodes cannot hold the ladder; raise nodes")

    parent = [np.zeros(1, np.int64)]
    rank = [np.array([LEFT_OVER], object)]
    depth = [np.zeros(1, np.int64)]
    above = np.zeros(1, np.int64)  # ranked nodes of the rank above
    used, carry = 1, 0
    for r in range(levels):
        budget = int(budgets[r]) + carry
        below = levels - 1 - r  # ranks left under this one
        forced = (lineage[r - (levels - 5)] if r >= levels - 5
                  else np.zeros(0, np.int64))
        pick = rng.integers(0, above.size, budget)
        pick[:forced.size] = forced
        pd = np.concatenate(depth)[above[pick]]
        cap = np.minimum(umax, hi - below - pd - 1)
        extra = (rng.random(budget) * (cap + 1)).astype(np.int64)
        if below == 0:
            extra = np.maximum(extra, lo - pd - 1)
        cost = 1 + extra
        ends = np.cumsum(cost)
        m = int(np.searchsorted(ends, budget, side="right"))
        if m < max(forced.size, 1):
            raise ValueError(f"{ranks[r]}: {budget} nodes cannot hold the "
                             "genomes' lineage; raise nodes")
        carry = budget - int(ends[m - 1])
        cost, extra, pick, pd = cost[:m], extra[:m], pick[:m], pd[:m]
        block = np.repeat(np.arange(m), cost)
        start = np.repeat(ends[:m] - cost, cost)
        k = np.arange(block.size) - start  # place in the node's chain
        idx = used + np.arange(block.size)
        parent.append(np.where(k == 0, above[pick][block], idx - 1))
        rank.append(np.where(k == extra[block], ranks[r], UNRANKED))
        depth.append(pd[block] + 1 + k)
        above = used + ends[:m] - 1  # the ranked nodes, in order
        used += block.size
    if carry:
        parent.append(np.zeros(carry, np.int64))
        rank.append(np.full(carry, LEFT_OVER, object))
        depth.append(np.ones(carry, np.int64))
    genomes = above[: cfg["genomes"]]
    return (np.concatenate(parent), np.concatenate(rank),
            np.concatenate(depth), genomes)


def write_taxonomy(cfg: dict, seed: int, directory: str) -> Taxa:
    """Write the seed's ``nodes.dmp`` under ``directory``; returns the
    genomes' taxids with it."""
    tax = cfg["taxonomy"]
    parent, rank, depth, genomes = build_tree(cfg, seed)
    n = parent.size
    if int(tax["max_taxid"]) < n:
        raise ValueError("max_taxid must exceed nodes")
    ids = np.sort(_rng(seed, 1).choice(int(tax["max_taxid"]) - 1, n - 1,
                                       replace=False)) + 2
    taxid = np.concatenate([[1], ids])
    lines = [f"{t}\t|\t{p}\t|\t{r}\t|\n"
             for t, p, r in zip(taxid.tolist(), taxid[parent].tolist(),
                                rank.tolist())]
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "nodes.dmp"), "w") as f:
        f.writelines(lines)
    return Taxa(directory, taxid[genomes].astype(np.uint32),
                int(depth.max()))
