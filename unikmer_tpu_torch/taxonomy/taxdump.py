"""NCBI taxonomy on the host (the port's copy of the parts of
unikmer_tpu/taxonomy/taxdump.py that ``count -T`` uses): nodes.dmp and
merged.dmp loading and vectorized LCA.

The tree is flattened into dense numpy arrays (parent[], depth[]) so
LCA runs on whole arrays at once: lift the deeper side to equal depth,
then walk both sides up in lockstep, each step one vectorized gather,
bounded by the tree depth.  0 acts as the LCA identity and unknown
taxids yield 0.  The device planner (taxonomy/lca.py) reads the same
arrays.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..utils.log import die, log


@dataclass
class Taxonomy:
    parent: np.ndarray  # uint32, parent[taxid]; 0 = unknown/absent
    depth: np.ndarray  # int16, depth[taxid]; -1 = absent
    rank_ids: np.ndarray  # int16 rank id per taxid; -1 = absent
    ranks: list[str]  # rank id -> rank name
    merged: dict[int, int] = field(default_factory=dict)
    root: int = 1

    @classmethod
    def from_numpy(cls, parent, depth, rank_ids, ranks, merged=None,
                   root: int = 1) -> "Taxonomy":
        """A Taxonomy from the same fields (e.g. those of a unikmer_tpu
        Taxonomy), copied and cast to their dtypes."""
        return cls(np.array(parent, np.uint32), np.array(depth, np.int16),
                   np.array(rank_ids, np.int16), list(ranks),
                   dict(merged or {}), int(root))

    @property
    def max_taxid(self) -> int:
        return len(self.parent) - 1

    def has(self, taxids) -> np.ndarray:
        t = np.asarray(taxids, dtype=np.int64)
        ok = (t > 0) & (t <= self.max_taxid)
        out = np.zeros(t.shape, bool)
        out[ok] = self.depth[t[ok]] >= 0
        return out

    def lca_pairs(self, a, b) -> np.ndarray:
        """Vectorized LCA over parallel arrays (0 = identity; unknown -> 0)."""
        a = np.asarray(a, dtype=np.int64).copy()
        b = np.asarray(b, dtype=np.int64).copy()
        shape = a.shape
        a, b = a.reshape(-1), b.reshape(-1)
        out = np.zeros(a.shape, dtype=np.uint32)

        known_a = self.has(a)
        known_b = self.has(b)
        # identity / unknown handling
        only_a = known_a & ((b == 0) | ~known_b)
        only_b = known_b & ((a == 0) | ~known_a)
        out[only_a & (b == 0)] = a[only_a & (b == 0)]
        out[only_b & (a == 0)] = b[only_b & (a == 0)]
        both = known_a & known_b
        if both.any():
            x, y = a[both], b[both]
            dx, dy = self.depth[x].astype(np.int32), self.depth[y].astype(np.int32)
            # lift deeper side
            while True:
                m = dx > dy
                if not m.any():
                    break
                x[m] = self.parent[x[m]]
                dx[m] -= 1
            while True:
                m = dy > dx
                if not m.any():
                    break
                y[m] = self.parent[y[m]]
                dy[m] -= 1
            while True:
                m = x != y
                if not m.any():
                    break
                x[m] = self.parent[x[m]]
                y[m] = self.parent[y[m]]
            out[both] = x.astype(np.uint32)
        return out.reshape(shape)

    def lca_reduce(self, keys: np.ndarray, taxids: np.ndarray):
        """Segment LCA: for sorted ``keys``, reduce each run of equal keys
        to its members' LCA.  Returns (unique_keys, lca_per_key).
        Unsorted keys are sorted first (stable, taxids alongside)."""
        keys = np.asarray(keys, dtype=np.uint64)
        taxids = np.asarray(taxids, dtype=np.uint32)
        n = len(keys)
        if n == 0:
            return keys, taxids
        if n > 1 and (keys[1:] < keys[:-1]).any():
            keys, taxids = native.host_sort_kv(keys, taxids)
        # singleton runs (the common case) pass through untouched; only
        # multi-element runs are reduced
        run_start = np.ones(n, bool)
        run_start[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(run_start)
        out_keys = keys[starts]
        out_tax = taxids[starts].copy()
        lens = np.diff(np.append(starts, n))
        if (lens <= 1).all():
            return out_keys, out_tax
        run_id = np.cumsum(run_start) - 1
        multi = (lens > 1)[run_id]
        # dedupe (run, taxid) pairs of the multi subset via one packed
        # u64 sort (run ids and taxids both fit in 32 bits)
        packed = (run_id[multi].astype(np.uint64) << np.uint64(32)) | taxids[
            multi
        ].astype(np.uint64)
        packed = native.host_sort(packed)
        first = np.ones(len(packed), bool)
        first[1:] = packed[1:] != packed[:-1]
        packed = packed[first]
        k_s = (packed >> np.uint64(32)).astype(np.int64)  # run ids
        t_s = (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        # pairwise tree reduction within runs
        while True:
            run_start = np.ones(len(k_s), bool)
            run_start[1:] = k_s[1:] != k_s[:-1]
            if run_start.all():
                break
            # element i merges i+1 when both belong to the same run and
            # i is an even member offset
            rid2 = np.cumsum(run_start) - 1
            offset = np.arange(len(k_s)) - np.flatnonzero(run_start)[rid2]
            left = (offset % 2 == 0)
            has_right = np.zeros(len(k_s), bool)
            has_right[:-1] = left[:-1] & (rid2[:-1] == rid2[1:]) & (offset[:-1] + 1 == offset[1:])
            merged = t_s.copy()
            merged[has_right] = self.lca_pairs(
                t_s[has_right], t_s[np.flatnonzero(has_right) + 1]
            )
            k_s, t_s = k_s[left], merged[left]
        out_tax[k_s] = t_s
        return out_keys, out_tax


def _parse_dmp_line(line: bytes) -> list[bytes]:
    return [f.strip() for f in line.split(b"\t|")]


def load_taxonomy(
    data_dir: str, with_rank: bool = True, verbose: bool = False
) -> Taxonomy:
    """Load nodes.dmp (+merged.dmp when present) from ``data_dir``."""
    nodes_file = os.path.join(data_dir, "nodes.dmp")
    if not os.path.isdir(data_dir) or not os.path.exists(nodes_file):
        die(
            "data directory not found or missing nodes.dmp. please download "
            "ftp://ftp.ncbi.nih.gov/pub/taxonomy/taxdump.tar.gz and copy "
            f'"nodes.dmp" to {data_dir}'
        )
    if verbose:
        log.info(f"loading Taxonomy from: {data_dir}")
    taxids, parents, ranks = [], [], []
    with open(nodes_file, "rb") as f:
        for line in f:
            fields = _parse_dmp_line(line)
            if len(fields) < 3:
                continue
            taxids.append(int(fields[0]))
            parents.append(int(fields[1]))
            ranks.append(fields[2].decode())
    taxids = np.asarray(taxids, dtype=np.int64)
    parents_a = np.asarray(parents, dtype=np.int64)
    max_taxid = int(taxids.max())
    parent = np.zeros(max_taxid + 1, dtype=np.uint32)
    parent[taxids] = parents_a

    rank_names = sorted(set(ranks))
    rank_idx = {r: i for i, r in enumerate(rank_names)}
    rank_ids = np.full(max_taxid + 1, -1, dtype=np.int16)
    if with_rank:
        rank_ids[taxids] = np.array([rank_idx[r] for r in ranks], dtype=np.int16)

    # depths by frontier propagation from the root (parent[1] == 1)
    depth = np.full(max_taxid + 1, -1, dtype=np.int16)
    root = 1
    if parent[root] == 0:
        parent[root] = root
    depth[root] = 0
    present = np.zeros(max_taxid + 1, bool)
    present[taxids] = True
    undefined = present.copy()
    undefined[root] = False
    for d in range(1, 200):
        if not undefined.any():
            break
        idx = np.flatnonzero(undefined)
        ready = depth[parent[idx]] >= 0
        if not ready.any():
            # orphan subtrees (parents absent): anchor at depth 1
            orphans = idx[parent[idx] == 0]
            if len(orphans) == 0:
                orphans = idx
            depth[orphans] = 1
            parent[orphans] = root
            undefined[orphans] = False
            continue
        sel = idx[ready]
        depth[sel] = depth[parent[sel]] + 1
        undefined[sel] = False

    merged: dict[int, int] = {}
    merged_file = os.path.join(data_dir, "merged.dmp")
    if os.path.exists(merged_file):
        with open(merged_file, "rb") as f:
            for line in f:
                fields = _parse_dmp_line(line)
                if len(fields) >= 2:
                    merged[int(fields[0])] = int(fields[1])

    if verbose:
        log.info(f"{len(taxids)} nodes loaded, max taxid {max_taxid}")
    return Taxonomy(
        parent=parent,
        depth=depth,
        rank_ids=rank_ids,
        ranks=rank_names,
        merged=merged,
    )
