"""Host sorted-set merges over uint64 code arrays (the port's copy of the
parts of unikmer_tpu/ops/sets.py that the count pipeline's piece merge
and spill use): duplicate collapse and the union of sorted arrays.

All functions take and return SORTED code arrays; taxid columns are
optional (None = no taxid info) and merge by LCA through a
taxonomy.taxdump.Taxonomy.
"""

from __future__ import annotations

import numpy as np

from .. import native


def dedup_sorted(codes: np.ndarray, taxids: np.ndarray | None, taxdb=None):
    """Collapse duplicates in a sorted array; taxids merge by LCA."""
    if len(codes) == 0:
        return codes, taxids
    if taxids is None:
        first = np.ones(len(codes), bool)
        first[1:] = codes[1:] != codes[:-1]
        if first.all():  # sorted sets are usually already unique
            return codes, None
        return codes[first], None
    if taxdb is not None:
        return taxdb.lca_reduce(codes, taxids)
    # no taxonomy: runs with a single distinct NONZERO taxid keep it,
    # else 0 (0 is the no-taxid identity: {0, t} merges to t)
    first = np.ones(len(codes), bool)
    first[1:] = codes[1:] != codes[:-1]
    run_id = np.cumsum(first) - 1
    n_runs = int(run_id[-1]) + 1
    t_min = np.full(n_runs, np.iinfo(np.uint32).max, np.uint32)
    t_max = np.zeros(n_runs, np.uint32)
    nz = np.where(taxids == 0, np.iinfo(np.uint32).max, taxids)
    np.minimum.at(t_min, run_id, nz)
    np.maximum.at(t_max, run_id, taxids)
    # all-zero runs: t_min stays at the sentinel != t_max=0 -> 0
    merged = np.where(t_min == t_max, t_max, 0).astype(np.uint32)
    return codes[first], merged


def _is_sorted(c: np.ndarray) -> bool:
    return len(c) < 2 or bool((c[1:] >= c[:-1]).all())


def _native_union_tree(code_arrays):
    """Pairwise-tree union of sorted arrays via the parallel native
    merge; None without the native library.  Every array passes through
    at least one merge (which collapses duplicates within and across
    inputs), so the result is strictly increasing."""
    if native.get_lib() is None:
        return None
    level = [np.ascontiguousarray(c, np.uint64) for c in code_arrays]
    while len(level) > 1:
        nxt = []
        final = len(level) == 2
        for i in range(0, len(level) - 1, 2):
            # intermediates skip the trim copy (consumed by the next
            # level at once); only the final result is trimmed
            nxt.append(native.set2_union(level[i], level[i + 1],
                                         trim=final))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def union(code_arrays) -> np.ndarray:
    """Sorted union (duplicates collapsed) of uint64 code arrays."""
    if len(code_arrays) > 1 and all(_is_sorted(c) for c in code_arrays):
        out = _native_union_tree(code_arrays)
        if out is not None:
            return out
    codes = (np.concatenate(code_arrays) if code_arrays
             else np.zeros(0, np.uint64))
    return dedup_sorted(native.host_sort(codes), None)[0]
