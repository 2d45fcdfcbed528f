"""Sorted-set algebra over uint64 code arrays (+ optional taxid columns):
the port's copy of unikmer_tpu/ops/sets.py, the host engine of the
set-operation subcommands and of the count pipeline's piece merge and
spill.

Every operation is a bulk sorted-array computation (sort, searchsorted
or native merge-join, segment reduction); the device twins are in
ops/device_sets.py.  All functions take and return SORTED code arrays;
taxid columns are optional (None = no taxid info) and merge by LCA
through a taxonomy.taxdump.Taxonomy.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _lca_merge(taxdb, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise LCA with 0 as identity (no-taxid)."""
    if taxdb is None:
        # without a taxonomy, equal taxids keep, differing fall to 0
        return np.where(a == b, a, np.where(a == 0, b, np.where(b == 0, a, 0))).astype(
            np.uint32
        )
    return taxdb.lca_pairs(a, b)


def dedup_sorted(codes: np.ndarray, taxids: np.ndarray | None, taxdb=None):
    """Collapse duplicates in a sorted array; taxids merge by LCA
    (the reference's map-insert + LCA-update loop, count.go:405-410)."""
    if len(codes) == 0:
        return codes, taxids
    if taxids is None:
        first = np.ones(len(codes), bool)
        first[1:] = codes[1:] != codes[:-1]
        if first.all():  # sorted .unik sets are usually already unique
            return codes, None
        return codes[first], None
    if taxdb is not None:
        return taxdb.lca_reduce(codes, taxids)
    # no taxonomy: runs with a single distinct NONZERO taxid keep it,
    # else 0 (0 is the no-taxid identity, matching _lca_merge: {0, t}
    # must merge to t, not 0)
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
    merge kernel; None without the native library.  Every array passes
    through at least one merge (which collapses duplicates within and
    across inputs), so the result is strictly increasing."""
    if native.get_lib() is None:
        return None
    level = [np.ascontiguousarray(c, np.uint64) for c in code_arrays]
    while len(level) > 1:
        nxt = []
        final = len(level) == 2
        for i in range(0, len(level) - 1, 2):
            # intermediates skip the buffer-trim copy (consumed by the
            # next level immediately); only the final result is trimmed
            nxt.append(native.set2_sorted(
                "union", level[i], level[i + 1], trim=final
            ))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def union(code_arrays, taxid_arrays=None, taxdb=None):
    """Union with LCA merge on collision (union.go:195-202)."""
    if (
        taxid_arrays is None
        and len(code_arrays) > 1
        and all(_is_sorted(c) for c in code_arrays)
    ):
        out = _native_union_tree(code_arrays)
        if out is not None:
            return out, None
    codes = np.concatenate(code_arrays) if code_arrays else np.zeros(0, np.uint64)
    if taxid_arrays is None:
        return dedup_sorted(native.host_sort(codes), None)
    consts = _constant_taxids(taxid_arrays)
    if consts is not None and len(code_arrays) <= 64:
        return _union_const_taxids(code_arrays, consts, taxdb)
    taxids = np.concatenate(taxid_arrays)
    codes, taxids = native.host_sort_kv(codes, taxids)
    return dedup_sorted(codes, taxids, taxdb)


def _constant_taxids(taxid_arrays):
    """Per-array constant taxid values, or None if any array varies.
    (Global-taxid inputs — the common case — are constant columns.)"""
    consts = []
    for t in taxid_arrays:
        if t is None or len(t) == 0:
            consts.append(0)
            continue
        if t[0] != t[-1] or (t != t[0]).any():
            return None
        consts.append(int(t[0]))
    return consts


def _union_const_taxids(code_arrays, consts, taxdb):
    """Union where file i contributes the single taxid consts[i]: the
    LCA of a result code depends only on WHICH files contain it, so
    compute a per-code file-membership bitmask and look the LCA up in a
    tiny per-pattern table — O(F) vectorized searchsorted passes instead
    of the generic segmented LCA reduction (which allocates ~30 large
    temps; first-touch page faults dominate on this VM)."""
    deduped = []
    for c in code_arrays:
        # NOT np.diff()<=0: uint64 subtraction wraps, so a descending
        # step looks like a huge positive delta and unsortedness would
        # never be detected
        if len(c) and (c[1:] <= c[:-1]).any():
            c = np.unique(c)
        else:
            c, _ = dedup_sorted(c, None)
        deduped.append(c)
    out = _native_union_tree(deduped)  # O(N logF) pairwise tree
    if out is None:
        out = deduped[0]
        for c in deduped[1:]:
            # merge-of-sorted via membership + sort of the new tail
            mask, _ = member_mask(out, c, sorted_queries=True)
            out = np.sort(np.concatenate([out, c[~mask]]))
    bits = np.zeros(len(out), np.uint64)
    for i, c in enumerate(deduped):
        mask, _ = member_mask(c, out, sorted_queries=True)
        bits |= mask.astype(np.uint64) << np.uint64(i)
    patterns, inv = np.unique(bits, return_inverse=True)
    lca_per_pattern = np.empty(len(patterns), np.uint32)
    for j, p in enumerate(patterns):
        members = [consts[i] for i in range(len(consts)) if (int(p) >> i) & 1]
        acc = members[0] if members else 0
        for m in members[1:]:
            acc = _lca_merge(
                taxdb, np.array([acc], np.uint32), np.array([m], np.uint32)
            )[0]
        lca_per_pattern[j] = acc
    return out, lca_per_pattern[inv]


def member_mask(sorted_ref: np.ndarray, queries: np.ndarray,
                sorted_queries: bool = False):
    """For each query, whether it occurs in sorted_ref; also the match
    index (valid where mask).  Vectorized binary-search merge-join;
    when the caller knows `queries` is sorted too, a parallel native
    two-pointer join is used instead."""
    if len(sorted_ref) == 0:
        return np.zeros(len(queries), bool), np.zeros(len(queries), np.int64)
    if sorted_queries and len(queries) >= (1 << 14):
        res = native.member_mask_sorted(sorted_ref, queries)
        if res is not None:
            return res
    idx = np.searchsorted(sorted_ref, queries)
    idx_c = np.minimum(idx, len(sorted_ref) - 1)
    mask = sorted_ref[idx_c] == queries
    return mask, idx_c


def intersect(code_arrays, taxid_arrays=None, taxdb=None):
    """Intersection of sorted inputs with LCA on match (inter.go:205-296).
    Inputs are deduped per file first (sorted .unik sets are unique)."""
    survivors, s_tax = dedup_sorted(
        code_arrays[0],
        None if taxid_arrays is None else taxid_arrays[0],
        taxdb,
    )
    for i in range(1, len(code_arrays)):
        codes_i, tax_i = dedup_sorted(
            code_arrays[i],
            None if taxid_arrays is None else taxid_arrays[i],
            taxdb,
        )
        mask, idx = member_mask(codes_i, survivors, sorted_queries=True)
        survivors = survivors[mask]
        if s_tax is not None:
            s_tax = s_tax[mask]
            if tax_i is not None:
                s_tax = _lca_merge(taxdb, s_tax, tax_i[idx[mask]])
        if len(survivors) == 0:
            break
    return survivors, s_tax


def subtract(
    q_codes: np.ndarray,
    q_tax: np.ndarray | None,
    other_arrays,
    other_tax_arrays=None,
    compare_taxid: bool = False,
    taxdb=None,
):
    """diff: remove query k-mers found in later files; with compare_taxid
    a query survives a match when the target taxid equals the query's or
    is its descendant (LCA(t, q) == q, diff.go:360-366,405-409)."""
    for i, codes_i in enumerate(other_arrays):
        if len(q_codes) == 0:
            break
        if len(codes_i) == 0:
            # empty target removes nothing (and member_mask's clipped
            # searchsorted index must never be used against it)
            continue
        tax_i = None if other_tax_arrays is None else other_tax_arrays[i]
        # targets may be unsorted (diff.go:341-377 handles both), but
        # .unik sets usually ARE sorted: verify (vectorized O(n), ~10x
        # cheaper than a wasted sort) instead of sorting unconditionally
        if tax_i is None:
            if not _is_sorted(codes_i):
                codes_i = native.host_sort(codes_i)
            # duplicate targets cannot change membership: no dedup
            # (member_mask's join stops at the first equal ref)
        else:
            if not _is_sorted(codes_i):
                codes_i, tax_i = native.host_sort_kv(codes_i, tax_i)
            codes_i, tax_i = dedup_sorted(codes_i, tax_i, taxdb)
        mask, idx = member_mask(codes_i, q_codes, sorted_queries=True)
        if compare_taxid and q_tax is not None and tax_i is not None:
            t = tax_i[idx]
            keep_matched = (q_tax == t) | (
                (taxdb.lca_pairs(t, q_tax) == q_tax) if taxdb is not None else False
            )
            remove = mask & ~keep_matched
        else:
            remove = mask
        q_codes = q_codes[~remove]
        if q_tax is not None:
            q_tax = q_tax[~remove]
    return q_codes, q_tax


def common(code_arrays, taxid_arrays=None, threshold: int = 0, taxdb=None):
    """k-mers shared by >= threshold files (common.go:75-111): each file
    contributes once per code; taxids LCA-merge across files."""
    if threshold <= 0:
        threshold = len(code_arrays)
    deduped = []
    dedup_tax = []
    for i, codes in enumerate(code_arrays):
        t = None if taxid_arrays is None else taxid_arrays[i]
        c, t = dedup_sorted(codes, t, taxdb)
        deduped.append(c)
        dedup_tax.append(t)
    all_codes = np.concatenate(deduped)
    if taxid_arrays is None:
        all_codes = native.host_sort(all_codes)
        order = None
    else:
        all_codes, order = native.host_argsort(all_codes)
    # run-length count on the sorted array (np.unique would re-sort)
    starts = np.flatnonzero(
        np.concatenate([[True], all_codes[1:] != all_codes[:-1]])
    ) if len(all_codes) else np.zeros(0, np.int64)
    counts = np.diff(np.append(starts, len(all_codes)))
    keep_codes = all_codes[starts[counts >= threshold]]
    if taxid_arrays is None:
        return keep_codes, None
    all_tax = np.concatenate(
        [t if t is not None else np.zeros(len(c), np.uint32)
         for c, t in zip(deduped, dedup_tax)]
    )[order]
    m_codes, m_tax = dedup_sorted(all_codes, all_tax, taxdb)
    mask, idx = member_mask(m_codes, keep_codes, sorted_queries=True)
    return keep_codes, m_tax[idx]
