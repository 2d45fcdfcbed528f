"""Compact-vocabulary LCA on PyTorch (port of unikmer_tpu/taxonomy/lca.py).

A batch's taxid vocabulary is small next to the taxonomy, so the host
plans once (:func:`device_lca_plan`) and the device merges compact ids:

  'table'  vocabularies up to UNIKMER_TPU_TAXID_VOCAB_MAX (default
           4096): the meet-closure's all-pairs LCA table (C, C), one
           gather per merge round;
  'paths'  larger ones: each closure member's root-down path of closure
           ancestors (C, Dp), the LCA being the deepest common entry;
           gather-free rounds over path rows.

The planners are numpy, with the JAX package's semantics and knobs;
they are re-declared here because that module imports jax.  The device
half is plain PyTorch around one K3 call: the collapse sorts (code,
payload) pairs by code, the payload holding the compact id and a valid
bit, so invalid slots (keyed to CODE_SENTINEL, payload 0) and real
all-ones codes share the last run and the valid bit tells them apart.
0 is the LCA identity (row 0 of every table is taxid 0).

The tree-walk LCA (:func:`lca_pairs_device`, :func:`lca_collapse_device`)
serves the set operations of ``KmerSet``: it walks the uploaded
parent/depth tables, ``max_depth`` steps to lift the deeper side and
``max_depth`` steps up in lockstep, in plain PyTorch, with the JAX
package's rule for unknown taxids (an unknown taxid merges to 0, and 0
is the identity), so the pairing order of a run is the JAX package's.

The TPU forms of the sort stage (a packed single u64 key, a 3-operand
split sort, staged programs) are compile workarounds of that backend
and are not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.radix_sort import radix_sort_kv_u64
from ..ops.sort import _run_edges
from ..utils.stages import stage

_VALID_BIT = 1 << 30  # beside compact ids in the sort payload


def lca_closure(taxdb, taxids):
    """(closure uint32 sorted (0 first), lca_tab int32 (C, C)) for the
    taxid vocabulary ``taxids``: lca_tab[i, j] is the compact id of
    LCA(closure[i], closure[j]) (0 identity; unknown -> 0)."""
    vocab = np.unique(
        np.concatenate([np.asarray(taxids, np.uint32).reshape(-1),
                        np.zeros(1, np.uint32)])
    )
    ii, jj = np.meshgrid(vocab, vocab, indexing="ij")
    pair_lca = taxdb.lca_pairs(ii.reshape(-1), jj.reshape(-1))
    closure = np.unique(np.concatenate([vocab, pair_lca]))
    ci, cj = np.meshgrid(closure, closure, indexing="ij")
    tab = taxdb.lca_pairs(ci.reshape(-1), cj.reshape(-1))
    ids = np.searchsorted(closure, tab).astype(np.int32)
    return closure, ids.reshape(len(closure), len(closure))


def compact_ids(closure: np.ndarray, taxids: np.ndarray) -> np.ndarray:
    """Map taxids (all members of the vocabulary) to compact ids."""
    return np.searchsorted(closure, np.asarray(taxids, np.uint32)).astype(
        np.int32
    )


def _known(taxdb, taxids) -> tuple[np.ndarray, bool]:
    """(vocabulary, every nonzero member known to the taxonomy)."""
    vocab = np.unique(np.asarray(taxids, np.uint32).reshape(-1))
    return vocab, bool(np.all(taxdb.has(vocab) | (vocab == 0)))


def _vocab_cap() -> int:
    return int(os.environ.get("UNIKMER_TPU_TAXID_VOCAB_MAX", "4096"))


def closure_for_vocab(taxdb, taxids):
    """(closure, lca_tab) for a taxid vocabulary, or None when the
    compact form cannot own the semantics: unknown NONZERO taxids (the
    host's unknown-merge rule depends on merge order), or a vocabulary
    or meet-closure beyond UNIKMER_TPU_TAXID_VOCAB_MAX (2x for the
    closure).  The 'table' tier of :func:`device_lca_plan`."""
    vocab, known = _known(taxdb, taxids)
    if not known:
        return None
    cap = _vocab_cap()
    if len(vocab) > cap:
        return None
    closure, lca_tab = lca_closure(taxdb, vocab)
    if len(closure) > 2 * cap:
        return None
    return closure, lca_tab


def _root_paths(taxdb, vocab):
    """(V, Dfull) int64 matrix of root-down ancestor taxids (-1 pad)
    for KNOWN nonzero ``vocab`` entries (depth(parent) = depth - 1)."""
    v = np.asarray(vocab, np.int64)
    if len(v) == 0:
        return np.full((0, 1), -1, np.int64)
    depth = taxdb.depth.astype(np.int64)
    parent = taxdb.parent.astype(np.int64)
    D = int(depth[v].max()) + 1
    paths = np.full((len(v), D), -1, np.int64)
    rows = np.arange(len(v))
    cur = v.copy()
    for _ in range(D):
        d = depth[cur]
        ok = (cur > 0) & (d >= 0)
        paths[rows[ok], d[ok]] = cur[ok]
        nxt = parent[cur]
        cur = np.where(ok & (nxt != cur), nxt, 0)
    return paths


def path_tables(taxdb, taxids):
    """(anc uint32 sorted (0 first), path_tab (C, Dp) int32) for a
    KNOWN taxid vocabulary of any size.

    ``anc`` is the vocabulary's meet-closure plus 0; ``path_tab[i]`` is
    member i's closure ancestors root-down as indices into ``anc``
    (itself last; -1 pad; row 0, taxid 0, all -1).  The meet-closure is
    the vocabulary plus the LCAs of lexicographically adjacent root
    paths, so the host work is O(V * depth), never O(V^2)."""
    vocab = np.unique(
        np.concatenate([np.asarray(taxids, np.uint32).reshape(-1),
                        np.zeros(1, np.uint32)])
    )
    vz = vocab[vocab != 0]
    if len(vz) == 0:
        return vocab, np.full((1, 1), -1, np.int32)
    fp = _root_paths(taxdb, vz)
    order = np.lexsort(fp.T[::-1])
    sfp = fp[order]
    if len(sfp) > 1:
        eq = sfp[1:] == sfp[:-1]
        cpd = np.cumprod(eq, axis=1).sum(axis=1)  # common-prefix depth
        good = cpd > 0  # 0 only for forest inputs
        adj = sfp[np.flatnonzero(good), cpd[good] - 1]
    else:
        adj = np.zeros(0, np.int64)
    closure = np.unique(np.concatenate([vz.astype(np.int64), adj]))
    anc = np.concatenate([np.zeros(1, np.int64), closure]).astype(np.uint64)
    anc = np.unique(anc).astype(np.uint32)  # 0 first (sorted)
    # each member's full path pruned to closure entries, left-packed
    afp = _root_paths(taxdb, closure)
    member = np.isin(afp, closure)
    Dp = max(int(member.sum(axis=1).max()), 1)
    tab = np.full((len(anc), Dp), -1, np.int32)
    rws, cls = np.nonzero(member)
    pos = (np.cumsum(member, axis=1) - 1)[rws, cls]
    ids = np.searchsorted(anc, afp[rws, cls]).astype(np.int32)
    tab[rws + 1, pos] = ids  # closure row r is anc row r+1
    return anc, tab


def device_lca_plan(taxdb, taxids):
    """Tiered admission of a taxid vocabulary: ('table', closure,
    lca_tab) for small vocabularies, ('paths', anc, path_tab) for large
    ones, or None when the device cannot own the semantics (unknown
    NONZERO taxids).

    Unlike the JAX package, no path depth declines the plan
    (UNIKMER_TPU_TAXID_PATH_DEPTH_MAX bounds a TPU block): the path
    rows live in device memory, gathered only for slots that merge."""
    vocab, known = _known(taxdb, taxids)
    if not known:
        return None
    table = closure_for_vocab(taxdb, vocab)
    if table is not None:
        return ("table",) + table
    anc, path_tab = path_tables(taxdb, vocab)
    if len(anc) >= _VALID_BIT:
        raise ValueError(f"a taxid closure of {len(anc)} members does not "
                         f"fit beside the sort payload's valid bit")
    return ("paths", anc, path_tab)


def upload_plan(plan, device):
    """A :func:`device_lca_plan` result with its table on ``device``:
    (kind, closure numpy, tab int32 tensor)."""
    kind, closure, tab = plan
    return kind, closure, torch.from_numpy(np.ascontiguousarray(tab)).to(device)


# ---------------------------------------------------------------------
# device half: the tree walk


def device_tables(taxdb, device):
    """(parent int64, depth int32, max_depth) of a Taxonomy on ``device``."""
    parent = torch.from_numpy(taxdb.parent.astype(np.int64)).to(device)
    depth = torch.from_numpy(taxdb.depth.astype(np.int32)).to(device)
    return parent, depth, int(taxdb.depth.max())


def lca_pairs_device(a: torch.Tensor, b: torch.Tensor, parent: torch.Tensor,
                     depth: torch.Tensor, max_depth: int) -> torch.Tensor:
    """Elementwise LCA of two int32 tensors of u32 taxids, 0 the
    identity and an unknown taxid 0: ``max_depth`` steps lift the deeper
    side, ``max_depth`` more walk both up in lockstep (no early exit).
    Returns int32."""
    n_tax = parent.shape[0]
    a = a.long()
    b = b.long()
    da = torch.where((a > 0) & (a < n_tax), depth[a.clamp(0, n_tax - 1)], -1)
    db = torch.where((b > 0) & (b < n_tax), depth[b.clamp(0, n_tax - 1)], -1)
    known_a, known_b = da >= 0, db >= 0
    x = torch.where(known_a, a, 0)
    y = torch.where(known_b, b, 0)
    dx, dy = da.clamp(min=0), db.clamp(min=0)
    for _ in range(max_depth):
        mx, my = dx > dy, dy > dx
        x = torch.where(mx, parent[x], x)
        dx = dx - mx.int()
        y = torch.where(my, parent[y], y)
        dy = dy - my.int()
    for _ in range(max_depth):
        m = x != y
        x = torch.where(m, parent[x], x)
        y = torch.where(m, parent[y], y)
    res = torch.where(known_a & known_b, x, 0)
    res = torch.where(known_a & (b == 0), a, res)
    res = torch.where(known_b & (a == 0), b, res)
    return res.to(torch.int32)


def lca_collapse_device(codes: torch.Tensor, taxids: torch.Tensor,
                        valid: torch.Tensor, parent: torch.Tensor,
                        depth: torch.Tensor, max_depth: int, rounds: int,
                        code_bits: int = 64):
    """Sorted distinct collapse with the tree-walk LCA over each run of
    equal codes: (sorted codes, merged taxids int32, keep mask), aligned
    to the sorted order.

    The order is that of the JAX package's sort of (code, invalid) made
    stable (UNIKMER_TPU_SORT_STABLE=1; only unknown taxids make a run's
    order matter): a stable partition puts the valid slots first, then
    K3 sorts the codes stably with the slots' positions as payload, so a
    run holds its valid slots in input order.  After round r every slot
    holds the LCA of the next 2^(r+1) slots of its run (slot i with
    i + 2^r, in its run when the two hold one code), so ``rounds`` >=
    ceil(log2(longest run)) merges each run into its first slot."""
    n = codes.shape[0]
    valid = valid.bool()
    part = torch.cat([torch.nonzero(valid).squeeze(1),
                      torch.nonzero(~valid).squeeze(1)])
    s_codes, s_pos = radix_sort_kv_u64(
        codes[part], torch.arange(n, dtype=torch.int32, device=codes.device),
        code_bits)
    src = part[s_pos.long()]
    s_valid = valid[src]
    tax = torch.where(s_valid, taxids[src].to(torch.int32), 0)
    first, _ = _run_edges(s_codes)
    for r in range(rounds):
        d = 1 << r
        if d >= n:
            break
        i = torch.nonzero(s_codes[d:] == s_codes[:-d]).squeeze(1)
        tax[i] = lca_pairs_device(tax[i], tax[i + d], parent, depth,
                                  max_depth)
    return s_codes, tax, first & s_valid


# ---------------------------------------------------------------------
# device half: compact ids


def lca_pairs_compact(ca: torch.Tensor, cb: torch.Tensor,
                      lca_tab: torch.Tensor) -> torch.Tensor:
    """Elementwise LCA over compact ids: one gather (int64 index)."""
    c = lca_tab.shape[0]
    return lca_tab.reshape(-1)[ca.long() * c + cb.long()]


def _run_bounds(s: torch.Tensor):
    """For a sorted array: (first mask, run start index, run end index,
    exclusive), int64, by scans (cummax; a reversed cummin)."""
    n = s.shape[0]
    idx = torch.arange(n, device=s.device)
    first, last = _run_edges(s)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    end = torch.where(last, idx + 1, n).flip(0).cummin(0).values.flip(0)
    return first, start, end


def _run_valid_counts(s_valid: torch.Tensor, start: torch.Tensor,
                      end: torch.Tensor) -> torch.Tensor:
    """Valid members of each element's run, by a cumsum over run bounds."""
    csum = torch.cumsum(s_valid, 0)
    return csum[end - 1] - csum[start] + s_valid[start].long()


def merge_rounds_needed(first, start, end, run_valid) -> int:
    """Doubling rounds that merge every run holding a valid member:
    ceil(log2(longest such run)).  Runs without one are never kept, so
    their merge is moot.  One device sync."""
    lens = torch.where(first & (run_valid > 0), end - start, 0)
    longest = int(lens.max()) if lens.numel() else 0
    return max(longest - 1, 0).bit_length()


def _round_partners(start: torch.Tensor, rounds: int,
                    live: torch.Tensor | None = None):
    """(d, i) for each doubling round: the slots i whose partner i + d
    lies in their run (run start ``start``), and, given ``live``, only
    slots of live runs."""
    for r in range(rounds):
        d = 1 << r
        pair = start[d:] == start[:-d]
        if live is not None:
            pair &= live[:-d]
        yield d, torch.nonzero(pair).squeeze(1)


def _merge_rounds(tax: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                  tab: torch.Tensor, rounds: int, kind: str,
                  live: torch.Tensor) -> torch.Tensor:
    """The doubling LCA merge: after round r every slot holds the LCA of
    the next 2^(r+1) slots of its run, so the run's first slot holds the
    run's LCA once 2^rounds >= the run's length.  Only slots of live runs
    (``live``: the run holds a valid member; no other run is kept) whose
    partner at distance d lies in their run are touched; the live run
    heads' ids are the result (other slots are left partly merged).
    Skipping the dead runs keeps the sentinel run of a mostly invalid
    input (a sketch's unselected windows) out of the rounds."""
    out = tax.clone()
    if kind == "table":
        for d, i in _round_partners(start, rounds, live):
            out[i] = lca_pairs_compact(out[i], out[i + d], tab)
        return out
    # paths: only slots of live runs with 2+ members take path rows; a run
    # stays contiguous among them, so partners keep their distance
    sub = torch.nonzero((end - start > 1) & live).squeeze(1)
    if sub.numel() == 0:
        return out
    P = tab[tax[sub].long()]  # (m, Dp)
    cols = torch.arange(P.shape[1], device=P.device)
    s_start = start[sub]
    for d, i in _round_partners(s_start, rounds):
        a, q = P[i], P[i + d]
        # meet = common prefix; an empty path (taxid 0) is the identity
        ne = a != q
        cpd = torch.where(ne.any(1), ne.to(torch.uint8).argmax(1),
                          P.shape[1])
        merged = torch.where(cols[None, :] < cpd[:, None], a, -1)
        merged = torch.where(a[:, :1] < 0, q, merged)
        merged = torch.where(q[:, :1] < 0, a, merged)
        P[i] = merged
    heads = torch.nonzero(s_start == sub).squeeze(1)
    Ph = P[heads]
    depth = (Ph >= 0).sum(1)
    deepest = Ph.gather(1, (depth - 1).clamp(min=0)[:, None]).squeeze(1)
    out[sub[heads]] = torch.where(depth > 0, deepest, 0).to(out.dtype)
    return out


def collapse_keyed_taxids(keyed: torch.Tensor, ids: torch.Tensor,
                          valid: torch.Tensor, tab: torch.Tensor, kind: str,
                          code_bits: int = 64):
    """The LCA collapse of codes already keyed to CODE_SENTINEL where
    invalid: one K3 sort of (keyed, valid ? id | VALID_BIT : 0), then the
    merge rounds and run accounting.

    Returns (sorted codes, merged ids, first mask, valid members per
    run, valid mask), all aligned to the sorted order."""
    n = keyed.shape[0]
    dev = keyed.device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return keyed.clone(), ids.clone(), empty.bool(), empty, empty.bool()
    with stage("collapse", dev):
        valid = valid.bool()
        payload = torch.where(valid, ids.to(torch.int32) | _VALID_BIT,
                              0).to(torch.int32)
    with stage("k3", dev):
        s_codes, s_pay = radix_sort_kv_u64(keyed, payload, code_bits)
    with stage("collapse", dev):
        s_valid = s_pay >= _VALID_BIT
        tax = torch.where(s_valid, s_pay & (_VALID_BIT - 1), 0)
        first, start, end = _run_bounds(s_codes)
        run_valid = _run_valid_counts(s_valid, start, end)
        rounds = merge_rounds_needed(first, start, end, run_valid)
    with stage("lca", dev):
        tax = _merge_rounds(tax, start, end, tab, rounds, kind,
                            run_valid > 0)
    return s_codes, tax, first, run_valid, s_valid
