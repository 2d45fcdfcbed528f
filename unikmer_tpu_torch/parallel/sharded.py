"""Hash-range sharded k-mer sets over a mesh of devices (port of
unikmer_tpu/parallel/sharded.py).

The set is range-partitioned by code value: shard j owns the codes in
[boundaries[j], boundaries[j+1]), so the shards' sorted sets, taken in
shard order, make the globally sorted set.

  * build (``count --mesh``): the flat packed bases are cut into D rows
    with halos (:func:`pack_host_shards`, :func:`shard_halos`), so each
    window or sketch emission is computed in full and owned by one row.
    Each shard encodes its row on its device (models/count._encode_piece:
    K1 for 2-bit codes, H1 for hashed ones, H1 then S1 for sketches),
    keeps the valid windows it owns, sorts them with K2 (K3 with the
    compact taxid ids of ``count -T``), splits them into D value ranges
    by a binary search for the boundaries, and sends range b to shard b
    (:func:`_exchange`, the counterpart of ``jax.lax.all_to_all``).  Each
    shard collapses what it received (ops/sort, or the LCA collapse of
    taxonomy/lca), and the host concatenates the shards' results.
    :func:`build_sharded_distinct` and :func:`build_sharded_taxids` are
    that step over given rows.
  * across processes (pipeline/distributed.py): with a torch.distributed
    group of W ranks, each holding L local shards, shard g = rank * L + l
    of D = W * L owns range g as above, and the exchange is one
    ``all_to_all_single`` a plane between the ranks
    (:func:`_exchange_group`: NCCL between cards, gloo on the CPU or for
    ranks sharing a card); each rank keeps its own shards' results.
  * set operations (``union``/``inter``/``diff``/``common --mesh``): the
    deduplicated inputs are range-partitioned on the host
    (:func:`partition_host_set`) and reduced shard by shard with the
    single-device routes of ops/device_sets.

A process runs its shards one after another; a shard on ``cuda:i``
launches its kernels there.  Buckets are sized exactly from
each shard's split, so the JAX package's static capacity, dropped count
and retry loop (``_cap_quantum``, ``_default_capacity``) are not
ported, nor its packed-key taxid exchange and staged programs: they
are TPU static-shape and compile workarounds (ROADMAP.md).

A real all-ones code (poly-T at k = 32 without -K, or a hash of 2^64-1)
is a valid window like any other here: it sorts last, lands in the last
shard, and that shard's collapse keeps it by the single-device sentinel
accounting (ops/sort, taxonomy/lca), the rule the JAX package applies
by re-appending it (sharded.py:181-186, :750-761).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..models.count import (
    CountConfig, _PartialSink, _capped_cfgs, _encode_piece,
    _stream_chunk_bases, count_taxids_step, packed_chunks, split_packed,
    stream_taxid_pieces,
)
from ..ops import device_sets
from ..ops import sets as host_sets
from ..ops.codec import INVALID_BASE, SIGN
from ..ops.device_sets import _to_device, fits
from ..ops.radix_sort import radix_sort_kv_u64
from ..ops.sort import _sort_u64, collapse_dual_keyed, collapse_keyed
from ..taxonomy.lca import compact_ids, device_lca_plan, upload_plan
from ..utils.stages import stage
from .mesh import Mesh, as_mesh

SENT = np.uint64((1 << 64) - 1)  # CODE_SENTINEL
OPS = ("union", "inter", "diff", "common")


def partition_boundaries(n_shards: int, cfg, code_bits: int) -> np.ndarray:
    """LOWER bucket boundaries ((n_shards,) uint64, first 0): shard j
    owns codes in [boundaries[j], boundaries[j+1]).  Balanced for the
    code distribution: canonical 2-bit codes (CDF 2x - x^2) at
    1 - sqrt(1 - j/D); scaled hashes over [0, max_hash]; uniform codes
    in equal ranges."""
    space = float(2 ** code_bits)
    fracs = np.arange(n_shards, dtype=np.float64) / n_shards
    hashed = bool(getattr(cfg, "hashed", False))
    canonical = bool(getattr(cfg, "canonical", False))
    scale = int(getattr(cfg, "scale", 1))
    if hashed and scale > 1:
        from ..ops.nthash import scaled_max_hash

        space = float(scaled_max_hash(scale)) + 1.0
        xs = fracs
    elif canonical and not hashed:
        xs = 1.0 - np.sqrt(1.0 - fracs)
    else:
        xs = fracs
    b = np.minimum(xs * space, space - 1).astype(np.uint64)
    b[0] = 0
    return np.maximum.accumulate(b)  # monotone even at float resolution


def shard_halos(cfg: CountConfig) -> tuple[int, int]:
    """(front, back) halo bases a shard row needs so every window or
    sketch emission is computed exactly and owned once: k-mers and
    syncmers read the k bases ahead (back = k-1); the minimizer looks
    ahead over w k-mers (back = w+k-2) and compares with the previous
    window's pick (front = 1)."""
    if cfg.minimizer_w > 0:
        return 1, cfg.minimizer_w + cfg.k - 2
    return 0, cfg.k - 1


def pack_host_rows(values: np.ndarray, n_shards: int, front: int,
                   back: int, fill) -> np.ndarray:
    """(n_shards, front + ceil(n/D) + back) rows of ``values``: row i
    holds slice i with ``front`` values of the previous slice and
    ``back`` of the next, ``fill`` past either end."""
    n = len(values)
    per = -(-n // n_shards)
    row_len = front + per + back
    out = np.full((n_shards, row_len), fill, dtype=values.dtype)
    for i in range(n_shards):
        lo = i * per - front
        hi = min(lo + row_len, n)
        src_lo = max(lo, 0)
        if src_lo < n:
            out[i, src_lo - lo: hi - lo] = values[src_lo:hi]
    return out


def pack_host_shards(bases: np.ndarray, n_shards: int, k: int,
                     front: int = 0, back: int | None = None) -> np.ndarray:
    """A flat packed base array as n_shards halo rows (pack_host_rows,
    padded with INVALID_BASE; ``back`` defaults to k-1): every window of
    the flat array starts at an owned position of exactly one row."""
    if back is None:
        back = k - 1
    return pack_host_rows(np.asarray(bases, np.uint8), n_shards, front,
                          back, INVALID_BASE)


def _shard_edges(codes: np.ndarray, n_shards: int,
                 code_bits: int) -> np.ndarray:
    """The n_shards + 1 edges of a sorted host set's shards: shard i
    holds the codes whose top log2(D) bits of ``code_bits`` are i, the
    last shard the rest."""
    log_d = int(np.ceil(np.log2(n_shards))) if n_shards > 1 else 0
    shift = np.uint64(max(code_bits - log_d, 0))
    lows = np.arange(1, n_shards, dtype=np.uint64) << shift
    return np.concatenate([[0], np.searchsorted(codes, lows), [len(codes)]])


def partition_host_set(codes: np.ndarray, n_shards: int, capacity: int,
                       code_bits: int = 64, taxids: np.ndarray | None = None):
    """A sorted host set as (n_shards, capacity) rows (shard i's codes,
    :func:`_shard_edges`), CODE_SENTINEL padded; with ``taxids`` also
    their (n_shards, capacity) uint32 rows.  Raises ValueError when a
    shard holds more than ``capacity`` codes."""
    edges = _shard_edges(codes, n_shards, code_bits)
    out = np.full((n_shards, capacity), SENT, dtype=np.uint64)
    out_t = (
        np.zeros((n_shards, capacity), np.uint32) if taxids is not None else None
    )
    for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
        if hi - lo > capacity:
            raise ValueError(
                f"shard {i} needs {hi - lo} slots > capacity {capacity}"
            )
        out[i, : hi - lo] = codes[lo:hi]
        if out_t is not None:
            out_t[i, : hi - lo] = taxids[lo:hi]
    if out_t is not None:
        return out, out_t
    return out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x)


def _collect_sharded(out, counts) -> np.ndarray:
    """The shards' sorted prefixes ``out[i][:counts[i]]`` (a (D, C) array
    or D tensors) concatenated in shard order: the globally sorted set."""
    parts = [_host(o[: int(n)]).view(np.uint64) for o, n in zip(out, counts)]
    return np.concatenate(parts) if parts else np.zeros(0, np.uint64)


def _collect_sharded_taxids(out_c, out_t, counts):
    """(codes, compact ids as int64) of the shards' prefixes."""
    if len(out_c) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    ids = [_host(t[: int(n)]).astype(np.int64) for t, n in zip(out_t, counts)]
    return _collect_sharded(out_c, counts), np.concatenate(ids)


# ---------------------------------------------------------------------
# the sharded build


def _owned(row: np.ndarray, cfg: CountConfig, dev: torch.device,
           front: int, back: int):
    """(keyed codes, index) of the valid windows a row owns: those
    starting at [front, len(row) - back).  A sketch's halo windows are
    computed, since the selection reads them, and only then dropped."""
    keyed, valid = _encode_piece(row, cfg, dev)
    with stage("own", dev):
        valid[:front] = False
        valid[len(row) - back:] = False
        idx = torch.nonzero(valid).squeeze(1)
        return keyed[idx], idx


def _bucket_edges(s: torch.Tensor, bnd: np.ndarray) -> list[int]:
    """The D+1 edges of sorted keys ``s`` over the value ranges of the
    lower boundaries ``bnd``: a binary search in int64 with the sign bit
    flipped (unsigned order; torch has no uint64 search), as
    ops/device_sets._lookup does."""
    flipped = torch.from_numpy(bnd.view(np.int64) ^ np.int64(SIGN)).to(
        s.device)
    edges = torch.searchsorted(s ^ SIGN, flipped)
    return edges.tolist() + [s.shape[0]]


def _exchange(parts, edges, mesh: Mesh, group=None):
    """parts[i]: a tuple of aligned 1-D tensors on local shard i sorted by
    code, edges[i] their D+1 bucket edges.  Returns for each local shard
    b the tuple of range b of every shard, in global shard order, on
    mesh[b].  Without a group every shard is local (D = len(mesh)) and
    the ranges are tensor copies; with one, :func:`_exchange_group`.
    torch.cat copies, so no shard's input aliases another's buffer,
    though t.to(dev) returns t itself where t lies on dev already."""
    if group is not None:
        return _exchange_group(parts, edges, mesh, group)
    out = []
    for b, dev in enumerate(mesh):
        with stage("exchange", dev):
            out.append(tuple(
                torch.cat([p[j][e[b]: e[b + 1]].to(dev)
                           for p, e in zip(parts, edges)])
                for j in range(len(parts[0]))))
    return out


def group_shards(mesh: Mesh, group=None) -> tuple[int, int]:
    """(D, first global shard) of this rank's ``mesh`` in ``group``: W
    ranks of len(mesh) local shards each, shard g = rank * L + l."""
    if group is None:
        return len(mesh), 0
    import torch.distributed as dist

    n_local = len(mesh)
    return (dist.get_world_size(group) * n_local,
            dist.get_rank(group) * n_local)


def all_reduce_sum(n: torch.Tensor, group=None) -> torch.Tensor:
    """An int64 scalar summed over the ranks of ``group`` (the psum of
    the JAX package), on n's device; n itself without a group."""
    if group is None:
        return n
    import torch.distributed as dist

    t = n.to(torch.int64).reshape(1).clone()
    dist.all_reduce(t, group=group)
    return t.reshape(())


def _exchange_group(parts, edges, mesh: Mesh, group):
    """:func:`_exchange` across the ranks of a torch.distributed group
    (the counterpart of jax.lax.all_to_all between processes): an
    all_gather of every local shard's bucket sizes gives each rank the
    D x D matrix of sizes, then one all_to_all_single a plane moves the
    ranges, on the first local shard's device (NCCL and gloo both take
    tensors on the card; gloo copies them through host memory).  The
    send buffer holds, for each rank q, for each shard b of q, for each
    local shard l, range b of shard l; the receiver cuts its buffer by
    source rank, then by its own shard, then by the sender's shard, and
    joins each shard's ranges in global shard order.  Every rank enters
    the same collectives, with empty ranges where it has nothing to
    send."""
    import torch.distributed as dist

    n_local = len(mesh)
    w = dist.get_world_size(group)
    rank = dist.get_rank(group)
    d = w * n_local
    home = mesh[0]
    with stage("exchange", home):
        sizes = torch.tensor([[e[b + 1] - e[b] for b in range(d)]
                              for e in edges], dtype=torch.int64,
                             device=home)
        gathered = [torch.empty_like(sizes) for _ in range(w)]
        dist.all_gather(gathered, sizes, group=group)
        # m[p, l, q, j]: the codes shard p * L + l sends to shard q * L + j
        m = torch.cat(gathered).cpu().numpy().reshape(w, n_local, w, n_local)
        in_splits = m[rank].sum(axis=(0, 2)).tolist()
        out_splits = m[:, :, rank].sum(axis=(1, 2)).tolist()
        # the received ranges in buffer order: source rank p, my shard j,
        # p's shard l
        recv_sizes = m[:, :, rank].transpose(0, 2, 1)
        offs = (np.cumsum(recv_sizes.reshape(-1)) - recv_sizes.reshape(-1)
                ).reshape(recv_sizes.shape)
        out = [[] for _ in range(n_local)]
        for j in range(len(parts[0])):
            send = torch.cat([
                p[j][e[b]: e[b + 1]].to(home)
                for b in range(d) for p, e in zip(parts, edges)])
            buf = torch.empty(sum(out_splits), dtype=send.dtype,
                              device=home)
            dist.all_to_all_single(buf, send, out_splits, in_splits,
                                   group=group)
            del send
            for jj, dev in enumerate(mesh):
                out[jj].append(torch.cat([
                    buf[int(offs[p, jj, l]):
                        int(offs[p, jj, l] + recv_sizes[p, jj, l])]
                    for p in range(w) for l in range(n_local)]).to(dev))
    return [tuple(o) for o in out]


def build_sharded_distinct(rows: np.ndarray, cfg: CountConfig, mesh: Mesh,
                           group=None, modes=None):
    """The sharded count's step over halo rows (:func:`pack_host_shards`
    with :func:`shard_halos`), one row a local shard of ``mesh``: each
    shard encodes its row, keeps the valid windows it owns, sorts them
    (K2) and sends range b to shard b; each shard collapses what it
    received.  Without a group ``rows`` are all D rows; with one, this
    rank's L rows, and the D = W * L shards exchange across the ranks.
    Returns for each of ``modes`` (default (cfg.mode,); or the pair
    ('distinct', 'repeated'), from one sort a shard) the (codes, n) of
    each local shard: codes[:n] its sorted kept codes, on its device.
    Every occurrence of a code reaches its owner shard, so the
    multiplicity modes are exact."""
    modes = tuple(modes or (cfg.mode,))
    d, _ = group_shards(mesh, group)
    front, back = shard_halos(cfg)
    bnd = partition_boundaries(d, cfg, cfg.code_bits)
    parts, edges = [], []
    for row, dev in zip(rows, mesh):
        keyed, _ = _owned(row, cfg, dev, front, back)
        with stage("sort", dev):
            s = _sort_u64(keyed, cfg.code_bits)
        del keyed
        edges.append(_bucket_edges(s, bnd))
        parts.append((s,))
    recv = _exchange(parts, edges, mesh, group)
    del parts
    outs = [[] for _ in modes]
    dual = modes == ("distinct", "repeated")
    for (mine,), dev in zip(recv, mesh):
        ones = torch.ones(mine.shape, dtype=torch.bool, device=dev)
        if dual:
            od, nd, orp, nr = collapse_dual_keyed(mine, ones, cfg.code_bits)
            res = [(od, nd), (orp, nr)]
        else:
            res = [collapse_keyed(mine, ones, m, cfg.code_bits)
                   for m in modes]
        for o, r in zip(outs, res):
            o.append(r)
    return outs


def _build(bases: np.ndarray, cfg: CountConfig, mesh: Mesh,
           modes=("distinct",)) -> list[np.ndarray]:
    """The sharded count of one flat packed base array in this process:
    for each of ``modes`` (:func:`build_sharded_distinct`) the sorted
    kept codes on the host."""
    if len(bases) < cfg.k:
        return [np.zeros(0, np.uint64) for _ in modes]
    front, back = shard_halos(cfg)
    rows = pack_host_shards(bases, len(mesh), cfg.k, front, back)
    outs = build_sharded_distinct(rows, cfg, mesh, modes=modes)
    with stage("d2h", "cpu"):
        return [_collect_sharded([o for o, _ in r], [n for _, n in r])
                for r in outs]


def mesh_count_distinct(bases: np.ndarray, cfg: CountConfig,
                        mesh=None) -> np.ndarray:
    """``count --mesh N`` of one flat packed base array: the sorted codes
    kept by cfg.mode.  ``mesh``: a Mesh, or a device count (None: every
    device)."""
    return _build(np.asarray(bases, np.uint8), cfg, as_mesh(mesh),
                  (cfg.mode,))[0]


def mesh_count_stream_packed(packed_iter, cfg: CountConfig, mesh=None,
                             chunk_bases: int | None = None):
    """Streaming ``count --mesh``: every PackedSeqs is cut into pieces
    (models/count.split_packed; 2^25 bases on CUDA), each piece runs the
    sharded build, and the pieces merge through the single-device
    stream's capped-multiplicity sink, its beyond-RAM spill included
    (UNIKMER_TPU_COUNT_MEM_MB).  Returns np.ndarray or SpilledCount."""
    mesh = as_mesh(mesh)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(mesh[0])
    distinct_cfg, repeated_cfg = _capped_cfgs(cfg)
    modes = (cfg.mode,) if repeated_cfg is None else ("distinct", "repeated")
    sink = _PartialSink(cfg)
    it = iter(packed_iter)
    while True:
        with stage("ingest", torch.device("cpu")):
            packed = next(it, None)
        if packed is None:
            break
        for piece in split_packed(packed, chunk_bases,
                                  cfg.k if cfg.segmentable else 0):
            for u in _build(piece.bases, distinct_cfg, mesh, modes):
                if len(u):
                    sink.add(u)
    return sink.result()


def mesh_count_stream(records, cfg: CountConfig, mesh=None,
                      chunk_bases: int | None = None):
    """:func:`mesh_count_stream_packed` over FASTA/Q records, packed in
    chunks of about ``chunk_bases`` bases."""
    mesh = as_mesh(mesh)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(mesh[0])
    return mesh_count_stream_packed(packed_chunks(records, cfg, chunk_bases),
                                    cfg, mesh, chunk_bases)


def build_sharded_taxids(rows: np.ndarray, trows: np.ndarray,
                         cfg: CountConfig, mesh: Mesh, plans: dict,
                         group=None, modes=None):
    """The sharded ``count -T`` step over halo rows of bases and of each
    position's compact taxid id (:func:`pack_host_rows`), one row a local
    shard: each shard sorts its owned (code, id) pairs with K3 and sends
    them by code range; the owner collapses them with the single-device
    LCA collapse (models/count.count_taxids_step).  ``plans``: the
    uploaded :func:`device_lca_plan` of each device.  With a group,
    ``rows`` and ``trows`` are this rank's L rows, and every rank must
    hold the same plan, since compact ids are positions in its closure:
    build it from the global taxids, not a rank's own.  Returns for each
    of ``modes`` (default (cfg.mode,)) the (codes, ids, n) of each local
    shard, the ids compact."""
    modes = tuple(modes or (cfg.mode,))
    d, _ = group_shards(mesh, group)
    front, back = shard_halos(cfg)
    bnd = partition_boundaries(d, cfg, cfg.code_bits)
    parts, edges = [], []
    for row, trow, dev in zip(rows, trows, mesh):
        keyed, idx = _owned(row, cfg, dev, front, back)
        with stage("h2d", dev):
            ids = torch.from_numpy(trow).to(dev)[idx]
        with stage("k3", dev):
            s, sv = radix_sort_kv_u64(keyed, ids, cfg.code_bits)
        del keyed, ids
        edges.append(_bucket_edges(s, bnd))
        parts.append((s, sv))
    recv = _exchange(parts, edges, mesh, group)
    del parts
    per_mode = [[] for _ in modes]
    for (codes, ids), dev in zip(recv, mesh):
        ones = torch.ones(codes.shape, dtype=torch.bool, device=dev)
        for acc, res in zip(per_mode, count_taxids_step(
                codes, ones, ids, plans[dev], cfg, modes)):
            acc.append(res)
    return per_mode


def _taxid_build(bases: np.ndarray, pos_ctax: np.ndarray, cfg: CountConfig,
                 mesh: Mesh, plans: dict, modes):
    """The sharded ``count -T`` of one flat packed base array with each
    position's compact taxid id in this process: for each of ``modes``
    the host (codes, taxids), LCA-merged (:func:`build_sharded_taxids`)."""
    front, back = shard_halos(cfg)
    d = len(mesh)
    rows = pack_host_shards(bases, d, cfg.k, front, back)
    trows = pack_host_rows(pos_ctax, d, front, back, np.int32(0))
    per_mode = build_sharded_taxids(rows, trows, cfg, mesh, plans,
                                    modes=modes)
    closure = plans[mesh[0]][1]
    out = []
    with stage("d2h", "cpu"):
        for res in per_mode:
            codes, ids = _collect_sharded_taxids(*zip(*res))
            out.append((codes, closure[ids].astype(np.uint32)))
    return out


def mesh_count_taxids(packed, rec_taxids: np.ndarray, taxdb,
                      cfg: CountConfig, mesh=None):
    """``count -T --mesh N``: packed records and their taxids -> the
    LCA-merged sorted (codes, taxids) by cfg.mode, through the sharded
    build, in pieces as the single-device -T streams them
    (models/count.stream_taxid_pieces).  Returns None where the
    single-device engines own the semantics: unknown nonzero taxids
    (device_lca_plan declines) and the compat syncmer, whose emission
    depends on whole records."""
    if cfg.needs_record_sep:
        return None
    plan = device_lca_plan(taxdb, rec_taxids)
    if plan is None:
        return None
    mesh = as_mesh(mesh)
    bases = np.asarray(packed.bases, np.uint8)
    if len(bases) < cfg.k:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    spans = np.diff(np.append(packed.starts, len(bases)))
    pos_ctax = np.repeat(compact_ids(plan[1], rec_taxids), spans)
    plans = {dev: upload_plan(plan, dev) for dev in set(mesh)}

    def collapse(piece, off, modes):
        return _taxid_build(piece.bases,
                            pos_ctax[off: off + len(piece.bases)], cfg, mesh,
                            plans, modes)

    chunk = _stream_chunk_bases(mesh[0])
    if len(bases) > chunk:
        return stream_taxid_pieces(packed, cfg, taxdb, chunk, collapse)
    return collapse(packed, 0, (cfg.mode,))[0]


# ---------------------------------------------------------------------
# sharded set operations


def _upload(mesh: Mesh, rows: np.ndarray, dtype=np.uint64) -> list:
    """Row i of a host array on mesh[i] (u64 as int64 bit patterns)."""
    if dtype == np.uint64:
        return [_to_device(r, dev) for r, dev in zip(rows, mesh)]
    return [torch.from_numpy(np.ascontiguousarray(r, dtype)).to(dev)
            for r, dev in zip(rows, mesh)]


def sharded_common(sets: list, threshold: int, code_bits: int = 64):
    """Per shard: the codes in >= threshold of its stacked padded sets
    (sets[i]: an (F, C) tensor on shard i) -> [(codes, n)]."""
    return [device_sets.common(s, threshold, code_bits) for s in sets]


def sharded_set_op(op: str, a: list, b: list, code_bits: int = 64):
    """Per-shard merge-join of two aligned range-partitioned padded
    sorted sets, op 'union', 'inter' or 'diff' -> [(codes, n)]."""
    if op == "union":
        return [device_sets.union(x, y, code_bits) for x, y in zip(a, b)]
    if op == "inter":
        return [device_sets.intersect(x, y) for x, y in zip(a, b)]
    if op == "diff":
        return [device_sets.subtract(x, y) for x, y in zip(a, b)]
    raise ValueError(f"unknown sharded set op: {op}")


def _total(counts: list, group=None) -> torch.Tensor:
    """The shards' counts summed, and over the ranks of ``group``."""
    dev = counts[0].device
    return all_reduce_sum(torch.stack([n.to(dev) for n in counts]).sum(),
                          group)


def sharded_union_counts(a: list, b: list, code_bits: int = 64, group=None):
    """Per shard: the union of two aligned range-partitioned padded
    sorted sets (device_sets.union) -> ([(codes, n)], total), the total
    the kept codes of every shard, summed over the ranks of ``group``
    (the JAX package's psum)."""
    res = sharded_set_op("union", a, b, code_bits)
    return res, _total([n for _, n in res], group)


def sharded_union_taxids(a: list, ta: list, b: list, tb: list, parent,
                         depth, max_depth: int, group=None):
    """Per shard: the LCA-merging union of aligned (codes, taxids) shards
    by the tree walk (device_sets.union_with_taxids; ``parent``,
    ``depth`` and ``max_depth`` of taxonomy/lca.device_tables, moved to
    each shard's device) -> ([(codes, taxids, n)], total), the total as
    :func:`sharded_union_counts` sums it."""
    res = [device_sets.union_with_taxids(x, tx, y, ty, parent.to(x.device),
                                         depth.to(x.device), max_depth, 1)
           for x, tx, y, ty in zip(a, ta, b, tb)]
    return res, _total([n for _, _, n in res], group)


def sharded_setop_taxids(codes: list, ids: list, tabs: list, kind: str,
                         threshold: int, code_bits: int = 64):
    """Per shard: threshold set algebra with LCA-merged compact ids over
    its stacked padded sets (device_sets.setop_taxids_compact; ``tabs``
    the uploaded LCA table of each shard's device) -> [(codes, ids, n)]."""
    return [device_sets.setop_taxids_compact(c.reshape(-1), t.reshape(-1),
                                             tab, kind, threshold, code_bits)
            for c, t, tab in zip(codes, ids, tabs)]


def sharded_diff_taxids(a: list, ta: list, u: list):
    """Per shard: a - u keeping a's taxid column -> [(codes, ids, n)]."""
    return [device_sets.subtract_with_taxids(x, t, y)
            for x, t, y in zip(a, ta, u)]


def _distinct(codes) -> np.ndarray:
    """np.unique of a code array, in one pass when it is sorted."""
    c = np.ascontiguousarray(codes, np.uint64)
    if not host_sets._is_sorted(c):
        c = native.host_sort(c)
    return host_sets.dedup_sorted(c, None)[0]


def _file_reduce(taxdb, codes, taxids):
    """taxdb.lca_reduce of one file's codes and taxids, which passes a
    strictly increasing file (a sorted .unik set) through as it is."""
    c = np.ascontiguousarray(codes, np.uint64)
    t = np.ascontiguousarray(taxids, np.uint32)
    if len(c) < 2 or bool((c[1:] > c[:-1]).all()):
        return c, t
    return taxdb.lca_reduce(c, t)


def _sentinel_in(op: str, has_sent: list, threshold) -> bool:
    """Is the all-ones code in the result: decided on the host, since it
    doubles as the device padding."""
    if op == "union":
        return any(has_sent)
    if op == "inter":
        return all(has_sent)
    if op == "common":
        return sum(has_sent) >= int(threshold)
    return has_sent[0] and not any(has_sent[1:])


def _partition(arrs, d: int, code_bits: int, taxids=None):
    """The sorted inputs as partition_host_set rows of one capacity, the
    most codes any input puts in one shard."""
    cap = max([1] + [int(np.diff(_shard_edges(a, d, code_bits)).max())
                     for a in arrs])
    if taxids is None:
        return [partition_host_set(a, d, cap, code_bits) for a in arrs], cap
    return [partition_host_set(a, d, cap, code_bits, taxids=t)
            for a, t in zip(arrs, taxids)], cap


def _admitted(mesh: Mesh, needs) -> bool:
    """Do the shards' routes fit their devices?  ``needs``: (route,
    slots a shard, path columns, table bytes) for each route a shard
    runs; a device holds the slots of every shard it hosts (all D when
    they share one card), as ops/device_sets.fits counts them."""
    for dev in set(mesh):
        held = mesh.count(dev)
        for route, slots, columns, table_bytes in needs:
            if not fits(route, dev, held * slots, columns, table_bytes):
                return False
    return True


def mesh_set_op(op: str, code_arrays: list, mesh=None, code_bits: int = 64,
                threshold: int | None = None):
    """``union``/``inter``/``diff``/``common --mesh N`` over inputs
    without taxids: the inputs are deduplicated, range-partitioned over
    the mesh and reduced shard by shard (union: in >= 1 set, inter: in
    all F, common: in >= threshold, diff: the first less the union of
    the rest).  Returns the sorted codes, or None when the shards pass
    the element budget of their route (the caller takes the port's route
    without --mesh, the host engine)."""
    if op not in OPS:
        raise ValueError(f"unknown mesh set op: {op}")
    arrs = [_distinct(c) for c in code_arrays]
    if not arrs:
        return np.zeros(0, np.uint64)
    has_sent = [len(a) > 0 and a[-1] == SENT for a in arrs]
    arrs = [a[:-1] if h else a for a, h in zip(arrs, has_sent)]
    sent_in = _sentinel_in(op, has_sent, threshold)
    tail = [np.array([SENT], np.uint64)] if sent_in else []
    if op == "diff" and len(arrs) == 1:
        return np.concatenate([arrs[0], *tail])
    mesh = as_mesh(mesh)
    parts, cap = _partition(arrs, len(mesh), code_bits)
    nf = len(arrs)
    if op == "diff":
        needs = [("common", (nf - 1) * cap, 0, 0),
                 ("subtract", nf * cap, 0, 0)]
    else:
        needs = [("common", nf * cap, 0, 0)]
    if not _admitted(mesh, needs):
        return None
    if op == "diff":
        rest = _upload(mesh, np.stack(parts[1:], axis=1))  # (D, F-1, C)
        u = [c for c, _ in sharded_common(rest, 1, code_bits)]
        del rest
        res = sharded_set_op("diff", _upload(mesh, parts[0]), u, code_bits)
    else:
        thr = 1 if op == "union" else nf if op == "inter" else int(threshold)
        res = sharded_common(_upload(mesh, np.stack(parts, axis=1)), thr,
                             code_bits)
    with stage("d2h", "cpu"):
        out = _collect_sharded([c for c, _ in res], [n for _, n in res])
    return np.concatenate([out, *tail])


def mesh_set_op_taxids(op: str, code_arrays: list, taxid_arrays: list,
                       taxdb, mesh=None, code_bits: int = 64,
                       threshold: int | None = None):
    """``union``/``inter``/``diff``/``common --mesh N`` over inputs with
    taxids: each file's codes LCA-reduced on the host (threshold counts
    are file-presence counts), range-partitioned with their compact ids,
    then one threshold collapse a shard through the vocabulary's LCA
    table (taxonomy/lca.device_lca_plan); diff keeps the first file's
    taxids.  Returns (codes, taxids), or None where the port's route
    without --mesh owns the work: unknown nonzero taxids (their merge
    depends on order), or shards past their route's element budget."""
    if op not in OPS:
        raise ValueError(f"unknown mesh taxid set op: {op}")
    all_tax = np.concatenate(
        [np.asarray(t, np.uint32) for t in taxid_arrays]
    ) if taxid_arrays else np.zeros(0, np.uint32)
    plan = device_lca_plan(taxdb, all_tax)
    if plan is None:
        return None
    kind, closure, tab = plan
    arrs = [_file_reduce(taxdb, c, t) for c, t in zip(code_arrays,
                                                      taxid_arrays)]
    if not arrs:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    has_sent = [len(a) > 0 and a[-1] == SENT for a, _ in arrs]
    sent_tax = [t[-1] for (_, t), h in zip(arrs, has_sent) if h]
    arrs = [(a[:-1], t[:-1]) if h else (a, t)
            for (a, t), h in zip(arrs, has_sent)]
    nf = len(arrs)
    sent_in = _sentinel_in(op, has_sent, threshold)
    tail_c, tail_t = [], []
    if sent_in:
        if op == "diff":
            merged = np.uint32(sent_tax[0])
        else:
            merged = np.uint32(0)
            for t in sent_tax:
                merged = taxdb.lca_pairs(np.array([merged]),
                                         np.array([t]))[0]
        tail_c = [np.array([SENT], np.uint64)]
        tail_t = [np.array([merged], np.uint32)]
    if op == "diff" and nf == 1:
        res_c, res_t = arrs[0]
        return (np.concatenate([res_c, *tail_c]),
                np.concatenate([res_t, *tail_t]))
    mesh = as_mesh(mesh)
    parts, cap = _partition(
        [a for a, _ in arrs], len(mesh), code_bits,
        [compact_ids(closure, t).astype(np.uint32) for _, t in arrs])
    columns = tab.shape[1] if kind == "paths" else 0
    if op == "diff":
        needs = [("common", (nf - 1) * cap, 0, 0),
                 ("subtract_taxids", nf * cap, 0, 0)]
    else:
        needs = [(f"union_taxids_{kind}", nf * cap, columns, tab.nbytes)]
    if not _admitted(mesh, needs):
        return None
    if op == "diff":
        rest = _upload(mesh, np.stack([c for c, _ in parts[1:]], axis=1))
        u = [c for c, _ in sharded_common(rest, 1, code_bits)]
        del rest
        res = sharded_diff_taxids(
            _upload(mesh, parts[0][0]),
            _upload(mesh, parts[0][1].view(np.int32), np.int32), u)
    else:
        thr = 1 if op == "union" else nf if op == "inter" else int(threshold)
        tabs = {dev: upload_plan(plan, dev)[2] for dev in set(mesh)}
        res = sharded_setop_taxids(
            _upload(mesh, np.stack([c for c, _ in parts], axis=1)),
            _upload(mesh, np.stack([t for _, t in parts], axis=1)
                    .view(np.int32), np.int32),
            [tabs[dev] for dev in mesh], kind, thr, code_bits)
    with stage("d2h", "cpu"):
        codes, ids = _collect_sharded_taxids(
            [c for c, _, _ in res], [t for _, t, _ in res],
            [n for _, _, n in res])
    return (np.concatenate([codes, *tail_c]),
            np.concatenate([closure[ids].astype(np.uint32), *tail_t]))
