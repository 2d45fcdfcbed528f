"""The count pipeline on PyTorch: FASTA/Q -> k-mer set (port of
unikmer_tpu/models/count.py: 2-bit codes, and ntHash codes for hashed
and scaled configs).

One piece of packed sequence runs as: host 2-bit pack (shared native
code), host-to-device copy, K1 (ops/encode.py: unpack + encode +
canonical + sentinel keying) or, for hashed configs, H1 (ops/nthash.py:
unpack + ntHash + canonical + scaled threshold + keying), K2 sort and
collapse (ops/sort.py), and a device-to-host copy of the kept prefix.
Streams cut the input into pieces at record boundaries (k-1-overlap
segments inside long records) and merge the per-piece sorted sets on
the host, spilling to external sort chunks beyond
UNIKMER_TPU_COUNT_MEM_MB, as the JAX package does.

Sketch configs (-W minimizer, -S closed syncmer, ``--syncmer-impl
compat``) encode a piece with H1 at scale 1 (the k-mers, and for
syncmers the s-mers too), then S1 (ops/sketch.py: window select, emit
rule and scaled threshold); the compat rule adds its vote and fill
passes in plain PyTorch around S1's argmin, with the record separators
carried to the card as a bitmask beside the 2-bit pack.  Sketch windows
depend on their neighbours, so a sketch piece holds whole records.

``count -T`` (per-record taxids, LCA-merged per code) runs the same
encode, then one K3 sort of (code, compact taxid id) pairs and the
merge rounds of taxonomy/lca.py; ``count -l`` is the encode alone, the
valid windows kept in genome order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields, replace as dc_replace

import numpy as np
import torch

from .. import native
from .._device import get_device
from ..io.fastx import PackedSeqs, pack_records
from ..ops import codec
from ..ops import sets as host_sets
from ..ops.codec import MAX_K_ENCODED, MAX_K_HASHED
from ..ops.encode import encode_2bit
from ..ops.nthash import (
    at_most, encode_nthash, nthash_windows, scaled_max_hash,
)
from ..ops.sketch import (
    compat_gap, minimizer_windows, sketch_select, syncmer_compat_select,
    syncmer_compat_windows, syncmer_windows, unpack_bits,
)
from ..ops.sort import (
    _compact, collapse_dual_keyed, collapse_keyed, collapse_sorted,
)
from ..taxonomy.lca import (
    collapse_keyed_taxids, compact_ids, device_lca_plan, upload_plan,
)
from ..utils.stages import stage

_HOST = torch.device("cpu")


@dataclass(frozen=True)
class CountConfig:
    """The fields and normalization of unikmer_tpu's CountConfig."""

    k: int
    canonical: bool = False
    hashed: bool = False
    scale: int = 1
    minimizer_w: int = 0
    syncmer_s: int = 0
    syncmer_impl: str = "edgar"  # edgar | compat
    circular: bool = False
    mode: str = "distinct"  # distinct | unique | repeated

    @classmethod
    def from_reference(cls, obj) -> "CountConfig":
        """A config with the field values of ``obj`` (e.g. a
        unikmer_tpu CountConfig), normalized again here."""
        return cls(**{f.name: getattr(obj, f.name) for f in fields(cls)})

    @property
    def code_bits(self) -> int:
        """True width of the codes: 2k for 2-bit codes, 64 for hashed.
        (unikmer_tpu's ``code_bits`` is its rounded TPU sort hint.)"""
        return 64 if self.hashed else 2 * self.k

    @property
    def segmentable(self) -> bool:
        """Windows are a function of k bases alone, so k-1-overlap
        segmentation partitions them exactly (not so for sketches)."""
        return self.minimizer_w == 0 and self.syncmer_s == 0

    @property
    def needs_record_sep(self) -> bool:
        return self.syncmer_s > 0 and self.syncmer_impl == "compat"

    @property
    def record_gap(self) -> int:
        """RECORD_SEP bytes between packed records: compat_gap for the
        compat syncmer, else 1."""
        if not self.needs_record_sep:
            return 1
        return compat_gap(self.k, self.syncmer_s)

    def __post_init__(self):
        if self.syncmer_s == 0 and self.syncmer_impl != "edgar":
            object.__setattr__(self, "syncmer_impl", "edgar")
        if self.k > MAX_K_ENCODED and not self.hashed:
            object.__setattr__(self, "hashed", True)
        if self.scale > 1 and not self.hashed:
            object.__setattr__(self, "hashed", True)
        if (self.minimizer_w > 0 or self.syncmer_s > 0) and not (
            self.hashed and self.canonical
        ):
            object.__setattr__(self, "hashed", True)
            object.__setattr__(self, "canonical", True)
        if self.minimizer_w > 0 and self.syncmer_s > 0:
            raise ValueError("minimizer and syncmer are mutually exclusive")
        if self.hashed and self.k > MAX_K_HASHED:
            raise ValueError(f"k must be <= {MAX_K_HASHED}")


def window_codes(bases: torch.Tensor, cfg: CountConfig):
    """Per-position (codes, valid) of a uint8 base tensor: 2-bit codes,
    or ntHash codes (hashed), kept at most scaled_max_hash (scaled); for
    sketches the (codes, emit) stream of ops/sketch.py, unscaled."""
    k = cfg.k
    if cfg.minimizer_w > 0:
        return minimizer_windows(bases, k, cfg.minimizer_w)
    if cfg.syncmer_s > 0:
        if cfg.syncmer_impl == "compat":
            return syncmer_compat_windows(bases, k, cfg.syncmer_s)
        return syncmer_windows(bases, k, cfg.syncmer_s)
    valid = codec.window_valid(bases, k)
    if cfg.hashed:
        codes = nthash_windows(bases, k, cfg.canonical)
    else:
        codes = codec.kmer_codes(bases, k)
        if cfg.canonical:
            codes = codec.canonical_code(codes, k)
    if cfg.scale > 1:
        valid = valid & at_most(codes, scaled_max_hash(cfg.scale))
    return codes, valid


def count_step(bases: torch.Tensor, cfg: CountConfig):
    """Base tensor -> (sorted dense prefix of kept codes, n)."""
    codes, valid = window_codes(bases, cfg)
    if cfg.scale > 1 and not cfg.segmentable:  # sketches: the selected codes
        valid = valid & at_most(codes, scaled_max_hash(cfg.scale))
    return collapse_sorted(codes, valid, mode=cfg.mode,
                           code_bits=cfg.code_bits)


def pack_bases_2bit(bases: np.ndarray):
    """(packed2 u8 [ceil(n/4)], validmask u8 [ceil(n/8)]): the host
    2-bit ingress pack, native when the library is there."""
    res = native.pack_bases_2bit(bases)
    if res is not None:
        return res
    n = len(bases)
    n4 = -(-n // 4) * 4
    n8 = -(-n // 8) * 8
    b = np.zeros(n4, np.uint8)
    np.copyto(b[:n], bases, casting="unsafe")
    valid = np.zeros(n8, bool)
    valid[:n] = bases < 4
    b = np.where(valid[:n4], b, 0).astype(np.uint8)
    quads = b.reshape(-1, 4)
    packed2 = (quads[:, 0] | (quads[:, 1] << 2) | (quads[:, 2] << 4)
               | (quads[:, 3] << 6)).astype(np.uint8)
    validmask = np.packbits(valid.reshape(-1, 8), axis=1, bitorder="little")
    return packed2, validmask.reshape(-1)


def _encode_piece(bases: np.ndarray, cfg: CountConfig, device: torch.device):
    """Pack, copy and encode one piece of bases -> (keyed, valid bool):
    K1 for 2-bit codes, H1 for hashed configs, H1 then S1 for sketches."""
    n = len(bases)
    with stage("pack", device):
        packed2, validmask = pack_bases_2bit(bases)
        # the 2-bit pack makes a separator an invalid base: the compat
        # rule reads the separators from a mask of their own
        sepmask = (np.packbits(bases == codec.RECORD_SEP, bitorder="little")
                   if cfg.needs_record_sep else None)
    with stage("h2d", device):
        p2 = torch.from_numpy(packed2).to(device)
        vm = torch.from_numpy(validmask).to(device)
        sm = None if sepmask is None else torch.from_numpy(sepmask).to(device)
    if not cfg.segmentable:
        keyed, valid = _encode_sketch(p2, vm, sm, n, cfg, device)
    elif cfg.hashed:
        with stage("h1", device):
            keyed, valid = encode_nthash(p2, vm, n, cfg.k, cfg.canonical,
                                         scaled_max_hash(cfg.scale))
    else:
        with stage("k1", device):
            keyed, valid = encode_2bit(p2, vm, n, cfg.k, cfg.canonical)
    return keyed, valid.view(torch.bool)


def _encode_sketch(p2, vm, sm, n: int, cfg: CountConfig,
                   device: torch.device):
    """A sketch piece: H1 at scale 1 over the k-mers (and the s-mers of a
    syncmer), then S1 with the scaled threshold."""
    k, s = cfg.k, cfg.syncmer_s
    if s > k:
        raise ValueError(f"syncmer s ({s}) must be <= k ({k})")
    max_hash = scaled_max_hash(cfg.scale)
    with stage("h1", device):
        kkeyed, kvalid = encode_nthash(p2, vm, n, k, True)
        # s == k: the s-mers are the k-mers
        skeyed = encode_nthash(p2, vm, n, s, True)[0] if 0 < s < k else kkeyed
    with stage("s1", device):
        if cfg.minimizer_w > 0:
            return sketch_select("minimizer", kkeyed, cfg.minimizer_w,
                                 valid=kvalid, max_hash=max_hash)
        if cfg.syncmer_impl == "edgar":
            return sketch_select("syncmer", skeyed, k - s + 1, valid=kvalid,
                                 khash=kkeyed, max_hash=max_hash)
        sep = unpack_bits(sm, n)
        return syncmer_compat_select(kkeyed, kvalid, skeyed, sep, k, s,
                                     max_hash)


def count_packed_dispatch(packed: PackedSeqs, cfg: CountConfig, device=None):
    """Queue one piece's device work (pack, H2D, encode, sort, collapse);
    returns a token for :func:`count_packed_fetch`."""
    device = get_device(device)
    if packed.bases.size == 0:
        return ("empty", device)
    keyed, valid = _encode_piece(packed.bases, cfg, device)
    out, n = collapse_keyed(keyed, valid, cfg.mode, cfg.code_bits)
    return ("one", device, out, n)


def count_packed_dispatch_dual(packed: PackedSeqs, cfg: CountConfig,
                               device=None):
    """:func:`count_packed_dispatch` yielding the piece's distinct AND
    repeated sets from one sort (the capped-multiplicity streams)."""
    device = get_device(device)
    if packed.bases.size == 0:
        return ("empty", device)
    keyed, valid = _encode_piece(packed.bases, cfg, device)
    return ("dual", device) + collapse_dual_keyed(keyed, valid,
                                                  cfg.code_bits)


def _fetch_prefix(out: torch.Tensor, n: torch.Tensor,
                  device: torch.device) -> np.ndarray:
    with stage("d2h", device):
        kept = out[: int(n)]
        kept = kept.cpu() if kept.is_cuda else kept.clone()
        return kept.numpy().view(np.uint64)


def count_packed_fetch(token) -> np.ndarray:
    """The sorted uint64 codes of a count_packed_dispatch token."""
    if token[0] == "empty":
        return np.zeros(0, np.uint64)
    _, device, out, n = token
    return _fetch_prefix(out, n, device)


def count_packed_fetch_dual(token) -> tuple[np.ndarray, np.ndarray]:
    """(distinct, repeated) of a count_packed_dispatch_dual token."""
    if token[0] == "empty":
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    _, device, od, nd, orp, nr = token
    return _fetch_prefix(od, nd, device), _fetch_prefix(orp, nr, device)


def count_packed(packed: PackedSeqs, cfg: CountConfig,
                 device=None) -> np.ndarray:
    """Packed sequences -> sorted numpy uint64 of the kept codes."""
    return count_packed_fetch(count_packed_dispatch(packed, cfg, device))


def _stream_chunk_bases(device: torch.device) -> int:
    """Bases per streamed piece: 2^25 on CUDA, 7 << 16 on the CPU (as
    the JAX package's CPU size, so the tests cut records the same way)."""
    return (1 << 25) if device.type == "cuda" else (7 << 16)


_PAD_QUANTUM = 1 << 20


def _padded_len(n: int) -> int:
    """The smallest power-of-two multiple of 2^20 holding n: a KmerSet's
    capacity (the JAX package's quantum off the TPU, on every device,
    so capacities agree with it)."""
    q = _PAD_QUANTUM
    while q < n:
        q *= 2
    return q


def _capped_cfgs(cfg: CountConfig):
    """(distinct_cfg, repeated_cfg-or-None) for the capped-multiplicity
    piece merge of the streams."""
    if cfg.mode not in ("unique", "repeated"):
        return cfg, None
    return dc_replace(cfg, mode="distinct"), dc_replace(cfg, mode="repeated")


class _SpillOpt:
    """Option bag for pipeline/extsort writers (write-once temp chunks)."""

    max_taxid = 0
    compress = True
    compression_level = 1
    threads = 4
    verbose = False


class SpilledCount:
    """Beyond-RAM count result: sorted spill chunks on disk.
    ``write_to(write_batch)`` streams the collapsed result in ascending
    batches, returns the total and removes the temp files."""

    def __init__(self, chunk_files: list, tmp_dir: str, mode: str, k: int):
        self.chunk_files = chunk_files
        self.tmp_dir = tmp_dir
        self.mode = mode  # extsort collapse mode: unique/once/repeated
        self.k = k

    def write_to(self, write_batch) -> int:
        import shutil

        from ..pipeline import extsort

        total = 0

        def sink(codes, _taxids):
            nonlocal total
            total += len(codes)
            write_batch(codes)

        try:
            extsort.cascade_merge(self.chunk_files, lambda: sink,
                                  self.tmp_dir, self.k, flag=0,
                                  mode=self.mode, taxdb=None,
                                  opt=_SpillOpt())
        finally:
            shutil.rmtree(self.tmp_dir, ignore_errors=True)
        return total


class _PartialSink:
    """Accumulates per-piece sorted arrays; past UNIKMER_TPU_COUNT_MEM_MB
    (default 4096) of buffered parts they are collapsed and spilled to
    an extsort chunk file."""

    _SPILL_MODE = {"distinct": "unique", "unique": "once",
                   "repeated": "repeated"}

    def __init__(self, cfg: CountConfig):
        self.cfg = cfg
        self.mode = self._SPILL_MODE[cfg.mode]
        self.parts: list[np.ndarray] = []
        self.nbytes = 0
        self.cap = int(float(os.environ.get("UNIKMER_TPU_COUNT_MEM_MB",
                                            "4096")) * (1 << 20))
        self.tmp_dir: str | None = None
        self.chunks: list[str] = []

    def add(self, u: np.ndarray) -> None:
        self.parts.append(u)
        self.nbytes += u.nbytes
        if self.nbytes > self.cap:
            self._spill()

    def _spill(self) -> None:
        import tempfile

        from ..pipeline import extsort

        if self.tmp_dir is None:
            self.tmp_dir = tempfile.mkdtemp(prefix="unikmer-tpu-torch-count-")
        codes = np.concatenate(self.parts)
        self.parts, self.nbytes = [], 0
        path = extsort.chunk_file_name(self.tmp_dir, len(self.chunks))
        extsort.dump_chunk(codes, None, path, self.cfg.k, 0, self.mode, None,
                           _SpillOpt())
        self.chunks.append(path)

    def result(self):
        """np.ndarray (everything fit) or SpilledCount (chunks on disk)."""
        with stage("merge", _HOST):
            if not self.chunks:
                return _merge_partials(self.parts, self.cfg)
            if self.parts:
                self._spill()
            return SpilledCount(self.chunks, self.tmp_dir, self.mode,
                                self.cfg.k)


def _merge_partials(partial, cfg: CountConfig) -> np.ndarray:
    if not partial:
        return np.zeros(0, np.uint64)
    if cfg.mode not in ("unique", "repeated"):
        return host_sets.union(partial)[0]
    merged = np.concatenate(partial)
    merged.sort()
    first = np.ones(len(merged), bool)
    first[1:] = merged[1:] != merged[:-1]
    counts = np.bincount(np.cumsum(first) - 1)
    keep = counts == 1 if cfg.mode == "unique" else counts >= 2
    return merged[first][keep]


def _count_piece(piece: PackedSeqs, cfg: CountConfig, device: torch.device,
                 sink: _PartialSink) -> None:
    distinct_cfg, repeated_cfg = _capped_cfgs(cfg)
    if repeated_cfg is None:
        parts = [count_packed(piece, cfg, device)]
    else:
        # one sort gives the piece's distinct set and its repeated marks
        parts = count_packed_fetch_dual(
            count_packed_dispatch_dual(piece, distinct_cfg, device))
    for u in parts:
        if len(u):
            sink.add(u)


def split_packed(packed: PackedSeqs, chunk_bases: int, k: int = 0,
                 yield_offsets: bool = False):
    """Split a PackedSeqs at record boundaries into pieces of at most
    ~chunk_bases bases (a piece holds >= 1 record).  With ``k`` > 0 a
    record longer than chunk_bases + k is cut into segments with k-1
    bases of overlap, so every window lands in exactly one segment.
    ``yield_offsets`` yields (piece, offset of its first base in
    packed.bases) pairs, for position-aligned columns such as -T's ids."""
    n_rec = packed.n_records
    if n_rec == 0:
        return
    total = len(packed.bases)
    lo = 0
    while lo < n_rec:
        rec_end = packed.starts[lo + 1] if lo + 1 < n_rec else total
        span = int(rec_end - packed.starts[lo])
        if k > 0 and span > chunk_bases + k:
            base0 = int(packed.starts[lo])
            for off in range(0, span - (k - 1), chunk_bases):
                seg = packed.bases[
                    base0 + off: base0 + min(off + chunk_bases + k - 1, span)
                ]
                piece = PackedSeqs(seg, np.zeros(1, np.int64),
                                   np.asarray([len(seg)], np.int64))
                yield (piece, base0 + off) if yield_offsets else piece
            lo += 1
            continue
        # whole records while the piece END stays within the chunk
        limit = packed.starts[lo] + chunk_bases
        ends = np.concatenate([packed.starts[lo + 1:], [total]])
        hi = max(lo + int(np.searchsorted(ends, limit, side="right")), lo + 1)
        end = packed.starts[hi] if hi < n_rec else total
        piece = PackedSeqs(packed.bases[packed.starts[lo]:end],
                           packed.starts[lo:hi] - packed.starts[lo],
                           packed.lengths[lo:hi])
        yield (piece, int(packed.starts[lo])) if yield_offsets else piece
        lo = hi


def count_stream_packed(packed_iter, cfg: CountConfig,
                        chunk_bases: int | None = None, device=None):
    """Streaming count over packed buffers: every PackedSeqs is cut into
    device-sized pieces, each counted on the device, and the per-piece
    sets merged exactly for every mode (distinct: union; unique and
    repeated: multiplicity capped at 2 per piece, then counted).
    Returns np.ndarray, or SpilledCount past the host memory cap."""
    device = get_device(device)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(device)
    sink = _PartialSink(cfg)
    it = iter(packed_iter)
    while True:
        with stage("ingest", _HOST):
            packed = next(it, None)
        if packed is None:
            break
        for piece in split_packed(packed, chunk_bases,
                                  cfg.k if cfg.segmentable else 0):
            _count_piece(piece, cfg, device, sink)
    return sink.result()


def count_stream(records, cfg: CountConfig, chunk_bases: int | None = None,
                 device=None):
    """Streaming count over FASTA/Q records: records are buffered up to
    chunk_bases, packed and counted as in :func:`count_stream_packed`."""
    device = get_device(device)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(device)

    def packed_chunks():
        buf: list = []
        buffered = 0
        for rec in records:
            buf.append(rec)
            buffered += len(rec.seq)
            if buffered >= chunk_bases:
                yield pack_records(buf, cfg.k, cfg.circular,
                                   gap=cfg.record_gap)
                buf, buffered = [], 0
        if buf:
            yield pack_records(buf, cfg.k, cfg.circular, gap=cfg.record_gap)

    return count_stream_packed(packed_chunks(), cfg, chunk_bases, device)


# ---------------------------------------------------------------------
# count -l: windows in genome order


def linear_codes_all(bases: np.ndarray, cfg: CountConfig,
                     chunk_bases: int | None = None, device=None):
    """All valid window codes of a packed base buffer, in genome order:
    (codes uint64[n_valid], positions int64[n_valid]).  Buffers past
    the piece size are cut into k-1-overlap segments, each window
    landing in exactly one."""
    device = get_device(device)
    n = len(bases)
    if n == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(device)
    k = cfg.k
    if n <= chunk_bases + k or not cfg.segmentable:
        return _linear_piece(bases, cfg, device, n)
    parts_c, parts_p = [], []
    for off in range(0, n - (k - 1), chunk_bases):
        seg = bases[off: min(off + chunk_bases + k - 1, n)]
        # windows starting in the overlap tail belong to the next segment
        c, p = _linear_piece(seg, cfg, device, chunk_bases)
        parts_c.append(c)
        parts_p.append(p + off)
    return np.concatenate(parts_c), np.concatenate(parts_p)


def _linear_piece(bases: np.ndarray, cfg: CountConfig, device: torch.device,
                  limit: int):
    """(codes, positions) of the valid windows starting before ``limit``."""
    keyed, valid = _encode_piece(bases, cfg, device)
    with stage("collapse", device):
        pos = torch.nonzero(valid[:limit]).squeeze(1)
        codes = keyed[pos]
    with stage("d2h", device):
        return codes.cpu().numpy().view(np.uint64), pos.cpu().numpy()


def count_linear(packed: PackedSeqs, cfg: CountConfig,
                 device=None) -> np.ndarray:
    """count -l/--linear: codes in genome order, duplicates kept."""
    if packed.bases.size == 0:
        return np.zeros(0, np.uint64)
    codes, _ = linear_codes_all(packed.bases, cfg, device=device)
    return codes


# ---------------------------------------------------------------------
# count -T: per-record taxids, LCA-merged per code

def count_taxids_step(keyed: torch.Tensor, valid: torch.Tensor,
                      pos_ctax: torch.Tensor, plan, cfg: CountConfig,
                      modes=("distinct",)):
    """The encode's (keyed, valid) plus per-position compact ids -> for
    each of ``modes`` a (codes, ids, n) triple: the kept codes ascending
    with their LCA-merged compact ids as dense prefixes of length n.  A code
    is kept when its run holds a valid member (distinct), exactly one
    (unique) or more than one (repeated).  ``plan`` is an uploaded
    :func:`device_lca_plan`."""
    kind, _, tab = plan
    s_codes, tax, first, run_valid, _ = collapse_keyed_taxids(
        keyed, pos_ctax, valid, tab, kind, cfg.code_bits)
    out = []
    dev = keyed.device
    with stage("collapse", dev):
        for mode in modes:
            if mode == "distinct":
                keep = first & (run_valid > 0)
            elif mode == "unique":
                keep = first & (run_valid == 1)
            elif mode == "repeated":
                keep = first & (run_valid > 1)
            else:
                raise ValueError(f"unknown mode: {mode}")
            out.append((_compact(s_codes, keep), _compact(tax, keep, 0),
                        keep.sum(dtype=torch.int64)))
    return out


def parse_taxid_records(records, cfg: CountConfig, re_taxid):
    """Parse per-record taxids from headers and pack the sequences:
    (packed, rec_taxids) aligned (records shorter than k dropped from
    both)."""
    from ..utils.log import die

    records = list(records)
    rec_taxids = np.empty(len(records), np.uint32)
    for i, rec in enumerate(records):
        m = re_taxid.search(rec.name)
        if not m:
            die(f"failed to parse taxid in header: {rec.name.decode()}")
        try:
            rec_taxids[i] = int(m.group(1))
        except (ValueError, OverflowError):
            die(
                f"failed to parse taxid {m.group(1)!r} in header: "
                f"{rec.name.decode()}"
            )
    packed = pack_records(records, cfg.k, cfg.circular,
                          gap=cfg.record_gap)
    if packed.n_records != len(records):
        kept = [i for i, rec in enumerate(records) if len(rec.seq) >= cfg.k]
        rec_taxids = rec_taxids[kept]
    return packed, rec_taxids


def _pos_ctax(packed: PackedSeqs, rec_ctax: np.ndarray, off: int,
              length: int, device: torch.device) -> torch.Tensor:
    """Compact ids of positions [off, off+length) of packed.bases: each
    record's id repeated over its span, expanded on the device so that
    only one id per record crosses to it."""
    starts = packed.starts
    ends = np.append(starts[1:], len(packed.bases))
    r0 = max(int(np.searchsorted(starts, off, side="right")) - 1, 0)
    r1 = int(np.searchsorted(starts, off + length, side="left"))
    spans = (np.minimum(ends[r0:r1], off + length)
             - np.maximum(starts[r0:r1], off))
    with stage("h2d", device):
        ids = torch.from_numpy(rec_ctax[r0:r1]).to(device)
        reps = torch.from_numpy(spans.astype(np.int64)).to(device)
    return torch.repeat_interleave(ids, reps, output_size=length)


def _fetch_taxids(out_c, out_t, n, closure, device):
    """Host (codes uint64, taxids uint32) of one mode's dense prefixes."""
    with stage("d2h", device):
        n = int(n)
        codes = out_c[:n].cpu().numpy().view(np.uint64)
        ids = out_t[:n].cpu().numpy()
    return codes, closure[ids.astype(np.int64)]


def _device_taxid_collapse(packed: PackedSeqs, rec_ctax: np.ndarray,
                           piece: PackedSeqs, off: int, cfg: CountConfig,
                           plan, device: torch.device, modes):
    """One device piece of the -T reduction -> a host (codes, taxids)
    pair for each of ``modes``."""
    keyed, valid = _encode_piece(piece.bases, cfg, device)
    pos_ctax = _pos_ctax(packed, rec_ctax, off, len(piece.bases), device)
    res = count_taxids_step(keyed, valid, pos_ctax, plan, cfg, modes)
    return [_fetch_taxids(c, t, n, plan[1], device) for c, t, n in res]


def count_taxids_stream_device(packed: PackedSeqs, rec_taxids, cfg: CountConfig,
                               plan, taxdb, chunk_bases: int | None = None,
                               device=None):
    """Streamed device -T: each piece collapses on the device (its
    distinct set with merged taxids, and for -u/-d its within-piece
    repeated codes, from one sort); the pieces merge on the host with
    one lca_reduce and the capped-multiplicity rule."""
    device = get_device(device)
    if chunk_bases is None:
        chunk_bases = _stream_chunk_bases(device)
    dplan = upload_plan(plan, device)
    rec_ctax = compact_ids(plan[1], rec_taxids)
    capped = cfg.mode in ("unique", "repeated")
    modes = ("distinct", "repeated") if capped else ("distinct",)
    parts_c, parts_t, parts_rep = [], [], []
    for piece, off in split_packed(packed, chunk_bases,
                                   cfg.k if cfg.segmentable else 0,
                                   yield_offsets=True):
        res = _device_taxid_collapse(packed, rec_ctax, piece, off, cfg,
                                     dplan, device, modes)
        parts_c.append(res[0][0])
        parts_t.append(res[0][1])
        if capped:
            parts_rep.append(res[1][0])
    with stage("merge", _HOST):
        dcodes = (np.concatenate(parts_c) if parts_c
                  else np.zeros(0, np.uint64))
        dtax = (np.concatenate(parts_t) if parts_t
                else np.zeros(0, np.uint32))
        uniq, merged = taxdb.lca_reduce(dcodes, dtax)
        if not capped:
            return uniq, merged
        # piece-presence counts align with lca_reduce's sorted keys
        _, counts = np.unique(dcodes, return_counts=True)
        in_rep = (
            np.isin(uniq, np.unique(np.concatenate(parts_rep)))
            if parts_rep else np.zeros(len(uniq), bool)
        )
        multi = (counts > 1) | in_rep
        keep = ~multi if cfg.mode == "unique" else multi
        return uniq[keep], merged[keep]


def count_taxids_from_packed(packed: PackedSeqs, rec_taxids, cfg: CountConfig,
                             taxdb, device=None):
    """The -T reduction over pre-parsed (packed, rec_taxids): one device
    piece when the input fits, streamed pieces otherwise.  Only unknown
    nonzero taxids, whose merge the host's order defines, take
    :func:`count_taxids_unknown`."""
    device = get_device(device)
    if packed.bases.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    with stage("plan", _HOST):
        plan = device_lca_plan(taxdb, rec_taxids)
    if plan is None:
        return count_taxids_unknown(packed, rec_taxids, cfg, taxdb, device)
    if len(packed.bases) > _stream_chunk_bases(device):
        return count_taxids_stream_device(packed, rec_taxids, cfg, plan,
                                          taxdb, device=device)
    rec_ctax = compact_ids(plan[1], rec_taxids)
    [res] = _device_taxid_collapse(
        packed, rec_ctax, packed, 0, cfg, upload_plan(plan, device),
        device, (cfg.mode,))
    return res


def count_taxids_unknown(packed: PackedSeqs, rec_taxids, cfg: CountConfig,
                         taxdb, device=None):
    """-T for a vocabulary with unknown nonzero taxids: the windows in
    genome order, then taxdb.lca_reduce, whose merge order defines how
    an unknown taxid combines (the JAX package's rule)."""
    device = get_device(device)
    codes, pos = linear_codes_all(packed.bases, cfg, device=device)
    with stage("merge", _HOST):
        rec_id = np.searchsorted(packed.starts, pos, side="right") - 1
        taxids = rec_taxids[rec_id]
        uniq, merged = taxdb.lca_reduce(codes, taxids)
        if cfg.mode in ("unique", "repeated"):
            _, counts = np.unique(codes, return_counts=True)
            keep = counts == 1 if cfg.mode == "unique" else counts > 1
            return uniq[keep], merged[keep]
        return uniq, merged


def count_packed_taxids(records, cfg: CountConfig, re_taxid, taxdb,
                        device=None):
    """count -T/--parse-taxid: per-record taxids, LCA-merged per code
    (reference count.go:334-344,377-410).  ``re_taxid`` is a compiled
    bytes regexp with one capture group.  Returns (codes, taxids) sorted
    by code, filtered by cfg.mode."""
    with stage("ingest", _HOST):
        packed, rec_taxids = parse_taxid_records(records, cfg, re_taxid)
    return count_taxids_from_packed(packed, rec_taxids, cfg, taxdb, device)
