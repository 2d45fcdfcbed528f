"""map (alias uniqs): map k-mers to genomes and extract maximal
consecutively-matching regions as BED3 or FASTA (port of
unikmer_tpu/cli/commands/map.py).

Reference: unikmer/cmd/map.go — a region is a run of matched k-mer
starts, optionally tolerating up to -X gaps of at most -x consecutive
unmatched k-mers, ending at the last match; multiply-mapped k-mers
terminate regions unless -M; min region length -m; circular genomes scan
a doubled sequence with the end clamped to one full length.

On the device: the query set (every file's codes, K2 and the collapse of
ops/sort.py); each genome file's kept records (doubled under
--circular), joined with separators and encoded once (K1 or H1,
models/count.linear_codes_device), every window of a record read as its
code or CODE_SENTINEL where invalid, as the JAX package's ``_seq_codes``
gives them; membership by a binary search; and the multiply-mapped
terminators, the hits whose code is hit at least twice within a unit (a
record, or a file under -W): one stable K3 sort of (hit code, hit
ordinal), in which a unit's hits of one code sit together.  The region
state machine then runs on the host over match runs, as in the JAX
package.

Admission: a genome file whose joined buffer passes
``element_budget("map", device)`` (a slot a base, less the query set's
sign-flipped copy that the search makes) takes the JAX package's route:
its windows come from models/count.linear_codes_all (one piece on the
card at a time, fetched), and membership, hit runs and terminators are
computed on the host against the fetched query set (np.searchsorted
over the windows in sorted order, the native stable argsort), as
unikmer_tpu/cli/commands/map.py does.  The output bytes are the same on
both routes.
"""

from __future__ import annotations

import sys

import numpy as np

from ... import native
from ..._device import get_device
from ..._lazy import torch
from ...ops.codec import SENTINEL
from ...utils.log import die, log
from ...utils.stages import stage
from ..opts import out_text_stream
from ._common import add_files_arg, new_command, open_reader, unik_inputs
from .locate import HOST, name_filters

MAX_HITS = 1 << 32  # K3's values are u32 hit ordinals
SENT = np.uint64((1 << 64) - 1)  # CODE_SENTINEL on the host route


def register(subparsers):
    p = new_command(
        subparsers, "map",
        "Mapping k-mers back to the genome and extracting successive regions/subsequences",
        aliases=["uniqs"],
    )
    add_files_arg(p)
    p.add_argument("-B", "--seq-name-filter", action="append", default=[],
                   help="regular expressions for filtering out sequences by header/name, case ignored")
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-g", "--genome", action="append", default=[],
                   help="genomes in (gzipped) fasta file(s)")
    p.add_argument("-m", "--min-len", type=int, default=200,
                   help="minimum length of subsequence")
    p.add_argument("-M", "--allow-multiple-mapped-kmers", action="store_true",
                   help="allow multiple mapped k-mers")
    p.add_argument("-W", "--seqs-in-a-file-as-one-genome", action="store_true",
                   help="treat seqs in a genome file as one genome")
    p.add_argument("-a", "--output-fasta", action="store_true",
                   help="output fasta format instead of BED3")
    p.add_argument("-x", "--max-gap-size", type=int, default=0,
                   help="max gap size (the number of consecutive unmapped k-mers)")
    p.add_argument("-X", "--max-gap-num", type=int, default=0,
                   help="max number of gaps (consecutive unmapped k-mers)")
    p.add_argument("--circular", action="store_true", help="circular genome")
    p.set_defaults(func=run)


def run(args) -> int:
    from ...models.count import CountConfig
    from ...models.locate import read_genome_records

    opt, files = unik_inputs(args)
    if not args.genome:
        die("flag -g/--genome needed")
    name_res = name_filters(args.seq_name_filter)

    # load query k-mer set from .unik files
    k = None
    hashed = False
    qsets = []
    for f in files:
        with open_reader(f) as r:
            if k is None:
                k = r.header.k
                hashed = r.header.is_hashed
                if not r.header.is_canonical:
                    die(f"{f}: 'canonical' flag is needed")
            elif r.header.k != k:
                die(f"k mismatch: {f}")
            codes, _ = r.read_all()
            qsets.append(codes)
    device = get_device()
    query = query_set(qsets, device)
    if opt.verbose:
        log.info(f"{query.shape[0]} k-mers loaded")

    kept = read_genome_records(args.genome, k, args.circular, name_res,
                               doubled=args.circular)
    by_file = [[] for _ in args.genome]
    for fi, rec, seq in kept:
        by_file[fi].append((rec, seq))
    scan = GenomeScan(by_file, CountConfig(k=k, canonical=True, hashed=hashed),
                      query, device, args.seqs_in_a_file_as_one_genome)
    # -W: the pre-scan lists a multiply-mapped set for each file that
    # kept a record, and file i reads the i-th entry of that list
    # (map.py:112-113,122-124), whichever file it came from
    nonempty = [fi for fi, recs in enumerate(by_file) if recs]
    out, _ = out_text_stream(args.out_prefix, opt.compression_level)
    try:
        for fi, gf in enumerate(args.genome):
            if opt.verbose:
                log.info(f"reading genome file: {gf}")
            if not by_file[fi]:
                continue
            if args.allow_multiple_mapped_kmers:
                multi_of = None
            elif not args.seqs_in_a_file_as_one_genome:
                multi_of = fi
            else:
                multi_of = nonempty[fi] if fi < len(nonempty) else -1
            match, term, starts = scan.masks(fi, multi_of)
            if opt.verbose:
                log.info(f"map route of {gf}: {scan.routes[fi]}")
            with stage("map regions", HOST):
                for (rec, seq), s in zip(by_file[fi], starts):
                    n = len(seq) - k + 1
                    _map_one(rec, k, seq, match[s: s + n], term[s: s + n],
                             args, out)
    finally:
        out.flush()
        if out is not sys.stdout:
            out.close()
    return 0


def query_set(qsets, device: torch.device) -> torch.Tensor:
    """The distinct codes of every file, sorted (np.unique of their
    concatenation), on ``device``: K2 and the distinct collapse."""
    from ...ops.device_sets import _to_device
    from ...ops.sort import collapse_sorted

    codes = np.concatenate(qsets) if qsets else np.zeros(0, np.uint64)
    x = _to_device(codes, device)
    with stage("map query", device):
        out, n = collapse_sorted(x, torch.ones_like(x, dtype=torch.bool))
        return out[: int(n)]


class GenomeScan:
    """The match and terminator masks of each genome file's windows: a
    file is encoded once, but for the multiply-mapped set of a later
    file that -W makes it read (then that file is encoded for its set
    alone, once, and again when its turn comes)."""

    def __init__(self, by_file, cfg: CountConfig, query: torch.Tensor,
                 device: torch.device, whole_file: bool):
        self.by_file, self.cfg, self.query = by_file, cfg, query
        self.device, self.whole_file = device, whole_file
        self._multi: dict[int, torch.Tensor | np.ndarray] = {}
        self._host_query: np.ndarray | None = None
        self.routes: dict[int, str] = {}  # "device" or "host", a file

    def _windows(self, fi: int):
        """(codes, match, hit positions, starts) of file fi: each
        window's code over the joined records (CODE_SENTINEL where
        invalid or across records), its membership in the query set, the
        in-record windows that match, and the records' starts; tensors on
        the device route, numpy arrays on the host route."""
        from ...models.count import linear_codes_device
        from ...models.locate import joined_bases
        from ...ops.device_sets import _lookup, fits

        dev, k = self.device, self.cfg.k
        seqs = [seq for _, seq in self.by_file[fi]]
        bases, starts = joined_bases(seqs)
        n = len(bases)
        ends = starts + np.fromiter((len(s) for s in seqs), np.int64,
                                    len(seqs)) - k + 1
        if not fits("map", dev, n, table_bytes=8 * self.query.shape[0]):
            self.routes[fi] = "host"
            return self._windows_host(bases, starts, ends)
        self.routes[fi] = "device"
        with stage("map encode", dev):
            codes, pos = linear_codes_device(bases, self.cfg, device=dev)
            dense = torch.full((n,), SENTINEL, dtype=torch.int64, device=dev)
            dense[pos] = codes
            del codes, pos
        with stage("map member", dev):
            _, match = _lookup(self.query, dense)
            # the windows inside a record: [start, start + len - k]
            edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
            edge[torch.from_numpy(starts).to(dev)] = 1
            edge[torch.from_numpy(ends).to(dev)] = -1
            inrec = torch.cumsum(edge, 0)[:n] > 0
            hits = torch.nonzero(match & inrec).squeeze(1)
        return dense, match, hits, starts

    def _windows_host(self, bases, starts, ends):
        """:meth:`_windows` on the host route: the windows fetched a piece
        at a time, the rest numpy."""
        from ...models.count import linear_codes_all

        n = len(bases)
        with stage("map encode", HOST):
            codes, pos = linear_codes_all(bases, self.cfg, device=self.device)
        with stage("map member", HOST):
            dense = np.full(n, SENT, np.uint64)
            dense[pos] = codes
            del codes, pos
            if self._host_query is None:
                q = self.query.cpu()
                self._host_query = q.numpy().view(np.uint64)
            match = _member_np(self._host_query, dense)
            edge = np.zeros(n + 1, np.int32)
            edge[starts] = 1
            edge[ends] = -1
            inrec = np.cumsum(edge)[:n] > 0
            hits = np.flatnonzero(match & inrec)
        return dense, match, hits, starts

    def _hit_runs(self, dense, hits, starts):
        """(sorted hit codes, their hit ordinals as int64, mask of hits
        whose (code, unit) is hit at least twice): K3 over (code,
        ordinal), stable, so a unit's hits of one code sit together (the
        host's stable argsort on the host route)."""
        if isinstance(dense, np.ndarray):
            with stage("map multi", HOST):
                sc, so = native.host_argsort(dense[hits])
                so = so.astype(np.int64)
                same = sc[1:] == sc[:-1]
                if not self.whole_file:
                    unit = np.searchsorted(starts, hits[so], side="right")
                    same &= unit[1:] == unit[:-1]
                multi = np.zeros(len(hits), bool)
                multi[1:] |= same
                multi[:-1] |= same
            return sc, so, multi
        from ...ops.radix_sort import radix_sort_kv_u64

        dev = self.device
        m = hits.shape[0]
        if m >= MAX_HITS:
            raise ValueError(f"map: {m} matched windows in one genome file, "
                             f"past {MAX_HITS}")
        with stage("map multi", dev):
            ordinal = torch.arange(m, dtype=torch.int64,
                                   device=dev).to(torch.int32)
            sc, so = radix_sort_kv_u64(dense[hits], ordinal)
            so = so.to(torch.int64) & 0xFFFFFFFF
            same = sc[1:] == sc[:-1]
            if not self.whole_file:  # a unit is a record
                unit = torch.searchsorted(torch.from_numpy(starts).to(dev),
                                          hits[so], right=True)
                same &= unit[1:] == unit[:-1]
            multi = torch.zeros(m, dtype=torch.bool, device=dev)
            multi[1:] |= same
            multi[:-1] |= same
        return sc, so, multi

    def multi_set(self, fi: int):
        """The sorted codes hit at least twice in file fi (-W's unit): a
        tensor where fi took the device route, else numpy."""
        from ...ops.device_sets import _first

        if fi not in self._multi:
            dense, _, hits, starts = self._windows(fi)
            sc, _, multi = self._hit_runs(dense, hits, starts)
            sc = sc[multi]
            if isinstance(sc, np.ndarray):
                self._multi[fi] = np.unique(sc)
            else:
                self._multi[fi] = sc[_first(sc)]
        return self._multi[fi]

    def masks(self, fi: int, multi_of: int | None):
        """(match, terminator, starts) of file fi, the masks as numpy
        bool over the joined buffer: terminators from the hits of fi's
        own units (multi_of == fi), from the multiply-mapped set of file
        multi_of, or none (multi_of None or -1)."""
        from ...ops.device_sets import _lookup, _to_device

        dev = self.device
        dense, match, hits, starts = self._windows(fi)
        host = isinstance(dense, np.ndarray)
        if multi_of == fi:
            _, so, multi = self._hit_runs(dense, hits, starts)
            term = np.zeros_like(match) if host else torch.zeros_like(match)
            term[hits[so]] = multi
        elif multi_of is not None and multi_of >= 0:
            ms = self.multi_set(multi_of)
            if host:
                if isinstance(ms, torch.Tensor):
                    ms = ms.cpu().numpy().view(np.uint64)
                term = _member_np(ms, dense) & match
            else:
                if isinstance(ms, np.ndarray):
                    ms = _to_device(ms, dev)
                term = _lookup(ms, dense)[1] & match
        else:
            term = None
        if host:
            return match, (np.zeros(len(match), bool) if term is None
                           else term), starts
        with stage("map fetch", HOST):
            match_np = match.cpu().numpy()
            term_np = (np.zeros(len(match_np), bool) if term is None
                       else term.cpu().numpy())
        return match_np, term_np, starts


def _member_np(ref: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Membership of vals in the sorted ``ref``: np.searchsorted over the
    values in sorted order (the host's stable radix argsort first), so
    the searches walk ``ref`` in order instead of missing the cache at
    nearly every step."""
    if len(ref) == 0:
        return np.zeros(len(vals), bool)
    s, order = native.host_argsort(vals)
    idx = np.minimum(np.searchsorted(ref, s), len(ref) - 1)
    out = np.empty(len(vals), bool)
    out[order] = ref[idx] == s
    return out


def _map_one(rec, k, seq, match, term, args, out):
    """The regions of one record from its windows' match and terminator
    masks (``seq`` doubled under --circular)."""
    length0 = len(rec.seq)
    rid = rec.id.decode()

    def emit(start: int, lastmatch: int):
        if start < 0 or lastmatch - start + k < args.min_len:
            return
        if args.circular and lastmatch - start + k > length0:
            lastmatch = length0 - k + start
        if args.output_fasta:
            sub = seq[start : lastmatch + k].decode()
            wrapped = "\n".join(sub[i : i + 60] for i in range(0, len(sub), 60))
            out.write(f">{rid}:{start + 1}-{lastmatch + k}\n{wrapped}\n")
        else:
            out.write(f"{rid}\t{start}\t{lastmatch + k}\n")

    # run-level state machine over match runs split by terminators
    n = len(match)
    match_eff = match & ~term
    # find runs of consecutive effective matches
    padded = np.zeros(n + 2, bool)
    padded[1:-1] = match_eff
    starts = np.flatnonzero(padded[1:] & ~padded[:-1])
    ends = np.flatnonzero(padded[:-1] & ~padded[1:]) - 1  # inclusive end
    term_pos = np.flatnonzero(term)

    cur_start = -1
    cur_last = -1
    gapn = 0
    ti = 0
    for s, e in zip(starts, ends):
        # terminators strictly between cur_last and s close the region
        while ti < len(term_pos) and term_pos[ti] < s:
            if cur_start >= 0 and term_pos[ti] > cur_last:
                emit(cur_start, cur_last)
                cur_start, cur_last, gapn = -1, -1, 0
            ti += 1
        if args.circular and s >= length0 and cur_start < 0:
            break
        if cur_start < 0:
            cur_start, cur_last, gapn = int(s), int(e), 0
            continue
        gap = int(s) - cur_last - 1
        if gap == 0:
            cur_last = int(e)
        elif gap <= args.max_gap_size and gapn + 1 <= args.max_gap_num:
            gapn += 1
            cur_last = int(e)
        else:
            emit(cur_start, cur_last)
            if args.circular and s >= length0:
                cur_start, cur_last, gapn = -1, -1, 0
                break
            cur_start, cur_last, gapn = int(s), int(e), 0
    if cur_start >= 0:
        emit(cur_start, cur_last)
