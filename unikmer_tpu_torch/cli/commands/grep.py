"""grep: search k-mers from binary files (port of
unikmer_tpu/cli/commands/grep.py).

Reference: unikmer/cmd/grep.go — queries are k-mers (encoded to
CANONICAL codes, or ntHash following the first file's flags) or taxids
(-t, exact match); results optionally inverted, sorted, uniqued, or
split into per-input output files (-m).

UNIKMER_TPU_GREP_DEVICE=1 answers each block's membership on the device
(ops/device_sets.DeviceMembership) when the query set fits the device's
element budget; the default, as in the JAX package, is the host's
searchsorted.
"""

from __future__ import annotations

import itertools
import os
import shutil
import sys

import numpy as np

from ... import native
from ...io import unik
from ...ops import codec
from ...ops.device_sets import DeviceMembership, grep_device_route
from ...ops.nthash import nthash_kmer
from ...pipeline import extsort
from ...utils.log import die, log
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import (
    add_files_arg,
    check_taxid_info_match,
    effective_taxids,
    log_saved,
    new_command,
    open_reader,
    unik_inputs,
)

DEFAULT_OUT_SUFFIX = ".grep"

# IUPAC degenerate bases (reference util.go:173-245 extendDegenerateSeq)
IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "T", "U": "T",
    "M": "AC", "R": "AG", "W": "AT", "S": "CG", "Y": "CT", "K": "GT",
    "V": "ACG", "H": "ACT", "D": "AGT", "B": "CGT", "N": "ACGT",
}


def extend_degenerate(q: str) -> list[str]:
    pools = []
    for ch in q.upper():
        if ch not in IUPAC:
            die(f"invalid degenerate base '{ch}' in query: {q}")
        pools.append(IUPAC[ch])
    n = 1
    for p in pools:
        n *= len(p)
        if n > 100000:
            die(f"too many degenerate expansions for query: {q}")
    return ["".join(t) for t in itertools.product(*pools)]


def register(subparsers):
    p = new_command(subparsers, "grep", "Search k-mers from binary files")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-q", "--query", action="append", default=[],
                   help="query k-mers/taxids (multiple values delimited by comma supported)")
    p.add_argument("-f", "--query-file", action="append", default=[],
                   help="query file (one k-mer/taxid per line)")
    p.add_argument("-F", "--query-unik-file", action="append", default=[],
                   help="query file in .unik format")
    p.add_argument("-t", "--query-is-taxid", action="store_true", help="queries are taxids")
    p.add_argument("-D", "--degenerate", action="store_true",
                   help="query k-mers contain degenerate bases")
    p.add_argument("-v", "--invert-match", action="store_true",
                   help="invert the sense of matching, to select non-matching records")
    p.add_argument("-m", "--multiple-outfiles", action="store_true",
                   help="write results into separated files for multiple input files")
    p.add_argument("-O", "--out-dir", default="unikmer-grep", help="output directory")
    p.add_argument("-S", "--out-suffix", default=DEFAULT_OUT_SUFFIX, help="output suffix")
    p.add_argument("--force", action="store_true", help="overwrite output directory")
    p.add_argument("-s", "--sort", action="store_true",
                   help="sort k-mers. Overrides -c/--compact")
    p.add_argument("-u", "--unique", action="store_true", help="remove duplicate k-mers")
    p.add_argument("-d", "--repeated", action="store_true", help="only print duplicate k-mers")
    p.set_defaults(func=run)


def _collect_query_strings(args) -> list[str]:
    queries: list[str] = []
    for q in args.query:
        queries.extend(s for s in q.split(",") if s)
    for f in args.query_file:
        if not f:
            continue
        with open(f, "rb") as fh:
            for line in fh:
                s = line.strip().decode()
                if s:
                    queries.append(s)
    return queries


def run(args) -> int:
    opt, files = unik_inputs(args)
    if args.unique and args.repeated:
        die("flag -u/--unique and -d/--repeated are not compatible")
    query_strings = _collect_query_strings(args)

    query_taxids = None
    if args.query_is_taxid:
        try:
            query_taxids = np.unique(
                np.array([int(q) for q in query_strings], dtype=np.uint32)
            )
        except ValueError:
            die("query taxid should be a positive integer")
        if len(query_taxids) == 0:
            log.warning("0 taxids loaded")

    # query codes from .unik files (hashed-ness follows those files);
    # query files must agree on k/canonical/hashed/scaled among
    # themselves (grep.go:229-240 checkCompatibility between them)
    unik_query_codes = []
    unik_query_hashed = None
    unik_query_k = None
    hq0 = None
    for f in args.query_unik_file:
        if not f:
            continue
        with open_reader(f) as r:
            h = r.header
            if hq0 is None:
                hq0 = h
                unik_query_hashed = h.is_hashed
                unik_query_k = h.k
            elif (
                h.k != hq0.k
                or h.is_canonical != hq0.is_canonical
                or h.is_hashed != hq0.is_hashed
                or h.is_scaled != hq0.is_scaled
            ):
                die(
                    f"query file incompatible with previous query files "
                    f"(k/canonical/hashed/scaled must match): {f}"
                )
            codes, _ = r.read_all()
            unik_query_codes.append(codes)

    kmer_queries: list[str] = []
    if not args.query_is_taxid:
        for q in query_strings:
            if args.degenerate:
                kmer_queries.extend(extend_degenerate(q))
            else:
                kmer_queries.append(q.upper())

    multi = args.multiple_outfiles
    if multi:
        if os.path.exists(args.out_dir):
            if args.force:
                shutil.rmtree(args.out_dir)
            elif os.listdir(args.out_dir):
                die(f"outdir not empty: {args.out_dir}, use --force to overwrite")
        os.makedirs(args.out_dir, exist_ok=True)

    query_set = None  # sorted uint64 array, built lazily from first file
    dev_member = None  # device membership tier (grep_device_route)
    h0 = None
    has_taxid = False
    sink = None  # single-output funnel (grep.go:518-539 writes as it goes)
    n_total = 0
    out_file = ensure_unik_suffix(args.out_prefix)

    for i, file in enumerate(files):
        with open_reader(file) as r:
            h = r.header
            if not args.query_is_taxid and unik_query_k is not None \
                    and h.k != unik_query_k:
                # grep.go:553-554: input k must equal the -F query k
                die(
                    f"K ({h.k}) of binary file '{file}' not equal to "
                    f"query K ({unik_query_k})"
                )
            if h0 is None:
                h0 = h
                has_taxid = not opt.ignore_taxid and h.has_taxid_info
                if not args.query_is_taxid:
                    query_set = _build_query_set(
                        kmer_queries, unik_query_codes, unik_query_hashed, h
                    )
                    if grep_device_route(len(query_set)):
                        # device membership tier: query set resident on
                        # the device, per-block binary search + bit-packed
                        # egress (grep.go:617-676 at scale)
                        dev_member = DeviceMembership(query_set)
                else:
                    if not h.has_taxid_info:
                        die(f"no taxids found in file: {file}")
                if not multi:
                    sink = _Sink(out_file, opt, h0, has_taxid, args,
                                 sorted_input=len(files) == 1 and h0.is_sorted)
            elif not args.query_is_taxid and h.k != h0.k:
                die(f"k-mer length mismatch: {file}")
            if h0 is not h:
                check_taxid_info_match(h0, h, file, opt)  # grep.go:556-562

            if multi:
                base = "stdin" if file == "-" else os.path.basename(file)
                path = os.path.join(args.out_dir, base + args.out_suffix + unik.EXT)
                sink = _Sink(path, opt, h, has_taxid, args,
                             sorted_input=h.is_sorted)
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                if args.query_is_taxid:
                    t = taxids if taxids is not None else np.zeros(len(codes), np.uint32)
                    ok = np.isin(t, query_taxids)
                else:
                    look = codes
                    if not h.is_canonical and not h.is_hashed:
                        look = codec.canonical_np(codes, h.k)
                    if dev_member is not None:
                        ok = dev_member.lookup(look)
                    else:
                        idx = np.searchsorted(query_set, look)
                        idx = np.minimum(idx, max(len(query_set) - 1, 0))
                        ok = (
                            query_set[idx] == look
                            if len(query_set)
                            else np.zeros(len(codes), bool)
                        )
                hit = ~ok if args.invert_match else ok
                t = None
                if has_taxid:
                    t = (taxids if taxids is not None
                         else np.zeros(len(codes), np.uint32))[hit]
                sink.add(codes[hit], t)

            if multi:
                n = sink.close()
                n_total += n
                if opt.verbose:
                    log.info(f"[file {i+1}/{len(files)}] {n} k-mers saved to {path}")

    if not multi:
        n_total = sink.close() if sink is not None else 0
        log_saved(opt, n_total, out_file)
    return 0


def _build_query_set(kmer_queries, unik_query_codes, unik_query_hashed, h):
    codes = []
    hashed = h.is_hashed if unik_query_hashed is None else unik_query_hashed
    for q in kmer_queries:
        if hashed:
            if len(q) != h.k:
                die(f"length of query '{q}' ({len(q)}) != k ({h.k})")
            codes.append(nthash_kmer(q, canonical=h.is_canonical))
        else:
            if len(q) != h.k:
                die(f"length of query '{q}' ({len(q)}) != k ({h.k})")
            try:
                code = codec.encode_kmer(q)
            except ValueError as e:
                die(f"fail to encode query '{q}': {e}")
            codes.append(int(codec.canonical_np(code, h.k)))
    arr = np.array(codes, dtype=np.uint64)
    if unik_query_codes:
        arr = np.concatenate([arr] + unik_query_codes)
    arr = np.unique(arr)
    if len(arr) == 0:
        log.warning("0 k-mers loaded")
        sys.exit(0)
    return arr


class _Sink:
    """Bounded-memory grep result funnel.

    Unsorted mode streams matched blocks straight into the UnikWriter
    as they arrive (the reference funnels hits through a writer channel,
    grep.go:518-539, instead of materializing them).  sort/-u/-d modes
    buffer up to UNIKMER_TPU_GREP_MEM_MB (default 512) of hits; beyond
    that, sorted chunks spill through pipeline/extsort and the close()
    finishes with a cascade merge -- RSS stays O(buffer + query set)
    however large the matched set (e.g. `-v` of a huge input).
    """

    def __init__(self, path, opt, h, has_taxid, args, sorted_input=False):
        self.path = path
        self.opt = opt
        self.h = h
        self.has_taxid = has_taxid
        self.mode = (
            "unique" if args.unique else "repeated" if args.repeated else "none"
        )
        # -u/-d imply -s (grep.go:99-102)
        self.collapse = args.sort or self.mode != "none"
        flag = 0
        if self.collapse:
            flag |= unik.SORTED
        elif sorted_input:
            # streaming preserves order: a single sorted input yields
            # sorted output without re-sorting (grep.go:502-504,587-588)
            flag |= unik.SORTED
        elif opt.compact and not h.is_hashed:
            flag |= unik.COMPACT
        if h.is_canonical:
            flag |= unik.CANONICAL
        if has_taxid:
            flag |= unik.INCLUDE_TAXID
        if h.is_hashed:
            flag |= unik.HASHED
        self.flag = flag
        self._c: list[np.ndarray] = []
        self._t: list[np.ndarray] = []
        self._buffered = 0
        self._cap = int(
            float(os.environ.get("UNIKMER_TPU_GREP_MEM_MB", "512")) * (1 << 20)
        )
        self._tmp_dir: str | None = None
        self._chunks: list[str] = []
        self._writer = None
        self._n = 0
        if not self.collapse:
            self._writer = self._open_writer()

    def _open_writer(self):
        out, _ = out_binary_stream(self.path)
        return unik.UnikWriter(
            out,
            k=self.h.k,
            flag=self.flag,
            max_taxid=self.opt.max_taxid,
            compress=self.opt.compress,
            compression_level=self.opt.compression_level,
            threads=self.opt.threads,
        )

    def add(self, codes: np.ndarray, taxids: np.ndarray | None) -> None:
        if len(codes) == 0:
            return
        if not self.collapse:
            self._writer.write_codes(codes, taxids if self.has_taxid else None)
            self._n += len(codes)
            return
        self._c.append(codes)
        if self.has_taxid:
            self._t.append(
                taxids if taxids is not None else np.zeros(len(codes), np.uint32)
            )
        self._buffered += codes.nbytes + (
            taxids.nbytes if taxids is not None else 0
        )
        if self._buffered > self._cap:
            self._spill()

    def _drain(self):
        codes = (
            np.concatenate(self._c) if self._c else np.zeros(0, np.uint64)
        )
        taxids = (
            np.concatenate(self._t)
            if self.has_taxid and self._t
            else (np.zeros(0, np.uint32) if self.has_taxid else None)
        )
        self._c, self._t, self._buffered = [], [], 0
        return codes, taxids

    def _spill(self) -> None:
        import tempfile

        if self._tmp_dir is None:
            self._tmp_dir = tempfile.mkdtemp(prefix="unikmer-tpu-grep-")
        codes, taxids = self._drain()
        path = extsort.chunk_file_name(self._tmp_dir, len(self._chunks))
        extsort.dump_chunk(
            codes, taxids, path, self.h.k, self.flag, self.mode, None,
            self.opt, compression_level=1,
        )
        self._chunks.append(path)

    def close(self) -> int:
        if not self.collapse:
            self._writer.close()
            return self._n
        if not self._chunks:
            # everything fit: one in-RAM sort + collapse + write
            codes, taxids = self._drain()
            if taxids is not None:
                codes, taxids = native.host_sort_kv(codes, taxids)
            else:
                codes = native.host_sort(codes)
            codes, taxids = extsort.collapse_batch(
                codes, taxids, self.mode, None, final_round=True
            )
            out, _ = out_binary_stream(self.path)
            with unik.UnikWriter(
                out,
                k=self.h.k,
                flag=self.flag,
                number=len(codes),
                max_taxid=self.opt.max_taxid,
                compress=self.opt.compress,
                compression_level=self.opt.compression_level,
                threads=self.opt.threads,
            ) as w:
                w.write_codes(codes, taxids)
            return len(codes)
        if self._c:
            self._spill()
        writer = self._open_writer()
        try:
            n = extsort.merge_sorted_files(
                self._chunks,
                lambda c, t: writer.write_codes(
                    c, t if self.has_taxid else None
                ),
                mode=self.mode,
                taxdb=None,
                final_round=True,
            )
        finally:
            writer.close()
            shutil.rmtree(self._tmp_dir, ignore_errors=True)
        return n
