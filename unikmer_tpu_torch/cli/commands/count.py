"""count: generate k-mers from FASTA/Q sequences, on the port's device path.

Port of unikmer_tpu/cli/commands/count.py with the same flags, checks
and messages, and the same ``.unik`` header flags and writer settings.
2-bit configs (k <= 32, -K, -s, -u, -d, --circular, -t, several files,
-C), hashed configs (-H, -D scaled, k 33-64: ntHash codes), sketches
(-W minimizer, -S closed syncmer, --syncmer-impl compat), -T/-r
(per-record taxids, LCA-merged, read with --data-dir's nodes.dmp) and
-l (genome order, with or without -T) always run on the device through
models/count.py; there is no size-based routing to the host engine.
--mesh, not ported yet, exits with an error that names the ROADMAP item
bringing it.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from ..._device import get_device
from ...io import unik
from ...io.fastx import (
    PackedSeqs, _try_native_load, pack_files, pack_records, read_fastx,
)
from ...models.count import (
    CountConfig, SpilledCount, _stream_chunk_bases, count_linear,
    count_packed_taxids, count_stream, count_stream_packed, linear_codes_all,
    parse_taxid_records,
)
from ...ops.codec import MAX_K_ENCODED, MAX_K_HASHED
from ...taxonomy.taxdump import load_taxonomy
from ...utils.log import die, log
from ...utils.stages import stage
from ..opts import (
    MESH_NOT_PORTED, ensure_unik_suffix, get_file_list, get_options,
    out_binary_stream,
)
from ._common import log_saved, new_command



def register(subparsers):
    p = new_command(subparsers, "count", "Generate k-mers (sketch) from FASTA/Q sequences")
    p.add_argument("files", nargs="*", default=[], help="input FASTA/Q file(s)")
    p.add_argument("-B", "--seq-name-filter", action="append", default=[],
                   help="regular expression for filtering out sequences by header/name, case ignored")
    p.add_argument("-o", "--out-prefix", default="-", help='out file prefix ("-" for stdout)')
    p.add_argument("-k", "--kmer-len", type=int, required=True, help="k-mer length")
    p.add_argument("-K", "--canonical", action="store_true", help="only keep the canonical k-mers")
    p.add_argument("-s", "--sort", action="store_true",
                   help="sort k-mers, this significantly reduces file size for k<=25. Overrides -c/--compact")
    p.add_argument("-t", "--taxid", type=int, default=0, help="global taxid")
    p.add_argument("-T", "--parse-taxid", action="store_true", help="parse taxid from FASTA/Q header")
    p.add_argument("-r", "--parse-taxid-regexp", default="", help="regular expression for parsing taxid")
    p.add_argument("-d", "--repeated", action="store_true",
                   help="only count duplicate k-mers, for removing singletons in FASTQ")
    p.add_argument("-u", "--unique", action="store_true", help="only count unique k-mers")
    p.add_argument("-V", "--more-verbose", action="store_true", help="print extra verbose information")
    p.add_argument("-H", "--hash", action="store_true",
                   help="save hash of k-mer, automatically on for k>32. Overrides -c/--compact")
    p.add_argument("--circular", action="store_true", help="circular genome")
    p.add_argument("-D", "--scale", type=int, default=1, help="scale/down-sample factor")
    p.add_argument("-W", "--minimizer-w", type=int, default=0, help="minimizer window size")
    p.add_argument("-S", "--syncmer-s", type=int, default=0, help="closed syncmer length")
    p.add_argument("--syncmer-impl", choices=("edgar", "compat"), default="edgar",
                   help="closed-syncmer rule: 'edgar' (Edgar 2021, the documented "
                        "definition) or 'compat' (forensic reconstruction of the "
                        "reference binary's behavior; docs/DIVERGENCES.md §2)")
    p.add_argument("-l", "--linear", action="store_true",
                   help="output k-mers in linear order, duplicate k-mers are not removed")
    p.set_defaults(func=run)


def _not_ported(args, opt) -> str | None:
    if opt.mesh >= 1 and not args.linear:  # -l runs on one device anyway
        return MESH_NOT_PORTED
    return None


def _reference_checks(args) -> bool:
    """The reference's flag checks and warnings, in its order
    (unikmer_tpu/cli/commands/count.py:59-97), so a flag combination that
    the reference refuses exits with its message even where it names a
    flag the port does not run yet.  Returns (hashed, canonical): -H,
    or switched on by k > 32, -D or a sketch; -K, or switched on by a
    sketch."""
    k = args.kmer_len
    if k <= 0:
        die("k-mer length must be positive")
    hashed = args.hash
    if k > MAX_K_ENCODED and not hashed:
        hashed = True
        log.warning("flag -H/--hash is switched on for k > 32")
    if hashed and k > MAX_K_HASHED:
        die(f"k-mer size ({k}) should be <=64")
    if args.scale > 0xFFFFFFFF:
        die("scale must fit in 32 bits (the .unik header stores uint32)")
    if args.scale > 1 and not hashed:
        hashed = True
        log.warning("flag -H/--hash is switched on for scale > 1")
    canonical = args.canonical
    if (args.minimizer_w > 0 or args.syncmer_s > 0) and not (hashed and canonical):
        hashed = canonical = True
        log.warning("flags -H/--hash and -K/--canonical are switched on for sketches")
    if args.minimizer_w > 0 and args.syncmer_s > 0:
        die("flag --minimizer-w and --syncmer-s can not be given simultaneously")
    if args.syncmer_impl == "compat":
        if args.syncmer_s <= 0:
            die("flag --syncmer-impl=compat requires -S/--syncmer-s")
    if args.unique and args.repeated:
        die("flag -u/--unique and -d/--repeated are not compatible")
    if args.linear and args.sort:
        die("flag -l/--linear and -s/--sort are not compatible")
    if args.linear and (args.unique or args.repeated):
        log.warning("flag -d/--repeated and -u/--unique are ignored when -l/--linear given")
    if args.parse_taxid:
        if args.taxid > 0:
            die("flag -t/--taxid and -T/--parse-taxid can not be given simultaneously")
        if not args.parse_taxid_regexp:
            die("flag -r/--parse-taxid-regexp needed when given flag -T/--parse-taxid")
        if not re.search(r"\(.+\)", args.parse_taxid_regexp):
            die('value of -r/--parse-taxid-regexp must contain "(" and ")" to capture taxid')
    return hashed, canonical


def run(args) -> int:
    opt = get_options(args)
    k = args.kmer_len
    hashed, canonical = _reference_checks(args)
    todo = _not_ported(args, opt)
    if todo:
        die(f"not supported by unikmer_tpu_torch yet: {todo}")
    re_taxid = (re.compile(args.parse_taxid_regexp.encode())
                if args.parse_taxid else None)
    try:
        device = get_device()
    except RuntimeError as e:
        die(str(e))

    name_res = []
    for kw in args.seq_name_filter:
        if "(?i)" not in kw:
            kw = "(?i)" + kw
        try:
            name_res.append(re.compile(kw.encode()))
        except re.error as e:
            die(f"failed to parse regular expression for matching sequence header: {e}")

    files = get_file_list(args, check_exists=not opt.skip_file_check)
    out_file = ensure_unik_suffix(args.out_prefix)
    mode = "repeated" if args.repeated else "unique" if args.unique else "distinct"
    if args.linear:
        mode = "distinct"

    def records():
        for f in files:
            if opt.verbose:
                log.info(f"reading sequence file: {f}")
            for rec in read_fastx(f):
                if name_res and any(r.search(rec.name) for r in name_res):
                    continue
                yield rec

    flag = 0
    if canonical:
        flag |= unik.CANONICAL
    if hashed:
        flag |= unik.HASHED
    elif opt.compact and not args.sort and not args.linear:
        flag |= unik.COMPACT
    if args.parse_taxid:
        flag |= unik.INCLUDE_TAXID
    if args.sort:
        flag |= unik.SORTED
        flag &= ~unik.COMPACT

    writer_kw = dict(
        k=k,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
        global_taxid=args.taxid if (args.taxid > 0 and not args.parse_taxid) else 0,
        scale=args.scale if args.scale > 1 else 1,
        max_taxid=opt.max_taxid,
    )

    cfg = CountConfig(k=k, canonical=canonical, hashed=hashed,
                      scale=args.scale, minimizer_w=args.minimizer_w,
                      syncmer_s=args.syncmer_s,
                      syncmer_impl=args.syncmer_impl,
                      circular=args.circular, mode=mode)

    def packed_stream():
        # the native fused ingest per file, else bounded record chunks
        chunk = _stream_chunk_bases(device)
        for f in files:
            if opt.verbose:
                log.info(f"reading sequence file: {f}")
            # the compat syncmer needs compat_gap separator bytes between
            # records, which the native loader's packing does not place
            part = (None if cfg.needs_record_sep
                    else _try_native_load(f, k, args.circular))
            if part is not None:
                b, s, ln, _ = part
                yield PackedSeqs(b, s, ln)
                continue
            buf, size = [], 0
            for rec in read_fastx(f):
                buf.append(rec)
                size += len(rec.seq)
                if size >= chunk:
                    yield pack_records(buf, k, args.circular,
                                       gap=cfg.record_gap)
                    buf, size = [], 0
            if buf:
                yield pack_records(buf, k, args.circular, gap=cfg.record_gap)

    if args.linear:
        return _run_linear(args, opt, cfg, records, re_taxid, files, name_res,
                           out_file, flag, writer_kw, device)
    if args.parse_taxid:
        taxdb = load_taxonomy(opt.data_dir, verbose=opt.verbose)
        codes, taxids = count_packed_taxids(records(), cfg, re_taxid, taxdb,
                                            device)
        with stage("write", torch.device("cpu")):
            out, _ = out_binary_stream(out_file)
            with unik.UnikWriter(out, flag=flag, number=len(codes),
                                 **writer_kw) as w:
                w.write_codes(codes, taxids)
        log_saved(opt, len(codes), out_file)
        return 0
    if not name_res and all(_native_ingest_ok(f) for f in files):
        codes = count_stream_packed(packed_stream(), cfg, device=device)
    else:
        codes = count_stream(records(), cfg, device=device)

    with stage("write", torch.device("cpu")):
        out, _ = out_binary_stream(out_file)
        if isinstance(codes, SpilledCount):
            # beyond-RAM set: stream the cascade merge into the writer
            with unik.UnikWriter(out, flag=flag, **writer_kw) as w:
                n = codes.write_to(w.write_codes)
        else:
            n = len(codes)
            with unik.UnikWriter(out, flag=flag, number=n, **writer_kw) as w:
                w.write_codes(codes)
    log_saved(opt, n, out_file)
    return 0


def _run_linear(args, opt, cfg, records, re_taxid, files, name_res, out_file,
                flag, writer_kw, device) -> int:
    """-l/--linear: every valid window in genome order, duplicates kept;
    with -T each window carries its record's taxid."""
    k = cfg.k
    if args.parse_taxid:
        with stage("ingest", torch.device("cpu")):
            # headers of records too short for one window are not parsed
            packed, rec_taxids = parse_taxid_records(
                (rec for rec in records() if len(rec.seq) >= k), cfg, re_taxid)
        codes, pos = linear_codes_all(packed.bases, cfg, device=device)
        taxids = rec_taxids[np.searchsorted(packed.starts, pos, side="right") - 1]
    else:
        with stage("ingest", torch.device("cpu")):
            if (not name_res and not cfg.needs_record_sep
                    and all(_native_ingest_ok(f) for f in files)):
                packed = pack_files(files, k, args.circular)
            else:
                packed = pack_records(records(), k, args.circular,
                                      gap=cfg.record_gap)
        codes, taxids = count_linear(packed, cfg, device), None
    with stage("write", torch.device("cpu")):
        out, _ = out_binary_stream(out_file)
        with unik.UnikWriter(out, flag=flag, **writer_kw) as w:
            w.write_codes(codes, taxids)
    log_saved(opt, len(codes), out_file)
    return 0


def _native_ingest_ok(path: str) -> bool:
    """Regular files go through the native fused loader (io/fastx)."""
    return path != "-" and os.path.isfile(path)
