"""count: generate k-mers from FASTA/Q sequences, on the host engine or the card.

Port of unikmer_tpu/cli/commands/count.py with the same flags, checks
and messages, and the same ``.unik`` header flags and writer settings.
2-bit configs (k <= 32, -K, -s, -u, -d, --circular, -t, several files,
-C), hashed configs (-H, -D scaled, k 33-64: ntHash codes), sketches
(-W minimizer, -S closed syncmer, --syncmer-impl compat), -T/-r
(per-record taxids, LCA-merged, read with --data-dir's nodes.dmp) and
-l (genome order, with or without -T).

Routing, as in the JAX CLI (``_host_count_wanted``): a small input goes
to the host engine (models/count_host.py: the native window kernels and
the host sort), which never imports torch; the rest runs on the device
through models/count.py.  UNIKMER_TPU_HOST_COUNT=0 sends every call to
the device, =1 every config the host engine supports, and ``auto`` (the
default) those whose input files total at most
UNIKMER_TPU_HOST_COUNT_MAX_MB (default 256) MB, except in the resident
server (server.py), which has paid the device's start-up already; past
UNIKMER_TPU_HOST_COUNT_MAX_BASES packed bases (default 2^28, a quarter
of it for sketches) the host engine declines and the device streams.
The compat syncmer prefers the host kernel whatever the knob
(UNIKMER_TPU_NO_NATIVE=1 reaches its device twin); -T with a sketch has
no host route.  --mesh N (not with -l or the compat syncmer) runs the
hash-range sharded build of parallel/sharded.py over N devices, ahead of
the host route.  -V logs the route taken.  The routing changes no
output byte.  In -T, UNIKMER_TPU_DEVICE_TAXID=0 keeps the windows on the
device but reduces their taxids on the host (models/count.py
``_device_taxid_route``), as in the JAX CLI.

UNIKMER_TPU_PROFILE_STREAM=1 prints the exclusive wall time of each
stage (ingest, pack, h2d, k1, sort, collapse, d2h, merge, write, ...)
to stderr after the run, in the JAX package's layout.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ...io import unik
from ...io.fastx import (
    PackedSeqs, _try_native_load, pack_files, pack_records,
    parse_taxid_records, read_fastx,
)
from ...ops.codec import MAX_K_ENCODED, MAX_K_HASHED
from ...ops.sketch import compat_gap
from ...taxonomy.taxdump import load_taxonomy
from ...utils.log import die, init_logging, log
from ...utils.stages import (
    stage, stream_profile_report, stream_profile_reset, stream_profile_stop,
)
from ..opts import (
    ensure_unik_suffix, get_file_list, get_options, out_binary_stream,
)
from ._common import check_mesh_devices, log_saved, new_command


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
    """The command; with UNIKMER_TPU_PROFILE_STREAM=1 its stage times
    follow on stderr (utils/stages.py's stream profiler), which is off
    again after the report."""
    stream_profile_reset()
    try:
        return _count(args)
    finally:
        stream_profile_report()
        stream_profile_stop()


def _count(args) -> int:
    opt = get_options(args)
    k = args.kmer_len
    hashed, canonical = _reference_checks(args)
    re_taxid = (re.compile(args.parse_taxid_regexp.encode())
                if args.parse_taxid else None)

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
    sketch = args.minimizer_w > 0 or args.syncmer_s > 0
    compat = args.syncmer_impl == "compat" and args.syncmer_s > 0
    gap = compat_gap(k, args.syncmer_s) if compat else 1
    # the compat syncmer prefers the host kernel, as in the JAX CLI; -T
    # with a sketch has no host route (the sketch kernels give no window
    # positions, so no record's taxid)
    host_ok = ((compat or _host_count_wanted(files, k, hashed, args))
               and not (args.parse_taxid and sketch))
    # the native fused ingest (io/fastx) places one separator between
    # records, not the compat syncmer's compat_gap
    native_ingest = (not name_res and not compat
                     and all(_native_ingest_ok(f) for f in files))
    host_kw = dict(k=k, canonical=canonical, hashed=hashed, scale=args.scale)
    sketch_kw = dict(minimizer_w=args.minimizer_w, syncmer_s=args.syncmer_s,
                     syncmer_impl=args.syncmer_impl)

    def pack_all():
        if native_ingest:
            return pack_files(files, k, args.circular)
        return pack_records(records(), k, args.circular, gap=gap)

    def device_run():
        """(device, CountConfig) of a device route: torch is imported
        here and on no host route."""
        from ..._device import get_device
        from ...models.count import CountConfig

        _log_route(args, opt, "device")
        try:
            device = get_device()
        except RuntimeError as e:
            die(str(e))
        return device, CountConfig(
            k=k, canonical=canonical, hashed=hashed, scale=args.scale,
            circular=args.circular, mode=mode, **sketch_kw)

    def write(codes, taxids=None, number=True):
        """Write the .unik; ``number`` False leaves its count unknown
        (-l's header, as the JAX CLI writes it)."""
        with stage("write", "cpu"):
            out, _ = out_binary_stream(out_file)
            with unik.UnikWriter(out, flag=flag,
                                 number=len(codes) if number else -1,
                                 **writer_kw) as w:
                w.write_codes(codes, taxids)
        log_saved(opt, len(codes), out_file)
        return 0

    mesh = opt.mesh >= 1 and not compat
    if args.linear:
        if args.parse_taxid:
            with stage("ingest", "cpu"):
                # headers of records too short for one window are not
                # parsed
                packed, rec_taxids = parse_taxid_records(
                    (rec for rec in records() if len(rec.seq) >= k), k,
                    args.circular, gap, re_taxid)
            res = None
            if host_ok:
                from ...models.count_host import linear_windows_host

                _log_route(args, opt, "host")
                res = linear_windows_host(packed.bases, k, canonical, hashed)
            if res is None:
                from ...models.count import linear_codes_all

                device, cfg = device_run()
                res = linear_codes_all(packed.bases, cfg, device=device)
            codes, pos = res
            taxids = rec_taxids[
                np.searchsorted(packed.starts, pos, side="right") - 1]
            return write(codes, taxids, number=False)
        with stage("ingest", "cpu"):
            packed = pack_all()
        codes = None
        if host_ok and (compat or len(packed.bases) <= _host_max_bases()):
            from ...models.count_host import linear_host

            _log_route(args, opt, "host")
            codes = linear_host(packed, **host_kw, **sketch_kw)
        if codes is None:
            # incl. compat past the host cap: the device twin takes over
            from ...models.count import count_linear

            device, cfg = device_run()
            codes = count_linear(packed, cfg, device)
        return write(codes, number=False)

    if args.parse_taxid:
        taxdb = load_taxonomy(opt.data_dir, verbose=opt.verbose)
        res = None
        if host_ok and not mesh:
            from ...models.count_host import count_taxids_host

            _log_route(args, opt, "host")
            res = count_taxids_host(records(), k, canonical, hashed,
                                    args.scale, mode, args.circular,
                                    re_taxid, taxdb)
        if res is None:
            from ...models.count import (
                count_packed_taxids, count_taxids_from_packed,
            )
            from ...parallel.sharded import mesh_count_taxids

            device, cfg = device_run()
            if mesh:
                check_mesh_devices(opt)
                # falls back to the single-device -T where the sharded
                # build declines (unknown nonzero taxids)
                with stage("ingest", "cpu"):
                    packed, rec_taxids = parse_taxid_records(
                        records(), k, args.circular, gap, re_taxid)
                res = mesh_count_taxids(packed, rec_taxids, taxdb, cfg,
                                        opt.mesh)
                if res is None:
                    res = count_taxids_from_packed(packed, rec_taxids, cfg,
                                                   taxdb, device)
            else:
                res = count_packed_taxids(records(), cfg, re_taxid, taxdb,
                                          device)
        return write(*res)

    if host_ok and not mesh:
        with stage("ingest", "cpu"):
            packed = pack_all()
        codes = None
        if compat or len(packed.bases) <= _host_max_bases():
            from ...models.count_host import count_host

            _log_route(args, opt, "host")
            with stage("host count", "cpu"):
                codes = count_host(packed, mode=mode, **host_kw, **sketch_kw)
        if codes is not None:
            return write(codes)
        # a cap said no (the input's packed size past the host cap, or
        # the sketch kernels' tighter one): the device streams the files
        # again (stdin never routes here)
        del packed

    # the streamed device count (--mesh N: the sharded build)
    from ...models.count import (
        SpilledCount, _stream_chunk_bases, count_stream, count_stream_packed,
    )
    from ...parallel.sharded import (
        mesh_count_stream, mesh_count_stream_packed,
    )

    device, cfg = device_run()

    def packed_stream():
        # the native fused ingest per file, else bounded record chunks
        chunk = _stream_chunk_bases(device)
        for f in files:
            if opt.verbose:
                log.info(f"reading sequence file: {f}")
            part = _try_native_load(f, k, args.circular)
            if part is not None:
                b, s, ln, _ = part
                yield PackedSeqs(b, s, ln)
                continue
            buf, size = [], 0
            for rec in read_fastx(f):
                buf.append(rec)
                size += len(rec.seq)
                if size >= chunk:
                    yield pack_records(buf, k, args.circular)
                    buf, size = [], 0
            if buf:
                yield pack_records(buf, k, args.circular)

    if mesh:
        check_mesh_devices(opt)
    if mesh and native_ingest:
        codes = mesh_count_stream_packed(packed_stream(), cfg, opt.mesh)
    elif mesh:
        codes = mesh_count_stream(records(), cfg, opt.mesh)
    elif native_ingest:
        codes = count_stream_packed(packed_stream(), cfg, device=device)
    else:
        codes = count_stream(records(), cfg, device=device)

    with stage("write", "cpu"):
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


def _log_route(args, opt, route: str) -> None:
    """-V (or --verbose) logs which engine counts."""
    if args.more_verbose or opt.verbose:
        init_logging(True)
        log.info(f"count: the {route} route")


def _host_max_bases() -> int:
    """Hard post-pack cap for the host engine: its window buffer costs
    8 bytes a base, so bound it apart from the input's size on disk (the
    device streaming path is memory-bounded instead)."""
    return int(os.environ.get("UNIKMER_TPU_HOST_COUNT_MAX_BASES",
                              str(1 << 28)))  # 268 Mbp -> ~2.1 GB codes


def _host_count_wanted(files, k: int, hashed: bool, args) -> bool:
    """Route to the host engine?  UNIKMER_TPU_HOST_COUNT: 0 = never, 1 =
    whenever the config is supported, auto (default) = supported AND the
    input files' total size at most UNIKMER_TPU_HOST_COUNT_MAX_MB
    (default 256 MB; stdin's size is unknown, so it streams on the
    device) AND not in the resident server: there the torch import and
    the CUDA context are paid, which is what the host engine saves."""
    knob = os.environ.get("UNIKMER_TPU_HOST_COUNT", "auto")
    if knob == "0":
        return False  # checked before supported(): get_lib() may compile
    from ...models.count_host import supported

    if not supported(k, hashed, args.scale, args.minimizer_w, args.syncmer_s):
        return False
    if knob == "1":
        return True
    if os.environ.get("UNIKMER_TPU_IN_SERVER"):
        return False
    if any(f == "-" for f in files):
        return False
    try:
        total = sum(os.path.getsize(f) for f in files)
    except OSError:
        return False
    cap_mb = float(os.environ.get("UNIKMER_TPU_HOST_COUNT_MAX_MB", "256"))
    return total <= cap_mb * (1 << 20)


def _native_ingest_ok(path: str) -> bool:
    """Regular files go through the native fused loader (io/fastx)."""
    return path != "-" and os.path.isfile(path)
