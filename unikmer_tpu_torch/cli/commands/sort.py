"""sort: sort k-mers to reduce file size (port of
unikmer_tpu/cli/commands/sort.py).

Reference: unikmer/cmd/sort.go: an in-memory sort, or an external
chunked sort when -m/--chunk-size is given (split + merge).  Both run on
the host, as in the JAX package: the native sorts and the extsort merge.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from ... import native
from ...io import unik
from ...pipeline import extsort
from ...utils.log import die, log
from ...utils.sizes import parse_byte_size
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import add_files_arg, log_saved, new_command, unik_inputs
from ._setops import load_inputs, maybe_taxonomy


def register(subparsers):
    p = new_command(subparsers, "sort",
                    "Sort k-mers to reduce the file size and accelerate downstream analysis")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-u", "--unique", action="store_true", help="remove duplicate k-mers")
    p.add_argument("-d", "--repeated", action="store_true", help="only print duplicate k-mers")
    p.add_argument("-m", "--chunk-size", default="",
                   help="split input into chunks of N k-mers, supports K/M/G suffix")
    p.add_argument("-t", "--tmp-dir", default="./", help="directory for intermediate files")
    p.add_argument("-M", "--max-open-files", type=int, default=400, help="max number of open files")
    p.add_argument("-k", "--keep-tmp-dir", action="store_true", help="keep tmp dir")
    p.add_argument("--force", action="store_true", help="overwrite tmp dir")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    if args.unique and args.repeated:
        die("flag -u/--unique and -d/--repeated are not compatible")
    mode = "unique" if args.unique else "repeated" if args.repeated else "none"
    out_file = ensure_unik_suffix(args.out_prefix)

    if not args.chunk_size:
        return _sort_in_memory(args, opt, files, mode, out_file)
    return _sort_external(args, opt, files, mode, out_file)


def _out_flag(h0, has_taxid: bool) -> int:
    flag = unik.SORTED
    if h0.is_canonical:
        flag |= unik.CANONICAL
    if h0.is_hashed:
        flag |= unik.HASHED
    if has_taxid:
        flag |= unik.INCLUDE_TAXID
    return flag


def _sort_in_memory(args, opt, files, mode, out_file):
    headers, code_arrays, taxid_arrays, has_taxid = load_inputs(files, opt)
    taxdb = maybe_taxonomy(opt, has_taxid and mode != "none")
    codes = np.concatenate(code_arrays) if code_arrays else np.zeros(0, np.uint64)
    if has_taxid:
        taxids = np.concatenate(
            [t if t is not None else np.zeros(len(c), np.uint32)
             for c, t in zip(code_arrays, taxid_arrays)]
        )
        codes, taxids = native.host_sort_kv(codes, taxids)
    else:
        taxids = None
        codes = native.host_sort(codes)
    if opt.verbose:
        log.info(f"sorting {len(codes)} k-mers")
    codes, taxids = extsort.collapse_batch(codes, taxids, mode, taxdb, final_round=True)
    out, _ = out_binary_stream(out_file)
    with unik.UnikWriter(
        out,
        k=headers[0].k,
        flag=_out_flag(headers[0], has_taxid),
        number=len(codes),
        max_taxid=opt.max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    ) as w:
        w.write_codes(codes, taxids)
    log_saved(opt, len(codes), out_file)
    return 0


def _sort_external(args, opt, files, mode, out_file):
    chunk_size = parse_byte_size(args.chunk_size)
    if chunk_size <= 0:
        die(f"invalid chunk size: {args.chunk_size}")
    tmp_dir = os.path.join(args.tmp_dir, os.path.basename(out_file) + ".tmp")
    if os.path.exists(tmp_dir):
        if args.force:
            shutil.rmtree(tmp_dir)
        elif os.listdir(tmp_dir):
            die(f"tmp dir not empty: {tmp_dir}, use --force to overwrite")
    os.makedirs(tmp_dir, exist_ok=True)

    from ._common import check_taxid_info_match, effective_taxids, open_reader
    from ...io.unik import check_compatibility
    from ...utils.log import check_error

    taxdb = None
    chunk_files = []
    h0 = None
    has_taxid = False

    def on_chunk(codes, taxids):
        path = extsort.chunk_file_name(tmp_dir, len(chunk_files))
        if opt.verbose:
            log.info(f"dumping chunk {len(chunk_files)}: {len(codes)} k-mers")
        extsort.dump_chunk(
            codes, taxids, path, h0.k, _out_flag(h0, has_taxid) & ~unik.SORTED,
            mode, taxdb, opt,
            compression_level=min(opt.compression_level, 1),  # temp files
        )
        chunk_files.append(path)

    acc = None
    for f in files:
        with open_reader(f, stream=True) as r:
            if h0 is None:
                h0 = r.header
                has_taxid = not opt.ignore_taxid and h0.has_taxid_info
                if has_taxid and mode != "none":
                    taxdb = maybe_taxonomy(opt, True)
                acc = extsort.ChunkAccumulator(chunk_size, has_taxid, on_chunk)
            else:
                if not opt.skip_flag_check:
                    try:
                        check_compatibility(h0, r.header, f)
                    except ValueError as e:
                        check_error(e)
                check_taxid_info_match(h0, r.header, f, opt)  # sort.go:217-222
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                acc.add(codes, taxids)
    if acc is not None:
        acc.flush()

    if opt.verbose:
        log.info(f"merging {len(chunk_files)} chunk files")

    out, _ = out_binary_stream(out_file)
    writer = unik.UnikWriter(
        out,
        k=h0.k,
        flag=_out_flag(h0, has_taxid),
        max_taxid=opt.max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    )
    n = extsort.cascade_merge(
        chunk_files,
        lambda: (lambda c, t: writer.write_codes(c, t if has_taxid else None)),
        tmp_dir,
        h0.k,
        _out_flag(h0, has_taxid) & ~unik.SORTED & ~unik.INCLUDE_TAXID,
        mode,
        taxdb,
        opt,
        max_open_files=args.max_open_files,
    )
    writer.close()
    if not args.keep_tmp_dir:
        shutil.rmtree(tmp_dir)
    log_saved(opt, n, out_file)
    return 0
