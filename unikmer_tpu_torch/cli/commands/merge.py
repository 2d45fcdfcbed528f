"""merge: merge k-mers from sorted chunk files (port of
unikmer_tpu/cli/commands/merge.py).

Reference: unikmer/cmd/merge.go (directories scanned by the regex
^chunk_\\d+\\.unik$, a cascade past max-open-files, unique/repeated
modes).
"""

from __future__ import annotations

import os
import re
import shutil

from ...io import unik
from ...pipeline import extsort
from ...utils.log import die, log
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import (
    add_files_arg,
    check_taxid_info_match,
    log_saved,
    new_command,
    open_reader,
    unik_inputs,
)
from ._setops import maybe_taxonomy


def register(subparsers):
    p = new_command(subparsers, "merge", "Merge k-mers from sorted chunk files")
    add_files_arg(p)
    p.add_argument("-D", "--is-dir", action="store_true",
                   help="input files are directories containing chunk files")
    p.add_argument("-p", "--pattern", default=r"^chunk_\d+\.unik$",
                   help="chunk file pattern (regular expression)")
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-u", "--unique", action="store_true", help="remove duplicate k-mers")
    p.add_argument("-d", "--repeated", action="store_true", help="only print duplicate k-mers")
    p.add_argument("-M", "--max-open-files", type=int, default=400, help="max number of open files")
    p.add_argument("-t", "--tmp-dir", default="./", help="directory for intermediate files")
    p.add_argument("-k", "--keep-tmp-dir", action="store_true", help="keep tmp dir")
    p.add_argument("--force", action="store_true", help="overwrite tmp dir")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args, check_suffix=not args.is_dir)
    if args.unique and args.repeated:
        die("flag -u/--unique and -d/--repeated are not compatible")
    mode = "unique" if args.unique else "repeated" if args.repeated else "none"

    if "-" in files:
        # the k-way merge needs seekable chunk files (merge.go:152)
        log.warning("skip stdin")
        files = [f for f in files if f != "-"]
    if args.is_dir:
        pattern = re.compile(args.pattern)
        expanded = []
        for d in files:
            if not os.path.isdir(d):
                die(f"not a directory: {d}")
            found = sorted(
                os.path.join(d, f) for f in os.listdir(d) if pattern.search(f)
            )
            if opt.verbose:
                log.info(f"{len(found)} chunk files found in {d}")
            expanded.extend(found)
        files = expanded
    if not files:
        die("no input chunk files")

    h0 = None
    has_taxid = False
    for f in files:
        with open_reader(f) as r:
            if h0 is None:
                h0 = r.header
                has_taxid = not opt.ignore_taxid and h0.has_taxid_info
            else:
                check_taxid_info_match(h0, r.header, f, opt)  # merge.go:199-204
            if not r.header.is_sorted:
                die(f"input file should be sorted: {f}")

    taxdb = maybe_taxonomy(opt, has_taxid and mode != "none")

    flag = unik.SORTED
    if h0.is_canonical:
        flag |= unik.CANONICAL
    if h0.is_hashed:
        flag |= unik.HASHED
    if has_taxid:
        flag |= unik.INCLUDE_TAXID

    out_file = ensure_unik_suffix(args.out_prefix)
    tmp_dir = os.path.join(args.tmp_dir, os.path.basename(out_file) + ".tmp")
    need_cascade = len(files) > args.max_open_files
    if need_cascade:
        if os.path.exists(tmp_dir):
            if args.force:
                shutil.rmtree(tmp_dir)
            elif os.listdir(tmp_dir):
                die(f"tmp dir not empty: {tmp_dir}, use --force to overwrite")
        os.makedirs(tmp_dir, exist_ok=True)

    out, _ = out_binary_stream(out_file)
    writer = unik.UnikWriter(
        out,
        k=h0.k,
        flag=flag,
        max_taxid=opt.max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    )
    n = extsort.cascade_merge(
        files,
        lambda: (lambda c, t: writer.write_codes(c, t if has_taxid else None)),
        tmp_dir,
        h0.k,
        (flag & ~unik.SORTED & ~unik.INCLUDE_TAXID),
        mode,
        taxdb,
        opt,
        max_open_files=args.max_open_files,
    )
    writer.close()
    if need_cascade and not args.keep_tmp_dir and os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    log_saved(opt, n, out_file)
    return 0
