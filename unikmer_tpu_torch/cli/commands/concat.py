"""concat: concatenate multiple binary files, duplicates kept (port of
unikmer_tpu/cli/commands/concat.py).

Reference: unikmer/cmd/concat.go.
"""

from __future__ import annotations

import numpy as np

from ...io import unik
from ...io.unik import check_compatibility
from ...utils.log import check_error, log
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



def register(subparsers):
    p = new_command(
        subparsers, "concat", "Concatenate multiple binary files without removing duplicates"
    )
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-s", "--sorted", action="store_true", help="input k-mers are sorted")
    p.add_argument("-t", "--taxid", type=int, default=0, help="global taxid")
    p.add_argument("-n", "--number", type=int, default=-1, help="number of k-mers")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    global_taxid = args.taxid
    if global_taxid > 0 and opt.verbose:
        log.warning(
            f"discarding all taxids and assigning new global taxid: {global_taxid}"
        )
    writer = None
    h0 = None
    has_taxid = False
    n = 0
    out_file = ensure_unik_suffix(args.out_prefix)
    for file in files:
        with open_reader(file) as r:
            h = r.header
            if writer is None:
                h0 = h
                has_taxid = not opt.ignore_taxid and h.has_taxid_info
                flag = 0
                if args.sorted:
                    flag |= unik.SORTED
                elif opt.compact and not h.is_hashed:
                    flag |= unik.COMPACT
                if h.is_canonical:
                    flag |= unik.CANONICAL
                if has_taxid and global_taxid == 0:
                    flag |= unik.INCLUDE_TAXID
                if h.is_hashed:
                    flag |= unik.HASHED
                out, _ = out_binary_stream(out_file)
                writer = unik.UnikWriter(
                    out,
                    k=h.k,
                    flag=flag,
                    number=args.number if args.number > 0 else -1,
                    global_taxid=global_taxid if global_taxid > 0 else 0,
                    max_taxid=(1 << (8 * h.taxid_bytes)) - 1 if h.taxid_bytes else 0,
                    compress=opt.compress,
                    compression_level=opt.compression_level,
                    threads=opt.threads,
                )
            else:
                if not opt.skip_flag_check:
                    try:
                        check_compatibility(h0, h, file)
                    except ValueError as e:
                        check_error(e)
                if global_taxid == 0:
                    check_taxid_info_match(h0, h, file, opt)
            for codes, taxids in r.iter_blocks():
                if global_taxid > 0 or not has_taxid:
                    writer.write_codes(codes)
                else:
                    taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                    if taxids is None:
                        taxids = np.zeros(len(codes), np.uint32)
                    writer.write_codes(codes, taxids)
                n += len(codes)
    if writer is not None:
        writer.close()
    log_saved(opt, n, out_file)
    return 0
