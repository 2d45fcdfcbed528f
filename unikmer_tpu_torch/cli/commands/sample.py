"""sample: sample k-mers from binary files (port of
unikmer_tpu/cli/commands/sample.py).

Reference: unikmer/cmd/sample.go: keep the j-th record (1-based, reset
per file) when j >= start and (j-start) % window == 0.
"""

from __future__ import annotations

import numpy as np

from ._common import (
    add_files_arg,
    check_taxid_info_match,
    effective_taxids,
    log_saved,
    make_writer_like,
    new_command,
    open_reader,
    unik_inputs,
)
from ..opts import ensure_unik_suffix
from ...utils.log import check_error, die
from ...io.unik import check_compatibility


def register(subparsers):
    p = new_command(subparsers, "sample", "Sample k-mers from binary files")
    add_files_arg(p)
    p.add_argument("-s", "--start", type=int, default=1, help="start location")
    p.add_argument("-w", "--window", type=int, default=1, help="window size")
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    start, window = args.start, args.window
    if start <= 0:
        die(f"value of flag -s/--start should be positive: {start}")
    if window <= 0:
        die(f"value of flag -w/--window should be positive: {window}")
    writer = None
    h0 = None
    has_taxid = False
    n = 0
    out_file = ensure_unik_suffix(args.out_prefix)
    for file in files:
        with open_reader(file, stream=True) as r:
            if writer is None:
                h0 = r.header
                has_taxid = not opt.ignore_taxid and h0.has_taxid_info
                writer = make_writer_like(r, args.out_prefix, opt, has_taxid)
            else:
                if not opt.skip_flag_check:
                    try:
                        check_compatibility(h0, r.header, file)
                    except ValueError as e:
                        check_error(e)
                check_taxid_info_match(h0, r.header, file, opt)
            j = 0
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                # vectorized j-filter over the block
                idx = j + 1 + np.arange(len(codes))
                keep = (idx >= start) & ((idx - start) % window == 0)
                j += len(codes)
                if not keep.any():
                    continue
                kept = codes[keep]
                if has_taxid:
                    t = (taxids[keep] if taxids is not None
                         else np.zeros(int(keep.sum()), np.uint32))
                    writer.write_codes(kept, t)
                else:
                    writer.write_codes(kept)
                n += len(kept)
    if writer is not None:
        writer.close()
    log_saved(opt, n, out_file)
    return 0
