"""head: extract the first N k-mers (port of
unikmer_tpu/cli/commands/head.py).

Reference: unikmer/cmd/head.go (the output's flag copies the reader's,
+INCLUDE_TAXID when the inputs have taxid info; N counts across files).
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
from ...utils.log import check_error
from ...io.unik import check_compatibility


def register(subparsers):
    p = new_command(subparsers, "head", "Extract the first N k-mers")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-n", "--number", type=int, default=10,
                   help="number of k-mers to extract")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    N = args.number
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
            done = False
            for codes, taxids in r.iter_blocks():
                taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
                take = min(len(codes), N - n)
                if take <= 0:
                    done = True
                    break
                codes = codes[:take]
                if has_taxid:
                    t = (taxids[:take] if taxids is not None
                         else np.zeros(take, np.uint32))
                    writer.write_codes(codes, t)
                else:
                    writer.write_codes(codes)
                n += take
                if n >= N:
                    done = True
                    break
        if done:
            break
    if writer is not None:
        writer.close()
    log_saved(opt, n, out_file)
    return 0
