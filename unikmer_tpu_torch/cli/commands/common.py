"""common: k-mers shared by most of the binary files (port of
unikmer_tpu/cli/commands/common.py; the host engine, ops/sets.common).

The threshold comes from -n, or from the proportion -p of the files;
taxids merge by LCA across files; the output is sorted.
"""

from __future__ import annotations

import math

from ... import native
from ...ops import sets
from ...utils.log import die
from ._common import add_files_arg, log_saved, new_command, unik_inputs
from ._setops import load_inputs, maybe_taxonomy, write_result


def register(subparsers):
    p = new_command(subparsers, "common",
                    "Finding k-mers shared by most of the binary files")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-m", "--mix-taxid", action="store_true",
                   help="allow part of files being without taxids")
    p.add_argument("-p", "--proportion", type=float, default=1.0,
                   help="minimum proportion of files that share a k-mer")
    p.add_argument("-n", "--number", type=int, default=0,
                   help="minimum number of files that share a k-mer (overrides -p/--proportion)")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    if len(files) > 65535:
        die("at most 65535 input files supported")
    headers, code_arrays, taxid_arrays, has_taxid = load_inputs(
        files, opt, mix_taxid=args.mix_taxid
    )
    if args.number > 0:
        threshold = args.number
    else:
        if not 0 < args.proportion <= 1:
            die(f"value of -p/--proportion should be in (0, 1]: {args.proportion}")
        threshold = max(1, math.ceil(args.proportion * len(files)))
    taxdb = maybe_taxonomy(opt, has_taxid and len(files) > 1)
    # inputs may be unsorted; sort before set algebra
    for i in range(len(code_arrays)):
        if not headers[i].is_sorted:
            if taxid_arrays is not None and taxid_arrays[i] is not None:
                code_arrays[i], taxid_arrays[i] = native.host_sort_kv(
                    code_arrays[i], taxid_arrays[i]
                )
            else:
                code_arrays[i] = native.host_sort(code_arrays[i])
    codes, taxids = sets.common(code_arrays, taxid_arrays, threshold, taxdb)
    out_file = write_result(
        args.out_prefix, opt, headers[0], codes, taxids, sort_flag=True
    )
    log_saved(opt, len(codes), out_file)
    return 0
