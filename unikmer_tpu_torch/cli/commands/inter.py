"""inter: intersection of multiple SORTED binary files (port of
unikmer_tpu/cli/commands/inter.py; the host engine, ops/sets.intersect,
as in the JAX package: LCA on match, --mix-taxid).
"""

from __future__ import annotations

from ...ops import sets
from ._common import add_files_arg, log_saved, new_command, unik_inputs
from ._setops import load_inputs, maybe_taxonomy, write_result


def register(subparsers):
    p = new_command(subparsers, "inter",
                    "Intersection of multiple binary files (sorted input required)")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-m", "--mix-taxid", action="store_true",
                   help="allow part of files being without taxids")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    headers, code_arrays, taxid_arrays, has_taxid = load_inputs(
        files, opt, require_sorted=True, mix_taxid=args.mix_taxid
    )
    taxdb = maybe_taxonomy(opt, has_taxid and len(files) > 1)
    codes, taxids = sets.intersect(code_arrays, taxid_arrays, taxdb)
    out_file = write_result(
        args.out_prefix, opt, headers[0], codes, taxids, sort_flag=True
    )
    log_saved(opt, len(codes), out_file)
    return 0
