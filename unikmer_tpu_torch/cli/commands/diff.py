"""diff: set difference of multiple binary files (port of
unikmer_tpu/cli/commands/diff.py; the host engine, ops/sets.subtract).

The first file must be sorted; --compare-taxid keeps a matched query
k-mer when the target taxid equals the query's or is its descendant.
"""

from __future__ import annotations

from ...io.unik import check_compatibility
from ...ops import sets
from ...utils.log import check_error, die
from ._common import (
    add_files_arg, effective_taxids, log_saved, new_command, open_reader,
    unik_inputs,
)
from ._setops import maybe_taxonomy, write_result


def register(subparsers):
    p = new_command(subparsers, "diff",
                    "Set difference of multiple binary files")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-s", "--sort", action="store_true",
                   help="sort k-mers. Overrides -c/--compact")
    p.add_argument("-t", "--compare-taxid", action="store_true",
                   help="take taxid into consideration: keep a k-mer when "
                        "the target taxid equals the query's or is its descendant")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    # first (query) file: must be sorted
    with open_reader(files[0]) as r:
        h0 = r.header
        if not h0.is_sorted:
            die(f"the first file should be sorted: {files[0]}")
        q_codes, q_tax = r.read_all()
        q_tax = effective_taxids(r, len(q_codes), q_tax, opt.ignore_taxid)
    has_taxid = q_tax is not None
    q_codes, q_tax = sets.dedup_sorted(q_codes, q_tax, None)

    taxdb = maybe_taxonomy(opt, args.compare_taxid and has_taxid)

    other_codes, other_tax = [], []
    for f in files[1:]:
        with open_reader(f) as r:
            if not opt.skip_flag_check:
                try:
                    check_compatibility(h0, r.header, f)
                except ValueError as e:
                    check_error(e)
            if (args.compare_taxid and not opt.ignore_taxid
                    and r.header.has_taxid_info != has_taxid):
                if r.header.has_taxid_info:
                    die(f"taxid information not found in previous files, but found in this: {f}")
                die(f"taxid information found in previous files, but missing in this: {f}")
            codes, taxids = r.read_all()
            taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
            other_codes.append(codes)
            other_tax.append(taxids)

    codes, taxids = sets.subtract(
        q_codes,
        q_tax,
        other_codes,
        other_tax if has_taxid else None,
        compare_taxid=args.compare_taxid,
        taxdb=taxdb,
    )
    out_file = write_result(
        args.out_prefix, opt, h0, codes, taxids, sort_flag=args.sort
    )
    log_saved(opt, len(codes), out_file)
    return 0
