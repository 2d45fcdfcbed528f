"""union: union of multiple binary files, TaxIds merged by LCA (port of
unikmer_tpu/cli/commands/union.py).

Inputs with taxids (more than one file) take the device route,
ops/device_sets.union_taxids_device: one K3 sort and the compact-id LCA
rounds, on the card and on the CPU alike.  The host engine
(ops/sets.union) answers where that route returns None (unknown nonzero
taxids, a real 2^64-1 code) and for inputs without taxids; the bytes are
the JAX CLI's either way.  ``--mesh N`` takes the sharded engine
(parallel/sharded.py) first, these routes where it returns None.
"""

from __future__ import annotations

from ...ops import sets
from ._common import add_files_arg, log_saved, new_command, unik_inputs
from ._setops import load_inputs, maybe_taxonomy, mesh_route, write_result


def register(subparsers):
    p = new_command(subparsers, "union",
                    "Union of multiple binary files (k-mers deduplicated, TaxIds merged by LCA)")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-s", "--sort", action="store_true",
                   help="sort k-mers, significantly reduces file size for k<=25. Overrides -c/--compact")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    headers, code_arrays, taxid_arrays, has_taxid = load_inputs(files, opt)
    res = mesh_route("union", code_arrays, taxid_arrays, headers[0], opt)
    taxdb = maybe_taxonomy(opt, has_taxid and len(files) > 1)
    if res is None and taxdb is not None:
        from ...ops.device_sets import union_taxids_device

        h0 = headers[0]
        res = union_taxids_device(
            code_arrays, taxid_arrays, taxdb,
            code_bits=64 if h0.is_hashed else 2 * h0.k)
    if res is not None:
        codes, taxids = res
    else:
        codes, taxids = sets.union(code_arrays, taxid_arrays, taxdb)
    out_file = write_result(
        args.out_prefix, opt, headers[0], codes, taxids, sort_flag=args.sort
    )
    log_saved(opt, len(codes), out_file)
    return 0
