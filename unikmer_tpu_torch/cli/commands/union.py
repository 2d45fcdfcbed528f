"""union: union of multiple binary files, TaxIds merged by LCA (port of
unikmer_tpu/cli/commands/union.py).

Inputs with taxids (more than one file) may take the device route,
ops/device_sets.union_taxids_device: one K3 sort and the compact-id LCA
rounds, on the card (or on the CPU, where UNIKMER_TPU_TORCH_DEVICE says
so).  UNIKMER_TPU_DEVICE_TAXID picks the route before any input is read
and before torch is imported: ``1`` tries the device, ``0`` never does,
and ``auto`` (the default) tries it when the input files total at least
UNIKMER_TPU_DEVICE_TAXID_MIN_MB (default DEVICE_TAXID_MIN_MB) MiB of
``.unik`` bytes, not from stdin, as in the JAX CLI but with the card's
own crossover; inside the resident server (server.py)
``auto`` tries the device at any size, as ``count``'s ``auto`` takes it
there.  The host engine (ops/sets.union) answers the rest, and where the
device route returns None (unknown nonzero taxids, a real 2^64-1 code,
past the card's memory budget); the bytes are the JAX CLI's either way.
``--mesh N`` takes the sharded engine (parallel/sharded.py) first, these
routes where it returns None.
"""

from __future__ import annotations

import os

from ...ops import sets
from ._common import add_files_arg, log_saved, new_command, unik_inputs
from ._setops import load_inputs, maybe_taxonomy, mesh_route, write_result

# auto's threshold, MiB of input: in fresh processes on an H100 the host
# engine won at 220 MiB of sorted taxid .unik input (7.5-8.3 s against
# 9.6-9.9 s, the card's start-up included) and the card from 437 MiB
# (12.5 s against 13.3-14.3 s); python -m unikmer_tpu_torch.taxid_route_times
DEVICE_TAXID_MIN_MB = 437


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
    route_device = _device_taxid_requested(files)
    headers, code_arrays, taxid_arrays, has_taxid = load_inputs(files, opt)
    res = mesh_route("union", code_arrays, taxid_arrays, headers[0], opt)
    taxdb = maybe_taxonomy(opt, has_taxid and len(files) > 1)
    if res is None and taxdb is not None and route_device:
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


def _device_taxid_requested(files) -> bool:
    """Try the device taxid union?  UNIKMER_TPU_DEVICE_TAXID: 1 = yes
    (its guards may still send the inputs to the host engine), 0 = never,
    auto (default) = in the resident server, or for inputs totalling at
    least UNIKMER_TPU_DEVICE_TAXID_MIN_MB (default DEVICE_TAXID_MIN_MB)
    MiB of .unik bytes and not read from stdin: below that the torch
    import and the CUDA context cost more than the card saves on the
    host engine's union."""
    knob = os.environ.get("UNIKMER_TPU_DEVICE_TAXID", "auto")
    if knob in ("0", "1"):
        return knob == "1"
    if os.environ.get("UNIKMER_TPU_IN_SERVER"):
        return True
    if any(f == "-" for f in files):
        return False
    try:
        total = sum(os.path.getsize(f) for f in files)
    except OSError:
        return False
    return total >= float(os.environ.get(
        "UNIKMER_TPU_DEVICE_TAXID_MIN_MB", DEVICE_TAXID_MIN_MB)) * (1 << 20)
