"""filter: filter out low-complexity k-mers (port of
unikmer_tpu/cli/commands/filter.py).

Reference: unikmer/cmd/filter.go (one input file; the writer copies the
reader's flag).  The mask runs on the port's device (``get_device()``:
the card unless UNIKMER_TPU_TORCH_DEVICE asks for the CPU), one call a
block of the input, and one ``write_codes`` a block, so the output's
blocks are the JAX command's.
"""

from __future__ import annotations

import numpy as np

from ..._device import get_device
from ..._lazy import torch
from ...io import unik
from ...ops.filter import low_complexity_mask
from ...utils.log import die, log
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import add_files_arg, log_saved, new_command, open_reader, unik_inputs


def register(subparsers):
    p = new_command(subparsers, "filter", "Filter out low-complexity k-mers (experimental)")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="-",
                   help='out file prefix ("-" for stdout)')
    p.add_argument("-v", "--invert", action="store_true",
                   help="invert result, i.e., output low-complexity k-mers")
    p.add_argument("-t", "--threshold", type=int, default=15,
                   help="penalty threshold for filter, higher is stricter")
    p.add_argument("-w", "--window", type=int, default=7,
                   help="window size for checking penalty")
    p.add_argument("-s", "--penalty-s", type=int, default=3,
                   help="penalty for successive bases")
    p.add_argument("-d", "--penalty-d", type=int, default=1,
                   help="penalty for different bases")
    p.set_defaults(func=run)


def block_mask(codes, device: torch.device, k: int, penalty_s: int,
               penalty_d: int, threshold: int, window: int):
    """low_complexity_mask of a block of u64 codes on ``device``: the
    codes cross as int64 bit patterns, the bool mask comes back."""
    # a block decoded from a buffer is read-only: torch wants it writable
    x = torch.from_numpy(np.require(codes, np.uint64, "CW").view(np.int64))
    x = x.to(device)
    return low_complexity_mask(x, k, penalty_s, penalty_d, threshold,
                               window).cpu().numpy()


def run(args) -> int:
    opt, files = unik_inputs(args)
    if len(files) > 1:
        die("no more than one file should be given")
    if args.threshold < 0:
        die("threshold should be non-negative")
    try:
        device = get_device()
    except RuntimeError as e:
        die(str(e))
    out_file = ensure_unik_suffix(args.out_prefix)
    n = 0
    with open_reader(files[0]) as r:
        h = r.header
        if h.is_hashed:
            die("filter command requires encoded (non-hashed) k-mers")
        window = args.window
        if window > h.k:
            log.warning(f"window size ({window}) is bigger than k ({h.k})")
            window = h.k
        out, _ = out_binary_stream(out_file)
        writer = unik.UnikWriter(
            out,
            k=h.k,
            flag=h.flag,
            max_taxid=(1 << (8 * h.taxid_bytes)) - 1 if h.taxid_bytes else 0,
            compress=opt.compress,
            compression_level=opt.compression_level,
            threads=opt.threads,
        )
        for codes, taxids in r.iter_blocks():
            low = block_mask(codes, device, h.k, args.penalty_s,
                             args.penalty_d, args.threshold, window)
            keep = low if args.invert else ~low
            kept = codes[keep]
            writer.write_codes(
                kept, taxids[keep] if taxids is not None else None
            )
            n += len(kept)
        writer.close()
    log_saved(opt, n, out_file)
    return 0
