"""tsplit: split k-mers according to TaxId (port of
unikmer_tpu/cli/commands/tsplit.py).

Reference: unikmer/cmd/tsplit.go: one output file per taxid named
{prefix}.taxid-{taxid}.k{k}.unik with a global-taxid header.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from ...io import unik
from ...utils.log import die, log
from ._common import add_files_arg, effective_taxids, new_command, open_reader, unik_inputs
from ...io.unik import check_compatibility
from ...utils.log import check_error


def register(subparsers):
    p = new_command(subparsers, "tsplit", "Split k-mers according to TaxId")
    add_files_arg(p)
    p.add_argument("-o", "--out-prefix", default="tsplit", help="out file prefix")
    p.add_argument("-O", "--out-dir", default="", help="output directory")
    p.add_argument("--force", action="store_true", help="overwrite output directory")
    p.set_defaults(func=run)


def run(args) -> int:
    opt, files = unik_inputs(args)
    out_dir = args.out_dir
    if not out_dir:
        out_dir = ("stdin" if files[0] == "-" else files[0]) + ".tsplit"
    if os.path.exists(out_dir):
        if args.force:
            shutil.rmtree(out_dir)
        elif os.listdir(out_dir):
            die(f"outdir not empty: {out_dir}, use --force to overwrite")
    os.makedirs(out_dir, exist_ok=True)

    h0 = None
    all_codes, all_tax = [], []
    max_taxid_width = 0
    for f in files:
        with open_reader(f) as r:
            h = r.header
            if h0 is None:
                h0 = h
            elif not opt.skip_flag_check:
                try:
                    check_compatibility(h0, h, f)
                except ValueError as e:
                    check_error(e)
            if not h.has_taxid_info or opt.ignore_taxid:
                die(f"input files should have taxid information: {f}")
            max_taxid_width = max(max_taxid_width, h.taxid_bytes or 4)
            codes, taxids = r.read_all()
            taxids = effective_taxids(r, len(codes), taxids, False)
            all_codes.append(codes)
            all_tax.append(taxids)

    codes = np.concatenate(all_codes) if all_codes else np.zeros(0, np.uint64)
    taxids = np.concatenate(all_tax) if all_tax else np.zeros(0, np.uint32)
    if len(codes) == 0:
        log.warning("0 taxids loaded")
        return 0

    flag = 0
    if h0.is_sorted:
        flag |= unik.SORTED
    if h0.is_canonical:
        flag |= unik.CANONICAL
    if h0.is_hashed:
        flag |= unik.HASHED

    k = h0.k
    # group by taxid with one stable radix sort (code order is kept
    # within each group), not a codes[taxids == t] scan a taxid
    from ... import native

    res = native.sort_u64_kv(taxids.astype(np.uint64), codes)
    if res is not None:
        t_s, c_s = res[0].astype(np.uint32), res[1]
    else:
        order = np.argsort(taxids, kind="stable")
        t_s, c_s = taxids[order], codes[order]
    starts = np.flatnonzero(np.r_[True, t_s[1:] != t_s[:-1]])
    bounds = np.append(starts, len(t_s))
    if opt.verbose:
        log.info(f"{len(codes)} k-mers belonging to {len(starts)} taxids loaded")

    def write_one(i: int) -> tuple[str, int]:
        taxid = int(t_s[starts[i]])
        sel = c_s[starts[i] : bounds[i + 1]]
        path = os.path.join(
            out_dir, f"{args.out_prefix}.taxid-{taxid}.k{k}{unik.EXT}"
        )
        with unik.UnikWriter(
            path,
            k=k,
            flag=flag,
            number=len(sel),
            global_taxid=taxid,
            max_taxid=(1 << (8 * max_taxid_width)) - 1,
            compress=opt.compress,
            compression_level=opt.compression_level,
            threads=1,  # parallelism is across files here
        ) as w:
            w.write_codes(sel)
        return path, len(sel)

    # per-taxid writers on a pool (tsplit.go:175-192); the native varint
    # encode and deflate release the GIL.  pool.map yields in input order
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(opt.threads, 1)) as pool:
        for path, n_sel in pool.map(write_one, range(len(starts))):
            if opt.verbose:
                log.info(f"{n_sel} k-mers saved to {path}")
    return 0
