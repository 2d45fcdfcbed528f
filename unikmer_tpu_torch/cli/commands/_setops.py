"""Shared input loading and output of the set-operation subcommands (the
port's copy of unikmer_tpu/cli/commands/_setops.py, without the mesh
routes: --mesh is not ported yet)."""

from __future__ import annotations

import numpy as np

from ...io import unik
from ...io.unik import check_compatibility
from ...utils.log import check_error, die, log
from ..opts import ensure_unik_suffix, out_binary_stream
from ._common import effective_taxids, open_reader


def load_inputs(
    files,
    opt,
    require_sorted: bool = False,
    mix_taxid: bool = False,
):
    """Read all inputs fully.  Returns (headers, code_arrays, taxid_arrays,
    has_taxid) where taxid_arrays is None when no input carries taxids;
    files without taxids contribute zeros in mix mode."""
    headers, code_arrays, taxid_arrays = [], [], []
    has_flags = []
    h0 = None
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
            if require_sorted and not h.is_sorted:
                die(f"input file should be sorted: {f}")
            codes, taxids = r.read_all()
            taxids = effective_taxids(r, len(codes), taxids, opt.ignore_taxid)
            headers.append(h)
            code_arrays.append(codes)
            taxid_arrays.append(taxids)
            has_flags.append(taxids is not None)
    any_taxid = any(has_flags)
    all_taxid = all(has_flags)
    if any_taxid and not all_taxid:
        if not mix_taxid:
            i = has_flags.index(True) if not has_flags[0] else has_flags.index(False)
            if has_flags[i]:
                die(f"taxid information not found in previous files, but found in this: {files[i]}")
            die(f"taxid information found in previous files, but missing in this: {files[i]}")
        log.info("part of files being without taxids (--mix-taxid)")
        taxid_arrays = [
            t if t is not None else np.zeros(len(c), np.uint32)
            for c, t in zip(code_arrays, taxid_arrays)
        ]
    if not any_taxid:
        taxid_arrays = None
    return headers, code_arrays, taxid_arrays, any_taxid


def maybe_taxonomy(opt, needed: bool):
    if not needed:
        return None
    from ...taxonomy.taxdump import load_taxonomy

    return load_taxonomy(opt.data_dir, with_rank=False, verbose=opt.verbose)


def write_result(
    out_prefix,
    opt,
    h0,
    codes,
    taxids,
    sort_flag: bool,
    number_known: bool = True,
):
    """Write a result set with flags assembled like the reference's
    set-op outputs."""
    flag = 0
    if sort_flag:
        flag |= unik.SORTED
    elif opt.compact and not h0.is_hashed:
        flag |= unik.COMPACT
    if h0.is_canonical:
        flag |= unik.CANONICAL
    if taxids is not None:
        flag |= unik.INCLUDE_TAXID
    if h0.is_hashed:
        flag |= unik.HASHED
    out_file = ensure_unik_suffix(out_prefix)
    out, _ = out_binary_stream(out_file)
    with unik.UnikWriter(
        out,
        k=h0.k,
        flag=flag,
        number=len(codes) if number_known else -1,
        scale=h0.scale,
        max_taxid=opt.max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    ) as w:
        w.write_codes(codes, taxids)
    return out_file
