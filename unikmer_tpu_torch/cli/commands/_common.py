"""Helpers shared by the port's subcommands (the parts of
unikmer_tpu/cli/commands/_common.py that its subcommands use)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ...io.unik import INCLUDE_TAXID, UnikReader, UnikWriter
from ...utils.log import die, log
from ..opts import (
    add_global_flags, check_file_suffix, ensure_unik_suffix,
    get_file_list, get_options, out_binary_stream,
)


def new_command(subparsers, name: str, help_: str, **kw) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        name,
        help=help_,
        description=help_,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        **kw,
    )
    add_global_flags(p)
    return p


def add_files_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("files", nargs="*", default=[], help="input .unik file(s)")


def unik_inputs(args, check_suffix: bool = True):
    """(options, file list) with existence and suffix checks."""
    opt = get_options(args)
    files = get_file_list(args, check_exists=not opt.skip_file_check)
    if check_suffix:
        check_file_suffix(files, skip=opt.skip_file_check)
    return opt, files


def check_mesh_devices(opt) -> None:
    """--mesh N needs N devices (parallel/mesh.device_count)."""
    from ...parallel import mesh

    if mesh.device_count() < opt.mesh:
        die(f"--mesh {opt.mesh} needs {opt.mesh} devices, "
            f"found {mesh.device_count()}")


def open_reader(file: str, stream: bool = False) -> UnikReader:
    """A reader of a .unik file, or of stdin for "-".  ``stream=True``
    for commands that consume blocks one at a time (head, sample,
    concat, num, info and the external sort and split inputs): it skips
    the whole-file parallel inflate, so memory stays bounded whatever
    the input's size.  Whole-set commands keep the default: they read
    everything anyway, and the parallel inflate reads it faster."""
    return UnikReader(sys.stdin.buffer if file == "-" else file,
                      stream=stream)


def check_taxid_info_match(h0, h, file, opt) -> None:
    """Multi-file inputs must ALL have (or all lack) taxid info unless
    -I/--ignore-taxid (reference sort.go:217-222; the same block appears
    in concat/merge/sample/split/view/grep/head)."""
    if opt.ignore_taxid or h.has_taxid_info == h0.has_taxid_info:
        return
    if h.has_taxid_info:
        die(
            "taxid information not found in previous files, "
            f"but found in this: {file}"
        )
    die(
        "taxid information found in previous files, "
        f"but missing in this: {file}"
    )


def effective_taxids(reader: UnikReader, n: int, taxids, ignore_taxid: bool):
    """Per-record taxids, a global taxid made into a column (readers
    report the global taxid for every record)."""
    if ignore_taxid:
        return None
    if taxids is not None:
        return taxids
    h = reader.header
    if h.has_global_taxid:
        return np.full(n, h.global_taxid, np.uint32)
    return None


def make_writer_like(
    reader: UnikReader, out_path: str, opt, has_taxid: bool, number: int = -1
) -> UnikWriter:
    """Writer whose flag copies the reader's (+INCLUDE_TAXID when the
    inputs carry taxid info), as head.go and sample.go write."""
    h = reader.header
    flag = h.flag
    if has_taxid:
        flag |= INCLUDE_TAXID
    max_taxid = (1 << (8 * h.taxid_bytes)) - 1 if h.taxid_bytes else 0
    out, _ = out_binary_stream(ensure_unik_suffix(out_path))
    return UnikWriter(
        out,
        k=h.k,
        flag=flag,
        number=number,
        global_taxid=0 if has_taxid else h.global_taxid,
        scale=h.scale,
        max_taxid=max_taxid,
        compress=opt.compress,
        compression_level=opt.compression_level,
        threads=opt.threads,
    )


def log_saved(opt, n: int, out_file: str) -> None:
    if opt.verbose:
        log.info(f"{n} k-mers saved to {out_file}")
