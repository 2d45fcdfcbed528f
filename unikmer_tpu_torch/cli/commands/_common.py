"""Helpers shared by the port's subcommands (the parts of
unikmer_tpu/cli/commands/_common.py that its subcommands use)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ...io.unik import UnikReader
from ...utils.log import die, log
from ..opts import (
    MESH_NOT_PORTED, add_global_flags, check_file_suffix, get_file_list,
    get_options,
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
    """(options, file list) with existence and suffix checks; --mesh,
    not ported yet, exits naming ROADMAP.md."""
    opt = get_options(args)
    files = get_file_list(args, check_exists=not opt.skip_file_check)
    if check_suffix:
        check_file_suffix(files, skip=opt.skip_file_check)
    if opt.mesh >= 1:
        die(f"not supported by unikmer_tpu_torch yet: {MESH_NOT_PORTED}")
    return opt, files


def open_reader(file: str) -> UnikReader:
    """A reader of a .unik file, or of stdin for "-"."""
    return UnikReader(sys.stdin.buffer if file == "-" else file)


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


def log_saved(opt, n: int, out_file: str) -> None:
    if opt.verbose:
        log.info(f"{n} k-mers saved to {out_file}")
