"""Global options and CLI helpers of the port (the parts of
unikmer_tpu/cli/opts.py that its subcommands use): the same global
flags, defaults, environment names and file-list rules."""

from __future__ import annotations

import argparse
import gzip
import io
import os
import sys
from dataclasses import dataclass

from .. import native
from ..io.unik import EXT
from ..utils.log import die, init_logging

DEFAULT_DATA_DIR = os.path.expanduser("~/.unikmer/")


@dataclass
class Options:
    threads: int = 4
    verbose: bool = False
    compress: bool = True
    compact: bool = False
    compression_level: int = 5
    max_taxid: int = (1 << 32) - 1
    ignore_taxid: bool = False
    data_dir: str = DEFAULT_DATA_DIR
    skip_flag_check: bool = False
    skip_file_check: bool = False
    mesh: int = 0


# --mesh is parsed but not ported: the subcommands exit with this
MESH_NOT_PORTED = "--mesh (multi-GPU over NCCL): ROADMAP.md queue 1 item 9"


def add_global_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("global flags")
    g.add_argument("-j", "--threads", type=int, default=min(os.cpu_count() or 4, 4),
                   help="number of host worker threads")
    g.add_argument("--verbose", action="store_true", help="print verbose information")
    g.add_argument("-C", "--no-compress", action="store_true",
                   help="do not compress binary file (not recommended)")
    g.add_argument("--compression-level", type=int, default=5,
                   help="compression level")
    g.add_argument("-c", "--compact", action="store_true",
                   help="write compact binary file with little loss of speed")
    g.add_argument("-i", "--infile-list", default="",
                   help="file of input files list (one file per line), appended to cli args")
    g.add_argument("--max-taxid", type=int, default=(1 << 32) - 1,
                   help="for smaller TaxIds, use less space to store TaxIds")
    g.add_argument("-I", "--ignore-taxid", action="store_true",
                   help="ignore taxonomy information")
    g.add_argument("--data-dir", default=None,
                   help="directory containing NCBI Taxonomy nodes.dmp etc.")
    g.add_argument("--skip-flag-check", action="store_true",
                   help="do not check binary file flags")
    g.add_argument("--skip-file-check", action="store_true",
                   help="skip checking input file existence")
    g.add_argument("--mesh", type=int,
                   default=int(os.environ.get("UNIKMER_TPU_MESH", "0")),
                   help="shard across a mesh of this many devices (not "
                        "ported yet: only 0)")


def get_options(args: argparse.Namespace) -> Options:
    # $UNIKMER_DB overrides data-dir unless the flag was given
    data_dir = args.data_dir
    if data_dir is None:
        data_dir = os.environ.get("UNIKMER_DB") or DEFAULT_DATA_DIR
    if args.threads <= 0:
        die(f"invalid threads: {args.threads}")
    native.set_threads(args.threads)  # -j caps native threads too
    opt = Options(
        threads=args.threads,
        verbose=args.verbose,
        compress=not args.no_compress,
        compact=args.compact,
        compression_level=args.compression_level,
        max_taxid=args.max_taxid,
        ignore_taxid=args.ignore_taxid,
        data_dir=data_dir,
        skip_flag_check=args.skip_flag_check,
        skip_file_check=args.skip_file_check,
        mesh=args.mesh,
    )
    init_logging(opt.verbose)
    return opt


def get_file_list(args: argparse.Namespace, check_exists: bool = True) -> list[str]:
    """Positional files + -i list file; '-' (stdin) when none given."""
    files = list(getattr(args, "files", []) or [])
    infile_list = getattr(args, "infile_list", "")
    if infile_list:
        try:
            with (sys.stdin.buffer if infile_list == "-" else open(infile_list, "rb")) as f:
                for line in f:
                    line = line.strip().decode()
                    if line and line != "-":
                        files.append(line)
        except OSError as e:
            die(f"reading infile list: {e}")
    if not files:
        return ["-"]
    if check_exists:
        for f in files:
            if f != "-" and not os.path.exists(f):
                die(f"file not found: {f}")
    return files


def check_file_suffix(files: list[str], skip: bool = False) -> None:
    """Inputs must be stdin or end in .unik."""
    if skip:
        return
    for f in files:
        if f != "-" and not f.endswith(EXT):
            die(f"input should be stdin or file with suffix {EXT}: {f}")


def ensure_unik_suffix(path: str) -> str:
    if path != "-" and not path.endswith(EXT):
        return path + EXT
    return path


def out_binary_stream(path: str):
    """Binary out stream; '-' = stdout."""
    if path == "-":
        return sys.stdout.buffer, False
    return open(path, "wb"), True


def out_text_stream(path: str, compression_level: int = 5):
    """Text out stream; '-' = stdout, a .gz suffix gzips (view -o)."""
    if path == "-":
        return sys.stdout, False
    if path.lower().endswith(".gz"):
        return (
            io.TextIOWrapper(
                gzip.open(path, "wb", compresslevel=compression_level),
                encoding="utf-8",
            ),
            True,
        )
    return open(path, "w"), True
