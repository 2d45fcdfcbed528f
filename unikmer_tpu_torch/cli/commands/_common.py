"""Helpers shared by the port's subcommands (the parts of
unikmer_tpu/cli/commands/_common.py that ``count`` uses)."""

from __future__ import annotations

import argparse

from ...utils.log import log
from ..opts import add_global_flags


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


def log_saved(opt, n: int, out_file: str) -> None:
    if opt.verbose:
        log.info(f"{n} k-mers saved to {out_file}")
