"""Subcommands of the port: each module exposes register(subparsers).

COMMANDS is the JAX CLI's list (unikmer_tpu/cli/commands/__init__.py),
in its order."""

from __future__ import annotations

import importlib

COMMANDS = [
    "count",
    "info",
    "num",
    "view",
    "dump",
    "encode",
    "decode",
    "concat",
    "inter",
    "union",
    "common",
    "diff",
    "grep",
    "sort",
    "split",
    "merge",
    "tsplit",
    "head",
    "sample",
    "filter",
    "rfilter",
    "locate",
    "map",
    "autocompletion",
    "version",
]


def register(name: str, subparsers) -> None:
    importlib.import_module(f".{name}", __package__).register(subparsers)
