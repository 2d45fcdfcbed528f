"""Lazy module proxy for torch.

Importing torch costs seconds, longer than most host-only CLI commands'
whole run (view, dump, info, num, sort, ... never touch the card).
Modules whose module-level code does not need torch import this proxy
instead: the real import happens on the first attribute access, that is
only when a device path runs.  The port's copy of unikmer_tpu/_lazy.py.
"""

from __future__ import annotations

import importlib


class LazyModule:
    """Attribute-forwarding proxy; resolves the module on first use."""

    __slots__ = ("_name",)

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)

    def __repr__(self):  # pragma: no cover
        return f"<lazy module {self._name!r}>"


torch = LazyModule("torch")
