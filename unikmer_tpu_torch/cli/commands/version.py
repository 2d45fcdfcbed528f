"""version: print version information (port of
unikmer_tpu/cli/commands/version.py).

Reference: unikmer/cmd/version.go (-u checks GitHub for a newer release;
the port makes no network call, so -u says that checking is
unavailable, as the JAX command does).
"""

from __future__ import annotations

from ... import REFERENCE_VERSION, __version__
from ._common import new_command


def register(subparsers):
    p = new_command(subparsers, "version", "Print version information and check for update")
    p.add_argument("-u", "--check-update", action="store_true",
                   help="check update (requires network access)")
    p.set_defaults(func=run)


def run(args) -> int:
    print(f"unikmer-tpu-torch v{__version__} (unikmer v{REFERENCE_VERSION} compatible)")
    if args.check_update:
        print("update check unavailable: no network access")
    return 0
