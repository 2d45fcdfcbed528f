"""unikmer-tpu-torch CLI: the ``count``, ``info`` (``stats``), ``num``,
``view``, ``dump``, ``encode``, ``decode``, ``concat``, ``inter``,
``union``, ``common``, ``diff`` and ``grep`` subcommands on the
PyTorch/CUDA port.

Same global flags (cli/opts.py, the port's copy of unikmer_tpu/cli/opts.py)
and exit-code conventions as ``python -m unikmer_tpu.cli.main``; the
other subcommands are not ported yet (ROADMAP.md queue 1 item 12).

    python -m unikmer_tpu_torch.cli.main count -k 23 -K -s in.fa -o a
    python -m unikmer_tpu_torch.cli.main union -s a.unik b.unik -o u
    python -m unikmer_tpu_torch.cli.main view a.unik | head
"""

from __future__ import annotations

import argparse
import lzma
import sys
import zlib

from .. import REFERENCE_VERSION, __version__
from .commands import (
    common, concat, count, decode, diff, dump, encode, grep, info, inter, num,
    union, view,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unikmer-tpu-torch",
        description=(
            "unikmer-tpu-torch - the k-mer toolkit on PyTorch and CUDA "
            "(unikmer-compatible count, format, lookup and set "
            "operations)\n\n"
            f"Version: v{__version__} (reference parity: unikmer "
            f"v{REFERENCE_VERSION})"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", metavar="command")
    # the JAX CLI's order (unikmer_tpu/cli/commands/__init__.py)
    for cmd in (count, info, num, view, dump, encode, decode, concat, inter,
                union, common, diff, grep):
        cmd.register(sub)
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    try:
        return args.func(args) or 0
    except SystemExit as e:
        # die() exits like the reference; main() returns the code instead
        code = e.code
        if code is None:
            return 0
        return code & 0xFF if isinstance(code, int) else 255
    except BrokenPipeError:
        return 0
    except KeyboardInterrupt:
        return 130
    except (ValueError, OSError, EOFError, zlib.error, lzma.LZMAError) as e:
        import os

        if os.environ.get("UNIKMER_TPU_DEBUG"):
            raise
        from ..utils.log import init_logging, log

        init_logging(False)
        log.error(str(e))
        return 255


if __name__ == "__main__":
    sys.exit(main())
