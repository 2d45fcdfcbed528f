"""unikmer-tpu-torch CLI: the unikmer-compatible subcommands on the
PyTorch/CUDA port, all of the JAX CLI's: counting, information, format
conversion, set operations, split and merge, subsets, the genome
commands (locate, map) and the misc commands.

Same global flags (cli/opts.py, the port's copy of unikmer_tpu/cli/opts.py)
and exit-code conventions as ``python -m unikmer_tpu.cli.main``.

    python -m unikmer_tpu_torch.cli.main count -k 23 -K -s in.fa -o a
    python -m unikmer_tpu_torch.cli.main union -s a.unik b.unik -o u
    python -m unikmer_tpu_torch.cli.main sort -u -m 16M a.unik -o s
    python -m unikmer_tpu_torch.cli.main view a.unik | head
    python -m unikmer_tpu_torch.cli.main locate -g g.fa a.unik
"""

from __future__ import annotations

import argparse
import lzma
import sys
import zlib

from .. import REFERENCE_VERSION, __version__
from . import commands


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unikmer-tpu-torch",
        description=(
            "unikmer-tpu-torch - the k-mer toolkit on PyTorch and CUDA "
            "(unikmer-compatible)\n\n"
            f"Version: v{__version__} (reference parity: unikmer "
            f"v{REFERENCE_VERSION})"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", metavar="command")
    for name in commands.COMMANDS:
        commands.register(name, sub)
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
