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

With UNIKMER_TPU_SERVER=<socket> a call goes to the resident server
(unikmer_tpu_torch/server.py) and runs locally when none answers.
UNIKMER_TPU_CPROFILE=<file> writes a host cProfile dump of the command,
UNIKMER_TPU_PROFILE=<dir> a torch.profiler Chrome trace (CPU and CUDA
activities) into the directory.
"""

from __future__ import annotations

import argparse
import lzma
import os
import sys
import zlib

from .. import REFERENCE_VERSION, __version__
from . import commands

_ALIASES = {"stats": "info", "uniqs": "map"}


def build_parser(only: str | None = None) -> argparse.ArgumentParser:
    """The CLI parser; with ``only``, just that subcommand registered.

    Some command modules reach torch, whose import costs seconds, so a
    call registers only its own command when argv[0] names one exactly.
    Help output, the command list and unknown-command errors come from
    the fully registered parser."""
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
    for name in commands.COMMANDS if only is None else [only]:
        commands.register(name, sub)
    return p


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and os.environ.get("UNIKMER_TPU_SERVER"):
        from .._client import try_server

        rc = try_server(argv)
        if rc is not None:
            return rc
    name = _ALIASES.get(argv[0], argv[0]) if argv else None
    parser = build_parser(only=name if name in commands.COMMANDS else None)
    args = parser.parse_args(argv)
    if not getattr(args, "command", None):
        parser.print_help()
        return 0
    try:
        return _run_profiled(args)
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
        if os.environ.get("UNIKMER_TPU_DEBUG"):
            raise
        from ..utils.log import init_logging, log

        init_logging(False)
        log.error(str(e))
        return 255


def _run_profiled(args) -> int:
    """Run the command, under cProfile when UNIKMER_TPU_CPROFILE names a
    file and under torch.profiler when UNIKMER_TPU_PROFILE names a
    directory (torch is imported only then)."""
    trace_dir = os.environ.get("UNIKMER_TPU_PROFILE")
    cprof = os.environ.get("UNIKMER_TPU_CPROFILE")
    if cprof:
        import cProfile

        host = cProfile.Profile()
        host.enable()
    if trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities)
        trace.start()
    try:
        return args.func(args) or 0
    finally:
        if trace_dir:
            trace.stop()
            os.makedirs(trace_dir, exist_ok=True)
            trace.export_chrome_trace(os.path.join(
                trace_dir, f"unikmer-tpu-torch.{os.getpid()}.trace.json"))
        if cprof:
            host.disable()
            host.dump_stats(cprof)


if __name__ == "__main__":
    sys.exit(main())
