"""The benchmark of unikmer_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port (``unikmer_tpu_torch``)
on a machine with a CUDA card.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also the device's
busy seconds and the traced window's length), ``breakdown`` with
``--trace 1``, and last ``checks``: each number the comparison with the
reference compared, beside its limit.  The same numbers close standard
error.  Exits non-zero, printing no result, without a card, or when the
process holds JAX or the JAX package after the window.

The kernel library and the host library are built at a checkout's first
run into ``build/unikmer_tpu_torch/`` inside it (the port's own fixed
place); the genomes' FASTA files go to a temporary directory under
``$TMPDIR`` and are removed at exit.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from portbench.cell import forbidden_modules, load_cell, run_cell
        import torch
        import unikmer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: cannot run here: {e}", file=sys.stderr)
        return 1
    cell = load_cell(ROOT, args.workload)[0]
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), ROOT, STARTED)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; no result",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
