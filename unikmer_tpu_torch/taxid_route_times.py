"""Fresh-process taxid ``union`` on the host engine and on the card, at a
few input sizes: the measurement behind UNIKMER_TPU_DEVICE_TAXID_MIN_MB,
the size from which ``union``'s ``auto`` takes the device route.

    python -m unikmer_tpu_torch.taxid_route_times [MB ...]

For each size (default 32 64 128 256 512 1024 MiB of input), two seeded sorted
taxid .unik files (k=23, canonical, uncompressed as ``-C`` writes them,
taxids from the nodes of tests/data/taxdump; the second file holds half
of the first's codes) that together take about that many bytes.  Their
``union -s -C`` runs in a fresh interpreter, as a user runs it, under
UNIKMER_TPU_DEVICE_TAXID=0 (the host engine, ops/sets.union) and =1 (the
card: K3 and the LCA rounds), in the order 0, 1, 1, 0.  The outputs must
be byte-equal and the device runs must launch K3.  Prints the card's
name and power limit, one JSON line per size (the input's bytes and
k-mers, the wall seconds of each run) and last the largest size at which
the host engine won both of its runs and the smallest from which the
card won both of its runs at every size.  Needs a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TAXDUMP = ROOT / "tests" / "data" / "taxdump"
SIZES_MB = (32, 64, 128, 256, 512, 1024)
BYTES_PER_CODE = 8.5  # a sorted 46-bit code's delta and its taxid, about
# runs the CLI, then reports the K3 launches the process made
FRESH = ("import sys\n"
         "from unikmer_tpu_torch.cli.main import main\n"
         "rc = main(sys.argv[1:])\n"
         "k3 = 0\n"
         "if 'torch' in sys.modules:\n"
         "    from unikmer_tpu_torch.ops.radix_sort import radix_sort_kv_u64\n"
         "    k3 = radix_sort_kv_u64.launches\n"
         "print('k3 launches:', k3, file=sys.stderr)\n"
         "sys.exit(rc)\n")


def write_pair(tmp: str, mb: float, rng) -> tuple:
    """Two sorted taxid .unik files of about ``mb`` MiB together;
    returns their paths and k-mer counts."""
    from .io import unik
    from .taxonomy.taxdump import load_taxonomy

    taxdb = load_taxonomy(str(TAXDUMP))
    known = np.flatnonzero(taxdb.depth >= 0)
    pool = known[known > 0].astype(np.uint32)
    n = max(int(mb * (1 << 20) / BYTES_PER_CODE / 1.95), 16)
    a = np.unique(rng.integers(0, 1 << 46, size=n, dtype=np.uint64))
    b = np.unique(np.concatenate([
        a[rng.integers(0, len(a), size=len(a) // 2)],
        rng.integers(0, 1 << 46, size=len(a) // 2, dtype=np.uint64)]))
    flag = unik.SORTED | unik.CANONICAL | unik.INCLUDE_TAXID
    paths = []
    for name, codes in (("a", a), ("b", b)):
        path = os.path.join(tmp, f"{name}.unik")
        with open(path, "wb") as fh, unik.UnikWriter(
                fh, k=23, flag=flag, number=len(codes), compress=False,
                threads=min(os.cpu_count() or 4, 8)) as w:
            w.write_codes(codes, rng.choice(pool, len(codes)))
        paths.append(path)
    return paths, len(a) + len(b)


def union_run(paths, out: str, knob: str) -> tuple:
    """(wall seconds, K3 launches) of one fresh ``union -s -C``."""
    env = dict(os.environ, UNIKMER_TPU_DEVICE_TAXID=knob)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, "union", "-s", "-C", "--data-dir",
         str(TAXDUMP), *paths, "-o", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=1200)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"union under UNIKMER_TPU_DEVICE_TAXID={knob} "
                         f"exited {proc.returncode}: {proc.stderr[-2000:]}")
    k3 = int(proc.stderr.strip().splitlines()[-1].split()[-1])
    return secs, k3


def route_times(sizes_mb, tmp: str, seed: int = 17, on_card: bool = True):
    """Yields one row per size: input bytes and k-mers, the seconds of
    the runs (0, 1, 1, 0), and whether the host engine won both of its
    runs.  ``on_card`` holds the device runs to a K3 launch (the CPU's
    plain versions count none)."""
    rng = np.random.default_rng(seed)
    for mb in sizes_mb:
        d = tempfile.mkdtemp(dir=tmp)
        paths, kmers = write_pair(d, mb, rng)
        secs = {"0": [], "1": []}
        digests = set()
        for i, knob in enumerate(("0", "1", "1", "0")):
            out = os.path.join(d, f"u{i}")
            s, k3 = union_run(paths, out, knob)
            if (k3 > 0) != (knob == "1" and on_card):
                raise SystemExit(f"union at {mb} MB under "
                                 f"UNIKMER_TPU_DEVICE_TAXID={knob}: "
                                 f"{k3} K3 launches")
            with open(out + ".unik", "rb") as f:
                digests.add(hashlib.file_digest(f, "sha256").hexdigest())
            os.remove(out + ".unik")
            secs[knob].append(s)
        if len(digests) != 1:
            raise SystemExit(f"union at {mb} MB: the routes' bytes differ")
        row = {"mb": mb, "input_bytes": sum(map(os.path.getsize, paths)),
               "kmers": kmers, "host_s": secs["0"], "device_s": secs["1"],
               "host_wins": max(secs["0"]) < min(secs["1"]),
               "device_wins": max(secs["1"]) < min(secs["0"])}
        shutil.rmtree(d)
        yield row


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("taxid_route_times needs a CUDA device")
    sizes = [float(a) for a in (argv or sys.argv[1:])] or list(SIZES_MB)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    from . import _kernels, native

    _kernels.load()  # built once here, so no timed process pays nvcc
    native.get_lib()  # likewise g++
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for row in route_times(sizes, tmp):
            row["card"] = card
            rows.append(row)
            print(json.dumps(row), flush=True)
    wins = [r["mb"] for r in rows if r["host_wins"]]
    since = None  # the smallest size from which the card always won
    for r in reversed(rows):
        if not r["device_wins"]:
            break
        since = r["mb"]
    print(json.dumps({"largest_host_win_mb": max(wins) if wins else None,
                      "device_wins_from_mb": since}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
