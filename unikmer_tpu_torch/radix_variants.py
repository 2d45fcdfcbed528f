"""K2/K3 design variants, built side by side and timed on one card.

    python -m unikmer_tpu_torch.radix_variants

Each variant is csrc/radix_sort.cu with one design choice of the onesweep
sort undone by a text substitution (``VARIANTS``).  Each is linked with
the other csrc sources into a library of its own under
``build/unikmer_tpu_torch/variants/`` and bound as the real one is.  Every
variant is held to the plain versions, then timed on 2^25 random keys
with 2% sentinels (and random u32 values) at code_bits 46 and 64: the
CUDA-event median ms of K2 and K3, and the device ms per call of each
kernel from torch.profiler.  ``torch.sort`` is timed on the same keys
first.  The first variant, the source as it is, is timed again last, to
show the drift within the call.  Prints ptxas's registers, shared memory
and spills for each kernel of the source as it is, then one JSON line per
variant; needs a CUDA device and nvcc, and raises on any mismatch.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import _kernels
from .ops import radix_sort
from .ops.codec import SIGN

_LOOKBACK_ORDER = [
    ("v, cuda::std::memory_order_relaxed",
     "v, cuda::std::memory_order_release"),
    ("load(\n      cuda::std::memory_order_relaxed",
     "load(\n      cuda::std::memory_order_acquire")]
_LATE_VALUES = [
    ("    if constexpr (kValues) val[r] = idx < n ? vals_in[idx] : 0u;\n", ""),
    ("if constexpr (kValues) stage_vals[slot] = val[r];",
     "if constexpr (kValues) "
     "stage_vals[slot] = vals_in[warp0 + 32 * r + lane];")]
VARIANTS = {
    "as_built": [],
    "release_acquire_lookback": _LOOKBACK_ORDER,
    "match_any_sync_ranks": [("= match_digit(d);",
                              "= __match_any_sync(0xffffffffu, d);")],
    "12_keys_a_thread": [("kItems = 16;", "kItems = 12;")],
    "24_keys_a_thread": [("kItems = 16;", "kItems = 24;")],
    "values_loaded_at_the_stage": _LATE_VALUES,
    "three_blocks_an_sm": [
        ("__launch_bounds__(kThreads)\nradix_onesweep_pass",
         "__launch_bounds__(kThreads, 3)\nradix_onesweep_pass")],
}
KERNELS = ("radix_upfront_hist", "radix_bases", "radix_onesweep_pass",
           "radix_copy", "Memset", "Memcpy")
N = 1 << 25


def build_variants() -> dict[str, str]:
    """Compile every variant into its own library; returns name -> path."""
    out = _kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels.find_nvcc()
    src = (_kernels.CSRC / "radix_sort.cu").read_text()
    others = [p for p in sorted(_kernels.CSRC.glob("*.cu"))
              if p.name != "radix_sort.cu"]
    objs = [out / f"{p.stem}.o" for p in others]
    compiles = [[nvcc, *_kernels.NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                for p, o in zip(others, objs)]
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        compiles.append([nvcc, *_kernels.NVCC_FLAGS, "-c", "-o",
                         str(out / f"{name}.o"), str(out / f"{name}.cu")])
    _kernels._run_all(compiles)
    _kernels._run_all([[nvcc, *_kernels.NVCC_FLAGS, "-shared", "-o",
                        str(out / f"{name}.so"), str(out / f"{name}.o"),
                        *map(str, objs)] for name in VARIANTS])
    return {name: str(out / f"{name}.so") for name in VARIANTS}


def ptxas_report() -> list[str]:
    """ptxas -v lines (kernel, registers, smem, spills) of radix_sort.cu."""
    out = _kernels.BUILD_DIR / "variants" / "ptxas.o"
    proc = subprocess.run(
        [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", str(out), str(_kernels.CSRC / "radix_sort.cu")],
        capture_output=True, text=True, check=True)
    return [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]


def event_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event milliseconds of fn() after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 10) -> dict[str, float]:
    """Device ms per call of fn() in each of KERNELS (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {k: sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0)
                   for e in events if k in e.key) / reps / 1e3
            for k in KERNELS}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("radix_variants: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    libs = build_variants()
    for line in ptxas_report():
        print(line, flush=True)
    cases = {}
    for bits in (46, 64):
        keys = rng.integers(0, 1 << bits, size=N, dtype=np.uint64)
        keys[rng.random(N) < 0.02] = np.uint64((1 << 64) - 1)
        vals = rng.integers(0, 1 << 31, size=N, dtype=np.uint32)
        k = torch.from_numpy(keys.view(np.int64)).to(dev)
        v = torch.from_numpy(vals.view(np.int32)).to(dev)
        flipped = k ^ SIGN
        cases[bits] = (k, v, radix_sort.sort_u64_plain(k),
                       radix_sort.sort_kv_plain(k, v))
        print(json.dumps({"code_bits": bits, "torch.sort_ms": event_ms(
            lambda: torch.sort(flipped)), "stable_torch.sort_ms": event_ms(
            lambda: torch.sort(flipped, stable=True))}), flush=True)
    for name in [*VARIANTS, next(iter(VARIANTS))]:
        lib = ctypes.CDLL(libs[name])
        _kernels._bind(lib)
        _kernels._lib = lib  # the wrappers launch this variant from here on
        row = {"variant": name}
        for bits, (k, v, want2, want3) in cases.items():
            got3 = radix_sort.radix_sort_kv_u64(k, v, bits)
            if not (torch.equal(radix_sort.radix_sort_u64(k, bits), want2)
                    and all(map(torch.equal, got3, want3))):
                raise SystemExit(f"variant {name} differs at code_bits {bits}")
            row[bits] = {
                "k2_ms": event_ms(lambda: radix_sort.radix_sort_u64(k, bits)),
                "k3_ms": event_ms(
                    lambda: radix_sort.radix_sort_kv_u64(k, v, bits)),
                "k2_device_ms": kernel_ms(
                    lambda: radix_sort.radix_sort_u64(k, bits)),
                "k3_device_ms": kernel_ms(
                    lambda: radix_sort.radix_sort_kv_u64(k, v, bits))}
        print(json.dumps(row), flush=True)
    _kernels._lib = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
