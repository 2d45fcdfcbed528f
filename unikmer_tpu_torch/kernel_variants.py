"""K1, S1, C1 and probe-kernel design variants, built side by side and timed on one card.

    python -m unikmer_tpu_torch.kernel_variants [KERNEL ...]

Each variant is csrc/ with one design choice of a kernel undone by a text
substitution, or with one entry point taken from the kernel's earlier
design under csrc/earlier/ (the entry point as built renamed away).  Each
is linked with the other sources into a library of its own under
``build/unikmer_tpu_torch/variants/`` and bound as the real one is;
:func:`using` swaps it into ``_kernels``, so the wrappers of ``ops/``
launch it.  Every exact variant is held to the plain versions; then each
workload is timed in turns (CUDA events; the order reversed every other
round) and by torch.profiler (device ms a call, and the kernels a
row_cmpex_u32 call launches, from its ``.kernels`` count).  KERNEL picks
among K1, P1a, P1b, P1c, S1, C1 (default: all).  Prints ptxas's registers for
the sources as built, then one JSON line a workload; needs a CUDA device
and nvcc, and raises on any mismatch.  ``chip_smoke.py`` builds the
earlier designs through :func:`build`.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import _kernels

EARLIER_K1 = "K1 earlier design, one window a thread"
EARLIER_ROW_CMPEX = "P1b earlier design, one column a block"
EARLIER_S1 = "S1 earlier design, a window a thread scanned"

_LD_256 = (
    "__device__ __forceinline__ uint4 ld_nc_256(const uint4* p) {\n"
    "  uint4 v;\n"
    "  asm volatile(\"ld.global.nc.L1::no_allocate.L2::256B.v4.u32 "
    "{%0, %1, %2, %3}, [%4];\" : \"=r\"(v.x), \"=r\"(v.y), "
    "\"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
    "  return v;\n"
    "}\n\n")
_NO_K1_LOADS = (
    "  const int64_t first = span * kBlockWindows;\n  return t < kPackedVecs",
    "  return make_uint4(t, 0u, 0u, 0u);\n"
    "  const int64_t first = span * kBlockWindows;\n  return t < kPackedVecs")

# name: (kernel, source under csrc/, substitutions, earlier design under
# csrc/ linked in place of the source's entry point, or None; exact).  An
# inexact variant computes something else on purpose and is only timed.
VARIANTS = {
    EARLIER_K1: (
        "K1", "encode.cu",
        [("int ukt_encode_2bit(", "int ukt_encode_2bit_as_built(")],
        "earlier/encode_one_window_a_thread.cu", True),
    "K1 keys stored from registers": (
        "K1", "encode.cu",
        [("    s_keys[key_slot(t, s)] = make_uint4(",
          "    if (i0 + 2 * s + 1 < n) reinterpret_cast<uint4*>(keyed + i0)[s] "
          "= make_uint4("),
         ("for (int p = t; p < kKeyVecs; p += kThreads) {",
          "for (int p = t; p < 0; p += kThreads) {")], None, False),
    "K1 no global loads": ("K1", "encode.cu", [_NO_K1_LOADS], None, False),
    "K1 stores only (no loads, no roll)": (
        "K1", "encode.cu",
        [_NO_K1_LOADS,
         ("const uint64_t code = (canonical && rc < fwd) ? rc : fwd;",
          "const uint64_t code = i0 + j;")], None, False),
    "P1a default-cached loads and stores": (
        "P1a", "probes.cu",
        [("__ldcs(in4 + i)", "in4[i]"),
         ("__stcs(out4 + i, inc4(v[u]))", "out4[i] = inc4(v[u])")], None, True),
    "P1a streaming loads, default-cached stores": (
        "P1a", "probes.cu",
        [("__stcs(out4 + i, inc4(v[u]))", "out4[i] = inc4(v[u])")], None, True),
    "P1a default-cached loads, streaming stores": (
        "P1a", "probes.cu", [("__ldcs(in4 + i)", "in4[i]")], None, True),
    "P1a loads ld.global.nc.L1::no_allocate.L2::256B": (
        "P1a", "probes.cu",
        [("__ldcs(in4 + i)", "ld_nc_256(in4 + i)"),
         ("__device__ __forceinline__ uint4 inc4(uint4 v) {",
          _LD_256 + "__device__ __forceinline__ uint4 inc4(uint4 v) {")],
        None, True),
    "P1a 1 uint4 a thread": (
        "P1a", "probes.cu",
        [("constexpr int kIncVecs = 4;", "constexpr int kIncVecs = 1;")],
        None, True),
    "P1a 8 uint4 a thread": (
        "P1a", "probes.cu",
        [("constexpr int kIncVecs = 4;", "constexpr int kIncVecs = 8;")],
        None, True),
    EARLIER_ROW_CMPEX: (
        "P1b", "probes.cu",
        [("int ukt_row_cmpex_u32(", "int ukt_row_cmpex_u32_as_built(")],
        "earlier/row_cmpex_one_column_a_block.cu", True),
    "P1b tile one column a block": (
        "P1b", "probes.cu",
        [("const bool vec_tile = vec;", "const bool vec_tile = false;")],
        None, True),
    "P1b tile's phase-0 load an if/else": (
        "P1b", "probes.cu",
        [("        v[u] = ((present >> u) & 1)\n"
          "                   ? *reinterpret_cast<const T*>(\n"
          "                         in + row_of<PB>(gbase, gbit, u) * cols + col)\n"
          "                   : absent_row<T>();",
          "        if ((present >> u) & 1) {\n"
          "          v[u] = *reinterpret_cast<const T*>(\n"
          "              in + row_of<PB>(gbase, gbit, u) * cols + col);\n"
          "        } else {\n"
          "          absent(v[u]);\n"
          "        }")], None, True),
    "P1b no tile route (register runs only)": (
        "P1b", "probes.cu",
        [("constexpr int kTileBits = 14;", "constexpr int kTileBits = 4;"),
         ("constexpr int kVecTileBits = 12;", "constexpr int kVecTileBits = 4;"),
         ("static_assert(16 << kVecTileBits == kTileBytes", "static_assert(true")],
        None, True),
    "P1b every stage a pass": (
        "P1b", "probes.cu",
        [("if (d & (d - 1)) {  // the pass route", "if (true) {  // the pass route")],
        None, True),
    "P1b no unrolled sweep (a dispatch a run)": (
        "P1b", "probes.cu",
        [("  if (is_sweep) {\n    sweep<PB>(v);", "  if (false) {\n    sweep<PB>(v);")],
        None, True),
    "P1c whole tile a block": (
        "P1c", "probes.cu",
        [("constexpr int kSub = 64;", "constexpr int kSub = 128;")], None, True),
    EARLIER_S1: (
        "S1", "sketch.cu",
        [("int ukt_sketch_select(", "int ukt_sketch_select_as_built(")],
        "earlier/sketch_scan_a_window.cu", True),
    "S1 runs of at most 16 windows": (
        "S1", "sketch.cu",
        [("constexpr int kMaxRun = 8;", "constexpr int kMaxRun = 16;")],
        None, True),
    "S1 runs of at most 4 windows": (
        "S1", "sketch.cu",
        [("constexpr int kMaxRun = 8;", "constexpr int kMaxRun = 4;")],
        None, True),
    "S1 256 threads a block": (
        "S1", "sketch.cu",
        [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
        None, True),
    "S1 left suffix minima in shared memory": (
        "S1", "sketch.cu",
        [("struct Best {",
          "template <class T>\nstruct Column {  // part u of thread t at [u][t]\n"
          "  T (*a)[kThreads];\n  int t;\n"
          "  __device__ __forceinline__ T& operator[](int u) const {\n"
          "    return a[u][t];\n  }\n};\n\nstruct Best {"),
         ("  unsigned long long lk[R];\n  int lp[R];\n",
          "  __shared__ unsigned long long lk_s[R][kThreads];\n"
          "  __shared__ int lp_s[R][kThreads];\n"
          "  const Column<unsigned long long> lk{lk_s, t};\n"
          "  const Column<int> lp{lp_s, t};\n")], None, True),
    "S1 stage slots unpadded (bank conflicts)": (
        "S1", "sketch.cu",
        [("return R > 1 ? s + s / R : s;", "return s;")], None, True),
    "C1 the sentinel tail by a memset ahead": (
        "C1", "collapse.cu",
        [("  const int aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0;",
          "  err = cudaMemsetAsync(keys_out, 0xff, n * sizeof(u64), stream);\n"
          "  if (err != cudaSuccess) return static_cast<int>(err);\n"
          "  if (kAuxBytes != 0)\n"
          "    err = cudaMemsetAsync(aux_out, 0, n * kAuxBytes, stream);\n"
          "  if (err != cudaSuccess) return static_cast<int>(err);\n"
          "  const int aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0;"),
         ("  collapse_fill<kAuxBytes>\n      <<<",
          "  if (false) collapse_fill<kAuxBytes>\n      <<<")], None, True),
    "C1 8-byte loads": (
        "C1", "collapse.cu",
        [("const int aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0;",
          "const int aligned = 0;")], None, True),
}
TURNS = 20  # rounds of timings in turns
P2A_BIG_ROWS = 1 << 16  # P2a's 64 stages over 16 row bits


def _slug(name: str) -> str:
    return re.sub(r"\W+", "_", name).strip("_")


def build(names=None) -> dict[str, ctypes.CDLL]:
    """Each named variant (default: all) compiled, linked into a library
    of its own with the other sources and bound; one nvcc a source, all
    at once.  Returns name -> library."""
    names = list(VARIANTS if names is None else names)
    out = _kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS]
    built = {p.name: out / f"{p.stem}.o" for p in _kernels.CSRC.glob("*.cu")}
    compiles = [[*nvcc, "-c", "-o", str(o), str(_kernels.CSRC / s)]
                for s, o in built.items()]
    links = {}
    for name in names:
        _, source, subs, earlier, _ = VARIANTS[name]
        text = (_kernels.CSRC / source).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {source}")
            text = text.replace(old, new)
        stem = out / _slug(name)
        stem.with_suffix(".cu").write_text(text)
        objs = [stem.with_suffix(".o")]
        compiles.append([*nvcc, "-c", "-o", str(objs[0]), str(stem) + ".cu"])
        if earlier:
            objs.append(out / f"{_slug(name)}.earlier.o")
            compiles.append([*nvcc, "-c", "-o", str(objs[1]),
                             str(_kernels.CSRC / earlier)])
        objs += [o for s, o in built.items() if s != source]
        links[name] = [*nvcc, "-shared", "-o", str(stem) + ".so", *map(str, objs)]
    _kernels._run_all(compiles)
    _kernels._run_all(list(links.values()))
    libs = {}
    for name, cmd in links.items():
        lib = ctypes.CDLL(cmd[cmd.index("-o") + 1])
        _kernels._bind(lib)
        libs[name] = lib
    return libs


def using(lib: ctypes.CDLL, fn):
    """fn, run with the wrappers launching ``lib``'s entry points (the
    library in use before is restored after each call)."""
    def call(*args):
        before, _kernels._lib = _kernels._lib, lib
        try:
            return fn(*args)
        finally:
            _kernels._lib = before
    return call


def ptxas_report(sources=("encode.cu", "probes.cu", "sketch.cu",
                         "collapse.cu")) -> list[str]:
    """ptxas's registers line of every kernel of the sources as built."""
    out = _kernels.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
         "-o", str(out / f"ptxas.{s}.o"), str(_kernels.CSRC / s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s in sources]
    lines, name = [], None
    for proc in procs:
        for line in proc.communicate()[0].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            elif "registers" in line and name:
                lines.append(f"{name}: {line.split(':', 1)[1].strip()}")
    return lines


def quartiles(v) -> dict:
    """Median and spread (the distance between the quartiles) of v."""
    q1, q2, q3 = statistics.quantiles(v, n=4, method="inclusive")
    return {"median": q2, "spread": q3 - q1}


def turns_ms(fns: dict, rounds: int = TURNS, before=None) -> dict:
    """{name: quartiles} of the CUDA-event ms of every fn, timed in turns:
    each round runs them in order and then in reverse; ``before()`` runs
    ahead of each timing, outside the events."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name in [*fns, *reversed(fns)]:
            if before is not None:
                before()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[name]()
            t1.record()
            t1.synchronize()
            got[name].append(t0.elapsed_time(t1))
    return {name: quartiles(v) for name, v in got.items()}


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device ms a call of fn() in the CUDA kernels whose name holds
    ``kernel`` (torch.profiler); None when it records no device time."""
    return device_profile(fn, kernel, reps)[0]


def device_profile(fn, kernel: str, reps: int = 20):
    """(device_ms, the kernels the profiler recorded a call): a count
    below the launches shows a reading that lost events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel in e.key]
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0) for e in events)
    if not total_us:
        return None, None
    return total_us / reps / 1e3, sum(e.count for e in events) / reps


def kernels_per_call(fn, calls: int = 10) -> int:
    """The kernels one row_cmpex_u32 call of fn() launches, from the
    wrapper's ``.kernels`` count over ``calls`` calls."""
    from .ops.probes import row_cmpex_u32

    k0, l0 = row_cmpex_u32.kernels, row_cmpex_u32.launches
    for _ in range(calls):
        fn()
    kernels, launches = row_cmpex_u32.kernels - k0, row_cmpex_u32.launches - l0
    if launches != calls or kernels % calls:
        raise RuntimeError(f"{kernels} kernels in {launches} launching calls "
                           f"of {calls}")
    return kernels // calls


def _u32(rng, shape, dev) -> torch.Tensor:
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(dev)


class Workload(NamedTuple):
    name: str
    call: Callable  # call(wrapper) runs the workload through a wrapper
    wrapper: Callable
    plain: Callable
    kernel: str  # what the names of its CUDA kernels hold
    holds: list  # argument tuples an exact variant is held to the plain on
    skip: tuple = ()  # variants that cannot take it


def workloads(dev, rng) -> dict:
    """kernel -> its Workloads."""
    from . import probes as entry
    from .models.count import pack_bases_2bit
    from .ops import collapse, encode, nthash, probes, sketch

    x1, blk = entry.probe_inputs(dev)
    n = (1 << 25) + 3
    bases = rng.integers(0, 4, size=n, dtype=np.uint8)
    bases[rng.random(n) < 0.02] = 255
    p2, vm = (torch.from_numpy(a).to(dev) for a in pack_bases_2bit(bases))
    big = _u32(rng, (P2A_BIG_ROWS, 128), dev)
    kk, kv = nthash.encode_nthash(p2, vm, n, 31, True)
    sk, _ = nthash.encode_nthash(p2, vm, n, 16, True)
    mh = nthash.scaled_max_hash(15)
    s1 = {  # workload: (mode, the arguments after mode)
        "minimizer w=15 (-k 31 -W 15)": ("minimizer", (kk, 15, kv)),
        "syncmer s=16 (-k 31 -S 16)": ("syncmer", (sk, 16, kv, kk)),
        "argmin W=30 (compat -k 31 -S 16)": ("argmin", (sk, 30))}
    s1_holds = [  # (mode, keys, w, valid, khash, max_hash) at lengths m
        args for m in (1, 4099, 70001) for w in (1, 2, 15, 16, 30, 100)
        for args in (("minimizer", kk[:m], w, kv[:m], None, mh),
                     ("syncmer", sk[:m], w, kv[:m], kk[:m], mh),
                     ("argmin", sk[:m], w))]
    keys = np.sort(rng.integers(0, 1 << 46, size=n // 8, dtype=np.uint64)[
        rng.integers(0, n // 8, size=n)])
    keys[int(n * 0.6):] = np.uint64((1 << 64) - 1)  # union_all's padding
    ck = torch.from_numpy(keys.view(np.int64)).to(dev)
    cm = torch.rand(n, device=dev) < 0.5
    caux = _u32(rng, (n,), dev)

    def c1(keys, mode, threshold=1, mask=None, aux=None):
        return collapse.collapse_pass(keys, mode, threshold=threshold,
                                      mask=mask, aux=aux)

    def c1_plain(keys, mode, threshold=1, mask=None, aux=None):
        return collapse.collapse_plain(keys, mode, threshold=threshold,
                                       mask=mask, aux=aux)

    c1_work = {"distinct (union_all)": (ck, "distinct"),
               "threshold 58 (common)": (ck, "threshold", 58),
               "mask, int32 aux (a taxid intersect)": (ck, "mask", 1, cm,
                                                       caux)}
    c1_holds = [(ck[:m], mode, t, cm[:m] if mode == "mask" else None,
                 caux[:m]) for m in (1, 4097, 70001)
                for mode, t in (("distinct", 1), ("unique", 1),
                                ("repeated", 1), ("threshold", 3),
                                ("mask", 1))]
    rows = {"p1b": (blk, probes.p1b_distances(entry.ROWS)),
            **{f"p2a_{s}": (blk, probes.p2a_distances(s, entry.ROWS))
               for s in entry.P2A_STAGES},
            "p2a_64_2^16_rows": (big, probes.p2a_distances(64, P2A_BIG_ROWS))}
    return {
        "K1": [Workload(
            "n=2^25+3 k=23 canonical", lambda f: f(p2, vm, n, 23, True),
            encode.encode_2bit, encode.encode_2bit_plain, "encode_2bit",
            [(p2, vm, m, k, c) for m in (1, 4099, n) for k in (23, 32)
             for c in (False, True)])],
        "P1a": [Workload(
            "probe, L2 flushed", lambda f: f(x1), probes.copy_inc_u32,
            probes.copy_inc_u32_plain, "copy_inc",
            [(x1,), (_u32(rng, ((1 << 21) + 4,), dev)[1:],)])],
        "P1b": [Workload(
            w, lambda f, x=x, ds=ds: f(x, ds), probes.row_cmpex_u32,
            probes.row_cmpex_u32_plain, "row_cmpex", [(x, ds)],
            # the earlier design takes at most 40,960 rows
            (EARLIER_ROW_CMPEX,) if x.shape[0] > 40960 else ())
            for w, (x, ds) in rows.items()],
        "P1c": [Workload(
            "probe", lambda f: f(blk), probes.transpose128_u32,
            probes.transpose128_u32_plain, "transpose128",
            [(blk,), (_u32(rng, (3 * 128, 128), dev),)])],
        "S1": [Workload(
            f"n=2^25+3 {name}", lambda f, m=m, a=a: f(m, *a),
            sketch.sketch_select, sketch.sketch_select_plain, "sketch_select",
            s1_holds) for name, (m, a) in s1.items()],
        "C1": [Workload(
            f"n=2^25 {name}", lambda f, a=a: f(*a), c1, c1_plain, "collapse_",
            c1_holds) for name, a in c1_work.items()]}


def smi(when: str) -> None:
    """Print the card's name, power limit, clocks and power draw."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,"
         "power.draw", "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card {when}: {q.stdout.strip()}", flush=True)


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(map(torch.equal, a, b))
    return torch.equal(a, b)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    kernels = list(argv if argv is not None else sys.argv[1:]) or [
        "K1", "P1a", "P1b", "P1c", "S1", "C1"]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(20261016)
    _kernels.load()
    for line in ptxas_report():
        print(f"ptxas: {line}", flush=True)
    names = [n for n, v in VARIANTS.items() if v[0] in kernels]
    libs = build(names)
    flush = torch.empty((256 << 20) // 4, dtype=torch.int32, device=dev)
    work = workloads(dev, rng)
    smi("before")
    for kernel in kernels:
        mine = [n for n in names if VARIANTS[n][0] == kernel]
        for w in work[kernel]:
            runs = {"as built": w.wrapper,
                    **{n: using(libs[n], w.wrapper) for n in mine
                       if n not in w.skip}}
            for name, run in runs.items():
                if name == "as built" or VARIANTS[name][4]:
                    for args in w.holds:
                        if not _equal(run(*args), w.plain(*args)):
                            raise SystemExit(f"{name} differs on {w.name}")
            fns = {name: (lambda run=run: w.call(run))
                   for name, run in runs.items()}
            before = (lambda: flush.fill_(1)) if kernel == "P1a" else None
            t = turns_ms(fns, before=before)
            row = {"kernel": kernel, "workload": w.name}
            for name, fn in fns.items():
                dms, recorded = device_profile(fn, w.kernel)
                row[name] = dict(ms=t[name]["median"],
                                 ms_spread=t[name]["spread"], device_ms=dms,
                                 profiled_kernels_per_call=recorded)
                if kernel == "P1b":
                    row[name]["kernels_per_call"] = kernels_per_call(fn)
            print(json.dumps(row), flush=True)
    smi("after")
    return 0


if __name__ == "__main__":
    sys.exit(main())
