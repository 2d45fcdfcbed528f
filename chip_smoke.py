"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 encode, H1 ntHash encode, S1 sketch
window select, K2 radix sort, K3 key+value radix sort, and the four P1/P2
probe kernels) from unikmer_tpu_torch/csrc, holds each against its plain
PyTorch version on the card (exact equality), then drives the port's
paths (count and the set operations) and holds their results against
oracles:

  count     ``count -k 23 -K -s -C`` over a 134 Mbp FASTA of 4 records,
            and over the same FASTA bench.py's two ntHash configurations,
            ``count -k 31 -K -H -s -C`` and ``count -k 31 -K -D 15 -s -C``,
            and its two sketch configurations, ``count -k 31 -W 15 -s -C``
            and ``count -k 31 -S 16 -s -C`` (and -u, -d, k = 32 and
            k = 64 -H -u over one 37.7 Mbp record, 2 pieces);
  count -T  over a synthetic 100,000-node taxonomy written as nodes.dmp:
            T1, 8,192 records of 4,000 bases, each with its own taxid,
            one piece of ~2^25 windows on the 'paths' LCA tier, 2-bit,
            hashed (T1H, k = 31 -H) and sketched (T1W, k = 31 -W 15);
            T2, 1,024 records of 49,152 bases with 512 taxids, streamed
            in pieces on the 'table' tier; T3, k = 32 -u over two 1 Mbp records, keeping a real
            2^64-1 code with its taxid;
  count -l  ``count -k 27 -K -l -H -C`` and ``count -k 23 -W 5 -l -C``
            over two 1 Mbp records;
  compat    ``count -k 31 -S 16 --syncmer-impl compat -s -C`` over 1,200
            records of 1 to 7,000 bases;
  sets      ``KmerSet.from_fasta(k=23, canonical=True)`` of the 134 Mbp
            FASTA (4 pieces merged by union_all) and of three seeded
            2^25-base records A, B and C that share large parts; then
            ``A | B``, ``A & B``, ``A - B``, ``union_all``, ``common``
            (2 of 3), ``contains`` and ``DeviceMembership`` over 2^24
            queries, ``head``, ``sample`` and ``filter_low_complexity``;
            the taxid set operations of A and B with per-code taxids of
            the -T path's tree (the tree-walk union, the one-sided union
            of A with taxids and B without, the intersection, the
            one-sided intersection, the difference); and the CLI's
            ``union`` (table and paths tiers), ``inter``, ``diff`` and
            ``common -n 2`` over ``count -t`` outputs of A, B and C.
            Admission: the free bytes, each route's bytes a slot and the
            element budgets are printed; under them every operation
            above keeps its device route (its launches say so); with
            UNIKMER_TPU_MAX_ELEMS below their size, ``from_fasta`` of
            the 134 Mbp FASTA (no union_all K2) and the CLI ``union``
            (no K3, the host engine) take the host route and are exact.
            Then ``grep -F q.unik`` over A's ``count -t`` output with
            UNIKMER_TPU_GREP_DEVICE at 1 (DeviceMembership) and at 0,
            q.unik holding 2^22 codes of known membership, half of them
            A's; and ``view`` -> ``dump`` over a 2^20-code 2-bit and a
            2^20-code hashed file (the native text functions against
            numpy and the original bytes).
            Every result and every saved ``.unik`` is held exactly to
            numpy (one stable sort merges the sorted sets with a bit a
            set, ``merge_sets``, from which union, intersection,
            difference and the codes held by 2 of 3 are read; queries of
            known membership; the LCA by the port's host Taxonomy), and
            each operation is timed (CUDA events, 5 runs) beside the
            host engine (ops/sets, native and numpy) in the ``sets`` line;
  probes    ``python -m unikmer_tpu_torch.probes``: P1a-P2b at the sizes
            of scripts/exp_pallas_dma*.py, each kernel held to its plain
            version inside the entry point.

The launch counters, zeroed before each path's run (and before each set
operation) and read after it, show that the run went through the kernels
of its path (and that a hashed run launched H1 and no K1; that ``|``
(the one-sided taxid union too), ``union_all`` and ``common`` launched
K2 once, ``&``, ``-`` and the per-set transforms no sort,
and the CLI's taxid union K3 and no host reduction).  P1a and P1c are timed in turns with
their library calls (library, kernel, kernel, library; TURNS rounds), S1
with torch.argmin over an unfold view of its keys (``unfold_argmin``); K1
and P1b/P2a in turns with their earlier designs (csrc/earlier/, built by
unikmer_tpu_torch/kernel_variants.py, which times the other design
variants on its own), H1 with K1 at the same k.  The host cost of the
launch path is read as host microseconds per wrapper call over
HOST_CALLS un-synchronised calls: for P1c's call step by step as the
path stood before the launch helper of _kernels.py
(``launch_breakdown``), and for every wrapper (``host_us`` in the
kernels line).

The count oracle is this script's own numpy count (every window's 2-bit
code, the canonical form written out below, a sort and its distinct
values, ``unique_counts``; for hashed runs every window's ntHash v1
from its definition, ``nthash_keyed_oracle``, and the
scaled threshold of ``scaled_max_hash_oracle``; for sketches the
leftmost window minimum by np.argmin over a sliding window view and the
emit rules as defined, per record for compat) over the bases packed by
the port's host layer; for -T the record ids come from a searchsorted
over the record starts and the taxids merge through the port's
Taxonomy.lca_reduce.  Its result goes through the port's UnikWriter
with the same flags.  The oracle runs those host layers on their numpy
branches (UNIKMER_TPU_NO_NATIVE=1), so the CLI's native host library is
held to them here; the CPU tests hold the numpy branches to the JAX
package.  Nothing of the port's device code enters the oracle.  The
script imports nothing of unikmer_tpu or jax.

Exits non-zero, printing no result, without a CUDA device or outside
the repository.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
K1_KS = (1, 5, 23, 31, 32)
K1_NS = (0, 1, 7, 4099, (1 << 25) + 3)
H1_KS = (1, 2, 31, 32, 33, 63, 64)
# ntHash v1 seeds (will-rowe/nthash) by base A, C, G, T, then any other byte
NT_SEEDS = np.array([0x3C8BFBB395C60474, 0x3193C18562A02B4C,
                     0x20323ED082572324, 0x295549F54BE24456, 0], np.uint64)
NT_SEEDS_RC = NT_SEEDS[[3, 2, 1, 0, 4]]  # of the complement base
K2_NS = (0, 1, 1000, (1 << 20) + 3, 1 << 25)
K3_NS = K2_NS
K3_BITS = (2, 46, 64)
VALID_BIT = 1 << 30  # the collapse payload's valid bit (taxonomy/lca.py)
SENT = np.uint64((1 << 64) - 1)
TAX_NODES = 100_000
TAX_CHAIN = 40  # grafted chain: the deepest closure paths
RE_TAXID = r"taxid\|(\d+)"
T1_RECORDS, T1_BASES = 8192, 4000  # one taxid each: the paths tier
T2_TAXIDS, T2_BASES = 512, 49152  # two records each: the table tier
T3_BASES = 1 << 20
RECORD_BASES = 1 << 25
SETS_BASES = 1 << 25  # each of the sets path's records A, B and C
LINEAR_BASES = 1 << 20  # the -l -H and -l -W runs' two records
SKETCH_K, SKETCH_W, SKETCH_S = 31, 15, 16  # bench.py's sketch cells
COMPAT_RECORDS, COMPAT_MAX_BASES = 1200, 7000  # the compat run's input
LINE = 60
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
FLUSH_BYTES = 256 << 20  # written between P1a's repetitions: > the 50 MB L2
HOST_CALLS = 1000  # un-synchronised wrapper calls in one host-cost reading
TURNS = 20  # rounds of kernel-and-library timings in turns
P1C_BIG_TILES = 65537  # more tiles than a grid's z extent holds
P2A_BIG_ROWS = 1 << 16  # P2A's 64 stages over 16 row bits: tile and registers


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 5, before=None) -> float:
    """Median CUDA-event milliseconds of fn() over reps, after a warm-up;
    ``before()`` runs ahead of each repetition, outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def ms_spread(fn, rounds: int = 5) -> dict:
    """CUDA-event ms of fn() as the kernels-line keys ms (the median of
    2 * rounds timings) and ms_spread (the distance between quartiles)."""
    t = turns_ms({"kernel": fn}, rounds)["kernel"]
    return dict(ms=t["median"], ms_spread=t["spread"])


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device milliseconds per call of fn() spent in the CUDA kernels
    whose name holds ``kernel``, from torch.profiler: the kernel's own
    time, without the host's launch overhead that the CUDA events around
    a short call also hold.  A reading may record fewer such kernels than
    the calls launched (lost events): it is taken as the mean of the
    kernels it recorded times the whole number of them a call.  None when
    the profiler records no device time."""
    from unikmer_tpu_torch.kernel_variants import device_profile

    ms, per_call = device_profile(fn, kernel, reps)
    if ms is None:
        return None
    return ms * max(round(per_call), 1) / per_call


def bytes_ms(nbytes: float) -> float:
    """The least milliseconds to move ``nbytes`` at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| over u64 bit patterns (0.0 when equal)."""
    if torch.equal(a, b):
        return 0.0
    x = a.cpu().numpy().view(np.uint64)
    y = b.cpu().numpy().view(np.uint64)
    bad = np.flatnonzero(x != y)[:100000]
    return float(max(abs(int(x[i]) - int(y[i])) for i in bad))


def random_bases(rng, n: int, p_invalid: float = 0.02) -> np.ndarray:
    b = rng.integers(0, 4, size=n, dtype=np.uint8)
    b[rng.random(n) < p_invalid] = 255
    return b


# ---------------------------------------------------------------------------
# K1 / K2 against their plain versions


def cu_const(source: str, name: str) -> int:
    """An int constant of a csrc/ source, as the kernel is built."""
    from unikmer_tpu_torch import _kernels

    text = (_kernels.CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def k1_lengths() -> tuple:
    """K1's lengths: K1_NS and, at a thread's windows (kW) and a block's
    (kThreads * kW), each minus and plus one."""
    w = cu_const("encode.cu", "kW")
    block = w * cu_const("encode.cu", "kThreads")
    return tuple(sorted({*K1_NS, w - 1, w, w + 1, block - 1, block,
                         block + 1, 2 * block + 1}))


def check_k1(dev, rng, first):
    """K1 held to its plain version (and ``first``, the earlier design) at
    every length of k1_lengths, then timed in turns with it."""
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops.encode import encode_2bit, encode_2bit_plain

    def upload(bases):
        p2, vm = pack_bases_2bit(bases)
        return (torch.from_numpy(p2).to(dev), torch.from_numpy(vm).to(dev))

    ns = k1_lengths()
    big = random_bases(rng, max(ns))
    err, cases = 0.0, 0
    for n in ns:
        p2, vm = upload(big[:n])
        for k in K1_KS:
            for canonical in (False, True):
                pk, pv = encode_2bit_plain(p2, vm, n, k, canonical)
                for which, fn in (("kernel", encode_2bit),
                                  ("earlier design", first)):
                    kk, kv = fn(p2, vm, n, k, canonical)
                    torch.cuda.synchronize()
                    e = abs_err(kk, pk)
                    err = max(err, e)
                    cases += 1
                    if e or not torch.equal(kv, pv):
                        raise SystemExit(f"K1 ({which}) mismatch: n={n} k={k} "
                                         f"canonical={canonical} err={e}")
    # poly-T: the k=32 non-canonical code of TTTT... is 2^64-1
    poly = np.full(4099, 3, np.uint8)
    poly[[100, 2000]] = 255
    p2, vm = upload(poly)
    kk, kv = encode_2bit(p2, vm, len(poly), 32, False)
    pk, pv = encode_2bit_plain(p2, vm, len(poly), 32, False)
    n_real_sent = int(((kk == -1) & kv.bool()).sum())
    if not (torch.equal(kk, pk) and torch.equal(kv, pv)) or n_real_sent == 0:
        raise SystemExit(f"K1 poly-T mismatch (real 2^64-1 codes: {n_real_sent})")
    n = (1 << 25) + 3
    p2, vm = upload(big[:n])
    fns = {"kernel": lambda: encode_2bit(p2, vm, n, 23, True),
           "kernel, not canonical": lambda: encode_2bit(p2, vm, n, 23, False),
           "earlier design": lambda: first(p2, vm, n, 23, True)}
    t = turns_ms(fns)
    plain_ms = cuda_ms(lambda: encode_2bit_plain(p2, vm, n, 23, True))
    # packed bases and mask read once, the u64 codes and bool flags written
    bound = bytes_ms(p2.numel() + vm.numel() + 9 * n)
    dms = {name: device_ms(fn, "encode_2bit") for name, fn in fns.items()}
    say(f"K1 encode_2bit: exact on {cases + 1} cases (n in {ns}, the "
        f"earlier design beside it); n={n} k=23 canonical, in turns: "
        + "; ".join(
            f"{name} {t[name]['median']} ms (spread {t[name]['spread']}, "
            f"device {dms[name]})" for name in fns)
        + f"; plain {plain_ms} ms, bound {bound} ms")
    return dict(max_abs_err=err, ms=t["kernel"]["median"],
                ms_spread=t["kernel"]["spread"], device_ms=dms["kernel"],
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None, lengths_held=list(ns),
                variants={name: dict(ms=t[name]["median"],
                                     ms_spread=t[name]["spread"],
                                     device_ms=dms[name])
                          for name in fns if name != "kernel"})


def h1_lengths() -> tuple:
    """H1's lengths: K1_NS and, at a thread's windows (kW) and at one and
    two blocks' (kThreads * kW), each minus and plus one."""
    w = cu_const("nthash.cu", "kW")
    block = w * cu_const("nthash.cu", "kThreads")
    return tuple(sorted({*K1_NS, w - 1, w, w + 1, block - 1, block + 1,
                         2 * block - 1, 2 * block + 1}))


def check_h1(dev, rng):
    """H1 held exactly to its plain version at every k of H1_KS, canonical
    and not, scale 1 and 15, at every length of h1_lengths; then timed at
    n = 2^25+3, k = 31, canonical, in turns with K1 at the same k."""
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.nthash import (
        encode_nthash, encode_nthash_plain, scaled_max_hash,
    )

    ns = h1_lengths()
    big = random_bases(rng, max(ns))
    big[1000:1100] = 255  # an N run
    err, cases, kept = 0.0, 0, 0
    for n in ns:
        p2, vm = (torch.from_numpy(a).to(dev) for a in pack_bases_2bit(big[:n]))
        for k in H1_KS:
            for canonical in (False, True):
                for scale in (1, 15):
                    mh = scaled_max_hash(scale)
                    pk, pv = encode_nthash_plain(p2, vm, n, k, canonical, mh)
                    kk, kv = encode_nthash(p2, vm, n, k, canonical, mh)
                    torch.cuda.synchronize()
                    e = abs_err(kk, pk)
                    err = max(err, e)
                    cases += 1
                    kept += int(pv.sum())
                    if e or not torch.equal(kv, pv):
                        raise SystemExit(f"H1 mismatch: n={n} k={k} canonical="
                                         f"{canonical} scale={scale} err={e}")
    n = (1 << 25) + 3
    p2, vm = (torch.from_numpy(a).to(dev) for a in pack_bases_2bit(big[:n]))
    fns = {"kernel": lambda: encode_nthash(p2, vm, n, 31, True),
           "kernel, scale 15": lambda: encode_nthash(p2, vm, n, 31, True,
                                                     scaled_max_hash(15)),
           "K1 encode_2bit at k=31": lambda: encode_2bit(p2, vm, n, 31, True)}
    t = turns_ms(fns)
    plain_ms = cuda_ms(lambda: encode_nthash_plain(p2, vm, n, 31, True))
    # packed bases and mask read once, the u64 keys and u8 flags written
    bound = bytes_ms(p2.numel() + vm.numel() + 9 * n)
    dms = {name: device_ms(fn, "encode_2bit" if name.startswith("K1")
                           else "encode_nthash")
           for name, fn in fns.items()}
    share = f"{bound / dms['kernel']:.1%}" if dms["kernel"] else "not measured"
    say(f"H1 encode_nthash: exact on {cases} cases ({kept} kept windows; "
        f"k in {H1_KS}, canonical and not, scale 1 and 15, n in {ns}); "
        f"n={n} k=31 canonical, in turns: " + "; ".join(
            f"{name} {t[name]['median']} ms (spread {t[name]['spread']}, "
            f"device {dms[name]})" for name in fns)
        + f"; plain {plain_ms} ms, bound {bound} ms ({share} of the kernel's "
        f"device ms)")
    return dict(max_abs_err=err, ms=t["kernel"]["median"],
                ms_spread=t["kernel"]["spread"], device_ms=dms["kernel"],
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None, lengths_held=list(ns), ks_held=list(H1_KS),
                variants={name: dict(ms=t[name]["median"],
                                     ms_spread=t[name]["spread"],
                                     device_ms=dms[name])
                          for name in fns if name != "kernel"})


def s1_lengths() -> tuple:
    """S1's lengths: K1_NS and, for the runs of the timed widths (a run is
    the largest power of two at most min(w, kMaxRun) windows), a run's and
    one, two and three blocks' windows (kThreads runs each), each minus
    and plus one."""
    threads = cu_const("sketch.cu", "kThreads")
    most = cu_const("sketch.cu", "kMaxRun")
    ns = set(K1_NS)
    for w in (SKETCH_W, SKETCH_K - SKETCH_S + 1, 2 * (SKETCH_K - SKETCH_S)):
        run = 1 << (min(w, most).bit_length() - 1)
        tile = threads * run
        ns |= {run - 1, run, run + 1, tile - 1, tile, tile + 1, 2 * tile - 1,
               2 * tile + 1, 3 * tile + 1}
    return tuple(sorted(ns))


def unfold_argmin(keys: torch.Tensor, w: int) -> torch.Tensor:
    """The library yardstick of S1's argmin mode, one torch.argmin: the
    keys flipped to signed order (XOR 1 << 63), w - 1 pads of the flipped
    2^64-1, windows as an unfold(0, w, 1) view, the first minimum of each,
    its offset made a position."""
    flipped = keys ^ torch.iinfo(torch.int64).min
    pad = flipped.new_full((w - 1,), torch.iinfo(torch.int64).max)
    offset = torch.cat([flipped, pad]).unfold(0, w, 1).argmin(dim=1)
    return offset + torch.arange(keys.shape[0], device=keys.device)


def s1_cases(kk, kv, sk, w, mh):
    """(mode, args, kwargs) of each S1 mode at window width w over H1's
    k-mer (kk, kv) and s-mer (sk) outputs: scale 1 and max_hash mh."""
    return [("minimizer", (kk, w, kv), {}),
            ("minimizer", (kk, w, kv), {"max_hash": mh}),
            ("syncmer", (sk, w, kv, kk), {}),
            ("syncmer", (sk, w, kv, kk), {"max_hash": mh}),
            ("argmin", (sk, w), {})]


def check_s1(dev, rng):
    """S1 held exactly to its plain version in its three modes over H1's
    outputs (k = 31, s = 16) at every length of s1_lengths: w = 15, 16
    and 30 (the bench cells' minimizer and syncmer widths and the compat
    vote window) everywhere, and w = 1, 2, a block's tile + 300 and 5,000
    (past the shared stage) below 2^25; then each mode timed at n =
    2^25+3."""
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops.nthash import encode_nthash, scaled_max_hash
    from unikmer_tpu_torch.ops.sketch import sketch_select, sketch_select_plain

    ns = s1_lengths()
    tile = cu_const("sketch.cu", "kThreads") * cu_const("sketch.cu", "kMaxRun")
    big = random_bases(rng, max(ns))
    big[1000:1100] = 255  # an N run
    big[3000:3400] = 0  # poly-A: equal hashes, the leftmost rule decides
    big[20000:22000] = big[10000:12000]  # a repeat
    mh = scaled_max_hash(15)
    err, cases, kept = 0.0, 0, 0
    for n in ns:
        p2, vm = (torch.from_numpy(a).to(dev) for a in pack_bases_2bit(big[:n]))
        kk, kv = encode_nthash(p2, vm, n, SKETCH_K, True)
        sk, _ = encode_nthash(p2, vm, n, SKETCH_S, True)
        ws = (15, 16, 30) + (() if n == ns[-1] else (1, 2, tile + 300, 5000))
        for w in ws:
            for mode, args, kw in s1_cases(kk, kv, sk, w, mh):
                got = sketch_select(mode, *args, **kw)
                want = sketch_select_plain(mode, *args, **kw)
                torch.cuda.synchronize()
                if mode == "argmin":
                    e, same_flags = abs_err(got, want), True
                else:
                    e = abs_err(got[0], want[0])
                    same_flags = torch.equal(got[1], want[1])
                    kept += int(want[1].sum())
                err = max(err, e)
                cases += 1
                if e or not same_flags:
                    raise SystemExit(f"S1 mismatch: mode={mode} n={n} w={w} "
                                     f"{kw} err={e}")
    n = max(ns)  # 2^25+3
    p2, vm = (torch.from_numpy(a).to(dev) for a in pack_bases_2bit(big[:n]))
    kk, kv = encode_nthash(p2, vm, n, SKETCH_K, True)
    sk, _ = encode_nthash(p2, vm, n, SKETCH_S, True)
    ws = SKETCH_K - SKETCH_S + 1
    calls = {  # name: (mode, args, bytes read and written once a window)
        "kernel": ("minimizer", (kk, SKETCH_W, kv), 8 + 1 + 8 + 1),
        f"syncmer s={SKETCH_S}": ("syncmer", (sk, ws, kv, kk), 8 + 1 + 8 + 9),
        f"argmin W={2 * (SKETCH_K - SKETCH_S)}": (
            "argmin", (sk, 2 * (SKETCH_K - SKETCH_S)), 8 + 8)}
    # the yardstick: one torch.argmin over an unfold view, first held to the
    # plain version at every timed width
    for mode, args, _ in calls.values():
        lib = unfold_argmin(args[0], args[1])
        if not torch.equal(lib, sketch_select_plain("argmin", *args[:2])):
            raise SystemExit(f"unfold argmin differs from the plain S1 argmin "
                             f"at w={args[1]}")
    fns = {name: (lambda m=m, a=a: sketch_select(m, *a))
           for name, (m, a, _) in calls.items()}
    libs = {f"library {name}": (lambda a=a: unfold_argmin(a[0], a[1]))
            for name, (_, a, _) in calls.items()}
    t = turns_ms({**fns, **libs})
    res = {}
    for name, (mode, args, nbytes) in calls.items():
        res[name] = dict(
            ms=t[name]["median"], ms_spread=t[name]["spread"],
            device_ms=device_ms(fns[name], "sketch_select"),
            plain_ms=cuda_ms(lambda: sketch_select_plain(mode, *args)),
            bound_ms=bytes_ms(nbytes * n),
            # the minimizer's and syncmer's emit rules have no single call:
            # theirs is the argmin part's alone
            **{"library_ms" if mode == "argmin" else "argmin_library_ms":
               t[f"library {name}"]["median"]})
    say(f"S1 sketch_select: exact on {cases} cases ({kept} kept windows; "
        f"minimizer, syncmer and argmin modes, scale 1 and 15, n in {ns}); "
        f"n={n}, k={SKETCH_K}, in turns: " + "; ".join(
            f"{name} {r['ms']} ms (spread {r['ms_spread']}, device "
            f"{r['device_ms']}), plain {r['plain_ms']} ms, bound "
            f"{r['bound_ms']} ms, unfold argmin (flip, pad and offset inside) "
            f"{t[f'library {name}']['median']} ms" for name, r in res.items()))
    main = res.pop("kernel")
    return dict(max_abs_err=err, **main, bound_by="bytes", library_ms=None,
                lengths_held=list(ns), variants=res)


def adversarial_keys(rng, n: int, bits: int):
    """All-equal, sorted, reverse-sorted and one-hot keys below 2^bits (one
    bit set each: digit 0 dominates every pass, one long look-back
    chain), with sentinels in the sorted ones."""
    keys = rng.integers(0, 1 << min(bits, 64), size=n, dtype=np.uint64)
    keys[rng.random(n) < 0.02] = SENT
    one_hot = np.uint64(1) << rng.integers(0, bits, size=n).astype(np.uint64)
    return [np.full(n, keys[0] if n else 0, np.uint64), np.sort(keys),
            np.sort(keys)[::-1].copy(), one_hot]


def k2_inputs(rng, n: int):
    """(keys int64, code_bits) cases for one length."""
    full = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    full[: min(n, 5)] = np.array(
        [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)[: min(n, 5)]
    rng.shuffle(full)
    two_bit = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
    two_bit[rng.random(n) < 0.02] = np.uint64((1 << 64) - 1)
    dups = rng.integers(0, 7, size=n, dtype=np.uint64) << np.uint64(45)
    k1 = rng.integers(0, 4, size=n, dtype=np.uint64)
    k1[rng.random(n) < 0.1] = np.uint64((1 << 64) - 1)
    k32 = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    k32[rng.random(n) < 0.02] = np.uint64((1 << 64) - 1)
    return [(full, 64), (two_bit, 46), (dups, 48), (dups, 64), (k1, 2),
            (k32, 64)]


def check_k2(dev, rng):
    from unikmer_tpu_torch.ops.codec import SIGN
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_shifts, radix_sort_u64, sort_u64_plain,
    )

    err, cases = 0.0, 0
    for n in K2_NS + tile_edges():
        cases_n = k2_inputs(rng, n)
        if n in tile_edges() or n == K2_NS[-2]:
            cases_n += [(a, b) for b in (2, 46, 64)
                        for a in adversarial_keys(rng, n, b)]
        for keys, bits in cases_n:
            x = torch.from_numpy(keys.view(np.int64)).to(dev)
            got = radix_sort_u64(x, bits)
            want = sort_u64_plain(x)
            torch.cuda.synchronize()
            e = abs_err(got, want)
            err = max(err, e)
            cases += 1
            if e or (n > 1 and got.data_ptr() == x.data_ptr()):
                raise SystemExit(f"K2 mismatch: n={n} code_bits={bits} err={e}")
    big = k2_inputs(rng, 1 << 25)
    times, radix_bound = {}, {}
    for keys, bits in (big[1], big[0]):  # code_bits 46, then 64
        x = torch.from_numpy(keys.view(np.int64)).to(dev)
        flipped = x ^ SIGN  # unsigned order as signed: one torch.sort call
        passes = len(radix_shifts(bits))
        times[bits] = dict(
            **ms_spread(lambda: radix_sort_u64(x, bits)),
            plain_ms=cuda_ms(lambda: sort_u64_plain(x)),
            library_ms=cuda_ms(lambda: torch.sort(flipped)),
            # the keys read once and the sorted keys written once
            bound_ms=bytes_ms(16 * x.numel()),
            **sort_device_ms(lambda: radix_sort_u64(x, bits), radix_sort_u64))
        # an 8-bit LSD radix sort's own bound: one histogram read, then
        # each pass reads and writes the keys
        radix_bound[bits] = bytes_ms((1 + 2 * passes) * 8 * x.numel())
    say(f"K2 radix_sort_u64: exact on {cases} cases; n=2^25 " + "; ".join(
        f"code_bits={b}: kernel {t['ms']} ms (spread {t['ms_spread']}), "
        f"plain {t['plain_ms']} ms, torch.sort {t['library_ms']} ms, bound {t['bound_ms']} ms, "
        f"{len(radix_shifts(b))}-pass radix bound {radix_bound[b]} ms "
        f"({radix_bound[b] / t['ms']:.1%} of it); " + sort_detail(t)
        for b, t in times.items()))
    return sort_result(err, times)


def tile_edges() -> tuple:
    """Lengths at the onesweep tile's edges: tile - 1, tile + 1, 3 tiles."""
    from unikmer_tpu_torch import _kernels

    tile = _kernels.load().ukt_radix_tile()
    return (tile - 1, tile + 1, 3 * tile)


def sort_device_ms(fn, wrapper) -> dict:
    """Device ms of one sort call by kernel (torch.profiler): the upfront
    histogram, the bases/flags kernel, and the onesweep passes in all and
    per pass run; with the passes run and skipped in one call."""
    wrapper.passes_run = wrapper.passes_skipped = 0
    fn()
    torch.cuda.synchronize()
    ran, skipped = wrapper.passes_run, wrapper.passes_skipped
    passes_ms = device_ms(fn, "radix_onesweep_pass")
    return dict(device_ms_upfront=device_ms(fn, "radix_upfront_hist"),
                device_ms_bases=device_ms(fn, "radix_bases"),
                device_ms_passes=passes_ms,
                device_ms_per_pass=passes_ms / ran if passes_ms and ran
                else None,
                passes_run=ran, passes_skipped=skipped)


def sort_detail(t: dict) -> str:
    return (f"device ms: upfront histogram {t['device_ms_upfront']}, bases "
            f"{t['device_ms_bases']}, onesweep passes {t['device_ms_passes']}"
            f" ({t['device_ms_per_pass']} a pass); passes run "
            f"{t['passes_run']}, skipped {t['passes_skipped']}")


def sort_result(err: float, times: dict) -> dict:
    """The kernels-line entry of K2 or K3: code_bits 46, with the 64-bit
    times beside it."""
    return dict(max_abs_err=err, bound_by="bytes", **times[46],
                **{f"{k}_code_bits_64": v for k, v in times[64].items()
                   if k != "bound_ms"})


def k3_inputs(rng, n: int, bits: int):
    """(keys, values) for one case: tie-heavy keys of ``bits`` bits with
    sentinels, values holding 0 and VALID_BIT | id."""
    keys = rng.integers(0, 1 << min(bits, 64), size=n, dtype=np.uint64)
    if n:
        keys[rng.random(n) < 0.25] = keys[0]
    keys[rng.random(n) < 0.02] = SENT
    vals = rng.integers(0, 1 << 20, size=n, dtype=np.uint32)
    vals[rng.random(n) < 0.8] |= np.uint32(VALID_BIT)
    vals[rng.random(n) < 0.05] = 0
    return keys, vals


def check_k3(dev, rng):
    from unikmer_tpu_torch.ops.codec import SIGN
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_shifts, radix_sort_kv_u64, sort_kv_plain,
    )

    def upload(keys, vals):
        return (torch.from_numpy(keys.view(np.int64)).to(dev),
                torch.from_numpy(vals.view(np.int32)).to(dev))

    err, cases = 0.0, 0
    for n in K3_NS + tile_edges():
        for bits in K3_BITS:
            keys, vals = k3_inputs(rng, n, bits)
            extra = (adversarial_keys(rng, n, bits)
                     if n in tile_edges() or n == K3_NS[-2] else [])
            for kk in (keys, np.full(n, SENT), *extra):
                k, v = upload(kk, vals)
                gk, gv = radix_sort_kv_u64(k, v, bits)
                wk, wv = sort_kv_plain(k, v)
                torch.cuda.synchronize()
                e = abs_err(gk, wk)
                if not torch.equal(gv, wv):
                    e = max(e, float((gv.long() - wv.long()).abs().max()))
                err = max(err, e)
                cases += 1
                if e or (n > 1 and gk.data_ptr() == k.data_ptr()):
                    raise SystemExit(f"K3 mismatch: n={n} code_bits={bits} "
                                     f"err={e}")
    times, radix_bound = {}, {}
    for bits in (46, 64):
        k, v = upload(*k3_inputs(rng, 1 << 25, bits))
        flipped = k ^ SIGN
        passes = len(radix_shifts(bits))
        times[bits] = dict(
            **ms_spread(lambda: radix_sort_kv_u64(k, v, bits)),
            plain_ms=cuda_ms(lambda: sort_kv_plain(k, v)),
            # one call: the stable sort, its permutation not yet applied
            library_ms=cuda_ms(lambda: torch.sort(flipped, stable=True)),
            # keys and values read once, both written once
            bound_ms=bytes_ms(24 * k.numel()),
            **sort_device_ms(lambda: radix_sort_kv_u64(k, v, bits),
                             radix_sort_kv_u64))
        # the histogram read of the keys, then 24 B a pair a pass
        radix_bound[bits] = bytes_ms((8 + 24 * passes) * k.numel())
    say(f"K3 radix_sort_kv_u64: exact on both planes in {cases} cases; "
        f"n=2^25 " + "; ".join(
            f"code_bits={b}: kernel {t['ms']} ms (spread {t['ms_spread']}), "
            f"plain {t['plain_ms']} ms, stable torch.sort {t['library_ms']} ms, bound {t['bound_ms']} "
            f"ms, {len(radix_shifts(b))}-pass radix bound "
            f"{radix_bound[b]} ms ({radix_bound[b] / t['ms']:.1%} of it); "
            + sort_detail(t) for b, t in times.items()))
    return sort_result(err, times)


# ---------------------------------------------------------------------------
# main path through the CLI, held against an oracle


def write_fasta(path: str, rng, n_records: int, record_bases: int) -> None:
    """Random DNA with lowercase stretches, N runs, a poly-T run and a
    repeated stretch."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for r in range(n_records):
            seq = lut[rng.integers(0, 4, size=record_bases, dtype=np.uint8)]
            for a in rng.integers(0, record_bases - 20000, size=200):
                seq[a:a + int(rng.integers(10, 20000))] |= 32  # lowercase
            for a in rng.integers(0, record_bases - 2000, size=100):
                seq[a:a + int(rng.integers(1, 2000))] = ord("N")
            seq[1000:1100] = ord("T")
            seq[-200000:-100000] = seq[5000:105000]  # repeated k-mers
            lines = -(-record_bases // LINE)
            text = np.full((lines, LINE + 1), ord("\n"), np.uint8)
            flat = np.zeros(lines * LINE, np.uint8)
            flat[:record_bases] = seq
            text[:, :LINE] = flat.reshape(lines, LINE)
            tail = record_bases - (lines - 1) * LINE
            body = text.reshape(-1)[: (lines - 1) * (LINE + 1) + tail]
            f.write(f">rec{r} synthetic seed={SEED}\n".encode())
            f.write(body.tobytes())
            f.write(b"\n")


def numpy_windows(bases: np.ndarray, k: int, canonical: bool):
    """(codes, positions) of every valid 2-bit window, straight numpy
    (independent of the port).  The code of window i is built from
    8-base blocks: fwd[i] holds bases i..i+7 first base highest, so the
    window is fwd[i] << 2(k-8), fwd[i+8] << 2(k-16), ... and the top r =
    k % 8 bases of the last block; its reverse complement comes the same
    way from rev[i], the complements of bases i..i+7 first base lowest."""
    n = len(bases)
    m = n - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    b = np.zeros(n + 8, np.uint16)
    b[:n] = bases & 3
    fwd = np.zeros(n, np.uint16)
    rev = np.zeros(n, np.uint16)
    for j in range(8):
        x = b[j:j + n]
        fwd = (fwd << 2) | x
        rev |= (3 - x) << (2 * j)
    nb, r = divmod(k, 8)
    codes = np.zeros(m, np.uint64)
    rc = np.zeros(m, np.uint64)
    for q in range(nb):
        codes |= fwd[8 * q:8 * q + m].astype(np.uint64) << np.uint64(
            2 * (k - 8 * (q + 1)))
        rc |= rev[8 * q:8 * q + m].astype(np.uint64) << np.uint64(16 * q)
    if r:
        codes |= (fwd[8 * nb:8 * nb + m] >> (16 - 2 * r)).astype(np.uint64)
        rc |= (rev[8 * nb:8 * nb + m] & ((1 << 2 * r) - 1)).astype(
            np.uint64) << np.uint64(16 * nb)
    bad = np.concatenate([[0], np.cumsum(bases >= 4, dtype=np.int64)])
    pos = np.flatnonzero(bad[k:] - bad[:m] == 0)
    if len(pos) < m:
        codes, rc = codes[pos], rc[pos]
    if canonical:
        codes = np.minimum(codes, rc)
    return codes, pos


def rol_np(x, s: int):
    """Rotate u64 values left by s (mod 64)."""
    s %= 64
    return x if s == 0 else (x << np.uint64(s)) | (x >> np.uint64(64 - s))


@functools.lru_cache(maxsize=None)
def nthash_block_tables(w: int):
    """(TF, TR) over all 4^w codes c of w bases (first base in the top
    2-bit group): ntHash v1's definition for one block of w bases,
    TF[c] = XOR_{t<w} rol(seed[s_t], w-1-t), TR[c] = XOR_{t<w}
    rol(seed[comp s_t], t)."""
    c = np.arange(4 ** w, dtype=np.int64)
    tf = np.zeros(len(c), np.uint64)
    tr = np.zeros(len(c), np.uint64)
    for t in range(w):
        s = (c >> (2 * (w - 1 - t))) & 3
        tf ^= rol_np(NT_SEEDS[s], w - 1 - t)
        tr ^= rol_np(NT_SEEDS_RC[s], t)
    return tf, tr


def nthash_keyed_oracle(bases: np.ndarray, k: int, canonical: bool = True):
    """(keyed, valid), len(bases) long: every window's ntHash v1 written
    from its definition (will-rowe/nthash, the reference's hash),
    independent of the port,

      F = XOR_{j<k} rol(seed[s_j], k-1-j),  R = XOR_{j<k} rol(seed[comp s_j], j)

    and min(F, R) when canonical, where the window's k bases are valid;
    2^64-1 and invalid elsewhere (and past len - k).  The table form over
    8-base blocks: the window is cut into blocks of up to 8 bases from
    its start, and a block of w bases at offset o adds rol(TF_w[c],
    k-o-w) to F and rol(TR_w[c], o) to R, c its 2-bit code
    (nthash_block_tables).  Windows holding a byte that is no base are
    not kept.  Whole-array passes in one thread: 4 table lookups a
    direction a window at k = 31, where the direct form takes 31."""
    n = len(bases)
    keyed = np.full(n, SENT, np.uint64)
    valid = np.zeros(n, bool)
    m = n - k + 1
    if m <= 0:
        return keyed, valid
    # the 8-base code at every position, by doubling (1, 2, 4, 8 bases)
    # over 8 bases of padding; a block of w < 8 bases is its top 2w bits
    c8 = np.zeros(n + 8, np.intp)
    c8[:n] = bases & 3
    for half in (1, 2, 4):
        c8 = (c8[:-half] << (2 * half)) | c8[half:]
    f = np.zeros(m, np.uint64)
    r = np.zeros(m, np.uint64)
    tmp = np.empty(m, np.uint64)
    for o in range(0, k, 8):
        w = min(8, k - o)
        tf, tr = nthash_block_tables(w)
        c = c8[o:o + m] if w == 8 else c8[o:o + m] >> (2 * (8 - w))
        f ^= np.take(rol_np(tf, k - o - w), c, out=tmp)
        if canonical:
            r ^= np.take(rol_np(tr, o), c, out=tmp)
    del c8, c, tmp
    if canonical:
        np.minimum(f, r, out=f)
    del r
    bad = np.concatenate([[0], np.cumsum(bases >= 4, dtype=np.int64)])
    valid[:m] = bad[k:] - bad[:m] == 0
    del bad
    keyed[:m] = np.where(valid[:m], f, SENT)
    return keyed, valid


def nthash_oracle(bases: np.ndarray, k: int, canonical: bool):
    """(codes, positions) of every valid window's ntHash v1, from
    :func:`nthash_keyed_oracle`."""
    keyed, valid = nthash_keyed_oracle(bases, k, canonical)
    pos = np.flatnonzero(valid)
    return keyed[pos], pos


def window_argmin_oracle(keys: np.ndarray, w: int,
                         chunk: int = 1 << 22) -> np.ndarray:
    """The leftmost position of the minimum of keys[i:i+w], cut at the
    end, for every i: np.argmin (the first minimum) over a sliding window
    view, the tail padded with 2^64-1 (which a real key ties at most, and
    the real key lies left of it)."""
    n = len(keys)
    pad = np.concatenate([keys, np.full(w - 1, SENT, np.uint64)])
    out = np.empty(n, np.int64)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        view = np.lib.stride_tricks.sliding_window_view(pad[a:b + w - 1], w)
        out[a:b] = np.arange(a, b) + np.argmin(view, axis=1)
    return out


def minimizer_oracle(keyed: np.ndarray, valid: np.ndarray, w: int):
    """(codes, positions) of the minimizer stream over keyed k-mer hashes,
    from its definition: the window of w k-mer positions from i counts
    when its k-mers are all valid, and yields its minimum (leftmost) when
    the selected position differs from that of window i-1, or window i-1
    did not count."""
    n = len(keyed)
    arg = window_argmin_oracle(keyed, w)
    counts = np.zeros(n, bool)
    m = n - w + 1
    if m > 0:
        bad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int64)])
        counts[:m] = bad[w:] - bad[:m] == 0
    same = np.zeros(n, bool)
    same[1:] = counts[:-1] & (arg[1:] == arg[:-1])
    pos = np.flatnonzero(counts & ~same)
    return keyed[arg[pos]], pos


def syncmer_oracle(kkeyed: np.ndarray, kvalid: np.ndarray,
                   skeyed: np.ndarray, k: int, s: int):
    """(codes, positions) of the closed syncmers, from the definition: a
    valid k-mer whose leftmost minimal s-mer (over its k-s+1 s-mers)
    starts at its offset 0 or k-s."""
    off = window_argmin_oracle(skeyed, k - s + 1) - np.arange(len(skeyed))
    pos = np.flatnonzero(kvalid & ((off == 0) | (off == k - s)))
    return kkeyed[pos], pos


def compat_record_oracle(kh, kv, sh, k: int, s: int) -> np.ndarray:
    """Positions the compat closed syncmer emits in one record, given its
    k-mer hashes and validity (nk = len - k + 1) and keyed s-mer hashes
    (ns = len - s + 1), written from the rule the JAX package's native
    engine runs: mark the leftmost minimum of every window of W = 2(k-s)
    s-mers (cut at the record's end) that is no 2^64-1 and starts a
    valid k-mer; emit the marks, before the first mark every valid
    position at a multiple of T = k-s from it (position >= 1), and before
    the last mark every valid position at a multiple of T after the
    previous mark."""
    nk = len(kh)
    if s == k:
        return np.flatnonzero(kv)
    W, T = 2 * (k - s), k - s
    arg = window_argmin_oracle(sh, W)
    ok = (sh[arg] != SENT) & (arg < nk)
    ok[ok] = kv[arg[ok]]
    mark = np.zeros(nk, bool)
    mark[arg[ok]] = True
    marks = np.flatnonzero(mark)
    if len(marks) == 0:
        return marks
    first, last = marks[0], marks[-1]
    i = np.arange(nk)
    head = (i < first) & (i >= 1) & ((first - i) % T == 0) & kv
    prev = np.maximum.accumulate(np.where(mark, i, -1))
    inner = (i > first) & (i < last) & ((i - prev) % T == 0) & kv
    return np.flatnonzero(mark | head | inner)


def compat_oracle(packed, k: int, s: int):
    """(codes, positions in packed.bases) of the compat closed syncmer,
    record by record (compat_record_oracle); the hashes of windows inside
    a record do not depend on the bytes between records."""
    kkeyed, kvalid = nthash_keyed_oracle(packed.bases, k)
    skeyed, _ = nthash_keyed_oracle(packed.bases, s)
    parts = []
    for start, length in zip(packed.starts, packed.lengths):
        nk, ns = int(length) - k + 1, int(length) - s + 1
        if nk > 0:
            parts.append(start + compat_record_oracle(
                kkeyed[start:start + nk], kvalid[start:start + nk],
                skeyed[start:start + ns], k, s))
    pos = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    return kkeyed[pos], pos


def scaled_max_hash_oracle(scale: int) -> int:
    """The reference's scaled threshold, uint64(float64(MaxUint64) /
    float64(scale)) (unikmer cmd/count.go), written anew here."""
    if scale <= 1:
        return (1 << 64) - 1
    return min(int(np.float64(2.0**64 - 1) / np.float64(scale)),
               (1 << 64) - 1)


def unique_counts(codes: np.ndarray):
    """(the distinct codes ascending, the count of each), from one np.sort:
    on the 133 M codes of the hashed main path, np.unique took minutes on
    the card's host, this form seconds (the oracle's ``unique`` time)."""
    s = np.sort(codes)
    first = np.flatnonzero(np.concatenate([s[:1] == s[:1], s[1:] != s[:-1]]))
    return s[first], np.diff(np.append(first, len(s)))


def numpy_count(bases: np.ndarray, k: int, canonical: bool, mode: str,
                hashed: bool = False):
    """Straight numpy count of 2-bit or ntHash k-mers (independent of the
    port)."""
    windows = nthash_oracle if hashed else numpy_windows
    codes, _ = windows(bases, k, canonical)
    u, counts = unique_counts(codes)
    if mode == "unique":
        return u[counts == 1]
    if mode == "repeated":
        return u[counts > 1]
    return u


def write_oracle(out: str, k: int, flag: int, codes, taxids=None,
                 scale: int = 1, number: int | None = None,
                 max_taxid: int = (1 << 32) - 1) -> None:
    """The oracle's codes through the port's UnikWriter, with the CLI's
    writer settings for -C (``number`` -1 for -l, which leaves the count
    out of the header; ``max_taxid`` the taxids' largest for a
    KmerSet.save)."""
    from unikmer_tpu_torch.io import unik

    with open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag,
            number=len(codes) if number is None else number, compress=False,
            compression_level=5, threads=min(os.cpu_count() or 4, 4),
            global_taxid=0, scale=scale, max_taxid=max_taxid) as w:
        w.write_codes(codes, taxids)


@contextlib.contextmanager
def numpy_host():
    """The port's host layers on their numpy branches: its native library
    reads UNIKMER_TPU_NO_NATIVE on every call, so the oracle shares no
    native code with the CLI it checks."""
    old = os.environ.get("UNIKMER_TPU_NO_NATIVE")
    os.environ["UNIKMER_TPU_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["UNIKMER_TPU_NO_NATIVE"]
        else:
            os.environ["UNIKMER_TPU_NO_NATIVE"] = old


def oracle_unik(fa: str, out: str, k: int, canonical: bool, mode: str,
                hashed: bool = False) -> str:
    """Write the oracle's .unik for ``count -k k [-K] [-H] -s -C [-u|-d]``."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_files

    t0 = time.perf_counter()
    with numpy_host():
        packed = pack_files([fa], k)
        codes = numpy_count(packed.bases, k, canonical, mode, hashed)
        write_oracle(out, k, unik.SORTED
                     | (unik.CANONICAL if canonical else 0)
                     | (unik.HASHED if hashed else 0), codes)
    return (f"numpy{' ntHash' if hashed else ''} "
            f"({time.perf_counter() - t0:.3f} s)")


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def run_cli(argv):
    from unikmer_tpu_torch.cli.main import main

    rc = main(argv)
    torch.cuda.synchronize()
    if rc != 0:
        raise SystemExit(f"CLI exited {rc}: {' '.join(argv)}")


def encode_wrappers() -> dict:
    """The count path's encode and sort wrappers by kernel key."""
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.nthash import encode_nthash
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_sort_kv_u64, radix_sort_u64,
    )
    from unikmer_tpu_torch.ops.sketch import sketch_select

    return {"k1": encode_2bit, "h1": encode_nthash, "s1": sketch_select,
            "k2": radix_sort_u64, "k3": radix_sort_kv_u64}


def counted_cli(argv, need: dict):
    """Run the CLI with every launch counter zeroed just before and read
    just after; ``need`` maps a kernel key to True (it must launch) or
    False (it must not).  Returns (seconds, launches, stage seconds and
    calls)."""
    from unikmer_tpu_torch.utils.stages import record_stages

    wrappers = encode_wrappers()
    for w in wrappers.values():
        w.launches = 0
    with record_stages() as st:
        t0 = time.perf_counter()
        run_cli(argv)
        secs = time.perf_counter() - t0
    launches = {key: w.launches for key, w in wrappers.items()}
    wrong = {key for key, must in need.items() if (launches[key] > 0) != must}
    if wrong:
        raise SystemExit(f"{' '.join(argv)}: launches {launches}, expected "
                         f"{need}")
    return secs, launches, st


def check_against_oracle(tmp, fa, name, k, canonical, mode, extra,
                         hashed=False):
    out = os.path.join(tmp, name)
    argv = ["count", "-k", str(k), *(["-K"] if canonical else []), "-s",
            "-C", *extra, fa, "-o", out]
    need = ({"h1": True, "k1": False, "k2": True, "s1": False} if hashed
            else {"k1": True, "h1": False, "k2": True, "s1": False})
    secs, launches, _ = counted_cli(argv, need)
    which = oracle_unik(fa, out + ".oracle.unik", k, canonical, mode, hashed)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{' '.join(argv)}: .unik differs from the oracle "
                         f"({which})")
    say(f"{' '.join(argv[:-3])}: {os.path.getsize(out + '.unik')} bytes, "
        f"equal to the {which} oracle; CLI {secs:.3f} s, launches {launches}")


def main_path(tmp, rng, report):
    """The 134 Mbp CLI count, 2-bit, then KmerSet.from_fasta of the same
    FASTA (into ``report``), hashed (bench.py's two ntHash
    configurations) and sketched (its two sketch configurations), then
    -u, -d, k = 32 and k = 64 -H -u over one 37.7 Mbp record; returns the
    launches of the 2-bit, the -K -H and the -W 15 run."""
    fa = os.path.join(tmp, "in.fa")
    t0 = time.perf_counter()
    write_fasta(fa, rng, 4, RECORD_BASES)
    say(f"FASTA 4 x {RECORD_BASES} bases written in "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(tmp, "k23")
    argv = ["count", "-k", "23", "-K", "-s", "-C", fa, "-o", out]
    secs, launches, st = counted_cli(argv, {"k1": True, "h1": False,
                                            "k2": True, "s1": False})
    windows = 4 * (RECORD_BASES - 23 + 1)
    say(f"main path {' '.join(argv[:6])}: {secs:.3f} s, "
        f"{windows / secs:.1f} windows/s, launches {launches}")
    say("stage seconds: " + json.dumps(
        {k: round(v, 4) for k, v in st.seconds.items()}))
    which = oracle_unik(fa, out + ".oracle.unik", 23, True, "distinct")
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"main path .unik differs from the {which} oracle")
    say(f"main path .unik ({os.path.getsize(out + '.unik')} bytes) equal to "
        f"the {which} oracle")
    fasta_set_check(tmp, fa, out + ".oracle.unik", report)
    hashed, bases, keyed, valid = hashed_main_path(tmp, fa)
    sketched = sketch_main_path(tmp, fa, bases, keyed, valid)
    del bases, keyed, valid
    os.remove(fa)
    one = os.path.join(tmp, "one.fa")
    write_fasta(one, rng, 1, RECORD_BASES + (RECORD_BASES >> 3))
    check_against_oracle(tmp, one, "u", 23, True, "unique", ["-u"])
    check_against_oracle(tmp, one, "d", 23, True, "repeated", ["-d"])
    check_against_oracle(tmp, one, "k32", 32, False, "distinct", [])
    check_against_oracle(tmp, one, "k64Hu", 64, False, "unique", ["-H", "-u"],
                         hashed=True)
    os.remove(one)
    return {"k1": launches["k1"], "k2": launches["k2"], "h1": hashed["h1"],
            "s1": sketched["s1"]}


def hashed_main_path(tmp, fa):
    """``count -k 31 -K -H -s -C`` and ``count -k 31 -K -D 15 -s -C`` over
    the 134 Mbp FASTA (bench.py's count_nthash_canonical_sort_distinct and
    count_scaled_s15_sort_distinct), each held to the ntHash oracle, whose
    one hash of every window serves both; returns the -H run's launches,
    the packed bases and the oracle's keyed hashes and validity (for the
    sketch runs)."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_files

    k = 31
    t = [time.perf_counter()]
    with numpy_host():
        bases = pack_files([fa], k).bases
        t.append(time.perf_counter())
        keyed, valid = nthash_keyed_oracle(bases, k, True)
        t.append(time.perf_counter())
        u, _ = unique_counts(keyed[valid])
        t.append(time.perf_counter())
    say(f"ntHash oracle of {fa}: k={k} canonical, {len(u)} distinct codes, "
        f"{t[3] - t[0]:.3f} s (pack {t[1] - t[0]:.3f}, hash "
        f"{t[2] - t[1]:.3f}, unique {t[3] - t[2]:.3f})")
    windows = 4 * (RECORD_BASES - k + 1)
    first = None
    for name, extra, scale in (("H", ["-H"], 1), ("D15", ["-D", "15"], 15)):
        out = os.path.join(tmp, f"k31{name}")
        argv = ["count", "-k", str(k), "-K", *extra, "-s", "-C", fa, "-o", out]
        secs, launches, st = counted_cli(argv, {"h1": True, "k1": False,
                                                "k2": True, "s1": False})
        first = first or launches
        say(f"hashed main path {' '.join(argv[:-3])}: {secs:.3f} s, "
            f"{windows / secs:.1f} windows/s, launches {launches}")
        say(f"hashed main path {' '.join(extra)} stage seconds: " + json.dumps(
            {s: round(v, 4) for s, v in st.seconds.items()}))
        t0 = time.perf_counter()
        want = u[u <= np.uint64(scaled_max_hash_oracle(scale))]
        with numpy_host():
            write_oracle(out + ".oracle.unik", k, unik.SORTED | unik.CANONICAL
                         | unik.HASHED, want, scale=scale)
        if not same_bytes(out + ".unik", out + ".oracle.unik"):
            raise SystemExit(f"{' '.join(argv)}: .unik differs from the ntHash "
                             f"oracle")
        say(f"hashed main path {' '.join(extra)} .unik ({os.path.getsize(out + '.unik')} "
            f"bytes, {len(want)} codes) equal to the ntHash oracle (written in "
            f"{time.perf_counter() - t0:.3f} s)")
        os.remove(out + ".unik")
        os.remove(out + ".oracle.unik")
    return first, bases, keyed, valid


def sketch_main_path(tmp, fa, bases, keyed, valid):
    """``count -k 31 -W 15 -s -C`` and ``count -k 31 -S 16 -s -C`` over the
    134 Mbp FASTA (bench.py's count_minimizer_w15_sort_distinct and
    count_syncmer_s16_sort_distinct, whole records, no -K: the sketch
    switches it on), each held to its oracle over the ntHash oracle's
    keyed hashes; returns the -W 15 run's launches."""
    from unikmer_tpu_torch.io import unik

    k, w, s = SKETCH_K, SKETCH_W, SKETCH_S
    t0 = time.perf_counter()
    with numpy_host():
        skeyed, _ = nthash_keyed_oracle(bases, s, True)
    say(f"ntHash oracle at s={s}: {time.perf_counter() - t0:.3f} s")
    windows = 4 * (RECORD_BASES - k + 1)
    runs = (("W15", ["-W", str(w)], "minimizer",
             lambda: minimizer_oracle(keyed, valid, w)[0]),
            ("S16", ["-S", str(s)], "closed syncmer",
             lambda: syncmer_oracle(keyed, valid, skeyed, k, s)[0]))
    first = None
    for name, extra, what, oracle in runs:
        out = os.path.join(tmp, f"k31{name}")
        argv = ["count", "-k", str(k), *extra, "-s", "-C", fa, "-o", out]
        torch.cuda.reset_peak_memory_stats()
        secs, launches, st = counted_cli(argv, {"h1": True, "s1": True,
                                                "k1": False, "k2": True})
        peak = torch.cuda.max_memory_allocated()
        first = first or launches
        say(f"sketch main path {' '.join(argv[:-3])}: {secs:.3f} s, "
            f"{windows / secs:.1f} windows/s, pieces "
            f"{st.calls.get('s1', 0)}, launches {launches}, peak device "
            f"memory {peak} B")
        say(f"sketch main path {' '.join(extra)} stage seconds: " + json.dumps(
            {x: round(v, 4) for x, v in st.seconds.items()}))
        t0 = time.perf_counter()
        with numpy_host():
            u, _ = unique_counts(oracle())
            write_oracle(out + ".oracle.unik", k, unik.SORTED | unik.CANONICAL
                         | unik.HASHED, u)
        if not same_bytes(out + ".unik", out + ".oracle.unik"):
            raise SystemExit(f"{' '.join(argv)}: .unik differs from the "
                             f"{what} oracle")
        say(f"sketch main path {' '.join(extra)} .unik ("
            f"{os.path.getsize(out + '.unik')} bytes, {len(u)} codes, "
            f"{len(u) / len(keyed):.4f} of the positions) equal to the "
            f"{what} oracle ({time.perf_counter() - t0:.3f} s)")
        os.remove(out + ".unik")
        os.remove(out + ".oracle.unik")
    return first


def linear_hashed_path(tmp, rng):
    """A small ``count -k 27 -K -l -H -C`` (two 2^20-base records) held
    to the ntHash oracle's windows in genome order, then ``count -k 23
    -W 5 -l -C`` over them held to the minimizer oracle's stream; returns
    the launches of both."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_files

    fa = os.path.join(tmp, "lin.fa")
    write_fasta(fa, rng, 2, LINEAR_BASES)
    out = os.path.join(tmp, "linH")
    argv = ["count", "-k", "27", "-K", "-l", "-H", "-C", fa, "-o", out]
    secs, launches, _ = counted_cli(argv, {"h1": True, "k1": False,
                                           "s1": False})
    t0 = time.perf_counter()
    with numpy_host():
        codes, _ = nthash_oracle(pack_files([fa], 27).bases, 27, True)
        write_oracle(out + ".oracle.unik", 27, unik.CANONICAL | unik.HASHED,
                     codes, number=-1)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{' '.join(argv)}: .unik differs from the oracle")
    say(f"{' '.join(argv[:-3])}: {len(codes)} windows in genome order, "
        f"equal to the ntHash oracle ({time.perf_counter() - t0:.3f} s); "
        f"CLI {secs:.3f} s, launches {launches}")
    out = os.path.join(tmp, "linW")
    argv = ["count", "-k", "23", "-W", "5", "-l", "-C", fa, "-o", out]
    secs, sketch_launches, _ = counted_cli(argv, {"h1": True, "s1": True,
                                                  "k1": False})
    t0 = time.perf_counter()
    with numpy_host():
        keyed, valid = nthash_keyed_oracle(pack_files([fa], 23).bases, 23)
        codes, _ = minimizer_oracle(keyed, valid, 5)
        write_oracle(out + ".oracle.unik", 23, unik.CANONICAL | unik.HASHED,
                     codes, number=-1)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{' '.join(argv)}: .unik differs from the "
                         f"minimizer oracle")
    say(f"{' '.join(argv[:-3])}: {len(codes)} minimizers in genome order, "
        f"equal to the minimizer oracle ({time.perf_counter() - t0:.3f} s); "
        f"CLI {secs:.3f} s, launches {sketch_launches}")
    os.remove(fa)
    return launches, sketch_launches


def write_records_fasta(path: str, rng, lengths) -> None:
    """One record of random DNA a length, with lowercase stretches and N
    runs."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, n in enumerate(lengths):
            seq = lut[rng.integers(0, 4, size=n, dtype=np.uint8)]
            if n > 500:
                a = int(rng.integers(0, n - 400))
                seq[a:a + 300] |= 32
                a = int(rng.integers(0, n - 100))
                seq[a:a + int(rng.integers(1, 60))] = ord("N")
            f.write(b">c%d\n%s\n" % (i, seq.tobytes()))


def compat_path(tmp, rng):
    """``count -k 31 -S 16 --syncmer-impl compat -s -C`` over about 4 Mbp
    of records from 1 to COMPAT_MAX_BASES bases (some shorter than k and
    than the W = 30 vote window), held to the per-record compat oracle;
    returns the launches."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_records, read_fastx

    k, s = SKETCH_K, SKETCH_S
    fa = os.path.join(tmp, "compat.fa")
    lengths = rng.integers(1, COMPAT_MAX_BASES, size=COMPAT_RECORDS)
    lengths[:6] = (1, 20, 30, 31, 32, 45)
    write_records_fasta(fa, rng, lengths)
    out = os.path.join(tmp, "compat")
    argv = ["count", "-k", str(k), "-S", str(s), "--syncmer-impl", "compat",
            "-s", "-C", fa, "-o", out]
    secs, launches, _ = counted_cli(argv, {"h1": True, "s1": True,
                                           "k1": False, "k2": True})
    t0 = time.perf_counter()
    with numpy_host():
        codes, _ = compat_oracle(pack_records(read_fastx(fa), k), k, s)
        u, _ = unique_counts(codes)
        write_oracle(out + ".oracle.unik", k, unik.SORTED | unik.CANONICAL
                     | unik.HASHED, u)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{' '.join(argv)}: .unik differs from the "
                         f"per-record compat oracle")
    say(f"{' '.join(argv[:-3])}: {len(lengths)} records, "
        f"{int(lengths.sum())} bases, {len(u)} codes, equal to the "
        f"per-record compat oracle ({time.perf_counter() - t0:.3f} s); CLI "
        f"{secs:.3f} s, launches {launches}")
    os.remove(fa)
    return launches


# ---------------------------------------------------------------------------
# count -T through the CLI, held against an oracle


def write_taxonomy(d: str, rng):
    """nodes.dmp of TAX_NODES nodes in the format of NCBI's: the parent
    of t is uniform in [1, t), except a chain of TAX_CHAIN nodes grafted
    under node 2.  Returns (the random part's leaves, the chain)."""
    body = TAX_NODES - TAX_CHAIN
    parent = np.zeros(TAX_NODES + 1, np.int64)
    parent[1] = 1
    parent[2:body + 1] = rng.integers(1, np.arange(2, body + 1))
    chain = np.arange(body + 1, TAX_NODES + 1)
    parent[chain] = np.concatenate([[2], chain[:-1]])
    with open(os.path.join(d, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{parent[t]}\t|\tno rank\t|\t\t|\n"
                     for t in range(1, TAX_NODES + 1))
    has_child = np.zeros(TAX_NODES + 1, bool)
    has_child[parent[2:]] = True
    leaves = np.flatnonzero(~has_child[:body + 1])
    return leaves[leaves >= 2], chain


def write_taxid_fasta(path: str, rng, taxids, record_bases: int,
                      poly_t: bool = False) -> None:
    """One record per taxid (header ``rec<i> taxid|<t>``): random DNA
    where a quarter of each record is copied from another record (codes
    whose taxids merge), two N runs and a lowercase stretch; with
    ``poly_t`` record 0 holds exactly one window of 32 T's."""
    lut = np.frombuffer(b"ACGT", np.uint8)
    n = len(taxids)
    orig = lut[rng.integers(0, 4, size=(n, record_bases), dtype=np.uint8)]
    seqs = orig.copy()
    q = record_bases // 4
    src = (np.arange(n) + rng.integers(1, n, size=n)) % n
    a = rng.integers(0, record_bases - q, size=n)
    b = rng.integers(0, record_bases - q, size=n)
    with open(path, "wb") as f:
        for i in range(n):
            seq = seqs[i]
            seq[a[i]:a[i] + q] = orig[src[i], b[i]:b[i] + q]
            for x in rng.integers(0, record_bases - 50, size=2):
                seq[x:x + int(rng.integers(1, 50))] = ord("N")
            x = int(rng.integers(0, record_bases - 500))
            seq[x:x + 500] |= 32
            if poly_t and i == 0:
                seq[999:1033] = np.frombuffer(b"A" + b"T" * 32 + b"A", np.uint8)
            f.write(b">rec%d taxid|%d\n" % (i, taxids[i]))
            f.write(seq.tobytes())
            f.write(b"\n")


def oracle_taxid_unik(fa: str, out: str, k: int, canonical: bool, mode: str,
                      data_dir: str, hashed: bool = False,
                      minimizer_w: int = 0):
    """Write the oracle's .unik for ``count -k k [-K] [-H] [-W w] -s -C -T
    -r ...``; returns (which oracle, codes, taxids)."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_records, read_fastx
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    with numpy_host():
        taxdb = load_taxonomy(data_dir)
        re_t = re.compile(RE_TAXID.encode())
        records = list(read_fastx(fa))
        rec_taxids = np.array([int(re_t.search(r.name).group(1))
                               for r in records], np.uint32)
        packed = pack_records(records, k)
        if minimizer_w:
            keyed, valid = nthash_keyed_oracle(packed.bases, k)
            codes, pos = minimizer_oracle(keyed, valid, minimizer_w)
        else:
            windows = nthash_oracle if hashed else numpy_windows
            codes, pos = windows(packed.bases, k, canonical)
        taxids = rec_taxids[np.searchsorted(packed.starts, pos, "right") - 1]
        uniq, merged = taxdb.lca_reduce(codes, taxids)
        if mode != "distinct":
            _, counts = np.unique(codes, return_counts=True)
            keep = counts == 1 if mode == "unique" else counts > 1
            uniq, merged = uniq[keep], merged[keep]
        write_oracle(out, k, unik.SORTED | unik.INCLUDE_TAXID
                     | (unik.CANONICAL if canonical or minimizer_w else 0)
                     | (unik.HASHED if hashed or minimizer_w else 0),
                     uniq, merged)
    which = (" minimizer" if minimizer_w else " ntHash" if hashed else "")
    return f"numpy{which} + lca_reduce", uniq, merged


def taxid_run(tmp, name, fa, data_dir, k, canonical, mode, windows,
              hashed=False, minimizer_w=0):
    """One ``count -T`` CLI run with its launch counts, stage seconds and
    peak device memory, held against the oracle's bytes; returns (the
    launches, the oracle's codes and taxids)."""
    out = os.path.join(tmp, name)
    flags = {"unique": ["-u"], "repeated": ["-d"]}.get(mode, [])
    if minimizer_w:
        flags += ["-W", str(minimizer_w)]
    argv = ["count", "-k", str(k), *(["-K"] if canonical else []),
            *(["-H"] if hashed else []), "-s", "-C", *flags, "-T", "-r",
            RE_TAXID, "--data-dir", data_dir, fa, "-o", out]
    torch.cuda.reset_peak_memory_stats()
    encode = "h1" if hashed or minimizer_w else "k1"
    secs, launches, st = counted_cli(
        argv, {encode: True, "h1" if encode == "k1" else "k1": False,
               "k3": True, "s1": bool(minimizer_w)})
    peak = torch.cuda.max_memory_allocated()
    say(f"{name} {' '.join(argv[:-5])}: {secs:.3f} s, {windows} windows, "
        f"{windows / secs:.1f} windows/s, pieces {st.calls.get(encode, 0)}, "
        f"launches {launches}, peak device memory {peak} B")
    say(f"{name} stage seconds: " + json.dumps(
        {s: round(v, 4) for s, v in st.seconds.items()}))
    which, codes, taxids = oracle_taxid_unik(fa, out + ".oracle.unik", k,
                                             canonical, mode, data_dir, hashed,
                                             minimizer_w)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{name}: .unik differs from the {which} oracle")
    say(f"{name} .unik ({os.path.getsize(out + '.unik')} bytes, {len(codes)} "
        f"codes, {len(np.unique(taxids))} distinct taxids) equal to the "
        f"{which} oracle")
    return launches, codes, taxids


def taxid_path(tmp, rng):
    """T1, T1 hashed, T2 and T3 (module docstring); returns K3's launches
    in T1-T3."""
    from unikmer_tpu_torch.taxonomy.lca import device_lca_plan
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    d = os.path.join(tmp, "taxdump")
    os.mkdir(d)
    leaves, chain = write_taxonomy(d, rng)
    taxdb = load_taxonomy(d)
    # T1: 32 of its taxids down the chain, the deepest closure paths
    t1 = np.concatenate([chain[-32:], rng.choice(leaves, T1_RECORDS - 32,
                                                 replace=False)])
    t2 = np.repeat(np.concatenate([chain[::4], rng.choice(
        np.arange(3, TAX_NODES - TAX_CHAIN), T2_TAXIDS - len(chain[::4]),
        replace=False)]), 2)
    t3 = np.array([chain[-1], leaves[0]])
    runs = (("T1", t1, T1_BASES, 23, True, "distinct", "paths"),
            ("T2", t2, T2_BASES, 23, True, "distinct", "table"),
            ("T3", t3, T3_BASES, 32, False, "unique", "table"))
    k3 = 0
    for name, taxids, length, k, canonical, mode, tier in runs:
        plan = device_lca_plan(taxdb, taxids)
        if plan is None or plan[0] != tier:
            raise SystemExit(f"{name}: expected the {tier} tier, plan "
                             f"{plan and plan[0]}")
        kind, closure, tab = plan
        say(f"{name}: tier {kind}, vocabulary {len(np.unique(taxids))} "
            f"taxids, closure {len(closure)} ids, "
            f"Dp {tab.shape[1] if kind == 'paths' else '-'}")
        fa = os.path.join(tmp, name + ".fa")
        write_taxid_fasta(fa, rng, taxids, length, poly_t=name == "T3")
        launches, codes, got_taxids = taxid_run(
            tmp, name, fa, d, k, canonical, mode,
            len(taxids) * (length - k + 1))
        k3 += launches["k3"]
        if name == "T1":  # the same input hashed (H1, then K3) and sketched
            taxid_run(tmp, "T1H", fa, d, 31, True, "distinct",
                      len(taxids) * (length - 31 + 1), hashed=True)
            taxid_run(tmp, "T1W", fa, d, SKETCH_K, False, "distinct",
                      len(taxids) * (length - SKETCH_K + 1),
                      minimizer_w=SKETCH_W)
        os.remove(fa)
    # T3: the one window of 32 T's is a real 2^64-1 code, kept with the
    # taxid of its record
    if not (codes[-1] == SENT and got_taxids[-1] == t3[0]):
        raise SystemExit(f"T3: the 2^64-1 code was not kept with taxid "
                         f"{t3[0]}: {codes[-3:]}, {got_taxids[-3:]}")
    return k3


# ---------------------------------------------------------------------------
# sets: KmerSet, ops/device_sets and the set-operation subcommands


def set_bases(rng, n: int | None = None):
    """The bases (0-3) of the sets path's records A, B and C: A random; B
    A's first half with a substitution about every 1,000 bases, then new
    bases; C A's third quarter, B's second and fourth quarters (each with
    substitutions) and a new quarter.  So every pair shares a large part
    and each record has a part of its own."""
    n = n or SETS_BASES
    h, q = n // 2, n // 4

    def subst(x):
        x = x.copy()
        m = rng.random(len(x)) < 1e-3
        x[m] = (x[m] + rng.integers(1, 4, size=int(m.sum()),
                                    dtype=np.uint8)) % 4
        return x

    a = rng.integers(0, 4, size=n, dtype=np.uint8)
    b = np.concatenate([subst(a[:h]), rng.integers(0, 4, size=h,
                                                   dtype=np.uint8)])
    c = np.concatenate([subst(a[2 * q:3 * q]), subst(b[q:2 * q]),
                        subst(b[3 * q:]),
                        rng.integers(0, 4, size=q, dtype=np.uint8)])
    return a, b, c


def write_one_record(path: str, name: str, bases: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(np.frombuffer(b"ACGT", np.uint8)[bases].tobytes())
        f.write(b"\n")


def member_np(ref: np.ndarray, q: np.ndarray):
    """(index, hit) of each query in the sorted ``ref`` by np.searchsorted."""
    if len(ref) == 0:
        return np.zeros(len(q), np.int64), np.zeros(len(q), bool)
    idx = np.minimum(np.searchsorted(ref, q), len(ref) - 1)
    return idx, ref[idx] == q


def merge_sets(sets):
    """(u, bits): the distinct codes of sorted arrays (at most 8) and for
    each a bit per array that holds it, from one stable numpy sort of
    their concatenation (it merges the sorted runs in linear time; a
    quicksort of 10^8 codes took minutes on the card's host)."""
    codes = np.concatenate(sets)
    tags = np.concatenate([np.full(len(x), 1 << i, np.uint8)
                           for i, x in enumerate(sets)])
    if len(codes) == 0:
        return codes, tags
    order = np.argsort(codes, kind="stable")
    codes, tags = codes[order], tags[order]
    del order
    first = np.flatnonzero(np.concatenate([[True], codes[1:] != codes[:-1]]))
    return codes[first], np.bitwise_or.reduceat(tags, first)


def set_oracles(merged) -> dict:
    """The library phase's results from the merge of A, B and C: the
    union, intersection and difference of A and B, the union of all and
    the codes of at least 2 of 3."""
    u, bits = merged
    ab = bits & 3
    held = (bits & 1) + (bits >> 1 & 1) + (bits >> 2 & 1)
    return {"A | B": u[ab != 0], "A & B": u[ab == 3], "A - B": u[ab == 1],
            "union_all": u, "common 2": u[held >= 2]}


def low_complexity_oracle(codes: np.ndarray, k: int, penalty_s: int = 3,
                          penalty_d: int = 1, threshold: int = 15,
                          window: int = 7) -> np.ndarray:
    """True where a 2-bit k-mer is low-complexity, from the filter's
    definition: walk the bases from the last one back, score the first
    penalty_d and each next one penalty_s where it equals the base walked
    before it, else penalty_d; the k-mer is low when a window of scores
    starting at 0 .. max(k - window - 1, 0) sums to >= threshold.  Base j
    of the walk is bits 2j of the code, read from its byte j // 4."""
    window = min(window, k)
    out = np.zeros(len(codes), bool)
    step = 1 << 22
    for lo in range(0, len(codes), step):
        by = np.ascontiguousarray(codes[lo:lo + step], "<u8").view(
            np.uint8).reshape(-1, 8)
        walked = [(by[:, j >> 2] >> (2 * (j & 3))) & 3 for j in range(k)]
        csum = [np.zeros(len(by), np.int16), np.full(len(by), penalty_d,
                                                     np.int16)]
        for j in range(1, k):
            csum.append(csum[-1] + np.where(walked[j] == walked[j - 1],
                                            penalty_s, penalty_d).astype(
                                                np.int16))
        for s in range(max(k - window - 1, 0) + 1):
            out[lo:lo + len(by)] |= (csum[min(s + window, k)] - csum[s]
                                     >= threshold)
    return out


def taxid_set_oracles(a, ta, b, tb, taxdb) -> dict:
    """(codes, taxids) of the taxid set operations of A and B: a code in
    both takes lca_pairs of its two taxids (unknown -> 0, 0 the
    identity; each distinct pair walked once), a code in one keeps its
    own.  In the one-sided union B's taxids are 0, so a shared code
    takes lca_pairs(its A taxid, 0)."""
    _, in_a = member_np(a, b)  # b's codes found in a
    ib, in_b = member_np(b, a)
    shared = a[in_b]
    pairs = (ta[in_b].astype(np.uint64) << np.uint64(32)) | tb[ib[in_b]]
    uniq, inv = np.unique(pairs, return_inverse=True)
    lca = taxdb.lca_pairs(uniq >> np.uint64(32),
                          uniq & np.uint64(0xFFFFFFFF))[inv.reshape(-1)]
    u = merge_sets([a, b])[0]
    tu = np.zeros(len(u), np.uint32)
    tu[np.searchsorted(u, a)] = ta
    tu[np.searchsorted(u, b[~in_a])] = tb[~in_a]
    tu[np.searchsorted(u, shared)] = lca
    t1 = np.zeros(len(u), np.uint32)
    t1[np.searchsorted(u, a)] = ta
    t1[np.searchsorted(u, shared)] = taxdb.lca_pairs(
        ta[in_b], np.zeros(len(shared), np.uint32))
    return {"A | B (taxids)": (u, tu), "A | B (one-sided)": (u, t1),
            "A & B (taxids)": (shared, lca),
            "A & B (one-sided)": (shared, ta[in_b]),
            "A - B (taxids)": (a[~in_b], ta[~in_b])}


def cli_setop_oracles(merged, gtaxids, taxdb) -> dict:
    """(codes, taxids) of ``union``, ``inter``, ``diff`` and ``common -n
    2`` over the three sets written by ``count -t`` with the global
    taxids ``gtaxids``, from their merge: a code's taxid is the LCA of
    the taxids of the files that hold it (the query's for diff)."""
    u, bits = merged
    lca = np.zeros(8, np.uint32)
    for p in range(1, 8):
        members = [gtaxids[i] for i in range(3) if p >> i & 1]
        acc = np.array([members[0]], np.uint32)
        for m in members[1:]:
            acc = taxdb.lca_pairs(acc, np.array([m], np.uint32))
        lca[p] = acc[0]
    tax = lca[bits]
    nfiles = (bits & 1) + (bits >> 1 & 1) + (bits >> 2 & 1)
    diff = bits == 1
    return {"union": (u, tax), "inter": (u[bits == 7], tax[bits == 7]),
            "diff": (u[diff], np.full(int(diff.sum()), gtaxids[0],
                                      np.uint32)),
            "common": (u[nfiles >= 2], tax[nfiles >= 2])}


def counted(fn, need: dict, what: str):
    """fn() once with the K1/K2/K3 counters zeroed just before and read
    just after, and the peak device memory over it; raises unless the
    launches equal ``need``.  Returns (result, seconds, launches, peak)."""
    wrappers = {key: w for key, w in encode_wrappers().items()
                if key in ("k1", "k2", "k3")}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {key: w.launches for key, w in wrappers.items()}
    if any(launches[key] != n for key, n in need.items()):
        raise SystemExit(f"sets {what}: launches {launches}, expected {need}")
    return out, secs, launches, peak


HOST_BRANCHES = {"native": contextlib.nullcontext, "numpy": numpy_host}


def host_seconds(fn, branches=("native", "numpy")) -> dict:
    """Seconds of one call of a host-engine function on each of
    ``branches``: the native library, then its numpy branches."""
    out = {}
    for branch in branches:
        with HOST_BRANCHES[branch]():
            t0 = time.perf_counter()
            fn()
            out[f"host_{branch}_s"] = round(time.perf_counter() - t0, 4)
    return out


def check_saved(tmp, name, kset, codes, taxids=None) -> None:
    """kset.save() against the oracle's .unik, byte for byte."""
    from unikmer_tpu_torch.io import unik

    got = os.path.join(tmp, "set.unik")
    want = os.path.join(tmp, "set.oracle.unik")
    kset.save(got, compress=False)
    flag = unik.SORTED | unik.CANONICAL
    with numpy_host():
        if taxids is None:
            write_oracle(want, kset.k, flag, codes)
        else:
            write_oracle(want, kset.k, flag | unik.INCLUDE_TAXID, codes,
                         taxids, max_taxid=int(taxids.max(initial=0)))
    if not same_bytes(got, want):
        raise SystemExit(f"sets {name}: the saved .unik differs from the "
                         f"oracle's")
    os.remove(got)
    os.remove(want)


class SetsReport:
    """The rows of the ``sets`` JSON line and the K2/K3 launches of the
    sets path."""

    def __init__(self):
        self.rows = []
        self.launches = {"k1": 0, "k2": 0, "k3": 0}
        self.admission = {}

    def forced_host(self, name, secs, launches, peak, device_s) -> None:
        """A run with UNIKMER_TPU_MAX_ELEMS below its size, exact, beside
        the device route's first run; its launches stay out of the
        kernels line."""
        row = {"s": round(secs, 4), "device_route_s": device_s,
               "peak_bytes": peak,
               "launches": {k: v for k, v in launches.items() if v}}
        self.admission.setdefault("forced_host", {})[name] = row
        say(f"admission {name} past the budget: exact, " + json.dumps(row))

    def op(self, name, fn, need, check, host=None,
           branches=("native", "numpy")):
        """Run a set operation once counted and checked, then time it
        (the median of 5 runs; of 1 where the first took over a second:
        the host-bound transforms); returns its result."""
        out, secs, launches, peak = counted(fn, need, name)
        check(out)
        for key in self.launches:
            self.launches[key] += launches[key]
        reps = 5 if secs < 1 else 1
        row = {"op": name, "ms": round(cuda_ms(fn, reps), 4), "runs": reps,
               "first_s": round(secs, 4), "peak_bytes": peak,
               "launches": {k: v for k, v in launches.items() if v}}
        if host is not None:
            row.update(host_seconds(host, branches))
        self.rows.append(row)
        say(f"sets {name}: " + json.dumps(row))
        return out


def same_set(name, got_codes, want_codes, got_tax=None, want_tax=None):
    if not np.array_equal(got_codes, want_codes):
        raise SystemExit(f"sets {name}: {len(got_codes)} codes against the "
                         f"oracle's {len(want_codes)}, not equal")
    if want_tax is not None and not np.array_equal(got_tax, want_tax):
        raise SystemExit(f"sets {name}: taxids differ from the oracle's")


def fasta_set_check(tmp, fa, oracle_path, report: SetsReport,
                    dev=None) -> None:
    """KmerSet.from_fasta(k=23, canonical=True) of the main path's 134 Mbp
    FASTA: a device set a record (K1, K2 each), merged by union_all (one
    more K2), saved byte-equal to the main path's oracle .unik."""
    from unikmer_tpu_torch import KmerSet

    dev = dev or torch.device("cuda", 0)
    got = os.path.join(tmp, "fasta_set.unik")

    def check(kset):
        kset.save(got, compress=False)
        if not same_bytes(got, oracle_path):
            raise SystemExit("sets from_fasta 134 Mbp: .unik differs from "
                             "the main path's oracle")
        os.remove(got)

    report.op("from_fasta 134 Mbp (4 pieces)",
              lambda: KmerSet.from_fasta(fa, 23, canonical=True, device=dev),
              {"k1": 4, "k2": 5, "k3": 0}, check)
    # past the budget: the pieces' sorts, no union_all, the set kept on
    # the host
    with max_elems(1 << 26):
        kset, secs, launches, peak = counted(
            lambda: KmerSet.from_fasta(fa, 23, canonical=True, device=dev),
            {"k1": 4, "k2": 4, "k3": 0}, "from_fasta 134 Mbp (forced host)")
    if not kset._on_host:
        raise SystemExit("sets from_fasta past the budget: the set is on "
                         "the card")
    check(kset)
    del kset
    report.forced_host("from_fasta 134 Mbp", secs, launches, peak,
                       report.rows[-1]["first_s"])


@contextlib.contextmanager
def max_elems(n: int):
    """UNIKMER_TPU_MAX_ELEMS=n inside: every route's element budget is n,
    so work past it takes the host route."""
    os.environ["UNIKMER_TPU_MAX_ELEMS"] = str(n)
    try:
        yield
    finally:
        del os.environ["UNIKMER_TPU_MAX_ELEMS"]


def admission_budgets(dev) -> dict:
    """The device's free bytes, each route's bytes a slot and the element
    budgets they give (ops/device_sets.element_budget; the paths tier's
    also at path tables 1, 16 and 64 columns wide), printed."""
    from unikmer_tpu_torch.ops import device_sets

    if "UNIKMER_TPU_MAX_ELEMS" in os.environ:
        raise SystemExit("admission: UNIKMER_TPU_MAX_ELEMS is set")
    row = {"free_bytes": device_sets._device_free_bytes(dev),
           "admit_share": device_sets.ADMIT_SHARE,
           "slot_bytes": dict(device_sets.SLOT_BYTES),
           "path_column_bytes": device_sets.PATH_COLUMN_BYTES,
           "budgets": {route: device_sets.element_budget(route, dev)
                       for route in device_sets.SLOT_BYTES},
           "paths_budgets": {
               dp: device_sets.element_budget("union_taxids_paths", dev, dp)
               for dp in (1, 16, 64)}}
    say("admission budgets: " + json.dumps(row))
    return row


def grep_oracle(path: str, unik_in: str, hit: np.ndarray, taxid: int) -> None:
    """What ``grep -F q.unik -C`` writes for a sorted input file with a
    global taxid: block by block of the input (read here on the numpy
    branches), the codes where ``hit``, each with the taxid, in a sorted
    .unik with INCLUDE_TAXID and no count."""
    from unikmer_tpu_torch.io import unik

    with numpy_host(), unik.UnikReader(unik_in) as r, open(path, "wb") as fh, \
            unik.UnikWriter(fh, k=r.header.k, flag=unik.SORTED
                            | unik.CANONICAL | unik.INCLUDE_TAXID,
                            compress=False, max_taxid=(1 << 32) - 1) as w:
        off = 0
        for codes, _ in r.iter_blocks():
            c = codes[hit[off:off + len(codes)]]
            off += len(codes)
            if len(c):
                w.write_codes(c, np.full(len(c), taxid, np.uint32))


def grep_path(tmp, rng, a_codes, a_unik: str, taxid: int, dev,
              half: int = 1 << 21):
    """``grep -F q.unik`` over A's ``count -t`` output, the device tier
    (UNIKMER_TPU_GREP_DEVICE=1) and then the host's (=0): q.unik holds
    2 x ``half`` codes, ``half`` of them members of A and ``half`` valid
    23-mer codes that A lacks, so the hits are known.  Both outputs are held to
    grep_oracle byte for byte; each run is timed whole, with its peak
    device memory above what was allocated before it and the
    DeviceMembership.lookup calls it made; member_bits is timed alone
    on a 2^20-code block (CUDA events).  Prints and returns the ``grep``
    row."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.ops import device_sets

    idx = rng.choice(len(a_codes), half, replace=False)
    cand = np.unique(rng.integers(0, 1 << 46, size=half + (half >> 2),
                                  dtype=np.uint64))
    cand = cand[~member_np(a_codes, cand)[1]]
    if len(cand) < half:
        raise SystemExit("grep: too few non-members drawn")
    cand = rng.choice(cand, half, replace=False)
    q = np.unique(np.concatenate([a_codes[idx], cand]))
    hit = np.zeros(len(a_codes), bool)
    hit[idx] = True
    qpath = os.path.join(tmp, "q.unik")
    with numpy_host():
        write_oracle(qpath, 23, unik.SORTED | unik.CANONICAL, q)
    want = os.path.join(tmp, "grep.oracle.unik")
    grep_oracle(want, a_unik, hit, taxid)
    calls = []
    real = device_sets.DeviceMembership.lookup

    def spy(self, look):
        calls.append(len(look))
        return real(self, look)

    row = {"queries": len(q), "hits": int(hit.sum()),
           "input_codes": len(a_codes)}
    device_sets.DeviceMembership.lookup = spy
    try:
        for route, knob in (("device", "1"), ("host", "0")):
            out = os.path.join(tmp, f"grep_{route}")
            os.environ["UNIKMER_TPU_GREP_DEVICE"] = knob
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            try:
                _, secs, launches, peak = counted(
                    lambda: run_cli(["grep", "-F", qpath, "-C", a_unik, "-o",
                                     out]),
                    {"k1": 0, "k2": 0, "k3": 0}, f"grep ({route} tier)")
            finally:
                del os.environ["UNIKMER_TPU_GREP_DEVICE"]
            if (route == "device") != bool(calls):
                raise SystemExit(f"grep {route} tier: {len(calls)} "
                                 f"DeviceMembership lookups")
            if not same_bytes(out + ".unik", want):
                raise SystemExit(f"grep {route} tier: .unik differs from the "
                                 f"oracle")
            row[f"{route}_s"] = round(secs, 4)
            if route == "device":
                row["device_peak_bytes"] = peak - base
                row["lookups"] = len(calls)
            os.remove(out + ".unik")
    finally:
        device_sets.DeviceMembership.lookup = real
    member = device_sets.DeviceMembership(q, device=dev)
    block = torch.from_numpy(np.sort(a_codes[rng.integers(
        0, len(a_codes), size=min(1 << 20, len(a_codes)))]).view(
            np.int64)).to(dev)
    row["member_bits_ms"] = round(cuda_ms(
        lambda: device_sets.member_bits(member.dev_q, block), 20), 5)
    look = block.cpu().numpy().view(np.uint64)
    row["lookup_ms"] = round(cuda_ms(lambda: member.lookup(look), 20), 5)
    del member, block
    for f in (qpath, want):
        os.remove(f)
    say("grep: both tiers equal the oracle; " + json.dumps(row))
    return row


def text_round_trip(tmp, rng, a_codes, n: int = 1 << 20) -> dict:
    """``view`` then ``dump`` over an n-code 2-bit file (k = 23, A's
    first codes, canonical: ``dump -K`` keeps them) and an n-code hashed file (k = 31): view's text with the native library
    equals its numpy branch's (utils/textout) byte for byte, with and
    without -n; dump of that text (the native parse_code_lines) writes the
    original file's bytes, and the hashed file's numpy dump (the per-line
    parse) does too.  Returns seconds by step."""
    from unikmer_tpu_torch.io import unik

    hashed = np.unique(rng.integers(0, 1 << 64, size=n + (n >> 4),
                                    dtype=np.uint64))
    files = {"2-bit": (23, unik.SORTED | unik.CANONICAL, a_codes[:n], []),
             "hashed": (31, unik.SORTED | unik.CANONICAL | unik.HASHED,
                        np.sort(rng.choice(hashed, n, replace=False)),
                        ["--hashed", "-k", "31"])}
    secs = {}
    for name, (k, flag, codes, dump_flags) in files.items():
        src = os.path.join(tmp, "rt.unik")
        with numpy_host():
            write_oracle(src, k, flag, codes)
        for extra in (["-n"], []):  # the plain text is dumped below
            texts = []
            for branch in ("native", "numpy"):
                txt = os.path.join(tmp, f"rt_{branch}.txt")
                with HOST_BRANCHES[branch]():
                    t0 = time.perf_counter()
                    run_cli(["view", *extra, src, "-o", txt])
                    secs[f"{name} view {' '.join(extra)} {branch}".replace(
                        "  ", " ")] = round(time.perf_counter() - t0, 4)
                texts.append(txt)
            if not same_bytes(*texts):
                raise SystemExit(f"round trip {name}: view {extra}: the native "
                                 f"text differs from numpy's")
        branches = ("native", "numpy") if name == "hashed" else ("native",)
        for branch in branches:
            back = os.path.join(tmp, f"rt_back_{branch}")
            with HOST_BRANCHES[branch]():
                t0 = time.perf_counter()
                run_cli(["dump", "-K", "-s", "-C", *dump_flags,
                         os.path.join(tmp, "rt_native.txt"), "-o", back])
                secs[f"{name} dump {branch}"] = round(
                    time.perf_counter() - t0, 4)
            if not same_bytes(back + ".unik", src):
                raise SystemExit(f"round trip {name}: dump ({branch}) differs "
                                 f"from the original file")
            os.remove(back + ".unik")
        for f in (src, *texts):
            os.remove(f)
    say("round trip view -> dump: native text and parse equal numpy's; "
        "seconds " + json.dumps(secs))
    return secs


def sets_path(tmp, rng, report: SetsReport, dev=None) -> None:
    """The library phase, the taxid phase and the CLI phase (module
    docstring), every result held exactly to its numpy oracle; the
    -T path's taxonomy is read from ``tmp``/taxdump."""
    from unikmer_tpu_torch import KmerSet
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.ops import device_sets
    from unikmer_tpu_torch.ops import sets as host_sets
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    dev = dev or torch.device("cuda", 0)
    report.admission.update(admission_budgets(dev))
    t0 = time.perf_counter()
    bases = set_bases(rng)
    fas = [os.path.join(tmp, f"set{n}.fa") for n in "ABC"]
    for fa, name, x in zip(fas, "ABC", bases):
        write_one_record(fa, name, x)
    t = [t0, time.perf_counter()]
    oracle = {}
    for name, x in zip("ABC", bases):
        oracle[name] = numpy_count(x, 23, True, "distinct")
    t.append(time.perf_counter())
    merged = merge_sets([oracle["A"], oracle["B"], oracle["C"]])
    oracle.update(set_oracles(merged))
    t.append(time.perf_counter())
    say(f"sets inputs: 3 x {len(bases[0])} bases, {len(oracle['A'])} / "
        f"{len(oracle['B'])} / {len(oracle['C'])} distinct 23-mers; made and "
        f"written {t[1] - t[0]:.3f} s, counted {t[2] - t[1]:.3f} s, set "
        f"oracles {t[3] - t[2]:.3f} s: " + json.dumps(
            {k: len(v) for k, v in oracle.items()}))
    del bases
    no_sort = {"k1": 0, "k2": 0, "k3": 0}
    one_k2 = {"k1": 0, "k2": 1, "k3": 0}

    def holds(name):
        def check(kset):
            want = oracle[name]
            if isinstance(want, tuple):
                want, taxids_want = want
            else:
                taxids_want = None
            same_set(name, kset.to_numpy(), want, kset.taxids_to_numpy(),
                     taxids_want)
            if kset.device != dev:
                raise SystemExit(f"sets {name}: result on {kset.device}")
            check_saved(tmp, name, kset, want, taxids_want)
        return check

    sets = {}
    for name, fa in zip("ABC", fas):
        sets[name] = report.op(
            f"from_fasta {name}",
            lambda fa=fa: KmerSet.from_fasta(fa, 23, canonical=True,
                                             device=dev),
            {"k1": 1, "k2": 1, "k3": 0}, holds(name))
    a, b, c = sets["A"], sets["B"], sets["C"]
    an, bn, cn = oracle["A"], oracle["B"], oracle["C"]
    report.op("A | B", lambda: a | b, one_k2, holds("A | B"),
              lambda: host_sets.union([an, bn]))
    report.op("A & B", lambda: a & b, no_sort, holds("A & B"),
              lambda: host_sets.intersect([an, bn]))
    report.op("A - B", lambda: a - b, no_sort, holds("A - B"),
              lambda: host_sets.subtract(an, None, [bn]))
    report.op("union_all", lambda: KmerSet.union_all([a, b, c]), one_k2,
              holds("union_all"), lambda: host_sets.union([an, bn, cn]))
    report.op("common 2", lambda: KmerSet.common([a, b, c], 2), one_k2,
              holds("common 2"), lambda: host_sets.common([an, bn, cn],
                                                          None, 2))
    # queries of known membership: 2^23 members of A, 2^22 members plus
    # one (searched in A), 2^22 codes past any 23-mer's; shuffled
    near = an[np.sort(rng.integers(0, len(an), size=1 << 22))] + np.uint64(1)
    q = np.concatenate([an[rng.integers(0, len(an), size=1 << 23)], near,
                        rng.integers(1 << 46, 1 << 47, size=1 << 22,
                                     dtype=np.uint64)])
    want_hits = np.concatenate([np.ones(1 << 23, bool), member_np(an, near)[1],
                                np.zeros(1 << 22, bool)])
    perm = rng.permutation(len(q))
    q, want_hits = q[perm], want_hits[perm]
    del near, perm

    def hits(name):
        def check(got):
            if not np.array_equal(got, want_hits):
                raise SystemExit(f"sets {name}: {int(got.sum())} hits "
                                 f"against the oracle's {int(want_hits.sum())}")
        return check

    # the host engine's membership of unsorted queries is numpy's
    # searchsorted on either branch (40 s for all 2^24 queries on the
    # card's host): timed over the first 2^20; DeviceMembership answers
    # the same
    report.op("contains 2^24", lambda: a.contains(q), no_sort,
              hits("contains"), lambda: host_sets.member_mask(an, q[:1 << 20]),
              ("numpy",))
    report.rows[-1]["host_queries"] = 1 << 20
    member = device_sets.DeviceMembership(an, device=dev)
    report.op("DeviceMembership 2^24", lambda: member.lookup(q), no_sort,
              hits("DeviceMembership"))
    report.rows[-1]["host_as"] = "contains 2^24"
    del member, q
    idx = np.arange(len(an))
    oracle["head"] = an[:1000]
    oracle["sample"] = an[(idx >= 3) & ((idx - 3) % 7 == 0)]
    oracle["filter"] = an[~low_complexity_oracle(an, 23)]
    report.op("head 1000", lambda: a.head(1000), no_sort, holds("head"))
    report.op("sample 3 7", lambda: a.sample(3, 7), no_sort, holds("sample"))
    report.op("filter_low_complexity", lambda: a.filter_low_complexity(),
              no_sort, holds("filter"))
    del c, sets

    # the taxid phase: per-code taxids from 512 nodes of the -T path's
    # tree, one unknown nonzero taxid in A
    d = os.path.join(tmp, "taxdump")
    taxdb = load_taxonomy(d)
    known = np.flatnonzero(taxdb.depth >= 0)
    pool = rng.choice(known[known > 0], 512, replace=False).astype(np.uint32)
    ta = rng.choice(pool, len(an)).astype(np.uint32)
    ta[len(ta) // 3] = TAX_NODES + 7  # unknown to the taxonomy
    tb = rng.choice(pool, len(bn)).astype(np.uint32)
    t0 = time.perf_counter()
    with numpy_host():
        oracle.update(taxid_set_oracles(an, ta, bn, tb, taxdb))
    say(f"sets taxid oracles: {time.perf_counter() - t0:.3f} s")
    at = KmerSet.from_codes(an, 23, canonical=True, taxids=ta, taxdb=taxdb,
                            assume_sorted_unique=True, device=dev)
    bt = KmerSet.from_codes(bn, 23, canonical=True, taxids=tb, taxdb=taxdb,
                            assume_sorted_unique=True, device=dev)
    report.op("A | B (taxids)", lambda: at | bt, {"k1": 0, "k2": 0, "k3": 1},
              holds("A | B (taxids)"),
              lambda: host_sets.union([an, bn], [ta, tb], taxdb), ("native",))
    report.op("A | B (one-sided)", lambda: at | b, one_k2,
              holds("A | B (one-sided)"),
              lambda: host_sets.union([an, bn],
                                      [ta, np.zeros(len(bn), np.uint32)],
                                      taxdb), ("native",))
    report.op("A & B (taxids)", lambda: at & bt, no_sort,
              holds("A & B (taxids)"),
              lambda: host_sets.intersect([an, bn], [ta, tb], taxdb),
              ("native",))
    report.op("A & B (one-sided)", lambda: at & b, no_sort,
              holds("A & B (one-sided)"),
              lambda: host_sets.intersect([an, bn], [ta, None], taxdb),
              ("native",))
    report.op("A - B (taxids)", lambda: at - bt, no_sort,
              holds("A - B (taxids)"),
              lambda: host_sets.subtract(an, ta, [bn]), ("native",))
    del a, b, at, bt

    # the CLI phase
    gtax = [int(t) for t in rng.choice(known[known > 2], 3, replace=False)]
    uniks = []
    for fa, name, t in zip(fas, "ABC", gtax):
        out = os.path.join(tmp, f"cli{name}")
        counted_cli(["count", "-k", "23", "-K", "-s", "-C", "-t", str(t), fa,
                     "-o", out], {"k1": True, "k2": True, "h1": False,
                                  "s1": False})
        uniks.append(out + ".unik")
        os.remove(fa)
    t0 = time.perf_counter()
    with numpy_host():
        cli_oracle = cli_setop_oracles(merged, gtax, taxdb)
    del bn, cn, oracle, merged
    written = {}
    for key, (codes, taxids) in cli_oracle.items():
        written[key] = os.path.join(tmp, f"cli_{key}.oracle.unik")
        with numpy_host():
            write_oracle(written[key], 23, unik.SORTED | unik.CANONICAL
                         | unik.INCLUDE_TAXID, codes, taxids)
    say(f"sets CLI oracles: {time.perf_counter() - t0:.3f} s")
    host_union_calls = []
    real_union = host_sets.union

    def spy(*args, **kw):
        host_union_calls.append(1)
        return real_union(*args, **kw)

    runs = (("union (table tier)", ["union", "-s"], "union", None),
            ("union (paths tier)", ["union", "-s"], "union", "0"),
            ("inter", ["inter"], "inter", None),
            ("diff", ["diff", "-s"], "diff", None),
            ("common -n 2", ["common", "-n", "2"], "common", None))
    for name, cmd, key, vocab_max in runs:
        out = os.path.join(tmp, "cliout")
        argv = [*cmd, "-C", "--data-dir", d, *uniks, "-o", out]
        if vocab_max is not None:
            os.environ["UNIKMER_TPU_TAXID_VOCAB_MAX"] = vocab_max
        host_sets.union = spy
        host_union_calls.clear()
        try:
            _, secs, launches, peak = counted(
                lambda: run_cli(argv),
                {"k1": 0, "k2": 0, "k3": 1 if key == "union" else 0}, name)
        finally:
            host_sets.union = real_union
            os.environ.pop("UNIKMER_TPU_TAXID_VOCAB_MAX", None)
        if key == "union" and host_union_calls:
            raise SystemExit(f"sets CLI {name}: the host engine ran")
        if not same_bytes(out + ".unik", written[key]):
            raise SystemExit(f"sets CLI {' '.join(argv)}: .unik differs from "
                             f"the oracle")
        for key_ in report.launches:
            report.launches[key_] += launches[key_]
        row = {"op": f"CLI {name}", "s": round(secs, 4), "peak_bytes": peak,
               "codes": len(cli_oracle[key][0]),
               "launches": {k: v for k, v in launches.items() if v}}
        report.rows.append(row)
        say(f"sets CLI {name}: {os.path.getsize(out + '.unik')} bytes equal "
            f"to the oracle; " + json.dumps(row))
        os.remove(out + ".unik")
        if name == "union (table tier)":
            device_s = secs
    # past the budget: the host engine, no K3
    out = os.path.join(tmp, "cliout")
    host_sets.union = spy
    host_union_calls.clear()
    try:
        with max_elems(1 << 20):
            _, secs, launches, peak = counted(
                lambda: run_cli(["union", "-s", "-C", "--data-dir", d, *uniks,
                                 "-o", out]),
                {"k1": 0, "k2": 0, "k3": 0}, "CLI union (forced host)")
    finally:
        host_sets.union = real_union
    if not host_union_calls or not same_bytes(out + ".unik",
                                               written["union"]):
        raise SystemExit("sets CLI union past the budget: not the host "
                         "engine, or not the oracle's bytes")
    os.remove(out + ".unik")
    report.forced_host("CLI union", secs, launches, peak, round(device_s, 4))
    t0 = time.perf_counter()
    grep_path(tmp, rng, an, uniks[0], gtax[0], dev)
    t1 = time.perf_counter()
    text_round_trip(tmp, rng, an)
    say("phase seconds: " + json.dumps({
        "grep": round(t1 - t0, 3),
        "round trip": round(time.perf_counter() - t1, 3)}))
    del an
    for u in uniks + list(written.values()):
        os.remove(u)


# ---------------------------------------------------------------------------
# P1/P2: the probe kernels against their plain versions, then their entry
# point


def u32_tensor(rng, shape, dev) -> torch.Tensor:
    """Random u32 bit patterns as int32, led by 0, 2^31-1, 2^31, 2^32-1."""
    x = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    flat = x.reshape(-1)
    flat[:4] = np.array([0, 2**31 - 1, 2**31, 2**32 - 1],
                        np.uint32)[:len(flat[:4])]
    return torch.from_numpy(x.view(np.int32)).to(dev)


def u32_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Max |a - b| over u32 bit patterns (0.0 when equal)."""
    if a.shape != b.shape:
        return float("inf")
    if torch.equal(a, b):
        return 0.0
    x = a.cpu().numpy().view(np.uint32).astype(np.int64)
    y = b.cpu().numpy().view(np.uint32).astype(np.int64)
    return float(np.abs(x - y).max())


def hold(name, kernel, plain, cases) -> float:
    """Every case through the kernel and its plain version, exactly."""
    err = 0.0
    for args in cases:
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        e = u32_err(got, want)
        if e:
            shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
            raise SystemExit(f"{name} mismatch on {shapes}: err={e}")
        err = max(err, e)
    return err


def turns_ms(fns: dict, rounds: int = TURNS, before=None) -> dict:
    """{name: quartiles} of the CUDA-event ms of every fn, timed in turns:
    each round runs them in order and then in reverse (library, kernel,
    kernel, library); ``before()`` runs ahead of each timing, outside the
    events."""
    from unikmer_tpu_torch.kernel_variants import turns_ms as in_turns

    return in_turns(fns, rounds, before)


def check_probes(dev, rng, first_row_cmpex):
    """The four probe kernels held to their plain versions at the
    scripts' sizes and at ragged ones, then timed at the scripts' sizes
    (P1a and P1c in turns with their library calls, P1b/P2a with
    ``first_row_cmpex``, its earlier design); returns one result dict per
    kernel."""
    from unikmer_tpu_torch.kernel_variants import kernels_per_call
    from unikmer_tpu_torch import probes as entry
    from unikmer_tpu_torch.ops import probes

    x1, blk = entry.probe_inputs(dev)
    rows = entry.ROWS
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    two_mib = 2 * blk.numel() * 4  # each probe reads and writes its block once
    out = {}

    err = hold("P1a copy_inc_u32", probes.copy_inc_u32,
               probes.copy_inc_u32_plain,
               [(x1,), (u32_tensor(rng, (65536, 128), dev),),
                (u32_tensor(rng, (3, 5), dev),), (u32_tensor(rng, (1,), dev),),
                (u32_tensor(rng, (7, 128), dev).reshape(-1)[1:],),
                (u32_tensor(rng, ((1 << 21) + 3,), dev),),
                (u32_tensor(rng, ((1 << 21) + 4,), dev)[1:],)])
    cold = dict(before=lambda: flush.fill_(1))  # L2 flushed each time
    t = turns_ms({"library": lambda: x1 + 1,
                  "kernel": lambda: probes.copy_inc_u32(x1)}, **cold)
    # the same after a read of the flush buffer: L2 then holds no dirty
    # lines that the copy's own lines must first write back
    clean = turns_ms({"library": lambda: x1 + 1,
                      "kernel": lambda: probes.copy_inc_u32(x1)},
                     before=lambda: flush.sum())
    out["P1a"] = dict(
        max_abs_err=err, ms=t["kernel"]["median"],
        ms_spread=t["kernel"]["spread"], library_ms=t["library"]["median"],
        library_ms_spread=t["library"]["spread"],
        ms_after_a_read_flush=clean["kernel"]["median"],
        library_ms_after_a_read_flush=clean["library"]["median"],
        plain_ms=cuda_ms(lambda: probes.copy_inc_u32_plain(x1), reps=10,
                         **cold),
        device_ms=device_ms(lambda: probes.copy_inc_u32(x1), "copy_inc"),
        bound_ms=bytes_ms(2 * x1.numel() * 4), bound_by="bytes")

    p1b = probes.p1b_distances(rows)
    p2a = {s: probes.p2a_distances(s, rows) for s in entry.P2A_STAGES}
    pow2_down = [1 << b for b in range(16, -1, -1)]
    row_cases = [(blk, p1b), *((blk, d) for d in p2a.values()),
                 (u32_tensor(rng, (37, 128), dev), [16, 8, 4, 2, 1, 16]),
                 (u32_tensor(rng, (5, 3), dev), [2, 1, 4]),
                 (u32_tensor(rng, (1, 128), dev), [1]),
                 (u32_tensor(rng, (300, 7), dev), [3] * 300),
                 (u32_tensor(rng, (1000, 6), dev), pow2_down[-10:]),
                 # above the first design's 40,960 rows
                 (u32_tensor(rng, (65537, 2), dev), [32768, 3, 1, 50000]),
                 (u32_tensor(rng, (1 << 17, 4), dev), pow2_down),
                 (u32_tensor(rng, (70001, 3), dev), pow2_down + [5, 5, 70000]),
                 (u32_tensor(rng, (P2A_BIG_ROWS, 128), dev),
                  probes.p2a_distances(64, P2A_BIG_ROWS))]
    err = hold("P1b/P2a row_cmpex_u32", probes.row_cmpex_u32,
               probes.row_cmpex_u32_plain, row_cases)
    hold("P1b/P2a earlier design", first_row_cmpex, probes.row_cmpex_u32_plain,
         [(blk, p1b), *((blk, d) for d in p2a.values())])
    schedules = {"p1b": p1b, **{f"p2a_{s}": d for s, d in p2a.items()}}
    row = {}
    for sched, ds in schedules.items():
        fns = {"kernel": lambda ds=ds: probes.row_cmpex_u32(blk, ds),
               "earlier design": lambda ds=ds: first_row_cmpex(blk, ds)}
        t = turns_ms(fns)
        row[sched] = dict(
            ms=t["kernel"]["median"], ms_spread=t["kernel"]["spread"],
            device_ms=device_ms(fns["kernel"], "row_cmpex"),
            kernels_per_call=kernels_per_call(fns["kernel"]),
            variants={"earlier design": dict(
                ms=t["earlier design"]["median"],
                ms_spread=t["earlier design"]["spread"],
                device_ms=device_ms(fns["earlier design"], "row_cmpex"),
                kernels_per_call=kernels_per_call(fns["earlier design"]))})
    out["P1b"] = dict(
        max_abs_err=err, **{k: v for k, v in row["p1b"].items()
                            if k != "variants"},
        plain_ms=cuda_ms(lambda: probes.row_cmpex_u32_plain(blk, p1b), 5),
        library_ms=None, bound_ms=bytes_ms(two_mib), bound_by="bytes",
        rows_held=sorted({int(x.shape[0]) for x, _ in row_cases}),
        variants=row["p1b"]["variants"],
        **{f"{k}_{s}": v for s, r in row.items() if s != "p1b"
           for k, v in r.items()})

    # 65,537 tiles (4.3 GB each way): past a grid's z extent of 65,535
    big = torch.arange(P1C_BIG_TILES * 128 * 128, dtype=torch.int32,
                       device=dev).view(-1, 128)
    misaligned = torch.empty(3 * 128 * 128 + 1, dtype=torch.int32, device=dev)
    misaligned = misaligned[1:].view(-1, 128).copy_(
        u32_tensor(rng, (3 * 128, 128), dev))
    err = hold("P1c transpose128_u32", probes.transpose128_u32,
               probes.transpose128_u32_plain,
               [(blk,), (u32_tensor(rng, (128, 128), dev),),
                (u32_tensor(rng, (3 * 128, 128), dev),), (misaligned,),
                (big,)])
    del big, misaligned
    library = (lambda: blk.view(rows // 128, 128, 128)
               .transpose(1, 2).contiguous())
    t = turns_ms({"library": library,
                  "kernel": lambda: probes.transpose128_u32(blk)})
    out["P1c"] = dict(
        max_abs_err=err, ms=t["kernel"]["median"],
        ms_spread=t["kernel"]["spread"], library_ms=t["library"]["median"],
        library_ms_spread=t["library"]["spread"],
        plain_ms=cuda_ms(lambda: probes.transpose128_u32_plain(blk), 20),
        device_ms=device_ms(lambda: probes.transpose128_u32(blk),
                            "transpose128"),
        bound_ms=bytes_ms(two_mib), bound_by="bytes",
        tiles_held=[1, 3, 32, P1C_BIG_TILES])

    err = hold("P2b lane_cmpex_u32", probes.lane_cmpex_u32,
               probes.lane_cmpex_u32_plain,
               [(blk,), (u32_tensor(rng, (1, 128), dev),),
                (u32_tensor(rng, (9, 128), dev),)])
    out["P2b"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: probes.lane_cmpex_u32(blk), 20),
        plain_ms=cuda_ms(lambda: probes.lane_cmpex_u32_plain(blk), 20),
        library_ms=None, bound_ms=bytes_ms(two_mib), bound_by="bytes",
        device_ms=device_ms(lambda: probes.lane_cmpex_u32(blk), "lane_cmpex"))
    for name, r in out.items():
        say(f"{name}: exact; " + ", ".join(
            f"{k} {v}" for k, v in r.items() if k != "max_abs_err"))
    return out


# ---------------------------------------------------------------------------
# the launch path: host cost of a wrapper call


def quartiles(v) -> dict:
    """Median and spread (the distance between the quartiles) of v."""
    q1, q2, q3 = statistics.quantiles(v, n=4, method="inclusive")
    return {"median": q2, "spread": q3 - q1}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of fn() over ``calls`` calls with no
    synchronize between them; the card is drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def host_us_turns(fns: dict, rounds: int = 15) -> dict:
    """{name: quartiles} of host_us(fn) over ``rounds`` readings of every
    fn, taken in turns (the order reversed every other round)."""
    for fn in fns.values():
        fn()
    got = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[name].append(host_us(fns[name]))
    return {name: quartiles(v) for name, v in got.items()}


OLD_STEPS = ("checks", "contiguous", "empty_like", "device context", "load",
             "stream lookup", "getattr", "ctypes call", "check")


def old_transpose_launch(x, skip=()):
    """transpose128_u32(x) as its launch path stood before the launch
    helper of _kernels.py, step by step (ops/probes.py before it): each
    step named in ``skip`` is left out, its result taken from one call
    made ahead."""
    from unikmer_tpu_torch import _kernels
    from unikmer_tpu_torch.ops import probes

    name = "ukt_transpose128_u32"
    tiles = x.shape[0] // 128
    lib = _kernels.load()
    fn = getattr(lib, name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    out0 = torch.empty_like(x)

    def body(xc, out):
        lib_ = lib if "load" in skip else _kernels.load()
        if "stream lookup" in skip:
            s = stream
        else:
            s = torch.cuda.current_stream(torch.cuda.current_device()).cuda_stream
        f = fn if "getattr" in skip else getattr(lib_, name)
        err = 0 if "ctypes call" in skip else f(xc.data_ptr(), out.data_ptr(),
                                                  tiles, s)
        if "check" not in skip:
            _kernels.check(lib_, err, name)

    def call():
        if "checks" not in skip:
            t = probes._check_tiles("transpose128_u32", x)
            if x.device.type == "cpu" or t > 65535 or t == 0:
                raise ValueError("not a launch")
        xc = x if "contiguous" in skip else x.contiguous()
        out = out0 if "empty_like" in skip else torch.empty_like(xc)
        if "device context" in skip:
            body(xc, out)
        else:
            with torch.cuda.device(xc.device):
                body(xc, out)
        return out

    return call


def smi_clocks(when: str) -> None:
    """Print the card's clocks and power draw as nvidia-smi reads them."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    say(f"clocks {when}: {q.stdout.strip()}")


def launch_breakdown(blk) -> dict:
    """The host cost of one transpose128_u32(blk), the P1c probe's call,
    in HOST_CALLS un-synchronised calls a reading, all readings in turns:
    the launch path as it stood before the launch helper, that path with
    each of its steps left out (a step's cost is the difference), the
    wrapper as it is, the library call, and the torch primitives a
    launch path may use.  Prints one line a reading; returns them."""
    from unikmer_tpu_torch.ops import probes

    fns = {"old path": old_transpose_launch(blk)}
    fns.update({f"old path without {s}": old_transpose_launch(blk, {s})
                for s in OLD_STEPS})
    fns["wrapper as built"] = lambda: probes.transpose128_u32(blk)
    fns["library call"] = (
        lambda: blk.view(-1, 128, 128).transpose(1, 2).contiguous())
    fns["torch.cuda.current_device()"] = torch.cuda.current_device
    fns["torch.cuda.current_stream(0).cuda_stream"] = (
        lambda: torch.cuda.current_stream(0).cuda_stream)
    for prim, args in (("_cuda_getDevice", ()),
                       ("_cuda_getCurrentRawStream", (0,))):
        f = getattr(torch._C, prim, None)
        say(f"torch._C.{prim}: {'present' if f else 'absent'}")
        if f is not None:
            fns[f"torch._C.{prim}{args}"] = lambda f=f, a=args: f(*a)
    smi_clocks("before the launch breakdown")
    got = host_us_turns(fns)
    smi_clocks("after it")
    full = got["old path"]["median"]
    for name, q in got.items():
        step = (f"; step {full - q['median']:.3f} us"
                if name.startswith("old path without") else "")
        say(f"host us/call {name}: {q['median']:.3f} "
            f"(spread {q['spread']:.3f}){step}")
    return got


def host_costs(dev, rng) -> dict:
    """host_us of every wrapper: host microseconds per call over
    HOST_CALLS un-synchronised calls, the median of 15 readings in turns,
    at inputs where the card keeps up with the host, so the reading is
    the launch path's: P1c and P2b at the probe's (4096, 128) block, the
    others at a few thousand elements.  K2 and K3 read their pass flags
    back in every call, so theirs holds one round trip to the card."""
    from unikmer_tpu_torch import probes as entry
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops import probes
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.nthash import encode_nthash
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_sort_kv_u64, radix_sort_u64,
    )
    from unikmer_tpu_torch.ops.sketch import sketch_select

    n = 4097
    p2, vm = (torch.from_numpy(a).to(dev)
              for a in pack_bases_2bit(random_bases(rng, n)))
    keys = torch.from_numpy(rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
                            .view(np.int64)).to(dev)
    vals = u32_tensor(rng, (n,), dev)
    small = u32_tensor(rng, (32, 128), dev)
    kk, kv = encode_nthash(p2, vm, n, SKETCH_K, True)
    _, blk = entry.probe_inputs(dev)
    ds = probes.p2a_distances(4, 32)
    smi_clocks("before host_us")
    got = host_us_turns({
        "k1": lambda: encode_2bit(p2, vm, n, 23, True),
        "h1": lambda: encode_nthash(p2, vm, n, 31, True),
        "s1": lambda: sketch_select("minimizer", kk, SKETCH_W, kv),
        "k2": lambda: radix_sort_u64(keys, 46),
        "k3": lambda: radix_sort_kv_u64(keys, vals, 46),
        "P1a": lambda: probes.copy_inc_u32(small),
        "P1b": lambda: probes.row_cmpex_u32(small, ds),
        "P1c": lambda: probes.transpose128_u32(blk),
        "P2b": lambda: probes.lane_cmpex_u32(blk)})
    smi_clocks("after it")
    say("host us/call by wrapper: " + json.dumps(got))
    return {k: q["median"] for k, q in got.items()}


def probe_path():
    """``python -m unikmer_tpu_torch.probes`` in this process, its launch
    counters zeroed just before and read just after."""
    from unikmer_tpu_torch import probes as entry
    from unikmer_tpu_torch.ops import probes

    wrappers = {"P1a": probes.copy_inc_u32, "P1b": probes.row_cmpex_u32,
                "P1c": probes.transpose128_u32, "P2b": probes.lane_cmpex_u32}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    if entry.main([]) != 0:
        raise SystemExit("the probe entry point failed")
    secs = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if min(launches.values()) < 1:
        raise SystemExit(f"the probe path skipped a kernel: {launches}")
    say(f"probe path: {secs:.3f} s, launches {launches}")
    return launches


KERNELS = (  # (key, name, source, the TPU kernel it replaces, also)
    ("k1", "K1 encode_2bit", "unikmer_tpu_torch/csrc/encode.cu",
     "unikmer_tpu/ops/pallas_encode.py:79", []),
    ("h1", "H1 encode_nthash", "unikmer_tpu_torch/csrc/nthash.cu",
     "unikmer_tpu/ops/nthash.py:68 nthash_windows (XLA, no Pallas kernel)",
     ["unikmer_tpu/models/count.py:278", "unikmer_tpu/models/count.py:195-197"]),
    ("s1", "S1 sketch_select", "unikmer_tpu_torch/csrc/sketch.cu",
     "unikmer_tpu/ops/sketch.py:42 _window_argmin and :67 _window_all (XLA, "
     "no Pallas kernel)",
     ["unikmer_tpu/ops/sketch.py:79-98", "unikmer_tpu/ops/sketch.py:205-221",
      "unikmer_tpu/models/count.py:205-207"]),
    ("k2", "K2 radix_sort_u64", "unikmer_tpu_torch/csrc/radix_sort.cu",
     "unikmer_tpu/ops/pallas_sort.py:235", []),
    ("k3", "K3 radix_sort_kv_u64", "unikmer_tpu_torch/csrc/radix_sort.cu",
     "unikmer_tpu/ops/pallas_sort.py:399", []),
    ("P1a", "P1a copy_inc_u32", "unikmer_tpu_torch/csrc/probes.cu",
     "scripts/exp_pallas_dma.py:54", ["scripts/exp_pallas_dma2.py:49"]),
    ("P1b", "P1b+P2a row_cmpex_u32", "unikmer_tpu_torch/csrc/probes.cu",
     "scripts/exp_pallas_dma.py:101", ["scripts/exp_pallas_dma2.py:96"]),
    ("P1c", "P1c transpose128_u32", "unikmer_tpu_torch/csrc/probes.cu",
     "scripts/exp_pallas_dma.py:130", []),
    ("P2b", "P2b lane_cmpex_u32", "unikmer_tpu_torch/csrc/probes.cu",
     "scripts/exp_pallas_dma2.py:137", []),
)


def main() -> int:
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from unikmer_tpu_torch import _kernels, native
    except ImportError as e:
        say(f"chip_smoke: cannot import the package unikmer_tpu_torch ({e}); "
            f"run it from the root of the repository")
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    say(smi.stdout.strip().splitlines()[0])
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    _kernels.load()
    say(f"kernel build+load seconds: {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    say(f"host engine: {native.engine()} "
        f"(build+load {time.perf_counter() - t0:.3f} s); the oracles: numpy")
    from unikmer_tpu_torch import kernel_variants as kv
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.probes import row_cmpex_u32

    t0 = time.perf_counter()
    pr5 = kv.build([kv.EARLIER_K1, kv.EARLIER_ROW_CMPEX])
    say(f"the earlier designs of K1 and row_cmpex_u32 built in "
        f"{time.perf_counter() - t0:.3f} s")
    results = {
        "k1": check_k1(dev, rng, kv.using(pr5[kv.EARLIER_K1], encode_2bit)),
        "h1": check_h1(dev, rng), "s1": check_s1(dev, rng),
        "k2": check_k2(dev, rng), "k3": check_k3(dev, rng),
        **check_probes(dev, rng,
                       kv.using(pr5[kv.EARLIER_ROW_CMPEX], row_cmpex_u32))}
    from unikmer_tpu_torch import probes as entry

    launch_breakdown(entry.probe_inputs(dev)[1])
    for key, us in host_costs(dev, rng).items():
        results[key]["host_us"] = us
    report = SetsReport()
    with tempfile.TemporaryDirectory(prefix="unikmer-torch-smoke-") as tmp:
        t0 = time.perf_counter()
        launches = main_path(tmp, rng, report)
        t = [time.perf_counter()]
        launches["k3"] = taxid_path(tmp, rng)
        t.append(time.perf_counter())
        linear_hashed_path(tmp, rng)
        compat_path(tmp, rng)
        t.append(time.perf_counter())
        sets_path(tmp, rng, report)
        t.append(time.perf_counter())
    say(f"path seconds: main {t[0] - t0:.3f}, count -T {t[1] - t[0]:.3f}, "
        f"-l and compat {t[2] - t[1]:.3f}, sets {t[3] - t[2]:.3f}")
    say(json.dumps({"sets": report.rows}))
    say(json.dumps({"admission": report.admission}))
    launches["k2"] += report.launches["k2"]
    launches["k3"] += report.launches["k3"]
    launches.update(probe_path())
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         **({"also_replaces": also} if also else {}),
         "launches": launches[key], **results[key]}
        for key, name, source, replaces, also in KERNELS]}))
    say(f"chip_smoke total seconds: {time.perf_counter() - start:.3f}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
