"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 encode, H1 ntHash encode, S1 sketch
window select, K2 radix sort, K3 key+value radix sort, and the four P1/P2
probe kernels) from unikmer_tpu_torch/csrc, holds each against its plain
PyTorch version on the card (exact equality), then drives the port's
paths and holds their results against oracles:

  count     ``count -k 23 -K -s -C`` over a 134 Mbp FASTA of 4 records,
            and over the same FASTA bench.py's two ntHash configurations,
            ``count -k 31 -K -H -s -C`` and ``count -k 31 -K -D 15 -s -C``,
            and its two sketch configurations, ``count -k 31 -W 15 -s -C``
            and ``count -k 31 -S 16 -s -C`` (and -u, -d, k = 32 and
            k = 64 -H -u over one 50 Mbp record);
  count -T  over a synthetic 100,000-node taxonomy written as nodes.dmp:
            T1, 8,192 records of 4,000 bases, each with its own taxid,
            one piece of ~2^25 windows on the 'paths' LCA tier, 2-bit,
            hashed (T1H, k = 31 -H) and sketched (T1W, k = 31 -W 15);
            T2, 1,024 records of 98,304 bases with 512 taxids, streamed
            in pieces on the 'table' tier; T3, k = 32 -u over two 1 Mbp records, keeping a real
            2^64-1 code with its taxid;
  count -l  ``count -k 27 -K -l -H -C`` and ``count -k 23 -W 5 -l -C``
            over two 1 Mbp records;
  compat    ``count -k 31 -S 16 --syncmer-impl compat -s -C`` over 1,200
            records of 1 to 7,000 bases;
  probes    ``python -m unikmer_tpu_torch.probes``: P1a-P2b at the sizes
            of scripts/exp_pallas_dma*.py, each kernel held to its plain
            version inside the entry point.

The launch counters, zeroed before each path's run and read after it,
show that the run went through the kernels of its path (and that a
hashed run launched H1 and no K1).  P1a and P1c are timed in turns with
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
T2_TAXIDS, T2_BASES = 512, 98304  # two records each: the table tier
T3_BASES = 1 << 20
RECORD_BASES = 1 << 25
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


def canonical_np(codes: np.ndarray, k: int) -> np.ndarray:
    """min(code, reverse complement) of 2-bit codes of k bases: the
    complement is ~code on each 2-bit group, and the 32 groups of the
    64-bit word are reversed by five swaps, which moves the k real groups
    to the top 2k bits."""
    x = ~codes
    for shift, mask in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                        (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                        (32, 0x00000000FFFFFFFF)):
        s, m = np.uint64(shift), np.uint64(mask)
        x = ((x >> s) & m) | ((x & m) << s)
    return np.minimum(codes, x >> np.uint64(64 - 2 * k))


def numpy_windows(bases: np.ndarray, k: int, canonical: bool):
    """(codes, positions) of every valid 2-bit window, straight numpy
    (independent of the port)."""
    m = len(bases) - k + 1
    if m <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    codes = np.zeros(m, np.uint64)
    two = np.uint64(2)
    for j in range(k):
        codes <<= two
        codes |= (bases[j:j + m] & 3).astype(np.uint64)
    bad = np.concatenate([[0], np.cumsum(bases >= 4, dtype=np.int64)])
    pos = np.flatnonzero(bad[k:] - bad[:m] == 0)
    codes = codes[pos]
    if canonical:
        codes = canonical_np(codes, k)
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
                 scale: int = 1, number: int | None = None) -> None:
    """The oracle's codes through the port's UnikWriter, with the CLI's
    writer settings for -C (``number`` -1 for -l, which leaves the count
    out of the header)."""
    from unikmer_tpu_torch.io import unik

    with open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag,
            number=len(codes) if number is None else number, compress=False,
            compression_level=5, threads=min(os.cpu_count() or 4, 4),
            global_taxid=0, scale=scale, max_taxid=(1 << 32) - 1) as w:
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


def main_path(tmp, rng):
    """The 134 Mbp CLI count, 2-bit, then hashed (bench.py's two ntHash
    configurations) and sketched (its two sketch configurations), then
    -u, -d, k = 32 and k = 64 -H -u over one 50 Mbp record; returns the
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
    hashed, bases, keyed, valid = hashed_main_path(tmp, fa)
    sketched = sketch_main_path(tmp, fa, bases, keyed, valid)
    del bases, keyed, valid
    os.remove(fa)
    one = os.path.join(tmp, "one.fa")
    write_fasta(one, rng, 1, RECORD_BASES + (RECORD_BASES >> 1))
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
    with tempfile.TemporaryDirectory(prefix="unikmer-torch-smoke-") as tmp:
        launches = main_path(tmp, rng)
        launches["k3"] = taxid_path(tmp, rng)
        linear_hashed_path(tmp, rng)
        compat_path(tmp, rng)
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
