"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 encode, H1 ntHash encode, S1 sketch
window select, K2 radix sort, K3 key+value radix sort, C1 collapse and
compaction, and the four P1/P2 probe kernels) from unikmer_tpu_torch/csrc, holds each against its plain
PyTorch version on the card (exact equality), then drives the port's
paths (count, the set operations, the file and genome commands) and
holds their results against oracles:

  count     ``count -k 23 -K -s -C`` over a 134 Mbp FASTA of 4 records,
            and over the same FASTA bench.py's two ntHash configurations,
            ``count -k 31 -K -H -s -C`` and ``count -k 31 -K -D 15 -s -C``,
            and over its first two records its two sketch configurations,
            ``count -k 31 -W 15 -s -C`` and ``count -k 31 -S 16 -s -C``
            (and -u, -d, k = 32 and
            k = 64 -H -u over one 37.7 Mbp record, 2 pieces);
  pipeline  right after the count: K2 and K3 at 2^25 keys in every case
            of their pass plan (every pass, the top three digits shared,
            one pass, all keys equal), exact against their plain versions
            with the passes run and skipped of the numpy reckoning of the
            constant digits; count_packed_dispatch (2-bit, -H, -W 15, the
            -u dual dispatch; the compat syncmer reported) and K2/K3 alone
            under torch.cuda.set_sync_debug_mode("error"); the 134 Mbp
            ``count -k 23 -K -s -C`` and ``-k 31 -K -H``, ``-k 31 -W 15``
            of its first two records and ``-k 23 -K -l -C`` of the
            37.7 Mbp record (2 pieces each), unrecorded at
            UNIKMER_TPU_PIPELINE_DEPTH 0, 1, 1, 0, byte-equal to the
            oracles, each with its wall seconds, peak device memory and,
            from one torch.profiler trace a depth, the card's busy share;
            the 134 Mbp count written gzipped and read back by read_all()
            with the parallel inflate, by members (stream=True) and with
            UNIKMER_TPU_INFLATE_CAP=0 in turns, and a ``union`` of the
            gzipped file (``pipeline_path``, the ``pipeline`` line);
  start-up  fresh processes of the CLI (``python -c`` around its main()):
            ``num``, ``info`` and ``view`` of the 134 Mbp .unik, none of
            which may import torch; ``count -k 23 -K -s -C`` at 4, 32 and
            134 Mbp with UNIKMER_TPU_HOST_COUNT 0 and 1 (device, host,
            host), every output equal to the numpy oracle's, the
            host route's processes without torch, each device process
            launching K1 and K2; the resident server (--warm --pretouch)
            answering the 134 Mbp count, ``union`` and ``view`` through
            the client as local calls do, element_budget("union") read
            before and after, then stopped by SIGTERM; and one device
            count under UNIKMER_TPU_PROFILE, whose Chrome trace must name
            K1's and K2's kernels (``startup_path``, the ``startup``
            line);
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
            2^24-base records A, B and C that share large parts; then
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
            q.unik holding 2^21 codes of known membership, half of them
            A's; and ``view`` -> ``dump`` over a 2^20-code 2-bit and a
            2^20-code hashed file (the native text functions against
            numpy and the original bytes).
            Every result and every saved ``.unik`` is held exactly to
            numpy (one stable sort merges the sorted sets with a bit a
            set, ``merge_sets``, from which union, intersection,
            difference and the codes held by 2 of 3 are read; queries of
            known membership; the LCA by the port's host Taxonomy), and
            each operation is timed (CUDA events, 5 runs) beside the
            host engine (ops/sets, native and numpy; not for the taxid
            operations) in the ``sets`` line;
  file commands
            over the sets path's ``count -t`` files of A, B and C (about
            3.3 x 10^7 codes each) and T2's ``count -T`` output: ``sort -u
            -I`` in memory and with ``-m 8M -M 4`` (a cascade, gzip
            temporaries), ``split -m 8M -u -I`` then ``merge -D -u -I -M
            4`` (sort -m's bytes), ``sort -d -I``, ``sort -u`` of A's and
            B's codes with the taxid phase's per-code taxids (its LCA
            oracle), ``tsplit`` of T2, ``rfilter -E species`` and ``-L
            genus`` on a copy of the tree ranked by depth, ``head -n
            1048576``, ``sample -s 3 -w 7`` and ``filter`` (its mask on
            the card) of A, each held to numpy (``file_commands_path``)
            and timed in the ``file_commands`` line;
  genome    over the sets path's record A: ``locate -g A`` of 2^20 codes
            of ``diff A B`` (linear, ``--circular``, and from two files
            that share codes; and once with UNIKMER_TPU_MAX_ELEMS below
            A's windows, the index sorted on the host), ``map -m 200``
            of all of ``diff A B`` over A (``-x 5 -X 2``, ``-M``, ``-a``)
            and over 1,024 records cut from A (without and with ``-W``,
            and once forced past map's budget: the host route),
            ``count -k 31 -K -H`` of A and ``view -g A`` of 2^20 of its
            hashes and 16 that A lacks; every output held to numpy's
            bytes (``genome_path``), each call's seconds, index stages,
            peak, windows and route in the ``genome`` line;
  surface   the library snippet of docs/USAGE.md (``from
            unikmer_tpu_torch import CountConfig, count_packed,
            pack_files, UnikReader, UnikWriter``) on the card over a
            seeded 2^24-base FASTA, k = 23 canonical, against the numpy
            count, with the reader's and writer's accessors;
            ``sort_codes`` against torch.sort of 2^25 keys (64 and 46
            bits, the latter's pass count from ``sort_code_bits``) and
            ``sort_codes_taxids`` against numpy's lexsort of 2^24
            pairs; ``union -s -C`` of two small seeded taxid .unik files
            in fresh processes under UNIKMER_TPU_DEVICE_TAXID auto (the
            host engine, no torch), 1 (K3) and 0, and ``count -T`` of T1
            under 0 (no K3) and auto, all byte-equal to their oracles;
            a ``count`` with UNIKMER_TPU_PROFILE_STREAM=1 whose stderr
            holds the report and one without, whose stderr is empty
            (``surface_path``, the ``surface`` line);
  mesh      parallel/sharded.py with 4 shards on the card
            (``make_mesh(devices=[cuda:0] * 4)``): ``count --mesh 1 -k 23
            -K -s -C`` of the 134 Mbp FASTA through the CLI, byte-equal
            to the main path's .unik; mesh_count_stream_packed over it
            (distinct and -d) and over its first record (-k 31 -K -H and
            -k 31 -W 15); mesh_count_taxids over T1 and T2; mesh_set_op
            (union, inter, diff, common 2) and mesh_set_op_taxids (both
            LCA tiers) over the sets path's A, B and C; and the CLI's
            ``union``, ``inter``, ``diff`` and ``common -n 2`` with
            ``--mesh 1``, byte-equal to their --mesh 0 outputs.  Each
            output is held to its single-device twin's (``mesh_path``),
            each run timed with its peak beside the twin in the ``mesh``
            line;
  distributed
            pipeline/distributed.py in rank processes of this script
            (``chip_smoke.py --rank``), 4 shards in all: one NCCL rank
            with 4 shards on the card, ``sharded_count_distinct -k 23
            -K`` of the main FASTA written as 4 files, and
            ``sharded_union_counts`` / ``sharded_union_taxids`` of the
            sets path's A and B; two gloo ranks sharing the card, 2
            shards each, for the same count, ``-k 31 -W 15`` of the
            first file alone (the second rank reads none) and T1's -T
            build from its global rows.  Each shard is held to its range
            of the main path's .unik, the single-device output or
            KmerSet's union; each rank prints its start-up split
            (interpreter and imports, CUDA context, kernel load,
            init_process_group), its stages and peak, and the
            ``distributed`` line times each run beside its
            single-process twin (``distributed_path``);
  probes    ``python -m unikmer_tpu_torch.probes``: P1a-P2b at the sizes
            of scripts/exp_pallas_dma*.py, each kernel held to its plain
            version inside the entry point.

The launch counters, zeroed before each path's run (and before each set
operation) and read after it, show that the run went through the kernels
of its path (and that a hashed run launched H1 and no K1; that ``|``
(the one-sided taxid union too), ``union_all`` and ``common`` launched
K2 once, ``&``, ``-`` and the per-set transforms no sort,
and the CLI's taxid union K3 and no host reduction).  P1a and P1c are
timed in turns with their library calls (library, kernel, kernel,
library; TURNS timings each), S1 with torch.argmin over an unfold view
of its keys (``unfold_argmin``), H1 with K1 at the same k.  The host
cost of every wrapper's launch path is read as host microseconds per
call over HOST_CALLS un-synchronised calls (``host_us`` in the kernels
line).

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

Every phase but the start-up one runs count's device route
(UNIKMER_TPU_HOST_COUNT=0; the compat run without the native library,
so on its device twin), and every phase but the surface one the device
taxid union (UNIKMER_TPU_DEVICE_TAXID=1).  An early ``machine:`` line
names the driver, the CUDA versions, the card's uncorrected ECC errors,
its UUID and the host.

Exits non-zero, printing no result, without a CUDA device or outside
the repository.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
import functools
import gzip
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
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
SETS_BASES = 1 << 24  # each of the sets path's records A, B and C
LINEAR_BASES = 1 << 20  # the -l -H and -l -W runs' two records
SKETCH_K, SKETCH_W, SKETCH_S = 31, 15, 16  # bench.py's sketch cells
COMPAT_RECORDS, COMPAT_MAX_BASES = 1200, 7000  # the compat run's input
LINE = 60
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
FLUSH_BYTES = 256 << 20  # written between P1a's repetitions: > the 50 MB L2
HOST_CALLS = 1000  # un-synchronised wrapper calls in one host-cost reading
TURNS = 40  # timings of each kernel and library call in turns
P1C_BIG_TILES = 65537  # more tiles than a grid's z extent holds
P2A_BIG_ROWS = 1 << 16  # P2A's 64 stages over 16 row bits: tile and registers


def say(*a):
    print(*a, flush=True)


def quartiles(v) -> dict:
    """Median and spread (the distance between the quartiles) of v, as
    numpy's linear percentiles; one value is its own median, spread 0."""
    if len(v) == 1:
        return {"median": v[0], "spread": 0.0}
    q1, q2, q3 = statistics.quantiles(v, n=4, method="inclusive")
    return {"median": q2, "spread": q3 - q1}


def turns_ms(fns: dict, timings: int = TURNS, before=None) -> dict:
    """{name: quartiles} of the CUDA-event ms of every fn over ``timings``
    timings each, after a warm-up, taken in turns: the fns in order and
    then in reverse (library, kernel, kernel, library); ``before()`` runs
    ahead of each timing, outside the events."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    got = {name: [] for name in fns}
    for r in range(timings):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
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


def cuda_ms(fn, reps: int = 5, before=None) -> float:
    """Median CUDA-event milliseconds of fn() over reps, after a warm-up
    (turns_ms of fn alone)."""
    return turns_ms({"fn": fn}, reps, before)["fn"]["median"]


def ms_spread(fn) -> dict:
    """CUDA-event ms of fn() as the kernels-line keys ms (the median of
    10 timings) and ms_spread (the distance between quartiles)."""
    t = turns_ms({"kernel": fn}, 10)["kernel"]
    return dict(ms=t["median"], ms_spread=t["spread"])


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device milliseconds per call of fn() spent in the CUDA kernels
    whose name holds ``kernel``, from torch.profiler: the kernel's own
    time, without the host's launch overhead that the CUDA events around
    a short call also hold.  A reading may record fewer such kernels than
    the calls launched (lost events): it is taken as the mean of the
    kernels it recorded times the whole number of them a call.  None when
    the profiler records no device time."""
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
        return None
    per_call = sum(e.count for e in events) / reps
    return total_us / reps / 1e3 * max(round(per_call), 1) / per_call


def kernels_per_call(fn) -> int:
    """The kernels one row_cmpex_u32 call of fn() launches, from the
    wrapper's ``.kernels`` count over 10 calls."""
    from unikmer_tpu_torch.ops.probes import row_cmpex_u32

    calls = 10
    k0, l0 = row_cmpex_u32.kernels, row_cmpex_u32.launches
    for _ in range(calls):
        fn()
    kernels, launches = row_cmpex_u32.kernels - k0, row_cmpex_u32.launches - l0
    if launches != calls or kernels % calls:
        raise RuntimeError(f"{kernels} kernels in {launches} launching calls "
                           f"of {calls}")
    return kernels // calls


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


def check_k1(dev, rng):
    """K1 held to its plain version at every length of k1_lengths, then
    timed in turns canonical and not."""
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
                kk, kv = encode_2bit(p2, vm, n, k, canonical)
                torch.cuda.synchronize()
                e = abs_err(kk, pk)
                err = max(err, e)
                cases += 1
                if e or not torch.equal(kv, pv):
                    i = int(torch.nonzero((kk != pk) | (kv != pv))[0])
                    raise SystemExit(
                        f"K1 mismatch: n={n} k={k} canonical={canonical} "
                        f"err={e}; first differing window {i}: kernel code "
                        f"{int(kk[i]) & (2**64 - 1):#x} valid {int(kv[i])}, "
                        f"plain code {int(pk[i]) & (2**64 - 1):#x} valid "
                        f"{int(pv[i])}")
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
           "kernel, not canonical": lambda: encode_2bit(p2, vm, n, 23, False)}
    t = turns_ms(fns)
    plain_ms = cuda_ms(lambda: encode_2bit_plain(p2, vm, n, 23, True))
    # packed bases and mask read once, the u64 codes and bool flags written
    bound = bytes_ms(p2.numel() + vm.numel() + 9 * n)
    dms = {name: device_ms(fn, "encode_2bit") for name, fn in fns.items()}
    say(f"K1 encode_2bit: exact on {cases + 1} cases (n in {ns}); n={n} "
        f"k=23 canonical, in turns: "
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


def c1_inputs(rng, n: int):
    """(sorted keys, mask) shaped like the main path's union_all of m
    genome sets: 60% of the slots members (each code about 8 times, as
    clades share their core), the rest the sentinel padding; a mask that
    keeps half the slots (an intersect's hits)."""
    m = int(n * 0.6)
    keys = np.full(n, SENT)
    keys[:m] = np.sort(rng.integers(0, 1 << 46, size=m // 8 + 1,
                                    dtype=np.uint64)[
        rng.integers(0, m // 8 + 1, size=m)])
    return keys, rng.random(n) < 0.5


def check_c1(dev, rng):
    """C1 held to its plain version at lengths around a tile and past a
    look-back window, in every mode; then timed at 2^25 slots (distinct,
    as union_all runs it; the threshold of common at 58 of 64 sets and
    the mask with an int32 aux column beside it)."""
    from unikmer_tpu_torch import _kernels
    from unikmer_tpu_torch.ops.collapse import collapse_pass, collapse_plain

    tile = _kernels.load().ukt_collapse_tile()
    ns = (0, 1, tile - 1, tile, tile + 1, 40 * tile + 3, (1 << 20) + 3)
    cases = 0
    for n in ns:
        keys, mask = c1_inputs(rng, n)
        x = torch.from_numpy(keys.view(np.int64)).to(dev)
        m = torch.from_numpy(mask).to(dev)
        aux = torch.from_numpy(rng.integers(0, 1 << 31, size=n).astype(
            np.int32)).to(dev)
        nsr = torch.tensor(min(n, 1), device=dev)  # at most n real codes
        for mode, kw in (("distinct", {}), ("unique", {}), ("repeated", {}),
                         ("distinct", dict(n_sent_real=nsr)),
                         ("threshold", dict(threshold=3)),
                         ("threshold", dict(threshold=tile + 1)),
                         ("mask", dict(mask=m)),
                         ("mask", dict(mask=m, aux=aux))):
            got = collapse_pass(x, mode, **kw)
            want = collapse_plain(x, mode, **kw)
            torch.cuda.synchronize()
            cases += 1
            if not (torch.equal(got[0], want[0]) and int(got[2]) == int(
                    want[2]) and (got[1] is None or torch.equal(got[1],
                                                                want[1]))):
                raise SystemExit(f"C1 mismatch: n={n} mode={mode} {kw}")
    n = 1 << 25
    keys, mask = c1_inputs(rng, n)
    x = torch.from_numpy(keys.view(np.int64)).to(dev)
    m = torch.from_numpy(mask).to(dev)
    aux = torch.from_numpy(rng.integers(0, 1 << 31, size=n).astype(
        np.int32)).to(dev)
    fns = {"distinct": lambda: collapse_pass(x, "distinct"),
           "threshold 58": lambda: collapse_pass(x, "threshold",
                                                 threshold=58),
           "mask with int32 aux": lambda: collapse_pass(x, "mask", mask=m,
                                                        aux=aux)}
    t = turns_ms(fns)
    dms = {name: device_ms(fn, "collapse_") for name, fn in fns.items()}
    plain_ms = cuda_ms(lambda: collapse_plain(x, "distinct"))
    # the keys read once and the output (kept keys, then the tail)
    # written once; the mask adds 1 B a slot and the aux 8 B (read and
    # written)
    bound = bytes_ms(16 * n)
    bounds = {"distinct": bound, "threshold 58": bound,
              "mask with int32 aux": bytes_ms(25 * n)}
    say(f"C1 collapse_pass: exact on {cases} cases (n in {ns}); n=2^25, in "
        "turns: " + "; ".join(
            f"{name} {t[name]['median']} ms (spread {t[name]['spread']}, "
            f"device {dms[name]}, bound {bounds[name]} ms, "
            f"{bounds[name] / dms[name]:.1%} of it by device time)"
            if dms[name] else f"{name} {t[name]['median']} ms"
            for name in fns)
        + f"; plain distinct {plain_ms} ms")
    return dict(max_abs_err=0.0, ms=t["distinct"]["median"],
                ms_spread=t["distinct"]["spread"],
                device_ms=dms["distinct"], plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None,
                lengths_held=list(ns),
                modes={name: dict(ms=t[name]["median"],
                                  ms_spread=t[name]["spread"],
                                  device_ms=dms[name],
                                  bound_ms=bounds[name])
                       for name in fns if name != "distinct"})


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
    native code with the CLI it checks.  The main path's large oracles
    compute their codes here and are written outside it, by the native
    writer, which tests/test_torch_host.py holds byte-equal to the numpy
    branch's."""
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
    write_oracle(out, k, unik.SORTED | (unik.CANONICAL if canonical else 0)
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
    from unikmer_tpu_torch.ops.collapse import collapse_pass
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
                         hashed=False, codes=None):
    """``count`` with ``extra`` flags held to the numpy oracle, or to the
    oracle's ``codes`` when the caller has them."""
    from unikmer_tpu_torch.io import unik

    out = os.path.join(tmp, name)
    argv = ["count", "-k", str(k), *(["-K"] if canonical else []), "-s",
            "-C", *extra, fa, "-o", out]
    need = ({"h1": True, "k1": False, "k2": True, "s1": False} if hashed
            else {"k1": True, "h1": False, "k2": True, "s1": False})
    secs, launches, _ = counted_cli(argv, need)
    if codes is None:
        which = oracle_unik(fa, out + ".oracle.unik", k, canonical, mode,
                            hashed)
    else:
        write_oracle(out + ".oracle.unik", k, unik.SORTED | (
            unik.CANONICAL if canonical else 0), codes)
        which = "numpy (shared windows)"
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
    launches of the 2-bit, the -K -H and the -W 15 run, and the FASTA's
    and the 2-bit run's paths (for the mesh path), the 37.7 Mbp record's
    path and k = 23 canonical windows and the -H run's .unik (for the
    pipeline phase)."""
    from unikmer_tpu_torch.io.fastx import pack_files

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
    hashed, bases, keyed, valid, k31h = hashed_main_path(tmp, fa)
    sketched, fa2, k31w = sketch_main_path(tmp, fa, bases, keyed, valid)
    del bases, keyed, valid
    one = os.path.join(tmp, "one.fa")
    write_fasta(one, rng, 1, RECORD_BASES + (RECORD_BASES >> 3))
    t0 = time.perf_counter()
    with numpy_host():  # one pass of windows: -u's, -d's, the pipeline's -l
        one_windows, _ = numpy_windows(pack_files([one], 23).bases, 23, True)
        u, counts = unique_counts(one_windows)
    say(f"numpy windows of the 37.7 Mbp record, k = 23 canonical: "
        f"{time.perf_counter() - t0:.3f} s")
    check_against_oracle(tmp, one, "u", 23, True, "unique", ["-u"],
                         codes=u[counts == 1])
    check_against_oracle(tmp, one, "d", 23, True, "repeated", ["-d"],
                         codes=u[counts > 1])
    del u, counts
    check_against_oracle(tmp, one, "k32", 32, False, "distinct", [])
    check_against_oracle(tmp, one, "k64Hu", 64, False, "unique", ["-H", "-u"],
                         hashed=True)
    os.remove(out + ".oracle.unik")
    return ({"k1": launches["k1"], "k2": launches["k2"], "h1": hashed["h1"],
             "s1": sketched["s1"]}, {"fa": fa, "k23": out + ".unik",
                                     "fa2": fa2, "k31W": k31w,
                                     "one": one, "one_windows": one_windows,
                                     "k31H": k31h})


def hashed_main_path(tmp, fa):
    """``count -k 31 -K -H -s -C`` and ``count -k 31 -K -D 15 -s -C`` over
    the 134 Mbp FASTA (bench.py's count_nthash_canonical_sort_distinct and
    count_scaled_s15_sort_distinct), each held to the ntHash oracle, whose
    one hash of every window serves both; returns the -H run's launches,
    the packed bases and the oracle's keyed hashes and validity (for the
    sketch runs), and the
    -H run's .unik, equal to its oracle (for the pipeline phase)."""
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
        write_oracle(out + ".oracle.unik", k, unik.SORTED | unik.CANONICAL
                     | unik.HASHED, want, scale=scale)
        if not same_bytes(out + ".unik", out + ".oracle.unik"):
            raise SystemExit(f"{' '.join(argv)}: .unik differs from the ntHash "
                             f"oracle")
        say(f"hashed main path {' '.join(extra)} .unik ({os.path.getsize(out + '.unik')} "
            f"bytes, {len(want)} codes) equal to the ntHash oracle (written in "
            f"{time.perf_counter() - t0:.3f} s)")
        if name != "H":
            os.remove(out + ".unik")
        os.remove(out + ".oracle.unik")
    return first, bases, keyed, valid, os.path.join(tmp, "k31H.unik")


def sketch_main_path(tmp, fa, bases, keyed, valid):
    """``count -k 31 -W 15 -s -C`` and ``count -k 31 -S 16 -s -C`` over the
    first two records of the 134 Mbp FASTA (bench.py's
    count_minimizer_w15_sort_distinct and count_syncmer_s16_sort_distinct,
    whole records, 2 pieces, no -K: the sketch switches it on), each held
    to its oracle over the ntHash oracle's keyed hashes of those records
    (a prefix of the whole FASTA's); returns the -W 15 run's launches, the
    two records' FASTA and the -W 15 run's .unik (for the pipeline
    phase)."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_files

    k, w, s = SKETCH_K, SKETCH_W, SKETCH_S
    with open(fa, "rb") as f:
        data = f.read()
    fa = os.path.join(tmp, "in2.fa")
    with open(fa, "wb") as f:  # up to the third record's header
        f.write(data[:data.index(b">", data.index(b">", 1) + 1)])
    del data
    t0 = time.perf_counter()
    with numpy_host():
        two = pack_files([fa], k).bases
        n = len(two)
        if not np.array_equal(two, bases[:n]):
            raise SystemExit("sketch main path: two records' bases are no "
                             "prefix of the four records'")
        keyed, valid = keyed[:n], valid[:n]
        skeyed, _ = nthash_keyed_oracle(bases[:n], s, True)
    say(f"ntHash oracle at s={s}: {time.perf_counter() - t0:.3f} s")
    windows = 2 * (RECORD_BASES - k + 1)
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
        if name != "W15":
            os.remove(out + ".unik")
        os.remove(out + ".oracle.unik")
    return first, fa, os.path.join(tmp, "k31W15.unik")


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
    # the compat syncmer prefers the host kernel whatever
    # UNIKMER_TPU_HOST_COUNT says: without the native library it runs on
    # its device twin
    with numpy_host():
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
# the pipeline path: K2/K3's pass plan on the card, dispatch without a
# wait, the streams at pipeline depths 0 and 1, the gzipped .unik reader


PIPELINE_KEYS = 1 << 25  # K2/K3's plan cases
PIPELINE_TURNS = ("0", "1", "1", "0")  # UNIKMER_TPU_PIPELINE_DEPTH in turns
PIPELINE_PIECE = 1 << 25  # the bases of the dispatch checks' piece
INFLATE_TURNS = ("parallel", "stream", "cap0", "parallel")
# the pipeline phase holds the launches it expects (the CPU tests, whose
# plain versions count none, turn this off)
PIPELINE_COUNTS = True


def constant_digits(keys: np.ndarray, bits: int) -> tuple:
    """(passes run, passes skipped) of a K2/K3 sort of ``keys``, reckoned
    in numpy: the sentinel ranked as 2^bits below 64 bits, a pass skipped
    when its 8-bit digit is the same in every key."""
    ranked = keys.copy()
    if bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(bits)
    passes = -(-(min(bits + 1, 64) if bits < 64 else 64) // 8)
    # the bits in which some key differs from the first: one read
    differ = int(np.bitwise_or.reduce(ranked ^ ranked[0])) if len(keys) else 0
    skipped = sum((differ >> (8 * p)) & 255 == 0 for p in range(passes))
    return passes - skipped, skipped


def plan_cases(rng, n: int) -> list:
    """(name, keys, code_bits) of K2/K3's pass-plan cases: every pass runs
    (46 bits: 6, an even count; 64 bits: 8), the top three digits shared
    (5 of 8, odd), one pass (1 of 8), and all keys equal (none: the copy
    kernel fills the output)."""
    two_bit = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
    two_bit[rng.random(n) < 0.02] = SENT
    full = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    top = np.uint64(0xABCDEF) << np.uint64(40)
    top3 = top | (full & np.uint64((1 << 40) - 1))
    one = np.uint64(0x0123456789ABCDEF) & ~np.uint64(0xFF << 16) | (
        (full & np.uint64(0xFF)) << np.uint64(16))
    equal = np.full(n, full[0], np.uint64)
    return [("every pass, 46 bits", two_bit, 46),
            ("every pass, 64 bits", full, 64),
            ("top three digits shared", top3, 64),
            ("one pass", one, 64), ("all equal", equal, 64),
            ("all equal sentinels, 46 bits", np.full(n, SENT), 46)]


def pipeline_sorts(dev, rng) -> dict:
    """K2 and K3 at 2^25 keys in every plan case, exact against their
    plain versions, their passes run and skipped equal to the numpy
    reckoning of the constant digits."""
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_sort_kv_u64, radix_sort_u64, sort_kv_plain, sort_u64_plain,
    )

    rows = {}
    vals = torch.arange(PIPELINE_KEYS, dtype=torch.int32, device=dev)
    for name, keys, bits in plan_cases(rng, PIPELINE_KEYS):
        want_passes = constant_digits(keys, bits)
        x = torch.from_numpy(keys.view(np.int64)).to(dev)
        for w in (radix_sort_u64, radix_sort_kv_u64):
            w.passes_run = w.passes_skipped = 0
        got = radix_sort_u64(x, bits)
        gk, gv = radix_sort_kv_u64(x, vals, bits)
        wk, wv = sort_kv_plain(x, vals)
        exact = (torch.equal(got, sort_u64_plain(x)) and torch.equal(gk, wk)
                 and torch.equal(gv, wv) and got.data_ptr() != x.data_ptr())
        passes = {w.__name__: (w.passes_run, w.passes_skipped)
                  for w in (radix_sort_u64, radix_sort_kv_u64)}
        if not exact or (PIPELINE_COUNTS
                         and set(passes.values()) != {want_passes}):
            raise SystemExit(f"pipeline: K2/K3 {name}: exact {exact}, passes "
                             f"{passes}, the digits say {want_passes}")
        rows[name] = {"code_bits": bits, "passes_run": want_passes[0],
                      "passes_skipped": want_passes[1]}
        del x, got, gk, gv, wk, wv
    say("pipeline K2/K3 pass plan at 2^25 keys, exact, pass counts equal to "
        "the digits: " + json.dumps(rows))
    return rows


def pipeline_no_waits(dev, rng) -> dict:
    """count_packed_dispatch (2-bit, -H, -W 15, the -u dual dispatch) and
    K2/K3 alone under torch.cuda.set_sync_debug_mode("error"), each token
    fetched afterwards equal to a dispatch outside the mode; the compat
    syncmer's dispatch too, which may wait (its plain-torch rule): that
    one is reported, not failed."""
    from unikmer_tpu_torch.io.fastx import PackedSeqs
    from unikmer_tpu_torch.models import count
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_sort_kv_u64, radix_sort_u64,
    )

    bases = random_bases(rng, PIPELINE_PIECE)
    one = PackedSeqs(bases, np.zeros(1, np.int64),
                     np.asarray([len(bases)], np.int64))
    compat = PackedSeqs(bases[:1 << 20], np.zeros(1, np.int64),
                        np.asarray([1 << 20], np.int64))
    cfgs = {
        "2bit": (count.CountConfig(k=23, canonical=True), False, one),
        "-H": (count.CountConfig(k=31, canonical=True, hashed=True), False,
               one),
        "-W 15": (count.CountConfig(k=31, minimizer_w=15), False, one),
        "-u dual": (count.CountConfig(k=23, canonical=True), True, one),
        "compat -S 16": (count.CountConfig(k=31, syncmer_s=16,
                                           syncmer_impl="compat"), False,
                         compat)}
    row = {}
    for name, (cfg, dual, packed) in cfgs.items():
        dispatch = (count.count_packed_dispatch_dual if dual
                    else count.count_packed_dispatch)
        fetch = (count.count_packed_fetch_dual if dual
                 else count.count_packed_fetch)
        want = fetch(dispatch(packed, cfg, dev))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            token = dispatch(packed, cfg, dev)
            waited = None
        except RuntimeError as e:
            token, waited = None, str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if waited is not None:
            if not name.startswith("compat"):
                raise SystemExit(f"pipeline: {name} dispatch waited on the "
                                 f"card: {waited}")
            row[name] = f"waits: {waited}"
            continue
        got = fetch(token)
        same = all(np.array_equal(g, w) for g, w in
                   zip(got if dual else [got], want if dual else [want]))
        if not same:
            raise SystemExit(f"pipeline: {name} dispatched under the sync "
                             f"check differs")
        row[name] = "no wait"
    keys = torch.from_numpy(random_bases(rng, PIPELINE_KEYS).astype(
        np.int64)).to(dev)
    vals = torch.zeros(PIPELINE_KEYS, dtype=torch.int32, device=dev)
    radix_sort_u64(keys, 46)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        radix_sort_u64(keys, 46)
        radix_sort_kv_u64(keys, vals, 46)
        radix_sort_u64(keys[:1], 64)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    row["K2/K3 alone"] = "no wait"
    say("pipeline dispatch under set_sync_debug_mode('error'): "
        + json.dumps(row))
    return row


def device_busy(fn) -> dict:
    """fn() under torch.profiler (CUDA activity): its wall seconds, the
    seconds the card was busy (the union of its kernels' and copies'
    intervals, portbench's union) and their share of the wall; busy None
    when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.records import covered

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return {"traced_s": round(wall, 4), "busy_s": None, "busy_share": None}
    busy_s = covered(spans) / 1e6
    return {"traced_s": round(wall, 4), "busy_s": round(busy_s, 6),
            "busy_share": round(busy_s / wall, 6)}


def pipeline_counts(tmp, runs) -> dict:
    """Each (name, argv, want, need) streamed CLI count unrecorded at
    UNIKMER_TPU_PIPELINE_DEPTH 0 and 1 in turns (PIPELINE_TURNS): wall s,
    peak device memory and launches of each, every output byte-equal to
    ``want`` (an oracle's bytes, or a file equal to one); then one
    profiled run at each depth for the device's busy share."""
    out = {}
    wrappers = encode_wrappers()
    for name, argv, want, need in runs:
        row = {"wall_s": {"0": [], "1": []}, "peak_bytes": {"0": [], "1": []}}
        for depth in PIPELINE_TURNS:
            os.environ["UNIKMER_TPU_PIPELINE_DEPTH"] = depth
            dst = os.path.join(tmp, f"pipe_{depth}")
            before = read_launches(wrappers)
            torch.cuda.reset_peak_memory_stats()
            try:
                t0 = time.perf_counter()
                run_cli([*argv, "-o", dst])
                secs = time.perf_counter() - t0
            finally:
                del os.environ["UNIKMER_TPU_PIPELINE_DEPTH"]
            got = {key: n - before[key]
                   for key, n in read_launches(wrappers).items()}
            if (PIPELINE_COUNTS and any((got[key] > 0) != must
                                        for key, must in need.items())
                    or not same_bytes(dst + ".unik", want)):
                raise SystemExit(f"pipeline: {name} at depth {depth}: output "
                                 f"differs or launches {got}, {need} needed")
            row["wall_s"][depth].append(round(secs, 4))
            row["peak_bytes"][depth].append(torch.cuda.max_memory_allocated())
            row["launches"] = got
            os.remove(dst + ".unik")
        for depth in ("0", "1"):
            os.environ["UNIKMER_TPU_PIPELINE_DEPTH"] = depth
            dst = os.path.join(tmp, f"pipe_trace_{depth}")
            try:
                row[f"trace_depth_{depth}"] = device_busy(
                    lambda: run_cli([*argv, "-o", dst]))
            finally:
                del os.environ["UNIKMER_TPU_PIPELINE_DEPTH"]
            if not same_bytes(dst + ".unik", want):
                raise SystemExit(f"pipeline: traced {name} differs")
            os.remove(dst + ".unik")
        say(f"pipeline {name}: " + json.dumps(row))
        out[name] = row
    return out


def pipeline_gzip(tmp, fa: str, plain_unik: str) -> dict:
    """``count -k 23 -K -s`` of the main FASTA written gzipped (UK-indexed
    members), read back by ``read_all()`` with the parallel inflate, with
    ``stream=True`` (member by member) and with
    UNIKMER_TPU_INFLATE_CAP=0, in turns (INFLATE_TURNS), every array equal
    to the -C file's; then ``union -s -C`` of it with itself, its gzipped
    inputs read end to end.  Fails when pgz_inflate_all returns None on
    the file."""
    from unikmer_tpu_torch import native
    from unikmer_tpu_torch.io import unik

    gz = os.path.join(tmp, "pipe_gz")
    t0 = time.perf_counter()
    run_cli(["count", "-k", "23", "-K", "-s", fa, "-o", gz])
    row = {"count_gzip_s": round(time.perf_counter() - t0, 4),
           "bytes": os.path.getsize(gz + ".unik")}
    with unik.UnikReader(plain_unik) as r:
        want = r.read_all()[0]
    with open(gz + ".unik", "rb") as f:
        raw = f.read()
    t0 = time.perf_counter()
    inflated = native.pgz_inflate_all(raw)
    row["pgz_inflate_all_s"] = round(time.perf_counter() - t0, 4)
    if inflated is None:
        raise SystemExit("pipeline: pgz_inflate_all returned None on a "
                         "UK-indexed .unik")
    del raw, inflated
    # below 1 MiB the reader streams by members in every mode
    kinds = {"parallel": io.BytesIO if row["bytes"] >= 1 << 20
             else unik._UKMemberStream, "stream": unik._UKMemberStream,
             "cap0": unik._UKMemberStream}
    secs = {mode: [] for mode in kinds}
    for mode in INFLATE_TURNS:
        if mode == "cap0":
            os.environ["UNIKMER_TPU_INFLATE_CAP"] = "0"
        try:
            t0 = time.perf_counter()
            with unik.UnikReader(gz + ".unik", stream=mode == "stream") as r:
                kind = type(r._file.raw)
                got = r.read_all()[0]
            secs[mode].append(round(time.perf_counter() - t0, 4))
        finally:
            os.environ.pop("UNIKMER_TPU_INFLATE_CAP", None)
        if kind is not kinds[mode] or not np.array_equal(got, want):
            raise SystemExit(f"pipeline: read_all {mode} took {kind} or "
                             f"differs")
        del got
    row["read_all_s"] = secs
    out = os.path.join(tmp, "pipe_union")
    t0 = time.perf_counter()
    run_cli(["union", "-s", "-C", gz + ".unik", gz + ".unik", "-o", out])
    row["union_gzip_s"] = round(time.perf_counter() - t0, 4)
    with unik.UnikReader(out + ".unik") as r:
        if not np.array_equal(r.read_all()[0], want):
            raise SystemExit("pipeline: the union of the gzipped files "
                             "differs")
    os.remove(out + ".unik")
    os.remove(gz + ".unik")
    say("pipeline gzipped .unik: " + json.dumps(row))
    return row


def pipeline_path(tmp, rng, dev, inputs: dict) -> dict:
    """The pipeline phase: K2/K3's plan cases, the dispatch's sync check,
    the 134 Mbp streamed count (2-bit and -H), -W 15 over its first two
    records (a sketch piece is a whole record) and -l over the 37.7 Mbp
    record at depths 0 and 1 (its oracle the main path's windows of that
    record, in genome order), and the gzipped reader.  Returns the
    launches of its counts."""
    from unikmer_tpu_torch.io import unik

    t0 = time.perf_counter()
    row = {"plan": pipeline_sorts(dev, rng), "dispatch": pipeline_no_waits(
        dev, rng)}
    lin = os.path.join(tmp, "pipe_l.oracle.unik")
    write_oracle(lin, 23, unik.CANONICAL, inputs["one_windows"], number=-1)
    two_bit = {"k1": True, "h1": False, "k2": True}
    runs = [
        ("count -k 23 -K -s -C (134 Mbp)",
         ["count", "-k", "23", "-K", "-s", "-C", inputs["fa"]],
         inputs["k23"], two_bit),
        ("count -k 31 -K -H -s -C (134 Mbp)",
         ["count", "-k", "31", "-K", "-H", "-s", "-C", inputs["fa"]],
         inputs["k31H"], {"k1": False, "h1": True, "k2": True}),
        ("count -k 31 -W 15 -s -C (67 Mbp, 2 whole-record pieces)",
         ["count", "-k", "31", "-W", "15", "-s", "-C", inputs["fa2"]],
         inputs["k31W"], {"k1": False, "h1": True, "s1": True, "k2": True}),
        ("count -k 23 -K -l -C (37.7 Mbp, 2 pieces)",
         ["count", "-k", "23", "-K", "-l", "-C", inputs["one"]], lin,
         {"k1": True, "h1": False, "k2": False})]
    wrappers = zero_launches()
    row["counts"] = pipeline_counts(tmp, runs)
    launches = read_launches(wrappers)
    for path in (lin, inputs["one"], inputs["k31H"], inputs["fa2"],
                 inputs["k31W"]):
        os.remove(path)
    row["gzip"] = pipeline_gzip(tmp, inputs["fa"], inputs["k23"])
    row["seconds"] = round(time.perf_counter() - t0, 3)
    say(json.dumps({"pipeline": row}))
    return launches


# ---------------------------------------------------------------------------
# the start-up path: what a user's call pays before its work, each call
# a process of its own


STARTUP_BASES = (1 << 22, 1 << 25)  # the 4 and 32 Mbp inputs (134: main)
STARTUP_TIMEOUT = 600  # seconds a fresh process of the phase may take
K1_KERNEL, K2_KERNEL = "encode_2bit_kernel", "radix_onesweep_pass"
KERNEL_EVENT = "kernel"  # the trace category of a CUDA kernel's events
STARTUP_NEED = ("k1", "k2")  # what each device process must launch
STARTUP_AIM_S = 120  # the phase's seconds, with room on a slow host
SMOKE_AIM_S = 800  # the script's, with room under the 1,200 s limit
# a user's call of the CLI, which then prints on stderr its wrappers'
# launches (when it imported torch) and, last, whether it imported torch
FRESH = ("import json, sys\n"
         "from unikmer_tpu_torch.cli.main import main\n"
         "rc = main(sys.argv[1:])\n"
         "sys.stdout.flush()\n"
         "imported = 'torch' in sys.modules\n"
         "if imported:\n"
         "    import chip_smoke\n"
         "    print('launches:', json.dumps({key: w.launches for key, w in\n"
         "          chip_smoke.encode_wrappers().items()}), file=sys.stderr)\n"
         "print('torch imported:', imported, file=sys.stderr)\n"
         "sys.exit(rc)\n")


def fresh(argv, env: dict | None = None, digest: bool = False):
    """Run the port's CLI on ``argv`` in a fresh interpreter from the
    repository's root, with os.environ updated by ``env`` (None values
    removed).  Returns (wall seconds, exit code, whether torch was
    imported, stderr, the sha256 and length of stdout when ``digest``,
    else None: the output is hashed as it streams, inside the time).
    The process's kernel launches are in fresh_launches(stderr)."""
    import hashlib

    full = dict(os.environ)
    for name, value in (env or {}).items():
        if value is None:
            full.pop(name, None)
        else:
            full[name] = value
    err_path = os.path.join(tempfile.gettempdir(), f"fresh.{os.getpid()}.err")
    with open(err_path, "w+") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", FRESH, *argv],
                                cwd=ROOT, env=full, stderr=err,
                                stdout=subprocess.PIPE if digest
                                else subprocess.DEVNULL)
        out = None
        try:
            if digest:
                h, size = hashlib.sha256(), 0
                while chunk := proc.stdout.read(1 << 22):
                    h.update(chunk)
                    size += len(chunk)
                out = (h.hexdigest(), size)
            rc = proc.wait(timeout=STARTUP_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        secs = time.perf_counter() - t0
        err.seek(0)
        text = err.read()
    os.remove(err_path)
    last = text.strip().splitlines()[-1] if text.strip() else ""
    if not last.startswith("torch imported:"):
        raise SystemExit(f"start-up {' '.join(argv)}: exited {rc} without "
                         f"its last line: {text[-2000:]}")
    return secs, rc, last.endswith("True"), text, out


def fresh_launches(err: str) -> dict:
    """The launches a fresh process's wrappers counted (none without
    torch)."""
    found = re.findall(r"^launches: (.*)$", err, re.M)
    return json.loads(found[-1]) if found else {}


def routes_of(err: str) -> list:
    return re.findall(r"count: the (\w+) route", err)


def served_launches(log_path: str) -> dict:
    """The launches the server logged for its last request."""
    found = re.findall(r"^\[server\] done rc=.* launches (\{.*\})$",
                       open(log_path).read(), re.M)
    return json.loads(found[-1]) if found else {}


def startup_path(tmp, rng, main_in: dict, dev, card: str) -> dict:
    """(a) num and info of the main path's .unik and view of the 32 Mbp
    one as fresh processes, none of which may import torch; (b) fresh
    ``count -k 23 -K -s -C`` processes at 4 and 32 Mbp (device, host,
    host) and 134 Mbp (device, host, host), UNIKMER_TPU_HOST_COUNT
    0 for the device and 1 for the host, their bytes equal to the numpy
    oracle's (the main path's .unik for 134 Mbp), the host route's
    processes without torch; (c) the resident server with --warm
    --pretouch: through the client, the 134 Mbp count under
    UNIKMER_TPU_HOST_COUNT 0, auto (the device in the server) and 1, the
    32 Mbp count under 0 and 1, ``union`` of the first count's output and
    ``view`` of the 32 Mbp one, each equal to a local call's (or the
    oracle's) bytes and exit code, each device count with K1 and K2 in
    the launches the server logged for it, element_budget("union") read
    before and after the requests, then SIGTERM and the server's exit;
    (d) a device count under UNIKMER_TPU_PROFILE, whose Chrome trace must
    name K1's and K2's kernels.  Every device process of (b) and (d) must
    launch K1 and K2 (its wrappers' counts, printed at its end).  Returns
    the start-up line, with the launches of those processes and of the
    server's device counts."""
    from unikmer_tpu_torch.cli.main import main as cli_main
    from unikmer_tpu_torch.ops.device_sets import element_budget

    t_phase = time.perf_counter()
    fa, k23 = main_in["fa"], main_in["k23"]
    row = {"card": card}
    launches = {"k1": 0, "h1": 0, "s1": 0, "k2": 0, "k3": 0}

    def add_launches(got, what):
        if any(got.get(key, 0) < 1 for key in STARTUP_NEED):
            raise SystemExit(f"start-up {what}: launches {got}, "
                             f"{STARTUP_NEED} expected")
        for key, n in got.items():
            launches[key] += n

    inputs = [(f"{n / (1 << 20):g} Mbp", os.path.join(tmp, f"startup{n}.fa"), n)
              for n in STARTUP_BASES]
    for _, path, n in inputs:
        write_fasta(path, rng, 1, n)
    oracles = {}
    for label, path, _ in inputs:
        oracles[label] = path + ".oracle.unik"
        say(f"start-up {label} oracle: " + oracle_unik(
            path, oracles[label], 23, True, "distinct"))
    mid, mid_fa = inputs[-1][:2]  # 32 Mbp: view's, and the server's

    # (a) host-only commands
    cmds = {}
    for name, argv in (("num", ["num", k23]), ("info", ["info", k23]),
                       (f"view {mid}", ["view", oracles[mid]])):
        secs, rc, imported, err, out = fresh(argv, digest=True)
        if rc != 0 or imported:
            raise SystemExit(f"start-up {name}: exit {rc}, torch imported "
                             f"{imported}: {err[-2000:]}")
        cmds[name] = {"s": round(secs, 4), "stdout_bytes": out[1]}
    view_digest = out  # the view's, held to the server's below
    row["host_only"] = cmds
    say(f"start-up host-only commands (no torch imported): "
        + json.dumps(cmds))

    # (b) the host engine against the device route
    inputs.append(("134 Mbp", fa, 4 * RECORD_BASES))
    oracles["134 Mbp"] = k23  # held to the oracle by the main path
    routes = {}
    for label, path, n in inputs:
        runs = {"host": [], "device": []}
        knobs = ("0", "1", "1")
        for knob in knobs:
            route = "host" if knob == "1" else "device"
            out = os.path.join(tmp, f"startup_{route}")
            secs, rc, imported, err, _ = fresh(
                ["count", "-k", "23", "-K", "-s", "-C", "-V", path, "-o",
                 out], {"UNIKMER_TPU_HOST_COUNT": knob})
            if (rc != 0 or routes_of(err) != [route]
                    or imported != (route == "device")
                    or not same_bytes(out + ".unik", oracles[label])):
                raise SystemExit(
                    f"start-up count {label} UNIKMER_TPU_HOST_COUNT={knob}: "
                    f"exit {rc}, routes {routes_of(err)}, torch imported "
                    f"{imported}, or bytes unlike the oracle's: "
                    f"{err[-2000:]}")
            os.remove(out + ".unik")
            runs[route].append(round(secs, 4))
            if route == "device":
                add_launches(fresh_launches(err), f"count {label}")
        routes[label] = {
            "bases": n, **{f"{r}_s": v for r, v in runs.items()},
            "host_wins": max(runs["host"]) < min(runs["device"])}
        say(f"start-up count {label}, fresh processes "
            f"({', '.join('host' if x == '1' else 'device' for x in knobs)}"
            f"), every .unik equal to the oracle's: "
            + json.dumps(routes[label]))
    row["count"] = routes
    os.remove(oracles[inputs[0][0]])
    small = inputs[0][1]

    # (c) the resident server
    sock = os.path.join(tmp, "server.sock")
    log_path = os.path.join(tmp, "server.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        srv = subprocess.Popen(
            [sys.executable, "-m", "unikmer_tpu_torch.server", "--socket",
             sock, "--warm", "--pretouch"], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT,
            env={k: v for k, v in os.environ.items()
                 if k != "UNIKMER_TPU_SERVER"})
    try:
        while "listening on" not in open(log_path).read():
            if srv.poll() is not None or (time.perf_counter() - t0
                                          > STARTUP_TIMEOUT):
                raise SystemExit(f"start-up server: not listening: "
                                 f"{open(log_path).read()[-2000:]}")
            time.sleep(0.1)
        ready_s = time.perf_counter() - t0
        warm = [ln for ln in open(log_path).read().splitlines()
                if " in " in ln]
        say(f"start-up server ready in {ready_s:.3f} s: " + "; ".join(warm))
        before = element_budget("union", dev)
        requests, served = {}, {}
        # (input, its oracle, the knob, the route the server must take)
        counts = (("134 Mbp", fa, "0", "device"),
                  ("134 Mbp", fa, "auto", "device"),
                  ("134 Mbp", fa, "1", "host"),
                  (mid, mid_fa, "0", "device"),
                  (mid, mid_fa, "1", "host"))
        for label, path, knob, route in counts:
            what = f"count {label} UNIKMER_TPU_HOST_COUNT={knob}"
            out = os.path.join(tmp, f"served_{len(requests)}")
            secs, rc, imported, err, _ = fresh(
                ["count", "-k", "23", "-K", "-s", "-C", "-V", path, "-o",
                 out], {"UNIKMER_TPU_SERVER": sock,
                        "UNIKMER_TPU_HOST_COUNT": knob})
            got = served_launches(log_path)
            if (rc != 0 or imported or routes_of(err) != [route]
                    or not same_bytes(out + ".unik", oracles[label])):
                raise SystemExit(f"start-up server {what}: exit {rc}, the "
                                 f"client imported torch {imported}, routes "
                                 f"{routes_of(err)}, or bytes unlike the "
                                 f"oracle's: {err[-2000:]}")
            if route == "device":
                add_launches(got, f"server {what}")
            elif any(got.values()):
                raise SystemExit(f"start-up server {what}: the host route "
                                 f"launched {got}")
            requests[what] = {"s": round(secs, 4), "launches": got}
            if (label, knob) in (("134 Mbp", "0"), (mid, "0")):
                served[label] = out + ".unik"  # union's and view's input
            else:
                os.remove(out + ".unik")
        client = {"UNIKMER_TPU_SERVER": sock}
        union = ["union", "-s", "-C", served["134 Mbp"], "-o"]
        secs, rc, imported, err, _ = fresh(
            union + [os.path.join(tmp, "served_union")], client)
        requests["union"] = {"s": round(secs, 4),
                             "launches": served_launches(log_path)}
        local_rc = cli_main(union + [os.path.join(tmp, "local_union")])
        if (rc, imported) != (local_rc, False) or not same_bytes(
                os.path.join(tmp, "served_union.unik"),
                os.path.join(tmp, "local_union.unik")):
            raise SystemExit(f"start-up server union: exit {rc} against the "
                             f"local {local_rc}, or other bytes: "
                             f"{err[-2000:]}")
        secs, rc, imported, err, digest = fresh(
            ["view", served[mid]], client, digest=True)
        if (rc, imported, digest) != (0, False, view_digest):
            raise SystemExit(f"start-up server view: exit {rc}, or its "
                             f"output unlike the local view's: {err[-2000:]}")
        requests[f"view {mid}"] = {"s": round(secs, 4),
                                   "launches": served_launches(log_path)}
        after = element_budget("union", dev)
        if after < 0.9 * before:
            raise SystemExit(f"start-up server: element_budget('union') "
                             f"{after} after the requests, {before} before")
    finally:
        srv.terminate()
        try:
            srv_rc = srv.wait(timeout=60)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
            srv_rc = None
    if srv_rc != 0 or os.path.exists(sock):
        raise SystemExit(f"start-up server: exit {srv_rc} on SIGTERM, socket "
                         f"left {os.path.exists(sock)}")
    for path in (*served.values(), oracles[mid],
                 os.path.join(tmp, "served_union.unik"),
                 os.path.join(tmp, "local_union.unik")):
        os.remove(path)
    row["server"] = {
        "ready_s": round(ready_s, 4), "warm": warm, "requests": requests,
        "cold_local_count_s": routes["134 Mbp"]["device_s"][0],
        "union_budget": {"before": before, "after": after},
        "exit": srv_rc}
    say("start-up server: every request equal to a local call; "
        + json.dumps(row["server"]))

    # (d) the profiler knob
    trace_dir = os.path.join(tmp, "trace")
    secs, rc, _, err, _ = fresh(
        ["count", "-k", "23", "-K", "-s", "-C", small, "-o",
         os.path.join(tmp, "traced")],
        {"UNIKMER_TPU_HOST_COUNT": "0", "UNIKMER_TPU_PROFILE": trace_dir})
    traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    if rc != 0 or len(traces) != 1:
        raise SystemExit(f"start-up profile: exit {rc}, traces {traces}: "
                         f"{err[-2000:]}")
    add_launches(fresh_launches(err), "profile")
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = {name: sum(1 for ev in events if ev.get("cat") == KERNEL_EVENT
                         and name in ev.get("name", ""))
               for name in (K1_KERNEL, K2_KERNEL)}
    if min(kernels.values()) < 1:
        raise SystemExit(f"start-up profile: the trace names no K1 or K2 "
                         f"kernel: {kernels}")
    row["profile"] = {"s": round(secs, 4), "events": len(events),
                      "kernel_events": kernels}
    say("start-up profile: " + json.dumps(row["profile"]))
    shutil.rmtree(trace_dir)
    os.remove(os.path.join(tmp, "traced.unik"))
    for _, path, _ in inputs[:-1]:
        os.remove(path)
    row["launches"] = launches  # (b), the server's device counts, (d)
    row["seconds"] = round(time.perf_counter() - t_phase, 3)
    say(f"start-up phase seconds: {row['seconds']} (aim at most "
        f"{STARTUP_AIM_S})")
    return row


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
    in T1-T3, T2's output for the file commands (its path and the
    oracle's codes and taxids; the taxonomy in ``tmp``/taxdump) and the
    FASTA files of T1 and T2 for the mesh path ([(name, path, tier)])."""
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
    kept = []
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
        if name == "T2":
            t2 = {"unik": os.path.join(tmp, "T2.unik"), "codes": codes,
                  "taxids": got_taxids}
            os.remove(os.path.join(tmp, "T2.oracle.unik"))
        if name == "T1":  # the same input hashed (H1, then K3) and sketched
            taxid_run(tmp, "T1H", fa, d, 31, True, "distinct",
                      len(taxids) * (length - 31 + 1), hashed=True)
            taxid_run(tmp, "T1W", fa, d, SKETCH_K, False, "distinct",
                      len(taxids) * (length - SKETCH_K + 1),
                      minimizer_w=SKETCH_W)
        if name == "T3":
            os.remove(fa)
        else:
            kept.append((name, fa, tier))
    # T3: the one window of 32 T's is a real 2^64-1 code, kept with the
    # taxid of its record
    if not (codes[-1] == SENT and got_taxids[-1] == t3[0]):
        raise SystemExit(f"T3: the 2^64-1 code was not kept with taxid "
                         f"{t3[0]}: {codes[-3:]}, {got_taxids[-3:]}")
    return k3, t2, kept


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
        raise SystemExit(f"{what}: launches {launches}, expected {need}")
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
        out, secs, launches, peak = counted(fn, need, f"sets {name}")
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
            {"k1": 4, "k2": 4, "k3": 0},
            "sets from_fasta 134 Mbp (forced host)")
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
              half: int = 1 << 20):
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


def sets_path(tmp, rng, report: SetsReport, dev=None) -> dict:
    """The library phase, the taxid phase and the CLI phase (module
    docstring), every result held exactly to its numpy oracle; the
    -T path's taxonomy is read from ``tmp``/taxdump.  Returns what the
    file commands read: the ``count -t`` files of A, B and C, the codes
    of their union and of those in two of them, A's and B's codes with
    their per-code taxids, the oracle of their taxid union and A's
    low-complexity mask; and what the mesh path reads: the CLI phase's
    oracle, its .unik files and the CLI's seconds."""
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
    low = low_complexity_oracle(an, 23)
    oracle["filter"] = an[~low]
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
    # the host engine's times of these operations are not taken (the
    # untaxed operations above have them)
    report.op("A | B (taxids)", lambda: at | bt, {"k1": 0, "k2": 0, "k3": 1},
              holds("A | B (taxids)"))
    report.op("A | B (one-sided)", lambda: at | b, one_k2,
              holds("A | B (one-sided)"))
    report.op("A & B (taxids)", lambda: at & bt, no_sort,
              holds("A & B (taxids)"))
    report.op("A & B (one-sided)", lambda: at & b, no_sort,
              holds("A & B (one-sided)"))
    report.op("A - B (taxids)", lambda: at - bt, no_sort,
              holds("A - B (taxids)"))
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
        if name != "A":  # the genome path reads A
            os.remove(fa)
    t0 = time.perf_counter()
    with numpy_host():
        cli_oracle = cli_setop_oracles(merged, gtax, taxdb)
    kept = {"uniks": uniks, "taxdump": d, "a": (an, ta), "b": (bn, tb),
            "a_low": low, "ab_taxids": oracle["A | B (taxids)"],
            "a_fa": fas[0], "oracle": cli_oracle}
    del cn, oracle, merged
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
                {"k1": 0, "k2": 0, "k3": 1 if key == "union" else 0},
                f"sets CLI {name}")
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
                {"k1": 0, "k2": 0, "k3": 0}, "sets CLI union (forced host)")
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
    kept.update(union=cli_oracle["union"][0], common=cli_oracle["common"][0],
                written=written, cli_s={
                    row["op"][4:].replace(" -n 2", ""): row["s"]
                    for row in report.rows if row["op"].startswith("CLI ")})
    return kept


# ---------------------------------------------------------------------------
# file commands: sort, split, merge, tsplit, rfilter, head, sample and
# filter over the files the count -T and sets paths wrote


RANK_BY_DEPTH = ("no rank", "superkingdom", "phylum", "class", "order",
                 "family", "genus", "species", "strain")


def write_ranked_taxonomy(src: str, dst: str) -> np.ndarray:
    """A copy of ``src``/nodes.dmp in ``dst`` whose ranks go by depth
    (RANK_BY_DEPTH; past its end "no rank"); returns the depths."""
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    with numpy_host():
        taxdb = load_taxonomy(src, with_rank=False)
    depth = taxdb.depth.astype(np.int64)
    names = RANK_BY_DEPTH + ("no rank",) * int(depth.max() + 1)
    os.mkdir(dst)
    with open(os.path.join(dst, "nodes.dmp"), "w") as f:
        f.writelines(f"{t}\t|\t{taxdb.parent[t]}\t|\t{names[depth[t]]}"
                     "\t|\t\t|\n" for t in np.flatnonzero(depth >= 0))
    return depth


def rfilter_keep(depth: np.ndarray, taxids: np.ndarray, how: str):
    """What ``rfilter`` keeps on the ranked copy of the tree: under ``-E
    species`` the taxids at the species depth; under ``-L genus`` those
    below genus (species, strain) and those whose rank has no order ("no
    rank": the root and every depth past strain, order 0 in the rank
    file); a taxid absent from the tree has no rank and goes."""
    t = taxids.astype(np.int64)
    d = np.full(len(t), -1)
    ok = (t > 0) & (t < len(depth))
    d[ok] = depth[t[ok]]
    species = RANK_BY_DEPTH.index("species")
    if how == "-E species":
        return d == species
    if how == "-L genus":
        return (d >= species) | (d == 0)
    raise ValueError(how)


def write_oracle_blocks(out: str, k: int, flag: int, blocks,
                        max_taxid: int = 0) -> None:
    """The oracle's (codes, taxids) blocks through the port's UnikWriter,
    one write_codes a block and no count, as the streaming commands
    (head, sample, filter) write: an empty block writes nothing."""
    from unikmer_tpu_torch.io import unik

    with numpy_host(), open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag, compress=False, max_taxid=max_taxid) as w:
        for codes, taxids in blocks:
            w.write_codes(codes, taxids)


def block_bounds(path: str) -> np.ndarray:
    """The offsets of a .unik file's blocks (0, n0, n0 + n1, ...)."""
    from unikmer_tpu_torch.io import unik

    with unik.UnikReader(path) as r:
        return np.cumsum([0] + [len(c) for c, _ in r.iter_blocks()])


def unik_number(path: str) -> int:
    """The code count in a .unik file's header."""
    from unikmer_tpu_torch.io import unik

    with unik.UnikReader(path) as r:
        return r.header.number


def read_unik(path: str):
    """(header, codes, taxids) of a .unik file, read by the port's reader."""
    from unikmer_tpu_torch.io import unik

    with unik.UnikReader(path) as r:
        return (r.header, *r.read_all())


def same_content(name: str, path: str, codes, taxids, flag: int,
                 number: int) -> None:
    """A .unik file holds exactly these codes and taxids under this flag
    and count."""
    h, c, t = read_unik(path)
    if h.flag != flag or h.number != number:
        raise SystemExit(f"file commands {name}: flag {h.flag}, count "
                         f"{h.number}; expected {flag}, {number}")
    if not np.array_equal(c, codes) or (t is None) != (taxids is None) or (
            taxids is not None and not np.array_equal(t, taxids)):
        raise SystemExit(f"file commands {name}: {len(c)} codes, not the "
                         f"oracle's {len(codes)} (or their taxids)")


def same_inflated(a: str, b: str) -> bool:
    """Two gzip files inflate to the same bytes."""
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def file_commands_path(tmp, sets: dict, t2: dict, dev, chunk: str = "8M",
                       max_open: int = 4, head_n: int = 1 << 20) -> dict:
    """The file commands over the sets path's ``count -t`` files of A, B
    and C and T2's ``count -T`` output, each run through the CLI (no
    K1, K2 or K3 launch: they run on the host, filter's mask in plain
    torch on the card) and held to its oracle.  The runs over A, B and C
    take -I (their global taxids' LCA is the host ``lca_reduce``, which
    would lead every call); the LCA run is A's and B's codes with the
    taxid phase's per-code taxids:

      sort -u -I (in memory)    the bytes of the union's codes
      sort -u -I -m chunk -M n  the union's codes, from more chunks than
                                -M, so a cascade; gzip temporaries
      split + merge -D -u -I    the inflated bytes of sort -m's output
                                (the same chunks merged the same way)
      sort -d -I                the bytes of the codes in two files
      sort -u, per-code taxids  the bytes of the taxid phase's LCA oracle
      tsplit T2                 a file a taxid, holding T2's codes with
                                that taxid under a global taxid
      rfilter -E / -L           T2's codes whose taxids pass, on a copy
                                of the tree ranked by depth
      head, sample, filter      A's codes block by block (head's first
                                ``head_n``, sample's -s 3 -w 7, filter's
                                by low_complexity_oracle)

    Returns the seconds of each call and filter's mask times and peak
    device bytes over what was resident (each block's mask must run on
    ``dev``); prints them as the ``file_commands`` line."""
    from unikmer_tpu_torch.cli.commands import filter as filter_cmd
    from unikmer_tpu_torch.cli.commands.filter import block_mask
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.ops.filter import low_complexity_mask
    from unikmer_tpu_torch.utils.sizes import parse_byte_size

    d, uniks = sets["taxdump"], sets["uniks"]
    an, ta = sets["a"]
    bn, tb = sets["b"]
    seconds = {}
    stmp = os.path.join(tmp, "fc_tmp")

    def run(name, argv):
        _, secs, _, peak = counted(lambda: run_cli(argv),
                                   {"k1": 0, "k2": 0, "k3": 0},
                                   f"file commands {name}")
        seconds[name] = round(secs, 4)
        return peak

    def out(name):
        return os.path.join(tmp, f"fc_{name}")

    def holds(name, got, want, same=same_bytes):
        if not same(got, want):
            raise SystemExit(f"file commands {name}: {got} differs from "
                             f"{want}")
        say(f"file commands {name}: {os.path.getsize(got)} bytes equal to "
            f"the oracle's ({seconds[name]} s)")

    def oracle(name, codes, taxids=None):
        path = out(name + ".oracle")
        with numpy_host():
            write_oracle(path, 23, (unik.SORTED | unik.CANONICAL) | (
                0 if taxids is None else unik.INCLUDE_TAXID), codes, taxids)
        return path

    sorted_flag = unik.SORTED | unik.CANONICAL
    n_codes = sum(read_unik(u)[0].number for u in uniks)
    if -(-n_codes // parse_byte_size(chunk)) <= max_open:
        raise SystemExit(f"file commands: {n_codes} codes in chunks of "
                         f"{chunk} make no cascade past -M {max_open}")
    # sort -u in memory, and external with a cascade
    run("sort -u -I", ["sort", "-u", "-I", "-C", *uniks, "-o", out("sort_u")])
    holds("sort -u -I", out("sort_u") + ".unik",
          oracle("union", sets["union"]))
    for f in (out("sort_u") + ".unik", out("union.oracle")):
        os.remove(f)
    name_m = f"sort -u -I -m {chunk} -M {max_open}"
    run(name_m, ["sort", "-u", "-I", "-m", chunk, "-M", str(max_open), "-t",
                 stmp, *uniks, "-o", out("sort_um")])
    same_content(name_m, out("sort_um") + ".unik", sets["union"], None,
                 sorted_flag, -1)
    say(f"file commands {name_m}: {len(sets['union'])} codes equal to the "
        f"union's ({seconds[name_m]} s)")
    # split, then merge what it wrote: sort -m's bytes
    parts = out("parts")
    run(f"split -u -I -m {chunk}", ["split", "-u", "-I", "-m", chunk,
                                    *uniks, "-O", parts])
    name_merge = f"merge -D -u -I -M {max_open}"
    run(name_merge, ["merge", "-D", "-u", "-I", "-M", str(max_open), "-t",
                     stmp, parts, "-o", out("merge")])
    holds(name_merge, out("merge") + ".unik", out("sort_um") + ".unik",
          same_inflated)
    shutil.rmtree(parts)
    for f in ("merge", "sort_um"):
        os.remove(out(f) + ".unik")
    # sort -d: the codes of at least two files
    run("sort -d -I", ["sort", "-d", "-I", "-C", *uniks, "-o", out("sort_d")])
    holds("sort -d -I", out("sort_d") + ".unik",
          oracle("common", sets["common"]))
    for f in (out("sort_d") + ".unik", out("common.oracle")):
        os.remove(f)
    # duplicate codes with different per-code taxids: their LCA
    taxid_flag = sorted_flag | unik.INCLUDE_TAXID
    per_code = [out("at") + ".unik", out("bt") + ".unik"]
    for path, codes, taxids in zip(per_code, (an, bn), (ta, tb)):
        write_oracle(path, 23, taxid_flag, codes, taxids)
    run("sort -u (per-code taxids)", ["sort", "-u", "-C", "--data-dir", d,
                                      *per_code, "-o", out("sort_ut")])
    holds("sort -u (per-code taxids)", out("sort_ut") + ".unik",
          oracle("ab", *sets["ab_taxids"]))
    for f in (*per_code, out("sort_ut") + ".unik", out("ab.oracle")):
        os.remove(f)
    # tsplit of T2: a file a taxid
    ts = out("tsplit")
    run("tsplit", ["tsplit", "-C", t2["unik"], "-O", ts])
    codes, taxids = t2["codes"], t2["taxids"]
    order = np.argsort(taxids, kind="stable")
    t_s, c_s = taxids[order], codes[order]
    starts = np.flatnonzero(np.r_[True, t_s[1:] != t_s[:-1]])
    bounds = np.append(starts, len(t_s))
    names = {f"tsplit.taxid-{t_s[i]}.k23.unik" for i in starts}
    if set(os.listdir(ts)) != names:
        raise SystemExit(f"file commands tsplit: {len(os.listdir(ts))} "
                         f"files, not the {len(names)} taxids' names")
    for i, lo in enumerate(starts):
        path = os.path.join(ts, f"tsplit.taxid-{t_s[lo]}.k23.unik")
        h, c, _ = read_unik(path)
        if (h.global_taxid != t_s[lo] or h.flag != unik.SORTED
                | unik.CANONICAL or h.number != bounds[i + 1] - lo
                or not np.array_equal(c, c_s[lo:bounds[i + 1]])):
            raise SystemExit(f"file commands tsplit: {path} is not taxid "
                             f"{t_s[lo]}'s {bounds[i + 1] - lo} codes")
    say(f"file commands tsplit: {len(names)} files, each equal to T2's "
        f"codes of its taxid ({seconds['tsplit']} s)")
    shutil.rmtree(ts)
    del order, t_s, c_s
    # rfilter on the tree ranked by depth
    ranked = os.path.join(tmp, "taxdump_ranked")
    depth = write_ranked_taxonomy(d, ranked)
    for how in ("-E species", "-L genus"):
        keep = rfilter_keep(depth, taxids, how)
        if keep.all() or not keep.any():
            raise SystemExit(f"file commands rfilter {how}: keeps "
                             f"{int(keep.sum())} of {len(keep)}")
        run(f"rfilter {how}", ["rfilter", *how.split(), "-C", "--data-dir",
                               ranked, t2["unik"], "-o", out("rfilter")])
        same_content(f"rfilter {how}", out("rfilter") + ".unik", codes[keep],
                     taxids[keep], taxid_flag, -1)
        say(f"file commands rfilter {how}: {int(keep.sum())} of "
            f"{len(keep)} codes, equal to the oracle's "
            f"({seconds[f'rfilter {how}']} s)")
        os.remove(out("rfilter") + ".unik")
    shutil.rmtree(ranked)
    # head, sample and filter of A, block by block
    a_unik = uniks[0]
    h = read_unik(a_unik)[0]
    edges = block_bounds(a_unik)
    blocks = [(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])]
    if edges[-1] != len(an):
        raise SystemExit("file commands: A's file does not hold A's codes")

    def tax(n):
        return np.full(n, h.global_taxid, np.uint32)

    run(f"head -n {head_n}", ["head", "-n", str(head_n), "-C", a_unik, "-o",
                              out("head")])
    write_oracle_blocks(out("head.oracle"), 23, h.flag | unik.INCLUDE_TAXID, (
        (an[lo:min(hi, head_n)], tax(min(hi, head_n) - lo))
        for lo, hi in blocks if lo < head_n))
    holds(f"head -n {head_n}", out("head") + ".unik", out("head.oracle"))
    idx = np.arange(1, len(an) + 1)
    picked = (idx >= 3) & ((idx - 3) % 7 == 0)
    run("sample -s 3 -w 7", ["sample", "-s", "3", "-w", "7", "-C", a_unik,
                             "-o", out("sample")])
    write_oracle_blocks(out("sample.oracle"), 23, h.flag | unik.INCLUDE_TAXID,
                        ((an[lo:hi][picked[lo:hi]],
                          tax(int(picked[lo:hi].sum())))
                         for lo, hi in blocks if picked[lo:hi].any()))
    holds("sample -s 3 -w 7", out("sample") + ".unik", out("sample.oracle"))
    del idx, picked
    # every block's mask on dev; the peak over what was resident before
    masked, real_mask = [], filter_cmd.low_complexity_mask

    def mask_on(x, *args):
        masked.append(x.device.type)
        return real_mask(x, *args)

    resident = torch.cuda.memory_allocated()
    filter_cmd.low_complexity_mask = mask_on
    try:
        peak = run("filter", ["filter", "-C", a_unik, "-o", out("filter")])
    finally:
        filter_cmd.low_complexity_mask = real_mask
    if masked != [dev.type] * len(blocks):
        raise SystemExit(f"file commands filter: masks on {masked}, not one "
                         f"on {dev.type} for each of {len(blocks)} blocks")
    low = sets["a_low"]
    write_oracle_blocks(out("filter.oracle"), 23, h.flag, (
        (an[lo:hi][~low[lo:hi]], None) for lo, hi in blocks))
    holds("filter", out("filter") + ".unik", out("filter.oracle"))
    for f in ("head", "sample", "filter"):
        os.remove(out(f) + ".unik")
        os.remove(out(f + ".oracle"))
    block = an[:1 << 20]
    x = torch.from_numpy(block.view(np.int64)).to(dev)
    mask = {"blocks": len(blocks), "kept": int((~low).sum()),
            "peak_bytes": peak - resident,
            "mask_ms": round(cuda_ms(lambda: low_complexity_mask(x, 23), 20),
                             5),
            "block_mask_ms": round(cuda_ms(
                lambda: block_mask(block, dev, 23, 3, 1, 15, 7), 20), 5)}
    del x
    say(f"file commands filter: mask of a {len(block)}-code block "
        + json.dumps(mask))
    if os.path.exists(stmp) and os.listdir(stmp):
        raise SystemExit(f"file commands: {stmp} was left non-empty")
    return {"seconds": seconds, "filter": mask}


# ---------------------------------------------------------------------------
# genome commands: locate, map and view -g over the sets path's record A

GENOME_QUERY = 1 << 20  # codes of locate's and view -g's query files
MAP_RECORDS = 1024  # the multi-record genome cut from A
MAP_RECORD_BASES = 12288
ORACLE_LUT = np.full(256, 4, np.uint8)  # ACGT -> 0-3, any other byte 4
ORACLE_LUT[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def record_sequence(path: str) -> bytes:
    """The sequence of a FASTA of one record on one line
    (write_one_record's)."""
    with open(path, "rb") as f:
        raw = f.read()
    return raw[raw.index(b"\n") + 1:].rstrip(b"\n")


def windows_oracle(seq: bytes, k: int, hashed: bool = False):
    """(codes, positions) of the valid windows of seq: canonical 2-bit
    codes (numpy_windows) or ntHash v1 (nthash_oracle)."""
    bases = ORACLE_LUT[np.frombuffer(seq, np.uint8)]
    return (nthash_oracle if hashed else numpy_windows)(bases, k, True)


def dense_oracle(seqs, k: int) -> list:
    """map's windows of each record: each start's code, SENT where the
    window is invalid (the JAX package's ``_seq_codes``), from one pass
    over the records joined by invalid bases."""
    joined = b"\n".join(seqs) + b"\n"
    codes, pos = windows_oracle(joined, k)
    dense = np.full(len(joined), SENT, np.uint64)
    dense[pos] = codes
    out, at = [], 0
    for seq in seqs:
        out.append(dense[at:at + len(seq) - k + 1])
        at += len(seq) + 1
    return out


def member_any_np(ref: np.ndarray, q: np.ndarray) -> np.ndarray:
    """member_np's hits for queries in any order, searched in sorted
    order (np.searchsorted of 3.4 x 10^7 queries in random order spent
    most of a minute on the card's host in cache misses)."""
    order = np.argsort(q)
    hit = np.empty(len(q), bool)
    hit[order] = member_np(ref, q[order])[1]
    return hit


def bed6_oracle(codes, pos, seq: bytes, rid: bytes, k: int,
                printed: np.ndarray) -> bytes:
    """locate's lines: for each code of ``printed`` in turn, every
    position of the sorted (codes, pos) index that holds it."""
    s = np.searchsorted(codes, printed, "left")
    n = np.searchsorted(codes, printed, "right") - s
    sel = np.repeat(s, n) + (np.arange(int(n.sum()))
                             - np.repeat(np.cumsum(n) - n, n))
    return b"".join(b"%s\t%d\t%d\t%s\t0\t.\n" % (rid, p, p + k, seq[p:p + k])
                    for p in pos[sel].tolist())


def regions_oracle(rid: bytes, seq: bytes, k: int, match: np.ndarray,
                   term: np.ndarray, opt: dict) -> bytes:
    """map's output for one record from its windows' match and
    terminator masks (map.go as unikmer_tpu/cli/commands/map.py reads
    it): a region grows over matched windows, across at most opt["X"]
    gaps of at most opt["x"] unmatched windows, ends at its last match,
    is cut by a terminator past that match and is kept from opt["m"]
    bases."""
    out = []

    def emit(start, last):
        if last - start + k < opt["m"]:
            return
        if opt["a"]:
            sub = seq[start:last + k]
            out.append(b">%s:%d-%d\n" % (rid, start + 1, last + k)
                       + b"\n".join(sub[i:i + LINE]
                                    for i in range(0, len(sub), LINE))
                       + b"\n")
        else:
            out.append(b"%s\t%d\t%d\n" % (rid, start, last + k))

    eff = np.concatenate([[False], match & ~term, [False]])
    run_s = np.flatnonzero(eff[1:] & ~eff[:-1]).tolist()
    run_e = (np.flatnonzero(eff[:-1] & ~eff[1:]) - 1).tolist()
    terms = np.flatnonzero(term).tolist()
    start = last = -1
    gaps = ti = 0
    for s, e in zip(run_s, run_e):
        while ti < len(terms) and terms[ti] < s:
            if start >= 0 and terms[ti] > last:
                emit(start, last)
                start = -1
            ti += 1
        if start < 0:
            start, last, gaps = s, e, 0
        elif s == last + 1:
            last = e
        elif s - last - 1 <= opt["x"] and gaps < opt["X"]:
            gaps, last = gaps + 1, e
        else:
            emit(start, last)
            start, last, gaps = s, e, 0
    if start >= 0:
        emit(start, last)
    return b"".join(out)


def map_oracle(records, k: int, query: np.ndarray, opts) -> list:
    """map's output over one genome file of linear records for each
    option set of ``opts``; ``records`` are (id, sequence, dense_oracle
    windows): a window matches when its code is in ``query``; unless
    opt["M"] a match is a terminator when its code matches twice or more
    in its unit, the record or (opt["W"]) the file."""
    dense = np.concatenate([d for _, _, d in records])
    cuts = np.cumsum([len(d) for _, _, d in records])[:-1]
    match = member_any_np(query, dense)

    def multi_codes(hits):
        u, c = np.unique(hits, return_counts=True)
        return u[c >= 2]

    terms = {}
    out = []
    for opt in opts:
        key = "M" if opt["M"] else opt["W"]
        if key == "M":
            terms[key] = np.zeros(len(dense), bool)
        elif key not in terms and opt["W"]:
            terms[key] = member_any_np(multi_codes(dense[match]),
                                       dense) & match
        elif key not in terms:
            terms[key] = np.concatenate([
                member_np(multi_codes(d[m]), d)[1] & m
                for d, m in zip(np.split(dense, cuts),
                                np.split(match, cuts))])
        out.append(b"".join(
            regions_oracle(rid, seq, k, m, t, opt) for (rid, seq, _), m, t
            in zip(records, np.split(match, cuts),
                   np.split(terms[key], cuts))))
    return out


def genome_path(tmp, rng, sets: dict, dev, n_query: int = GENOME_QUERY,
                m_records: int = MAP_RECORDS,
                m_bases: int = MAP_RECORD_BASES) -> dict:
    """The genome commands over the sets path's record A (its FASTA,
    ``sets["a_fa"]``, and the codes of A and B), each run through the
    CLI and held to its oracle's bytes:

      locate -g A q1          q1: n_query codes of diff A B and those of
      locate -g A --circular q1   the k-1 windows across A's end
      locate -g A q1 q2       q2: half of q1's codes, others of diff A B
                              and codes of B alone (missed: no line), so
                              a code is printed once
      locate, forced host     UNIKMER_TPU_MAX_ELEMS below A's windows:
                              the index sorted on the host (no K3)
      map -m 200 -g A diff    the regions of A that B lacks (diff: all of
                              diff A B), with -x 5 -X 2, with -M, with -a
      map -m 200 -g M diff    M: m_records records of m_bases cut from
                              the end of A, each sharing a third of its
                              bases with the next (-W's terminators) and
                              with a repeat inside (terminators without
                              -W); without and with -W, and once with
                              UNIKMER_TPU_MAX_ELEMS below M's bases (the
                              host route: numpy membership, no K3)
      count -k 31 -K -H A     held to the ntHash oracle
      view -g A hq            hq: n_query of its hashes and 16 that A
                              lacks (the per-row path and its warnings)

    The oracles restate models/locate.py and the map command in numpy
    over this script's windows: one stable argsort for the index (the
    circular one, whose entries before position len - k + 1 make the
    linear one), np.searchsorted and np.unique.  Each call runs on
    ``dev`` with its K1/H1/K2/K3 launches counted and its stages
    recorded; the forced-host call's launches stay out of the returned
    ones.  Returns {"launches": ..., "row": the genome line}."""
    from unikmer_tpu_torch.cli.commands import locate as locate_cmd
    from unikmer_tpu_torch.cli.commands import map as map_cmd
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.models import locate as locate_model

    on_card = dev.type == "cuda"
    k, rid = 23, b"A"
    a_fa = sets["a_fa"]
    an, bn = sets["a"][0], sets["b"][0]
    calls, oracle_s = {}, {}
    launches = {"k1": 0, "h1": 0, "k2": 0, "k3": 0}
    built, scans = [], []
    real_build = locate_model.build_genome_index
    real_scan = map_cmd.GenomeScan

    def spy(*a, **kw):
        idx = real_build(*a, **kw)
        built.append(idx)
        return idx

    class ScanSpy(real_scan):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            scans.append(self)

    def path(name):
        return os.path.join(tmp, f"gn_{name}")

    def call(name, argv, need, want: bytes, windows=None, out=None,
             count=True):
        """One CLI call, counted, its output file held to ``want``."""
        need = {key: must and on_card for key, must in need.items()}
        built.clear()
        scans.clear()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs, got, st = counted_cli(argv, need)
        row = {"s": round(secs, 4),
               "peak_bytes": torch.cuda.max_memory_allocated() - resident,
               "stages": {key: round(v, 4) for key, v in st.seconds.items()},
               "launches": {key: v for key, v in got.items() if v}}
        if built:
            row.update(windows=len(built[0].seq_idx), route=built[0].route)
        elif windows is not None:
            row["windows"] = windows
        if scans:
            row["route"] = sorted(set(scans[0].routes.values()))
        if count:
            for key in launches:
                launches[key] += got[key]
        out = out or argv[argv.index("-o") + 1]
        with open(out, "rb") as f:
            body = f.read()
        os.remove(out)
        if body != want:
            raise SystemExit(f"genome {name}: {len(body)} bytes differ from "
                             f"the oracle's {len(want)}")
        calls[name] = row
        say(f"genome {name}: {len(want)} bytes equal to the oracle's "
            + json.dumps(row))

    t0 = time.perf_counter()
    seq = record_sequence(a_fa)
    length = len(seq)
    circ = seq + seq[:k - 1]  # the k-1 windows across the end
    codes, pos = windows_oracle(circ, k)
    order = np.argsort(codes, kind="stable")
    icodes, ipos = codes[order], pos[order]
    linear = ipos <= length - k
    lcodes, lpos = icodes[linear], ipos[linear]
    dense = np.full(length - k + 1, SENT, np.uint64)
    keep = pos <= length - k
    dense[pos[keep]] = codes[keep]
    wrap = codes[~keep]  # found by the circular index alone
    del codes, pos, order, linear, keep
    diff = an[~member_np(bn, an)[1]]
    q1 = np.unique(np.concatenate([
        rng.choice(diff, n_query - len(wrap), replace=False), wrap]))
    b_only = bn[~member_np(an, bn)[1]]
    q2 = np.unique(np.concatenate([
        q1[::2], rng.choice(diff, n_query // 4, replace=False),
        rng.choice(b_only, n_query // 16, replace=False)]))
    flag = unik.SORTED | unik.CANONICAL
    for name, x in (("q1", q1), ("q2", q2), ("diff", diff)):
        write_oracle(path(name) + ".unik", k, flag, x)
    oracle_s["index and inputs"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    want = bed6_oracle(lcodes, lpos, seq, rid, k, q1)
    wants = {"locate": want,
             "locate --circular": bed6_oracle(icodes, ipos, circ, rid, k,
                                              q1),
             "locate q1 q2": want + bed6_oracle(
                 lcodes, lpos, seq, rid, k, q2[~member_np(q1, q2)[1]])}
    del icodes, ipos, lcodes, lpos
    oracle_s["locate"] = round(time.perf_counter() - t0, 3)
    loc_need = {"k1": True, "h1": False, "k2": False, "k3": True}
    q1u, q2u = path("q1") + ".unik", path("q2") + ".unik"
    locate_model.build_genome_index = locate_cmd.build_genome_index = spy
    map_cmd.GenomeScan = ScanSpy
    try:
        for name, argv in (
                ("locate", ["-g", a_fa, q1u]),
                ("locate --circular", ["-g", a_fa, "--circular", q1u]),
                ("locate q1 q2", ["-g", a_fa, q1u, q2u])):
            call(name, ["locate", *argv, "-o", path("out")], loc_need,
                 wants[name])
        with max_elems(length // 2):
            call("locate (forced host)", ["locate", "-g", a_fa, q1u, "-o",
                                          path("out")],
                 {"k1": True, "k2": False, "k3": False}, want, count=False)
        routes = [calls[n].get("route") for n in ("locate",
                                                  "locate (forced host)")]
        if routes != ["device", "host"]:
            raise SystemExit(f"genome locate: routes {routes}, not device "
                             f"then host")
        del want, wants

        # map over A, then over M
        t0 = time.perf_counter()
        base = dict(m=200, x=0, X=0, M=False, W=False, a=False)
        a_rec = [(rid, seq, dense)]
        wants = dict(zip(("-x 5 -X 2", "-M", "-a"), map_oracle(
            a_rec, k, diff, ({**base, "x": 5, "X": 2}, {**base, "M": True},
                             {**base, "a": True}))))
        del a_rec, dense
        # neighbours share a third of their bases; the records end where
        # A ends, in the half B lacks
        stride = 2 * m_bases // 3
        off = max(length - (m_records - 1) * stride - m_bases, 0)
        m_recs = []
        for i in range(m_records):
            r = bytearray(seq[off + i * stride:off + i * stride + m_bases])
            r[-400:-100] = r[100:400]  # a repeat inside the record
            m_recs.append((b"m%d" % i, bytes(r)))
        m_fa = path("M.fa")
        with open(m_fa, "wb") as f:
            f.writelines(b">%s\n%s\n" % rec for rec in m_recs)
        m_dense = list(zip(*zip(*m_recs), dense_oracle(
            [s for _, s in m_recs], k)))
        wants["M"], wants["M -W"] = map_oracle(m_dense, k, diff, (
            base, {**base, "W": True}))
        del m_dense, m_recs
        if wants["M"].count(b"\n") < 2 or wants["M"] == wants["M -W"]:
            raise SystemExit("genome map M: no region, or -W cut none")
        oracle_s["map"] = round(time.perf_counter() - t0, 3)
        map_need = {"k1": True, "h1": False, "k2": True, "k3": True}
        for name, flags, genome, windows in (
                ("-x 5 -X 2", ["-x", "5", "-X", "2"], a_fa, length),
                ("-M", ["-M"], a_fa, length), ("-a", ["-a"], a_fa, length),
                ("M", [], m_fa, m_records * m_bases),
                ("M -W", ["-W"], m_fa, m_records * m_bases)):
            call(f"map {name}", ["map", "-m", "200", *flags, "-g", genome,
                                 path("diff") + ".unik", "-o", path("out")],
                 {**map_need, "k3": name != "-M"}, wants[name], windows)
        # past map's budget: the windows fetched, the rest numpy (no K3)
        with max_elems(m_records * m_bases // 2):
            call("map M (forced host)", ["map", "-m", "200", "-g", m_fa,
                                         path("diff") + ".unik", "-o",
                                         path("out")],
                 {**map_need, "k3": False}, wants["M"], m_records * m_bases,
                 count=False)
        routes = [calls[n].get("route") for n in ("map M",
                                                  "map M (forced host)")]
        if routes != [["device"], ["host"]]:
            raise SystemExit(f"genome map: routes {routes}, not device "
                             f"then host")
        os.remove(m_fa)
        del wants

        # count -k 31 -K -H of A, then view -g of its hashes
        t0 = time.perf_counter()
        hcodes, hpos = windows_oracle(seq, 31, hashed=True)
        hu, first = np.unique(hcodes, return_index=True)
        first = hpos[first]
        del hcodes, hpos
        hflag = flag | unik.HASHED
        with numpy_host():
            write_oracle(path("h31.oracle"), 31, hflag, hu)
        with open(path("h31.oracle"), "rb") as f:
            want = f.read()
        os.remove(path("h31.oracle"))
        lacks = np.random.default_rng(SEED).integers(
            0, 1 << 64, size=64, dtype=np.uint64)
        lacks = lacks[~member_np(hu, lacks)[1]][:16]
        pick = np.sort(rng.choice(len(hu), n_query, replace=False))
        hq = np.unique(np.concatenate([hu[pick], lacks]))
        write_oracle(path("hq") + ".unik", 31, hflag, hq)
        at, found = member_np(hu, hq)
        where = first[at].tolist()
        want_v = b"".join(seq[p:p + 31] + b"\n" if ok else b"%d\n" % c
                          for p, ok, c in zip(where, found.tolist(),
                                              hq.tolist()))
        del hu, first
        oracle_s["count -H and view -g"] = round(time.perf_counter() - t0, 3)
        call("count -k 31 -K -H", ["count", "-k", "31", "-K", "-H", "-s",
                                   "-C", a_fa, "-o", path("h31")],
             {"k1": False, "h1": True, "k2": True, "k3": False}, want,
             windows=length, out=path("h31") + ".unik")
        call("view -g", ["view", "-g", a_fa, path("hq") + ".unik", "-o",
                         path("out")],
             {"k1": False, "h1": True, "k2": False, "k3": True}, want_v)
    finally:
        locate_model.build_genome_index = real_build
        locate_cmd.build_genome_index = real_build
        map_cmd.GenomeScan = real_scan
    for name in ("q1", "q2", "diff", "hq"):
        os.remove(path(name) + ".unik")
    os.remove(a_fa)
    row = {"calls": calls, "oracle_s": oracle_s, "query_codes": n_query,
           "diff_codes": len(diff), "M": [m_records, m_bases]}
    say(json.dumps({"genome": row}))
    return {"launches": launches, "row": row}


# ---------------------------------------------------------------------------
# mesh: the sharded build and set operations of parallel/sharded.py, D
# shards on one card, each output held to its single-device twin

MESH_SHARDS = 4
MESH_KEYS = ("k1", "h1", "s1", "k2", "k3")


def mesh_path(tmp, inputs: dict, dev, shards: int = MESH_SHARDS) -> dict:
    """``count --mesh 1`` through the CLI and the sharded library entries
    over ``shards`` shards on ``dev`` (make_mesh(devices=[dev] * shards)),
    each output held to the single-device output of the same input (which
    the earlier phases hold to their oracles), beside that run's time:

      count --mesh 1       the main path's CLI count; byte-equal to its
                           .unik (``inputs["k23"]``)
      stream k23, k23 -d   mesh_count_stream_packed over the main FASTA
                           against count_stream_packed
      stream -H, -W 15     the same over its first record (k = 31)
      -T T1, -T T2         mesh_count_taxids against
                           count_taxids_from_packed (paths, table tier)
      union ... common 2   mesh_set_op over the sets path's A, B and C
                           against KmerSet's union_all, &, - and common
      taxid ops            mesh_set_op_taxids over the same files with
                           their global taxids, both LCA tiers, against
                           the sets path's CLI oracle (the table tier's
                           union also against union_taxids_device)
      CLI --mesh 1         union -s, inter, diff -s, common -n 2 over
                           the files: byte-equal to the sets path's
                           oracle files, the --mesh 0 outputs

    ``inputs``: "fa", "k23", "taxdump", "taxid" ([(name, FASTA, tier)]),
    "uniks", "oracle" ({op: (codes, taxids)}) and "written" ({op: the
    oracle .unik}); the FASTA files of "taxid" and the "written" files are
    removed.  Every run's K1/H1/S1/K2/K3 launches are counted (those of
    the single-device twins apart); returns {"launches": the mesh runs'
    launches, "row": the mesh line}."""
    from unikmer_tpu_torch import KmerSet
    from unikmer_tpu_torch.io.fastx import (
        pack_files, pack_records, parse_taxid_records, read_fastx,
    )
    from unikmer_tpu_torch.models.count import (
        CountConfig, count_stream_packed, count_taxids_from_packed,
    )
    from unikmer_tpu_torch.ops.device_sets import union_taxids_device
    from unikmer_tpu_torch.parallel import sharded
    from unikmer_tpu_torch.parallel.mesh import make_mesh
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    on_card = dev.type == "cuda"
    mesh = make_mesh(devices=[dev] * shards)
    added = dict.fromkeys(MESH_KEYS, 0)
    runs = {}

    def timed(fn):
        """(result, seconds, peak bytes above what was resident, launches)."""
        wrappers = encode_wrappers()
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        return out, secs, peak, {k: w.launches for k, w in wrappers.items()}

    def run(name, mesh_fn, single, need, same, codes=len):
        """The mesh run, then its single-device twin (a function, or a
        time taken elsewhere), each timed; raises unless the mesh run
        launched exactly the kernels ``need`` names (on the card) and
        same(mesh output, twin's output)."""
        got, secs, peak, launches = timed(mesh_fn)
        wrong = {key for key in MESH_KEYS
                 if (launches[key] > 0) != (key in need and on_card)}
        if wrong:
            raise SystemExit(f"mesh {name}: launches {launches}, expected "
                             f"{sorted(need)}")
        for key in added:
            added[key] += launches[key]
        row = {"s": round(secs, 4), "peak_bytes": peak}
        want = None
        if callable(single):
            want, s_secs, s_peak, s_launches = timed(single)
            row.update(single_s=round(s_secs, 4), single_peak_bytes=s_peak,
                       single_launches={k: v for k, v in s_launches.items()
                                        if v})
        else:
            row["single_s"] = single
        if not same(got, want):
            raise SystemExit(f"mesh {name}: differs from the single-device "
                             f"output")
        if not callable(single):
            row["single_from"] = "the sets line's --mesh 0 CLI run"
        row.update(codes=codes(got),
                   launches={k: v for k, v in launches.items() if v})
        runs[name] = row
        say(f"mesh {name}: " + json.dumps(row))

    def arrays_equal(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return len(got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want))

    t_phase = time.perf_counter()
    # count --mesh 1 through the CLI, byte-equal to the main path's output
    out = os.path.join(tmp, "mesh1")
    argv = ["count", "-k", "23", "-K", "-s", "-C", inputs["fa"], "-o"]
    run("count --mesh 1", lambda: run_cli([*argv, out, "--mesh", "1"]),
        lambda: run_cli([*argv, out + ".single"]), ("k1", "k2"),
        lambda *_: same_bytes(out + ".unik", inputs["k23"])
        and same_bytes(out + ".single.unik", inputs["k23"]),
        codes=lambda _: unik_number(out + ".unik"))
    for f in (out + ".unik", out + ".single.unik"):
        os.remove(f)

    # the streamed build over the main FASTA, then its first record
    packed = pack_files([inputs["fa"]], 23)
    for name, mode in (("k23", "distinct"), ("k23 -d", "repeated")):
        cfg = CountConfig(k=23, canonical=True, mode=mode)
        run(f"stream {name}",
            lambda cfg=cfg: sharded.mesh_count_stream_packed([packed], cfg,
                                                             mesh),
            lambda cfg=cfg: count_stream_packed([packed], cfg, device=dev),
            ("k1", "k2"), arrays_equal)
    del packed
    first = next(iter(read_fastx(inputs["fa"])))
    packed = pack_records([first], 31)
    del first
    for name, cfg, need in (
            ("-k 31 -K -H", CountConfig(k=31, canonical=True, hashed=True),
             ("h1", "k2")),
            ("-k 31 -W 15", CountConfig(k=SKETCH_K, minimizer_w=SKETCH_W),
             ("h1", "s1", "k2"))):
        run(f"stream {name}",
            lambda cfg=cfg: sharded.mesh_count_stream_packed([packed], cfg,
                                                             mesh),
            lambda cfg=cfg: count_stream_packed([packed], cfg, device=dev),
            need, arrays_equal)
    del packed

    # count -T, the paths tier (T1) and the table tier (T2)
    taxdb = load_taxonomy(inputs["taxdump"])
    re_t = re.compile(RE_TAXID.encode())
    cfg = CountConfig(k=23, canonical=True)
    for name, fa, tier in inputs["taxid"]:
        packed, rec_taxids = parse_taxid_records(
            read_fastx(fa), cfg.k, cfg.circular, cfg.record_gap, re_t)
        os.remove(fa)
        run(f"-T {name} ({tier} tier)",
            lambda: sharded.mesh_count_taxids(packed, rec_taxids, taxdb, cfg,
                                              mesh),
            lambda: count_taxids_from_packed(packed, rec_taxids, cfg, taxdb,
                                             dev),
            ("k1", "k3"), arrays_equal, codes=lambda r: len(r[0]))
    del packed, rec_taxids

    # the set operations over A, B and C
    files = [read_unik(u) for u in inputs["uniks"]]
    codes = [c for _, c, _ in files]
    taxids = [np.full(len(c), h.global_taxid, np.uint32) for h, c, _ in files]
    del files
    kw = dict(canonical=True, assume_sorted_unique=True, device=dev)
    a, b, c = (KmerSet.from_codes(x, 23, **kw) for x in codes)
    single = {"union": lambda: KmerSet.union_all([a, b, c]).to_numpy(),
              "inter": lambda: (a & b & c).to_numpy(),
              "diff": lambda: (a - KmerSet.union_all([b, c])).to_numpy(),
              "common": lambda: KmerSet.common([a, b, c], 2).to_numpy()}
    oracle = inputs["oracle"]
    for op, fn in single.items():
        run(f"{op} ({shards} shards)",
            lambda op=op: sharded.mesh_set_op(op, codes, mesh, 46,
                                              threshold=2),
            fn, ("k2",),
            lambda got, want, op=op: np.array_equal(got, want)
            and np.array_equal(got, oracle[op][0]))
    del a, b, c, single
    cli_s = inputs.get("cli_s", {})
    for tier, vocab_max in (("table", None), ("paths", "0")):
        if vocab_max is not None:
            os.environ["UNIKMER_TPU_TAXID_VOCAB_MAX"] = vocab_max
        try:
            for op in ("union", "inter", "diff", "common"):
                twin = cli_s.get(op if op != "union" else f"union ({tier} tier)")
                if op == "union":
                    twin = lambda: union_taxids_device(codes, taxids, taxdb,
                                                       46, dev)
                run(f"{op} taxids ({tier} tier, {shards} shards)",
                    lambda op=op: sharded.mesh_set_op_taxids(
                        op, codes, taxids, taxdb, mesh, 46, threshold=2),
                    twin, ("k2",) if op == "diff" else ("k3",),
                    lambda got, want, op=op: arrays_equal(got, oracle[op])
                    and (want is None or arrays_equal(got, want)),
                    codes=lambda r: len(r[0]))
        finally:
            os.environ.pop("UNIKMER_TPU_TAXID_VOCAB_MAX", None)
    del codes, taxids

    # the set-op CLI with --mesh 1: the --mesh 0 outputs' bytes
    out = os.path.join(tmp, "mesh_cli")
    for op, cmd in (("union", ["union", "-s"]), ("inter", ["inter"]),
                    ("diff", ["diff", "-s"]),
                    ("common", ["common", "-n", "2"])):
        run(f"CLI {' '.join(cmd)} --mesh 1",
            lambda cmd=cmd: run_cli([*cmd, "-C", "--data-dir",
                                     inputs["taxdump"], *inputs["uniks"],
                                     "-o", out, "--mesh", "1"]),
            cli_s.get(op if op != "union" else "union (table tier)"),
            ("k2",) if op == "diff" else ("k3",),
            lambda *_, op=op: same_bytes(out + ".unik",
                                         inputs["written"][op]),
            codes=lambda _: unik_number(out + ".unik"))
        os.remove(out + ".unik")
    for f in inputs["written"].values():
        os.remove(f)
    row = {"shards": shards, "devices": [str(d) for d in mesh],
           "runs": runs, "launches": added,
           "seconds": round(time.perf_counter() - t_phase, 3)}
    say(json.dumps({"mesh": row}))
    return {"launches": added, "row": row}


# ---------------------------------------------------------------------------
# distributed: rank processes over torch.distributed (pipeline/distributed.py)

DIST_SHARDS = 4  # D of every run; L = D / W local shards a rank
RANK_TIMEOUT = 300  # seconds a rank process may take


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_reference(run: dict):
    """(codes, taxids or None) a run's shards must hold: a .unik file's
    codes, or .npy files the parent wrote."""
    if run["ref"].endswith(".unik"):
        return read_unik(run["ref"])[1], None
    codes = np.load(run["ref"])
    return codes, (np.load(run["ref_taxids"]) if "ref_taxids" in run
                   else None)


def rank_count(run, group, mesh, dev):
    """(a)-(c): sharded_count_distinct over the run's files ->
    {shard: (codes, None)} of this rank's shards, fetched."""
    from unikmer_tpu_torch.models.count import CountConfig
    from unikmer_tpu_torch.pipeline import distributed
    from unikmer_tpu_torch.utils.stages import stage

    res = distributed.sharded_count_distinct(
        run["files"], CountConfig(**run["cfg"]), mesh, group=group)
    with stage("d2h", "cpu"):
        return {g: (c[: int(n)].cpu().numpy().view(np.uint64), None)
                for g, c, n in res}


def rank_taxids(run, group, mesh, dev):
    """(d): every rank makes T1's global halo rows and LCA plan, then
    supplies its own rows to build_sharded_taxids -> {shard: (codes,
    taxids)}."""
    from unikmer_tpu_torch.models.count import CountConfig
    from unikmer_tpu_torch.parallel import sharded
    from unikmer_tpu_torch.taxonomy.lca import (
        compact_ids, device_lca_plan, upload_plan,
    )
    from unikmer_tpu_torch.utils.stages import stage

    cfg = CountConfig(**run["cfg"])
    packed, rec_taxids, taxdb = run["inputs"]
    plan = device_lca_plan(taxdb, rec_taxids)
    spans = np.diff(np.append(packed.starts, len(packed.bases)))
    pos_ctax = np.repeat(compact_ids(plan[1], rec_taxids), spans)
    d, first = sharded.group_shards(mesh, group)
    front, back = sharded.shard_halos(cfg)
    mine = slice(first, first + len(mesh))
    rows = sharded.pack_host_shards(packed.bases, d, cfg.k, front, back)[mine]
    trows = sharded.pack_host_rows(pos_ctax, d, front, back,
                                   np.int32(0))[mine]
    (res,) = sharded.build_sharded_taxids(
        rows, trows, cfg, mesh, {dev: upload_plan(plan, dev)}, group)
    with stage("d2h", "cpu"):
        return {first + i: (c[: int(n)].cpu().numpy().view(np.uint64),
                            plan[1][t[: int(n)].cpu().numpy()])
                for i, (c, t, n) in enumerate(res)}


def rank_unions(run, group, mesh, dev):
    """(e): sharded_union_counts, or with taxids sharded_union_taxids,
    over A and B partitioned into this rank's shards -> {shard: (codes,
    taxids or None)}, and the total."""
    from unikmer_tpu_torch.parallel import sharded
    from unikmer_tpu_torch.taxonomy.lca import device_tables
    from unikmer_tpu_torch.utils.stages import stage

    (a, ta), (b, tb), taxdb = run["inputs"]
    d, first = sharded.group_shards(mesh, group)
    mine = slice(first, first + len(mesh))
    with stage("partition", dev):
        (ra, rta), (rb, rtb) = sharded._partition(
            [a, b], d, run["code_bits"], [ta, tb])[0]
        sa, sb = (sharded._upload(mesh, r[mine]) for r in (ra, rb))
    if run["taxids"]:
        sta, stb = (sharded._upload(mesh, r[mine].view(np.int32), np.int32)
                    for r in (rta, rtb))
        parent, depth, max_depth = device_tables(taxdb, dev)
        res, total = sharded.sharded_union_taxids(sa, sta, sb, stb, parent,
                                                  depth, max_depth, group)
    else:
        res, total = sharded.sharded_union_counts(sa, sb, run["code_bits"],
                                                  group)
        res = [(c, None, n) for c, n in res]
    with stage("d2h", "cpu"):
        out = {first + i: (c[: int(n)].cpu().numpy().view(np.uint64),
                           None if t is None
                           else t[: int(n)].cpu().numpy().astype(np.uint32))
               for i, (c, t, n) in enumerate(res)}
        return out, int(total)


def rank_setup(run: dict, dev):
    """Load what a run reads before its timed part: T1 parsed with the
    taxonomy, or the sets A and B with their twin (KmerSet's union, timed
    here) as the reference."""
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    if run["kind"] == "taxids":
        from unikmer_tpu_torch.io.fastx import parse_taxid_records, read_fastx
        from unikmer_tpu_torch.models.count import CountConfig

        cfg = CountConfig(**run["cfg"])
        packed, rec_taxids = parse_taxid_records(
            read_fastx(run["fa"]), cfg.k, cfg.circular, cfg.record_gap,
            re.compile(RE_TAXID.encode()))
        run["inputs"] = packed, rec_taxids, load_taxonomy(run["taxdump"])
        return rank_reference(run), None
    if run["kind"] == "unions":
        from unikmer_tpu_torch import KmerSet

        taxdb = load_taxonomy(run["taxdump"])
        ab = [(np.load(c), np.load(t)) for c, t in run["sets"]]
        run["inputs"] = (*ab, taxdb)
        kw = dict(canonical=True, assume_sorted_unique=True, device=dev)
        sets = [KmerSet.from_codes(c, 23, taxids=t if run["taxids"] else None,
                                   taxdb=taxdb, **kw) for c, t in ab]
        sync_card(dev)
        t0 = time.perf_counter()
        u = sets[0] | sets[1]
        want = (u.to_numpy(), u.taxids_to_numpy())
        return want, round(time.perf_counter() - t0, 4)
    return rank_reference(run), None


def sync_card(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_run(run, group, mesh, dev) -> dict:
    """One run of a rank: set-up, then the run timed with its launches
    zeroed just before and read just after, its stages and its peak;
    each of this rank's shards held to the reference's codes of the
    shard's range (for (e): the whole union, all 4 shards lie here)."""
    import torch.distributed as dist

    from unikmer_tpu_torch.models.count import CountConfig
    from unikmer_tpu_torch.parallel.sharded import partition_boundaries
    from unikmer_tpu_torch.utils.stages import record_stages

    (want, want_t), single_s = rank_setup(run, dev)
    fn = {"count": rank_count, "taxids": rank_taxids,
          "unions": rank_unions}[run["kind"]]
    wrappers = encode_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier(group)
    with record_stages() as st:
        t0 = time.perf_counter()
        got = fn(run, group, mesh, dev)
        sync_card(dev)
        secs = time.perf_counter() - t0
    row = {"s": round(secs, 4),
           "stages": {k: round(v, 4) for k, v in st.seconds.items()},
           "launches": {k: w.launches for k, w in wrappers.items()}}
    if dev.type == "cuda":
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - resident
    if single_s is not None:
        row["single_s"] = single_s
    if run["kind"] == "unions":
        got, row["total"] = got
        gc = np.concatenate([got[g][0] for g in sorted(got)])
        exact = row["total"] == len(want) and np.array_equal(gc, want)
        if run["taxids"]:
            exact = exact and np.array_equal(
                np.concatenate([got[g][1] for g in sorted(got)]), want_t)
    else:
        cfg = CountConfig(**run["cfg"])
        bnd = partition_boundaries(DIST_SHARDS, cfg, cfg.code_bits)
        cuts = np.append(np.searchsorted(want, bnd), len(want))
        exact = all(
            np.array_equal(c, want[cuts[g]: cuts[g + 1]])
            and (t is None or np.array_equal(
                t.astype(np.uint32), want_t[cuts[g]: cuts[g + 1]]))
            for g, (c, t) in got.items())
    row["exact"] = bool(exact)
    row["shards"] = {int(g): len(c) for g, (c, _) in got.items()}
    return row


def rank_main(spec_path: str, rank: int) -> int:
    """A rank process of the distributed phase: its start-up split, then
    each run of the spec (module docstring) over its local shards;
    prints its lines and one RANK json line."""
    import torch.distributed as dist

    from unikmer_tpu_torch import _kernels
    from unikmer_tpu_torch.parallel.mesh import make_mesh
    from unikmer_tpu_torch.pipeline import distributed

    spawn = float(os.environ["CHIP_SMOKE_SPAWN"])
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device(spec["device"])
    split = {"interpreter and imports": time.time() - spawn}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    if dev.type == "cuda":
        _kernels.load()
    t2 = time.perf_counter()
    group = distributed.initialize(f"127.0.0.1:{spec['port']}",
                                   spec["world"], rank, spec["backend"])
    t3 = time.perf_counter()
    split.update({"cuda context": t1 - t0, "kernels load": t2 - t1,
                  "init_process_group": t3 - t2})
    split = {k: round(v, 4) for k, v in split.items()}
    backend = dist.get_backend(group)
    say(f"rank {rank}/{spec['world']} ({backend}) start-up s: "
        + json.dumps(split))
    mesh = make_mesh(devices=[dev] * (DIST_SHARDS // spec["world"]))
    runs = {}
    for run in spec["runs"]:
        runs[run["name"]] = rank_run(run, group, mesh, dev)
        say(f"rank {rank} {run['name']}: " + json.dumps(runs[run["name"]]))
    dist.destroy_process_group()
    say("RANK " + json.dumps({"rank": rank, "backend": backend,
                              "start_up_s": split, "runs": runs}))
    return 0


def start_ranks(tmp: str, name: str, world: int, backend, runs, dev):
    """Run ``world`` rank processes of this script over ``runs``.  A rank
    that exits non-zero, or runs past RANK_TIMEOUT, stops the others and
    fails the phase.  Prints the ranks' lines; returns their RANK lines."""
    spec = os.path.join(tmp, f"ranks_{name}.json")
    with open(spec, "w") as f:
        json.dump({"port": free_port(), "world": world, "backend": backend,
                   "device": str(dev), "runs": runs}, f)
    env = dict(os.environ, UNIKMER_TPU_TORCH_DEVICE=dev.type,
               UNIKMER_TPU_HOST_COUNT="0", LOCAL_RANK=str(dev.index or 0),
               CHIP_SMOKE_SPAWN=repr(time.time()))
    logs = [os.path.join(tmp, f"ranks_{name}.{r}.log") for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", spec,
                 str(r)], stdout=out, stderr=subprocess.STDOUT, env=env))
    deadline = time.time() + RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    lines = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        with open(log) as f:
            out = f.read().splitlines()
        os.remove(log)
        for ln in out:
            if not ln.startswith("RANK "):
                say(f"  [{name} rank {r}] {ln}")
        if p.returncode != 0:
            raise SystemExit(f"distributed {name}: rank {r} exited "
                             f"{p.returncode} (timeout {RANK_TIMEOUT} s)")
        lines.append(json.loads([ln for ln in out
                                 if ln.startswith("RANK ")][0][5:]))
    os.remove(spec)
    return lines


def distributed_path(tmp, inputs: dict, dev) -> dict:
    """pipeline/distributed.py in rank processes of this script, D = 4
    shards in every run, each output held exactly to its reference:

      (a)  one rank (NCCL on the card, gloo on the CPU), 4 local shards:
           sharded_count_distinct -k 23 -K over the main FASTA's records
           written as 4 files; the main path's .unik codes, shard by
           shard (its range)
      (b)  two gloo ranks on the same device, 2 shards each: as (a),
           rank r reading files r and r + 2
      (c)  as (b), -k 31 -W 15 over the first record alone (rank 1 reads
           no file): the single-device count of it
      (d)  as (b), T1's -T build: every rank makes T1's 4 global rows
           and LCA plan and supplies its own two (build_sharded_taxids):
           count_taxids_from_packed's output
      (e)  as (a): sharded_union_counts and sharded_union_taxids of the
           sets path's A and B (their per-code taxids): KmerSet's A | B,
           the tree walk for the taxids, and the totals

    The single-process twins of (a)-(d) run here first, timed: (a) and
    (b) the same sharded_count_distinct with no group over 4 shards,
    (c) count_packed, (d) count_taxids_from_packed; (e)'s, KmerSet's
    union, in the rank process.  ``inputs``: "fa", "k23", "taxdump",
    "t1" (T1's FASTA, removed here) and "a", "b" ((codes, taxids)).
    Returns {"launches": the rank processes' launches, "row": the
    distributed line}."""
    from unikmer_tpu_torch.io.fastx import (
        pack_files, parse_taxid_records, read_fastx,
    )
    from unikmer_tpu_torch.models.count import (
        CountConfig, count_packed, count_taxids_from_packed,
    )
    from unikmer_tpu_torch.parallel.mesh import make_mesh
    from unikmer_tpu_torch.pipeline import distributed
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy
    from unikmer_tpu_torch.utils.stages import record_stages, stage

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    files = []
    for i, rec in enumerate(read_fastx(inputs["fa"])):
        files.append(os.path.join(tmp, f"dist{i}.fa"))
        with open(files[-1], "wb") as f:
            f.write(b">" + rec.name + b"\n" + rec.seq + b"\n")
    k23 = dict(k=23, canonical=True)
    sketch = dict(k=SKETCH_K, minimizer_w=SKETCH_W)
    twins = {}

    def twin(name, fn):
        """fn() timed with its stages recorded, as a rank records its run."""
        sync_card(dev)
        with record_stages() as st:
            t0 = time.perf_counter()
            out = fn()
            sync_card(dev)
        twins[name] = {"s": round(time.perf_counter() - t0, 4), "stages": {
            k: round(v, 4) for k, v in st.seconds.items()}}
        return out

    def count_4_shards():
        res = distributed.sharded_count_distinct(
            files, CountConfig(**k23), make_mesh(devices=[dev] * DIST_SHARDS))
        with stage("d2h", "cpu"):
            return np.concatenate([c[: int(n)].cpu().numpy().view(np.uint64)
                                   for _, c, n in res])

    # the twins, and the references the rank processes read
    want = read_unik(inputs["k23"])[1]
    if not np.array_equal(twin("4 shards, no group", count_4_shards), want):
        raise SystemExit("distributed: the 4-shard count without a group "
                         "differs from the main path's .unik")
    del want
    refs = {}
    w15 = twin("-W 15 single device", lambda: count_packed(
        pack_files(files[:1], SKETCH_K), CountConfig(**sketch), dev))
    refs["w15"] = os.path.join(tmp, "dist_w15.npy")
    np.save(refs["w15"], w15)
    cfg_t = CountConfig(**k23)
    taxdb = load_taxonomy(inputs["taxdump"])
    packed, rec_taxids = parse_taxid_records(
        read_fastx(inputs["t1"]), cfg_t.k, cfg_t.circular, cfg_t.record_gap,
        re.compile(RE_TAXID.encode()))
    t1c, t1t = twin("T1 single device", lambda: count_taxids_from_packed(
        packed, rec_taxids, cfg_t, taxdb, dev))
    del packed, rec_taxids
    refs["t1"], refs["t1_taxids"] = (os.path.join(tmp, f"dist_{n}.npy")
                                     for n in ("t1", "t1_taxids"))
    np.save(refs["t1"], t1c)
    np.save(refs["t1_taxids"], t1t)
    sets = []
    for name in "ab":
        paths = tuple(os.path.join(tmp, f"dist_{name}{x}.npy") for x in "ct")
        for p, x in zip(paths, inputs[name]):
            np.save(p, x)
        sets.append(paths)
    if on_card:
        torch.cuda.empty_cache()

    one = [{"name": "(a) k23, 4 files", "kind": "count", "cfg": k23,
            "files": files, "ref": inputs["k23"], "need": ["k1", "k2"],
            "twin": "4 shards, no group"},
           *({"name": f"(e) union{' taxids' if t else ''}", "kind": "unions",
              "taxids": t, "code_bits": 46, "sets": sets,
              "taxdump": inputs["taxdump"], "need": ["k3" if t else "k2"]}
             for t in (False, True))]
    two = [{"name": "(b) k23, 4 files", "kind": "count", "cfg": k23,
            "files": files, "ref": inputs["k23"], "need": ["k1", "k2"],
            "twin": "4 shards, no group"},
           {"name": "(c) -k 31 -W 15, 1 file", "kind": "count",
            "cfg": sketch, "files": files[:1], "ref": refs["w15"],
            "need": ["h1", "s1", "k2"], "twin": "-W 15 single device"},
           {"name": "(d) -T T1", "kind": "taxids", "cfg": k23,
            "fa": inputs["t1"], "taxdump": inputs["taxdump"],
            "ref": refs["t1"], "ref_taxids": refs["t1_taxids"],
            "need": ["k1", "k3"], "twin": "T1 single device"}]
    ranks = {"1 rank": (one, start_ranks(tmp, "one", 1, None, one, dev)),
             "2 ranks": (two, start_ranks(tmp, "two", 2, "gloo", two, dev))}
    launches = dict.fromkeys(MESH_KEYS, 0)
    runs = {}
    for group, (specs, lines) in ranks.items():
        for spec in specs:
            rows = [ln["runs"][spec["name"]] for ln in lines]
            shards = {}
            for r in rows:
                shards.update({int(g): n for g, n in r["shards"].items()})
            if not all(r["exact"] for r in rows) or sorted(shards) != list(
                    range(DIST_SHARDS)):
                raise SystemExit(f"distributed {spec['name']}: not exact, "
                                 f"or shards missing: {rows}")
            got = {k: sum(r["launches"][k] for r in rows) for k in MESH_KEYS}
            if any((got[k] > 0) != (k in spec["need"] and on_card)
                   for k in MESH_KEYS):
                raise SystemExit(f"distributed {spec['name']}: launches "
                                 f"{got}, expected {spec['need']}")
            for k in MESH_KEYS:
                launches[k] += got[k]
            runs[spec["name"]] = {
                "ranks": group, "backend": lines[0]["backend"],
                "s": max(r["s"] for r in rows),
                "single_s": rows[0].get("single_s") or twins[
                    spec["twin"]]["s"],
                "exchange_s": [r["stages"].get("exchange") for r in rows],
                "peak_bytes": [r.get("peak_bytes") for r in rows],
                "shard_codes": [shards[g] for g in sorted(shards)],
                "launches": {k: v for k, v in got.items() if v},
                "stages": [r["stages"] for r in rows],
                **({"total": rows[0]["total"]} if "total" in rows[0] else {})}
    for f in [*files, *refs.values(), *(p for s in sets for p in s),
              inputs["t1"]]:
        os.remove(f)
    row = {"shards": DIST_SHARDS, "device": str(dev), "twins_s": twins,
           "start_up_s": {f"{g} rank {ln['rank']} ({ln['backend']})":
                          ln["start_up_s"]
                          for g, (_, lines) in ranks.items() for ln in lines},
           "runs": runs, "launches": launches,
           "seconds": round(time.perf_counter() - t_phase, 3)}
    say(json.dumps({"distributed": row}))
    return {"launches": launches, "row": row}


# ---------------------------------------------------------------------------
# surface: the library API of docs/USAGE.md, the public sorts, the taxid
# route knob and the stream profiler


SURFACE_BASES = 1 << 24  # the USAGE snippet's FASTA
SURFACE_SORT_KEYS = 1 << 25  # sort_codes against torch.sort
SURFACE_PAIRS = 1 << 24  # sort_codes_taxids against numpy's lexsort
SURFACE_UNION_CODES = 1 << 17  # each small taxid .unik of the union runs
# the surface phase holds the launches it expects (on the CPU the plain
# versions count none, and the CPU tests turn this off)
SURFACE_COUNTS = True
PROFILE_HEADER = "# stream profile (exclusive wall per phase):"
PROFILE_TOTAL = "#   TOTAL(tracked)"


def zero_launches() -> dict:
    wrappers = encode_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def read_launches(wrappers: dict) -> dict:
    return {key: w.launches for key, w in wrappers.items()}


def surface_usage(tmp, rng) -> tuple:
    """The docs/USAGE.md library snippet on the port, on the card, over a
    seeded FASTA of SURFACE_BASES bases (k = 23, canonical): its codes
    equal to numpy's count; the codes through UnikWriter and back
    through UnikReader, whose accessors must give the header.  Returns
    (the FASTA, the oracle's codes, launches, row)."""
    fa = os.path.join(tmp, "surface.fa")
    write_one_record(fa, "surface", rng.integers(0, 4, size=SURFACE_BASES,
                                                 dtype=np.uint8))
    t0 = time.perf_counter()
    with numpy_host():
        from unikmer_tpu_torch.io.fastx import pack_files as np_pack

        want = numpy_count(np_pack([fa], 23).bases, 23, True, "distinct")
    oracle_s = time.perf_counter() - t0
    from unikmer_tpu_torch import (
        UNIK_MAIN_VERSION, CountConfig, UnikReader, UnikWriter, count_packed,
        pack_files,
    )
    from unikmer_tpu_torch.io import unik

    wrappers = zero_launches()
    t0 = time.perf_counter()
    codes = count_packed(pack_files([fa], k=23),
                         CountConfig(k=23, canonical=True))
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers)
    if not np.array_equal(codes, want):
        raise SystemExit(f"surface: the USAGE snippet gave {len(codes)} codes "
                         f"against numpy's {len(want)}")
    if SURFACE_COUNTS and (launches["k1"] < 1 or launches["k2"] < 1):
        raise SystemExit(f"surface: the USAGE snippet launched {launches}")
    path = os.path.join(tmp, "surface.unik")
    flag = unik.SORTED | unik.CANONICAL
    with UnikWriter(path, k=23, flag=flag, compress=False) as w:
        w.number = len(codes)
        w.write_codes(codes)
        try:
            w.number = 0
        except RuntimeError:
            pass
        else:
            raise SystemExit("surface: UnikWriter.number set after a write")
    with UnikReader(path) as r:
        got = (r.k, r.flag, r.number, r.header.main_version)
        back = r.read_all()[0]
    if got != (23, flag, len(codes), UNIK_MAIN_VERSION) or not np.array_equal(
            back, want):
        raise SystemExit(f"surface: UnikReader read {got}")
    os.remove(path)
    row = {"bases": SURFACE_BASES, "codes": len(codes), "s": round(secs, 4),
           "oracle_s": round(oracle_s, 3),
           "launches": {k: v for k, v in launches.items() if v}}
    say("surface USAGE snippet: exact, reader accessors " + json.dumps(row))
    return fa, want, launches, row


def surface_sorts(rng, dev) -> tuple:
    """sort_codes against torch.sort of the same 2^25 keys (64 bits, then
    46 bits with sort_code_bits(23, False) and its pass count), and of a
    numpy array; sort_codes_taxids against numpy's lexsort of 2^24 pairs
    with many equal codes: equal codes, and per code equal multisets of
    taxids.  Returns (launches, row)."""
    from unikmer_tpu_torch.ops.codec import SIGN
    from unikmer_tpu_torch.ops.radix_sort import (
        radix_sort_u64, radix_shifts,
    )
    from unikmer_tpu_torch.ops.sort import (
        sort_code_bits, sort_codes, sort_codes_taxids,
    )

    keys = torch.from_numpy(rng.integers(0, 1 << 64, size=SURFACE_SORT_KEYS,
                                         dtype=np.uint64).view(np.int64)
                            ).to(dev)
    bits = sort_code_bits(23, False)
    keys46 = keys & ((1 << bits) - 1)
    wrappers = zero_launches()
    passes = radix_sort_u64.passes_run + radix_sort_u64.passes_skipped
    got46 = sort_codes(keys46, bits)
    passes = radix_sort_u64.passes_run + radix_sort_u64.passes_skipped - passes
    got = sort_codes(keys)
    codes_np = rng.integers(0, 1 << 64, size=1 << 20, dtype=np.uint64)
    got_np = sort_codes(codes_np)
    pc = rng.integers(0, 1 << 20, size=SURFACE_PAIRS, dtype=np.uint64)
    pt = rng.integers(0, 1 << 32, size=SURFACE_PAIRS, dtype=np.uint32)
    sc, st = sort_codes_taxids(torch.from_numpy(pc.view(np.int64)).to(dev),
                               torch.from_numpy(pt.view(np.int32)).to(dev))
    sc_np, st_np = sort_codes_taxids(pc[:1 << 20], pt[:1 << 20])
    torch.cuda.synchronize()
    launches = read_launches(wrappers)
    ref = torch.sort(keys ^ SIGN).values ^ SIGN
    ref46 = torch.sort(keys46 ^ SIGN).values ^ SIGN
    if not (torch.equal(got, ref) and torch.equal(got46, ref46)):
        raise SystemExit("surface: sort_codes differs from torch.sort")
    if SURFACE_COUNTS and passes != len(radix_shifts(bits)):
        raise SystemExit(f"surface: sort_codes at {bits} bits ran {passes} "
                         f"passes")
    if not np.array_equal(got_np, np.sort(codes_np)):
        raise SystemExit("surface: sort_codes of a numpy array differs")
    for c, t, n in ((sc.cpu().numpy().view(np.uint64),
                     st.cpu().numpy().view(np.uint32), SURFACE_PAIRS),
                    (sc_np, st_np, 1 << 20)):
        want = np.lexsort((pt[:n], pc[:n]))
        mine = np.lexsort((t, c))
        if not (np.array_equal(c, pc[:n][want])
                and np.array_equal(c[mine], pc[:n][want])
                and np.array_equal(t[mine], pt[:n][want])):
            raise SystemExit(f"surface: sort_codes_taxids of {n} pairs "
                             f"differs from numpy's lexsort")
    if SURFACE_COUNTS and (launches["k2"] < 3 or launches["k3"] < 2):
        raise SystemExit(f"surface: the sorts launched {launches}")
    row = {"sort_codes_ms": round(cuda_ms(lambda: sort_codes(keys)), 4),
           "torch_sort_ms": round(cuda_ms(
               lambda: torch.sort(keys ^ SIGN).values ^ SIGN), 4),
           "keys": SURFACE_SORT_KEYS, "pairs": SURFACE_PAIRS,
           "passes_at_46_bits": passes,
           "launches": {k: v for k, v in launches.items() if v}}
    say("surface sorts: exact " + json.dumps(row))
    return launches, row


def surface_routes(tmp, rng, taxdump: str, t1_fa: str) -> tuple:
    """``union -s -C`` of two small seeded taxid .unik files in fresh
    processes under UNIKMER_TPU_DEVICE_TAXID auto (below the threshold:
    the host engine, no torch at exit), 1 (the card, K3) and 0 (the host
    engine), each byte-equal to the oracle (the sets path's LCA merge);
    then ``count -T`` of T1 under 0 (the host reduction: K1, no K3) and
    auto (K3), each byte-equal to T1's oracle.  Returns (launches, row)."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    taxdb = load_taxonomy(taxdump)
    known = np.flatnonzero(taxdb.depth >= 0)
    pool = rng.choice(known[known > 0], 256, replace=False).astype(np.uint32)
    a = np.unique(rng.integers(0, 1 << 46, size=SURFACE_UNION_CODES,
                               dtype=np.uint64))
    b = np.unique(np.concatenate([
        a[rng.integers(0, len(a), size=len(a) // 2)],
        rng.integers(0, 1 << 46, size=len(a) // 2, dtype=np.uint64)]))
    ta = rng.choice(pool, len(a)).astype(np.uint32)
    tb = rng.choice(pool, len(b)).astype(np.uint32)
    flag = unik.SORTED | unik.CANONICAL | unik.INCLUDE_TAXID
    ua, ub = (os.path.join(tmp, f"small_{n}.unik") for n in "ab")
    want = os.path.join(tmp, "small_union.oracle.unik")
    with numpy_host():
        write_oracle(ua, 23, flag, a, ta)
        write_oracle(ub, 23, flag, b, tb)
        u, tu = taxid_set_oracles(a, ta, b, tb, taxdb)["A | B (taxids)"]
        write_oracle(want, 23, flag, u, tu)
    launches = {"k1": 0, "k2": 0, "k3": 0}
    row = {"union_codes": len(u),
           "union_input_bytes": os.path.getsize(ua) + os.path.getsize(ub)}
    for knob, device in (("auto", False), ("1", True), ("0", False)):
        out = os.path.join(tmp, f"small_union_{knob}")
        secs, rc, imported, err, _ = fresh(
            ["union", "-s", "-C", "--data-dir", taxdump, ua, ub, "-o", out],
            {"UNIKMER_TPU_DEVICE_TAXID": knob})
        got = fresh_launches(err)
        if rc != 0 or not same_bytes(out + ".unik", want):
            raise SystemExit(f"surface: union under UNIKMER_TPU_DEVICE_TAXID="
                             f"{knob} exited {rc} or differs: {err[-2000:]}")
        if imported != device or (
                SURFACE_COUNTS and (got.get("k3", 0) > 0) != device):
            raise SystemExit(f"surface: union under UNIKMER_TPU_DEVICE_TAXID="
                             f"{knob}: torch imported {imported}, launches "
                             f"{got}")
        for key in launches:
            launches[key] += got.get(key, 0)
        row[f"union_{knob}_s"] = round(secs, 4)
        row[f"union_{knob}_torch"] = imported
        os.remove(out + ".unik")
    for path in (ua, ub, want):
        os.remove(path)
    t1_want = os.path.join(tmp, "T1.oracle.unik")
    for knob, k3 in (("0", False), ("auto", True)):
        out = os.path.join(tmp, f"T1_{knob}")
        os.environ["UNIKMER_TPU_DEVICE_TAXID"] = knob
        try:
            secs, got, st = counted_cli(
                ["count", "-k", "23", "-K", "-s", "-C", "-T", "-r", RE_TAXID,
                 "--data-dir", taxdump, t1_fa, "-o", out],
                {"k1": True, "k3": k3, "h1": False, "s1": False}
                if SURFACE_COUNTS else {})
        finally:
            os.environ["UNIKMER_TPU_DEVICE_TAXID"] = "1"
        if not same_bytes(out + ".unik", t1_want):
            raise SystemExit(f"surface: count -T of T1 under "
                             f"UNIKMER_TPU_DEVICE_TAXID={knob} differs from "
                             f"T1's oracle")
        for key in launches:
            launches[key] += got[key]
        row[f"count_T1_{knob}_s"] = round(secs, 4)
        row[f"count_T1_{knob}_stages"] = {
            s: round(v, 4) for s, v in st.seconds.items()}
        os.remove(out + ".unik")
    say("surface taxid routes: every output exact " + json.dumps(row))
    return launches, row


def surface_profile(tmp, fa: str, want) -> tuple:
    """A streamed ``count -k 23 -K -s -C`` of the snippet's FASTA without
    and with UNIKMER_TPU_PROFILE_STREAM=1: the report on stderr only with
    the knob, its header and TOTAL line present, the profiler off again
    after each count, both outputs the oracle's bytes.  Returns
    (launches, row)."""
    import io

    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.utils import stages

    oracle = os.path.join(tmp, "surface.oracle.unik")
    with numpy_host():
        write_oracle(oracle, 23, unik.SORTED | unik.CANONICAL, want)
    launches = {"k1": 0, "k2": 0, "k3": 0}
    row = {}
    for knob in ("0", "1"):
        out = os.path.join(tmp, f"surface_profile_{knob}")
        os.environ["UNIKMER_TPU_PROFILE_STREAM"] = knob
        wrappers = zero_launches()
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                t0 = time.perf_counter()
                run_cli(["count", "-k", "23", "-K", "-s", "-C", fa, "-o", out])
                secs = time.perf_counter() - t0
        finally:
            del os.environ["UNIKMER_TPU_PROFILE_STREAM"]
        got = read_launches(wrappers)
        text = err.getvalue()
        lines = text.splitlines()
        printed = PROFILE_HEADER in lines and any(
            ln.startswith(PROFILE_TOTAL) for ln in lines)
        if printed != (knob == "1") or (knob == "0" and text):
            raise SystemExit(f"surface: UNIKMER_TPU_PROFILE_STREAM={knob} "
                             f"printed: {text[-2000:]}")
        if not same_bytes(out + ".unik", oracle) or (
                SURFACE_COUNTS and got["k1"] < 1):
            raise SystemExit(f"surface: profiled count {knob} differs from "
                             f"the oracle or launched {got}")
        if stages._PROFILE is not None:
            raise SystemExit("surface: the stream profiler stayed on after "
                             "count, so later work in the process records")
        for key in launches:
            launches[key] += got[key]
        row[f"count_profile_{knob}_s"] = round(secs, 4)
        if knob == "1":
            row["report"] = lines
        os.remove(out + ".unik")
    os.remove(oracle)
    say("surface stream profile: " + json.dumps(row))
    return launches, row


def surface_path(tmp, rng, dev, taxdump: str, t1_fa: str) -> dict:
    """The surface phase (module docstring); returns its launches, to add
    to the kernels line, and the ``surface`` row."""
    t_phase = time.perf_counter()
    fa, want, launches, usage = surface_usage(tmp, rng)
    row = {"usage": usage}
    for name, (got, part) in (
            ("sorts", surface_sorts(rng, dev)),
            ("routes", surface_routes(tmp, rng, taxdump, t1_fa)),
            ("profile", surface_profile(tmp, fa, want))):
        row[name] = part
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n
    os.remove(fa)
    row["launches"] = {k: v for k, v in launches.items() if v}
    row["seconds"] = round(time.perf_counter() - t_phase, 3)
    say(json.dumps({"surface": row}))
    return {"launches": launches, "row": row}


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


def check_probes(dev, rng):
    """The four probe kernels held to their plain versions at the
    scripts' sizes and at ragged ones, then timed at the scripts' sizes
    (P1a and P1c in turns with their library calls); returns one result
    dict per kernel."""
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
    schedules = {"p1b": p1b, **{f"p2a_{s}": d for s, d in p2a.items()}}
    row = {}
    for sched, ds in schedules.items():
        fn = functools.partial(probes.row_cmpex_u32, blk, ds)
        t = turns_ms({"kernel": fn})["kernel"]
        row[sched] = dict(ms=t["median"], ms_spread=t["spread"],
                          device_ms=device_ms(fn, "row_cmpex"),
                          kernels_per_call=kernels_per_call(fn))
    out["P1b"] = dict(
        max_abs_err=err, **row["p1b"],
        plain_ms=cuda_ms(lambda: probes.row_cmpex_u32_plain(blk, p1b), 5),
        library_ms=None, bound_ms=bytes_ms(two_mib), bound_by="bytes",
        rows_held=sorted({int(x.shape[0]) for x, _ in row_cases}),
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


def machine_facts(dev) -> dict:
    """The driver, the CUDA versions, the card's uncorrected ECC errors,
    its UUID and the host's name: what tells one machine of a fault from
    another."""
    import ctypes
    import socket

    torch.zeros(1, device=dev)  # the context, so libcudart is loaded
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version,"
         "ecc.errors.uncorrected.volatile.total,uuid",
         "--format=csv,noheader"], capture_output=True, text=True)
    driver, ecc, uuid = q.stdout.strip().splitlines()[0].split(", ")
    runtime = "not found"
    with open("/proc/self/maps") as f:
        libs = {ln.split()[-1] for ln in f if "libcudart" in ln}
    for lib in sorted(libs):
        v = ctypes.c_int()
        if ctypes.CDLL(lib).cudaRuntimeGetVersion(ctypes.byref(v)) == 0:
            runtime = f"{v.value // 1000}.{v.value % 1000 // 10} ({lib})"
            break
    return {"driver_version": driver, "torch_cuda": torch.version.cuda,
            "cuda_runtime": runtime,
            "ecc_uncorrected_volatile_total": ecc, "card_uuid": uuid,
            "host": socket.gethostname()}


def smi_clocks(when: str) -> None:
    """Print the card's clocks and power draw as nvidia-smi reads them."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    say(f"clocks {when}: {q.stdout.strip()}")


def host_costs(dev, rng) -> dict:
    """host_us of every wrapper: host microseconds per call over
    HOST_CALLS un-synchronised calls, the median of 15 readings in turns,
    at inputs where the card keeps up with the host, so the reading is
    the launch path's: P1c and P2b at the probe's (4096, 128) block, the
    others at a few thousand elements.  K2 and K3 plan their passes on
    the card, so no call waits on it."""
    from unikmer_tpu_torch import probes as entry
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops import probes
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.collapse import collapse_pass
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
    sorted_keys = torch.sort(keys).values
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
        "c1": lambda: collapse_pass(sorted_keys, "distinct"),
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
    ("c1", "C1 collapse_pass", "unikmer_tpu_torch/csrc/collapse.cu",
     "unikmer_tpu/ops/sort.py:189-217 compact_sorted/compact_aux (XLA, no "
     "Pallas kernel)",
     ["unikmer_tpu/ops/sort.py:220-272", "unikmer_tpu/ops/device_sets.py:72-86"]),
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
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    say("machine: " + json.dumps(machine_facts(dev)))
    # every phase but the start-up one runs count's device route, and
    # every taxid union but the surface phase's the device taxid route:
    # small inputs would otherwise take the host engine (those phases
    # choose the routes themselves)
    os.environ["UNIKMER_TPU_HOST_COUNT"] = "0"
    os.environ["UNIKMER_TPU_DEVICE_TAXID"] = "1"
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    _kernels.load()
    say(f"kernel build+load seconds: {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    say(f"host engine: {native.engine()} "
        f"(build+load {time.perf_counter() - t0:.3f} s); the oracles: numpy")
    results = {
        "k1": check_k1(dev, rng), "h1": check_h1(dev, rng),
        "s1": check_s1(dev, rng), "k2": check_k2(dev, rng),
        "k3": check_k3(dev, rng), "c1": check_c1(dev, rng),
        **check_probes(dev, rng)}
    for key, us in host_costs(dev, rng).items():
        results[key]["host_us"] = us
    from unikmer_tpu_torch.ops.collapse import collapse_pass

    collapse_pass.launches = 0  # C1's launches from here: the phases'
    report = SetsReport()
    with tempfile.TemporaryDirectory(prefix="unikmer-torch-smoke-") as tmp:
        t0 = time.perf_counter()
        launches, mesh_in = main_path(tmp, rng, report)
        t_main = time.perf_counter()
        pipeline = pipeline_path(tmp, rng, dev, {
            "fa": mesh_in["fa"], "k23": mesh_in["k23"],
            "one": mesh_in.pop("one"), "k31H": mesh_in.pop("k31H"),
            "one_windows": mesh_in.pop("one_windows"),
            "fa2": mesh_in.pop("fa2"), "k31W": mesh_in.pop("k31W")})
        t_pipe = time.perf_counter()
        startup = startup_path(tmp, rng, mesh_in, dev, card)
        t = [time.perf_counter()]
        launches["k3"], t2, mesh_in["taxid"] = taxid_path(tmp, rng)
        t.append(time.perf_counter())
        linear_hashed_path(tmp, rng)
        compat_path(tmp, rng)
        t.append(time.perf_counter())
        kept = sets_path(tmp, rng, report)
        t.append(time.perf_counter())
        file_commands = file_commands_path(tmp, kept, t2, dev)
        del t2
        t.append(time.perf_counter())
        genome = genome_path(tmp, rng, kept, dev)
        t.append(time.perf_counter())
        surface = surface_path(tmp, rng, dev, kept["taxdump"],
                               mesh_in["taxid"][0][1])
        mesh_in.update({key: kept[key] for key in (
            "taxdump", "uniks", "oracle", "written", "cli_s")})
        # the mesh path removes T1's FASTA once read: a second name keeps
        # it for the distributed path
        t1 = mesh_in["taxid"][0][1]
        os.link(t1, t1 + ".dist")
        dist_in = {"fa": mesh_in["fa"], "k23": mesh_in["k23"],
                   "taxdump": kept["taxdump"], "t1": t1 + ".dist",
                   "a": kept["a"], "b": kept["b"]}
        del kept
        t.append(time.perf_counter())
        mesh = mesh_path(tmp, mesh_in, dev)
        del mesh_in
        t.append(time.perf_counter())
        dist = distributed_path(tmp, dist_in, dev)
        del dist_in
        t.append(time.perf_counter())
    say(f"path seconds: main {t_main - t0:.3f}, pipeline "
        f"{t_pipe - t_main:.3f}, start-up {t[0] - t_pipe:.3f}, "
        f"count -T {t[1] - t[0]:.3f}, "
        f"-l and compat {t[2] - t[1]:.3f}, sets {t[3] - t[2]:.3f}, "
        f"file commands {t[4] - t[3]:.3f}, genome {t[5] - t[4]:.3f}, "
        f"surface {t[6] - t[5]:.3f}, mesh {t[7] - t[6]:.3f}, "
        f"distributed {t[8] - t[7]:.3f}")
    say(json.dumps({"sets": report.rows}))
    say(json.dumps({"admission": report.admission}))
    say(json.dumps({"file_commands": file_commands}))
    say(json.dumps({"startup": startup}))
    launches["k2"] += report.launches["k2"]
    launches["k3"] += report.launches["k3"]
    for key, n in genome["launches"].items():
        launches[key] += n
    for key, n in mesh["launches"].items():
        launches[key] += n
    for key, n in dist["launches"].items():
        launches[key] += n
    for key, n in startup["launches"].items():
        launches[key] += n
    for key, n in surface["launches"].items():
        launches[key] += n
    for key, n in pipeline.items():
        launches[key] += n
    launches.update(probe_path())
    # C1's launches in this process's phases (fresh processes are not
    # counted)
    launches["c1"] = collapse_pass.launches
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         **({"also_replaces": also} if also else {}),
         "launches": launches[key], **results[key]}
        for key, name, source, replaces, also in KERNELS]}))
    say(f"chip_smoke total seconds: {time.perf_counter() - start:.3f} (aim "
        f"at most {SMOKE_AIM_S})")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:  # a rank process of distributed_path
        sys.exit(rank_main(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
