"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 encode, K2 radix sort, K3 key+value
radix sort, and the four P1/P2 probe kernels) from unikmer_tpu_torch/csrc,
holds each against its plain PyTorch version on the card (exact
equality), then drives the port's paths and holds their results against
oracles:

  count     ``count -k 23 -K -s -C`` over a 134 Mbp FASTA of 4 records
            (and -u, -d, k = 32 over one 50 Mbp record);
  count -T  over a synthetic 100,000-node taxonomy written as nodes.dmp:
            T1, 8,192 records of 4,000 bases, each with its own taxid,
            one piece of ~2^25 windows on the 'paths' LCA tier; T2,
            1,024 records of 98,304 bases with 512 taxids, streamed in
            pieces on the 'table' tier; T3, k = 32 -u over two 1 Mbp
            records, keeping a real 2^64-1 code with its taxid;
  probes    ``python -m unikmer_tpu_torch.probes``: P1a-P2b at the sizes
            of scripts/exp_pallas_dma*.py, each kernel held to its plain
            version inside the entry point.

The launch counters, zeroed before each path's run and read after it,
show that the run went through the kernels of its path.

The count oracle is this script's own numpy count (every window's 2-bit
code, the canonical form written out below, np.unique) over the bases
packed by the port's host layer; for -T the record ids come from a
searchsorted over the record starts and the taxids merge through the
port's Taxonomy.lca_reduce.  Its result goes through the port's
UnikWriter with the same flags.  The oracle runs those host layers on
their numpy branches (UNIKMER_TPU_NO_NATIVE=1), so the CLI's native
host library is held to them here; the CPU tests hold the numpy
branches to the JAX package.  Nothing of the port's device code enters
the oracle.  The script imports nothing of unikmer_tpu or jax.

Exits non-zero, printing no result, without a CUDA device or outside
the repository.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import contextlib
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
LINE = 60
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak bandwidth
FLUSH_BYTES = 256 << 20  # written between P1a's repetitions: > the 50 MB L2


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


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device milliseconds per call of fn() spent in the CUDA kernels
    whose name holds ``kernel``, from torch.profiler: the kernel's own
    time, without the host's launch overhead that the CUDA events around
    a short call also hold.  None when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "device_time_total", None)
                   or getattr(e, "cuda_time_total", 0.0)
                   for e in prof.key_averages() if kernel in e.key)
    return total_us / reps / 1e3 if total_us else None


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


def check_k1(dev, rng):
    from unikmer_tpu_torch.models.count import pack_bases_2bit
    from unikmer_tpu_torch.ops.encode import encode_2bit, encode_2bit_plain

    def upload(bases):
        p2, vm = pack_bases_2bit(bases)
        return (torch.from_numpy(p2).to(dev), torch.from_numpy(vm).to(dev))

    big = random_bases(rng, max(K1_NS))
    err = 0.0
    for n in K1_NS:
        p2, vm = upload(big[:n])
        for k in K1_KS:
            for canonical in (False, True):
                kk, kv = encode_2bit(p2, vm, n, k, canonical)
                pk, pv = encode_2bit_plain(p2, vm, n, k, canonical)
                torch.cuda.synchronize()
                e = abs_err(kk, pk)
                err = max(err, e)
                if e or not torch.equal(kv, pv):
                    raise SystemExit(f"K1 mismatch: n={n} k={k} "
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
    ms = cuda_ms(lambda: encode_2bit(p2, vm, n, 23, True))
    plain_ms = cuda_ms(lambda: encode_2bit_plain(p2, vm, n, 23, True))
    # packed bases and mask read once, the u64 codes and bool flags written
    bound = bytes_ms(p2.numel() + vm.numel() + 9 * n)
    say(f"K1 encode_2bit: exact on {len(K1_NS) * len(K1_KS) * 2 + 1} cases; "
        f"n={n} k=23 canonical: kernel {ms} ms, plain {plain_ms} ms, "
        f"bound {bound} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None)


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
    for n in K2_NS:
        for keys, bits in k2_inputs(rng, n):
            x = torch.from_numpy(keys.view(np.int64)).to(dev)
            got = radix_sort_u64(x, bits)
            want = sort_u64_plain(x)
            torch.cuda.synchronize()
            e = abs_err(got, want)
            err = max(err, e)
            cases += 1
            if e:
                raise SystemExit(f"K2 mismatch: n={n} code_bits={bits} err={e}")
    big = k2_inputs(rng, 1 << 25)
    times, radix_bound = {}, {}
    for keys, bits in (big[1], big[0]):  # code_bits 46, then 64
        x = torch.from_numpy(keys.view(np.int64)).to(dev)
        flipped = x ^ SIGN  # unsigned order as signed: one torch.sort call
        passes = len(radix_shifts(bits))
        times[bits] = dict(
            ms=cuda_ms(lambda: radix_sort_u64(x, bits)),
            plain_ms=cuda_ms(lambda: sort_u64_plain(x)),
            library_ms=cuda_ms(lambda: torch.sort(flipped)),
            # the keys read once and the sorted keys written once
            bound_ms=bytes_ms(16 * x.numel()))
        # an 8-bit LSD radix sort's own bound: one histogram read, then
        # each pass reads and writes the keys
        radix_bound[bits] = bytes_ms((1 + 2 * passes) * 8 * x.numel())
    say(f"K2 radix_sort_u64: exact on {cases} cases; n=2^25 " + "; ".join(
        f"code_bits={b}: kernel {t['ms']} ms, plain {t['plain_ms']} ms, "
        f"torch.sort {t['library_ms']} ms, bound {t['bound_ms']} ms, "
        f"{len(radix_shifts(b))}-pass radix bound {radix_bound[b]} ms"
        for b, t in times.items()))
    return dict(max_abs_err=err, bound_by="bytes", **times[46],
                ms_code_bits_64=times[64]["ms"],
                library_ms_code_bits_64=times[64]["library_ms"])


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
    for n in K3_NS:
        for bits in K3_BITS:
            keys, vals = k3_inputs(rng, n, bits)
            for kk in (keys, np.full(n, SENT)):
                k, v = upload(kk, vals)
                gk, gv = radix_sort_kv_u64(k, v, bits)
                wk, wv = sort_kv_plain(k, v)
                torch.cuda.synchronize()
                e = abs_err(gk, wk)
                if not torch.equal(gv, wv):
                    e = max(e, float((gv.long() - wv.long()).abs().max()))
                err = max(err, e)
                cases += 1
                if e:
                    raise SystemExit(f"K3 mismatch: n={n} code_bits={bits} "
                                     f"err={e}")
    times, radix_bound = {}, {}
    for bits in (46, 64):
        k, v = upload(*k3_inputs(rng, 1 << 25, bits))
        flipped = k ^ SIGN
        passes = len(radix_shifts(bits))
        times[bits] = dict(
            ms=cuda_ms(lambda: radix_sort_kv_u64(k, v, bits)),
            plain_ms=cuda_ms(lambda: sort_kv_plain(k, v)),
            # one call: the stable sort, its permutation not yet applied
            library_ms=cuda_ms(lambda: torch.sort(flipped, stable=True)),
            # keys and values read once, both written once
            bound_ms=bytes_ms(24 * k.numel()))
        # the histogram read of the keys, then 24 B a pair a pass
        radix_bound[bits] = bytes_ms((8 + 24 * passes) * k.numel())
    say(f"K3 radix_sort_kv_u64: exact on both planes in {cases} cases; "
        f"n=2^25 " + "; ".join(
            f"code_bits={b}: kernel {t['ms']} ms, plain {t['plain_ms']} ms, "
            f"stable torch.sort {t['library_ms']} ms, bound {t['bound_ms']} "
            f"ms, {len(radix_shifts(b))}-pass radix bound "
            f"{radix_bound[b]} ms" for b, t in times.items()))
    return dict(max_abs_err=err, bound_by="bytes", **times[46],
                ms_code_bits_64=times[64]["ms"],
                library_ms_code_bits_64=times[64]["library_ms"])


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


def numpy_count(bases: np.ndarray, k: int, canonical: bool, mode: str):
    """Straight numpy count of 2-bit k-mers (independent of the port)."""
    codes, _ = numpy_windows(bases, k, canonical)
    u, counts = np.unique(codes, return_counts=True)
    if mode == "unique":
        return u[counts == 1]
    if mode == "repeated":
        return u[counts > 1]
    return u


def write_oracle(out: str, k: int, flag: int, codes, taxids=None) -> None:
    """The oracle's codes through the port's UnikWriter, with the CLI's
    writer settings for -C."""
    from unikmer_tpu_torch.io import unik

    with open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag, number=len(codes), compress=False,
            compression_level=5, threads=min(os.cpu_count() or 4, 4),
            global_taxid=0, scale=1, max_taxid=(1 << 32) - 1) as w:
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


def oracle_unik(fa: str, out: str, k: int, canonical: bool, mode: str) -> str:
    """Write the oracle's .unik for ``count -k k [-K] -s -C [-u|-d]``."""
    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import pack_files

    with numpy_host():
        packed = pack_files([fa], k)
        codes = numpy_count(packed.bases, k, canonical, mode)
        write_oracle(out, k, unik.SORTED
                     | (unik.CANONICAL if canonical else 0), codes)
    return "numpy"


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


def check_against_oracle(tmp, fa, name, k, canonical, mode, extra):
    out = os.path.join(tmp, name)
    argv = ["count", "-k", str(k), *(["-K"] if canonical else []), "-s",
            "-C", *extra, fa, "-o", out]
    t0 = time.perf_counter()
    run_cli(argv)
    secs = time.perf_counter() - t0
    which = oracle_unik(fa, out + ".oracle.unik", k, canonical, mode)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{' '.join(argv)}: .unik differs from the oracle "
                         f"({which})")
    say(f"{' '.join(argv[:-3])}: {os.path.getsize(out + '.unik')} bytes, "
        f"equal to the {which} oracle; CLI {secs:.3f} s")


def main_path(tmp, rng):
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_u64
    from unikmer_tpu_torch.utils.stages import record_stages

    fa = os.path.join(tmp, "in.fa")
    t0 = time.perf_counter()
    write_fasta(fa, rng, 4, RECORD_BASES)
    say(f"FASTA 4 x {RECORD_BASES} bases written in "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(tmp, "k23")
    argv = ["count", "-k", "23", "-K", "-s", "-C", fa, "-o", out]
    encode_2bit.launches = 0
    radix_sort_u64.launches = 0
    with record_stages() as st:
        t0 = time.perf_counter()
        run_cli(argv)
        secs = time.perf_counter() - t0
    launches = {"k1": encode_2bit.launches, "k2": radix_sort_u64.launches}
    if min(launches.values()) < 1:
        raise SystemExit(f"main path skipped a kernel: {launches}")
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
    os.remove(fa)
    one = os.path.join(tmp, "one.fa")
    write_fasta(one, rng, 1, RECORD_BASES + (RECORD_BASES >> 1))
    check_against_oracle(tmp, one, "u", 23, True, "unique", ["-u"])
    check_against_oracle(tmp, one, "d", 23, True, "repeated", ["-d"])
    check_against_oracle(tmp, one, "k32", 32, False, "distinct", [])
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
                      data_dir: str):
    """Write the oracle's .unik for ``count -k k [-K] -s -C -T -r ...``;
    returns (which oracle, codes, taxids)."""
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
        codes, pos = numpy_windows(packed.bases, k, canonical)
        taxids = rec_taxids[np.searchsorted(packed.starts, pos, "right") - 1]
        uniq, merged = taxdb.lca_reduce(codes, taxids)
        if mode != "distinct":
            _, counts = np.unique(codes, return_counts=True)
            keep = counts == 1 if mode == "unique" else counts > 1
            uniq, merged = uniq[keep], merged[keep]
        write_oracle(out, k, unik.SORTED | unik.INCLUDE_TAXID
                     | (unik.CANONICAL if canonical else 0), uniq, merged)
    return "numpy + lca_reduce", uniq, merged


def taxid_run(tmp, name, fa, data_dir, k, canonical, mode, windows):
    """One ``count -T`` CLI run with its launch counts, stage seconds and
    peak device memory, held against the oracle's bytes; returns (the
    launches, the oracle's codes and taxids)."""
    from unikmer_tpu_torch.ops.encode import encode_2bit
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_kv_u64
    from unikmer_tpu_torch.utils.stages import record_stages

    out = os.path.join(tmp, name)
    flags = {"unique": ["-u"], "repeated": ["-d"]}.get(mode, [])
    argv = ["count", "-k", str(k), *(["-K"] if canonical else []), "-s", "-C",
            *flags, "-T", "-r", RE_TAXID, "--data-dir", data_dir, fa,
            "-o", out]
    torch.cuda.reset_peak_memory_stats()
    encode_2bit.launches = 0
    radix_sort_kv_u64.launches = 0
    with record_stages() as st:
        t0 = time.perf_counter()
        run_cli(argv)
        secs = time.perf_counter() - t0
    launches = {"k1": encode_2bit.launches, "k3": radix_sort_kv_u64.launches}
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) < 1:
        raise SystemExit(f"{name} skipped a kernel: {launches}")
    say(f"{name} {' '.join(argv[:-5])}: {secs:.3f} s, {windows} windows, "
        f"{windows / secs:.1f} windows/s, pieces {st.calls.get('k1', 0)}, "
        f"launches {launches}, peak device memory {peak} B")
    say(f"{name} stage seconds: " + json.dumps(
        {s: round(v, 4) for s, v in st.seconds.items()}))
    which, codes, taxids = oracle_taxid_unik(fa, out + ".oracle.unik", k,
                                             canonical, mode, data_dir)
    if not same_bytes(out + ".unik", out + ".oracle.unik"):
        raise SystemExit(f"{name}: .unik differs from the {which} oracle")
    say(f"{name} .unik ({os.path.getsize(out + '.unik')} bytes, {len(codes)} "
        f"codes, {len(np.unique(taxids))} distinct taxids) equal to the "
        f"{which} oracle")
    os.remove(fa)
    return launches, codes, taxids


def taxid_path(tmp, rng):
    """T1, T2 and T3 (module docstring); returns K3's launches in all."""
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


def check_probes(dev, rng):
    """The four probe kernels held to their plain versions at the
    scripts' sizes and at ragged ones, then timed at the scripts' sizes;
    returns one result dict per kernel."""
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
                (u32_tensor(rng, (7, 128), dev).reshape(-1)[1:],)])
    cold = dict(reps=10, before=lambda: flush.fill_(1))  # L2 flushed each time
    out["P1a"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: probes.copy_inc_u32(x1), **cold),
        plain_ms=cuda_ms(lambda: probes.copy_inc_u32_plain(x1), **cold),
        library_ms=cuda_ms(lambda: x1 + 1, **cold),
        device_ms=device_ms(lambda: probes.copy_inc_u32(x1), "copy_inc"),
        bound_ms=bytes_ms(2 * x1.numel() * 4), bound_by="bytes")

    p1b = probes.p1b_distances(rows)
    p2a = {s: probes.p2a_distances(s, rows) for s in entry.P2A_STAGES}
    err = hold("P1b/P2a row_cmpex_u32", probes.row_cmpex_u32,
               probes.row_cmpex_u32_plain,
               [(blk, p1b), *((blk, d) for d in p2a.values()),
                (u32_tensor(rng, (37, 128), dev), [16, 8, 4, 2, 1, 16]),
                (u32_tensor(rng, (5, 3), dev), [2, 1, 4]),
                (u32_tensor(rng, (1, 128), dev), [1])])
    out["P1b"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: probes.row_cmpex_u32(blk, p1b), 20),
        plain_ms=cuda_ms(lambda: probes.row_cmpex_u32_plain(blk, p1b), 5),
        library_ms=None, bound_ms=bytes_ms(two_mib), bound_by="bytes",
        device_ms=device_ms(lambda: probes.row_cmpex_u32(blk, p1b),
                            "row_cmpex"),
        **{f"ms_p2a_{s}": cuda_ms(lambda d=d: probes.row_cmpex_u32(blk, d), 20)
           for s, d in p2a.items()})

    err = hold("P1c transpose128_u32", probes.transpose128_u32,
               probes.transpose128_u32_plain,
               [(blk,), (u32_tensor(rng, (128, 128), dev),),
                (u32_tensor(rng, (3 * 128, 128), dev),)])
    out["P1c"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: probes.transpose128_u32(blk), 20),
        plain_ms=cuda_ms(lambda: probes.transpose128_u32_plain(blk), 20),
        library_ms=cuda_ms(lambda: blk.view(rows // 128, 128, 128)
                           .transpose(1, 2).contiguous(), 20),
        device_ms=device_ms(lambda: probes.transpose128_u32(blk),
                            "transpose128"),
        bound_ms=bytes_ms(two_mib), bound_by="bytes")

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
        say(f"{name}: exact; kernel {r['ms']} ms (device {r['device_ms']} "
            f"ms), plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
            f"bound {r['bound_ms']} ms" + "".join(
                f", {k} {v} ms" for k, v in r.items() if k.startswith("ms_")))
    return out


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
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from unikmer_tpu_torch import _kernels, native

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
    results = {"k1": check_k1(dev, rng), "k2": check_k2(dev, rng),
               "k3": check_k3(dev, rng), **check_probes(dev, rng)}
    with tempfile.TemporaryDirectory(prefix="unikmer-torch-smoke-") as tmp:
        launches = main_path(tmp, rng)
        launches["k3"] = taxid_path(tmp, rng)
    launches.update(probe_path())
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         **({"also_replaces": also} if also else {}),
         "launches": launches[key], **results[key]}
        for key, name, source, replaces, also in KERNELS]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
