"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels (K1 encode, K2 radix sort, K3 key+value
radix sort) from unikmer_tpu_torch/csrc, holds each against its plain
PyTorch version on the card (exact equality), then drives the port's
paths through its CLI and holds every .unik against a jax-free oracle:

  count     ``count -k 23 -K -s -C`` over a 134 Mbp FASTA of 4 records
            (and -u, -d, k = 32 over one 50 Mbp record);
  count -T  over a synthetic 100,000-node taxonomy written as nodes.dmp:
            T1, 8,192 records of 4,000 bases, each with its own taxid,
            one piece of ~2^25 windows on the 'paths' LCA tier; T2,
            1,024 records of 98,304 bases with 512 taxids, streamed in
            pieces on the 'table' tier; T3, k = 32 -u over two 1 Mbp
            records, keeping a real 2^64-1 code with its taxid.

The launch counters, zeroed before each CLI run and read after it, show
that the run went through the kernels of its path.

The oracle is unikmer_tpu.models.count_host / count_taxids_host (the
native host engine) when the native library builds; where it cannot
(no libdeflate), it is a numpy count over the same packed bases with
unikmer_tpu's numpy canonical twin, and for -T record ids by
searchsorted over the record starts and taxdump's lca_reduce.  Either
way its result goes through unikmer_tpu's UnikWriter with the same
flags.

Exits non-zero, printing no result, without a CUDA device or outside
the repository.  The last line of stdout is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

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


def say(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event milliseconds of fn() over reps, after a warm-up."""
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
    say(f"K1 encode_2bit: exact on {len(K1_NS) * len(K1_KS) * 2 + 1} cases; "
        f"n={n} k=23 canonical: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


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
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_u64, sort_u64_plain

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
    keys, bits = big[1]
    x = torch.from_numpy(keys.view(np.int64)).to(dev)
    ms = cuda_ms(lambda: radix_sort_u64(x, bits))
    plain_ms = cuda_ms(lambda: sort_u64_plain(x))
    keys64 = torch.from_numpy(big[0][0].view(np.int64)).to(dev)
    ms64 = cuda_ms(lambda: radix_sort_u64(keys64, 64))
    plain64 = cuda_ms(lambda: sort_u64_plain(keys64))
    say(f"K2 radix_sort_u64: exact on {cases} cases; n=2^25 code_bits=46: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; code_bits=64: "
        f"kernel {ms64:.4f} ms, plain {plain64:.4f} ms")
    return err, ms, plain_ms


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
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_kv_u64, sort_kv_plain

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
    times = {}
    for bits in (46, 64):
        k, v = upload(*k3_inputs(rng, 1 << 25, bits))
        times[bits] = (cuda_ms(lambda: radix_sort_kv_u64(k, v, bits)),
                       cuda_ms(lambda: sort_kv_plain(k, v)))
    say(f"K3 radix_sort_kv_u64: exact on both planes in {cases} cases; "
        f"n=2^25 code_bits=46: kernel {times[46][0]:.4f} ms, plain "
        f"{times[46][1]:.4f} ms; code_bits=64: kernel {times[64][0]:.4f} ms, "
        f"plain {times[64][1]:.4f} ms")
    return err, times[46][0], times[46][1]


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
    (independent of the port)."""
    from unikmer_tpu.ops.codec import canonical_np

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


def oracle_unik(fa: str, out: str, k: int, canonical: bool, mode: str) -> str:
    """Write the oracle's .unik for ``count -k k [-K] -s -C [-u|-d]``."""
    from unikmer_tpu.io import unik
    from unikmer_tpu.io.fastx import pack_files
    from unikmer_tpu.models.count_host import count_host

    packed = pack_files([fa], k)
    codes = count_host(packed, k, canonical, mode)
    which = "count_host"
    if codes is None:
        which = "numpy (native lib unavailable)"
        codes = numpy_count(packed.bases, k, canonical, mode)
    flag = unik.SORTED | (unik.CANONICAL if canonical else 0)
    with open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag, number=len(codes), compress=False,
            compression_level=5, threads=min(os.cpu_count() or 4, 4),
            global_taxid=0, scale=1, max_taxid=(1 << 32) - 1) as w:
        w.write_codes(codes)
    return which


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
    from unikmer_tpu.io import unik
    from unikmer_tpu.io.fastx import pack_records, read_fastx
    from unikmer_tpu.models.count_host import count_taxids_host
    from unikmer_tpu.taxonomy.taxdump import load_taxonomy

    taxdb = load_taxonomy(data_dir)
    re_t = re.compile(RE_TAXID.encode())
    res = count_taxids_host(read_fastx(fa), k, canonical, False, 1, mode,
                            False, re_t, taxdb)
    which = "count_taxids_host"
    if res is None:
        which = "numpy + lca_reduce (native lib unavailable)"
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
        res = uniq, merged
    codes, taxids = res
    flag = (unik.SORTED | unik.INCLUDE_TAXID
            | (unik.CANONICAL if canonical else 0))
    with open(out, "wb") as fh, unik.UnikWriter(
            fh, k=k, flag=flag, number=len(codes), compress=False,
            compression_level=5, threads=min(os.cpu_count() or 4, 4),
            global_taxid=0, scale=1, max_taxid=(1 << 32) - 1) as w:
        w.write_codes(codes, taxids)
    return which, codes, taxids


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
    from unikmer_tpu.taxonomy.taxdump import load_taxonomy
    from unikmer_tpu_torch.taxonomy.lca import device_lca_plan

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from unikmer_tpu_torch import _kernels

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
    k1_err, k1_ms, k1_plain = check_k1(dev, rng)
    k2_err, k2_ms, k2_plain = check_k2(dev, rng)
    k3_err, k3_ms, k3_plain = check_k3(dev, rng)
    with tempfile.TemporaryDirectory(prefix="unikmer-torch-smoke-") as tmp:
        launches = main_path(tmp, rng)
        launches["k3"] = taxid_path(tmp, rng)
    say(json.dumps({"kernels": [
        {"name": "K1 encode_2bit", "route": "cuda",
         "source": "unikmer_tpu_torch/csrc/encode.cu",
         "replaces": "unikmer_tpu/ops/pallas_encode.py:79",
         "launches": launches["k1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain},
        {"name": "K2 radix_sort_u64", "route": "cuda",
         "source": "unikmer_tpu_torch/csrc/radix_sort.cu",
         "replaces": "unikmer_tpu/ops/pallas_sort.py:235",
         "launches": launches["k2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain},
        {"name": "K3 radix_sort_kv_u64", "route": "cuda",
         "source": "unikmer_tpu_torch/csrc/radix_sort.cu",
         "replaces": "unikmer_tpu/ops/pallas_sort.py:397",
         "launches": launches["k3"], "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain},
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
