"""The streams' dispatch-ahead (models/count.py: ``_pipeline_depth``,
``_GroupedCounter``, ``linear_codes_all``'s in-flight queue) and K2/K3's
pass plan on the card (csrc/radix_sort.cu ``radix_bases``).

On the CPU: the port's streams and ``linear_codes_all`` at pipeline
depths 0, 1 and 3 against the JAX package's at the same
UNIKMER_TPU_PIPELINE_DEPTH (every mode, 2-bit, ``-H`` and ``-W``,
512-base pieces, as tests/test_count.py does for the JAX package); the
order of dispatches and fetches with recording stubs; the depth's
parsing and defaults; and a numpy twin of the pass plan against the
constant digits of the keys for every ``code_bits``.  Exact equality
throughout.  The ``cuda`` cases hold the plan the card writes to the
twin, run the dispatch under ``torch.cuda.set_sync_debug_mode``, and
read a recorded ``pack`` by the host's clock while the card runs.
"""

import os
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from unikmer_tpu.io.fastx import Record, pack_records
from unikmer_tpu.models import count as jax_count
from unikmer_tpu_torch.io.fastx import PackedSeqs
from unikmer_tpu_torch.models import count as port_count
from unikmer_tpu_torch.ops.radix_sort import (
    RADIX_BITS, radix_shifts, radix_sort_kv_u64, radix_sort_u64,
)
from unikmer_tpu_torch.utils import stages

CPU = torch.device("cpu")
SOURCE = (Path(__file__).resolve().parents[1] / "unikmer_tpu_torch" / "csrc"
          / "radix_sort.cu").read_text()
SENT = np.uint64((1 << 64) - 1)
DEPTHS = ["0", "1", "3"]
MODES = ["distinct", "unique", "repeated"]
CONFIGS = {  # 2-bit, -H, -W
    "2bit": dict(k=11, canonical=True),
    "H": dict(k=21, canonical=True, hashed=True),
    "W": dict(k=15, minimizer_w=5),
}
CHUNK = 512


def cu_const(name: str) -> int:
    """An integer constant of csrc/radix_sort.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.fixture(scope="module")
def records():
    """Four records with invalid bases and a fifth repeating the first's
    start (duplicates across pieces)."""
    rng = np.random.default_rng(18)
    alphabet = np.frombuffer(b"ACGTacgtN", np.uint8)
    seqs = [rng.choice(alphabet, size=n, p=[0.12] * 8 + [0.04]).tobytes()
            for n in (800, 400, 1200, 700)]
    seqs.append(seqs[0][:500])
    return [Record(b"s%d" % i, b"s%d" % i, s) for i, s in enumerate(seqs)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def port_packed(p) -> PackedSeqs:
    return PackedSeqs.from_numpy(p.bases, p.starts, p.lengths)


# ---------------------------------------------------------------------
# the streams at every depth, against the JAX package


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("mode", MODES)
def test_streams_match_jax_at_depth(records, monkeypatch, depth, config,
                                    mode):
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", depth)
    jcfg = jax_count.CountConfig(mode=mode, **CONFIGS[config])
    cfg = port_count.CountConfig.from_reference(jcfg)
    packed = pack_records(records, jcfg.k)
    want = jax_count.count_stream_packed([packed], jcfg, chunk_bases=CHUNK)
    got = port_count.count_stream_packed([port_packed(packed)], cfg,
                                         chunk_bases=CHUNK, device=CPU)
    np.testing.assert_array_equal(got, want)
    want = jax_count.count_stream(iter(records), jcfg, chunk_bases=CHUNK)
    got = port_count.count_stream(iter(records), cfg, chunk_bases=CHUNK,
                                  device=CPU)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_linear_codes_all_matches_jax_at_depth(records, monkeypatch, depth,
                                               config):
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", depth)
    jcfg = jax_count.CountConfig(**CONFIGS[config])
    bases = pack_records(records, jcfg.k).bases
    want = jax_count.linear_codes_all(bases, jcfg, chunk_bases=CHUNK)
    got = port_count.linear_codes_all(
        bases, port_count.CountConfig.from_reference(jcfg),
        chunk_bases=CHUNK, device=CPU)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64


# ---------------------------------------------------------------------
# the order of dispatches and fetches


class Recorder:
    """Stubs of a piece's dispatch and fetch that log their order and
    check how many tokens are alive at once."""

    def __init__(self, depth: int, fail_at: int | None = None):
        self.depth = depth
        self.fail_at = fail_at
        self.log: list = []
        self.alive: set = set()
        self.most = 0

    def dispatch(self, piece, cfg, device=None):
        self.log.append(("dispatch", piece))
        self.alive.add(piece)
        self.most = max(self.most, len(self.alive))
        return ("token", piece)

    def fetch(self, token):
        piece = token[1]
        self.log.append(("fetch", piece))
        self.alive.remove(piece)
        if piece == self.fail_at:
            raise RuntimeError(f"fetch of piece {piece} failed")
        return np.array([piece], np.uint64)

    def fetch_dual(self, token):
        got = self.fetch(token)
        return got, got + np.uint64(100)

    def check(self, n: int) -> None:
        """Piece i + depth went out before piece i came back; at most
        depth + 1 tokens were alive; every piece was fetched once."""
        at = {entry: i for i, entry in enumerate(self.log)}
        for i in range(n):
            assert at[("dispatch", i)] < at[("fetch", i)]
            if i + self.depth < n:
                assert at[("dispatch", i + self.depth)] < at[("fetch", i)]
            if i + self.depth + 1 < n:
                assert at[("fetch", i)] < at[("dispatch", i + self.depth + 1)]
        assert self.most <= self.depth + 1
        assert not self.alive and len(self.log) == 2 * n


class ListSink:
    def __init__(self):
        self.parts: list = []

    def add(self, u):
        self.parts.append(u)


@pytest.fixture
def recorder(monkeypatch, request):
    depth, fail_at = request.param
    rec = Recorder(depth, fail_at)
    monkeypatch.setattr(port_count, "count_packed_dispatch", rec.dispatch)
    monkeypatch.setattr(port_count, "count_packed_dispatch_dual",
                        rec.dispatch)
    monkeypatch.setattr(port_count, "count_packed_fetch", rec.fetch)
    monkeypatch.setattr(port_count, "count_packed_fetch_dual", rec.fetch_dual)
    return rec


@pytest.mark.parametrize("recorder", [(0, None), (1, None), (3, None),
                                      (5, None)], indirect=True,
                         ids=lambda p: f"depth{p[0]}")
@pytest.mark.parametrize("dual", [False, True])
def test_grouped_counter_keeps_depth_in_flight(recorder, dual):
    sink = ListSink()
    counter = port_count._GroupedCounter(sink, recorder.depth, CPU)
    for i in range(9):
        counter.add(i, None, dual=dual)
        assert len(counter.inflight) <= recorder.depth
    counter.finish()
    recorder.check(9)
    got = [int(u[0]) for u in sink.parts]
    want = ([x for i in range(9) for x in (i, i + 100)] if dual
            else list(range(9)))
    assert got == want


@pytest.mark.parametrize("recorder", [(0, 3), (1, 3), (3, 3), (3, 7)],
                         indirect=True, ids=lambda p: f"depth{p[0]}-at{p[1]}")
def test_grouped_counter_raises_the_fetch_error(recorder):
    """A failing fetch raises from the add (or the finish) that drains
    it, after the pieces before it reached the sink."""
    sink = ListSink()
    counter = port_count._GroupedCounter(sink, recorder.depth, CPU)
    with pytest.raises(RuntimeError, match=f"piece {recorder.fail_at}"):
        for i in range(8):
            counter.add(i, None)
        counter.finish()
    assert [int(u[0]) for u in sink.parts] == list(range(recorder.fail_at))
    assert ("dispatch", min(recorder.fail_at + recorder.depth, 7)) in \
        recorder.log


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_linear_codes_all_keeps_depth_in_flight(monkeypatch, depth):
    """linear_codes_all dispatches segment i + depth before it fetches
    segment i, and concatenates the segments in genome order."""
    rec = Recorder(depth)
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", str(depth))

    def piece(bases, cfg, device, limit, off=0):
        rec.dispatch(off, cfg)
        return ("token", off), None, None

    def fetch(outs, pending, device):
        got = rec.fetch(outs[0])
        return [got, got.astype(np.int64)]

    monkeypatch.setattr(port_count, "_linear_piece", piece)
    monkeypatch.setattr(port_count, "_fetch_prefixes", fetch)
    cfg = port_count.CountConfig(k=5)
    codes, pos = port_count.linear_codes_all(
        np.zeros(10 * 100 + 4, np.uint8), cfg, chunk_bases=100, device=CPU)
    offsets = list(range(0, 1000, 100))
    assert codes.tolist() == offsets and pos.tolist() == offsets
    rec.log = [(kind, i // 100) for kind, i in rec.log]
    rec.check(10)


def test_pipeline_depth_parsing_and_defaults(monkeypatch):
    monkeypatch.delenv("UNIKMER_TPU_PIPELINE_DEPTH", raising=False)
    assert port_count._pipeline_depth(CPU) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_count._pipeline_depth("cuda") == 1
    assert port_count._pipeline_depth(torch.device("cuda", 0)) == 1
    for env, want in (("0", 0), ("2", 2), ("7", 7), ("-3", 0), (" 4 ", 4)):
        monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", env)
        assert port_count._pipeline_depth("cuda") == want
        assert port_count._pipeline_depth(CPU) == want
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", "two")
    with pytest.raises(ValueError):
        port_count._pipeline_depth(CPU)


def test_pipeline_depth_matches_jax_parsing(monkeypatch):
    for env in ("0", "1", "3", "-1", "12"):
        monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", env)
        assert port_count._pipeline_depth(CPU) == jax_count._pipeline_depth()


@pytest.mark.parametrize("how", ["record_stages", "profiler"])
def test_recorded_stages_run_the_stream_at_depth_zero(records, monkeypatch,
                                                      how):
    """A recorded stage waits on nothing (CUDA stages are timed by
    events), so under record_stages() and the stream profiler the streams
    keep their depth and count the same, the stages are recorded, and the
    profiler's report keeps the JAX layout with no line of its own."""
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", "2")
    cfg = port_count.CountConfig(k=11, canonical=True)
    seen = []
    real = port_count._GroupedCounter

    def spy(sink, depth, device=None):
        seen.append(depth)
        return real(sink, depth, device)

    monkeypatch.setattr(port_count, "_GroupedCounter", spy)
    plain = port_count.count_stream(iter(records), cfg, CHUNK, CPU)
    assert seen == [2] and stages.stage("x", CPU) is stages._NULL
    if how == "record_stages":
        with stages.record_stages() as st:
            got = port_count.count_stream(iter(records), cfg, CHUNK, CPU)
        table = st.seconds
    else:
        monkeypatch.setenv("UNIKMER_TPU_PROFILE_STREAM", "1")
        stages.stream_profile_reset()
        try:
            got = port_count.count_stream(iter(records), cfg, CHUNK, CPU)
            table = {k: v for k, (v, _) in
                     stages.stream_profile_table().items()}
            import io

            out = io.StringIO()
            stages.stream_profile_report(out)
        finally:
            stages.stream_profile_stop()
        lines = out.getvalue().splitlines()
        assert lines[0] == "# stream profile (exclusive wall per phase):"
        assert lines[-1].startswith("#   TOTAL(tracked)")
        assert {ln.split()[1] for ln in lines[1:-1]} == set(table)
    assert seen == [2, 2]
    assert {"ingest", "k1", "sort", "collapse", "d2h"} <= set(table)
    np.testing.assert_array_equal(got, plain)


def test_dispatch_tokens_hold_the_uploads(records):
    """A token keeps what its piece needs until the fetch: on the CPU
    nothing is pinned and the counts are the piece's own tensors."""
    cfg = port_count.CountConfig(k=11, canonical=True, mode="unique")
    packed = port_packed(pack_records(records, cfg.k))
    token = port_count.count_packed_dispatch(packed, cfg, CPU)
    assert token[0] == "one" and token[-1].keep == []
    assert token[-1].event is None and token[-1].wait() == [int(token[3])]
    dual = port_count.count_packed_dispatch_dual(packed, cfg, CPU)
    assert dual[-1].wait() == [int(dual[3]), int(dual[5])]
    np.testing.assert_array_equal(port_count.count_packed_fetch(token),
                                  port_count.count_packed(packed, cfg, CPU))


# ---------------------------------------------------------------------
# K2/K3's pass plan


def plan_twin(keys: np.ndarray, code_bits: int):
    """radix_bases' plan in numpy, from the constant digits of the keys
    (the sentinel ranked as 2^code_bits below 64 bits): (steps, the
    copy flag).  A step is 0 for a pass whose digit is the same in every
    key, else kRun | src << 1 | dst << 3 over kInput, kTemp, kOutput."""
    run_bit, inp, temp, out = (cu_const(c) for c in
                               ("kRun", "kInput", "kTemp", "kOutput"))
    ranked = keys.copy()
    if code_bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(code_bits)
    runs = []
    for shift in radix_shifts(code_bits):
        d = (ranked >> np.uint64(shift)) & np.uint64(255)
        runs.append(bool(len(d)) and not bool(np.all(d == d[0])))
    ran = sum(runs)
    steps, src, j = [], inp, 0
    for run in runs:
        if not run:
            steps.append(0)
            continue
        dst = out if (ran - 1 - j) % 2 == 0 else temp
        steps.append(run_bit | src << 1 | dst << 3)
        src, j = dst, j + 1
    return steps, int(ran == 0)


def follow_plan(keys: np.ndarray, code_bits: int, steps, copy: int,
                vals: np.ndarray | None = None):
    """Run the plan's passes in numpy over three buffers and return the
    output buffer's (keys, vals): each pass a stable digit sort from its
    source into its destination, then the copy when the flag says so."""
    run_bit, inp, temp, out = (cu_const(c) for c in
                               ("kRun", "kInput", "kTemp", "kOutput"))
    ranked = keys.copy()
    if code_bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(code_bits)
    order = {inp: np.arange(len(keys)), temp: None, out: None}
    for p, step in enumerate(steps):
        if not step & run_bit:
            continue
        src, dst = (step >> 1) & 3, (step >> 3) & 3
        assert dst in (temp, out) and src != dst and order[src] is not None
        o = order[src]
        d = (ranked[o] >> np.uint64(RADIX_BITS * p)) & np.uint64(255)
        order[dst] = o[np.argsort(d, kind="stable")]
    if copy:
        assert order[out] is None
        order[out] = order[inp]
    o = order[out]
    return keys[o], None if vals is None else vals[o]


def plan_keys(rng, code_bits: int, kind: str, n: int = 3000):
    """Keys of one kind below 2^code_bits with sentinels: random, sharing
    their top three digits, all equal, or one pass's digit varying."""
    hi = 1 << min(code_bits, 63)
    keys = rng.integers(0, hi, size=n, dtype=np.uint64)
    if code_bits == 64:
        keys |= rng.integers(0, 2, size=n, dtype=np.uint64) << np.uint64(63)
    if kind == "top3":
        shift = max(len(radix_shifts(code_bits)) - 3, 0) * RADIX_BITS
        keep = np.uint64((1 << shift) - 1) if shift else np.uint64(0)
        keys = (keys & keep) | (keys[0] & ~keep)
    elif kind == "equal":
        keys[:] = keys[0]
    elif kind == "one_pass":
        shift = np.uint64(RADIX_BITS * (len(radix_shifts(code_bits)) // 2))
        keys = (keys[0] & ~(np.uint64(255) << shift)) | (
            (keys & np.uint64(255)) << shift)
        if code_bits < 64:
            keys &= np.uint64((1 << code_bits) - 1)
    if kind in ("random", "top3") and code_bits < 64:
        keys[rng.random(n) < 0.03] = SENT
    return keys


@pytest.mark.parametrize("code_bits", range(1, 65))
def test_pass_plan_twin_sorts_and_counts_the_constant_digits(code_bits):
    """For every code_bits: the plan skips exactly the passes whose digit
    is constant, its passes alternate so that the last writes the output
    (the copy when none runs), and following it sorts (keys and values,
    stably)."""
    rng = np.random.default_rng(code_bits)
    for kind in ("random", "top3", "equal", "one_pass"):
        keys = plan_keys(rng, code_bits, kind)
        vals = np.arange(len(keys), dtype=np.uint32)
        steps, copy = plan_twin(keys, code_bits)
        passes = len(radix_shifts(code_bits))
        assert len(steps) == passes
        ran = sum(1 for s in steps if s)
        assert copy == (ran == 0)
        if kind == "equal":
            assert ran == 0
        got, gv = follow_plan(keys, code_bits, steps, copy, vals)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got, keys[order], err_msg=kind)
        np.testing.assert_array_equal(gv, vals[order], err_msg=kind)
        last = [s for s in steps if s]
        if last:
            assert (last[-1] >> 3) & 3 == cu_const("kOutput")
            assert (last[0] >> 1) & 3 == cu_const("kInput")


def test_pass_plan_twin_reads_the_source_constants():
    """The twin's encoding is the source's: distinct buffer codes in two
    bits and a run bit below them."""
    codes = {cu_const(c) for c in ("kInput", "kTemp", "kOutput")}
    assert codes <= {0, 1, 2, 3} and len(codes) == 3
    assert cu_const("kRun") == 1
    assert "plan[passes] = ran == 0;" in SOURCE


# ---------------------------------------------------------------------
# on the card


def device_plan(keys: torch.Tensor, code_bits: int):
    """The plan ukt_radix_upfront writes for ``keys``, read back."""
    from unikmer_tpu_torch.ops import radix_sort

    passes = len(radix_shifts(code_bits))
    dev = keys.device
    hist = torch.empty(passes * 256, dtype=torch.int64, device=dev)
    bases = torch.empty_like(hist)
    plan = torch.empty(passes + 1, dtype=torch.int32, device=dev)
    pair = torch.zeros(2, dtype=torch.int64, device=dev)
    radix_sort._UPFRONT(dev, keys.data_ptr(), keys.shape[0], passes,
                        code_bits, hist.data_ptr(), bases.data_ptr(),
                        plan.data_ptr(), pair.data_ptr())
    got = plan.tolist()
    return got[:-1], got[-1], pair.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("code_bits", [1, 2, 7, 8, 9, 23, 46, 47, 48, 63,
                                       64])
def test_device_plan_matches_the_twin(cuda_device, code_bits):
    """The card's plan equals the twin's for every key kind, K2 and K3
    sort exactly along it, and the pass counters add its passes."""
    rng = np.random.default_rng(code_bits)
    for kind in ("random", "top3", "equal", "one_pass"):
        for n in (2, 4095, 4097, 3 * 4096 + 5):
            keys = plan_keys(rng, code_bits, kind, n)
            x = torch.from_numpy(keys.view(np.int64)).to(cuda_device)
            steps, copy, pair = device_plan(x, code_bits)
            want_steps, want_copy = plan_twin(keys, code_bits)
            assert (steps, copy) == (want_steps, want_copy), (kind, n)
            ran = sum(1 for s in steps if s)
            assert pair == [ran, len(steps) - ran]
            for w in (radix_sort_u64, radix_sort_kv_u64):
                w.passes_run = w.passes_skipped = 0
            got = radix_sort_u64(x, code_bits)
            np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64),
                                          np.sort(keys))
            v = torch.arange(n, dtype=torch.int32, device=cuda_device)
            gk, gv = radix_sort_kv_u64(x, v, code_bits)
            order = np.argsort(keys, kind="stable")
            np.testing.assert_array_equal(gv.cpu().numpy(), order)
            assert got.data_ptr() != x.data_ptr() != gk.data_ptr()
            for w in (radix_sort_u64, radix_sort_kv_u64):
                assert (w.passes_run, w.passes_skipped) == (
                    ran, len(steps) - ran)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["2bit", "H", "W15", "dual"])
def test_dispatch_waits_on_nothing(cuda_device, records, config):
    """count_packed_dispatch (and the -u/-d dual dispatch) and K2/K3 alone
    queue their work without a synchronising call."""
    cfg = {"2bit": port_count.CountConfig(k=23, canonical=True),
           "H": port_count.CountConfig(k=31, canonical=True, hashed=True),
           "W15": port_count.CountConfig(k=31, minimizer_w=15),
           "dual": port_count.CountConfig(k=23, canonical=True)}[config]
    packed = port_packed(pack_records(records, cfg.k))
    dispatch = (port_count.count_packed_dispatch_dual if config == "dual"
                else port_count.count_packed_dispatch)
    dispatch(packed, cfg, cuda_device)  # warm: the kernels load
    keys = torch.randint(0, 1 << 46, (1 << 16,), device=cuda_device)
    vals = torch.zeros(1 << 16, dtype=torch.int32, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        token = dispatch(packed, cfg, cuda_device)
        radix_sort_u64(keys, 46)
        radix_sort_kv_u64(keys, vals, 46)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetch = (port_count.count_packed_fetch_dual if config == "dual"
             else port_count.count_packed_fetch)
    got = fetch(token)
    want = fetch(dispatch(packed, cfg, CPU))
    for g, w in zip(got if config == "dual" else [got],
                    want if config == "dual" else [want]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_pack_reads_its_host_seconds_while_the_card_runs(cuda_device,
                                                         records,
                                                         monkeypatch):
    """At depth 2 the card still runs the pieces before while the host
    packs the next, so a stage of host work reads the host clock: each
    pack sleeps 20 ms on the host and each K1 queues about 50 ms of card
    time behind it, and ``pack`` reads at least its 20 ms a piece (a pair
    of CUDA events would read the card's few us between them)."""
    monkeypatch.setenv("UNIKMER_TPU_PIPELINE_DEPTH", "2")
    real_pack, real_k1 = port_count.pack_bases_2bit, port_count.encode_2bit

    def pack(bases):
        time.sleep(0.02)
        return real_pack(bases)

    def k1(*args):
        out = real_k1(*args)
        torch.cuda._sleep(100_000_000)
        return out

    monkeypatch.setattr(port_count, "pack_bases_2bit", pack)
    monkeypatch.setattr(port_count, "encode_2bit", k1)
    cfg = port_count.CountConfig(k=11, canonical=True)
    want = port_count.count_stream(iter(records), cfg, CHUNK, CPU)
    port_count.count_stream(iter(records), cfg, CHUNK, cuda_device)  # warm
    with stages.record_stages() as st:
        got = port_count.count_stream(iter(records), cfg, CHUNK,
                                      cuda_device)
    secs = st.seconds
    assert st.calls["pack"] >= 4 and st.calls["k1"] == st.calls["pack"]
    assert secs["pack"] >= 0.02 * st.calls["pack"]
    assert secs["k1"] >= 0.02 * st.calls["k1"]  # the card's time, by events
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# chip_smoke's pipeline phase


def test_chip_smoke_pipeline_path_on_the_cpu(tmp_path, monkeypatch):
    """The pipeline phase small on the CPU (the kernels' plain versions,
    which count no launch; the profiler and the sync check stubbed):
    every output check holds, at both depths, on both reader routes."""
    import chip_smoke

    for name in ("synchronize", "reset_peak_memory_stats",
                 "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "device_busy",
                        lambda fn: (fn(), {"busy_share": None})[1])
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    for name, value in (("PIPELINE_KEYS", 1 << 12),
                        ("PIPELINE_PIECE", 1 << 14),
                        ("PIPELINE_COUNTS", False)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(9)
    tmp = str(tmp_path)
    fa, one = str(tmp_path / "in.fa"), str(tmp_path / "one.fa")
    chip_smoke.write_fasta(fa, rng, 4, 1 << 18)  # pieces of 7 << 16
    # one record past the CPU's piece (7 << 16 bases): -l takes 2 pieces
    chip_smoke.write_fasta(one, rng, 1, (7 << 16) + 5000)
    fa2 = str(tmp_path / "in2.fa")
    chip_smoke.write_fasta(fa2, rng, 2, 1 << 18)
    for name, flags, path in (("k23", ["-k", "23", "-K"], fa),
                              ("k31H", ["-k", "31", "-K", "-H"], fa),
                              ("k31W", ["-k", "31", "-W", "15"], fa2)):
        chip_smoke.run_cli(["count", *flags, "-s", "-C", path, "-o",
                            str(tmp_path / name)])
    from unikmer_tpu_torch.io.fastx import pack_files

    windows, _ = chip_smoke.numpy_windows(pack_files([one], 23).bases, 23,
                                          True)
    inputs = {"fa": fa, "k23": str(tmp_path / "k23.unik"), "one": one,
              "k31H": str(tmp_path / "k31H.unik"), "one_windows": windows,
              "fa2": fa2, "k31W": str(tmp_path / "k31W.unik")}
    launches = chip_smoke.pipeline_path(tmp, rng, CPU, inputs)
    assert set(launches) == {"k1", "h1", "s1", "k2", "k3"}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.fa",
                                                          "k23.unik"]
    assert "UNIKMER_TPU_PIPELINE_DEPTH" not in os.environ
    assert "UNIKMER_TPU_INFLATE_CAP" not in os.environ


@pytest.mark.parametrize("bits", [1, 7, 8, 23, 46, 63, 64])
def test_chip_smoke_constant_digits_match_the_twin(bits):
    """chip_smoke's reckoning of the passes equals the plan twin's."""
    import chip_smoke

    rng = np.random.default_rng(bits)
    for kind in ("random", "top3", "equal", "one_pass"):
        keys = plan_keys(rng, bits, kind)
        steps, _ = plan_twin(keys, bits)
        ran = sum(1 for s in steps if s)
        assert chip_smoke.constant_digits(keys, bits) == (ran,
                                                          len(steps) - ran)


def test_chip_smoke_plan_cases_cover_the_plan():
    """The phase's cases run every pass (an even count), an odd count, one
    pass and none."""
    import chip_smoke

    got = {name: chip_smoke.constant_digits(keys, bits)[0] for name, keys,
           bits in chip_smoke.plan_cases(np.random.default_rng(1), 5000)}
    assert got == {"every pass, 46 bits": 6, "every pass, 64 bits": 8,
                   "top three digits shared": 5, "one pass": 1,
                   "all equal": 0, "all equal sentinels, 46 bits": 0}
