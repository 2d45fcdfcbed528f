"""The port's count model (plain kernels on the CPU) against the JAX
package's models/count.py and a numpy oracle, plus the port's import
and build rules.  Exact equality throughout."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from unikmer_tpu.io.fastx import Record, pack_records
from unikmer_tpu.models import count as jax_count
from unikmer_tpu.ops.codec import BASE_LUT, canonical_np
from unikmer_tpu_torch import _device, _kernels
from unikmer_tpu_torch.io.fastx import PackedSeqs
from unikmer_tpu_torch.models import count as port_count

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def port_packed(p) -> PackedSeqs:
    """The port's PackedSeqs from a JAX one's fields."""
    return PackedSeqs.from_numpy(p.bases, p.starts, p.lengths)


def random_records(rng, n_rec, lo, hi, p_invalid=0.01):
    recs = []
    for i in range(n_rec):
        seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8),
                         size=int(rng.integers(lo, hi)))
        seq[rng.random(len(seq)) < p_invalid] = ord("N")
        if i == 0 and len(seq) > 300:
            seq[200:300] = ord("T")  # poly-T: k=32 code 2^64-1
            seq[-60:] = seq[:60]  # repeated k-mers
        recs.append(Record(b"r%d" % i, b"r%d" % i, seq.tobytes()))
    return recs


def oracle(records, k, canonical, mode, circular=False):
    """numpy count of 2-bit k-mers over the records."""
    parts = []
    for r in records:
        b = BASE_LUT[np.frombuffer(r.seq, np.uint8)]
        if len(b) < k:
            continue
        if circular and k > 1:
            b = np.concatenate([b, b[: k - 1]])
        m = len(b) - k + 1
        codes = np.zeros(m, np.uint64)
        for j in range(k):
            codes = (codes << np.uint64(2)) | (b[j:j + m] & 3).astype(np.uint64)
        bad = np.concatenate([[0], np.cumsum(b >= 4)])
        parts.append(codes[bad[k:] - bad[:m] == 0])
    codes = np.concatenate(parts) if parts else np.zeros(0, np.uint64)
    if canonical:
        codes = canonical_np(codes, k)
    u, c = np.unique(codes, return_counts=True)
    return {"distinct": u, "unique": u[c == 1], "repeated": u[c > 1]}[mode]


@pytest.mark.parametrize("k", [1, 5, 23, 31, 32])
@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_count_packed_matches_oracle(k, mode):
    rng = np.random.default_rng(k)
    recs = random_records(rng, 4, 1, 3000)
    for canonical in (False, True):
        cfg = port_count.CountConfig(k=k, canonical=canonical, mode=mode)
        got = port_count.count_packed(port_packed(pack_records(recs, k)),
                                      cfg, CPU)
        np.testing.assert_array_equal(got, oracle(recs, k, canonical, mode))


@pytest.mark.parametrize("k,canonical,mode,circular", [
    (23, True, "distinct", False),
    (32, False, "unique", False),
    (5, True, "repeated", True),
])
def test_count_packed_matches_jax(k, canonical, mode, circular):
    recs = random_records(np.random.default_rng(k), 3, 50, 4000)
    packed = pack_records(recs, k, circular)
    jcfg = jax_count.CountConfig(k=k, canonical=canonical, mode=mode,
                                 circular=circular)
    want = jax_count.count_packed(packed, jcfg)
    cfg = port_count.CountConfig.from_reference(jcfg)
    np.testing.assert_array_equal(
        port_count.count_packed(port_packed(packed), cfg, CPU), want)


@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_count_stream_packed_matches_jax(mode):
    # a 20 kb record with 3 kb pieces: split_packed overlap-segments it
    recs = random_records(np.random.default_rng(3), 4, 500, 20000)
    k, chunk = 23, 3000
    jcfg = jax_count.CountConfig(k=k, canonical=True, mode=mode)
    packs = [pack_records(recs[:2], k), pack_records(recs[2:], k)]
    want = jax_count.count_stream_packed(iter(packs), jcfg, chunk_bases=chunk)
    got = port_count.count_stream_packed(
        iter([port_packed(p) for p in packs]),
        port_count.CountConfig.from_reference(jcfg),
        chunk_bases=chunk, device=CPU)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle(recs, k, True, mode))


@pytest.mark.parametrize("k", [1, 5, 23, 31, 32])
@pytest.mark.parametrize("circular", [False, True])
def test_count_stream_modes_match_oracle(k, circular):
    recs = random_records(np.random.default_rng(50 + k), 5, 10, 9000)
    for mode in ("distinct", "unique", "repeated"):
        cfg = port_count.CountConfig(k=k, canonical=True, mode=mode,
                                     circular=circular)
        got = port_count.count_stream(iter(recs), cfg, chunk_bases=2500,
                                      device=CPU)
        np.testing.assert_array_equal(
            got, oracle(recs, k, True, mode, circular), err_msg=mode)


def test_split_packed_matches_jax():
    recs = random_records(np.random.default_rng(9), 6, 10, 7000)
    packed = pack_records(recs, 7)
    for chunk, k in ((1000, 7), (5000, 0), (9000, 7)):
        want = list(jax_count.split_packed(packed, chunk, k))
        got = list(port_count.split_packed(port_packed(packed), chunk, k))
        assert len(got) == len(want) > 1
        for gp, wp in zip(got, want):
            np.testing.assert_array_equal(gp.bases, wp.bases)
            np.testing.assert_array_equal(gp.starts, wp.starts)
            np.testing.assert_array_equal(gp.lengths, wp.lengths)


def test_spill_matches_in_ram(monkeypatch):
    recs = random_records(np.random.default_rng(11), 6, 2000, 6000)
    for mode in ("distinct", "unique", "repeated"):
        cfg = port_count.CountConfig(k=15, canonical=True, mode=mode)
        want = port_count.count_stream(iter(recs), cfg, 4000, CPU)
        monkeypatch.setenv("UNIKMER_TPU_COUNT_MEM_MB", "0.01")
        spilled = port_count.count_stream(iter(recs), cfg, 4000, CPU)
        monkeypatch.delenv("UNIKMER_TPU_COUNT_MEM_MB")
        assert isinstance(spilled, port_count.SpilledCount)
        parts = []
        assert spilled.write_to(parts.append) == len(want)
        np.testing.assert_array_equal(np.concatenate(parts), want)


def test_count_step_matches_count_packed():
    recs = random_records(np.random.default_rng(12), 3, 100, 2000)
    packed = port_packed(pack_records(recs, 11))
    for mode in ("distinct", "unique", "repeated"):
        cfg = port_count.CountConfig(k=11, canonical=True, mode=mode)
        out, n = port_count.count_step(torch.from_numpy(packed.bases), cfg)
        np.testing.assert_array_equal(
            out[: int(n)].numpy().view(np.uint64),
            port_count.count_packed(packed, cfg, CPU))


FIELD_GRID = [
    dict(k=23, canonical=True),
    dict(k=40),
    dict(k=21, scale=10),
    dict(k=31, minimizer_w=5),
    dict(k=31, syncmer_s=12, syncmer_impl="compat"),
    dict(k=17, syncmer_impl="compat"),
    dict(k=12, hashed=True, canonical=True, circular=True, mode="unique"),
    dict(k=64, hashed=True, mode="repeated"),
]


@pytest.mark.parametrize("kw", FIELD_GRID)
def test_config_from_reference_matches_jax(kw):
    jcfg = jax_count.CountConfig(**kw)
    pcfg = port_count.CountConfig.from_reference(jcfg)
    direct = port_count.CountConfig(**kw)
    for f in ("k", "canonical", "hashed", "scale", "minimizer_w", "syncmer_s",
              "syncmer_impl", "circular", "mode", "segmentable",
              "needs_record_sep"):
        assert getattr(pcfg, f) == getattr(jcfg, f) == getattr(direct, f), f
    assert pcfg.code_bits == (64 if jcfg.hashed else 2 * jcfg.k)


def test_config_rejects_like_jax():
    for kw in (dict(k=21, minimizer_w=5, syncmer_s=4), dict(k=65)):
        with pytest.raises(ValueError):
            jax_count.CountConfig(**kw)
        with pytest.raises(ValueError):
            port_count.CountConfig(**kw)


@pytest.mark.parametrize("kw,stream", [
    (dict(k=21, hashed=True), False),
    (dict(k=40), False),
    (dict(k=21, scale=4, canonical=True), False),
    (dict(k=33, hashed=True, canonical=True, mode="unique"), False),
    (dict(k=31, scale=2, mode="repeated", circular=True), False),
    (dict(k=64, canonical=True, mode="unique"), True),
    (dict(k=40, hashed=True, mode="repeated"), True),
])
def test_hashed_count_matches_jax(kw, stream):
    """Hashed, scaled and k > 32 configs (ntHash codes, H1's plain
    version) against the JAX package's count_packed / count_stream_packed
    (a 12 kb record cut into 3 kb pieces when streamed)."""
    jcfg = jax_count.CountConfig(**kw)
    cfg = port_count.CountConfig.from_reference(jcfg)
    assert cfg.hashed and cfg.code_bits == 64
    recs = random_records(np.random.default_rng(cfg.k), 3, 500, 12000)
    packed = pack_records(recs, cfg.k, cfg.circular)
    if stream:
        want = jax_count.count_stream_packed(iter([packed]), jcfg,
                                             chunk_bases=3000)
        got = port_count.count_stream_packed(iter([port_packed(packed)]), cfg,
                                             chunk_bases=3000, device=CPU)
    else:
        want = jax_count.count_packed(packed, jcfg)
        got = port_count.count_packed(port_packed(packed), cfg, CPU)
    assert len(want) > (0 if cfg.mode == "repeated" else 100 // cfg.scale)
    np.testing.assert_array_equal(got, want)


SKETCH_COUNTS = [
    (dict(k=31, minimizer_w=15), "packed"),
    (dict(k=31, minimizer_w=15), "stream"),
    (dict(k=31, minimizer_w=15), "linear"),
    (dict(k=21, minimizer_w=5, scale=4, mode="unique"), "packed"),
    (dict(k=21, minimizer_w=5, mode="repeated", circular=True), "stream"),
    (dict(k=31, syncmer_s=16), "packed"),
    (dict(k=31, syncmer_s=16, mode="unique"), "stream"),
    (dict(k=21, syncmer_s=9, scale=3), "linear"),
    (dict(k=31, syncmer_s=16, syncmer_impl="compat"), "packed"),
    (dict(k=31, syncmer_s=16, syncmer_impl="compat", mode="repeated"),
     "stream"),
    (dict(k=21, syncmer_s=9, syncmer_impl="compat"), "linear"),
    (dict(k=15, syncmer_s=15, syncmer_impl="compat", circular=True),
     "packed"),
]


@pytest.mark.parametrize("kw,route", SKETCH_COUNTS,
                         ids=lambda x: x if isinstance(x, str) else str(x))
def test_sketch_count_matches_jax(kw, route):
    """Sketch configs (H1 then S1, plain versions) through count_packed,
    count_stream_packed (3 kb pieces: whole records, never segments) and
    count_linear, against the JAX package, records packed with the
    config's record gap."""
    jcfg = jax_count.CountConfig(**kw)
    cfg = port_count.CountConfig.from_reference(jcfg)
    assert not cfg.segmentable and cfg.record_gap == jcfg.record_gap
    recs = random_records(np.random.default_rng(cfg.k + cfg.minimizer_w),
                          5, 30, 12000)
    packed = pack_records(recs, cfg.k, cfg.circular, gap=cfg.record_gap)
    if route == "stream":
        packs = [pack_records(recs[:2], cfg.k, cfg.circular,
                              gap=cfg.record_gap),
                 pack_records(recs[2:], cfg.k, cfg.circular,
                              gap=cfg.record_gap)]
        want = jax_count.count_stream_packed(iter(packs), jcfg,
                                             chunk_bases=3000)
        got = port_count.count_stream_packed(
            iter([port_packed(p) for p in packs]), cfg, chunk_bases=3000,
            device=CPU)
        assert max(len(r.seq) for r in recs) > 3000 + cfg.k
    elif route == "linear":
        want = jax_count.count_linear(packed, jcfg)
        got = port_count.count_linear(port_packed(packed), cfg, CPU)
    else:
        want = jax_count.count_packed(packed, jcfg)
        got = port_count.count_packed(port_packed(packed), cfg, CPU)
    assert len(want) > (0 if cfg.mode == "repeated" else 200 // cfg.scale)
    np.testing.assert_array_equal(got, want)


def test_sketch_count_stream_keeps_records_whole():
    """count_stream over records: a sketch piece holds whole records, so
    a record longer than the piece size counts as one piece would."""
    recs = random_records(np.random.default_rng(4), 3, 5000, 9000)
    cfg = port_count.CountConfig(k=31, minimizer_w=15)
    whole = port_count.count_packed(
        port_packed(pack_records(recs, 31)), cfg, CPU)
    streamed = port_count.count_stream(iter(recs), cfg, chunk_bases=2000,
                                       device=CPU)
    np.testing.assert_array_equal(streamed, whole)


def test_port_imports_no_jax():
    # conftest imports jax here, so the check runs in a fresh interpreter:
    # every port module and chip_smoke, and then no jax and no module of
    # unikmer_tpu (unikmer_tpu_torch is the port itself)
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "unikmer_tpu_torch").rglob("*.py")) + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib') "
            "or m == 'unikmer_tpu' or m.startswith('unikmer_tpu.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "unikmer_tpu_torch.cli.main" in mods
    assert {f"unikmer_tpu_torch.cli.commands.{c}" for c in (
        "sort", "split", "merge", "tsplit", "head", "sample", "filter",
        "rfilter", "version", "autocompletion")} <= set(mods)
    assert "unikmer_tpu_torch.ops.radix_sort" in mods


def test_kernel_loader_raises_without_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.load()


def test_kernel_follows_a_swapped_library(monkeypatch):
    """A Kernel binds its C function once and again only when the library
    in use is replaced, as a test's fake or a fresh build replaces it."""
    first = types.SimpleNamespace(ukt_copy_inc_u32=lambda *a: 0)
    second = types.SimpleNamespace(ukt_copy_inc_u32=lambda *a: 0)
    kernel = _kernels.Kernel("ukt_copy_inc_u32")
    monkeypatch.setattr(_kernels, "_lib", first)
    assert kernel.bound() is first.ukt_copy_inc_u32
    first.ukt_copy_inc_u32 = None  # bound once: no lookup per call
    assert kernel.bound() is not None
    monkeypatch.setattr(_kernels, "_lib", second)
    assert kernel.bound() is second.ukt_copy_inc_u32


def test_library_name_tracks_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    before = _kernels.library_path()
    (csrc / "a.cu").write_text("// two\n")
    assert _kernels.library_path() != before


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv(_device.ENV_DEVICE, raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        _device.get_device()
    monkeypatch.setenv(_device.ENV_DEVICE, "cpu")
    assert _device.get_device() == CPU


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_count_stream_on_card_matches_oracle(cuda_device, mode):
    recs = random_records(np.random.default_rng(21), 5, 10, 90000)
    cfg = port_count.CountConfig(k=23, canonical=True, mode=mode)
    got = port_count.count_stream(iter(recs), cfg, chunk_bases=50000,
                                  device=cuda_device)
    np.testing.assert_array_equal(got, oracle(recs, 23, True, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(k=31, minimizer_w=15),
    dict(k=21, minimizer_w=5, scale=4, mode="unique"),
    dict(k=31, syncmer_s=16, mode="repeated"),
    dict(k=31, syncmer_s=16, syncmer_impl="compat"),
], ids=str)
def test_sketch_count_on_card_matches_cpu(cuda_device, kw):
    """H1 then S1 on the card against their plain versions on the CPU,
    through count_stream (whole-record pieces) and count_linear."""
    cfg = port_count.CountConfig(**kw)
    recs = random_records(np.random.default_rng(22), 6, 10, 90000)
    for dev in (cuda_device, CPU):
        got = port_count.count_stream(iter(recs), cfg, chunk_bases=50000,
                                      device=dev)
        lin = port_count.count_linear(
            port_packed(pack_records(recs, cfg.k, gap=cfg.record_gap)), cfg,
            dev)
        if dev == CPU:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(lin, want_lin)
        want, want_lin = got, lin
