"""The port's library surface against the JAX package's, on the CPU: the
package root's exports and version constants, the .unik reader's and
writer's accessors, Taxonomy.lca and remap_merged, seq_to_bases and
CODE_SENTINEL, the public sorts, the taxid route knob of ``union`` and
``count -T`` (UNIKMER_TPU_DEVICE_TAXID), the stream profiler
(UNIKMER_TPU_PROFILE_STREAM) and chip_smoke's surface phase, small.
Inputs come from seeded numpy; exact equality throughout."""

import io
import os
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

import unikmer_tpu
import unikmer_tpu_torch
from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.io import unik as jax_unik
from unikmer_tpu.models import count as jax_count
from unikmer_tpu.ops import codec as jax_codec
from unikmer_tpu.ops import sort as jax_sort
from unikmer_tpu.taxonomy import taxdump as jax_taxdump
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import unik
from unikmer_tpu_torch.ops import codec, sort
from unikmer_tpu_torch.taxonomy import taxdump
from unikmer_tpu_torch.utils import stages

REPO = Path(__file__).resolve().parents[1]
TAXDUMP = str(REPO / "tests" / "data" / "taxdump")
RE = ["-r", r"taxid\|(\d+)"]
LIBRARY = ("CountConfig", "count_packed", "count_linear", "UnikReader",
           "UnikWriter", "pack_files", "pack_records", "read_fastx",
           "load_taxonomy", "KmerSet")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three seeded records with N runs, lowercase and a repeat."""
    rng = np.random.default_rng(17)
    path = tmp_path_factory.mktemp("lib") / "in.fa"
    with open(path, "wb") as f:
        for i, n in enumerate((20000, 7000, 31)):
            seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=n)
            seq[rng.random(n) < 0.01] = ord("N")
            if n > 1000:
                seq[-500:] = seq[:500]
            f.write(b">r%d taxid|%d\n%s\n" % (i, (562, 585057, 511145)[i],
                                              seq.tobytes()))
    return str(path)


def test_usage_snippet_imports_from_the_port():
    """docs/USAGE.md's import line, on the port's package root."""
    from unikmer_tpu_torch import (  # noqa: F401
        CountConfig, UnikReader, UnikWriter, count_packed, pack_files,
    )


@pytest.mark.parametrize("name", LIBRARY)
def test_root_export_is_the_module_object(name):
    """Each lazy export of the root is its module's object, as in the
    JAX package."""
    import importlib

    where = {"CountConfig": "models.count", "count_packed": "models.count",
             "count_linear": "models.count", "UnikReader": "io.unik",
             "UnikWriter": "io.unik", "pack_files": "io.fastx",
             "pack_records": "io.fastx", "read_fastx": "io.fastx",
             "load_taxonomy": "taxonomy.taxdump", "KmerSet": "api"}[name]
    mod = importlib.import_module(f"unikmer_tpu_torch.{where}")
    assert getattr(unikmer_tpu_torch, name) is getattr(mod, name)
    assert hasattr(unikmer_tpu, name)
    with pytest.raises(AttributeError):
        getattr(unikmer_tpu_torch, "no_such_export")


def test_version_constants_match_jax():
    assert (unikmer_tpu_torch.UNIK_MAIN_VERSION,
            unikmer_tpu_torch.UNIK_MINOR_VERSION) == (
        unikmer_tpu.UNIK_MAIN_VERSION, unikmer_tpu.UNIK_MINOR_VERSION) == (
        unik.MAIN_VERSION, unik.MINOR_VERSION)


@pytest.mark.parametrize("k,canonical,hashed,fn", [
    (23, True, False, "count_packed"), (21, False, False, "count_packed"),
    (31, True, True, "count_packed"), (23, True, False, "count_linear"),
    (40, False, True, "count_linear")])
def test_usage_snippet_matches_jax(fasta, k, canonical, hashed, fn):
    """The USAGE snippet with device="cpu": the JAX package's codes."""
    from unikmer_tpu_torch import CountConfig, pack_files

    want = getattr(jax_count, fn)(
        unikmer_tpu.pack_files([fasta], k=k),
        unikmer_tpu.CountConfig(k=k, canonical=canonical, hashed=hashed))
    got = getattr(unikmer_tpu_torch, fn)(
        pack_files([fasta], k=k),
        CountConfig(k=k, canonical=canonical, hashed=hashed), device="cpu")
    assert got.dtype == np.uint64 and len(got) > 1000
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("flag,number", [
    (jax_unik.SORTED | jax_unik.CANONICAL, 1234), (jax_unik.HASHED, -1),
    (jax_unik.INCLUDE_TAXID | jax_unik.COMPACT, 77)])
def test_reader_and_writer_accessors_match_jax(tmp_path, flag, number):
    """k, flag and number read by both readers from one file, and the
    writer's number: settable before the first write only."""
    rng = np.random.default_rng(flag)
    codes = np.sort(rng.integers(0, 1 << 42, size=500, dtype=np.uint64))
    taxids = (rng.integers(1, 1000, size=500).astype(np.uint32)
              if flag & jax_unik.INCLUDE_TAXID else None)
    got = {}
    for name, mod in (("jax", jax_unik), ("port", unik)):
        path = tmp_path / f"{name}.unik"
        with mod.UnikWriter(str(path), k=21, flag=flag, max_taxid=1000,
                            compress=False) as w:
            assert w.number == -1
            w.number = number
            assert w.number == number
            w.write_codes(codes, taxids)
            with pytest.raises(RuntimeError):
                w.number = 5
        got[name] = path.read_bytes()
        for reader in (jax_unik.UnikReader, unik.UnikReader):
            with reader(str(path)) as r:
                assert (r.k, r.flag, r.number) == (21, flag, number)
    assert got["port"] == got["jax"]


@pytest.fixture(scope="module")
def merged_taxdump(tmp_path_factory):
    """A seeded 2,000-node tree with a merged.dmp of 300 old taxids."""
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("taxdump")
    n = 2000
    parent = np.concatenate([[1], rng.integers(1, np.arange(2, n + 1))])
    with open(d / "nodes.dmp", "w") as f:
        f.writelines(f"{t}\t|\t{parent[t - 1]}\t|\tno rank\t|\t\t|\n"
                     for t in range(1, n + 1))
    old = rng.choice(np.arange(n + 1, 3 * n), 300, replace=False)
    new = rng.integers(1, n + 1, size=300)
    with open(d / "merged.dmp", "w") as f:
        f.writelines(f"{o}\t|\t{m}\t|\n" for o, m in zip(old, new))
    return (jax_taxdump.load_taxonomy(str(d)), taxdump.load_taxonomy(str(d)),
            old)


def test_taxonomy_lca_matches_jax(merged_taxdump):
    want_db, got_db, old = merged_taxdump
    rng = np.random.default_rng(12)
    pool = np.concatenate([np.arange(0, 2010), old[:20]])
    for a, b in rng.choice(pool, size=(2000, 2)):
        assert got_db.lca(int(a), int(b)) == want_db.lca(int(a), int(b))


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_remap_merged_matches_jax(merged_taxdump, n):
    want_db, got_db, old = merged_taxdump
    rng = np.random.default_rng(n)
    t = rng.choice(np.concatenate([old, np.arange(0, 2100)]), n
                   ).astype(np.uint32)
    got = got_db.remap_merged(t)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want_db.remap_merged(t))
    assert len(got_db.merged) == 300
    unmerged = taxdump.Taxonomy.from_numpy(got_db.parent, got_db.depth,
                                           got_db.rank_ids, got_db.ranks)
    np.testing.assert_array_equal(unmerged.remap_merged(t), t)


@pytest.mark.parametrize("kind", ["bytes", "numpy", "tensor"])
def test_seq_to_bases_matches_jax(kind):
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 256, size=4096, dtype=np.uint8)
    raw[:2048] = rng.choice(np.frombuffer(b"ACGTUacgtuN\n", np.uint8), 2048)
    arg = {"bytes": raw.tobytes(), "numpy": raw,
           "tensor": torch.from_numpy(raw)}[kind]
    got = codec.seq_to_bases(arg, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_codec.seq_to_bases(raw)))
    assert codec.CODE_SENTINEL == jax_codec.CODE_SENTINEL
    assert codec.CODE_SENTINEL.dtype == np.uint64
    assert int(codec.CODE_SENTINEL) == codec.SENTINEL & ((1 << 64) - 1)


def codes_with_ties(rng, n, bits):
    c = rng.integers(0, 1 << bits, size=n, dtype=np.uint64)
    c[rng.random(n) < 0.05] = jax_codec.CODE_SENTINEL
    c[1::7] = c[::7][:len(c[1::7])]  # equal codes
    return c


@pytest.mark.parametrize("n,bits", [(0, 64), (1, 64), (3000, 64),
                                    (3000, 46), (70000, 64)])
def test_sort_codes_matches_jax(n, bits):
    """A numpy array in gives numpy out; a tensor in gives a tensor out on
    its device; both equal to the JAX sort (run as its tests run it on the
    CPU), with code_bits from sort_code_bits where it applies."""
    rng = np.random.default_rng(n + bits)
    c = codes_with_ties(rng, n, bits)
    want = np.asarray(jax_sort.sort_codes(c))
    cb = sort.sort_code_bits(23, False) if bits < 64 else 64
    got = sort.sort_codes(c, cb, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    t = sort.sort_codes(torch.from_numpy(c.view(np.int64)), cb)
    assert t.dtype == torch.int64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy().view(np.uint64), want)


def by_code_then_taxid(c, t):
    order = np.lexsort((t, c))
    return c[order], t[order]


@pytest.mark.parametrize("n", [0, 1, 3000, 70000])
def test_sort_codes_taxids_matches_jax(n):
    """Equal codes, and per code equal multisets of taxids (the tie order
    is free)."""
    rng = np.random.default_rng(n)
    c = codes_with_ties(rng, n, 20)
    t = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    wc, wt = (np.asarray(x) for x in jax_sort.sort_codes_taxids(c, t))
    for got_c, got_t in (
            sort.sort_codes_taxids(c, t, device="cpu"),
            (x.numpy().view(dt) for x, dt in zip(sort.sort_codes_taxids(
                torch.from_numpy(c.view(np.int64)),
                torch.from_numpy(t.view(np.int32))), (np.uint64, np.uint32)))):
        np.testing.assert_array_equal(got_c, wc)
        for x, y in zip(by_code_then_taxid(got_c, got_t),
                        by_code_then_taxid(wc, wt)):
            np.testing.assert_array_equal(x, y)


def test_sort_code_bits_matches_jax():
    from unikmer_tpu_torch.ops.radix_sort import radix_shifts

    for k in range(1, 65):
        for hashed in (False, True):
            bits = sort.sort_code_bits(k, hashed)
            assert bits == jax_sort.sort_code_bits(k, hashed)
            assert len(radix_shifts(bits)) == (
                8 if bits == 64 else -(-(bits + 1) // 8))


@pytest.mark.parametrize("native_on", [True, False])
def test_native_counterparts_match_jax(tmp_path, monkeypatch, native_on):
    """The JAX wrappers the port does under other names (the surface
    test's COUNTERPARTS): sort_u64 -> host_sort, map_bases_skip_ws ->
    load_fastx_packed's bases, decode_deltas_gb64 ->
    decode_sorted_blocks.  Without the library the JAX wrappers give
    None; host_sort falls back to numpy and the loader to None."""
    from unikmer_tpu import native as jax_native
    from unikmer_tpu_torch import native

    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 64, size=5000, dtype=np.uint64)
    vals = np.sort(rng.integers(0, 1 << 62, size=1001, dtype=np.uint64))
    seq = rng.choice(np.frombuffer(b"ACGTNacgu", np.uint8), 5000)
    text = b"\n".join(seq[i:i + 61].tobytes() for i in range(0, 5000, 61))
    fa = tmp_path / "w.fa"
    fa.write_bytes(b">r1\n" + text + b"\n")
    if not native_on:
        monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
        assert jax_native.sort_u64(keys) is None
        assert jax_native.map_bases_skip_ws(text) is None
        np.testing.assert_array_equal(native.host_sort(keys), np.sort(keys))
        assert native.load_fastx_packed(str(fa), 5) is None
        return
    np.testing.assert_array_equal(native.host_sort(keys),
                                  jax_native.sort_u64(keys))
    bases, _, lengths, _ = native.load_fastx_packed(str(fa), 5)
    np.testing.assert_array_equal(bases[:lengths[0]],
                                  jax_native.map_bases_skip_ws(text))
    want, _ = jax_native.decode_deltas_gb64(
        jax_native.encode_deltas_gb64(vals, 0), len(vals), 0)
    got, _ = native.decode_sorted_blocks(
        native.encode_sorted_blocks(vals, None, 0, 256), 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("second,ignore", [("same", False), ("taxid", False),
                                           ("taxid", True), ("k", False)])
def test_load_inputs_checks_match_jax_opts(tmp_path, caplog, second, ignore):
    """JAX's opts.open_readers and check_taxid_consistency against the
    port's counterpart, _setops.load_inputs, over a pair of files: the
    same has_taxid, or the same error line and exit code."""
    from unikmer_tpu.cli import opts as jax_opts
    from unikmer_tpu_torch.cli import opts
    from unikmer_tpu_torch.cli.commands._setops import load_inputs

    codes = np.arange(10, 200, 7, dtype=np.uint64)
    files = []
    for name, k, flag in (("a", 21, 0), ("b", 23 if second == "k" else 21,
                                         jax_unik.INCLUDE_TAXID
                                         if second == "taxid" else 0)):
        path = str(tmp_path / f"{name}.unik")
        with jax_unik.UnikWriter(path, k=k, flag=flag, compress=False) as w:
            w.write_codes(codes, np.ones(len(codes), np.uint32)
                          if flag else None)
        files.append(path)

    def jax_checks(opt):
        readers = jax_opts.open_readers(files, opt)
        try:
            return jax_opts.check_taxid_consistency(readers, files, opt)
        finally:
            for r in readers:
                r.close()

    got = {}
    for name, run, mod in (("jax", jax_checks, jax_opts),
                           ("port", lambda o: load_inputs(files, o)[3], opts)):
        try:
            res = run(mod.Options(ignore_taxid=ignore))
        except SystemExit as e:
            res = ("exit", e.code)
        got[name] = (res, [r.getMessage() for r in caplog.records])
        caplog.clear()
    assert got["port"] == got["jax"]
    assert isinstance(got["port"][0], tuple) == bool(got["port"][1]) == (
        second == "k" or (second == "taxid" and not ignore))


# ---------------------------------------------------------------------
# UNIKMER_TPU_DEVICE_TAXID


@pytest.fixture(scope="module")
def taxid_uniks(tmp_path_factory):
    """Two sorted .unik files with per-code taxids of the test taxdump."""
    rng = np.random.default_rng(23)
    d = tmp_path_factory.mktemp("taxid_uniks")
    known = np.flatnonzero(jax_taxdump.load_taxonomy(TAXDUMP).depth >= 0)
    a = np.unique(rng.integers(0, 1 << 40, size=4000, dtype=np.uint64))
    b = np.unique(np.concatenate([a[::3], rng.integers(
        0, 1 << 40, size=2000, dtype=np.uint64)]))
    paths = []
    for name, codes in (("a", a), ("b", b)):
        path = str(d / f"{name}.unik")
        with jax_unik.UnikWriter(path, k=21, flag=jax_unik.SORTED
                                 | jax_unik.INCLUDE_TAXID, compress=False,
                                 max_taxid=(1 << 32) - 1) as w:
            w.write_codes(codes, rng.choice(known[known > 0], len(codes)
                                            ).astype(np.uint32))
        paths.append(path)
    return paths


def spy_on(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("knob,min_mb,device", [
    ("auto", None, False), ("auto", "0", True), ("1", None, True),
    ("0", None, False), ("0", "0", False)])
def test_union_taxid_routes_match_jax_cli(taxid_uniks, tmp_path, monkeypatch,
                                          knob, min_mb, device):
    """``union -s -C`` with taxids under each knob: the JAX CLI's bytes;
    the port takes union_taxids_device exactly where the knob says (auto
    from UNIKMER_TPU_DEVICE_TAXID_MIN_MB of input, here 0)."""
    from unikmer_tpu_torch.ops import device_sets

    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID", knob)
    if min_mb is not None:
        monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID_MIN_MB", min_mb)
    calls = spy_on(monkeypatch, device_sets, "union_taxids_device")
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        assert main(["union", "-s", "-C", "--data-dir", TAXDUMP, *taxid_uniks,
                     "-o", str(tmp_path / name)]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 1000 and outs["port"] == outs["jax"]
    assert bool(calls) == device


def test_union_auto_takes_the_device_in_the_server(taxid_uniks, tmp_path,
                                                   monkeypatch):
    """In the resident server ``auto`` tries the device at any size, as
    count's ``auto`` takes it there."""
    from unikmer_tpu_torch.ops import device_sets

    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_IN_SERVER", "1")
    monkeypatch.delenv("UNIKMER_TPU_DEVICE_TAXID", raising=False)
    calls = spy_on(monkeypatch, device_sets, "union_taxids_device")
    assert port_main(["union", "-s", "-C", "--data-dir", TAXDUMP,
                      *taxid_uniks, "-o", str(tmp_path / "u")]) == 0
    assert calls


@pytest.mark.parametrize("total,device", [(230_346_194, False),
                                           (458_292_933, True)])
def test_union_auto_threshold_is_the_cards_crossover(tmp_path, monkeypatch,
                                                     total, device):
    """auto's default threshold lies between the input sizes at which
    taxid_route_times saw the host engine win (230,346,194 B) and the
    card win (458,292,933 B) on an H100; sparse files of those sizes."""
    from unikmer_tpu_torch.cli.commands import union

    for var in ("UNIKMER_TPU_DEVICE_TAXID", "UNIKMER_TPU_DEVICE_TAXID_MIN_MB",
                "UNIKMER_TPU_IN_SERVER"):
        monkeypatch.delenv(var, raising=False)
    files = [str(tmp_path / "a.unik"), str(tmp_path / "b.unik")]
    for f, size in zip(files, (total // 2, total - total // 2)):
        with open(f, "wb") as fh:
            fh.truncate(size)
    assert union._device_taxid_requested(files) == device


def test_union_from_stdin_stays_on_the_host(taxid_uniks, monkeypatch):
    from unikmer_tpu_torch.cli.commands import union

    monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID_MIN_MB", "0")
    monkeypatch.delenv("UNIKMER_TPU_DEVICE_TAXID", raising=False)
    monkeypatch.delenv("UNIKMER_TPU_IN_SERVER", raising=False)
    assert union._device_taxid_requested(taxid_uniks)
    assert not union._device_taxid_requested([taxid_uniks[0], "-"])
    assert not union._device_taxid_requested([taxid_uniks[0], "/no/file"])


@pytest.mark.parametrize("knob,flags", [
    ("0", ["-k", "15", "-K"]), ("1", ["-k", "15", "-K"]),
    ("auto", ["-k", "15", "-K"]), ("0", ["-k", "21", "-u"]),
    ("0", ["-k", "21", "-K", "-d"]), ("0", ["-k", "21", "-H", "-K"])])
def test_count_taxid_routes_match_jax_cli(fasta, tmp_path, monkeypatch, knob,
                                          flags):
    """``count -T -C`` under each knob (device routes of both CLIs): the
    JAX CLI's bytes; =0 takes the host reduction (count_taxids_unknown),
    1 and auto the device collapse."""
    from unikmer_tpu_torch.models import count as port_count

    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID", knob)
    calls = spy_on(monkeypatch, port_count, "count_taxids_unknown")
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        assert main(["count", *flags, "-s", "-C", "-T", *RE, "--data-dir",
                     TAXDUMP, fasta, "-o", str(tmp_path / name)]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 100 and outs["port"] == outs["jax"]
    assert bool(calls) == (knob == "0")


def test_taxid_route_times_on_the_cpu(tmp_path, monkeypatch):
    """The script behind UNIKMER_TPU_DEVICE_TAXID_MIN_MB, at a small size
    on the CPU: the two routes' fresh unions agree byte for byte, and
    the input is about the size asked for."""
    from unikmer_tpu_torch import taxid_route_times

    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    [row] = list(taxid_route_times.route_times([0.5], str(tmp_path),
                                               on_card=False))
    assert 0.8 < row["input_bytes"] / (1 << 19) < 1.25
    assert len(row["host_s"]) == len(row["device_s"]) == 2
    assert row["host_wins"] == (max(row["host_s"]) < min(row["device_s"]))


# ---------------------------------------------------------------------
# UNIKMER_TPU_PROFILE_STREAM


@pytest.fixture
def profile(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_PROFILE_STREAM", "1")
    stages.stream_profile_reset()
    yield
    monkeypatch.delenv("UNIKMER_TPU_PROFILE_STREAM")
    stages.stream_profile_reset()


def test_stream_profile_report_has_the_jax_layout(profile):
    """The port's report of a table is the JAX package's report of the
    same table, line for line; stages are exclusive of the stages they
    hold."""
    import time

    from unikmer_tpu_torch.models import count as port_count

    with stages.stage("outer", "cpu"):
        time.sleep(0.02)
        with stages.stage("inner", "cpu"):
            time.sleep(0.05)
    with stages.stage("inner", "cpu"):
        pass
    table = port_count.stream_profile_table()
    assert table["inner"][1] == 2 and table["outer"][1] == 1
    assert 0.02 <= table["outer"][0] < 0.05 <= table["inner"][0]
    got, want = io.StringIO(), io.StringIO()
    port_count.stream_profile_report(got)
    old = jax_count._PROF
    jax_count._PROF = {k: list(v) for k, v in table.items()}
    try:
        jax_count.stream_profile_report(want)
    finally:
        jax_count._PROF = old
    assert got.getvalue() == want.getvalue()
    lines = got.getvalue().splitlines()
    assert lines[0] == "# stream profile (exclusive wall per phase):"
    assert lines[1].startswith("#   inner ") and lines[-1].startswith(
        "#   TOTAL(tracked)")


def test_stream_profile_is_off_without_the_knob(monkeypatch):
    monkeypatch.delenv("UNIKMER_TPU_PROFILE_STREAM", raising=False)
    stages.stream_profile_reset()
    with stages.stage("x", "cpu"):
        pass
    assert stages.stream_profile_table() == {}
    out = io.StringIO()
    stages.stream_profile_report(out)
    assert out.getvalue() == ""


@pytest.mark.parametrize("knob,host", [("1", "0"), ("1", "1"), ("0", "0")])
def test_count_prints_the_stream_profile(fasta, tmp_path, monkeypatch, knob,
                                         host):
    """``count`` with the knob prints the report after its run, on either
    route (the device route's stages on the CPU), the output unchanged;
    without it stderr is empty."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", host)
    monkeypatch.setenv("UNIKMER_TPU_PROFILE_STREAM", knob)
    err = io.StringIO()
    with redirect_stderr(err):
        assert port_main(["count", "-k", "23", "-K", "-s", "-C", fasta, "-o",
                          str(tmp_path / "p")]) == 0
    stages.stream_profile_reset()
    assert jax_main(["count", "-k", "23", "-K", "-s", "-C", fasta, "-o",
                     str(tmp_path / "j")]) == 0
    assert (tmp_path / "p.unik").read_bytes() == (
        tmp_path / "j.unik").read_bytes()
    lines = err.getvalue().splitlines()
    if knob == "0":
        assert lines == []
        return
    assert lines[0] == "# stream profile (exclusive wall per phase):"
    assert lines[-1].startswith("#   TOTAL(tracked)")
    names = {ln.split()[1] for ln in lines[1:-1]}
    assert {"ingest", "write"} <= names
    assert ({"k1", "sort", "collapse", "d2h"} <= names) == (host == "0")


# ---------------------------------------------------------------------
# chip_smoke's surface phase


def test_chip_smoke_surface_path_on_the_cpu(tmp_path, monkeypatch):
    """The surface phase small on the CPU (the kernels' plain versions,
    which count no launch): every check but the launch counts holds."""
    import chip_smoke

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=5, before=None: (fn(), 0.0)[1])
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID", "1")
    for name, value in (("SURFACE_BASES", 1 << 16),
                        ("SURFACE_SORT_KEYS", 1 << 14),
                        ("SURFACE_PAIRS", 1 << 14),
                        ("SURFACE_UNION_CODES", 1 << 12),
                        ("SURFACE_COUNTS", False), ("TAX_NODES", 3000),
                        ("TAX_CHAIN", 40)):
        monkeypatch.setattr(chip_smoke, name, value)
    rng = np.random.default_rng(8)
    d = tmp_path / "taxdump"
    d.mkdir()
    leaves, chain = chip_smoke.write_taxonomy(str(d), rng)
    t1 = np.concatenate([chain[-4:], rng.choice(leaves, 12, replace=False)])
    fa = str(tmp_path / "T1.fa")
    chip_smoke.write_taxid_fasta(fa, rng, t1, 3000)
    chip_smoke.oracle_taxid_unik(fa, str(tmp_path / "T1.oracle.unik"), 23,
                                 True, "distinct", str(d))
    out = chip_smoke.surface_path(str(tmp_path), rng, torch.device("cpu"),
                                  str(d), fa)
    row = out["row"]
    assert row["usage"]["codes"] > 60000
    routes = row["routes"]
    assert [routes[f"union_{k}_torch"] for k in ("auto", "1", "0")] == [
        False, True, False]
    assert set(routes) >= {"count_T1_0_s", "count_T1_auto_s"}
    assert row["profile"]["report"][0] == chip_smoke.PROFILE_HEADER
    assert os.environ["UNIKMER_TPU_DEVICE_TAXID"] == "1"
    assert "UNIKMER_TPU_PROFILE_STREAM" not in os.environ
