"""The port's host count engine (models/count_host.py and the window
kernels of native/host_native.cpp) against the JAX package's
(unikmer_tpu/models/count_host.py, unikmer_tpu/native), and count's
routing (cli/commands/count.py ``_host_count_wanted``) against the JAX
CLI's: the same inputs, made from a numpy seed, give equal arrays, and
the CLI on either route writes the JAX CLI's bytes under -C.
"""

import argparse
import io
import logging
import re
from pathlib import Path

import numpy as np
import pytest

from unikmer_tpu import native as jax_native
from unikmer_tpu.cli.commands import count as jax_count_cmd
from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.io import fastx as jax_fastx
from unikmer_tpu.models import count_host as jax_host
from unikmer_tpu.taxonomy.taxdump import load_taxonomy as jax_taxonomy
from unikmer_tpu_torch import native
from unikmer_tpu_torch.cli.commands import count as count_cmd
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import fastx
from unikmer_tpu_torch.models import count_host
from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

REPO = Path(__file__).resolve().parents[1]
TAXDUMP = str(REPO / "tests" / "data" / "taxdump")
RE_TAXID = r"taxid\|(\d+)"
TAXIDS = (9606, 562, 511145, 585057, 349741, 2)
KS = (1, 23, 31, 32, 64)


def bases(seed: int, n: int = 20000) -> np.ndarray:
    """Base codes 0-3 with about 2% invalid bytes (4 and 254) in runs."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, size=n, dtype=np.uint8)
    for at in rng.integers(0, n, size=n // 400):
        b[at:at + int(rng.integers(1, 12))] = rng.choice([4, 254])
    return b


def records(seed: int, n: int = 9, lo: int = 1, hi: int = 3000):
    """(name, seq) pairs: ACGT with N runs and lowercase, some shorter
    than k, headers carrying a taxid."""
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGTacgtN", np.uint8)
    out = []
    for i in range(n):
        seq = lut[rng.choice(9, size=int(rng.integers(lo, hi)),
                             p=[0.24] * 4 + [0.01] * 4 + [0.0])]
        if len(seq) > 100:
            at = int(rng.integers(0, len(seq) - 50))
            seq[at:at + int(rng.integers(1, 40))] = ord("N")
        out.append((b"r%d taxid|%d" % (i, TAXIDS[i % len(TAXIDS)]),
                    seq.tobytes()))
    out.append(out[0])  # a repeated record: unique and repeated differ
    return out


def both_records(pairs):
    return ([jax_fastx.Record(n, n.split()[0], s) for n, s in pairs],
            [fastx.Record(n, n.split()[0], s) for n, s in pairs])


def both_packed(pairs, k: int, circular: bool = False, gap: int = 1):
    jr, pr = both_records(pairs)
    return (jax_fastx.pack_records(jr, k, circular, gap=gap),
            fastx.pack_records(pr, k, circular, gap=gap))


def assert_same(got, want):
    if want is None:
        assert got is None
        return
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the window kernels


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_encode_windows_matches_jax(k, canonical):
    b = bases(k)
    want = jax_native.encode_windows(b, k, canonical)
    assert (want is None) == (k > 32)
    assert_same(native.encode_windows(b, k, canonical), want)


@pytest.mark.parametrize("scale", [1, 15])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
def test_nthash_windows_matches_jax(k, canonical, scale):
    b = bases(100 + k)
    want = jax_native.nthash_windows(b, k, canonical, scale)
    assert len(want) > 0 or (k == 1 and scale > 1)  # 4 hashes at k = 1
    assert_same(native.nthash_windows(b, k, canonical, scale), want)


@pytest.mark.parametrize("kind,w_or_s", [("minimizer", 15), ("syncmer", 16),
                                         ("syncmer_compat", 16)])
@pytest.mark.parametrize("k", KS)
def test_sketch_emit_matches_jax(k, kind, w_or_s):
    b = bases(200 + k)
    want = jax_native.sketch_emit(b, k, w_or_s, kind)
    assert_same(native.sketch_emit(b, k, w_or_s, kind), want)


def test_window_kernels_without_the_library(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    b = bases(3)
    assert native.encode_windows(b, 21, True) is None
    assert native.nthash_windows(b, 21, True) is None
    assert native.sketch_emit(b, 21, 15, "minimizer") is None
    assert not count_host.supported(21, False, 1, 0, 0)


# ---------------------------------------------------------------------------
# the engine's functions


ENGINE_CASES = [
    dict(k=21, canonical=True),
    dict(k=23, canonical=False, mode="unique"),
    dict(k=32, canonical=True, mode="repeated"),
    dict(k=11, canonical=True, circular=True),
    dict(k=31, canonical=True, hashed=True),
    dict(k=31, canonical=False, hashed=True, scale=15),
    dict(k=64, canonical=True, hashed=True, mode="unique"),
    dict(k=31, canonical=True, hashed=True, minimizer_w=15),
    dict(k=21, canonical=True, hashed=True, minimizer_w=5, scale=3),
    dict(k=31, canonical=True, hashed=True, syncmer_s=16, mode="repeated"),
    dict(k=21, canonical=True, hashed=True, syncmer_s=9,
         syncmer_impl="compat"),
]


def engine_args(case):
    kw = dict(case)
    circular = kw.pop("circular", False)
    return kw, circular


@pytest.mark.parametrize("case", ENGINE_CASES, ids=repr)
def test_count_host_matches_jax(case):
    kw, circular = engine_args(case)
    gap = (max(2 * (kw["k"] - kw["syncmer_s"]) - kw["syncmer_s"] + 1, 1)
           if kw.get("syncmer_impl") == "compat" else 1)
    jp, pp = both_packed(records(kw["k"]), kw["k"], circular, gap)
    want = jax_host.count_host(jp, **kw)
    assert len(want) > 0
    assert_same(count_host.count_host(pp, **kw), want)
    kw.pop("mode", None)
    assert_same(count_host.linear_host(pp, **kw),
                jax_host.linear_host(jp, **kw))


@pytest.mark.parametrize("hashed", [False, True])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 21, 32])
def test_linear_windows_host_matches_jax(k, canonical, hashed):
    b = bases(300 + k)
    want = jax_host.linear_windows_host(b, k, canonical, hashed)
    got = count_host.linear_windows_host(b, k, canonical, hashed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(count_host._valid_window_positions(b, k),
                                  jax_host._valid_window_positions(b, k))


@pytest.mark.parametrize("case", [
    dict(k=15, canonical=True, hashed=False, scale=1, mode="distinct"),
    dict(k=21, canonical=False, hashed=False, scale=1, mode="unique"),
    dict(k=31, canonical=True, hashed=True, scale=1, mode="repeated"),
    dict(k=31, canonical=True, hashed=True, scale=7, mode="distinct",
         circular=True),
], ids=repr)
def test_count_taxids_host_matches_jax(case):
    kw = dict(case)
    circular = kw.pop("circular", False)
    jr, pr = both_records(records(kw["k"] + 7, n=14))
    re_taxid = re.compile(RE_TAXID.encode())
    want = jax_host.count_taxids_host(jr, circular=circular,
                                      re_taxid=re_taxid,
                                      taxdb=jax_taxonomy(TAXDUMP), **kw)
    got = count_host.count_taxids_host(pr, circular=circular,
                                       re_taxid=re_taxid,
                                       taxdb=load_taxonomy(TAXDUMP), **kw)
    assert len(want[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_supported_matches_jax():
    for k in range(0, 66):
        for hashed, scale, w, s in ((False, 1, 0, 0), (True, 1, 0, 0),
                                    (False, 3, 0, 0), (True, 1, 15, 0),
                                    (True, 1, 0, 16)):
            assert (count_host.supported(k, hashed, scale, w, s)
                    == jax_host.supported(k, hashed, scale, w, s))


# ---------------------------------------------------------------------------
# the CLI on both routes


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("hostcount")
    paths = []
    for f in range(2):
        p = d / f"in{f}.fa"
        with open(p, "wb") as out:
            for name, seq in records(40 + f, n=6, lo=20, hi=4000):
                out.write(b">%s\n%s\n" % (name, seq))
        paths.append(str(p))
    return paths


T = ["-T", "-r", RE_TAXID, "--data-dir", TAXDUMP]
CLI_CASES = [
    ["-k", "23", "-K", "-s"],
    ["-k", "21", "-s", "-u"],
    ["-k", "21", "-K", "-s", "-d", "--circular"],
    ["-k", "32", "-s"],
    ["-k", "23", "-K"],
    ["-k", "19", "-K", "-s", "-t", "562"],
    ["-k", "31", "-K", "-H", "-s"],
    ["-k", "31", "-K", "-D", "15", "-s"],
    ["-k", "64", "-H", "-u", "-s"],
    ["-k", "31", "-W", "15", "-s"],
    ["-k", "31", "-S", "16", "-s"],
    ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s"],
    ["-k", "21", "-K", "-l"],
    ["-k", "27", "-K", "-H", "-l"],
    ["-k", "23", "-W", "5", "-l"],
    ["-k", "15", "-K", "-s", *T],
    ["-k", "31", "-K", "-H", "-D", "3", "-s", *T],
    ["-k", "15", "-K", "-l", *T],
    ["-k", "21", "-W", "5", "-s", *T],
]


def routes_logged(caplog) -> list:
    return [r.getMessage() for r in caplog.records
            if r.name == "unikmer_tpu_torch" and "route" in r.getMessage()]


def run_port(argv, caplog) -> list:
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="unikmer_tpu_torch"):
        assert port_main(argv) == 0
    return routes_logged(caplog)


@pytest.mark.parametrize("flags", CLI_CASES, ids=" ".join)
def test_cli_bytes_match_jax_on_both_routes(fastas, tmp_path, monkeypatch,
                                            caplog, flags):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    assert jax_main(["count", *flags, "-C", *fastas, "-o",
                     str(tmp_path / "jax")]) == 0
    want = (tmp_path / "jax.unik").read_bytes()
    sketch_t = "-T" in flags and "-W" in flags
    compat = "compat" in flags
    for knob in ("1", "0"):
        monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", knob)
        routes = run_port(["count", *flags, "-V", "-C", *fastas, "-o",
                           str(tmp_path / knob)], caplog)
        host = (knob == "1" or compat) and not sketch_t
        assert routes == [f"count: the {'host' if host else 'device'} route"]
        assert (tmp_path / f"{knob}.unik").read_bytes() == want


# ---------------------------------------------------------------------------
# the routing table


def count_args(**kw):
    base = dict(scale=1, minimizer_w=0, syncmer_s=0)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("knob", [None, "0", "1", "auto"])
@pytest.mark.parametrize("max_mb", [None, "0.001", "1000"])
def test_host_count_wanted_matches_jax(fastas, monkeypatch, knob, max_mb):
    monkeypatch.delenv("UNIKMER_TPU_IN_SERVER", raising=False)
    for name, value in (("UNIKMER_TPU_HOST_COUNT", knob),
                        ("UNIKMER_TPU_HOST_COUNT_MAX_MB", max_mb)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for files in (fastas, fastas[:1], ["-"], [fastas[0], "-"],
                  [fastas[0] + ".missing"]):
        for k, hashed, kw in ((23, False, {}), (33, True, {}),
                              (21, True, {"scale": 4}),
                              (21, False, {"scale": 4}),
                              (31, True, {"minimizer_w": 15}),
                              (31, True, {"syncmer_s": 16}),
                              (65, True, {})):
            args = count_args(**kw)
            assert (count_cmd._host_count_wanted(files, k, hashed, args)
                    == jax_count_cmd._host_count_wanted(files, k, hashed,
                                                        args)), (files, k)


@pytest.mark.parametrize("knob,flags,want", [
    ("auto", ["-k", "23", "-K", "-s"], "device"),
    ("auto", ["-k", "31", "-K", "-H", "-l"], "device"),
    ("1", ["-k", "23", "-K", "-s"], "host"),
    ("auto", ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s"],
     "host"),
])
def test_auto_takes_the_device_in_the_server(fastas, tmp_path, monkeypatch,
                                             caplog, knob, flags, want):
    """In the resident server (UNIKMER_TPU_IN_SERVER set) auto routes
    to the device, where the JAX routing would take the host: the start-up
    the host engine saves is paid there.  =1 and the compat syncmer keep
    the host engine, and the bytes are the local call's."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", knob)
    argv = ["count", *flags, "-V", "-C", *fastas, "-o"]
    monkeypatch.delenv("UNIKMER_TPU_IN_SERVER", raising=False)
    run_port(argv + [str(tmp_path / "local")], caplog)
    monkeypatch.setenv("UNIKMER_TPU_IN_SERVER", "1")
    assert run_port(argv + [str(tmp_path / "served")], caplog) == [
        f"count: the {want} route"]
    assert ((tmp_path / "served.unik").read_bytes()
            == (tmp_path / "local.unik").read_bytes())


def test_host_max_bases_matches_jax(monkeypatch):
    assert count_cmd._host_max_bases() == jax_count_cmd._host_max_bases()
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT_MAX_BASES", "1000")
    assert count_cmd._host_max_bases() == jax_count_cmd._host_max_bases()


ROUTE_CASES = [
    # (knob, extra env, flags, the routes logged)
    ("auto", {}, ["-k", "23", "-K", "-s"], ["host"]),
    ("auto", {"UNIKMER_TPU_HOST_COUNT_MAX_MB": "0.001"},
     ["-k", "23", "-K", "-s"], ["device"]),
    ("1", {"UNIKMER_TPU_HOST_COUNT_MAX_BASES": "100"},
     ["-k", "23", "-K", "-s"], ["device"]),
    ("1", {"UNIKMER_TPU_HOST_COUNT_MAX_BASES": "100"},
     ["-k", "23", "-K", "-l"], ["device"]),
    ("1", {"UNIKMER_TPU_HOST_COUNT_MAX_BASES": "100"},
     ["-k", "15", "-K", "-s", *T], ["host", "device"]),
    # past the sketch kernels' cap (a quarter of it), inside the other
    ("1", {"UNIKMER_TPU_HOST_COUNT_MAX_BASES": "40000"},
     ["-k", "31", "-W", "15", "-s"], ["host", "device"]),
    ("0", {}, ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s"],
     ["host"]),
    ("1", {}, ["-k", "21", "-W", "5", "-s", *T], ["device"]),
    ("1", {}, ["-k", "23", "-K", "-s", "--mesh", "1"], ["device"]),
    ("1", {}, ["-k", "15", "-K", "-s", *T, "--mesh", "1"], ["device"]),
    ("1", {}, ["-k", "23", "-K", "-l", "--mesh", "1"], ["host"]),
    ("1", {"UNIKMER_TPU_NO_NATIVE": "1"}, ["-k", "23", "-K", "-s"],
     ["device"]),
    ("1", {"UNIKMER_TPU_NO_NATIVE": "1"}, ["-k", "31", "-K", "-H", "-l"],
     ["device"]),
    ("1", {"UNIKMER_TPU_NO_NATIVE": "1"}, ["-k", "15", "-K", "-s", *T],
     ["device"]),
    ("1", {"UNIKMER_TPU_NO_NATIVE": "1"},
     ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s"],
     ["host", "device"]),
]


@pytest.mark.parametrize("knob,env,flags,want", ROUTE_CASES,
                         ids=lambda v: " ".join(v) if isinstance(v, list)
                         else repr(v))
def test_cli_takes_the_jax_clis_route(fastas, tmp_path, monkeypatch, caplog,
                                      knob, env, flags, want):
    """The route the port logs under -V, and the JAX CLI's bytes (its
    device path): caps past which the host engine declines fall through
    to the device, --mesh comes first (but not with -l), the compat
    syncmer prefers its host kernel at any knob, -T with a sketch never
    takes the host, and UNIKMER_TPU_NO_NATIVE=1 sends every config to
    the device."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    jax_flags = [f for f in flags if f not in ("--mesh", "1")]
    assert jax_main(["count", *jax_flags, "-C", *fastas, "-o",
                     str(tmp_path / "jax")]) == 0
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", knob)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    routes = run_port(["count", *flags, "-V", "-C", *fastas, "-o",
                       str(tmp_path / "port")], caplog)
    assert routes == [f"count: the {r} route" for r in want]
    assert ((tmp_path / "port.unik").read_bytes()
            == (tmp_path / "jax.unik").read_bytes())


def test_stdin_streams_on_the_device_under_auto(fastas, tmp_path,
                                                monkeypatch, caplog):
    """stdin's size is unknown: auto keeps it on the device, 1 takes the
    host (as the JAX routing does)."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    data = Path(fastas[0]).read_bytes()
    outs = []
    for knob, want in (("auto", "device"), ("1", "host")):
        monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", knob)
        monkeypatch.setattr("sys.stdin",
                            argparse.Namespace(buffer=io.BytesIO(data)))
        out = tmp_path / knob
        assert run_port(["count", "-k", "23", "-K", "-s", "-V", "-C", "-o",
                         str(out)], caplog) == [f"count: the {want} route"]
        outs.append((tmp_path / f"{knob}.unik").read_bytes())
    assert outs[0] == outs[1]
