"""The port's CLI against ``unikmer_tpu.cli.main``: the same ``count``
arguments give byte-identical ``.unik`` files (-C: no gzip mtime).  The
JAX side runs its device path on the CPU (UNIKMER_TPU_HOST_COUNT=0), the
port its plain kernels (UNIKMER_TPU_TORCH_DEVICE=cpu)."""

import numpy as np
import pytest

from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu_torch.cli.main import main as port_main


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("fa")
    rng = np.random.default_rng(20261016)
    paths = []
    for f in range(2):
        lines = []
        for r in range(3):
            n = int(rng.integers(50, 40000))
            seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=n,
                             p=[.24, .24, .24, .24, .01, .01, .01, .005, .005])
            if r == 0:
                seq[100:200] = ord("T")
                seq[-300:] = seq[:300]
            s = seq.tobytes().decode()
            lines.append(f">f{f}r{r} sample{r}")
            lines += [s[i:i + 70] for i in range(0, len(s), 70)]
        p = d / f"in{f}.fa"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


@pytest.fixture
def envs(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    # a taxid union of these small files takes the device route only
    # when asked (auto takes it from 32 MB of input)
    monkeypatch.setenv("UNIKMER_TPU_DEVICE_TAXID", "1")
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


CASES = [
    ["-k", "23", "-K", "-s"],
    ["-k", "23", "-K", "-s", "-u"],
    ["-k", "21", "-K", "-s", "-d", "--circular"],
    ["-k", "32", "-s", "-t", "9606"],
    ["-k", "5", "-K", "-c"],
    ["-k", "17", "-s", "-B", "r1"],
    # hashed (ntHash): -H, k > 32, scaled, -T with a small nodes.dmp, -l
    ["-k", "21", "-H", "-s"],
    ["-k", "40", "-u"],
    ["-k", "21", "-K", "-D", "8", "-s"],
    ["-k", "21", "-K", "-s", "-T", "-r", r"sample(\d+)", "--data-dir",
     "tests/data/taxdump", "-H"],
    ["-k", "21", "-l", "-H"],
]


@pytest.mark.parametrize("flags", CASES, ids=lambda f: " ".join(f))
def test_count_bytes_match_jax_cli(fastas, envs, tmp_path, flags):
    inputs = fastas if "-c" not in flags else fastas[:1]
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
        assert main(["count", *flags, "-C", *inputs, "-o", prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 40
    assert outs["port"] == outs["jax"]


@pytest.fixture(scope="module")
def sketch_fastas(tmp_path_factory):
    """Two files of records up to 12 kb (one shorter than k, one holding
    a repeat), headers ``sample<taxid>``."""
    d = tmp_path_factory.mktemp("sk")
    rng = np.random.default_rng(20261017)
    paths = []
    for f in range(2):
        lines = []
        for r, n in enumerate((12000, 20, 3000, 9000)):
            seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=n,
                             p=[.24, .24, .24, .24, .01, .01, .01, .005, .005])
            if n > 5000:
                seq[-2000:] = seq[:2000]
            lines.append(f">f{f}r{r} sample{r}")
            s = seq.tobytes().decode()
            lines += [s[i:i + 60] for i in range(0, len(s), 60)]
        p = d / f"sk{f}.fa"
        p.write_text("\n".join(lines) + "\n")
        paths.append(str(p))
    return paths


TS = ["-T", "-r", r"sample(\d+)", "--data-dir", "tests/data/taxdump"]
SKETCH_CASES = [
    ["-k", "31", "-W", "15", "-s"],
    ["-k", "31", "-S", "16", "-s"],
    ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s"],
    ["-k", "21", "-W", "5", "-D", "4", "-s"],
    ["-k", "21", "-W", "5", "-u", "-s"],
    ["-k", "21", "-S", "9", "-d", "-s"],
    ["-k", "21", "-W", "5", "--circular", "-s"],
    ["-k", "23", "-W", "5", "-l"],
    ["-k", "21", "-W", "5", "-s", *TS],
    ["-k", "21", "-S", "9", "--syncmer-impl", "compat", "-s", *TS],
]


@pytest.mark.parametrize("flags", SKETCH_CASES, ids=" ".join)
def test_sketch_count_bytes_match_jax_cli(sketch_fastas, envs, tmp_path,
                                          monkeypatch, flags):
    """The sketches with each flag they combine with: the same .unik
    bytes as the JAX CLI (its compat runs may take its host engine; the
    JAX tests hold that engine to its device twin).  The port's compat
    syncmer prefers its host kernel whatever UNIKMER_TPU_HOST_COUNT says:
    UNIKMER_TPU_NO_NATIVE=1 sends it to the device twin."""
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
        with monkeypatch.context() as mp:
            if name == "port" and "compat" in flags:
                mp.setenv("UNIKMER_TPU_NO_NATIVE", "1")
            assert main(["count", *flags, "-C", *sketch_fastas, "-o",
                         prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 400
    assert outs["port"] == outs["jax"]


def test_sketch_without_k_flag_writes_canonical(sketch_fastas, envs,
                                                tmp_path):
    """``count -k 21 -W 5`` without -K: the sketch switches -K on, so the
    header says CANONICAL (as the JAX CLI writes it)."""
    from unikmer_tpu_torch.io import unik

    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
        assert main(["count", "-k", "21", "-W", "5", "-C", sketch_fastas[0],
                     "-o", prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    flag = unik.UnikReader(str(tmp_path / "port.unik")).header.flag
    assert flag & unik.CANONICAL and flag & unik.HASHED
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("flags", [
    ["-k", "21", "-K", "-s", "--mesh", "2"],
    ["-k", "21", "-K", "-s", "-T", "-r", r"sample(\d+)", "--data-dir",
     "tests/data/taxdump", "--mesh", "2"],
], ids=" ".join)
def test_unported_flags_exit_naming_roadmap(fastas, envs, tmp_path,
                                            monkeypatch, flags):
    """--mesh 2, which exited naming ROADMAP.md until the port had it
    (hence the name): the JAX CLI's --mesh bytes, over 2 of the 8 CPU
    devices that tests/conftest.py gives JAX."""
    from unikmer_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "device_count", lambda: 8)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
        assert main(["count", *flags, "-C", fastas[0], "-o", prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 1000 and outs["port"] == outs["jax"]


def test_cuda_requested_without_card_exits(fastas, monkeypatch, tmp_path,
                                           caplog):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cuda")
    rc = port_main(["count", "-k", "21", fastas[0], "-o", str(tmp_path / "x")])
    assert rc != 0 and "is_available" in caplog.text


def test_unique_and_repeated_conflict(fastas, envs, tmp_path):
    assert port_main(["count", "-k", "21", "-u", "-d", fastas[0],
                      "-o", str(tmp_path / "x")]) != 0


def _records(caplog, logger):
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == logger]


@pytest.mark.parametrize("flags", [
    ["-k", "70"],  # hashed by k > 32, then past 64
    ["-k", "70", "-H"],
    ["-k", "21", "-D", str(1 << 32)],
    ["-k", "21", "-W", "5", "-S", "5"],
    ["-k", "21", "--syncmer-impl", "compat"],
    ["-k", "21", "-H", "-u", "-d"],
    ["-k", "21", "-W", "5", "-l", "-s"],
    ["-k", "21", "--mesh", "2", "-u", "-d"],
    ["-k", "21", "-H", "-T", "-t", "5", "-r", r"(\d+)"],
    ["-k", "21", "-H", "-T"],
    ["-k", "21", "-S", "9", "-T", "-r", "abc"],
], ids=lambda f: " ".join(f))
def test_refused_flags_match_jax_cli(fastas, envs, tmp_path, caplog, flags):
    """Flag combinations that the reference refuses, each with a flag the
    port does not run yet: the same warnings and error line, the same exit
    code, no output."""
    got = {}
    for name, main, logger in (("jax", jax_main, "unikmer_tpu"),
                               ("port", port_main, "unikmer_tpu_torch")):
        caplog.clear()
        rc = main(["count", *flags, fastas[0], "-o", str(tmp_path / name)])
        got[name] = (rc, _records(caplog, logger))
        assert not (tmp_path / f"{name}.unik").exists()
    assert got["port"] == got["jax"]
    assert got["jax"][0] == 255 and got["jax"][1][-1][0] == "ERROR"


# ---------------------------------------------------------------------
# the set operations: union, inter, diff, common

TAXDUMP_FLAGS = ["--data-dir", "tests/data/taxdump"]


@pytest.fixture(scope="module")
def uniks(fastas, tmp_path_factory):
    """.unik inputs written by the port's count: sorted sets without
    taxids (n0-n2), with global taxids (t0-t2, and tu with a taxid the
    taxdump lacks), with per-record taxids (r0, r1), an unsorted set
    (u0) and a k = 25 set (k25)."""
    import os

    d = tmp_path_factory.mktemp("uniks")
    old = os.environ.get("UNIKMER_TPU_TORCH_DEVICE")
    os.environ["UNIKMER_TPU_TORCH_DEVICE"] = "cpu"
    rng = np.random.default_rng(20261018)
    seqs = []
    base = rng.choice(list(b"ACGT"), size=30000).astype(np.uint8)
    for i in range(3):
        s = base.copy()
        s[rng.integers(0, len(s), 400)] = rng.choice(list(b"ACGT"), 400)
        seqs.append(np.concatenate([s[i * 5000: 20000 + i * 3000], rng.choice(
            list(b"ACGT"), size=4000).astype(np.uint8)]).tobytes())
    out = {}
    try:
        for i, s in enumerate(seqs):
            fa = d / f"s{i}.fa"
            fa.write_bytes(b">a sample%d\n%s\n>b sample2\n%s\n"
                           % (i, s[:15000], s[15000:]))
            for name, flags in ((f"n{i}", ["-s"]),
                                (f"t{i}", ["-s", "-t", str(
                                    (511145, 585057, 562)[i])]),
                                (f"r{i}", ["-s", "-T", "-r", r"sample(\d+)",
                                           *TAXDUMP_FLAGS]),
                                (f"u{i}", []), (f"k{i}", ["-s", "-k", "25"]),
                                (f"x{i}", ["-s", "-t", "999999"])):
                k = [] if "-k" in flags else ["-k", "21"]
                assert port_main(["count", *k, "-K", "-C", *flags, str(fa),
                                  "-o", str(d / name)]) == 0
                out[name] = str(d / f"{name}.unik")
    finally:
        if old is None:
            del os.environ["UNIKMER_TPU_TORCH_DEVICE"]
        else:
            os.environ["UNIKMER_TPU_TORCH_DEVICE"] = old
    out["tu"], out["k25"] = out["x0"], out["k0"]
    return out


SETOP_CASES = [
    ["union", "-s", "n0", "n1", "n2"],
    ["union", "n0", "n1"],
    ["union", "-c", "n0", "n1"],
    ["union", "-s", "t0", "t1", "t2"],  # the device taxid union
    ["union", "t0", "t1", "t2"],
    ["union", "-s", "r0", "r1", "t2"],
    ["union", "-s", "t0", "tu"],  # an unknown taxid: the host engine
    ["union", "-s", "t0"],
    ["union", "n0", "t1"],  # taxids in one file only: refused
    ["union", "n0", "k25"],  # incompatible k
    ["union", "-I", "-s", "t0", "n1"],
    ["inter", "n0", "n1", "n2"],
    ["inter", "t0", "t1", "t2"],
    ["inter", "r0", "r1"],
    ["inter", "-m", "t0", "n1", "r2"],
    ["inter", "t0", "n1"],  # refused without --mix-taxid
    ["inter", "u0", "n1"],  # unsorted input: refused
    ["inter", "n0", "k25"],
    ["inter", "--skip-flag-check", "n0", "k25"],
    ["diff", "-s", "n0", "n1", "n2"],
    ["diff", "n0", "u1"],  # unsorted targets are sorted
    ["diff", "-s", "t0", "t1"],
    ["diff", "-s", "-t", "r0", "r1", "r2"],
    ["diff", "-t", "t0", "t2"],
    ["diff", "-s", "-t", "t0", "n1"],  # --compare-taxid: refused
    ["diff", "u0", "n1"],  # the first file must be sorted
    ["diff", "n0", "k25"],
    ["common", "-n", "2", "n0", "n1", "n2"],
    ["common", "n0", "n1", "n2"],
    ["common", "-p", "0.5", "n0", "n1", "n2"],
    ["common", "-n", "2", "t0", "t1", "t2"],
    ["common", "-n", "2", "u0", "n1", "r2", "-m"],
    ["common", "-n", "4", "r0", "r1", "r2"],
    ["common", "-p", "1.5", "n0", "n1"],  # a proportion past 1: refused
    ["common", "n0", "k25"],
]


@pytest.mark.parametrize("argv", SETOP_CASES, ids=" ".join)
def test_setop_bytes_match_jax_cli(uniks, envs, tmp_path, caplog, argv):
    """Each set operation, with and without taxids: the same .unik bytes
    (or the same error line and exit code, and no output) as the JAX
    CLI."""
    args = [uniks.get(a, a) for a in argv]
    got = {}
    for name, main, logger in (("jax", jax_main, "unikmer_tpu"),
                               ("port", port_main, "unikmer_tpu_torch")):
        caplog.clear()
        out = tmp_path / f"{name}.unik"
        rc = main([*args, "-C", *TAXDUMP_FLAGS, "-o", str(tmp_path / name)])
        errors = [m for lvl, m in _records(caplog, logger) if lvl == "ERROR"]
        got[name] = (rc, errors, out.read_bytes() if out.exists() else None)
    assert got["port"] == got["jax"]
    if got["jax"][0] == 0:  # only common -n 4 of 3 files is empty
        empty = argv[:3] == ["common", "-n", "4"]
        assert len(got["jax"][2]) >= (34 if empty else 41)
    else:
        assert got["jax"][0] == 255 and got["jax"][2] is None


@pytest.mark.parametrize("cmd", ["union", "inter", "diff", "common"])
def test_setop_mesh_exits_naming_roadmap(uniks, envs, tmp_path, monkeypatch,
                                         cmd):
    """--mesh 2, which exited naming ROADMAP.md until the port had it
    (hence the name): the JAX CLI's --mesh bytes, over 2 of the 8 CPU
    devices that tests/conftest.py gives JAX."""
    from unikmer_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "device_count", lambda: 8)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        assert main([cmd, "--mesh", "2", "-C", uniks["n0"], uniks["n1"],
                     "-o", str(tmp_path / name)]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 1000 and outs["port"] == outs["jax"]


def test_setop_reads_stdin_and_gzip(uniks, envs, tmp_path, monkeypatch):
    """A gzipped (UK-indexed) input and stdin ("-") read as the JAX CLI
    reads them."""
    import io
    import sys

    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        gz = str(tmp_path / f"{name}gz")
        assert main(["union", "-s", uniks["n0"], uniks["n1"], "-o", gz]) == 0
        with open(uniks["n2"], "rb") as f:
            monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(
                io.BufferedReader(io.BytesIO(f.read()))))
        prefix = str(tmp_path / name)
        assert main(["inter", gz + ".unik", "-", "-C", "-o", prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 40 and outs["port"] == outs["jax"]


@pytest.mark.parametrize("inputs,device", [(["t0", "t1", "t2"], True),
                                          (["r0", "r1"], True),
                                          (["t0", "tu"], False)])
def test_union_takes_the_device_taxid_route(uniks, envs, tmp_path,
                                            monkeypatch, inputs, device):
    """Inputs with taxids go through union_taxids_device; only an
    unknown nonzero taxid sends them on to the host engine."""
    from unikmer_tpu_torch.ops import device_sets

    seen = []
    real = device_sets.union_taxids_device

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(device_sets, "union_taxids_device", spy)
    assert port_main(["union", "-s", "-C", *TAXDUMP_FLAGS,
                      *[uniks[i] for i in inputs],
                      "-o", str(tmp_path / "u")]) == 0
    assert len(seen) == 1 and (seen[0] is not None) == device


@pytest.mark.parametrize("inputs", [["t0", "t1", "t2"], ["r0", "r1"]])
def test_union_past_the_budget_takes_the_host_engine(uniks, envs, tmp_path,
                                                     monkeypatch, inputs):
    """With the device's free bytes made small, union_taxids_device
    declines (None) and the host engine writes the JAX CLI's bytes."""
    from unikmer_tpu_torch.ops import device_sets

    seen = []
    real = device_sets.union_taxids_device

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(device_sets, "union_taxids_device", spy)
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 16)
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        assert main(["union", "-s", "-C", *TAXDUMP_FLAGS,
                     *[uniks[i] for i in inputs],
                     "-o", str(tmp_path / name)]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert seen == [None]
    assert len(outs["port"]) > 1000 and outs["port"] == outs["jax"]


def test_every_jax_command_but_locate_and_map_is_registered():
    """The port's parser takes every subcommand of the JAX CLI, locate
    and map among them, and the aliases stats and uniqs, in the JAX
    order.  (The name is the test's from before locate and map were
    ported.)"""
    from unikmer_tpu.cli import commands as jax_commands
    from unikmer_tpu_torch.cli import commands
    from unikmer_tpu_torch.cli.main import build_parser

    sub = next(a for a in build_parser()._actions
               if a.dest == "command").choices
    assert set(sub) == set(jax_commands.COMMANDS) | {"stats", "uniqs"}
    assert commands.COMMANDS == jax_commands.COMMANDS
    assert len(commands.COMMANDS) == 25


@pytest.mark.parametrize("check_update", [False, True])
def test_version_matches_jax_cli(capsys, check_update):
    flags = ["-u"] if check_update else []
    assert jax_main(["version", *flags]) == 0
    want = capsys.readouterr().out
    assert port_main(["version", *flags]) == 0
    got = capsys.readouterr().out
    assert got == want.replace("unikmer-tpu v", "unikmer-tpu-torch v")
    assert got.startswith("unikmer-tpu-torch v") and (
        ("no network" in got) == check_update)


@pytest.mark.parametrize("shell", ["bash", "zsh", "fish", "powershell"])
def test_autocompletion_matches_jax_cli(tmp_path, caplog, monkeypatch,
                                        shell):
    """The JAX command's script and log line, over the port's commands
    (the JAX list) plus stats and uniqs, with the port's program name;
    powershell exits as in the JAX command."""
    from unikmer_tpu.cli.commands import autocompletion as jax_autocompletion
    from unikmer_tpu_torch.cli.commands import COMMANDS

    monkeypatch.setattr(jax_autocompletion, "COMMANDS", COMMANDS)
    got = {}
    for side, main in (("jax", jax_main), ("port", port_main)):
        path = tmp_path / side / "c.sh"
        caplog.clear()
        rc = main(["autocompletion", "--type", shell, "--file", str(path)])
        text = path.read_text() if path.exists() else ""
        msg = caplog.records[-1].getMessage().replace(str(path), "F")
        if side == "jax":
            text, msg = (x.replace("unikmer-tpu", "unikmer-tpu-torch").replace(
                "_unikmer_tpu_", "_unikmer_tpu_torch_") for x in (text, msg))
        got[side] = (rc, text, msg)
    assert got["port"] == got["jax"]
    rc, text, _ = got["port"]
    assert (rc == 0) == (shell != "powershell")
    if rc == 0:
        assert " stats" in text and " uniqs" in text and " locate" in text
