"""The port's CLI against ``unikmer_tpu.cli.main``: the same ``count``
arguments give byte-identical ``.unik`` files (-C: no gzip mtime).  The
JAX side runs its device path on the CPU (UNIKMER_TPU_HOST_COUNT=0), the
port its plain kernels (UNIKMER_TPU_TORCH_DEVICE=cpu)."""

import numpy as np
import pytest

from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu_torch.cli.main import main as port_main


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
                                          flags):
    """The sketches with each flag they combine with: the same .unik
    bytes as the JAX CLI (its compat runs may take its host engine; the
    JAX tests hold that engine to its device twin)."""
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
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


@pytest.mark.parametrize("flags,item", [
    (["-k", "21", "--mesh", "2"], "item 9"),
    (["-k", "21", "-T", "-r", r"(\d+)", "--mesh", "2"], "item 9"),
])
def test_unported_flags_exit_naming_roadmap(fastas, envs, tmp_path, caplog,
                                            flags, item):
    rc = port_main(["count", *flags, fastas[0], "-o", str(tmp_path / "x")])
    assert rc != 0
    assert item in caplog.text and "ROADMAP" in caplog.text
    assert not (tmp_path / "x.unik").exists()


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
