"""The port's start-up path on the CPU: the host-only commands, a
host-routed ``count``, a small taxid ``union`` and the package root's
host exports run without importing torch (each in a fresh
interpreter), the one-command parser answers as the full one does, and
the profiler knobs write their files (UNIKMER_TPU_CPROFILE a cProfile
dump, UNIKMER_TPU_PROFILE a torch.profiler Chrome trace).
"""

import json
import os
import pstats
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from unikmer_tpu_torch.cli import commands
from unikmer_tpu_torch.cli.main import build_parser, main as port_main

REPO = Path(__file__).resolve().parents[1]
TAXDUMP = str(REPO / "tests" / "data" / "taxdump")
RE = ["-r", r"taxid\|(\d+)"]

# each runs in a fresh interpreter, which must end without torch loaded
# ({a}, {b}, ... name the inputs, {out} the test's directory)
HOST_ONLY = {
    "view": ["view", "{a}"],
    "dump": ["dump", "-K", "-s", "{k21}", "-C", "-o", "{out}/d"],
    "info": ["info", "-a", "{a}", "{b}"],
    "num": ["num", "{a}"],
    "encode": ["encode", "-a", "{k21}"],
    "decode": ["decode", "-k", "21", "{codes}"],
    "concat": ["concat", "-C", "{a}", "{b}", "-o", "{out}/c"],
    "sort": ["sort", "-u", "{a}", "{b}", "-C", "-o", "{out}/s"],
    "split": ["split", "-m", "1000", "{a}", "{b}", "-O", "{out}/parts",
              "-C"],
    "merge": ["merge", "{a}", "{b}", "-C", "-o", "{out}/m"],
    "tsplit": ["tsplit", "{t}", "-O", "{out}/t", "-C"],
    "head": ["head", "-n", "100", "{a}", "-C", "-o", "{out}/h"],
    "sample": ["sample", "-s", "3", "-w", "7", "{a}", "-C", "-o", "{out}/p"],
    "rfilter": ["rfilter", "-E", "species", "--data-dir", "{taxdump}", "{t}",
                "-C", "-o", "{out}/r"],
    "version": ["version"],
    "autocompletion": ["autocompletion", "--file", "{out}/ac.sh"],
    "grep": ["grep", "-F", "{b}", "{a}", "-C", "-o", "{out}/g"],
}
HOST_COUNT = ["count", "-k", "23", "-K", "-s", "-C", "{fa}", "-o", "{out}/k"]

PROBE = """
import sys
from unikmer_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
print(rc, "torch" in sys.modules)
"""


def write_fasta(path: Path, rng, taxids) -> None:
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for i, t in enumerate(taxids):
            seq = lut[rng.choice(5, size=2500, p=[0.245] * 4 + [0.02])]
            f.write(f">r{i} taxid|{t}\n{seq.tobytes().decode()}\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("startup")
    rng = np.random.default_rng(16)
    write_fasta(d / "a.fa", rng, [562, 511145])
    write_fasta(d / "b.fa", rng, [585057, 9606])
    taxdump = d / "taxdump"
    shutil.copytree(TAXDUMP, taxdump)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
        for name, extra in (("a", []), ("b", []),
                            ("t", ["-T", *RE, "--data-dir", str(taxdump)])):
            fa = d / f"{'b' if name == 'b' else 'a'}.fa"
            assert port_main(["count", "-k", "21", "-K", "-s", "-C", *extra,
                              str(fa), "-o", str(d / name)]) == 0
        assert port_main(["view", str(d / "a.unik"), "-o",
                          str(d / "k21.txt")]) == 0
    kmers = (d / "k21.txt").read_text().split()[:200]
    (d / "k21.txt").write_text("\n".join(kmers) + "\n")
    codes = rng.integers(0, 1 << 42, size=50, dtype=np.uint64)
    (d / "codes.txt").write_text("".join(f"{c}\n" for c in codes))
    return {"a": str(d / "a.unik"), "b": str(d / "b.unik"),
            "t": str(d / "t.unik"), "k21": str(d / "k21.txt"),
            "codes": str(d / "codes.txt"), "fa": str(d / "a.fa"),
            "taxdump": str(taxdump)}


def run_fresh(argv, inputs, out: Path, env=None):
    """Run the port's main() on ``argv`` in a fresh interpreter; returns
    (its exit code, whether torch was imported)."""
    argv = [a.format(out=out, **inputs) for a in argv]
    full = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    full.pop("UNIKMER_TPU_SERVER", None)
    res = subprocess.run([sys.executable, "-c", PROBE, *argv], cwd=out,
                         env=full, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1].split()
    return int(last[0]), last[1] == "True", res.stderr


@pytest.mark.parametrize("name", sorted(HOST_ONLY))
def test_host_only_command_does_not_import_torch(inputs, tmp_path, name):
    rc, imported, err = run_fresh(HOST_ONLY[name], inputs, tmp_path)
    assert rc == 0, err
    assert not imported, f"{name} imported torch"


def test_host_routed_count_does_not_import_torch(inputs, tmp_path):
    rc, imported, err = run_fresh(HOST_COUNT, inputs, tmp_path,
                                  {"UNIKMER_TPU_HOST_COUNT": "1",
                                   "UNIKMER_TPU_TORCH_DEVICE": "cpu"})
    assert rc == 0, err
    assert not imported
    rc, imported, err = run_fresh(HOST_COUNT, inputs, tmp_path,
                                  {"UNIKMER_TPU_HOST_COUNT": "0",
                                   "UNIKMER_TPU_TORCH_DEVICE": "cpu"})
    assert rc == 0, err
    assert imported  # the device route's plain versions run on torch


HOST_EXPORTS = ("UnikReader", "UnikWriter", "load_taxonomy", "pack_files",
                "pack_records", "read_fastx", "UNIK_MAIN_VERSION",
                "UNIK_MINOR_VERSION")


def test_host_root_exports_do_not_import_torch():
    """The package root's exports that do no device work load without
    torch; CountConfig (models/count) brings it in."""
    code = ("import sys, unikmer_tpu_torch as u\n"
            f"for name in {HOST_EXPORTS!r}:\n"
            "    getattr(u, name)\n"
            "print('torch' in sys.modules)\n"
            "u.CountConfig\n"
            "print('torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "True"]


@pytest.mark.parametrize("knob,imported", [("auto", False), ("0", False),
                                           ("1", True)])
def test_small_taxid_union_routes_before_torch(inputs, tmp_path, knob,
                                               imported):
    """``union`` of two small taxid files: under auto (below
    UNIKMER_TPU_DEVICE_TAXID_MIN_MB) and 0 the host engine, without
    torch; under 1 the device route (its plain versions here)."""
    argv = ["union", "-s", "-C", "--data-dir", "{taxdump}", "{t}", "{t}",
            "-o", f"{{out}}/u{knob}"]
    rc, got, err = run_fresh(argv, inputs, tmp_path,
                             {"UNIKMER_TPU_DEVICE_TAXID": knob,
                              "UNIKMER_TPU_TORCH_DEVICE": "cpu"})
    assert rc == 0, err
    assert got == imported


def help_of(parser, argv, capsys) -> tuple:
    with pytest.raises(SystemExit) as e:
        parser.parse_args(argv)
    out = capsys.readouterr()
    return e.value.code, out.out, out.err


@pytest.mark.parametrize("name", commands.COMMANDS)
def test_one_command_parser_gives_the_full_parsers_help(name, capsys):
    full = help_of(build_parser(), [name, "-h"], capsys)
    assert help_of(build_parser(only=name), [name, "-h"], capsys) == full
    assert full[0] == 0 and name in full[1]


def test_command_list_and_unknown_command_keep_the_full_parser(capsys):
    full = build_parser()
    assert help_of(full, ["-h"], capsys)[1] == full.format_help()
    assert port_main([]) == 0
    listing = capsys.readouterr().out
    assert listing == full.format_help()
    assert all(c in listing for c in commands.COMMANDS)
    want = help_of(full, ["nosuch"], capsys)
    with pytest.raises(SystemExit) as e:
        port_main(["nosuch"])
    assert (e.value.code, *capsys.readouterr()) == want
    assert want[0] == 2 and "invalid choice" in want[2]


def test_aliases_take_the_one_command_parser(inputs, capsys):
    assert port_main(["stats", inputs["a"]]) == 0
    stats = capsys.readouterr().out
    assert port_main(["info", inputs["a"]]) == 0
    assert capsys.readouterr().out == stats


def test_cprofile_knob_writes_a_pstats_file(inputs, tmp_path, monkeypatch,
                                            capsys):
    dump = tmp_path / "num.prof"
    monkeypatch.setenv("UNIKMER_TPU_CPROFILE", str(dump))
    assert port_main(["num", inputs["a"]]) == 0
    stats = pstats.Stats(str(dump))
    assert stats.total_calls > 0
    assert any(fn[2] == "run" and fn[0].endswith("num.py")
               for fn in stats.stats)


def test_profile_knob_writes_a_chrome_trace(inputs, tmp_path, monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_PROFILE", str(tmp_path / "trace"))
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", inputs["fa"],
                      "-o", str(tmp_path / "k")]) == 0
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(ev.get("name", "").startswith("aten::") for ev in events)


def test_chip_smoke_startup_path_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke's start-up phase small on the CPU: the kernels' plain
    versions stand in for the card (they count no launch), torch's CPU
    operators for K1's and K2's kernels in the trace."""
    import torch

    import chip_smoke

    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    monkeypatch.setattr(chip_smoke, "STARTUP_BASES", (1 << 18, 1 << 19))
    monkeypatch.setattr(chip_smoke, "RECORD_BASES", 1 << 18)
    monkeypatch.setattr(chip_smoke, "KERNEL_EVENT", "cpu_op")
    monkeypatch.setattr(chip_smoke, "K1_KERNEL", "aten::")
    monkeypatch.setattr(chip_smoke, "K2_KERNEL", "aten::sort")
    monkeypatch.setattr(chip_smoke, "STARTUP_NEED", ())
    rng = np.random.default_rng(5)
    fa = str(tmp_path / "in.fa")
    chip_smoke.write_fasta(fa, rng, 4, chip_smoke.RECORD_BASES)
    k23 = str(tmp_path / "k23.unik")
    chip_smoke.oracle_unik(fa, k23, 23, True, "distinct")
    row = chip_smoke.startup_path(str(tmp_path), rng, {"fa": fa, "k23": k23},
                                  torch.device("cpu"), "cpu")
    assert set(row["host_only"]) == {"num", "info", "view 0.5 Mbp"}
    assert [(len(r["host_s"]), len(r["device_s"]))
            for r in row["count"].values()] == [(2, 1), (2, 1), (2, 1)]
    assert row["server"]["exit"] == 0
    knob = "UNIKMER_TPU_HOST_COUNT"
    assert set(row["server"]["requests"]) == {
        f"count 134 Mbp {knob}=0", f"count 134 Mbp {knob}=auto",
        f"count 134 Mbp {knob}=1", f"count 0.5 Mbp {knob}=0",
        f"count 0.5 Mbp {knob}=1", "union", "view 0.5 Mbp"}
    assert min(row["profile"]["kernel_events"].values()) > 0
    assert set(row["launches"]) == {"k1", "h1", "s1", "k2", "k3"}
