"""Whole runs of the harness on the CPU at a small size: the cell comes
out correct, so does the hashed configuration under the same mix, the last line holds its required keys, a fault planted in
the program turns ``correct`` false, and a cell made of added files
runs.  The look for a card (run.main) is skipped: run_cell drives the
rest of a run on the port's plain versions."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, SMALL, SMALL_MIX
from portbench import cell as harness
from portbench import run as entry

CELLS = sorted(SMALL_MIX)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small_run(workload, seed=20240, seconds=1.5, traced=False, root=ROOT,
              mix_keys=None):
    return harness.run_cell(workload, seed, seconds, traced, root, threads=2,
                            sizes=SMALL,
                            mix_keys=mix_keys or SMALL_MIX.get(workload))


def copy_of_harness(tmp_path) -> dict:
    """BENCHMARK.json and portbench/ copied under ``tmp_path``; returns
    the benchmark for the caller to add entries to."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def add_cell(bench, name, config, traffic):
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": name})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(name)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_dry_and_correct(on_cpu, workload):
    r = small_run(workload)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setop_kmers_per_s", "setop_p95_ms",
                                 "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert all(c["limit"] == 0 for c in r["checks"].values())


def test_traced_run_reports_per_layer_metrics(on_cpu):
    r = small_run("pangenome-k23.merge", traced=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: only the host's spans and the counter read
    assert set(r["metrics"]) == {"setup.init_s", "setup.count_s",
                                 "k2.launches_per_op"}
    assert r["correct"] is True


def test_last_line_and_checks_on_stderr(on_cpu, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    run_cell = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda w, seed, s, t, *rest: (
        run_cell(w, seed, s, t, ROOT, threads=2, sizes=SMALL,
                 mix_keys=SMALL_MIX[w])))
    assert entry.main(["--workload", "pangenome-k23.merge", "--seed",
                       str(2**31 + 7), "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == KEYS + ["checks"]
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert tail == [f"check {n} {c['value']} limit {c['limit']}"
                    for n, c in last["checks"].items()]
    assert "requests in" in out  # the request count, on an earlier line


def test_no_card_no_result(tmp_path):
    """Without a card, and in a directory that holds only BENCHMARK.json
    and portbench/, run.py exits non-zero and prints nothing."""
    for where in (ROOT, tmp_path):
        if where == tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "pangenome-k23.merge", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0 and p.stdout == ""


def _patch(monkeypatch, name, fn):
    from unikmer_tpu_torch.api import KmerSet

    monkeypatch.setattr(KmerSet, name, fn)


def _first_member_altered(s):
    from unikmer_tpu_torch.api import KmerSet

    c = s._codes.clone()
    c[0] ^= 1
    return KmerSet(c, len(s), s.k, **s._flags_kw())


def _half_kept(s):
    """The set with its second half of members left out."""
    return s.head(len(s) // 2)


FAULTS = {
    # a step that returns its state unchanged
    ("pangenome-k23.merge", "unchanged"):
        ("union_all", lambda orig: staticmethod(lambda sets: list(sets)[0])),
    # half of the batch left out: the union over half of its sets
    ("pangenome-k23.merge", "half"):
        ("union_all", lambda orig: staticmethod(
            lambda sets: orig(list(sets)[: max(1, len(list(sets)) // 2)]))),
    # an answer altered where it is produced
    ("pangenome-k23.merge", "altered"):
        ("intersect", lambda orig: lambda a, b: _first_member_altered(
            orig(a, b))),
    ("pangenome-k23.merge", "subtract unchanged"):
        ("subtract", lambda orig: lambda a, b: a),
    ("pangenome-k23.merge", "subtract half"):
        ("subtract", lambda orig: lambda a, b: orig(_half_kept(a), b)),
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(on_cpu, monkeypatch, workload, fault):
    from unikmer_tpu_torch.api import KmerSet

    name, make = FAULTS[(workload, fault)]
    _patch(monkeypatch, name, make(getattr(KmerSet, name)))
    r = small_run(workload, seed=31337)
    assert r["correct"] is False
    assert r["checks"]["answers_wrong"]["value"] > 0


def test_a_cell_of_added_files_runs(on_cpu, tmp_path):
    """A configuration, a mix, a per-layer metric and a cell, each added
    as a file and an entry, with no file of the harness edited."""
    bench = copy_of_harness(tmp_path)
    cfg = json.loads(
        (ROOT / "portbench/configs/pangenome-k23.json").read_text())
    cfg.update(name="pangenome-k15", k=15, code_bits=30)
    (tmp_path / "portbench/configs/pangenome-k15.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/pairs.json").write_text(json.dumps({
        "loop": "closed", "clients": 1,
        "deck": [{"kind": "pair", "count": 3, "op": ["intersect", "a", "b"]},
                 {"kind": "gone", "count": 1, "op": ["subtract", "a", "b"]}],
        "sample": {"per_kind": 2, "among_first": 8}}))
    (tmp_path / "portbench/metrics/pairs.members_per_op.py").write_text(
        "def read(run):\n"
        "    return sum(r['members'] for r in run.requests)"
        " / len(run.requests)\n")
    bench["configs"].append({"name": "pangenome-k15", "source": "x",
                             "file": "portbench/configs/pangenome-k15.json",
                             "reduced": ["genomes"], "why": "k = 15"})
    bench["workloads"].append({"name": "pangenome-k15.pairs",
                               "config": "pangenome-k15", "traffic": "pairs",
                               "chips": 1, "why": "pairs"})
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "setop_kmers_per_s")
    rate["workloads"].append("pangenome-k15.pairs")
    bench["per_layer"].append({"name": "pairs.members_per_op", "unit": "kmers",
                               "better": "higher", "source": "host_clock",
                               "layer": "KmerSet glue",
                               "moves": "setop_kmers_per_s",
                               "workloads": ["pangenome-k15.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = small_run("pangenome-k15.pairs", traced=True, root=tmp_path)
    assert r["correct"] is True
    assert r["metrics"]["pairs.members_per_op"]["value"] > 0
    r = small_run("pangenome-k15.pairs", root=tmp_path)
    assert r["correct"] is True and "setop_kmers_per_s" in r["metrics"]


def test_a_failed_request_is_not_correct(on_cpu, monkeypatch):
    """Every other subtract in the window raises: those answers never
    come (set-up's own calls succeed)."""
    from unikmer_tpu_torch.api import KmerSet

    subtract, window, calls = KmerSet.subtract, harness.window, []

    def flaky(self, other):
        calls.append(1)
        if calls[0] is None and len(calls) % 2:
            raise RuntimeError("planted failure")
        return subtract(self, other)

    def armed(*args):
        calls[:] = [None]
        return window(*args)

    monkeypatch.setattr(KmerSet, "subtract", flaky)
    monkeypatch.setattr(harness, "window", armed)
    r = small_run("pangenome-k23.merge", seed=77)
    assert r["correct"] is False and r["failed"] > 0
    assert r["checks"]["requests_failed"]["value"] == r["failed"]


def test_a_sample_left_unchecked_is_not_correct(on_cpu):
    """A window that ends before the sample reaches every kind proves
    nothing of the kinds it missed."""
    r = small_run("pangenome-k23.merge", seconds=0)
    assert r["attempted"] == 1
    assert r["checks"]["kinds_unchecked"]["value"] > 0
    assert r["correct"] is False


def test_the_hashed_configuration_runs_by_entries_alone(on_cpu, tmp_path):
    """pangenome-k31h (ntHash v1, k = 31, 64-bit codes) under the merge
    mix, added by entries in BENCHMARK.json alone: its configuration
    file and the reference's hashed encoder are already there."""
    bench = copy_of_harness(tmp_path)
    bench["configs"].append({
        "name": "pangenome-k31h", "source": "x", "reduced": ["genomes"],
        "file": "portbench/configs/pangenome-k31h.json", "why": "hashed"})
    add_cell(bench, "pangenome-k31h.merge", "pangenome-k31h", "merge")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    r = small_run("pangenome-k31h.merge", root=tmp_path,
                  mix_keys=SMALL_MIX["pangenome-k23.merge"])
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"setop_kmers_per_s", "setop_p95_ms",
                                 "setup_s"}
