"""The hashed pan-genome: 64-bit codes through KmerSet and the benchmark.

- ``pangenome-k31h.merge`` and ``pangenome-k23.merge`` run small through
  the harness (portbench/cell.py), with BENCHMARK.json as it stands and
  the sizes of the harness's own tests, over a window of a fixed count
  of requests, and come out correct; with the
  membership search planted to order codes as signed int64 (the padding
  mapped to INT64_MAX, so every code below 2^63 stays in order) the
  hashed cell is not correct while the 2-bit cell still is;
- the set path at 64 bits against numpy, member for member: hashed sets
  whose members straddle 2^63 and hold 2^64 - 2, the code just below
  the padding;
- the reader of ``k2.passes_per_sort`` on set counters, and K2's pass
  count at the two widths the cells sort.
"""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cell as harness  # noqa: E402
from unikmer_tpu_torch.api import KmerSet  # noqa: E402
from unikmer_tpu_torch.ops import device_sets  # noqa: E402
from unikmer_tpu_torch.ops.codec import SENTINEL  # noqa: E402
from unikmer_tpu_torch.ops.radix_sort import (  # noqa: E402
    radix_shifts, radix_sort_u64,
)


def _harness_sizes():
    """(SMALL, the merge mix's keys) of portbench/tests/conftest.py."""
    spec = importlib.util.spec_from_file_location(
        "portbench_tests_sizes", ROOT / "portbench" / "tests" / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SMALL, mod.SMALL_MIX["pangenome-k23.merge"]


SMALL, MERGE_KEYS = _harness_sizes()
CELLS = ["pangenome-k23.merge", "pangenome-k31h.merge"]
INT64_MAX = torch.iinfo(torch.int64).max


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


def _window_of(count: int):
    """harness.window cut to ``count`` requests whatever the host's
    speed, so a loaded host still reaches the sample: one request a
    call of the original with no time left, the parts summed."""
    window = harness.window

    def counted(ev, stream, seconds, keep, device, traced):
        parts = [window(ev, stream, 0, keep, device, traced)
                 for _ in range(count)]
        return ([r for p in parts for r in p[0]],
                {k: v for p in parts for k, v in p[1].items()},
                *(sum(p[i] for p in parts) for i in (2, 3, 4)))
    return counted


def _signed_lookup(ref, q):
    """_lookup's fault: the search over codes read as signed int64, the
    padding moved to INT64_MAX so it still sorts last."""
    if ref.shape[0] == 0:
        return torch.zeros_like(q), torch.zeros(q.shape, dtype=torch.bool)
    r = torch.where(ref == SENTINEL, INT64_MAX, ref)
    v = torch.where(q == SENTINEL, INT64_MAX, q)
    idx = torch.searchsorted(r, v).clamp_(max=ref.shape[0] - 1)
    return idx, ref[idx] == q


@pytest.mark.parametrize("fault", [None, "signed order"])
@pytest.mark.parametrize("workload", CELLS)
def test_merge_cell_small(on_cpu, monkeypatch, workload, fault):
    cell, entry, cfg, _, _ = harness.load_cell(ROOT, workload)
    assert cell["traffic"] == "merge" and cell["chips"] == 1
    assert entry["reduced"] == ["genomes"]
    if fault:
        monkeypatch.setattr(device_sets, "_lookup", _signed_lookup)
    requests = MERGE_KEYS["sample"]["among_first"] + 4
    monkeypatch.setattr(harness, "window", _window_of(requests))
    r = harness.run_cell(workload, 31337, 0, False, ROOT, threads=2,
                         sizes=SMALL, mix_keys=MERGE_KEYS)
    assert r["failed"] == 0 and r["attempted"] == requests
    assert r["checks"]["requests_failed"]["value"] == 0
    assert r["checks"]["genome_sets_wrong"]["value"] == 0
    assert r["checks"]["kinds_unchecked"]["value"] == 0
    if fault and cfg["hashed"]:
        assert r["correct"] is False
        assert r["checks"]["answers_wrong"]["value"] > 0
        return
    assert r["correct"] is True
    assert set(r["metrics"]) == {"setop_kmers_per_s", "setop_p95_ms",
                                 "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


# --------------------------------------------------- the 64-bit set path
TOP = (1 << 64) - 2  # the largest code a KmerSet holds
EDGES = np.array([0, 1, (1 << 63) - 2, (1 << 63) - 1, 1 << 63,
                  (1 << 63) + 1, TOP - 1, TOP], np.uint64)
SETS = 10


@pytest.fixture(scope="module")
def hashed():
    """(numpy sets, KmerSets): SETS sets of uniform hashes, each holding
    between half and all of a shared pool; the codes around 2^63 and at
    the top in every set but the last."""
    rng = np.random.default_rng(23)
    pool = np.unique(rng.integers(0, TOP, 4000, dtype=np.uint64,
                                  endpoint=True))
    arrays = []
    for i in range(SETS):
        got = pool[rng.random(pool.size) < 0.5 + 0.05 * i]
        if i < SETS - 1:
            got = np.union1d(got, EDGES)
        arrays.append(np.unique(got))
    sets = [KmerSet.from_codes(a, 31, canonical=True, hashed=True,
                               device=torch.device("cpu")) for a in arrays]
    return arrays, sets


def _common(arrays, t):
    codes, counts = np.unique(np.concatenate(arrays), return_counts=True)
    return codes[counts >= t]


OPS = {
    "union_all": (lambda s: KmerSet.union_all(s),
                  lambda a: np.unique(np.concatenate(a))),
    "common 1": (lambda s: KmerSet.common(s, 1), lambda a: _common(a, 1)),
    "common m": (lambda s: KmerSet.common(s, SETS),
                 lambda a: _common(a, SETS)),
    "common 0.9m": (lambda s: KmerSet.common(s, math.ceil(0.9 * SETS)),
                    lambda a: _common(a, math.ceil(0.9 * SETS))),
    "subtract": (lambda s: s[0].subtract(s[-1]),
                 lambda a: np.setdiff1d(a[0], a[-1])),
    "intersect": (lambda s: s[0].intersect(s[1]),
                  lambda a: np.intersect1d(a[0], a[1])),
    "subtract of a union": (lambda s: s[2] - KmerSet.union_all(s[::9]),
                            lambda a: np.setdiff1d(
                                a[2], np.union1d(a[0], a[9]))),
}


@pytest.mark.parametrize("op", [*OPS, "contains"])
def test_hashed_set_path_matches_numpy(hashed, op):
    arrays, sets = hashed
    if op == "contains":
        q = np.concatenate([arrays[-2], arrays[-1], EDGES,
                            np.array([(1 << 64) - 1], np.uint64)])
        want = np.isin(q, arrays[-2])
        np.testing.assert_array_equal(sets[-2].contains(q), want)
        assert want[-2] and not want[-1]  # 2^64 - 2 held, the padding not
        return
    run, ref = OPS[op]
    got, want = run(sets), ref(arrays)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.to_numpy(), want)
    # every result straddles 2^63
    assert (want >= 1 << 63).any() and (want < 1 << 63).any()


# ------------------------------------------------- k2.passes_per_sort
def test_k2_passes_per_sort_reader(monkeypatch):
    read = harness.metric_reader(ROOT, "k2.passes_per_sort")
    monkeypatch.setattr(radix_sort_u64, "launches", 0)
    assert read(None) is None  # no sort ran (the CPU launches none)
    monkeypatch.setattr(radix_sort_u64, "launches", 1_000)
    monkeypatch.setattr(radix_sort_u64, "passes_run", 7_998)
    assert read(None) == pytest.approx(7.998)
    assert len(radix_shifts(64)) == 8 and len(radix_shifts(46)) == 6
    assert "k2.passes_per_sort" in {
        m["name"] for m in harness.cell_metrics(
            harness.load_cell(ROOT, CELLS[1])[4], CELLS[1], traced=True)}
