"""The port's spans and counters (unikmer_tpu_torch/utils/stages.py) and
the per-layer readers that read them (portbench/metrics).

On the CPU: each KmerSet operation under a ``torch.profiler`` session
records one root span, its ``readback`` child where a result's size is
read and its ``sort``/``collapse`` stages under the same root, and no
``admit`` child (the CPU has no budget); nothing records or counts, and
``record_function`` is never entered, when nobody listens; the spans'
Unix clock converted by the Chrome trace's rule lands on their own
``record_function`` copies in the exported trace; the libraries' load
seconds; the five readers against values worked out by hand on a planted
record.  The ``cuda`` case records stages on the card under
``set_sync_debug_mode("error")``.
"""

import json
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.cell import metric_reader  # noqa: E402
from portbench.records import RunRecords, Trace  # noqa: E402
from portbench.spans import trace_us  # noqa: E402
from unikmer_tpu_torch import _kernels, native  # noqa: E402
from unikmer_tpu_torch.api import KmerSet  # noqa: E402
from unikmer_tpu_torch.ops import device_sets  # noqa: E402
from unikmer_tpu_torch.utils import stages  # noqa: E402

CPU = torch.device("cpu")
K = 15


@pytest.fixture
def fresh(monkeypatch):
    """An empty span record, counters and kept card readings of the
    test's own."""
    monkeypatch.setattr(stages, "_SPANS", deque(maxlen=stages.MAX_SPANS))
    monkeypatch.setattr(stages, "COUNTERS", {})
    monkeypatch.setattr(device_sets, "_CEILINGS", {})
    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS", raising=False)


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(21)
    return [KmerSet.from_codes(rng.integers(0, 1 << (2 * K), n,
                                            dtype=np.uint64), K, device=CPU)
            for n in (3000, 2500, 4000)]


OPS = {
    "union_all": lambda s: KmerSet.union_all(s),
    "common": lambda s: KmerSet.common(s, 2),
    "subtract": lambda s: s[0].subtract(s[1]),
    "intersect": lambda s: s[0].intersect(s[1]),
}
SORTS = {"union_all", "common"}


def in_two(codes):
    u, n = np.unique(np.concatenate(codes), return_counts=True)
    return u[n >= 2]


WANT = {
    "union_all": lambda c: np.unique(np.concatenate(c)),
    "common": in_two,
    "subtract": lambda c: np.setdiff1d(c[0], c[1]),
    "intersect": lambda c: np.intersect1d(c[0], c[1]),
}


def by_root(spans):
    out = {}
    for s in spans:
        out.setdefault(s["root"], []).append(s)
    return out


@pytest.mark.parametrize("op", sorted(OPS))
def test_each_operation_records_one_root_span(fresh, sets, op):
    with profile(activities=[ProfilerActivity.CPU]):
        got = OPS[op](sets)
    spans = stages.snapshot()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == [f"KmerSet.{op}"]
    root = roots[0]
    assert set(by_root(spans)) == {root["id"]}
    ids = {s["id"]: s for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            up = ids[s["parent"]]
            assert up["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= up["end_ns"]
    names = [s["name"] for s in spans]
    assert "admit" not in names
    assert "readback" in names and "KmerSet.compact" in names
    # union_all sorts and collapses in ops/device_sets.union_many's
    # stages; common sorts by ops/device_sets.common, unstaged
    assert ({"sort", "collapse"} <= set(names)) == (op == "union_all")
    np.testing.assert_array_equal(got.to_numpy(), WANT[op](
        [s.to_numpy() for s in sets]))


def test_host_route_is_one_root_with_no_device_stage(fresh, sets,
                                                     monkeypatch):
    """Past the budget the host engine answers inside the operation's
    root span (its result kept on the host by ``from_codes``), with no
    read-back and no device stage under it."""
    monkeypatch.setattr(device_sets, "_device_free_bytes", lambda d: 1000)
    with profile(activities=[ProfilerActivity.CPU]):
        got = KmerSet.union_all(sets)
    root, *rest = stages.snapshot()["spans"]
    assert root["name"] == "KmerSet.union_all" and root["parent"] is None
    assert [s["name"] for s in rest] == ["KmerSet.from_codes"]
    assert rest[0]["parent"] == root["id"]
    assert got._on_host
    want = np.union1d(np.union1d(sets[0].to_numpy(), sets[1].to_numpy()),
                      sets[2].to_numpy())
    np.testing.assert_array_equal(got.to_numpy(), want)


def test_admit_span_wraps_the_free_bytes_read(fresh, monkeypatch):
    """On a CUDA device the admission, with its free-bytes read, is an
    ``admit`` span (mem_get_info and the allocator's stats stubbed: the
    CPU has no card)."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (8 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda d=None: {
                            "reserved_bytes": {"all": {"current": 1 << 30}},
                            "allocated_bytes": {"all": {"current": 1 << 29}}})
    card = torch.device("cuda", 0)
    assert device_sets._device_free_bytes(card) == (8 << 30) + (1 << 29)
    assert stages.snapshot()["spans"] == []
    with profile(activities=[ProfilerActivity.CPU]):
        with stages.stage("KmerSet.union"):
            device_sets.element_budget("union", card)
    spans = stages.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["KmerSet.union", "admit"]
    assert spans[1]["parent"] == spans[1]["root"] == spans[0]["id"]
    assert spans[0]["start_ns"] <= spans[1]["start_ns"] \
        <= spans[1]["end_ns"] <= spans[0]["end_ns"]


def test_nothing_records_without_a_listener(fresh, sets, monkeypatch):
    """No profiler and no recorder: no span, no counter but the member
    path's slot counts (which count work, listened to or not), and
    record_function is never entered."""
    def boom(*a, **kw):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    for op in OPS.values():
        op(sets)
    assert sets[0].contains(sets[0].to_numpy()[:10]).all()
    assert stages.snapshot()["spans"] == []
    assert stages.stage("x", CPU) is stages.stage("y") is stages._NULL
    # union_all and common, each over the sets' members
    assert stages.snapshot()["counters"] == {
        "sets.member_slots": 2 * sum(len(s) for s in sets),
        "sets.capacity_slots": 2 * sum(s.capacity for s in sets)}


def test_recorder_takes_spans_and_stage_seconds(fresh, sets):
    """Under record_stages() the spans record too (no profiler); device
    stages are timed into the table, spans without a device are not."""
    with stages.record_stages() as st:
        KmerSet.union_all(sets)
    names = {s["name"] for s in stages.snapshot()["spans"]}
    assert {"KmerSet.union_all", "readback", "sort", "collapse"} <= names
    assert set(st.seconds) == {"sort", "collapse"}
    assert st.calls["collapse"] == 1 and st.calls["sort"] == 1


def test_spans_sit_on_the_chrome_trace_clock(fresh, sets, tmp_path):
    """Each span's start and end, converted by the Chrome trace's rule
    (Unix ns less the start of the 7,889,238-second interval), lie within
    50 us of its record_function copy in the exported trace."""
    with profile(activities=[ProfilerActivity.CPU]):
        KmerSet.union_all(sets)  # the first ranges of a process are slow
    stages._SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for op in OPS.values():
            op(sets)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = {}
    names = {s["name"] for s in stages.snapshot()["spans"]}
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("name") in names),
                    key=lambda e: float(e["ts"])):
        copies.setdefault(e["name"], []).append(e)
    spans = stages.snapshot()["spans"]
    assert len(spans) >= 3 * len(OPS)  # each op, its compact and readback
    seen = {}
    for s in spans:
        e = copies[s["name"]][seen.setdefault(s["name"], 0)]
        seen[s["name"]] += 1
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert abs(trace_us(s["start_ns"]) - a) < 50, s
        assert abs(trace_us(s["end_ns"]) - b) < 50, s
    assert seen == {name: len(v) for name, v in copies.items()}


def test_the_span_record_is_bounded(fresh, monkeypatch):
    monkeypatch.setattr(stages, "_SPANS", deque(maxlen=3))
    monkeypatch.setattr(stages, "MAX_SPANS", 3)
    with stages.record_stages():
        for i in range(5):
            with stages.stage(f"s{i}"):
                pass
    assert [s["name"] for s in stages.snapshot()["spans"]] == ["s2", "s3",
                                                               "s4"]


def test_library_loads_are_counted(fresh, monkeypatch, tmp_path):
    """native.get_lib and _kernels.load count their first load's seconds
    alone (the kernel library's build stubbed to take 10 ms, its dlopen
    and binding stubbed: no nvcc here)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("UNIKMER_TPU_NO_NATIVE", raising=False)
    assert native.get_lib() is not None
    first = stages.COUNTERS["native.load_s"]
    assert native.get_lib() is not None
    assert stages.COUNTERS == {"native.load_s": first} and first > 0

    def build():
        time.sleep(0.01)
        return tmp_path / "lib.so"

    monkeypatch.setattr(_kernels, "_lib", None)
    monkeypatch.setattr(_kernels, "build", build)
    monkeypatch.setattr(_kernels.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_kernels, "_bind", lambda lib: None)
    _kernels.load()
    _kernels.load()
    assert 0.01 <= stages.COUNTERS["kernels.load_s"] < 1


# ---------------------------------------------------------------------
# the readers, on a planted record

READERS = ("api.admit_ms_per_op", "api.readbacks_per_op",
           "device.idle_in_ops_pct", "device.idle_admit_pct", "setup.load_s",
           "api.admit_reads_pct")
BASE_NS = 1_790_857_026 * 10**9  # the start of a 7,889,238-second interval


def at(us: float) -> int:
    """A Unix time in ns that the trace's clock reads as ``us``."""
    return BASE_NS + int(us * 1000)


def planted_run():
    """A 1,000 us window, kernels at 100-300 and 600-900 (idle 0-100,
    300-600, 900-1000: 500 us), two requests; two root operations at
    50-350 and 550-950, admit spans at 60-160 (under the first) and
    560-580, readbacks at 320-340 and 940-945, and a span before the
    window."""
    trace = Trace(start=0.0, end=1000.0)
    trace.device = [("kernel", "k", 100.0, 300.0), ("kernel", "k", 600.0,
                                                     900.0)]
    run = RunRecords(requests=[{"latency_ms": 1}, {"latency_ms": 1}],
                     window_s=0.001, setup={}, counters={}, trace=trace)
    rows = [(1, "KmerSet.union_all", None, 50, 350),
            (2, "admit", 1, 60, 160),
            (3, "readback", 1, 320, 340),
            (4, "KmerSet.common", None, 550, 950),
            (5, "admit", 4, 560, 580),
            (6, "readback", 4, 940, 945),
            (7, "KmerSet.union", None, -500, -400)]
    spans = [{"id": i, "name": n, "parent": p, "root": p or i,
              "start_ns": at(a), "end_ns": at(b)}
             for i, n, p, a, b in rows]
    counters = {"kernels.load_s": 0.25, "native.load_s": 0.5,
                "admit.calls": 400, "admit.reads": 2}
    return run, {"counters": counters, "spans": spans}


@pytest.mark.parametrize("name,want", [
    ("api.admit_ms_per_op", (0.100 + 0.020) / 2),
    ("api.readbacks_per_op", 1.0),
    # idle inside the roots: 50-100, 300-350, 550-600, 900-950
    ("device.idle_in_ops_pct", 100 * 200 / 1000),
    # idle inside admit: 60-100, 560-580
    ("device.idle_admit_pct", 100 * 60 / 1000),
    ("setup.load_s", 0.75),
    ("api.admit_reads_pct", 100 * 2 / 400),
])
def test_reader_on_a_planted_record(monkeypatch, name, want):
    run, rec = planted_run()
    monkeypatch.setattr(stages, "snapshot", lambda: rec)
    assert metric_reader(ROOT, name)(run) == pytest.approx(want, abs=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_without_the_record(monkeypatch, name):
    """A program without ``snapshot`` (an older checkout): None."""
    run, _ = planted_run()
    monkeypatch.delattr(stages, "snapshot")
    assert metric_reader(ROOT, name)(run) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_off_the_card(monkeypatch, name):
    """An untraced run, a trace with no device work, and counters without
    the kernel library's load or an admission on a card (a CPU run):
    None."""
    run, rec = planted_run()
    for counter in ("kernels.load_s", "admit.calls", "admit.reads"):
        rec["counters"].pop(counter)
    run.trace.device = []
    monkeypatch.setattr(stages, "snapshot", lambda: rec)
    read = metric_reader(ROOT, name)
    assert read(run) is None
    run.trace = None
    assert read(run) is None


# ---------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_recorded_stages_wait_on_nothing_on_the_card(fresh, cuda_device):
    """A union's sort and collapse recorded under record_stages() and a
    profiler queue no synchronising call; their seconds come from CUDA
    events when the table is read."""
    from unikmer_tpu_torch.ops.sort import collapse_sorted

    keys = torch.randint(0, 1 << 46, (1 << 20,), device=cuda_device)
    valid = torch.ones_like(keys, dtype=torch.bool)
    collapse_sorted(keys, valid, code_bits=46)  # warm: the kernels load
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with stages.record_stages() as st:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out, n = collapse_sorted(keys, valid, code_bits=46)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    table = st.seconds
    assert set(table) == {"sort", "collapse"} and min(table.values()) > 0
    assert int(n) == len(torch.unique(keys))
    assert {"sort", "collapse"} <= {s["name"] for s in
                                    stages.snapshot()["spans"]}
