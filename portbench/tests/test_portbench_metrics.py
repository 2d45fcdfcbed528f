"""The metric readers' arithmetic on records made by hand."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.peaks import HBM_BYTES_PER_S, sort_bytes  # noqa: E402
from portbench.records import (  # noqa: E402
    RunRecords, Trace, breakdown, busy_us, idle_gaps, merged, nearest_rank,
)


def reader(name: str):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def req(members=100, sort_members=0, lookups=0, latency_ms=1.0, kind="x"):
    return dict(kind=kind, size=0, members=members, sort_members=sort_members,
                lookups=lookups, latency_ms=latency_ms)


def test_every_metric_has_a_reader():
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"]))


def test_k2_roofline_counts_16_bytes_a_member():
    assert sort_bytes(10) == 160
    keys = 3_350_000_000  # 16 B each: 16 ms at the peak
    trace = Trace(0, 1e6, device=[
        ("kernel", "void radix_onesweep_pass<false>(...)", 0, 20_000),
        ("kernel", "radix_upfront_hist", 30_000, 40_000),
        ("kernel", "searchsorted_cuda_kernel", 50_000, 90_000),
        ("gpu_memcpy", "Memcpy DtoH", 90_000, 95_000)])
    half = req(sort_members=keys // 2)
    run = RunRecords([half, half], 1.0, {}, {}, trace)
    want = 100 * (16 * keys / HBM_BYTES_PER_S) / 0.030
    assert reader("k2_roofline")(run) == pytest.approx(want)
    assert want == pytest.approx(100 * 16 / 30)
    # no K2 kernel: nothing to read, never 0
    run.trace = Trace(0, 1e6, device=[("kernel", "searchsorted", 0, 5)])
    assert reader("k2_roofline")(run) is None
    run.trace = None
    assert reader("k2_roofline")(run) is None


def test_idle_share_over_overlapping_intervals():
    trace = Trace(0, 100, device=[
        ("kernel", "a", 10, 30), ("kernel", "b", 20, 40),  # overlap
        ("gpu_memset", "m", 40, 45), ("kernel", "c", 60, 70),
        ("kernel", "d", 62, 65)])  # inside c
    assert merged([(10, 30), (20, 40), (40, 45)]) == [(10, 45)]
    assert busy_us(trace) == 45
    assert idle_gaps(trace) == [(0, 10), (45, 60), (70, 100)]
    run = RunRecords([req()], 1.0, {}, {}, trace)
    assert reader("device.idle_pct")(run) == pytest.approx(55.0)


def test_p95_is_over_all_requests_and_a_stall_moves_it():
    lat = [10.0] * 95 + [20.0] * 5
    run = RunRecords([req(latency_ms=x) for x in lat], 1.0, {}, {})
    assert reader("setop_p95_ms")(run) == 10.0
    assert nearest_rank(lat, 0.96) == 20.0
    stalled = lat[:-6] + [500.0] * 6  # six requests wait behind a stall
    run = RunRecords([req(latency_ms=x) for x in stalled], 1.0, {}, {})
    assert reader("setop_p95_ms")(run) == 500.0


def test_rate_is_all_members_over_the_window():
    run = RunRecords([req(members=300), req(members=700)], 2.0, {}, {})
    assert reader("setop_kmers_per_s")(run) == 500.0


def test_per_op_device_times_and_syncs():
    trace = Trace(0, 1e6, device=[
        ("kernel", "radix_bases", 0, 1000),
        ("kernel", "at::native::searchsorted_cuda_kernel<long>", 1000, 4000),
        ("kernel", "CatArrayBatchedCopy", 4000, 6000),
        ("kernel", "DeviceScanKernel", 6000, 7000),
        ("gpu_memcpy", "Memcpy DtoH", 7000, 9000)],
        calls=[("cudaStreamSynchronize", 0, 1),
               ("cudaDeviceSynchronize", 2, 3),
               ("cudaDeviceSynchronize", 4, 5), ("cudaLaunchKernel", 6, 7),
               ("cudaMemcpyAsync", 8, 9), ("cudaStreamSynchronize", 10, 11)])
    run = RunRecords([req(lookups=1), req()], 1.0, {}, {"k2_launches": 3},
                     trace)
    assert reader("sets.collapse_ms_per_op")(run) == pytest.approx(1.5)
    assert reader("sets.lookup_ms_per_op")(run) == pytest.approx(3.0)
    assert reader("api.syncs_per_op")(run) == pytest.approx(1.0)
    assert reader("k2.launches_per_op")(run) == pytest.approx(1.5)
    run.counters["k2_launches"] = 0
    assert reader("k2.launches_per_op")(run) == 0.0


def test_setup_spans():
    run = RunRecords([], 0.0, {"setup_s": 12.5, "init_s": 8.0, "count_s": 2.0},
                     {})
    assert reader("setup_s")(run) == 12.5
    assert reader("setup.init_s")(run) == 8.0
    assert reader("setup.count_s")(run) == 2.0


def test_breakdown_names_gaps_by_span_op_and_call():
    trace = Trace(0, 100, device=[("kernel", "k1", 10, 20),
                                  ("kernel", "k2", 50, 60)],
                  spans=[("portbench.req.pan", 0, 100),
                         ("portbench.sync", 60, 100)],
                  cpu_ops=[("aten::item", 25, 45)],
                  calls=[("cudaMemGetInfo", 30, 40)])
    b = breakdown(trace)
    assert b["device_ops"] == [["k1", 10e-6], ["k2", 10e-6]]
    assert b["idle_gaps"] == [
        ["portbench.sync", 40e-6],
        ["portbench.req.pan / aten::item / cudaMemGetInfo", 30e-6],
        ["portbench.req.pan", 10e-6]]


def test_chrome_trace_keeps_only_the_window(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 160, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 120, "dur": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.req.a",
         "ts": 101, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 102, "dur": 3},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    t = Trace.from_chrome(str(p))
    assert (t.start, t.end, t.seconds) == (100.0, 150.0, 50e-6)
    assert t.device == [("kernel", "k", 100.0, 110.0)]
    assert t.calls == [("cudaLaunchKernel", 120.0, 121.0)]
    assert t.spans == [("portbench.req.a", 101.0, 111.0)]
    assert t.cpu_ops == [("aten::cat", 102.0, 105.0)]
    p.write_text(json.dumps({"traceEvents": events[1:]}))
    assert Trace.from_chrome(str(p)) is None
