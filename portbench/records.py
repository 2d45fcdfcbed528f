"""What a run hands to its metric readers (``portbench/metrics``): the
window's requests, the harness's set-up spans, the program's counters
and, in a traced run, the device trace of the window.

The trace is ``torch.profiler``'s Chrome trace (CPU and CUDA
activities), read as intervals in microseconds on one clock: the
device's kernels, copies and fills, the CUDA runtime and cu* API calls,
the CPU operators and the harness's own spans (``record_function``
ranges named ``portbench.*``).  Only what lies in the window's span
(``portbench.window``) is kept.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "portbench.window"


@dataclass
class Trace:
    """Intervals (name, start us, end us) of one traced window."""

    start: float
    end: float
    device: list = field(default_factory=list)  # (cat, name, ts, te)
    calls: list = field(default_factory=list)  # (name, ts, te)
    spans: list = field(default_factory=list)  # harness spans
    cpu_ops: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self):
        return [(n, a, b) for c, n, a, b in self.device if c == "kernel"]

    @classmethod
    def from_chrome(cls, path: str) -> "Trace | None":
        """The window's trace from a Chrome trace file; None when the
        file holds no window span."""
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        window = [e for e in events if e.get("name") == WINDOW_SPAN
                  and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not window:
            return None
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
        out = cls(start=w0, end=w1)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"])
            b = a + float(e["dur"])
            if b < w0 or a > w1:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                out.device.append((cat, name, max(a, w0), min(b, w1)))
            elif cat in CALL_CATS:
                out.calls.append((name, a, b))
            elif cat == "user_annotation" and name.startswith("portbench.") \
                    and name != WINDOW_SPAN:
                out.spans.append((name, a, b))
            elif cat == "cpu_op":
                out.cpu_ops.append((name, a, b))
        return out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def busy_us(trace: Trace) -> float:
    """Microseconds of the window in which a kernel, copy or fill ran."""
    return covered((a, b) for _, _, a, b in trace.device)


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The window's intervals in which nothing ran on the device."""
    gaps, at = [], trace.start
    for a, b in merged((a, b) for _, _, a, b in trace.device):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if trace.end > at:
        gaps.append((at, trace.end))
    return gaps


def _innermost(intervals, t: float) -> str | None:
    best = None
    for name, a, b in intervals:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (seconds by name), and
    the longest idle gaps, each named by the harness span open across it,
    and the CPU operator and the CUDA call the host was in."""
    by_name: dict[str, float] = {}
    for _, name, a, b in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(trace), key=lambda g: g[0] - g[1])[:top]
    labelled = []
    for a, b in gaps:
        mid = (a + b) / 2
        parts = [_innermost(trace.spans, mid) or "none",
                 _innermost(trace.cpu_ops, mid), _innermost(trace.calls, mid)]
        labelled.append([" / ".join(p for p in parts if p), (b - a) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": labelled}


def host_calls(trace: Trace, top: int = 12) -> list:
    """The CUDA runtime and cu* API calls that took most of the window's
    host time, [name, seconds, count]."""
    total: dict[str, list] = {}
    for name, a, b in trace.calls:
        t = total.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e6
        t[1] += 1
    return [[n, s, c] for n, (s, c) in
            sorted(total.items(), key=lambda kv: -kv[1][0])[:top]]


@dataclass
class RunRecords:
    """Everything a metric reader may read.  ``requests`` are dicts with
    ``kind``, ``size``, ``members``, ``sort_members``, ``lookups`` and
    ``latency_ms``; ``window_s`` is the window's host-clock length;
    ``setup`` the set-up spans in seconds; ``counters`` the program's
    counters over the window; ``trace`` the window's device trace (None
    in an untraced run)."""

    requests: list
    window_s: float
    setup: dict
    counters: dict
    trace: Trace | None = None


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least a
    share q of the values at or below it."""
    s = sorted(values)
    return s[max(1, math.ceil(q * len(s))) - 1]
