"""The program's own record, for the metric readers: its always-on
counters, and the spans it recorded while the profiler ran, placed on the
trace's clock (``unikmer_tpu_torch/utils/stages.py``, ``snapshot()``).

A span's start and end are Unix nanoseconds (``time.time_ns()``), the
clock ``torch.profiler`` converts its events to; the Chrome trace stores
each event as Unix time less the start of the current 7,889,238-second
interval (libkineto's ``ChromeTraceBaseTime``), in microseconds.  The
profiler runs from just before the window to just after it, so the spans
that lie in the trace's window are the window's.  Every function returns
None where the program keeps no such record (a checkout without it).
"""

from __future__ import annotations

from portbench.records import idle_gaps, merged

TRIMONTH_S = 7889238


def record() -> dict | None:
    """The program's counters and spans, or None where it keeps none."""
    try:
        from unikmer_tpu_torch.utils import stages
    except ImportError:
        return None
    snapshot = getattr(stages, "snapshot", None)
    return snapshot() if callable(snapshot) else None


def counters() -> dict | None:
    rec = record()
    return None if rec is None else rec["counters"]


def trace_us(t_ns: int) -> float:
    """A Unix time in ns on the Chrome trace's clock, in us."""
    base = t_ns // 10**9 // TRIMONTH_S * TRIMONTH_S * 10**9
    return (t_ns - base) / 1e3


def window_spans(run) -> list | None:
    """The spans that lie in the traced window, each a dict of the
    program's record with ``ts`` and ``te`` (us, the trace's clock)
    added; None without a record, or without a trace of the card's work
    (an untraced or a CPU run: the spans measure the device path)."""
    rec = record() if run.trace is not None and run.trace.device else None
    if rec is None:
        return None
    out = []
    for s in rec["spans"]:
        if s["end_ns"] is None:
            continue
        a, b = trace_us(s["start_ns"]), trace_us(s["end_ns"])
        if a >= run.trace.start and b <= run.trace.end:
            out.append({**s, "ts": a, "te": b})
    return out


def overlap_us(xs, ys) -> float:
    """The length of the intersection of two unions of (start, end)
    intervals."""
    a, b = merged(xs), merged(ys)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside_pct(run, spans) -> float:
    """100 x the window's idle time (no kernel, copy or fill on the
    card) inside the union of ``spans``, over the window."""
    inside = overlap_us(idle_gaps(run.trace),
                        [(s["ts"], s["te"]) for s in spans])
    return 100.0 * inside / (run.trace.end - run.trace.start)
