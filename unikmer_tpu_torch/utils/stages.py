"""The port's one tracing system: spans of the program's stages and
operations, and always-on counters.

Spans.  ``with stage(name, device)`` is a span.  It records only while
someone listens:

- a ``torch.profiler`` session records: the span is also entered as a
  RecordFunction range (the one ``torch.profiler.record_function`` opens,
  without the dispatcher's cost), so a Chrome trace
  (UNIKMER_TPU_PROFILE=<dir> among them) shows it beside the kernels;
- a :func:`record_stages` block or the stream profiler is open: the
  recorder also takes the stage's seconds.

Otherwise a span costs one check and a ``nullcontext``.  A recorded span
keeps its name, its start and end in Unix nanoseconds (``time.time_ns()``,
the clock ``torch.profiler`` converts its events to; a Chrome trace
stores each as Unix time less the start of the current 7,889,238-second
interval) and the id of its parent and of its root (the outermost open
span: all spans under one root share its id), in a bounded in-memory
list that keeps the newest :data:`MAX_SPANS` (:func:`snapshot`).

Stage seconds.  A stage given a device is timed into the recorder: on a
CUDA device by a pair of CUDA events on the device's current stream,
resolved when the table is read; on the host by the host clock.  So a
stage whose work is the host's (packing, reading files, waiting on the
card and copying to the host) names the host device, and reads its wall
seconds while the card still runs earlier work.  Nothing here
synchronises at a stage's edges, so recording leaves the streams'
overlap (models/count.py's pipeline depth) as it is.  A span given no
device (``device=None``) is a span only, kept out of the tables.

:func:`record_stages` keeps inclusive seconds: a stage opened inside
another (``map query`` around ``sort`` and ``collapse``) is charged to
both.  The stream profiler (``stream_profile_reset``,
``stream_profile_table``, ``stream_profile_report``; the JAX package's
names and report layout, unikmer_tpu/models/count.py) keeps exclusive
seconds, so that its phases add up to its total: ``count`` turns it on,
prints the report to stderr after its run and turns it off again
(:func:`stream_profile_stop`).

Counters.  :func:`timed` adds a block's host seconds to an always-on
counter in a plain dict: the loads of the kernel and host libraries
(``kernels.load_s``, ``native.load_s``: a build where the checkout has
none, the dlopen), which run before any profiler does.  :func:`count`
adds 1, or an amount, to one: ``admit.calls``, the admissions against a
card's budget, and ``admit.reads``, those that read the card's free
bytes; ``sets.member_slots``, the members that ``union_many`` and
``common`` hand to K2 where the caller gives the sets' lengths, and
``sets.capacity_slots``, the padded slots those sorts would have taken
(ops/device_sets.py).  :func:`snapshot` returns a copy of the counters
and of the spans.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar

MAX_SPANS = 1 << 18  # the newest spans kept; older ones are dropped

_NULL = nullcontext()
_COUNT_LOCK = threading.Lock()
COUNTERS: dict[str, float] = {}
_SPANS: deque = deque(maxlen=MAX_SPANS)
_IDS = itertools.count(1)
_profiler_enabled = None  # torch._C._autograd._profiler_enabled, once imported


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "name", "parent", "root", "start_ns", "end_ns")

    def __init__(self, name: str, parent: "Span | None"):
        self.id = next(_IDS)
        self.name = name
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.start_ns = self.end_ns = None

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns}


_OPEN: ContextVar[Span | None] = ContextVar("unikmer_tpu_torch_span",
                                            default=None)


class _Timing:
    """One stage's timing in a recorder: host seconds, or a CUDA event
    pair resolved later; ``inner`` sums its closed children's seconds."""

    __slots__ = ("name", "parent", "t0", "secs", "events", "inner")

    def __init__(self, name: str, parent: "_Timing | None"):
        self.name, self.parent = name, parent
        self.t0 = self.secs = self.events = None
        self.inner = 0.0


class StageTimes:
    """Seconds and entry counts per stage name, in the order stages
    close; ``exclusive`` takes the seconds of the stages opened inside a
    stage off its own.  CUDA stages are resolved from their events when
    ``seconds`` is read (a wait for the last of them), never at their
    edges."""

    def __init__(self, exclusive: bool = False):
        self.exclusive = exclusive
        self.calls: dict[str, int] = {}
        self._seconds: dict[str, float] = {}
        self._open: list[_Timing] = []
        self._closed: list[_Timing] = []  # children before their parents

    @contextmanager
    def stage(self, name: str, device):
        """Time one stage on ``device`` into this recorder."""
        t = _Timing(name, self._open[-1] if self._open else None)
        stream = None
        if str(device).startswith("cuda"):
            import torch

            stream = torch.cuda.current_stream(torch.device(device))
            t.events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            t.events[0].record(stream)
        else:
            t.t0 = time.perf_counter()
        self._open.append(t)
        try:
            yield
        finally:
            if stream is not None:
                t.events[1].record(stream)
            else:
                t.secs = time.perf_counter() - t.t0
            self._open.pop()
            self._closed.append(t)
            self.calls[name] = self.calls.get(name, 0) + 1

    @property
    def seconds(self) -> dict[str, float]:
        for t in self._closed:
            if t.events is not None:
                t.events[1].synchronize()
                t.secs = t.events[0].elapsed_time(t.events[1]) / 1e3
            if t.parent is not None:
                t.parent.inner += t.secs
            dt = t.secs - t.inner if self.exclusive else t.secs
            self._seconds[t.name] = self._seconds.get(t.name, 0.0) + dt
        self._closed = []
        return self._seconds


_ACTIVE: ContextVar[StageTimes | None] = ContextVar("unikmer_tpu_torch_stages",
                                                    default=None)
_PROFILE: StageTimes | None = None  # the stream profiler's recorder


def _profiling() -> bool:
    """Whether a torch.profiler session records (False until torch is
    imported: no session can run before)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        autograd = getattr(getattr(torch, "_C", None), "_autograd", None)
        if autograd is None:
            return False
        _profiler_enabled = autograd._profiler_enabled
    return _profiler_enabled()


@contextmanager
def record_stages():
    """Record the stages run inside the block; yields the StageTimes."""
    times = StageTimes()
    token = _ACTIVE.set(times)
    try:
        yield times
    finally:
        _ACTIVE.reset(token)


def stage(name: str, device=None):
    """Context manager: the span ``name`` when recording, else a no-op.
    Given ``device`` (a torch.device or its name), an open
    :func:`record_stages` block, else the stream profiler when it is on,
    also takes the stage's seconds on that device."""
    times = _ACTIVE.get() or _PROFILE
    if times is None and not _profiling():
        return _NULL
    return _recorded(name, None if device is None else times, device)


@contextmanager
def _recorded(name: str, times: StageTimes | None, device):
    span = Span(name, _OPEN.get())
    _SPANS.append(span)
    token = _OPEN.set(span)
    # the profiler's range is a RecordFunction entered directly:
    # torch.profiler.record_function enters it through the dispatcher,
    # which under a profiler costs 10-90 us on a busy host.  The span's
    # edges are read just after the range opens and just after it closes,
    # so both lie within a few us of the range's own.
    ranged = (sys.modules["torch"]._C._profiler._RecordFunctionFast(name)
              if _profiling() else _NULL)
    try:
        with ranged:
            span.start_ns = time.time_ns()
            with _NULL if times is None else times.stage(name, device):
                yield span
    finally:
        span.end_ns = time.time_ns()
        _OPEN.reset(token)


@contextmanager
def timed(name: str):
    """Add the block's host seconds to the always-on counter ``name``
    (a run that raises counts too)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        secs = time.perf_counter() - t0
        with _COUNT_LOCK:
            COUNTERS[name] = COUNTERS.get(name, 0.0) + secs


def count(name: str, amount: int = 1) -> None:
    """Add ``amount`` (1 by default) to the always-on counter ``name``."""
    with _COUNT_LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + amount


def snapshot() -> dict:
    """A copy of the counters and of the recorded spans (dicts: ``id``,
    ``name``, ``parent``, ``root``, ``start_ns``, ``end_ns``), oldest span
    first."""
    with _COUNT_LOCK:
        counters = dict(COUNTERS)
    return {"counters": counters, "spans": [s.as_dict() for s in list(_SPANS)]}


def stream_profile_reset() -> None:
    """Turn the stream profiler on (UNIKMER_TPU_PROFILE_STREAM=1) or off
    and clear its table; call before a run."""
    global _PROFILE
    on = os.environ.get("UNIKMER_TPU_PROFILE_STREAM", "0") == "1"
    _PROFILE = StageTimes(exclusive=True) if on else None


def stream_profile_stop() -> None:
    """Turn the stream profiler off, so that later work in the process
    (the resident server's next request) records nothing."""
    global _PROFILE
    _PROFILE = None


def stream_profile_table() -> dict:
    """{phase: (total_s, calls)} recorded since the last reset."""
    if _PROFILE is None:
        return {}
    return {k: (v, _PROFILE.calls[k]) for k, v in _PROFILE.seconds.items()}


def stream_profile_report(out=None) -> None:
    """Print the table, longest phase first, in the JAX package's layout
    (to stderr by default); nothing when the profiler is off or idle."""
    table = stream_profile_table()
    if not table:
        return
    out = out or sys.stderr
    total = sum(v[0] for v in table.values())
    print("# stream profile (exclusive wall per phase):", file=out)
    for name, (secs, calls) in sorted(table.items(),
                                      key=lambda kv: -kv[1][0]):
        print(f"#   {name:<22} {secs:8.3f}s  x{calls:<5} "
              f"({100 * secs / max(total, 1e-9):5.1f}%)", file=out)
    print(f"#   {'TOTAL(tracked)':<22} {total:8.3f}s", file=out)
