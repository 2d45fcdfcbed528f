"""Per-stage wall-clock timing of the count pipeline.

Off unless a caller opens :func:`record_stages`, or
UNIKMER_TPU_PROFILE_STREAM=1 is set when :func:`stream_profile_reset`
runs; then every ``with stage(name, device)`` block adds its seconds to
the recorder.  Device work is asynchronous, so a recorded stage
synchronizes the device at both of its edges: the work a stage queued is
charged to it, at the price of the overlap between stages.  Unrecorded
runs never synchronize here.  So the streams of models/count.py run at
pipeline depth 0 while stages are recorded, and :func:`note` it.

:func:`record_stages` keeps inclusive seconds: a stage opened inside
another (``map query`` around ``sort`` and ``collapse``) is charged to
both.  The stream profiler (``stream_profile_reset``,
``stream_profile_table``, ``stream_profile_report``; the JAX package's
names and report layout, unikmer_tpu/models/count.py) keeps exclusive
seconds, so that its phases add up to its total: ``count`` turns it on,
prints the report to stderr after its run and turns it off again
(:func:`stream_profile_stop`).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar


class StageTimes:
    """Seconds and entry counts per stage name, in first-seen order;
    ``exclusive`` takes the seconds of the stages opened inside a stage
    off its own."""

    def __init__(self, exclusive: bool = False):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.notes: dict[str, str] = {}  # what the record changed
        self.exclusive = exclusive
        self._inner: list[float] = []  # seconds of the open stages' children

    @contextmanager
    def stage(self, name: str, device: torch.device | str):
        from .._device import sync

        sync(device)
        t0 = time.perf_counter()
        self._inner.append(0.0)
        try:
            yield
        finally:
            sync(device)
            dt = time.perf_counter() - t0
            inner = self._inner.pop()
            if self._inner:
                self._inner[-1] += dt
            if self.exclusive:
                dt -= inner
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1


_ACTIVE: ContextVar[StageTimes | None] = ContextVar("unikmer_tpu_torch_stages",
                                                    default=None)
_PROFILE: StageTimes | None = None  # the stream profiler's recorder


@contextmanager
def record_stages():
    """Record the stages run inside the block; yields the StageTimes."""
    times = StageTimes()
    token = _ACTIVE.set(times)
    try:
        yield times
    finally:
        _ACTIVE.reset(token)


def stage(name: str, device: torch.device | str):
    """Context manager timing one stage on ``device`` (a torch.device or
    its name) when recording, else a no-op.  An open
    :func:`record_stages` block takes the record, else the stream
    profiler when it is on."""
    times = _ACTIVE.get() or _PROFILE
    return nullcontext() if times is None else times.stage(name, device)


def recording() -> bool:
    """Whether a :func:`stage` opened now would be recorded."""
    return (_ACTIVE.get() or _PROFILE) is not None


def note(key: str, text: str) -> None:
    """Keep ``text`` under ``key`` in the recorder that takes the stages
    (no-op when none does); the profiler's report prints it."""
    times = _ACTIVE.get() or _PROFILE
    if times is not None:
        times.notes[key] = text


def stream_profile_reset() -> None:
    """Turn the stream profiler on (UNIKMER_TPU_PROFILE_STREAM=1) or off
    and clear its table; call before a run."""
    global _PROFILE
    on = os.environ.get("UNIKMER_TPU_PROFILE_STREAM", "0") == "1"
    _PROFILE = StageTimes(exclusive=True) if on else None


def stream_profile_stop() -> None:
    """Turn the stream profiler off, so that later work in the process
    (the resident server's next request) records and synchronizes
    nothing."""
    global _PROFILE
    _PROFILE = None


def stream_profile_table() -> dict:
    """{phase: (total_s, calls)} recorded since the last reset."""
    if _PROFILE is None:
        return {}
    return {k: (v, _PROFILE.calls[k]) for k, v in _PROFILE.seconds.items()}


def stream_profile_report(out=None) -> None:
    """Print the table, longest phase first, in the JAX package's layout
    (to stderr by default), the record's notes on lines of their own
    before the total; nothing when the profiler is off or idle."""
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
    for key, text in _PROFILE.notes.items():
        print(f"#   ({key}: {text})", file=out)
    print(f"#   {'TOTAL(tracked)':<22} {total:8.3f}s", file=out)
