"""Per-stage wall-clock timing of the count pipeline.

Off unless a caller opens :func:`record_stages`; then every
``with stage(name, device)`` block adds its seconds to the recorder.
Device work is asynchronous, so a recorded stage synchronizes the
device at both of its edges: the work a stage queued is charged to it,
at the price of the overlap between stages.  Unrecorded runs never
synchronize here.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar


class StageTimes:
    """Seconds and entry counts per stage name, in first-seen order."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextmanager
    def stage(self, name: str, device: torch.device | str):
        from .._device import sync

        sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(device)
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)
            self.calls[name] = self.calls.get(name, 0) + 1


_ACTIVE: ContextVar[StageTimes | None] = ContextVar("unikmer_tpu_torch_stages",
                                                    default=None)


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
    its name) when recording, else a no-op."""
    times = _ACTIVE.get()
    return nullcontext() if times is None else times.stage(name, device)
