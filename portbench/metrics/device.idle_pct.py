"""device.idle_pct: the share of the window in which no kernel, copy or
fill ran on the card, 100 x (1 - their union over the window's span)."""

from portbench.records import busy_us


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    span = run.trace.end - run.trace.start
    return 100.0 * (1.0 - busy_us(run.trace) / span)
