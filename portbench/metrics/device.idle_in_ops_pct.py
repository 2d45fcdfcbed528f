"""device.idle_in_ops_pct: 100 x the window's idle time on the card that
lies inside the program's root operation spans (``KmerSet.<op>`` with no
parent), over the window; the rest of ``device.idle_pct`` falls between
operations, in the harness."""

from portbench.spans import idle_inside_pct, window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    return idle_inside_pct(run, [s for s in spans if s["parent"] is None
                                 and s["name"].startswith("KmerSet.")])
