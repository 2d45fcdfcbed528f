"""device.idle_admit_pct: 100 x the window's idle time on the card that
lies inside the program's ``admit`` spans (the admission's free-bytes
read), over the window."""

from portbench.spans import idle_inside_pct, window_spans


def read(run):
    spans = window_spans(run)
    if spans is None:
        return None
    return idle_inside_pct(run, [s for s in spans if s["name"] == "admit"])
