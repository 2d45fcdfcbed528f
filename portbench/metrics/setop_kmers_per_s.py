"""setop_kmers_per_s: the members of every input set of every set
operation completed in the window, over the window's seconds (host
clock), all the work over all the time."""


def read(run):
    if not run.requests or run.window_s <= 0:
        return None
    return sum(r["members"] for r in run.requests) / run.window_s
