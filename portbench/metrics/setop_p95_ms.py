"""setop_p95_ms: the 95th percentile, by nearest rank, of every
request's time in the window, by the host's clock from the call to its
result complete on the card (after the harness's synchronise)."""

from portbench.records import nearest_rank


def read(run):
    if not run.requests:
        return None
    return nearest_rank([r["latency_ms"] for r in run.requests], 0.95)
