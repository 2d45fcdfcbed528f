"""sets.lookup_ms_per_op: device ms of the binary search kernels
(``torch.searchsorted``, ops/device_sets._lookup) over the requests
that ran an intersect or a subtract."""

SEARCH_KERNELS = ("searchsorted",)


def read(run):
    if run.trace is None:
        return None
    looked = sum(1 for r in run.requests if r["lookups"])
    us = sum(b - a for name, a, b in run.trace.kernels()
             if any(k in name for k in SEARCH_KERNELS))
    if not looked or us <= 0:
        return None
    return us / 1e3 / looked
