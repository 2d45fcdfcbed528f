"""sets.collapse_ms_per_op: device ms a request of the window's kernels
outside K2 and the binary search: the collapse and compaction of
ops/sort.py and ops/device_sets.py (plain torch), and the sign flips
and gathers around the search.  Copies and fills are not kernels."""

K2_KERNELS = ("radix_upfront_hist", "radix_bases", "radix_onesweep_pass",
              "radix_copy")
SEARCH_KERNELS = ("searchsorted",)


def read(run):
    if run.trace is None or not run.requests:
        return None
    us = sum(b - a for name, a, b in run.trace.kernels()
             if not any(k in name for k in K2_KERNELS + SEARCH_KERNELS))
    if us <= 0:
        return None
    return us / 1e3 / len(run.requests)
