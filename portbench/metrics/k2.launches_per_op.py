"""k2.launches_per_op: K2's launches over the window
(``radix_sort_u64.launches``, the program's counter) per request; 0
where the mix bypasses the sort."""


def read(run):
    if not run.requests or "k2_launches" not in run.counters:
        return None
    return run.counters["k2_launches"] / len(run.requests)
