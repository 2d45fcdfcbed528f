"""k2.passes_per_sort: the digit passes K2's plan ran per sort, read
after the window from the program's counters (``radix_sort_u64.
passes_run`` over ``radix_sort_u64.launches``).  Both count every K2
call of the process, not the window's alone: set-up's 64 counts and the
warm-up, about 3% of the calls, sort codes of the same width.  None on
the CPU, where no K2 launches."""


def read(run):
    from unikmer_tpu_torch.ops.radix_sort import radix_sort_u64

    launches = radix_sort_u64.launches
    if not launches:
        return None
    return radix_sort_u64.passes_run / launches
