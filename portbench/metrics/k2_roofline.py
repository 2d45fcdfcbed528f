"""k2_roofline: K2's share of its HBM bound over the window: 16 B for
each member entering a keys-only sort (the inputs' lengths, not their
padded capacity) at the peak rate, over the device time of the K2
kernels.  None where no K2 kernel ran."""

from portbench.peaks import HBM_BYTES_PER_S, sort_bytes

K2_KERNELS = ("radix_upfront_hist", "radix_bases", "radix_onesweep_pass",
              "radix_copy")


def read(run):
    if run.trace is None:
        return None
    k2_us = sum(b - a for name, a, b in run.trace.kernels()
                if any(k in name for k in K2_KERNELS))
    keys = sum(r["sort_members"] for r in run.requests)
    if k2_us <= 0 or keys <= 0:
        return None
    return 100.0 * (sort_bytes(keys) / HBM_BYTES_PER_S) / (k2_us / 1e6)
