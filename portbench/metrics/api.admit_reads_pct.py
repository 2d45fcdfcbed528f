"""api.admit_reads_pct: 100 x the program's admissions that read the
card's free bytes (``torch.cuda.mem_get_info``) over its admissions
against a card's budget, from the counters ``admit.reads`` and
``admit.calls``, read after the window.  Both count every admission of
the process, not the window's alone: set-up's and the warm-up's too.
None where the program keeps no such counters or admitted nothing on a
card (a CPU run)."""

from portbench.spans import counters


def read(run):
    c = counters()
    if c is None or not c.get("admit.calls"):
        return None
    return 100.0 * c.get("admit.reads", 0) / c["admit.calls"]
