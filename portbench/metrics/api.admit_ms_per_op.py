"""api.admit_ms_per_op: the host ms of the program's ``admit`` spans in
the window (the admission's free-bytes read, ``torch.cuda.mem_get_info``
in ops/device_sets._device_free_bytes), over the requests."""

from portbench.spans import window_spans


def read(run):
    spans = window_spans(run)
    if spans is None or not run.requests:
        return None
    us = sum(s["te"] - s["ts"] for s in spans if s["name"] == "admit")
    return us / 1e3 / len(run.requests)
