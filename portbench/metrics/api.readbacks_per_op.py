"""api.readbacks_per_op: the program's ``readback`` spans in the window
(each host read of a device value in the KmerSet layer: a result's size,
``int(n)``, and ``contains``' answers), over the requests."""

from portbench.spans import window_spans


def read(run):
    spans = window_spans(run)
    if spans is None or not run.requests:
        return None
    return sum(1 for s in spans if s["name"] == "readback") / len(run.requests)
