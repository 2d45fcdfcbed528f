"""setup.load_s: the seconds the program's counters give to loading its
two libraries, the kernel library (``kernels.load_s``: nvcc's build
where the checkout has none, the dlopen) and the host library
(``native.load_s``: g++'s probes and build, the dlopen).  None where the
kernel library was not loaded (a CPU run)."""

from portbench.spans import counters


def read(run):
    c = counters()
    if c is None or "kernels.load_s" not in c:
        return None
    return c["kernels.load_s"] + c.get("native.load_s", 0.0)
