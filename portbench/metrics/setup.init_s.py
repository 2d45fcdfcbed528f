"""setup.init_s: the harness's span from its start until the port is
imported, the CUDA context made and the kernel and host libraries
loaded (built first, in a checkout's first run)."""


def read(run):
    return run.setup.get("init_s")
