"""api.syncs_per_op: the CUDA runtime and cu* API calls that make the
host wait (stream, device and event synchronise, synchronous copies)
in the window, less the harness's own device synchronise at the end of
each request, over the requests: the program's read-backs (``int(n)``
of a result's size) and waits a request."""

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
              "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2", "cuMemcpy")


def read(run):
    if run.trace is None or not run.requests:
        return None
    waits = sum(1 for name, _, _ in run.trace.calls if name in SYNC_CALLS)
    if waits == 0:
        return None
    return (waits - len(run.requests)) / len(run.requests)
