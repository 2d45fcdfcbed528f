"""unikmer_tpu_torch — the k-mer engine on PyTorch and CUDA (NVIDIA Hopper).

The second package beside ``unikmer_tpu``: the same ``count``, ``union``,
``inter``, ``diff`` and ``common`` outputs, the same ``.unik`` bytes and
the same ``KmerSet`` library API, with the device layer written in
PyTorch and the hot kernels written by hand in CUDA C++ for ``sm_90a``.

It imports ``torch`` and never ``jax``, and nothing of ``unikmer_tpu``:
the host layers it needs (FASTA ingest, the native host library, the
``.unik`` writer and reader, the host set engine, the low-complexity
filter, the external-sort spill, the taxdump, the CLI options) are its
own copies.

Layer map (bottom-up, mirroring ``unikmer_tpu``):
  _device.py   device choice (UNIKMER_TPU_TORCH_DEVICE)
  csrc/        hand-written CUDA kernels (K1 encode, H1 ntHash encode,
               S1 sketch select, K2/K3 radix sorts, the P1/P2 probes)
  native/      the host C++ library (g++, ctypes; numpy branches)
  io/          FASTA/Q ingest, .unik writer/reader, varint-GB, gzip
  ops/         codec, encode (K1), nthash (H1), sketch (S1), radix_sort
               (K2, K3), sort and collapse, device_sets (set algebra on
               the device), sets (the host set engine), filter, probes
  taxonomy/    taxdump (host LCA), the device LCA planner and collapse,
               the tree-walk LCA
  pipeline/    external-sort spill
  models/      the count pipeline: pack, H2D, encode, sort, collapse, D2H
  api.py       KmerSet: device-resident sets and their algebra
  cli/         the ``count``, ``union``, ``inter``, ``diff`` and
               ``common`` subcommands
  probes.py    the P1/P2 probe sequence (python -m unikmer_tpu_torch.probes)
  utils/       logging, per-stage timing
"""

import os as _os

# numpy madvises MADV_HUGEPAGE on every buffer >= 4 MB; on virtualized
# hosts a 2 MB huge fault can cost ~100 ms, a large tax on first touch
# of every big host temp.  Turn it off (a runtime switch, effective
# even when numpy is already imported); UNIKMER_TPU_HUGEPAGE=1 keeps
# numpy's default.
if _os.environ.get("UNIKMER_TPU_HUGEPAGE") != "1":
    _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")  # subprocesses
    try:
        try:
            from numpy._core import multiarray as _ma
        except ImportError:  # numpy < 2
            from numpy.core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except Exception:  # private API: best-effort
        pass

# Keep large freed allocations on the heap instead of returning pages to
# the OS: with glibc's default mmap threshold every multi-hundred-MB
# numpy temp is a fresh mmap that faults its pages again.  Raising
# M_MMAP_THRESHOLD / M_TRIM_THRESHOLD makes pages fault once and be
# reused.  PR_SET_THP_DISABLE (= 41) turns transparent huge pages off
# for the whole process: the madvise switch above only stops new
# MADV_HUGEPAGE calls, and areas marked before it ran keep collapsing.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.mallopt(-3, 1 << 31)  # M_MMAP_THRESHOLD
    _libc.mallopt(-1, 1 << 31)  # M_TRIM_THRESHOLD
    if _os.environ.get("UNIKMER_TPU_HUGEPAGE") != "1":
        _libc.prctl(41, 1, 0, 0, 0)  # PR_SET_THP_DISABLE
except (OSError, AttributeError):  # non-glibc platforms: best-effort
    pass

__version__ = "0.1.0"


def __getattr__(name):
    # KmerSet loads lazily, so importing the package stays cheap
    if name == "KmerSet":
        from .api import KmerSet

        return KmerSet
    raise AttributeError(name)


# Version of the reference toolkit whose behavior is reproduced.
REFERENCE_VERSION = "0.21.0"
