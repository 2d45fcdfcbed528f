"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface and are bound with ctypes: at first
use nvcc compiles every ``csrc/*.cu`` into an object, one nvcc process
per source, all started together, and links them into one shared
library under ``build/unikmer_tpu_torch/`` beside the package.  A fresh
checkout builds before its first launch, so the build takes the time of
the slowest source rather than the sum as ``csrc/`` grows.  The
library's name carries a hash of the sources and the flags, so an
edited source is rebuilt instead of loading a stale library.  nvcc is
found through ``torch.utils.cpp_extension.CUDA_HOME`` or ``PATH``;
without it, loading raises.  Nothing here runs at import time.

Every C entry point launches on the stream it is given, allocates
nothing and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.  Wrappers launch through a
:class:`Kernel`, one per entry point, which binds its C function once and
passes the raw current stream of the tensors' device.

utils/stages.py counts the load's seconds (``kernels.load_s``: the
build, the dlopen and the binding).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ._lazy import torch
from .utils import stages

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "unikmer_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """Path of nvcc: CUDA_HOME/bin/nvcc, else the first on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (neither CUDA_HOME/bin/nvcc nor on PATH): the CUDA "
        "kernels of unikmer_tpu_torch cannot be built"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libunikmer_tpu_torch_{_source_hash()}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ukt_error_string.restype = ctypes.c_char_p
    lib.ukt_error_string.argtypes = [i32]
    lib.ukt_encode_2bit.restype = i32
    lib.ukt_encode_2bit.argtypes = [p, i64, p, i64, i64, i32, i32, p, p, p]
    lib.ukt_encode_nthash.restype = i32
    lib.ukt_encode_nthash.argtypes = [p, i64, p, i64, i64, i32, i32,
                                      ctypes.c_uint64, p, p, p]
    lib.ukt_sketch_select.restype = i32
    lib.ukt_sketch_select.argtypes = [i32, p, p, p, i64, i32, ctypes.c_uint64,
                                      p, p, p]
    lib.ukt_radix_tile.restype = i32
    lib.ukt_radix_tile.argtypes = []
    lib.ukt_radix_upfront.restype = i32
    lib.ukt_radix_upfront.argtypes = [p, i64, i32, i32, p, p, p, p, p]
    lib.ukt_radix_onesweep.restype = i32
    lib.ukt_radix_onesweep.argtypes = [p, p, p, p, p, p, i64, i32, i32, p, p,
                                       p, i64, p]
    lib.ukt_collapse_tile.restype = i32
    lib.ukt_collapse_tile.argtypes = []
    lib.ukt_collapse.restype = i32
    lib.ukt_collapse.argtypes = [p, p, p, i32, i64, i32, i64, p, p, p, p, p,
                                 i64, p]
    lib.ukt_copy_inc_u32.restype = i32
    lib.ukt_copy_inc_u32.argtypes = [p, p, i64, p]
    lib.ukt_row_cmpex_u32.restype = i32
    lib.ukt_row_cmpex_u32.argtypes = [p, p, i64, i64, p, i64, p, p]
    lib.ukt_transpose128_u32.restype = i32
    lib.ukt_transpose128_u32.argtypes = [p, p, i64, p]
    lib.ukt_lane_cmpex_u32.restype = i32
    lib.ukt_lane_cmpex_u32.argtypes = [p, p, i64, p]


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises when nvcc is
    missing or the build fails; never returns None."""
    global _lib
    with _lock:
        if _lib is None:
            with stages.timed("kernels.load_s"):
                lib = ctypes.CDLL(str(build()))
                _bind(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.ukt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


class Kernel:
    """One C entry point of the library, launched on the current stream of
    a device.  The C function is resolved at the first call, and again
    only when ``_lib`` is replaced (a test swaps in a fake or a fresh
    build), so a launch takes no lock and looks up no symbol.  The
    stream is torch's raw current-stream handle of the device, read
    without building a ``torch.cuda.Stream``; the current device is
    switched only when the tensors lie on another one."""

    __slots__ = ("name", "_lib", "_fn")

    def __init__(self, name: str):
        self.name = name
        self._lib = self._fn = None

    def bound(self):
        """The C function in the library in use (built on first use)."""
        if self._lib is None or self._lib is not _lib:
            lib = load()
            self._fn = getattr(lib, self.name)
            self._lib = lib
        return self._fn

    def __call__(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream: the C function takes
        ``args`` and the stream; raises if it returns an error."""
        fn = self.bound()
        index = device.index
        if torch._C._cuda_getDevice() == index:
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        check(self._lib, err, self.name)
