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
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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
    lib.ukt_radix_tile.restype = i32
    lib.ukt_radix_tile.argtypes = []
    lib.ukt_radix_hist.restype = i32
    lib.ukt_radix_hist.argtypes = [p, i64, i32, i32, p, i64, p]
    lib.ukt_radix_scatter.restype = i32
    lib.ukt_radix_scatter.argtypes = [p, p, i64, i32, i32, p, i64, p]
    lib.ukt_radix_scatter_kv.restype = i32
    lib.ukt_radix_scatter_kv.argtypes = [p, p, p, p, i64, i32, i32, p, i64, p]
    lib.ukt_copy_inc_u32.restype = i32
    lib.ukt_copy_inc_u32.argtypes = [p, p, i64, p]
    lib.ukt_row_cmpex_u32.restype = i32
    lib.ukt_row_cmpex_u32.argtypes = [p, p, i64, i64, p, i64, p]
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
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = lib.ukt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
