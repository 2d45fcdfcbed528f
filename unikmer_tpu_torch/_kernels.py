"""Build and load the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface and are bound with ctypes: nvcc
compiles every ``csrc/*.cu`` into one shared library at first use, under
``build/unikmer_tpu_torch/`` beside the package.  The library's name
carries a hash of the sources and the flags, so an edited source is
rebuilt instead of loading a stale library.  nvcc is found through
``torch.utils.cpp_extension.CUDA_HOME`` or ``PATH``; without it,
loading raises.  Nothing here runs at import time.

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
              "-shared", "-Xcompiler", "-fPIC")

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


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
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
