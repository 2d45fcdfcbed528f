"""ctypes bindings for the port's native host library (host_native.cpp).

g++ compiles ``host_native.cpp`` at first use into
``build/unikmer_tpu_torch/`` beside the package, under a name keyed by
a hash of the source, the flags and the compiler's version, so an
edited source, or a copy of the tree on another host, is rebuilt
instead of loading a stale library.  One ``g++ -E`` probe decides
whether ``<zlib.h>`` is there: with it the fused FASTA loader inflates
gzip files itself and the ``.unik`` gzip members are deflated and
inflated here (``pgz_compress_member``, ``pgz_inflate_all``), without it
those go through Python's readers and zlib.

This is host code, not a device kernel.  Every entry point has a numpy
branch: the functions return None (or take the numpy path) when g++ is
missing, the build fails, or ``UNIKMER_TPU_NO_NATIVE=1``.

utils/stages.py counts the load's seconds (``native.load_s``: the
compiler probes, the build and the dlopen).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..utils import stages

SOURCE = Path(__file__).resolve().parent / "host_native.cpp"
BUILD_DIR = SOURCE.parents[2] / "build" / "unikmer_tpu_torch"
# no -march=native: the library's name does not track the host's CPU
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")

_lock = threading.Lock()
_lib = None  # None: not tried yet; False: unavailable


def _has_zlib(cxx: str) -> bool:
    res = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                         input="#include <zlib.h>\n", capture_output=True,
                         text=True)
    return res.returncode == 0


def _build() -> Path | None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    flags = list(CXX_FLAGS)
    libs = []
    if _has_zlib(cxx):
        flags.append("-DUKT_HAVE_ZLIB")
        libs.append("-lz")
    version = subprocess.run([cxx, "-dumpfullversion"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(" ".join([version, *flags, *libs]).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libukt_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE), *libs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, or None when unavailable (no g++, a failed
    build, or UNIKMER_TPU_NO_NATIVE=1: every caller has a numpy branch)."""
    global _lib
    if os.environ.get("UNIKMER_TPU_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is None:
            _lib = False
            with stages.timed("native.load_s"):
                path = _build()
                if path is not None:
                    lib = ctypes.CDLL(str(path))
                    _bind(lib)
                    _lib = lib
        return _lib or None


def engine() -> str:
    """Which host engine runs: the native library (and whether it
    inflates gzip itself) or numpy."""
    lib = get_lib()
    if lib is None:
        return "numpy"
    return f"native ({'zlib' if lib.ukt_have_zlib() else 'no zlib'})"


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    i64p = ctypes.POINTER(i64)
    lib.ukt_have_zlib.restype = i32
    lib.ukt_have_zlib.argtypes = []
    lib.gb64_encode_deltas.restype = ctypes.c_size_t
    lib.gb64_encode_deltas.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_uint64, u8p, ctypes.c_size_t,
    ]
    lib.unik_encode_sorted_blocks.restype = i64
    lib.unik_encode_sorted_blocks.argtypes = [
        u64p, u32p, i64, i64, i32, u8p, i64, i32,
    ]
    lib.pack_bases_2bit_native.restype = None
    lib.pack_bases_2bit_native.argtypes = [
        u8p, ctypes.c_size_t, u8p, u8p, ctypes.c_int,
    ]
    for op in ("union", "inter", "diff"):
        fn = getattr(lib, f"set2_{op}_u64")
        fn.restype = i64
        fn.argtypes = [u64p, i64, u64p, i64, u64p, i32]
    lib.member_mask_sorted_u64.restype = None
    lib.member_mask_sorted_u64.argtypes = [u64p, i64, u64p, i64, u8p, i64p,
                                           i32]
    lib.unik_scan_blocks.restype = i64
    lib.unik_scan_blocks.argtypes = [u8p, i64]
    lib.unik_decode_sorted_blocks.restype = i64
    lib.unik_decode_sorted_blocks.argtypes = [u8p, i64, i32, u64p, u32p, i64,
                                              i32]
    lib.msd_partition_u64.restype = i32
    lib.msd_partition_u64.argtypes = [u64p, i64, i32, i64p, i32]
    lib.radix_sort_u64.restype = i32
    lib.radix_sort_u64.argtypes = [u64p, i64, i32]
    lib.radix_sort_u64_u32.restype = i32
    lib.radix_sort_u64_u32.argtypes = [u64p, u32p, i64, i32]
    lib.radix_sort_u64_u64.restype = i32
    lib.radix_sort_u64_u64.argtypes = [u64p, u64p, i64, i32]
    lib.fastx_load.restype = ctypes.POINTER(FastxPackStruct)
    lib.fastx_load.argtypes = [ctypes.c_char_p, i64, i32, i64]
    lib.fastx_pack_free.restype = None
    lib.fastx_pack_free.argtypes = [ctypes.POINTER(FastxPackStruct)]
    lib.render_kmer_lines.restype = i64
    lib.render_kmer_lines.argtypes = [u64p, i64, i32, u8p]
    lib.render_kmer_u64_lines.restype = i64
    lib.render_kmer_u64_lines.argtypes = [u64p, u64p, i64, i32, u8p]
    lib.render_u64_lines.restype = i64
    lib.render_u64_lines.argtypes = [u64p, i64, u8p]
    lib.render_u64_pair_lines.restype = i64
    lib.render_u64_pair_lines.argtypes = [u64p, u64p, i64, u8p]
    lib.decode_codes_ascii.restype = None
    lib.decode_codes_ascii.argtypes = [u64p, i64, i32, u8p]
    lib.parse_code_lines.restype = i64
    lib.parse_code_lines.argtypes = [u8p, i64, i32, i32, i32, u64p, u32p,
                                     i64]
    lib.encode_windows_u64.restype = i64
    lib.encode_windows_u64.argtypes = [u8p, i64, i32, i32, u64p, i32]
    lib.nthash_windows_u64.restype = i64
    lib.nthash_windows_u64.argtypes = [u8p, i64, i32, i32, ctypes.c_uint32,
                                       u64p, i32]
    for name in ("minimizer_emit_u64", "syncmer_emit_u64",
                 "syncmer_compat_emit_u64"):
        fn = getattr(lib, name)
        fn.restype = i64
        fn.argtypes = [u8p, i64, i32, i32, u64p]
    lib.pgz_indexed_isize.restype = i64
    lib.pgz_indexed_isize.argtypes = [u8p, i64]
    lib.pgz_compress_member.restype = i64
    lib.pgz_compress_member.argtypes = [u8p, i64, i32, u8p, i64]
    lib.pgz_inflate_parallel.restype = i64
    lib.pgz_inflate_parallel.argtypes = [u8p, i64, u8p, i64, i32]


class FastxPackStruct(ctypes.Structure):
    _fields_ = [
        ("bases", ctypes.POINTER(ctypes.c_uint8)),
        ("n_bases", ctypes.c_int64),
        ("starts", ctypes.POINTER(ctypes.c_int64)),
        ("lengths", ctypes.POINTER(ctypes.c_int64)),
        ("n_records", ctypes.c_int64),
        ("ids", ctypes.POINTER(ctypes.c_uint8)),
        ("id_offs", ctypes.POINTER(ctypes.c_int64)),
        ("fastq", ctypes.c_int32),
        ("err", ctypes.c_char * 256),
    ]


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


_FAIL = (1 << 64) - 1 if ctypes.sizeof(ctypes.c_size_t) == 8 else (1 << 32) - 1

_THREADS_OVERRIDE = 0


def set_threads(n: int) -> None:
    """Cap native threads (the CLI's -j flag)."""
    global _THREADS_OVERRIDE
    _THREADS_OVERRIDE = max(int(n), 0)


def _threads() -> int:
    if _THREADS_OVERRIDE > 0:
        return _THREADS_OVERRIDE
    return min(os.cpu_count() or 1, 8)


def encode_deltas_gb64(vals: np.ndarray, prev: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    n = len(vals)
    if n == 0:
        return b""
    cap = 2 * ((n + 3) // 4) + 8 * n
    out = np.empty(cap, np.uint8)
    written = lib.gb64_encode_deltas(_u64p(vals), n, prev, _u8p(out), cap)
    if written == _FAIL:
        return None
    return out[:written].tobytes()


def encode_sorted_blocks(codes: np.ndarray, taxids: np.ndarray | None,
                         taxid_w: int, block_elems: int,
                         threads: int = 0) -> bytes | None:
    """Concurrent encode of sorted codes (+ optional taxid column) into
    the full framed block region (io/unik.py, minor version 1).  None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint64)
    n = len(codes)
    if n == 0:
        return b""
    if taxid_w:
        taxids = np.ascontiguousarray(taxids, np.uint32)
    else:
        taxids = np.zeros(1, np.uint32)
    nblocks = (n + block_elems - 1) // block_elems
    worst = 2 * ((block_elems + 3) // 4) + (8 + taxid_w) * block_elems
    out = np.empty(nblocks * (8 + worst), np.uint8)
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 8)
    w = lib.unik_encode_sorted_blocks(
        _u64p(codes), _u32p(taxids), n, block_elems, taxid_w, _u8p(out),
        len(out), threads,
    )
    if w < 0:
        return None
    return out[:w].tobytes()


def pack_bases_2bit(bases: np.ndarray, threads: int = 4):
    """(packed2 u8 ceil(n/4), validmask u8 ceil(n/8)): the 2-bit
    device-ingress pack, bit-identical to the numpy formulation in
    models/count.  None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    b = np.ascontiguousarray(bases, np.uint8)
    n = len(b)
    packed2 = np.empty(-(-n // 4) if n else 0, np.uint8)
    validmask = np.empty(-(-n // 8) if n else 0, np.uint8)
    if n:
        lib.pack_bases_2bit_native(_u8p(b), n, _u8p(packed2),
                                   _u8p(validmask), threads)
    return packed2, validmask


def set2_sorted(op: str, a: np.ndarray, b: np.ndarray,
                trim: bool = True) -> np.ndarray | None:
    """union/inter/diff of two sorted u64 arrays (duplicates collapsed),
    range-partitioned across threads; None without the native library.
    ``trim=False`` returns a view into the oversized output buffer, for
    intermediates that are consumed at once."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint64)
    b = np.ascontiguousarray(b, np.uint64)
    out = np.empty(len(a) + len(b), np.uint64)
    fn = getattr(lib, f"set2_{op}_u64")
    n = fn(_u64p(a), len(a), _u64p(b), len(b), _u64p(out), _threads())
    return out[:n].copy() if trim else out[:n]


def set2_union(a: np.ndarray, b: np.ndarray,
               trim: bool = True) -> np.ndarray | None:
    """:func:`set2_sorted` ``("union", a, b)``."""
    return set2_sorted("union", a, b, trim)


def member_mask_sorted(ref: np.ndarray, queries: np.ndarray,
                       want_idx: bool = True):
    """(mask bool, idx i64) of each sorted query in sorted ref; parallel
    two-pointer join.  None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    ref = np.ascontiguousarray(ref, np.uint64)
    queries = np.ascontiguousarray(queries, np.uint64)
    mask = np.empty(len(queries), np.uint8)
    idx = np.zeros(len(queries), np.int64) if want_idx else None
    lib.member_mask_sorted_u64(
        _u64p(ref), len(ref), _u64p(queries), len(queries), _u8p(mask),
        None if idx is None else _i64p(idx), _threads())
    return mask.view(bool), idx


def decode_sorted_blocks(buf: bytes, taxid_w: int, threads: int = 0):
    """Concurrent decode of a whole sorted .unik block region (minor
    version >= 1, io/unik.py layout): (codes u64, taxids u32 or None),
    or None without the native library.  Raises ValueError on corrupt
    framing."""
    lib = get_lib()
    if lib is None:
        return None
    inp = np.frombuffer(buf, np.uint8)
    total = lib.unik_scan_blocks(_u8p(inp), len(buf))
    if total < 0:
        raise ValueError("truncated .unik block")
    if total == 0:
        return np.zeros(0, np.uint64), (
            np.zeros(0, np.uint32) if taxid_w else None)
    codes = np.empty(int(total), np.uint64)
    taxids = np.empty(int(total) if taxid_w else 1, np.uint32)
    got = lib.unik_decode_sorted_blocks(
        _u8p(inp), len(buf), taxid_w, _u64p(codes), _u32p(taxids),
        int(total), threads if threads > 0 else _threads())
    if got != total:
        raise ValueError("truncated .unik block")
    return codes, (taxids if taxid_w else None)


def sort_u64_kv(keys: np.ndarray, vals: np.ndarray):
    """(sorted_keys, co-sorted_vals) by stable parallel radix on keys
    (vals uint32 or uint64; other dtypes round-trip through uint64).
    None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    if len(keys) != len(vals):
        raise ValueError("keys and vals must have equal length")
    ks = np.array(keys, dtype=np.uint64, copy=True, order="C")
    if vals.dtype == np.uint32:
        vs = np.array(vals, dtype=np.uint32, copy=True, order="C")
        rc = lib.radix_sort_u64_u32(_u64p(ks), _u32p(vs), len(ks), _threads())
        return (ks, vs) if rc == 0 else None
    orig = vals.dtype
    vs = np.array(vals, dtype=np.uint64, copy=True, order="C")
    if lib.radix_sort_u64_u64(_u64p(ks), _u64p(vs), len(ks),
                              _threads()) != 0:
        return None
    return ks, (vs if orig == np.uint64 else vs.astype(orig))


# Below this element count the ctypes round trip and copies cost more
# than numpy's sort.
_HOST_SORT_MIN = 1 << 15
# Above this, one parallel MSD-partition pass + per-bucket numpy sorts
# (GIL released) beat single-thread np.sort.
_HOST_SORT_PARTITION_MIN = 1 << 23


def _partitioned_sort(codes: np.ndarray) -> np.ndarray | None:
    """Sorted copy via one native MSD pass on the top significant byte
    (256 value-range buckets) and numpy's sort per bucket slice, 4
    slices at a time.  None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    mx = int(codes.max()) if len(codes) else 0
    if mx == 0:
        return np.zeros_like(codes)
    shift = max((mx.bit_length() - 1) // 8, 0) * 8
    out = np.array(codes, dtype=np.uint64, copy=True, order="C")
    offsets = np.zeros(257, np.int64)
    if lib.msd_partition_u64(_u64p(out), len(out), shift, _i64p(offsets),
                             _threads()) != 0:
        return None
    slices = [out[offsets[d]:offsets[d + 1]] for d in range(256)
              if offsets[d + 1] - offsets[d] > 1]
    with ThreadPoolExecutor(max_workers=min(_threads(), 4)) as ex:
        list(ex.map(lambda s: s.sort(), slices))
    return out


def host_sort(codes: np.ndarray) -> np.ndarray:
    """Sorted copy of a uint64 array: numpy's sort, fanned out over
    threads by one native MSD partition for large arrays."""
    if codes.dtype == np.uint64 and len(codes) >= _HOST_SORT_PARTITION_MIN:
        out = _partitioned_sort(codes)
        if out is not None:
            return out
    return np.sort(codes)


def host_sort_kv(keys: np.ndarray, vals: np.ndarray):
    """(sorted_keys, co-sorted_vals), stable in keys: native radix when
    available, argsort + gather otherwise.  Never returns None."""
    if keys.dtype == np.uint64 and len(keys) >= _HOST_SORT_MIN:
        res = sort_u64_kv(keys, vals)
        if res is not None:
            return res
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def host_argsort(keys: np.ndarray):
    """(sorted_keys, perm) with keys[perm] == sorted_keys, stable, for
    callers gathering several companion columns (perm uint64 from the
    native radix, int64 from numpy; both index numpy arrays)."""
    if keys.dtype == np.uint64 and len(keys) >= _HOST_SORT_MIN:
        res = sort_u64_kv(keys, np.arange(len(keys), dtype=np.uint64))
        if res is not None:
            return res
    order = np.argsort(keys, kind="stable")
    return keys[order], order


def load_fastx_packed(path: str, k: int, circular: bool = False,
                      max_text: int = 0):
    """Fused native ingest: file -> inflate -> parse -> packed base codes.

    Returns (bases u8, starts i64, lengths i64, ids list[bytes]) in the
    exact io/fastx.pack_records layout, or None when the native library
    is unavailable, the decompressed text exceeds ``max_text`` bytes
    (> 0), or the file is gzip and the build has no zlib (the caller
    then streams it through the Python reader).  Raises ValueError on
    malformed input.
    """
    lib = get_lib()
    if lib is None:
        return None
    p = lib.fastx_load(path.encode(), k, 1 if circular else 0, max_text)
    try:
        s = p.contents
        if s.err in (b"TOO_LARGE", b"GZIP_UNSUPPORTED"):
            return None
        if s.err:
            raise ValueError(f"{path}: {s.err.decode()}")
        n = int(s.n_records)
        if n == 0:
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int64), [])
        bases = np.ctypeslib.as_array(s.bases, (int(s.n_bases),)).copy()
        starts = np.ctypeslib.as_array(s.starts, (n,)).copy()
        lengths = np.ctypeslib.as_array(s.lengths, (n,)).copy()
        offs = np.ctypeslib.as_array(s.id_offs, (n + 1,))
        blob = (np.ctypeslib.as_array(s.ids, (int(offs[-1]),)).tobytes()
                if int(offs[-1]) else b"")
        ids = [blob[offs[i]:offs[i + 1]] for i in range(n)]
        return bases, starts, lengths, ids
    finally:
        lib.fastx_pack_free(p)


def render_lines(codes: np.ndarray, k: int | None,
                 vals: np.ndarray | None = None) -> bytes | None:
    """Text lines for view: '<kmer>\\n', '<kmer>\\t<val>\\n' (k set),
    or '<val>\\n' / '<a>\\t<b>\\n' (k None).  None -> numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes)
    if n == 0:
        return b""
    codes = np.ascontiguousarray(codes, np.uint64)
    if vals is not None:
        vals = np.ascontiguousarray(vals, np.uint64)
    if k is not None:
        if vals is None:
            out = np.empty(n * (k + 1), np.uint8)
            ln = lib.render_kmer_lines(_u64p(codes), n, k, _u8p(out))
        else:
            out = np.empty(n * (k + 22), np.uint8)
            ln = lib.render_kmer_u64_lines(_u64p(codes), _u64p(vals), n, k,
                                           _u8p(out))
    else:
        if vals is None:
            out = np.empty(n * 21, np.uint8)
            ln = lib.render_u64_lines(_u64p(codes), n, _u8p(out))
        else:
            out = np.empty(n * 42, np.uint8)
            ln = lib.render_u64_pair_lines(_u64p(codes), _u64p(vals), n,
                                           _u8p(out))
    return out[:ln].tobytes()


def decode_codes_ascii(codes: np.ndarray, k: int) -> np.ndarray | None:
    """(n, k) ASCII matrix of k-mer strings; None -> numpy fallback."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint64)
    out = np.empty((len(codes), k), np.uint8)
    lib.decode_codes_ascii(_u64p(codes), len(codes), k, _u8p(out))
    return out


def parse_code_lines(text: bytes, kmer_mode: bool, k: int, has_taxid: bool):
    """Bulk-parse '<token>[\\t<int>]' lines (dump's hot loop).

    Returns (codes u64, taxids u32 or None), or None when the native
    library is unavailable, or an int byte-offset of the first malformed
    line (the caller falls back to the per-line parser for exact errors).
    """
    lib = get_lib()
    if lib is None:
        return None
    inp = np.frombuffer(text, np.uint8)
    cap = text.count(b"\n") + 2
    codes = np.empty(cap, np.uint64)
    taxids = np.empty(cap if has_taxid else 1, np.uint32)
    n = lib.parse_code_lines(
        _u8p(inp), len(inp), 0 if kmer_mode else 1, k,
        1 if has_taxid else 0, _u64p(codes), _u32p(taxids), cap,
    )
    if n < 0:
        return int(-n - 1)  # byte offset of the offending line
    return codes[:n].copy(), (taxids[:n].copy() if has_taxid else None)


def encode_windows(bases: np.ndarray, k: int,
                   canonical: bool) -> np.ndarray | None:
    """All valid k-mer window codes of a packed base buffer (0..3 valid,
    >=4 resets the window), in genome order: the host count engine's hot
    loop (encode_windows_u64).  None without the library or for k
    outside [1, 32]."""
    lib = get_lib()
    if lib is None or not (1 <= k <= 32):
        return None
    bases = np.ascontiguousarray(bases, np.uint8)
    n = len(bases)
    if n == 0:
        return np.zeros(0, np.uint64)
    out = np.empty(n, np.uint64)
    m = lib.encode_windows_u64(
        _u8p(bases), n, k, 1 if canonical else 0, _u64p(out), _threads()
    )
    return out[:m]


def nthash_windows(bases: np.ndarray, k: int, canonical: bool,
                   scale: int = 1) -> np.ndarray | None:
    """ntHash v1 of all valid windows (genome order, invalid bases reset
    the window); scale > 1 keeps hashes <= scaled_max_hash(scale)
    (FracMinHash).  None without the library or for k outside [1, 64]."""
    lib = get_lib()
    if lib is None or not (1 <= k <= 64):
        return None
    bases = np.ascontiguousarray(bases, np.uint8)
    n = len(bases)
    if n == 0:
        return np.zeros(0, np.uint64)
    out = np.empty(n, np.uint64)
    m = lib.nthash_windows_u64(
        _u8p(bases), n, k, 1 if canonical else 0,
        scale if scale > 1 else 1, _u64p(out), _threads()
    )
    if m * 2 < n:
        return out[:m].copy()  # scaled filter kept few: release the 8n buffer
    return out[:m]


def sketch_emit(bases: np.ndarray, k: int, w_or_s: int,
                kind: str) -> np.ndarray | None:
    """Linear minimizer or closed-syncmer emission stream of canonical
    ntHash (the host twins of ops/sketch's minimizer, closed syncmer and
    compat rules); kind is "minimizer", "syncmer" or "syncmer_compat".
    None without the library or for k outside [1, 64]."""
    lib = get_lib()
    if lib is None or not (1 <= k <= 64):
        return None
    bases = np.ascontiguousarray(bases, np.uint8)
    n = len(bases)
    if n < k:
        return np.zeros(0, np.uint64)
    out = np.empty(n, np.uint64)
    fn = {
        "minimizer": lib.minimizer_emit_u64,
        "syncmer": lib.syncmer_emit_u64,
        "syncmer_compat": lib.syncmer_compat_emit_u64,
    }[kind]
    m = fn(_u8p(bases), n, k, w_or_s, _u64p(out))
    if m * 2 < n:
        return out[:m].copy()
    return out[:m]


def pgz_compress_member(data, level: int) -> bytes | None:
    """One UK-indexed gzip member of ``data`` (io/pgzip.py's layout), the
    bytes that io/pgzip's Python route makes, deflated by zlib without
    the GIL; None without the library or its zlib, and at level 0 (whose
    stored blocks only Python's own output buffers cut the same way)."""
    lib = get_lib()
    if lib is None:
        return None
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(28 + len(inp) + (len(inp) >> 3) + 256, np.uint8)
    w = lib.pgz_compress_member(_u8p(inp), len(inp), level, _u8p(out),
                                len(out))
    if w < 0:
        return None
    return out[:w].tobytes()


def pgz_inflate_all(raw, threads: int = 0) -> bytes | None:
    """Inflate a UK-indexed multi-member gzip buffer, its members on
    ``threads`` threads (0: min(cpus, 8)) each through zlib, which checks
    their CRC-32 and length.  None when the library or its zlib is
    missing, a member lacks the index, the buffer is truncated or a
    member fails its checks: the caller reads the buffer sequentially."""
    lib = get_lib()
    if lib is None or len(raw) == 0:
        return None
    inp = np.frombuffer(raw, np.uint8)
    total = lib.pgz_indexed_isize(_u8p(inp), len(inp))
    if total < 0:
        return None
    if threads <= 0:
        threads = min(os.cpu_count() or 1, 8)
    out = np.empty(int(total), np.uint8)
    got = lib.pgz_inflate_parallel(_u8p(inp), len(inp), _u8p(out),
                                   int(total), threads)
    if got != total:
        return None
    return out.tobytes()
