"""Host count engine: the native window kernels and the host sort; no
torch import.

A small ``count`` spends most of its wall time before its work: the
interpreter, the torch import and the CUDA context.  For small inputs
the CLI routes here instead of the device pipeline (cli/commands/count.py
``_host_count_wanted``): the C++ rolling window encoders of
native/host_native.cpp (encode_windows_u64, nthash_windows_u64 and the
sketch streams) feed the host sort, so the call never imports torch.
Window semantics are the device pipeline's (models/count.window_codes;
reference sketches NewKmerIterator, count.go:314-367), and the outputs
are byte-equal to it (tests/test_torch_count_host.py).  The port of
unikmer_tpu/models/count_host.py.

The device pipeline (models/count.py) stays the engine for large inputs
and for -T with sketches.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from ..io.fastx import parse_taxid_records
from ..ops.nthash import scaled_max_hash


def supported(k: int, hashed: bool, scale: int, minimizer_w: int,
              syncmer_s: int) -> bool:
    """Host engine scope: 2-bit encode (k <= 32), ntHash (k <= 64, incl.
    scaled MinHash), and the minimizer/closed-syncmer sketches (which
    force hashed+canonical)."""
    if native.get_lib() is None:
        return False
    if hashed or minimizer_w > 0 or syncmer_s > 0:
        return 1 <= k <= 64
    return 1 <= k <= 32 and scale <= 1


def _windows(packed, k, canonical, hashed, scale,
             minimizer_w=0, syncmer_s=0, syncmer_impl="edgar"):
    if minimizer_w > 0 or syncmer_s > 0:
        # sketch kernels materialize keyed hash arrays (~17-26 B/base vs
        # 8 for plain windows): route to the device streaming path at a
        # quarter of the plain-window cap
        cap = int(os.environ.get("UNIKMER_TPU_HOST_COUNT_MAX_BASES",
                                 str(1 << 28))) // 4
        if packed.bases.size > cap:
            return None
        if minimizer_w > 0:
            kind = "minimizer"
        elif syncmer_impl == "compat":
            kind = "syncmer_compat"
        else:
            kind = "syncmer"
        if kind == "syncmer_compat":
            # per-RECORD kernel calls: the compat truncation + fill
            # semantics are record-scoped (the reference's per-record
            # iterator model; the device twin in ops/sketch segments
            # the same way).  Slices may carry trailing separator
            # bytes; the kernel is invariant to them.
            ends = np.append(packed.starts[1:],
                             np.int64(len(packed.bases)))
            parts = [
                native.sketch_emit(
                    packed.bases[int(a):int(b)], k, syncmer_s, kind)
                for a, b in zip(packed.starts, ends)
            ]
            if any(p is None for p in parts):
                return None
            codes = (np.concatenate(parts) if parts
                     else np.zeros(0, np.uint64))
        else:
            codes = native.sketch_emit(packed.bases, k,
                                       minimizer_w or syncmer_s, kind)
        if codes is not None and scale > 1:
            # scaled filter applies to the emitted sketch stream
            # (models/count.linear_codes_step; count.go:373-375)
            codes = codes[codes <= np.uint64(scaled_max_hash(scale))]
        return codes
    if hashed:
        return native.nthash_windows(packed.bases, k, canonical, scale)
    return native.encode_windows(packed.bases, k, canonical)


def linear_host(packed, k: int, canonical: bool, hashed: bool = False,
                scale: int = 1, minimizer_w: int = 0,
                syncmer_s: int = 0,
                syncmer_impl: str = "edgar") -> np.ndarray | None:
    """count -l: all valid window codes/hashes in genome order,
    duplicates kept.  None when the native library is unavailable."""
    return _windows(packed, k, canonical, hashed, scale,
                    minimizer_w, syncmer_s, syncmer_impl)


def count_host(packed, k: int, canonical: bool, mode: str = "distinct",
               hashed: bool = False, scale: int = 1, minimizer_w: int = 0,
               syncmer_s: int = 0,
               syncmer_impl: str = "edgar") -> np.ndarray | None:
    """count: sorted distinct/unique/repeated codes (the device pipeline
    also emits sorted order, docs/DIVERGENCES.md §3).  None when the
    native library is unavailable."""
    codes = _windows(packed, k, canonical, hashed, scale,
                     minimizer_w, syncmer_s, syncmer_impl)
    if codes is None:
        return None
    if len(codes) == 0:
        return codes
    codes = native.host_sort(codes)
    first = np.ones(len(codes), bool)
    first[1:] = codes[1:] != codes[:-1]
    if mode == "distinct":
        return codes[first]
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, len(codes)))
    if mode == "unique":
        return codes[starts[counts == 1]]
    if mode == "repeated":
        return codes[starts[counts >= 2]]
    raise ValueError(f"unknown mode: {mode}")


def _valid_window_positions(bases: np.ndarray, k: int) -> np.ndarray:
    """Start positions of all-valid windows — the positions the native
    window kernels emit for, in the same order."""
    n = len(bases)
    if n < k:
        return np.zeros(0, np.int64)
    bad = (np.asarray(bases) >= 4).astype(np.int64)
    c = np.concatenate([np.zeros(1, np.int64), np.cumsum(bad)])
    return np.flatnonzero(c[k:] - c[:-k] == 0)


def linear_windows_host(bases: np.ndarray, k: int, canonical: bool,
                        hashed: bool = False):
    """(codes, start_positions) of every valid window, genome order: the
    host twin of models.count.linear_codes_all.  None when the native
    library is unavailable."""
    if hashed:
        codes = native.nthash_windows(bases, k, canonical)
    else:
        if not 1 <= k <= 32:
            return None
        codes = native.encode_windows(bases, k, canonical)
    if codes is None:
        return None
    pos = _valid_window_positions(bases, k)
    if len(pos) != len(codes):
        raise RuntimeError(f"{len(codes)} window codes for {len(pos)} valid "
                           f"windows")
    return codes, pos


def count_taxids_host(records, k: int, canonical: bool, hashed: bool,
                      scale: int, mode: str, circular: bool, re_taxid,
                      taxdb):
    """count -T: the host twin of models.count.count_packed_taxids
    (count.go:334-344,377-410): per-record taxids parsed from headers,
    windows by the native kernels, the LCA merged per code.  None when
    the native library is unavailable."""
    if native.get_lib() is None:
        return None
    packed, rec_taxids = parse_taxid_records(records, k, circular, 1,
                                             re_taxid)
    if packed.bases.size == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint32)
    if packed.bases.size > int(os.environ.get(
            "UNIKMER_TPU_HOST_COUNT_MAX_BASES", str(1 << 28))):
        return None  # window buffer would be 8 B/base: device streams
    res = linear_windows_host(packed.bases, k, canonical, hashed)
    if res is None:
        return None
    codes, pos = res
    taxids = rec_taxids[np.searchsorted(packed.starts, pos, side="right") - 1]
    if scale > 1:  # FracMinHash threshold (count.go:89-98)
        keep = codes <= np.uint64(scaled_max_hash(scale))
        codes, taxids = codes[keep], taxids[keep]
    uniq, merged = taxdb.lca_reduce(codes, taxids)
    if mode in ("unique", "repeated"):
        u, counts = np.unique(codes, return_counts=True)
        keep = counts == 1 if mode == "unique" else counts > 1
        return uniq[keep], merged[keep]
    return uniq, merged
