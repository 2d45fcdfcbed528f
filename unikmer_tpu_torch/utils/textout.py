"""Vectorized text emission (the port's copy of
unikmer_tpu/utils/textout.py): build whole output blocks as numpy byte
buffers instead of per-line Python formatting (the reference leans on
Go's fmt in a hot loop, view.go:187-217; we emit ~10^7 lines per block).

Core trick: per-row line lengths vary only through decimal widths, so
compute per-row offsets with one cumsum and scatter each byte column.
"""

from __future__ import annotations

import numpy as np

_MAX_U64_DIGITS = 20


def _decimal_digits(vals: np.ndarray, max_digits: int):
    """(digits, width): right-aligned ASCII digits (n, max_digits) and the
    significant width per value (>=1)."""
    n = len(vals)
    v = vals.astype(np.uint64).copy()
    digits = np.zeros((n, max_digits), np.uint8)
    for j in range(max_digits):
        digits[:, max_digits - 1 - j] = (v % 10).astype(np.uint8) + ord("0")
        v //= 10
    nz = digits != ord("0")
    first = np.argmax(nz, axis=1)
    any_nz = nz.any(axis=1)
    width = np.where(any_nz, max_digits - first, 1).astype(np.int64)
    return digits, width


def _scatter_digits(buf, offsets, digits, width, max_digits):
    for p in range(max_digits):
        mask = width > p
        if not mask.any():
            break
        rows = np.flatnonzero(mask)
        col = digits[rows, max_digits - width[rows] + p]
        buf[offsets[rows] + p] = col


def lines_fixed_plus_int(fixed: np.ndarray | None, vals: np.ndarray,
                         sep: bytes = b"\t") -> bytes:
    """Lines of '<fixed><sep><int>\\n' (fixed is an (n, w) byte matrix),
    or '<int>\\n' when fixed is None."""
    n = len(vals)
    digits, width = _decimal_digits(vals, _MAX_U64_DIGITS)
    fw = 0 if fixed is None else fixed.shape[1]
    sw = len(sep) if fixed is not None else 0
    lengths = fw + sw + width + 1
    offsets = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.zeros(int(lengths.sum()), np.uint8)
    if fixed is not None:
        for j in range(fw):
            buf[offsets + j] = fixed[:, j]
        for j, ch in enumerate(sep):
            buf[offsets + fw + j] = ch
    _scatter_digits(buf, offsets + fw + sw, digits, width, _MAX_U64_DIGITS)
    buf[offsets + lengths - 1] = ord("\n")
    return buf.tobytes()


def lines_int_plus_fixed(vals: np.ndarray, fixed: np.ndarray,
                         pre: bytes, mid: bytes, post: bytes) -> bytes:
    """Lines of '<pre><int><mid-line><fixed><post>' — used for FASTA/FASTQ
    emission where 'mid' contains the newline."""
    n = len(vals)
    digits, width = _decimal_digits(vals, _MAX_U64_DIGITS)
    fw = fixed.shape[1]
    lengths = len(pre) + width + len(mid) + fw + len(post)
    offsets = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.zeros(int(lengths.sum()), np.uint8)
    for j, ch in enumerate(pre):
        buf[offsets + j] = ch
    _scatter_digits(buf, offsets + len(pre), digits, width, _MAX_U64_DIGITS)
    o = offsets + len(pre) + width
    for j, ch in enumerate(mid):
        buf[o + j] = ch
    o = o + len(mid)
    for j in range(fw):
        buf[o + j] = fixed[:, j]
    o = o + fw
    for j, ch in enumerate(post):
        buf[o + j] = ch
    return buf.tobytes()


def lines_fixed(fixed: np.ndarray) -> bytes:
    """Lines of '<fixed>\\n'."""
    n, w = fixed.shape
    buf = np.empty((n, w + 1), np.uint8)
    buf[:, :w] = fixed
    buf[:, w] = ord("\n")
    return buf.tobytes()


def lines_two_ints(a: np.ndarray, b: np.ndarray, sep: bytes = b"\t") -> bytes:
    """Lines of '<a>\\t<b>\\n'."""
    n = len(a)
    da, wa = _decimal_digits(a, _MAX_U64_DIGITS)
    db, wb = _decimal_digits(b, _MAX_U64_DIGITS)
    lengths = wa + len(sep) + wb + 1
    offsets = np.zeros(n, np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    buf = np.zeros(int(lengths.sum()), np.uint8)
    _scatter_digits(buf, offsets, da, wa, _MAX_U64_DIGITS)
    o = offsets + wa
    for j, ch in enumerate(sep):
        buf[o + j] = ch
    _scatter_digits(buf, o + len(sep), db, wb, _MAX_U64_DIGITS)
    buf[offsets + lengths - 1] = ord("\n")
    return buf.tobytes()
