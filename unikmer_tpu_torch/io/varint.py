"""Vectorized group-varint (varint-GB) codec for 64-bit deltas (the
port's copy of unikmer_tpu/io/varint.py; the same bytes).

The sorted `.unik` payload stores delta-encoded sorted codes
"compressed using varint-GB", in this layout, chosen for SIMD/vector
decode:

  A block of n uint64 values is encoded as
      [ctrl bytes][value bytes]
  with ALL control bytes first: one u16 (LE) per group of 4 values,
  3 bits per value holding (byte_length - 1), byte lengths 1..8.
  Value bytes are each value's little-endian bytes, concatenated.

Putting the control stream before the value stream removes the
sequential control->offset dependency of classic varint-GB, so both
encode and decode are pure vectorized numpy (scatter/gather by byte
plane).
"""

from __future__ import annotations

import numpy as np

_THRESH = [np.uint64(1 << (8 * i)) for i in range(1, 8)]


def _byte_lengths(vals: np.ndarray) -> np.ndarray:
    """Minimal LE byte length (1..8) per uint64 value."""
    l = np.ones(len(vals), dtype=np.int64)
    for t in _THRESH:
        l += (vals >= t).astype(np.int64)
    return l


def encode_gb64(vals: np.ndarray) -> bytes:
    """Encode uint64 array -> bytes (ctrl stream ++ value stream)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    n = len(vals)
    if n == 0:
        return b""
    lens = _byte_lengths(vals)
    ngroups = (n + 3) // 4
    # control: 3 bits per value within a u16 per group
    lm1 = (lens - 1).astype(np.uint16)
    pad = ngroups * 4 - n
    if pad:
        lm1 = np.concatenate([lm1, np.zeros(pad, np.uint16)])
    lm1 = lm1.reshape(ngroups, 4)
    ctrl = (
        lm1[:, 0] | (lm1[:, 1] << 3) | (lm1[:, 2] << 6) | (lm1[:, 3] << 9)
    ).astype("<u2")
    # value bytes: scatter each byte plane
    offsets = np.zeros(n, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)[:-1]
    total = int(offsets[-1] + lens[-1])
    out = np.zeros(total, dtype=np.uint8)
    for j in range(8):
        mask = lens > j
        if not mask.any():
            break
        out[offsets[mask] + j] = (
            (vals[mask] >> np.uint64(8 * j)) & np.uint64(0xFF)
        ).astype(np.uint8)
    return ctrl.tobytes() + out.tobytes()


def decode_gb64(buf: bytes, n: int) -> tuple[np.ndarray, int]:
    """Decode n values from buf. Returns (values, bytes_consumed)."""
    if n == 0:
        return np.zeros(0, np.uint64), 0
    ngroups = (n + 3) // 4
    ctrl = np.frombuffer(buf, dtype="<u2", count=ngroups).astype(np.uint16)
    lm1 = np.empty((ngroups, 4), dtype=np.int64)
    lm1[:, 0] = ctrl & 7
    lm1[:, 1] = (ctrl >> 3) & 7
    lm1[:, 2] = (ctrl >> 6) & 7
    lm1[:, 3] = (ctrl >> 9) & 7
    lens = (lm1.reshape(-1)[:n] + 1).astype(np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)[:-1]
    total = int(offsets[-1] + lens[-1])
    data = np.frombuffer(buf, dtype=np.uint8, count=total, offset=2 * ngroups)
    vals = np.zeros(n, dtype=np.uint64)
    for j in range(8):
        mask = lens > j
        if not mask.any():
            break
        vals[mask] |= data[offsets[mask] + j].astype(np.uint64) << np.uint64(8 * j)
    return vals, 2 * ngroups + total


def delta_encode(sorted_vals: np.ndarray, prev: int = 0) -> np.ndarray:
    """Deltas of a sorted uint64 array relative to ``prev`` (wrapping sub)."""
    sorted_vals = np.asarray(sorted_vals, dtype=np.uint64)
    out = np.empty_like(sorted_vals)
    if len(sorted_vals) == 0:
        return out
    out[0] = sorted_vals[0] - np.uint64(prev)
    np.subtract(sorted_vals[1:], sorted_vals[:-1], out=out[1:])
    return out


def delta_decode(deltas: np.ndarray, prev: int = 0) -> np.ndarray:
    deltas = np.asarray(deltas, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return np.cumsum(deltas, dtype=np.uint64) + np.uint64(prev)
