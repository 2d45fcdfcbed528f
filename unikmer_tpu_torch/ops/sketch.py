"""K-mer sketches on PyTorch (port of unikmer_tpu/ops/sketch.py), and S1.

Behavior contract (reference: shenwei356/bio sketches via unikmer
cmd/count.go): sketches force hashed (ntHash v1) + canonical codes.

  * Minimizer(k, w): for every window of w consecutive k-mers, select
    the minimum canonical hash (leftmost on ties); the linear stream
    emits one entry each time the selected POSITION changes.
  * Closed syncmer(k, s): a k-mer is selected iff the minimum s-mer
    hash within it (leftmost on ties) sits at offset 0 or k-s; the
    emitted value is the k-mer's canonical ntHash.
  * Compat closed syncmer (``--syncmer-impl compat``): the JAX package's
    reconstruction of the reference binary's rule, per record of a
    buffer packed with :func:`compat_gap` separator bytes between
    records (:func:`syncmer_compat_windows`).

The plain functions run on int64 bit patterns, as ops/nthash.py does:
the window minimum compares in unsigned order (codec.ult) and the
sentinel 2^64-1 is ``U64_MAX`` (-1).  Window min/argmin is the JAX
package's doubling pyramid (log2(w) rounds of shifted compares, the
left operand kept on ties), so the functions equal the JAX ones
element for element; they are the tests' reference and the CPU route.

S1 (:func:`sketch_select`, csrc/sketch.cu) is the card's window select
for the count pipeline: a run of windows a thread, each window's minimum
from a left suffix, a shared core and a right prefix (a few compares at
any w).  It takes H1's keyed hashes and validity
(ops/nthash.py:encode_nthash) and writes what the encode of a piece
returns: (keyed int64 [n], valid uint8 [n]), non-emitted slots keyed to
the sentinel, the scaled threshold applied to the selected code.  Its
third mode returns the leftmost argmin of every window alone, for the
compat rule's vote pass.  On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

from .. import _kernels
from .._lazy import torch
from . import codec
from .codec import SENTINEL, ult
from .nthash import MAX_HASH, at_most, nthash_windows

U64_MAX = SENTINEL  # 2^64-1 as an int64 bit pattern


def _shift_up(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """y[i] = x[i+s], ``fill`` past the end."""
    if s == 0:
        return x
    if s >= x.shape[0]:  # inputs shorter than the window width
        return torch.full_like(x, fill)
    return torch.cat([x[s:], x.new_full((s,), fill)])


def _shift_down(x: torch.Tensor, fill) -> torch.Tensor:
    """y[i] = x[i-1], ``fill`` at slot 0."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])[: x.shape[0]]


def _window_argmin(vals: torch.Tensor, idx: torch.Tensor, w: int):
    """(min value, leftmost argmin index) over windows [i, i+w), in
    unsigned order; windows past the end are cut at it."""
    if w == 1:
        return vals, idx
    p = 1
    while p * 2 <= w:
        p *= 2
    v, ix = vals, idx
    width = 1
    while width < p:  # doubling to width p
        v2 = _shift_up(v, width, U64_MAX)
        ix2 = _shift_up(ix, width, 0)
        take_right = ult(v2, v)  # strict: leftmost wins ties
        v = torch.where(take_right, v2, v)
        ix = torch.where(take_right, ix2, ix)
        width *= 2
    # two overlapping width-p windows cover width w
    v2 = _shift_up(v, w - p, U64_MAX)
    ix2 = _shift_up(ix, w - p, 0)
    take_right = ult(v2, v)
    return torch.where(take_right, v2, v), torch.where(take_right, ix2, ix)


def _window_all(valid: torch.Tensor, w: int) -> torch.Tensor:
    """AND over windows [i, i+w) by doubling; windows past the end are
    False."""
    if w == 1:
        return valid
    v = valid
    width = 1
    while width * 2 <= w:
        v = v & _shift_up(v, width, False)
        width *= 2
    return v & _shift_up(v, w - width, False)


def _arange(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], dtype=torch.int64, device=x.device)


def _minimizer_select(keyed: torch.Tensor, kvalid: torch.Tensor, w: int):
    """(window min, emit) of keyed k-mer hashes and their validity."""
    wmin, wargmin = _window_argmin(keyed, _arange(keyed), w)
    wvalid = _window_all(kvalid, w)
    # a new record/window-run begins where the previous slot was invalid
    prev_valid = _shift_down(wvalid, False)
    prev_arg = _shift_down(wargmin, 0)
    emit = wvalid & (~prev_valid | (wargmin != prev_arg))
    return wmin, emit


def _syncmer_emit(skeyed: torch.Tensor, kvalid: torch.Tensor,
                  w: int) -> torch.Tensor:
    """Closed-syncmer emit mask: the leftmost argmin of the keyed s-mer
    hashes over the k-mer's w = k-s+1 s-mers at offset 0 or w-1."""
    idx = _arange(skeyed)
    _, sargmin = _window_argmin(skeyed, idx, w)
    offset = sargmin - idx
    return kvalid & ((offset == 0) | (offset == w - 1))


def minimizer_windows(bases: torch.Tensor, k: int, w: int):
    """Per-position minimizer stream of a uint8 base tensor: (codes,
    emit), codes[i] the minimum canonical hash of the window group
    starting at i, emit True where the selected position changed."""
    kvalid = codec.window_valid(bases, k)
    hashes = nthash_windows(bases, k, canonical=True)
    keyed = torch.where(kvalid, hashes, U64_MAX)
    return _minimizer_select(keyed, kvalid, w)


def syncmer_windows(bases: torch.Tensor, k: int, s: int):
    """Closed-syncmer stream: (codes, emit), emit marking the selected
    k-mer positions and codes the k-mer canonical hash."""
    if s > k:
        raise ValueError(f"syncmer s ({s}) must be <= k ({k})")
    kvalid = codec.window_valid(bases, k)
    khash = nthash_windows(bases, k, canonical=True)
    svalid = codec.window_valid(bases, s)
    shash = torch.where(svalid, nthash_windows(bases, s, canonical=True),
                        U64_MAX)
    return khash, _syncmer_emit(shash, kvalid, k - s + 1)


def compat_gap(k: int, s: int) -> int:
    """Separator-run length that pack_records must place between records
    for :func:`syncmer_compat_windows`: with W = 2(k-s) vote windows, a
    gap of W-s+1 RECORD_SEP bytes keeps every window that starts in one
    record from seeing the next record's s-mers, and puts a vote-killer
    byte in every window that starts inside the gap."""
    return max(2 * (k - s) - s + 1, 1)


def _compat_emit(kvalid: torch.Tensor, shash: torch.Tensor,
                 sep: torch.Tensor, k: int, s: int, argmin) -> torch.Tensor:
    """The compat rule's emit mask (s < k) from the k-mer validity, the
    keyed s-mer hashes and the RECORD_SEP mask; ``argmin(keys, W)`` gives
    each window's leftmost argmin position."""
    n = shash.shape[0]
    idx = _arange(shash)
    W = 2 * (k - s)
    T = k - s
    minus1 = torch.full_like(idx, -1)
    # prev_real[i] = last non-separator index <= i (-1 if none): the
    # separator run at i is i - prev_real[i] long
    prev_real = torch.cummax(torch.where(sep, minus1, idx), 0).values
    # vote killers: gap bytes deeper than W-s into the separator run
    killer = sep & (idx - prev_real > max(W - s, 0))
    vote_key = torch.where(killer, 0, shash)

    # vote pass: i is marked iff some window [t, t+W-1] has its leftmost
    # argmin at i; every window's argmin lies inside it, so one scatter
    # of the argmins marks the same positions as the reference's loop
    # over the W windows holding i
    # index_fill_ takes the value as a scalar: an indexed assignment would
    # copy a host tensor of it to the card, a wait on every dispatch
    mark = torch.zeros(n, dtype=torch.bool, device=shash.device)
    mark.index_fill_(0, argmin(vote_key, W), True)
    mark &= kvalid & (shash != U64_MAX)

    # record scans (unsegmented: the separator runs bound each record)
    seg_start = torch.cummax(torch.where(sep, idx + 1, 0), 0).values
    next_sep = torch.where(sep, idx, n).flip(0).cummin(0).values.flip(0)
    lb = torch.cummax(torch.where(mark, idx, minus1), 0).values
    lb_eff = torch.where(lb >= seg_start, lb, -1)
    nm = torch.where(mark, idx, n).flip(0).cummin(0).values.flip(0)
    nm_strict = _shift_up(nm, 1, n)

    # head fills: before the record's first base, at T-multiples of the
    # distance to it, local position >= 1
    head_fill = (kvalid & ~mark & (lb_eff < 0) & (nm < next_sep)
                 & ((nm - idx) % T == 0) & (idx > seg_start))
    # interior fills: after a base, before the record's last base, at
    # T-multiples since the previous base
    int_fill = (kvalid & ~mark & (lb_eff >= 0) & (nm_strict < next_sep)
                & ((idx - lb_eff) % T == 0))
    return mark | head_fill | int_fill


def _window_argmin_pos(keys: torch.Tensor, w: int) -> torch.Tensor:
    return _window_argmin(keys, _arange(keys), w)[1]


def syncmer_compat_windows(bases: torch.Tensor, k: int, s: int):
    """The compat closed syncmer of a base tensor packed with
    :func:`compat_gap` RECORD_SEP bytes between records: (khash, emit)
    like :func:`syncmer_windows`.  Per record (the JAX package's
    unikmer_tpu/ops/sketch.py:110): every window of W = 2(k-s) s-mer
    positions, cut at the record's end, marks its leftmost minimum when
    that position holds a valid k-mer; before the first mark every valid
    position at a multiple of T = k-s from it (local position >= 1), and
    between marks every valid position at a multiple of T after the
    previous one, are emitted too.  The first W-s gap bytes key as
    2^64-1 (losing, like the cut) and deeper gap bytes as 0 (vote
    killers that take any window reaching across the boundary)."""
    if s > k:
        raise ValueError(f"syncmer s ({s}) must be <= k ({k})")
    kvalid = codec.window_valid(bases, k)
    khash = nthash_windows(bases, k, canonical=True)
    if s == k:  # degenerate: every valid k-mer is a closed syncmer
        return khash, kvalid
    svalid = codec.window_valid(bases, s)
    shash = torch.where(svalid, nthash_windows(bases, s, canonical=True),
                        U64_MAX)
    sep = bases == int(codec.RECORD_SEP)
    return khash, _compat_emit(kvalid, shash, sep, k, s, _window_argmin_pos)


# ---------------------------------------------------------------------
# S1: sliding-window select of the sketches on H1's outputs

MODES = ("minimizer", "syncmer", "argmin")


def _keep(codes: torch.Tensor, emit: torch.Tensor, max_hash: int):
    """(keyed, valid uint8): the emitted codes at most max_hash."""
    if max_hash != MAX_HASH:
        emit = emit & at_most(codes, max_hash)
    return torch.where(emit, codes, SENTINEL), emit.to(torch.uint8)


def sketch_select_plain(mode: str, keys: torch.Tensor, w: int,
                        valid: torch.Tensor | None = None,
                        khash: torch.Tensor | None = None,
                        max_hash: int = MAX_HASH):
    """Plain PyTorch version of S1 (see :func:`sketch_select`)."""
    if mode == "argmin":
        return _window_argmin_pos(keys, w)
    if mode == "minimizer":
        wmin, emit = _minimizer_select(keys, valid.bool(), w)
        return _keep(wmin, emit, max_hash)
    return _keep(khash, _syncmer_emit(keys, valid.bool(), w), max_hash)


def _check_select(mode, keys, w, valid, khash, max_hash) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown sketch_select mode: {mode}")
    if w < 1:
        raise ValueError(f"window width must be >= 1, got {w}")
    if not 0 <= max_hash <= MAX_HASH:
        raise ValueError(f"max_hash must be in [0, 2^64), got {max_hash}")
    need = {"keys": (keys, torch.int64)}
    if mode != "argmin":
        need["valid"] = (valid, torch.uint8)
    if mode == "syncmer":
        need["khash"] = (khash, torch.int64)
    for name, (t, dtype) in need.items():
        if t is None or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"sketch_select({mode}): {name} must be a "
                             f"contiguous 1-D {dtype} tensor")
        if t.shape != keys.shape or t.device != keys.device:
            raise ValueError(f"sketch_select({mode}): {name} must match keys "
                             f"in length and device")


_SELECT = _kernels.Kernel("ukt_sketch_select")


def sketch_select(mode: str, keys: torch.Tensor, w: int,
                  valid: torch.Tensor | None = None,
                  khash: torch.Tensor | None = None,
                  max_hash: int = MAX_HASH):
    """S1 on CUDA tensors, its plain version on CPU tensors.

    ``minimizer``: keys/valid are H1's keyed k-mer hashes and validity;
    returns (keyed int64 [n], valid uint8 [n]): the window minimum over
    [i, i+w) where the leftmost argmin changed, kept if <= max_hash.
    ``syncmer``: keys are H1's keyed s-mer hashes, valid and khash its
    k-mer validity and keyed hashes, w = k-s+1; returns (keyed, valid):
    khash[i] where the argmin over [i, i+w) is at offset 0 or w-1.
    ``argmin``: returns the leftmost argmin position of every window of
    keys (int64 [n]).  Windows past the end are cut at it."""
    _check_select(mode, keys, w, valid, khash, max_hash)
    dev = keys.device
    if dev.type == "cpu":
        return sketch_select_plain(mode, keys, w, valid, khash, max_hash)
    if dev.type != "cuda":
        raise ValueError(f"sketch_select: unsupported device {dev}")
    # the kernel reads 16-byte words: a view off one is cloned
    keys, valid, khash = (t if t is None or t.data_ptr() % 16 == 0 else t.clone()
                          for t in (keys, valid, khash))
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=dev)
    out_valid = (None if mode == "argmin"
                 else torch.empty(n, dtype=torch.uint8, device=dev))
    if n == 0:
        return out if out_valid is None else (out, out_valid)
    _SELECT(dev, MODES.index(mode), keys.data_ptr(),
            0 if valid is None else valid.data_ptr(),
            0 if khash is None else khash.data_ptr(), n, w, max_hash,
            out.data_ptr(), 0 if out_valid is None else out_valid.data_ptr())
    sketch_select.launches += 1
    return out if out_valid is None else (out, out_valid)


sketch_select.launches = 0


def unpack_bits(mask: torch.Tensor, n: int) -> torch.Tensor:
    """Bool [n] of a little-endian bitmask (bit j at bit j%8 of byte j//8),
    as the host packs validity and separators."""
    bits = torch.arange(8, dtype=torch.int32, device=mask.device)
    return ((mask.to(torch.int32)[:, None] >> bits) & 1).reshape(-1)[:n].bool()


def syncmer_compat_select(kkeyed: torch.Tensor, kvalid: torch.Tensor,
                          skeyed: torch.Tensor, sep: torch.Tensor, k: int,
                          s: int, max_hash: int = MAX_HASH):
    """The compat rule on H1's outputs (k-mer keyed hashes and validity,
    keyed s-mer hashes) and the RECORD_SEP mask: (keyed int64, valid
    uint8) as S1 returns them.  The vote argmin is S1's argmin mode; the
    keying, mark, scans and fills are plain PyTorch."""
    kv = kvalid.bool()
    if s == k:
        emit = kv
    else:
        emit = _compat_emit(kv, skeyed, sep, k, s,
                            lambda keys, w: sketch_select("argmin", keys, w))
    return _keep(kkeyed, emit, max_hash)
