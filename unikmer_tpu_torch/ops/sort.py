"""Sort and collapse of keyed u64 code arrays (port of unikmer_tpu/ops/sort.py).

Invalid slots are keyed to CODE_SENTINEL (2^64-1, ``-1`` as int64) so
one keys-only sort pushes them to the tail.  A real code equal to the
sentinel cannot be told from an invalid slot after the sort, so it is
counted before (``n_sent_real``) and appended to the kept set by count,
exactly as in the JAX package.

The sort is always K2 (ops/radix_sort.py) on CUDA; the taxid
pipeline's (code, payload) sort is K3, in taxonomy/lca.py.  The public
sorts of the JAX module (``sort_codes``, ``sort_codes_taxids``,
``sort_code_bits``) are entry points over the same two kernels.  The
collapse after the sort is C1 (ops/collapse.py), one pass that keeps the
first slot of each run (or of each run of one, or of more than one) and
compacts; the TPU's sort-based compaction is not ported.  Results keep
the JAX contract: a full-length tensor whose first ``n`` slots are the
kept codes in ascending order, the rest CODE_SENTINEL, and ``n`` as a
0-dim int64 tensor (no host sync).
"""

from __future__ import annotations

import numpy as np

from .._lazy import torch
from ..utils.stages import stage
from .codec import SENTINEL
from .collapse import collapse_pass
from .radix_sort import radix_sort_kv_u64, radix_sort_u64

MODES = ("distinct", "unique", "repeated")


def _sort_u64(codes: torch.Tensor, code_bits: int = 64) -> torch.Tensor:
    """The device u64 sort: K2 on CUDA, its plain version on the CPU."""
    return radix_sort_u64(codes, code_bits)


def sort_code_bits(k: int, hashed: bool) -> int:
    """The ``code_bits`` of a (k, hashed) config for :func:`sort_codes`:
    2k where that is below 48, else 64 (the JAX package's values).  Every
    code of the config is below 2^code_bits, so K2 and K3 run
    ``len(radix_sort.radix_shifts(code_bits))`` digit passes at most:
    ceil((2k + 1) / 8) for k <= 23 (6 at k = 23), else 8."""
    bits = 64 if hashed else 2 * k
    return bits if 0 < bits < 48 else 64


def _to_device(arr, dtype, device) -> torch.Tensor:
    """A numpy array of u64 (or u32) values as an int64 (or int32)
    tensor of their bit patterns on ``get_device(device)``."""
    from .._device import get_device

    bits = np.ascontiguousarray(arr).view(dtype)
    return torch.from_numpy(bits).to(get_device(device))


def sort_codes(codes, code_bits: int = 64, device=None):
    """Ascending unsigned sort of u64 codes, by K2 on CUDA.

    A tensor (int64 bit patterns, the port's convention) is sorted on its
    own device and returned as a new tensor there.  A numpy uint64 array
    is sorted on ``device`` (default ``_device.get_device()``: the card
    unless UNIKMER_TPU_TORCH_DEVICE says otherwise) and returned as
    numpy.  With ``code_bits`` below 64 every code must be below
    2^code_bits or the all-ones CODE_SENTINEL (see
    :func:`sort_code_bits`)."""
    if isinstance(codes, torch.Tensor):
        return radix_sort_u64(codes, code_bits)
    out = radix_sort_u64(
        _to_device(np.asarray(codes, np.uint64), np.int64, device), code_bits)
    return out.cpu().numpy().view(np.uint64)


def sort_codes_taxids(codes, taxids, code_bits: int = 64, device=None):
    """(codes, taxids) co-sorted by ascending unsigned code, by K3 on
    CUDA; the order of equal codes' taxids is left free (K3 keeps their
    input order).  Tensors (int64 codes, int32 taxids, both bit
    patterns) are sorted on their device; numpy (uint64 codes, uint32
    taxids) on ``device``, as in :func:`sort_codes`, and returned as
    numpy."""
    if isinstance(codes, torch.Tensor):
        return radix_sort_kv_u64(codes, taxids, code_bits)
    c = _to_device(np.asarray(codes, np.uint64), np.int64, device)
    t = _to_device(np.asarray(taxids, np.uint32), np.int32, c.device)
    sc, st = radix_sort_kv_u64(c, t, code_bits)
    return (sc.cpu().numpy().view(np.uint64),
            st.cpu().numpy().view(np.uint32))


def _sentinel_count(keyed: torch.Tensor, valid: torch.Tensor):
    """Real sentinel-valued codes, counted before the sort: after it they
    cannot be told from the invalid slots keyed to the sentinel."""
    return ((keyed == SENTINEL) & valid.bool()).sum(dtype=torch.int64)


def collapse_keyed(keyed: torch.Tensor, valid: torch.Tensor,
                   mode: str = "distinct", code_bits: int = 64):
    """:func:`collapse_sorted` for codes already keyed to the sentinel
    where invalid (the output of K1)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode}")
    if keyed.shape[0] == 0:
        return keyed.clone(), keyed.new_zeros((), dtype=torch.int64)
    dev = keyed.device
    with stage("collapse", dev):
        n_sent_real = _sentinel_count(keyed, valid)
    with stage("sort", dev):
        s = _sort_u64(keyed, code_bits)
    with stage("collapse", dev):
        out, _, n = collapse_pass(s, mode, n_sent_real=n_sent_real)
    return out, n


def collapse_sorted(codes: torch.Tensor, valid: torch.Tensor,
                    mode: str = "distinct", code_bits: int = 64):
    """Sort + collapse a masked code array.

    mode: 'distinct' keeps one copy of every code (count), 'unique'
    codes seen once (count -u), 'repeated' one copy of codes seen more
    than once (count -d).  Returns (out, n): the kept codes ascending
    as the first n slots of out, the tail CODE_SENTINEL.
    """
    valid = valid.bool()
    return collapse_keyed(torch.where(valid, codes, SENTINEL), valid, mode,
                          code_bits)


def collapse_dual_keyed(keyed: torch.Tensor, valid: torch.Tensor,
                        code_bits: int = 64):
    """:func:`collapse_sorted_dual` for codes already keyed."""
    dev = keyed.device
    if keyed.shape[0] == 0:
        zero = keyed.new_zeros((), dtype=torch.int64)
        return keyed.clone(), zero, keyed.clone(), zero.clone()
    with stage("collapse", dev):
        n_sent_real = _sentinel_count(keyed, valid)
    with stage("sort", dev):
        s = _sort_u64(keyed, code_bits)
    with stage("collapse", dev):
        return collapse_dual_from_sorted(s, n_sent_real)


def collapse_sorted_dual(codes: torch.Tensor, valid: torch.Tensor,
                         code_bits: int = 64):
    """One sort, both collapses: (distinct, n_d, repeated, n_r), for the
    capped-multiplicity merge of the -u/-d streams."""
    valid = valid.bool()
    return collapse_dual_keyed(torch.where(valid, codes, SENTINEL), valid,
                               code_bits)


def collapse_dual_from_sorted(s: torch.Tensor, n_sent_real):
    """The post-sort half of :func:`collapse_sorted_dual`: the sorted
    keyed array and the pre-sort count of real sentinel-valued codes ->
    (distinct, n_d, repeated, n_r), by two C1 passes."""
    out_d, _, n_d = collapse_pass(s, "distinct", n_sent_real=n_sent_real)
    out_r, _, n_r = collapse_pass(s, "repeated", n_sent_real=n_sent_real)
    return out_d, n_d, out_r, n_r
