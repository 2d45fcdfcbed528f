"""C1: the collapse and compaction of a code array in one pass.

The JAX package does this step as XLA code (unikmer_tpu/ops/sort.py
``compact_sorted``/``compact_aux`` and ``collapse_sorted``'s run flags,
unikmer_tpu/ops/device_sets.py ``_compact_mask``/``common``).  On a CUDA
tensor :func:`collapse_pass` launches csrc/collapse.cu, which decides
each slot's keep flag in registers, scans the flags with a decoupled
look-back over its tiles and stores the kept keys through shared memory,
then fills the tail; nothing is read back to the host.  On a CPU tensor
it runs the plain version, :func:`collapse_plain`: run edges, a mask, a
cumsum and a scatter in PyTorch.

The rule (``mode``) is the calling operation's:

  distinct   the first slot of each run of a sorted array, sentinel aside
  unique     ... of a run of one slot
  repeated   ... of a run of more than one
  threshold  ... of a run of at least ``threshold`` slots (``common``)
  mask       the slots where ``mask`` holds (keys in any order)

In the sorted modes the sentinel-keyed slots are the sorted tail, so a
real sentinel-valued code cannot be told from padding: the caller counts
those before the sort and passes the count (``n_sent_real``, a 0-dim
int64 tensor), which adds one to ``n`` as in the JAX package (distinct
when > 0, unique when 1, repeated when > 1).  An int32 or int64 ``aux``
column is compacted by the same flags.  Results: a full-length tensor
whose first ``n`` slots are the kept keys in input order, the tail
CODE_SENTINEL (aux 0), and ``n`` as a 0-dim int64 tensor.
"""

from __future__ import annotations

from .. import _kernels
from .._lazy import torch
from .codec import SENTINEL

MODES = ("distinct", "unique", "repeated", "threshold", "mask")
SORTED_MODES = MODES[:3]

_TILE = _kernels.Kernel("ukt_collapse_tile")  # a query, not a launch
_COLLAPSE = _kernels.Kernel("ukt_collapse")


def run_edges(s: torch.Tensor):
    """(first, last): masks of the first and last slot of each run of
    equal values in a sorted array."""
    diff = s[1:] != s[:-1]
    one = diff.new_ones(min(s.shape[0], 1))
    return torch.cat([one, diff]), torch.cat([diff, one])[: s.shape[0]]


def compact_plain(values: torch.Tensor, keep: torch.Tensor,
                  fill: int = SENTINEL) -> torch.Tensor:
    """Stable-compact kept values to a dense prefix (scan + scatter);
    dropped slots go to a spill slot past the end and the tail stays
    ``fill``."""
    n = values.shape[0]
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep, pos, n)
    out = torch.full((n + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_(0, pos, values)
    return out[:n]


def keep_plain(keys: torch.Tensor, mode: str, threshold: int = 1,
               mask: torch.Tensor | None = None) -> torch.Tensor:
    """The keep flags of :func:`collapse_pass` in PyTorch."""
    if mode == "mask":
        return mask.bool()
    first, last = run_edges(keys)
    keep = first & (keys != SENTINEL)
    if mode == "unique":
        keep &= last
    elif mode == "repeated":
        keep &= ~last
    elif mode == "threshold" and threshold > 1:
        n, t = keys.shape[0], threshold
        reach = torch.zeros_like(keep)
        if t <= n:
            reach[: n - t + 1] = keys[t - 1:] == keys[: n - t + 1]
        keep &= reach
    return keep


def _real_sentinel(mode: str, n_sent_real: torch.Tensor) -> torch.Tensor:
    if mode == "distinct":
        return n_sent_real > 0
    if mode == "unique":
        return n_sent_real == 1
    return n_sent_real > 1


def collapse_plain(keys: torch.Tensor, mode: str = "distinct", *,
                   threshold: int = 1, mask: torch.Tensor | None = None,
                   aux: torch.Tensor | None = None,
                   n_sent_real: torch.Tensor | None = None):
    """Plain PyTorch version of C1: (out, aux_out or None, n)."""
    keep = keep_plain(keys, mode, threshold, mask)
    n = keep.sum(dtype=torch.int64)
    if n_sent_real is not None:
        n = n + _real_sentinel(mode, n_sent_real).to(torch.int64)
    aux_out = None if aux is None else compact_plain(aux, keep, 0)
    return compact_plain(keys, keep), aux_out, n


def _check(keys, mode, threshold, mask, aux, n_sent_real, out) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("collapse_pass takes a 1-D int64 tensor of keys")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"collapse_pass: unsupported device {keys.device}")
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode}")
    if int(threshold) < 1:
        raise ValueError(f"threshold must be >= 1, got {threshold}")
    if (mode == "mask") != (mask is not None):
        raise ValueError("a mask goes with mode 'mask' and no other")
    if mask is not None and (mask.dtype not in (torch.bool, torch.uint8)
                             or mask.shape != keys.shape):
        raise ValueError("the mask is a bool tensor shaped like the keys")
    if aux is not None and (aux.dtype not in (torch.int32, torch.int64)
                            or aux.shape != keys.shape):
        raise ValueError("aux is an int32 or int64 tensor shaped like the "
                         "keys")
    if n_sent_real is not None and (mode not in SORTED_MODES
                                    or n_sent_real.dtype != torch.int64
                                    or n_sent_real.dim() != 0):
        raise ValueError("n_sent_real is a 0-dim int64 tensor of a "
                         "distinct, unique or repeated collapse")
    if out is not None and (out.dtype != torch.int64
                            or out.shape != keys.shape
                            or not out.is_contiguous()):
        raise ValueError("out is a contiguous int64 tensor shaped like the "
                         "keys")
    for t in (mask, aux, n_sent_real, out):
        if t is not None and t.device != keys.device:
            raise ValueError("every tensor of a collapse on one device")


def collapse_pass(keys: torch.Tensor, mode: str = "distinct", *,
                  threshold: int = 1, mask: torch.Tensor | None = None,
                  aux: torch.Tensor | None = None,
                  n_sent_real: torch.Tensor | None = None,
                  out: torch.Tensor | None = None):
    """C1 on CUDA tensors, its plain version on CPU tensors: the slots of
    ``keys`` that ``mode`` keeps, compacted.  Returns (out, aux_out, n):
    ``out`` and ``aux_out`` (None without ``aux``) new tensors of the
    input's length, ``n`` a 0-dim int64 tensor; the inputs are left as
    they are.  Given ``out`` (contiguous, shaped like the keys: a prefix
    view of a longer result, say), the keys are written there and it is
    returned."""
    _check(keys, mode, threshold, mask, aux, n_sent_real, out)
    if keys.device.type == "cpu" or keys.shape[0] == 0:  # nothing to launch
        kept, aux_out, n = collapse_plain(
            keys, mode, threshold=int(threshold), mask=mask, aux=aux,
            n_sent_real=n_sent_real)
        return (kept if out is None else out.copy_(kept)), aux_out, n
    dev, n = keys.device, keys.shape[0]
    if out is None:
        out = torch.empty(n, dtype=torch.int64, device=dev)
    aux_out = None if aux is None else torch.empty(n, dtype=aux.dtype,
                                                   device=dev)
    keys = keys.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    if aux is not None:
        aux = aux.contiguous()
    if mode == "threshold" and threshold == 1:
        mode = "distinct"  # the same rule, without the second read
    tiles = -(-n // _TILE.bound()())
    n_out = torch.empty((), dtype=torch.int64, device=dev)
    scratch = torch.empty(tiles + 2, dtype=torch.int64, device=dev)
    _COLLAPSE(dev, keys.data_ptr(), None if mask is None else mask.data_ptr(),
              None if aux is None else aux.data_ptr(),
              0 if aux is None else aux.element_size(), n,
              MODES.index(mode), int(threshold),
              None if n_sent_real is None else n_sent_real.data_ptr(),
              out.data_ptr(), None if aux_out is None else aux_out.data_ptr(),
              n_out.data_ptr(), scratch.data_ptr(), tiles)
    collapse_pass.launches += 1
    return out, aux_out, n_out


collapse_pass.launches = 0
