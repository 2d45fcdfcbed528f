"""P1/P2: the four probe kernels of csrc/probes.cu and their plain versions.

The ports of the Pallas feasibility probes in scripts/exp_pallas_dma.py
and scripts/exp_pallas_dma2.py:

  copy_inc_u32      P1a  out = x + 1, wrapping at 2^32 (probe1, probe1_fixed)
  row_cmpex_u32     P1b  row compare-exchange stages at given distances
                    P2a  (probe2: 64 stages at R/2; cmpex_rows_kernel:
                         R/2, R/4, ..., 1, R/2, ...)
  transpose128_u32  P1c  transpose of each (128, 128) tile (probe3)
  lane_cmpex_u32    P2b  seven lane stages d = 64..1 on 128-lane rows
                         (probe4_roll)

u32 values travel as int32 tensors holding their bit patterns, as K3's
values do: torch has no unsigned compare or add for uint32 on the CPU.
The plain versions compare with the sign bit flipped (unsigned order as
signed order) and add in int64.  On a CUDA tensor each wrapper launches
its kernel or raises; on a CPU tensor it runs its plain version.  Each
wrapper counts the calls that launched its kernel in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _kernels

_FLIP = -(1 << 31)  # x ^ _FLIP maps unsigned int32 order onto signed order
LANES = 128


def _u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a ^ _FLIP, b ^ _FLIP) ^ _FLIP


def _umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a ^ _FLIP, b ^ _FLIP) ^ _FLIP


def _check(name: str, x: torch.Tensor, dim: int | None = None) -> None:
    if x.dtype != torch.int32:
        raise ValueError(f"{name} takes an int32 tensor of u32 bit patterns")
    if dim is not None and x.dim() != dim:
        raise ValueError(f"{name} takes a {dim}-D tensor, got {x.dim()}-D")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _launch(fn_name: str, *args) -> None:
    lib = _kernels.load()
    dev = torch.cuda.current_device()
    err = getattr(lib, fn_name)(*args,
                                torch.cuda.current_stream(dev).cuda_stream)
    _kernels.check(lib, err, fn_name)


# ---------------------------------------------------------------------
# P1a: copy + increment


def copy_inc_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1a: x + 1 modulo 2^32."""
    return _u32_bits((x.to(torch.int64) + 1) & 0xFFFFFFFF)


def copy_inc_u32(x: torch.Tensor) -> torch.Tensor:
    """P1a: a new tensor holding x + 1 modulo 2^32 (any shape)."""
    _check("copy_inc_u32", x)
    if x.device.type == "cpu":
        return copy_inc_u32_plain(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("ukt_copy_inc_u32", x.data_ptr(), out.data_ptr(), x.numel())
    copy_inc_u32.launches += 1
    return out


copy_inc_u32.launches = 0


# ---------------------------------------------------------------------
# P1b / P2a: row compare-exchange stages


def p1b_distances(rows: int) -> list[int]:
    """probe2's schedule: 64 stages, each between the two halves."""
    return [rows // 2] * 64


def p2a_distances(nstages: int, rows: int) -> list[int]:
    """cmpex_rows_kernel's schedule: R/2, R/4, ..., 1, then R/2 again,
    for ``nstages`` stages (exp_pallas_dma2.py:102-114)."""
    out, d = [], rows // 2
    while len(out) < nstages:
        out.append(d)
        d = d // 2 if d > 1 else rows // 2
    return out


def _check_distances(distances) -> list[int]:
    ds = [int(d) for d in distances]
    if any(d < 1 for d in ds):
        raise ValueError(f"row distances must be >= 1, got {ds}")
    return ds


def row_cmpex_u32_plain(x: torch.Tensor, distances) -> torch.Tensor:
    """Plain version of P1b/P2a.  Each stage at distance d pairs rows
    (g*2d + i, g*2d + i + d) for i < d, the top row taking the min and
    the bottom row the max; a row whose partner would lie past the last
    row is left as it is."""
    a = x.clone()
    rows = x.shape[0]
    r = torch.arange(rows, device=x.device)
    for d in _check_distances(distances):
        top = r[(r % (2 * d) < d) & (r + d < rows)]
        lo, hi = a[top], a[top + d]
        a[top], a[top + d] = _umin(lo, hi), _umax(lo, hi)
    return a


# rows of one column that fit a block's shared memory (csrc/probes.cu)
ROW_CMPEX_MAX_ROWS = 40 * 1024


def row_cmpex_u32(x: torch.Tensor, distances) -> torch.Tensor:
    """P1b/P2a: the row compare-exchange stages of ``distances`` on a
    (R, C) tensor, R <= ROW_CMPEX_MAX_ROWS on the card; a new tensor."""
    _check("row_cmpex_u32", x, 2)
    ds = _check_distances(distances)
    if x.device.type == "cpu":
        return row_cmpex_u32_plain(x, ds)
    if x.shape[0] > ROW_CMPEX_MAX_ROWS:
        raise ValueError(f"row_cmpex_u32 takes at most {ROW_CMPEX_MAX_ROWS} "
                         f"rows on the card, got {x.shape[0]}")
    x = x.contiguous()
    if not ds or x.numel() == 0:
        return x.clone()
    out = torch.empty_like(x)
    rows, cols = x.shape
    # a distance >= rows pairs no rows: clamped, it fits the kernel's int32
    host = (ctypes.c_int64 * len(ds))(*(min(d, rows) for d in ds))
    with torch.cuda.device(x.device):
        _launch("ukt_row_cmpex_u32", x.data_ptr(), out.data_ptr(), rows, cols,
                ctypes.addressof(host), len(ds))
    row_cmpex_u32.launches += 1
    return out


row_cmpex_u32.launches = 0


# ---------------------------------------------------------------------
# P1c: (128, 128) tile transposes


def _check_tiles(name: str, x: torch.Tensor) -> int:
    _check(name, x, 2)
    if x.shape[1] != LANES or x.shape[0] % LANES:
        raise ValueError(f"{name} takes (T*128, 128), got {tuple(x.shape)}")
    return x.shape[0] // LANES


def transpose128_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1c: swapaxes(reshape(T, 128, 128), 1, 2)."""
    t = x.shape[0] // LANES
    return x.reshape(t, LANES, LANES).transpose(1, 2).reshape(-1, LANES)


def transpose128_u32(x: torch.Tensor) -> torch.Tensor:
    """P1c: each (128, 128) tile of a (T*128, 128) tensor transposed;
    a new tensor."""
    tiles = _check_tiles("transpose128_u32", x)
    if x.device.type == "cpu":
        return transpose128_u32_plain(x).contiguous()
    if tiles > 65535:
        raise ValueError(f"transpose128_u32 takes at most 65535 tiles, got {tiles}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if tiles == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("ukt_transpose128_u32", x.data_ptr(), out.data_ptr(), tiles)
    transpose128_u32.launches += 1
    return out


transpose128_u32.launches = 0


# ---------------------------------------------------------------------
# P2b: lane compare-exchange stages

LANE_DISTANCES = (64, 32, 16, 8, 4, 2, 1)


def lane_cmpex_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P2b: for d = 64, 32, ..., 1 lane j takes
    min(a[j], a[j ^ d]) when bit d of j is clear, else the max (the
    partner of probe4_roll's rolls, exp_pallas_dma2.py:141-150)."""
    a = x
    lane = torch.arange(LANES, device=x.device)
    for d in LANE_DISTANCES:
        partner = a[:, lane ^ d]
        a = torch.where((lane & d) == 0, _umin(a, partner), _umax(a, partner))
    return a


def lane_cmpex_u32(x: torch.Tensor) -> torch.Tensor:
    """P2b: the seven lane stages on each 128-lane row of an (R, 128)
    tensor; a new tensor."""
    _check("lane_cmpex_u32", x, 2)
    if x.shape[1] != LANES:
        raise ValueError(f"lane_cmpex_u32 takes (R, 128), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lane_cmpex_u32_plain(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        _launch("ukt_lane_cmpex_u32", x.data_ptr(), out.data_ptr(), x.shape[0])
    lane_cmpex_u32.launches += 1
    return out


lane_cmpex_u32.launches = 0
