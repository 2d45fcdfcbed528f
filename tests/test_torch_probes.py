"""The port's P1/P2 probe kernels (ops/probes.py) against the Pallas
probes of scripts/exp_pallas_dma.py and scripts/exp_pallas_dma2.py.

The same seeded numpy input goes through the Pallas kernel on jax's CPU
interpreter and through the port's plain PyTorch version (which is what
the wrappers run on a CPU tensor); they must agree exactly.  The sizes
are cut down from the scripts' (R = 64 rows, N = 2^12 u32 in 2^10
blocks).  The scripts' probe functions define their kernels inside
themselves, so those kernels are re-stated here, each with the script
lines it copies; ``cmpex_rows_kernel`` is imported from the script.
Tests marked ``cuda`` hold each CUDA kernel to its plain version on the
card.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unikmer_tpu_torch.ops import probes
from unikmer_tpu_torch import probes as probe_main

REPO = Path(__file__).resolve().parent.parent
R = 64
N, BLK = 1 << 12, 1 << 10


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DMA2 = _script("exp_pallas_dma2")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def u32_block(seed, shape):
    """Random u32 values with the extremes 0, 2^31 - 1, 2^31, 2^32 - 1."""
    x = np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint32)
    flat = x.reshape(-1)
    extremes = np.array([0, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    flat[:4] = extremes[:len(flat[:4])]
    return x


def to_port(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def from_port(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def pallas(kernel, x, **kw):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
        interpret=True, **kw)(x))


# ---------------------------------------------------------------------
# P1a: exp_pallas_dma.py:54-90 (probe1) and exp_pallas_dma2.py:49-86
# (probe1_fixed), with N and BLK as arguments


def probe1_kernel(n, blk, fixed):
    blk_rows = blk // 128

    def kernel(hbm_in, hbm_out):
        def body(vmem, sem_in, sem_out):
            nblk = n // blk

            def step(i, _):
                off = (pl.multiple_of(i * blk_rows, blk_rows) if fixed
                       else i * blk_rows)
                cin = pltpu.make_async_copy(
                    hbm_in.at[pl.ds(off, blk_rows), :], vmem, sem_in)
                cin.start()
                cin.wait()
                vmem[:] = vmem[:] + jnp.uint32(1)
                cout = pltpu.make_async_copy(
                    vmem, hbm_out.at[pl.ds(off, blk_rows), :], sem_out)
                cout.start()
                cout.wait()
                return 0

            if fixed:
                jax.lax.fori_loop(jnp.int32(0), jnp.int32(nblk), step, 0)
            else:
                jax.lax.fori_loop(0, nblk, step, 0)

        pl.run_scoped(body, vmem=pltpu.VMEM((blk_rows, 128), jnp.uint32),
                      sem_in=pltpu.SemaphoreType.DMA,
                      sem_out=pltpu.SemaphoreType.DMA)

    return kernel


@pytest.mark.parametrize("fixed", [False, True],
                         ids=["probe1", "probe1_fixed"])
def test_p1a_plain_matches_pallas(fixed):
    x = u32_block(1, (N // 128, 128))
    want = pallas(probe1_kernel(N, BLK, fixed), x,
                  in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
                  out_specs=pl.BlockSpec(memory_space=pl.ANY),
                  compiler_params=pltpu.CompilerParams(has_side_effects=True))
    got = probes.copy_inc_u32_plain(to_port(x))
    np.testing.assert_array_equal(from_port(got), want)
    assert want.reshape(-1)[3] == 0  # 2^32 - 1 wrapped


# ---------------------------------------------------------------------
# P1b: exp_pallas_dma.py:101-121 (probe2) with R rows


def probe2_kernel(rows):
    def kernel(in_ref, out_ref):
        a = in_ref[:]
        for _ in range(64):
            top = a[: rows // 2]
            bot = a[rows // 2:]
            lo = jnp.minimum(top, bot)
            hi = jnp.maximum(top, bot)
            a = jnp.concatenate([lo, hi], axis=0)
        out_ref[:] = a

    return kernel


def test_p1b_plain_matches_pallas():
    x = u32_block(2, (R, 128))
    want = pallas(probe2_kernel(R), x)
    got = probes.row_cmpex_u32_plain(to_port(x), probes.p1b_distances(R))
    np.testing.assert_array_equal(from_port(got), want)


# ---------------------------------------------------------------------
# P1c: exp_pallas_dma.py:130-141 (probe3) with T tiles


def probe3_kernel(tiles):
    def kernel(in_ref, out_ref):
        a = in_ref[:].reshape(tiles, 128, 128)
        out_ref[:] = jnp.swapaxes(a, 1, 2).reshape(tiles * 128, 128)

    return kernel


@pytest.mark.parametrize("tiles", [1, 2])
def test_p1c_plain_matches_pallas(tiles):
    x = u32_block(3, (tiles * 128, 128))
    want = pallas(probe3_kernel(tiles), x)
    got = probes.transpose128_u32_plain(to_port(x))
    np.testing.assert_array_equal(from_port(got), want)


# ---------------------------------------------------------------------
# P2a: cmpex_rows_kernel, imported from exp_pallas_dma2.py:96


@pytest.mark.parametrize("nstages", [4, 16])
def test_p2a_plain_matches_pallas(nstages):
    x = u32_block(4 + nstages, (R, 128))
    want = pallas(DMA2.cmpex_rows_kernel(nstages, R), x,
                  scratch_shapes=[pltpu.VMEM((R, 128), jnp.uint32)])
    got = probes.row_cmpex_u32_plain(to_port(x),
                                     probes.p2a_distances(nstages, R))
    np.testing.assert_array_equal(from_port(got), want)


def test_p2a_schedule_cycles_back():
    assert probes.p2a_distances(8, 16) == [8, 4, 2, 1, 8, 4, 2, 1]
    assert probes.p2a_distances(16, 4096)[11:] == [1, 2048, 1024, 512, 256]
    assert probes.p1b_distances(R) == [R // 2] * 64


# ---------------------------------------------------------------------
# P2b: exp_pallas_dma2.py:137-150 (probe4_roll) with R rows


def probe4_kernel(rows):
    def kernel(in_ref, out_ref):
        a = in_ref[:]
        lane = jax.lax.broadcasted_iota(jnp.int32, (rows, 128), 1)
        for d in (64, 32, 16, 8, 4, 2, 1):
            b = pltpu.roll(a, shift=d, axis=1)  # partner value
            c = pltpu.roll(a, shift=128 - d, axis=1)
            partner = jnp.where((lane & d) == 0, c, b)
            is_low = (lane & d) == 0
            a = jnp.where(is_low, jnp.minimum(a, partner),
                          jnp.maximum(a, partner))
        out_ref[:] = a

    return kernel


def test_p2b_plain_matches_pallas():
    x = u32_block(5, (R, 128))
    want = pallas(probe4_kernel(R), x)
    got = probes.lane_cmpex_u32_plain(to_port(x))
    np.testing.assert_array_equal(from_port(got), want)


# ---------------------------------------------------------------------
# the wrappers on the CPU, ragged shapes, the entry point


def numpy_row_cmpex(x, distances):
    a = x.copy()
    r = np.arange(len(a))
    for d in distances:
        top = r[(r % (2 * d) < d) & (r + d < len(a))]
        lo = np.minimum(a[top], a[top + d])
        a[top + d] = np.maximum(a[top], a[top + d])
        a[top] = lo
    return a


@pytest.mark.parametrize("rows,distances", [
    (5, [2, 1, 4]), (7, [3, 3, 1]), (37, [16, 8, 4, 2, 1, 16]), (1, [1])])
def test_row_cmpex_ragged_rows(rows, distances):
    x = u32_block(rows, (rows, 3))
    got = probes.row_cmpex_u32(to_port(x), distances)
    np.testing.assert_array_equal(from_port(got), numpy_row_cmpex(x, distances))


def test_cpu_wrappers_run_plain_versions_without_launching():
    x = to_port(u32_block(6, (256, 128)))
    before = [f.launches for f in (probes.copy_inc_u32, probes.row_cmpex_u32,
                                   probes.transpose128_u32,
                                   probes.lane_cmpex_u32)]
    kernels = probes.row_cmpex_u32.kernels
    assert torch.equal(probes.copy_inc_u32(x), probes.copy_inc_u32_plain(x))
    assert torch.equal(probes.row_cmpex_u32(x, [64, 1]),
                       probes.row_cmpex_u32_plain(x, [64, 1]))
    assert torch.equal(probes.transpose128_u32(x),
                       probes.transpose128_u32_plain(x))
    assert torch.equal(probes.lane_cmpex_u32(x), probes.lane_cmpex_u32_plain(x))
    after = [f.launches for f in (probes.copy_inc_u32, probes.row_cmpex_u32,
                                  probes.transpose128_u32,
                                  probes.lane_cmpex_u32)]
    assert after == before
    assert probes.row_cmpex_u32.kernels == kernels


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError, match="int32"):
        probes.copy_inc_u32(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="128"):
        probes.transpose128_u32(torch.zeros(100, 128, dtype=torch.int32))
    with pytest.raises(ValueError, match="128"):
        probes.lane_cmpex_u32(torch.zeros(4, 64, dtype=torch.int32))
    with pytest.raises(ValueError, match=">= 1"):
        probes.row_cmpex_u32(torch.zeros(4, 4, dtype=torch.int32), [0])


def test_probe_entry_point_on_cpu(monkeypatch, capsys):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(probe_main, "N", 1 << 12)
    monkeypatch.setattr(probe_main, "ROWS", 256)
    assert probe_main.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert len(out) == 8 and all("exact=True" in line for line in out[1:])


# ---------------------------------------------------------------------
# the kernels' index arithmetic, walked block by block and thread by
# thread in numpy (csrc/probes.cu; its constants are read from the source)

CSRC = (REPO / "unikmer_tpu_torch" / "csrc" / "probes.cu").read_text()


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


THREADS, INC_VECS, SUB = (cu_const(n) for n in ("kThreads", "kIncVecs", "kSub"))


def copy_inc_partition(n, offset):
    """copy_inc_kernel's items for n u32 at ``offset`` elements past a
    16-byte boundary (the output is a fresh, aligned tensor): returns
    (how many times each element is moved, blocks launched, items)."""
    vec = offset % 4 == 0
    items = n >> 2 if vec else n
    block_items = THREADS * INC_VECS
    blocks = max(1, -(-items // block_items))  # ukt_copy_inc_u32
    b, t, u = np.meshgrid(np.arange(blocks), np.arange(THREADS),
                          np.arange(INC_VECS), indexing="ij")
    i = (b * block_items + t + u * THREADS).reshape(-1)
    i = i[i < items]
    moved = np.zeros(n, np.int64)
    if vec:
        np.add.at(moved, (4 * i[:, None] + np.arange(4)).reshape(-1), 1)
        tail = n - 4 * items  # block 0's threads t < n - head
        moved[4 * items + np.arange(THREADS)[:tail]] += 1
    else:
        np.add.at(moved, i, 1)
    return moved, blocks, items


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4099, (1 << 21) + 3])
def test_copy_inc_partition_covers_each_element_once(n, offset):
    moved, blocks, items = copy_inc_partition(n, offset)
    np.testing.assert_array_equal(moved, np.ones(n, np.int64))
    # one round: only the last block holds items past the array's end
    assert blocks * THREADS * INC_VECS - items < THREADS * INC_VECS or items == 0


def test_copy_inc_grid_at_the_probe_size():
    _, blocks, items = copy_inc_partition(probe_main.N, 0)
    assert (items, blocks) == (1 << 21, 2048)


def stage_slot(r, g, quads):
    """uint4 slot of row r, column group g of a stage of ``quads`` uint4
    a row (transpose128_kernel's stage_slot)."""
    return r * quads + (g ^ ((r >> 2) & 7))


def banks_once_a_quarter_warp(slots):
    """A 16-byte shared access is served eight threads at a time: their
    32 words must lie in 32 different banks.  ``slots``: uint4 slots of
    the block's threads in thread order."""
    words = (slots[:, None] * 4 + np.arange(4)).reshape(-1, 32)
    return all(len(set(w % 32)) == 32 for w in words)


def whole_row_segments(addrs):
    """Each warp's 16-byte global accesses cover whole 256-byte row
    segments (16 consecutive uint4 from a multiple of 16)."""
    for w in addrs.reshape(-1, 32):
        segs = np.unique(w // 16)
        if len(np.unique(w)) != 32 or len(segs) * 16 != 32:
            return False
    return True


def transpose128_walk(x, sub=SUB):
    """transpose128_kernel over (T*128, 128) u32 ``x``, block by block,
    with one shared-memory stage per block; returns (output, whether
    every shared access is free of bank conflicts, whether every global
    access moves whole row segments)."""
    quads = sub // 4
    per_side = 128 // sub
    tiles = x.shape[0] // 128
    x4 = x.reshape(tiles, 128, 32, 4)
    out4 = np.zeros_like(x4)
    banks_ok = rows_ok = True
    for b in range(tiles * per_side * per_side):
        t, s = divmod(b, per_side * per_side)
        sr, sc = divmod(s, per_side)
        stage = np.full((sub * quads, 4), -1, np.int64)
        for q in range(quads * quads // THREADS):
            s_ = np.arange(THREADS) + q * THREADS
            g, p = s_ % quads, s_ // quads
            rows = sr * sub + 4 * p[:, None] + np.arange(4)  # [thread, k]
            cols = sc * quads + g
            rows_ok &= all(whole_row_segments(rows[:, k] * 32 + cols)
                           for k in range(4))
            a = x4[t, rows, cols[:, None]]  # [thread, k, component]
            for e in range(4):
                slot = stage_slot(4 * g + e, p, quads)
                banks_ok &= banks_once_a_quarter_warp(slot)
                stage[slot] = a[:, :, e]
        assert (stage >= 0).all()  # every slot written, none twice below
        for q in range(sub * quads // THREADS):
            i = np.arange(THREADS) + q * THREADS
            r, g = i // quads, i % quads
            slot = stage_slot(r, g, quads)
            banks_ok &= banks_once_a_quarter_warp(slot)
            orow, ocol = sc * sub + r, sr * quads + g
            rows_ok &= whole_row_segments(orow * 32 + ocol)
            out4[t, orow, ocol] = stage[slot]
    return out4.reshape(x.shape), banks_ok, rows_ok


@pytest.mark.parametrize("sub", [SUB, 128], ids=["as_built", "whole_tile"])
@pytest.mark.parametrize("tiles", [1, 3])
def test_transpose128_walk_matches_swapaxes(tiles, sub):
    x = u32_block(11 + tiles, (tiles * 128, 128))
    got, banks_ok, rows_ok = transpose128_walk(x, sub)
    want = np.swapaxes(x.reshape(tiles, 128, 128), 1, 2).reshape(-1, 128)
    np.testing.assert_array_equal(got, want)
    assert banks_ok and rows_ok


def test_transpose128_walk_catches_an_unswizzled_stage(monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "stage_slot",
                        lambda r, g, quads: r * quads + g)
    got, banks_ok, _ = transpose128_walk(u32_block(14, (128, 128)))
    np.testing.assert_array_equal(
        got, u32_block(14, (128, 128)).T)  # still a transpose, but
    assert not banks_ok  # eight-way conflicts on the stage's writes


# ---------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65536, 128), (3, 5), (1, 1), (7, 128),
                                   (4099,), ((1 << 21) + 3,)])
def test_copy_inc_on_card(cuda_device, shape):
    x = to_port(u32_block(7, shape)).to(cuda_device)
    assert torch.equal(probes.copy_inc_u32(x), probes.copy_inc_u32_plain(x))
    # an offset view: not 16-byte aligned, the kernel's scalar path
    y = x.reshape(-1)[1:]
    assert torch.equal(probes.copy_inc_u32(y), probes.copy_inc_u32_plain(y))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,distances", [
    (4096, 128, probes.p1b_distances(4096)),
    (4096, 128, probes.p2a_distances(4, 4096)),
    (4096, 128, probes.p2a_distances(16, 4096)),
    (4096, 128, probes.p2a_distances(64, 4096)),
    (37, 128, [16, 8, 4, 2, 1, 16]), (5, 3, [2, 1, 4]),
    (300, 7, [3] * 300),  # one pass for 300 stages at one distance
    (1000, 6, [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]),  # a ragged tile
    (1 << 17, 4, [1 << b for b in range(16, -1, -1)]),  # tile, then registers
    (70001, 3, [1 << b for b in range(16, -1, -1)] + [5, 5, 70000]),
    (65537, 2, [32768, 3, 1, 50000]),  # past the first design's 40,960 rows
    (1 << 16, 128, probes.p2a_distances(64, 1 << 16)),  # column-group tiles
    (1 << 13, 528, probes.p2a_distances(16, 1 << 13)),
    (1 << 13, 528, [1 << b for b in range(12, -1, -1)] + [5])])
def test_row_cmpex_on_card(cuda_device, rows, cols, distances):
    x = to_port(u32_block(8, (rows, cols))).to(cuda_device)
    assert torch.equal(probes.row_cmpex_u32(x, distances),
                       probes.row_cmpex_u32_plain(x, distances))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,distances,kernels", [
    (4096, 128, probes.p1b_distances(4096), 1),
    (4096, 128, probes.p2a_distances(64, 4096), 1),
    (65537, 2, [32768, 3, 1, 50000], 4),
    (1 << 16, 128, probes.p2a_distances(64, 1 << 16), 6)])
def test_row_cmpex_counts_its_kernels_on_card(cuda_device, rows, cols,
                                              distances, kernels):
    x = to_port(u32_block(8, (rows, cols))).to(cuda_device)
    k0, l0 = probes.row_cmpex_u32.kernels, probes.row_cmpex_u32.launches
    probes.row_cmpex_u32(x, distances)
    assert probes.row_cmpex_u32.launches - l0 == 1
    assert probes.row_cmpex_u32.kernels - k0 == kernels
    assert len(row_cmpex_plan(rows, distances, cols % 4 == 0)) == kernels


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 3, 32])
def test_transpose128_on_card(cuda_device, tiles):
    x = to_port(u32_block(9, (tiles * 128, 128))).to(cuda_device)
    assert torch.equal(probes.transpose128_u32(x),
                       probes.transpose128_u32_plain(x))
    # a view 4 bytes past a 16-byte boundary
    y = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda_device)
    y = y[1:].view_as(x).copy_(x)
    assert torch.equal(probes.transpose128_u32(y),
                       probes.transpose128_u32_plain(x))


@pytest.mark.cuda
def test_transpose128_past_65535_tiles(cuda_device):
    """65,537 tiles (4.3 GB each way): more than a grid's z extent."""
    tiles = 65537
    x = torch.arange(tiles * 128 * 128, dtype=torch.int32,
                     device=cuda_device).view(-1, 128)
    got = probes.transpose128_u32(x)
    assert torch.equal(got, probes.transpose128_u32_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 9, 4096])
def test_lane_cmpex_on_card(cuda_device, rows):
    x = to_port(u32_block(10, (rows, 128))).to(cuda_device)
    assert torch.equal(probes.lane_cmpex_u32(x), probes.lane_cmpex_u32_plain(x))


# ---------------------------------------------------------------------
# row_cmpex_u32's host plan and its three routes (registers, tile, pass),
# walked in numpy with the constants of csrc/probes.cu

REG_BITS, TILE_BITS, VEC_TILE_BITS, MAX_STAGES = (
    cu_const(n) for n in ("kRegBits", "kTileBits", "kVecTileBits",
                          "kMaxStages"))


def popcount(x):
    return bin(x).count("1")


def bits_of(mask):
    return [b for b in range(mask.bit_length()) if (mask >> b) & 1]


def deposit(x, mask):
    """x's bits placed, lowest first, at the set bits of mask (x an int
    array)."""
    r = np.zeros_like(x)
    for i, b in enumerate(bits_of(mask)):
        r |= ((x >> i) & 1) << b
    return r


def as_runs(qs):
    """Stages as runs [(q, repeats)] (the kernels' Runs)."""
    runs = []
    for q in qs:
        if runs and runs[-1][0] == q:
            runs[-1] = (q, runs[-1][1] + 1)
        else:
            runs.append((q, 1))
    return runs


def row_cmpex_plan(rows, distances, column_groups=False):
    """ukt_row_cmpex_u32's launches for the wrapper's distances (those
    below R): ("pass", d, reps), ("regs", umask, runs) or ("tile", umask,
    [(pmask, runs)]), a run (q, repeats) of stages on the bit at position
    q of the thread's register set; a tile of column groups links at most
    VEC_TILE_BITS bits."""
    tile_max = VEC_TILE_BITS if column_groups else TILE_BITS
    ds = [d for d in distances if d < rows]
    plan, i = [], 0
    while i < len(ds):
        d, j = ds[i], i + 1
        if d & (d - 1):
            while j < len(ds) and ds[j] == d:
                j += 1
            plan.append(("pass", d, j - i))
        else:
            u = d
            while (j < len(ds) and j - i < MAX_STAGES
                   and not ds[j] & (ds[j] - 1)
                   and popcount(u | ds[j]) <= tile_max):
                u |= ds[j]
                j += 1
            tbit = [popcount(u & (ds[s] - 1)) for s in range(i, j)]
            if popcount(u) <= REG_BITS:
                plan.append(("regs", u, as_runs(tbit)))
            else:
                phases, cur, run = [], 0, []
                for b in tbit + [None]:
                    if b is None or popcount(cur | 1 << b) > REG_BITS:
                        pm = cur
                        for f in bits_of(((1 << popcount(u)) - 1) & ~pm):
                            if popcount(pm) == REG_BITS:
                                break
                            pm |= 1 << f
                        phases.append((pm, as_runs(
                            [popcount(pm & ((1 << s) - 1)) for s in run])))
                        cur, run = 0, []
                    if b is not None:
                        cur |= 1 << b
                        run.append(b)
                plan.append(("tile", u, phases))
        i = j
    return plan


ABSENT = np.uint32(0xFFFFFFFF)  # a row past R in registers and the tile


def cmpex_regs(v, runs):
    """Stage runs on slots v[u] (u < 2^PB, each an array): a stage on bit
    q pairs u and u | 2^q, with no check: a row past R holds ABSENT."""
    for q, reps in runs:
        for _ in range(reps):
            for u in range(len(v)):
                w = u | 1 << q
                if not u >> q & 1:
                    v[u], v[w] = np.minimum(v[u], v[w]), np.maximum(v[u], v[w])


def tile_slot(t, v):
    """Shared-memory slot of tile row t, a slot holding v u32."""
    if v == 4:
        return t ^ ((t >> 4) & 7)
    return t ^ (((t >> 5) & 31) ^ ((t >> 4) & 16))


class RowWalk:
    """The routes over an (R, C) u32 array: the first launch reads ``x``
    and writes ``out``, the others work on ``out``; records whether every
    row was written, each warp's global accesses and each tile phase's
    banks.  A tile holds ``tile_v`` columns (4: a column group)."""

    def __init__(self, x, vec, tile_v):
        self.x, self.out = x, np.zeros_like(x)
        self.written = np.zeros(x.shape, bool)
        self.first = True
        self.v = 4 if vec else 1
        self.tile_v = tile_v
        self.rows, self.cols = x.shape
        self.nbits = (self.rows - 1).bit_length()
        self.sectors = []  # (sectors a warp access touches, the least it could)
        self.bank_hits = []  # per warp tile access: most threads on a bank

    def src(self):
        return self.x if self.first else self.out

    def store(self, r, c, val, ok):
        self.out[r[ok], c[ok]] = val[ok]
        self.written[r[ok], c[ok]] = True

    def note_warps(self, r, c):
        flat_r, flat_c = r.reshape(-1), c.reshape(-1)
        for w in range(0, len(flat_r), 32):
            a = flat_r[w:w + 32] * self.cols * 4 + flat_c[w:w + 32] * 4
            least = -(-len(a) * 4 * self.v // 32)
            self.sectors.append((len(np.unique(a // 32)), least))

    def regs(self, umask, runs):
        pb, v = popcount(umask), self.v
        groups = self.cols // v
        threads = (1 << (self.nbits - pb)) * groups
        tid = np.arange(threads)
        cg, base = tid % groups, deposit(tid // groups, ((1 << self.nbits) - 1) & ~umask)
        rows = [base | deposit(np.full_like(base, u), umask) for u in range(1 << pb)]
        present = [r < self.rows for r in rows]
        cols = cg[:, None] * v + np.arange(v)
        src = self.src()
        vals = [np.where(p[:, None], src[np.minimum(r, self.rows - 1)[:, None], cols],
                         ABSENT) for r, p in zip(rows, present)]
        for r in rows:
            self.note_warps(r, cg * v)
        cmpex_regs(vals, runs)
        for r, p, val in zip(rows, present, vals):
            self.store(np.broadcast_to(r[:, None], cols.shape), cols, val,
                       np.broadcast_to(p[:, None], cols.shape))
        self.first = False

    def tile(self, umask, phases):
        tbits, v = popcount(umask), self.tile_v
        nt = 1 << (tbits - REG_BITS)
        groups = self.cols // v
        blocks = (1 << (self.nbits - tbits)) * groups
        b = np.arange(blocks)[:, None]
        col = (b % groups)[:, :, None] * v + np.arange(v)  # (blocks, 1, v)
        base = deposit(b // groups, ((1 << self.nbits) - 1) & ~umask)
        tau = np.arange(nt)[None, :]
        tall = (1 << tbits) - 1
        smem = np.zeros((blocks, 1 << tbits, v), self.x.dtype)
        src = self.src()
        for p, (pm, runs) in enumerate(phases):
            assert popcount(pm) == REG_BITS
            tb = deposit(tau, tall & ~pm)
            t = [tb | deposit(np.full_like(tb, u), pm) for u in range(16)]
            rows = [np.broadcast_to(base | deposit(tt, umask), (blocks, nt))[..., None]
                    for tt in t]
            present = [r < self.rows for r in rows]
            slots = [np.broadcast_to(tile_slot(tt, v), (blocks, nt)) for tt in t]
            if p == 0:
                vals = [np.where(pr, src[np.minimum(r, self.rows - 1), col], ABSENT)
                        for r, pr in zip(rows, present)]
            else:
                vals = [smem[b, slot] for slot in slots]
                for slot in slots:  # the reads of phase p, then its writes
                    self.note_banks(slot, v)
            cmpex_regs(vals, runs)
            if p + 1 == len(phases):
                for r, pr, val in zip(rows, present, vals):
                    shape = val.shape
                    self.store(np.broadcast_to(r, shape), np.broadcast_to(col, shape),
                               val, np.broadcast_to(pr, shape))
            else:
                for slot, val in zip(slots, vals):
                    smem[b, slot] = val
                    self.note_banks(slot, v)
        self.first = False

    def note_banks(self, slots, v):
        """Most threads on one bank in each shared access of block 0's
        threads: 32 // v threads at a time, v words each."""
        per = 32 // v
        for w in range(0, slots.shape[1], per):
            words = (slots[0, w:w + per, None] * v + np.arange(v)).reshape(-1)
            self.bank_hits.append(np.bincount(words % 32).max())

    def pass_(self, d, reps):
        v, groups = self.v, self.cols // self.v
        full, rem = divmod(self.rows, 2 * d)
        top = full * d + min(rem, d)
        tid = np.arange(top * groups)
        p, cg = tid // groups, tid % groups
        r = (p // d) * 2 * d + p % d
        paired = r + d < self.rows
        cols = cg[:, None] * v + np.arange(v)
        src = self.src()
        a = src[r[:, None], cols]
        b = src[np.minimum(r + d, self.rows - 1)[:, None], cols]
        for _ in range(reps):
            a, b = np.minimum(a, b), np.maximum(a, b)
        keep = src[r[:, None], cols]
        pr = np.broadcast_to(paired[:, None], cols.shape)
        self.store(np.broadcast_to(r[:, None], cols.shape), cols,
                   np.where(pr, a, keep), np.broadcast_to(True, cols.shape))
        self.store(np.broadcast_to((r + d)[:, None], cols.shape), cols, b, pr)
        self.first = False


def row_cmpex_walk(x, distances, column_groups=None):
    """The kernels' result for the wrapper's call, and the walk; tiles of
    column groups where ``column_groups`` (default: where C % 4 == 0, as
    the kernels take a 16-byte aligned array)."""
    rows, cols = x.shape
    if column_groups is None:
        column_groups = cols % 4 == 0
    walk = RowWalk(x, vec=cols % 4 == 0, tile_v=4 if column_groups else 1)
    for launch in row_cmpex_plan(rows, distances, column_groups):
        {"pass": walk.pass_, "regs": walk.regs, "tile": walk.tile}[launch[0]](
            *launch[1:])
    if walk.first:  # no stage pairs rows: the wrapper's clone
        return x.copy(), walk
    assert walk.written.all()  # every row written by the first launch
    return walk.out, walk


P2A_4096 = {s: probes.p2a_distances(s, 4096) for s in (4, 16, 64)}


def test_row_cmpex_plan_of_the_probes():
    assert row_cmpex_plan(4096, probes.p1b_distances(4096), True) == [
        ("regs", 2048, [(0, 64)])]
    assert row_cmpex_plan(4096, P2A_4096[4], True) == [
        ("regs", 0xF00, [(3, 1), (2, 1), (1, 1), (0, 1)])]
    for s, nphases in ((16, 4), (64, 16)):
        (route, umask, phases), = row_cmpex_plan(4096, P2A_4096[s], True)
        assert (route, umask, len(phases)) == ("tile", 0xFFF, nphases)
        assert [pm for pm, _ in phases[:4]] == [0xF00, 0xF0, 0xF, 0xF00]
        assert phases[0][1] == [(3, 1), (2, 1), (1, 1), (0, 1)]
        assert sum(n for _, runs in phases for _, n in runs) == s
    assert row_cmpex_plan(65537, [32768, 3, 1, 50000]) == [
        ("regs", 32768, [(0, 1)]), ("pass", 3, 1), ("regs", 1, [(0, 1)]),
        ("pass", 50000, 1)]
    assert row_cmpex_plan(64, [4, 4, 2, 4]) == [
        ("regs", 6, [(1, 2), (0, 1), (1, 1)])]
    assert row_cmpex_plan(300, [3] * 300 + [512]) == [("pass", 3, 300)]


@pytest.mark.parametrize("rows,cols,distances", [
    (4096, 128, probes.p1b_distances(4096)),
    (4096, 8, P2A_4096[4]), (4096, 8, P2A_4096[16]), (4096, 4, P2A_4096[64]),
    (37, 5, [16, 8, 4, 2, 1, 16]), (5, 3, [2, 1, 4]), (1, 2, [1]),
    (300, 7, [3] * 300),
    (1000, 6, [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]),  # a ragged tile
    (1 << 15, 1, [1 << b for b in range(14, -1, -1)] * 2),  # tile, registers
    (65537, 2, [32768, 3, 1, 50000]),  # past the first design's 40,960 rows
    (70001, 3, [1 << b for b in range(16, -1, -1)] + [5, 5, 70000]),
], ids=lambda v: str(v) if isinstance(v, int) else f"{len(v)}stages")
def test_row_cmpex_walk_matches_numpy_and_plain(rows, cols, distances):
    x = u32_block(rows + cols, (rows, cols))
    got, walk = row_cmpex_walk(x, distances)
    want = numpy_row_cmpex(x, [d for d in distances])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        from_port(probes.row_cmpex_u32_plain(to_port(x), distances)), want)
    if rows == 4096:  # the probes: whole rows a warp, 32 banks a warp
        assert walk.sectors or walk.bank_hits
        assert all(n == least for n, least in walk.sectors) or cols < 32
        assert all(h == 1 for h in walk.bank_hits)


def test_row_cmpex_walk_matches_the_pallas_probes():
    x = u32_block(21, (R, 128))
    got, _ = row_cmpex_walk(x, probes.p1b_distances(R))
    np.testing.assert_array_equal(got, pallas(probe2_kernel(R), x))
    for nstages in (4, 16):
        got, walk = row_cmpex_walk(x, probes.p2a_distances(nstages, R))
        want = pallas(DMA2.cmpex_rows_kernel(nstages, R), x,
                      scratch_shapes=[pltpu.VMEM((R, 128), jnp.uint32)])
        np.testing.assert_array_equal(got, want)


def test_row_cmpex_walk_catches_an_unswizzled_tile(monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "tile_slot", lambda t, v: t)
    x = u32_block(22, (4096, 2))
    got, walk = row_cmpex_walk(x, P2A_4096[16])
    np.testing.assert_array_equal(got, numpy_row_cmpex(x, P2A_4096[16]))
    assert max(walk.bank_hits) > 1  # still right, but threads share banks
    x = u32_block(22, (4096, 4))
    got, walk = row_cmpex_walk(x, P2A_4096[16], column_groups=True)
    np.testing.assert_array_equal(got, numpy_row_cmpex(x, P2A_4096[16]))
    assert max(walk.bank_hits) > 1


@pytest.mark.parametrize("column_groups", [True, False],
                         ids=["column_groups", "one_column"])
@pytest.mark.parametrize("rows,cols,distances", [
    (4096, 4, probes.p1b_distances(4096)),
    (4096, 8, P2A_4096[16]), (4096, 4, P2A_4096[64]),
    (1000, 8, [512, 256, 128, 64, 32, 16, 8, 4, 2, 1]),  # a ragged tile
    (1 << 15, 4, [1 << b for b in range(14, -1, -1)] * 2),  # 12-bit tiles
    (70001, 4, [1 << b for b in range(16, -1, -1)] + [5, 5, 70000]),
], ids=lambda v: str(v) if isinstance(v, int) else f"{len(v)}stages")
def test_row_cmpex_walk_of_both_tile_widths(rows, cols, distances,
                                            column_groups):
    x = u32_block(rows + cols + 1, (rows, cols))
    got, walk = row_cmpex_walk(x, distances, column_groups)
    np.testing.assert_array_equal(got, numpy_row_cmpex(x, distances))
    if rows == 4096:  # a warp's (a quarter-warp's) tile accesses on 32 banks
        assert all(h == 1 for h in walk.bank_hits)
    most = VEC_TILE_BITS if column_groups else TILE_BITS
    for launch in row_cmpex_plan(rows, distances, column_groups):
        if launch[0] == "tile":
            assert popcount(launch[1]) <= most


def test_row_cmpex_plan_of_column_group_tiles():
    plan = row_cmpex_plan(1 << 16, probes.p2a_distances(64, 1 << 16), True)
    assert [r for r, *_ in plan] == ["tile"] * 5 + ["regs"]
    assert [u for _, u, _ in plan] == [0xFFF0, 0xFF0F, 0xF0FF, 0x0FFF,
                                       0xFFF0, 0x000F]
    stages = sum(n for _, _, ph in plan[:-1] for _, runs in ph for _, n in runs)
    assert stages + sum(n for _, n in plan[-1][2]) == 64
