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
    rows = len(a)
    for d in distances:
        for r in range(rows):
            if r % (2 * d) < d and r + d < rows:
                lo = np.minimum(a[r], a[r + d])
                a[r + d] = np.maximum(a[r], a[r + d])
                a[r] = lo
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
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(65536, 128), (3, 5), (1, 1), (7, 128)])
def test_copy_inc_on_card(cuda_device, shape):
    x = to_port(u32_block(7, shape)).to(cuda_device)
    assert torch.equal(probes.copy_inc_u32(x), probes.copy_inc_u32_plain(x))
    # an offset view: not 16-byte aligned, the kernel's scalar path
    y = x.reshape(-1)[1:]
    assert torch.equal(probes.copy_inc_u32(y), probes.copy_inc_u32_plain(y))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,distances", [
    (4096, 128, probes.p1b_distances(4096)),
    (4096, 128, probes.p2a_distances(16, 4096)),
    (37, 128, [16, 8, 4, 2, 1, 16]), (5, 3, [2, 1, 4]),
    (300, 7, [3] * 300),  # past one launch's 256 stages
    (probes.ROW_CMPEX_MAX_ROWS, 2, [16384, 3, 1, 50000])])
def test_row_cmpex_on_card(cuda_device, rows, cols, distances):
    x = to_port(u32_block(8, (rows, cols))).to(cuda_device)
    assert torch.equal(probes.row_cmpex_u32(x, distances),
                       probes.row_cmpex_u32_plain(x, distances))
    if rows == probes.ROW_CMPEX_MAX_ROWS:
        with pytest.raises(ValueError, match="at most"):
            probes.row_cmpex_u32(torch.zeros(rows + 1, 1, dtype=torch.int32,
                                             device=cuda_device), [1])


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [1, 3, 32])
def test_transpose128_on_card(cuda_device, tiles):
    x = to_port(u32_block(9, (tiles * 128, 128))).to(cuda_device)
    assert torch.equal(probes.transpose128_u32(x),
                       probes.transpose128_u32_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 9, 4096])
def test_lane_cmpex_on_card(cuda_device, rows):
    x = to_port(u32_block(10, (rows, 128))).to(cuda_device)
    assert torch.equal(probes.lane_cmpex_u32(x), probes.lane_cmpex_u32_plain(x))
