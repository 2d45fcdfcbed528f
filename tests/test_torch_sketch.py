"""The port's sketches (ops/sketch.py: minimizer, closed syncmer, compat
syncmer) against the JAX package's ops/sketch.py, and S1 (plain version on
the CPU) composed with H1's plain version against the JAX count's window
codes.  S1's kernel (csrc/sketch.cu) is walked block by block in numpy,
and held to its plain version on the card (marked ``cuda``; skipped
without one).  Exact equality throughout: hashes and positions are
integers."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unikmer_tpu.io.fastx import Record, pack_records
from unikmer_tpu.models import count as jax_count
from unikmer_tpu.ops import sketch as jax_sketch
from unikmer_tpu_torch.models.count import pack_bases_2bit
from unikmer_tpu_torch.ops import nthash, sketch

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def sketch_bases(seed, n=2500):
    """Random bases with invalid singletons, an N run, a poly-A run and a
    repeated stretch (equal hashes: the leftmost rule decides)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, size=n, dtype=np.uint8)
    b[rng.random(n) < 0.005] = 255
    if n > 1200:
        b[300:340] = 255
        b[500:620] = 0
        b[900:1100] = b[700:900]
    return b


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def assert_stream_equal(got, want, n):
    (gc, ge), (wc, we) = got, want
    we = np.asarray(we)
    np.testing.assert_array_equal(ge.numpy(), we)
    np.testing.assert_array_equal(u64(gc), np.asarray(wc))
    assert len(we) == n


@pytest.mark.parametrize("w", [1, 2, 5, 15, 16, 100])
@pytest.mark.parametrize("k", [5, 15, 31, 64])
def test_minimizer_windows_matches_jax(k, w):
    b = sketch_bases(k * 1000 + w)
    want = jax_sketch.minimizer_windows(jnp.asarray(b), k, w)
    got = sketch.minimizer_windows(torch.from_numpy(b), k, w)
    assert_stream_equal(got, want, len(b))
    assert got[1].sum() > len(b) // (4 * w)


@pytest.mark.parametrize("k,s", [(16, 1), (16, 9), (16, 16), (31, 1),
                                 (31, 9), (31, 16), (31, 31), (64, 16)])
def test_syncmer_windows_matches_jax(k, s):
    b = sketch_bases(k * 100 + s)
    want = jax_sketch.syncmer_windows(jnp.asarray(b), k, s)
    got = sketch.syncmer_windows(torch.from_numpy(b), k, s)
    assert_stream_equal(got, want, len(b))
    assert got[1].sum() > 50


def compat_packed(seed, k, s):
    """Records packed with compat_gap separators: long and short ones
    (shorter than k, and than the W = 2(k-s) vote window), N runs and a
    record repeated."""
    rng = np.random.default_rng(seed)
    lens = [1500, 3, k - 1, k, k + 1, 2 * (k - s) + 2, 700, 2000]
    recs = []
    for i, n in enumerate(lens):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n,
                         p=[.245, .245, .245, .245, .02])
        recs.append(Record(b"r%d" % i, b"r%d" % i, seq.tobytes()))
    recs.append(recs[0])
    return pack_records(recs, k, gap=jax_sketch.compat_gap(k, s))


@pytest.mark.parametrize("k,s", [(31, 16), (31, 9), (21, 11), (21, 1),
                                 (15, 14), (31, 31)])
def test_syncmer_compat_windows_matches_jax(k, s):
    assert sketch.compat_gap(k, s) == jax_sketch.compat_gap(k, s)
    b = compat_packed(k * 100 + s, k, s).bases
    want = jax_sketch.syncmer_compat_windows(jnp.asarray(b), k, s)
    got = sketch.syncmer_compat_windows(torch.from_numpy(b), k, s)
    assert_stream_equal(got, want, len(b))
    assert got[1].sum() > 100


EDGES = {
    "shorter than w": np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8),
    "one base": np.array([2], np.uint8),
    "all N": np.full(60, 255, np.uint8),
    "poly-A": np.zeros(300, np.uint8),
    "period 4": np.tile(np.array([0, 1, 2, 3], np.uint8), 90),
    "N runs": np.where(np.arange(400) % 50 < 40,
                       np.arange(400) % 4, 255).astype(np.uint8),
}


@pytest.mark.parametrize("name", sorted(EDGES))
def test_sketch_edge_inputs_match_jax(name):
    b = EDGES[name]
    jb, tb = jnp.asarray(b), torch.from_numpy(b)
    for k, w in ((5, 1), (5, 4), (5, 11), (9, 40)):
        assert_stream_equal(sketch.minimizer_windows(tb, k, w),
                            jax_sketch.minimizer_windows(jb, k, w), len(b))
    for k, s in ((9, 4), (9, 9), (7, 1)):
        assert_stream_equal(sketch.syncmer_windows(tb, k, s),
                            jax_sketch.syncmer_windows(jb, k, s), len(b))
        if len(b) > 2 * (k - s):  # the JAX mark loop needs n > W
            assert_stream_equal(sketch.syncmer_compat_windows(tb, k, s),
                                jax_sketch.syncmer_compat_windows(jb, k, s),
                                len(b))


def test_window_argmin_leftmost_on_ties():
    keys = torch.tensor([5, 3, 3, -1, 3, 7, -1, -1], dtype=torch.int64)
    got = sketch.sketch_select("argmin", keys, 3)
    # -1 is 2^64-1, the largest key in unsigned order
    assert got.tolist() == [1, 1, 2, 4, 4, 5, 6, 7]


# ---------------------------------------------------------------------
# S1 on H1's outputs against the JAX count's window codes

SELECT_CONFIGS = [
    dict(k=31, minimizer_w=15),
    dict(k=21, minimizer_w=5, scale=4),
    dict(k=64, minimizer_w=3),
    dict(k=31, syncmer_s=16),
    dict(k=21, syncmer_s=9, scale=3),
    dict(k=21, syncmer_s=21),
    dict(k=31, syncmer_s=16, syncmer_impl="compat"),
    dict(k=21, syncmer_s=9, syncmer_impl="compat", scale=2),
    dict(k=15, syncmer_s=15, syncmer_impl="compat"),
]


@pytest.mark.parametrize("kw", SELECT_CONFIGS, ids=str)
def test_encode_sketch_matches_jax_count_step_codes(kw):
    """H1 (plain) at scale 1, then S1 (plain) with the threshold: the
    count's keyed codes, as the JAX count_step keys them (window_codes,
    then the scaled filter on the selected code)."""
    from unikmer_tpu_torch.models import count as port_count

    jcfg = jax_count.CountConfig(**kw)
    cfg = port_count.CountConfig.from_reference(jcfg)
    b = (compat_packed(cfg.k, cfg.k, cfg.syncmer_s).bases
         if cfg.needs_record_sep else sketch_bases(cfg.k + cfg.scale, 4000))
    codes, valid = jax_count.window_codes(jnp.asarray(b), jcfg)
    codes, valid = np.asarray(codes), np.array(valid)
    valid &= codes <= np.uint64(nthash.scaled_max_hash(cfg.scale))
    keyed, got_valid = port_count._encode_piece(b, cfg, torch.device("cpu"))
    np.testing.assert_array_equal(got_valid.numpy(), valid)
    np.testing.assert_array_equal(u64(keyed), np.where(valid, codes, SENT))
    assert valid.sum() > 40


def test_sketch_select_rejects_bad_inputs():
    keys = torch.zeros(8, dtype=torch.int64)
    valid = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="mode"):
        sketch.sketch_select("maximizer", keys, 3, valid)
    with pytest.raises(ValueError, match=">= 1"):
        sketch.sketch_select("minimizer", keys, 0, valid)
    with pytest.raises(ValueError, match="valid"):
        sketch.sketch_select("minimizer", keys, 3)
    with pytest.raises(ValueError, match="khash"):
        sketch.sketch_select("syncmer", keys, 3, valid)
    with pytest.raises(ValueError, match="match keys"):
        sketch.sketch_select("minimizer", keys, 3, valid[:5])
    with pytest.raises(ValueError, match="max_hash"):
        sketch.sketch_select("minimizer", keys, 3, valid, max_hash=1 << 64)
    out, ok = sketch.sketch_select("minimizer", keys[:0], 3, valid[:0])
    assert out.shape == ok.shape == (0,)


# ---------------------------------------------------------------------
# S1's kernel walked block by block in numpy (csrc/sketch.cu; its tile
# constants are read from the source)

CSRC = (Path(__file__).resolve().parent.parent / "unikmer_tpu_torch" / "csrc"
        / "sketch.cu").read_text()


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


TILE = cu_const("kTile")
STRIDE = TILE - 1  # kStride
POISON = np.uint64(0x5A5A5A5A5A5A5A5A)


def s1_walk(mode, keys, w, valid=None, khash=None, max_hash=nthash.MAX_HASH):
    """sketch_select_kernel over n windows, block by block: the staged
    elements [lo, lo + kTile + w - 1) with lo = b * kStride - 1, each
    window's leftmost argmin by a scan of its w elements, and the writes
    of windows lo + 1 .. lo + kTile - 1.  Every slot must be written once."""
    keys = keys.view(np.uint64)
    n = len(keys)
    out = np.full(n, POISON, np.uint64)
    out_valid = np.full(n, 7, np.uint8)
    writes = np.zeros(n, np.int64)
    for blk in range(-(-n // STRIDE)):
        lo = blk * STRIDE - 1
        e = lo + np.arange(TILE + w - 1)
        inside = (e >= 0) & (e < n)
        sk = np.where(inside, keys[np.clip(e, 0, max(n - 1, 0))], SENT)
        r = np.arange(TILE)
        r = r[lo + r < n]
        win = np.lib.stride_tricks.sliding_window_view(sk, w)[r]
        arg = r + np.argmin(win, axis=1)  # numpy: the first minimum
        rr, i = r[r >= 1], lo + r[r >= 1]
        if mode == "argmin":
            out[i] = lo + arg[rr]
        elif mode == "minimizer":
            sv = inside & (valid[np.clip(e, 0, max(n - 1, 0))] != 0)
            ok = np.lib.stride_tricks.sliding_window_view(sv, w)[r].all(1)
            emit = ok[rr] & (~ok[rr - 1] | (arg[rr] != arg[rr - 1]))
            code = sk[arg[rr]]
            keep = emit & (code <= np.uint64(max_hash))
            out[i] = np.where(keep, code, SENT)
            out_valid[i] = keep
        else:
            off = arg[rr] - rr
            code = khash.view(np.uint64)[i]
            keep = ((valid[i] != 0) & ((off == 0) | (off == w - 1))
                    & (code <= np.uint64(max_hash)))
            out[i] = np.where(keep, code, SENT)
            out_valid[i] = keep
        writes[i] += 1
    assert (writes == 1).all()
    return out if mode == "argmin" else (out, out_valid)


def h1_outputs(rng, n, k):
    b = sketch_bases(int(rng.integers(1 << 30)), n)
    p2, vm = (torch.from_numpy(a) for a in pack_bases_2bit(b))
    return nthash.encode_nthash(p2, vm, n, k, True)


S1_WALK_NS = (1, 2, 14, STRIDE - 1, STRIDE, STRIDE + 1, TILE + 1,
              2 * STRIDE - 1, 2 * STRIDE + 1, 3 * STRIDE + 500)


@pytest.mark.parametrize("w", [1, 2, 15, 16, TILE + 300])
def test_s1_walk_matches_plain(w):
    rng = np.random.default_rng(w)
    for n in S1_WALK_NS:
        kkeyed, kvalid = h1_outputs(rng, n, 21)
        skeyed, _ = h1_outputs(rng, n, 9)
        mh = nthash.scaled_max_hash(3)
        got = s1_walk("minimizer", kkeyed.numpy(), w, kvalid.numpy(),
                      max_hash=mh)
        want = sketch.sketch_select("minimizer", kkeyed, w, kvalid,
                                    max_hash=mh)
        np.testing.assert_array_equal(got[0], u64(want[0]), err_msg=f"n={n}")
        np.testing.assert_array_equal(got[1], want[1].numpy())
        got = s1_walk("syncmer", skeyed.numpy(), w, kvalid.numpy(),
                      kkeyed.numpy())
        want = sketch.sketch_select("syncmer", skeyed, w, kvalid, kkeyed)
        np.testing.assert_array_equal(got[0], u64(want[0]), err_msg=f"n={n}")
        np.testing.assert_array_equal(got[1], want[1].numpy())
        np.testing.assert_array_equal(
            s1_walk("argmin", skeyed.numpy(), w),
            sketch.sketch_select("argmin", skeyed, w).numpy())


# ---------------------------------------------------------------------
# on the card


def s1_cases(rng, dev, n, w):
    """(mode, args, kwargs) of each S1 mode over n windows of width w, on
    the card, with a scaled threshold."""
    kkeyed, kvalid = (t.to(dev) for t in h1_outputs(rng, n, 31))
    skeyed = h1_outputs(rng, n, 16)[0].to(dev)
    mh = nthash.scaled_max_hash(7)
    return [("minimizer", (kkeyed, w, kvalid), dict(max_hash=mh)),
            ("minimizer", (kkeyed, w, kvalid), {}),
            ("syncmer", (skeyed, w, kvalid, kkeyed), dict(max_hash=mh)),
            ("argmin", (skeyed, w), {})]


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 2, 15, 16, 30, TILE - 1, TILE + 300, 5000])
def test_s1_kernel_matches_plain_on_card(cuda_device, w):
    """Block edges +-1, w = 1, w past a block's tile (staged), and w past
    the shared stage (read from device memory)."""
    rng = np.random.default_rng(w)
    for n in (1, 7, w - 1, w, w + 1, STRIDE - 1, STRIDE, STRIDE + 1,
              2 * STRIDE, 2 * STRIDE + 1, (1 << 20) + 3):
        if n < 1:
            continue
        for mode, args, kw in s1_cases(rng, cuda_device, n, w):
            got = sketch.sketch_select(mode, *args, **kw)
            want = sketch.sketch_select_plain(mode, *args, **kw)
            if mode == "argmin":
                assert torch.equal(got, want), (mode, n)
            else:
                assert torch.equal(got[0], want[0]), (mode, n)
                assert torch.equal(got[1], want[1]), (mode, n)
