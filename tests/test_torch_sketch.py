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
# S1's kernel walked block by block in numpy (csrc/sketch.cu; its
# constants are read from the source)

CSRC = (Path(__file__).resolve().parent.parent / "unikmer_tpu_torch" / "csrc"
        / "sketch.cu").read_text()


def cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


THREADS = cu_const("kThreads")
MAX_RUN = cu_const("kMaxRun")
LEAD = cu_const("kLead")
TILE = THREADS * MAX_RUN  # a block's windows at w >= kMaxRun
POISON = np.uint64(0x5A5A5A5A5A5A5A5A)


def s1_run(w):
    """Windows a thread: the largest power of two at most min(w, kMaxRun)."""
    r = 1
    while 2 * r <= min(w, MAX_RUN):
        r *= 2
    return r


def s1_walk(mode, keys, w, valid=None, khash=None, max_hash=nthash.MAX_HASH):
    """sketch_select_kernel over n windows, block by block, the block's
    threads side by side: the stage (element first - kLead + s at index s,
    2^64-1 and invalid outside [0, n)), each thread's run of R windows from
    s0 = kLead + tR as left suffix minima (taken on <=), one core minimum
    over [s0+R-1, s0+w) and a right prefix (taken on <), combined left to
    right; the minimizer's window i-1 of a run's first window from element
    s0-1, the left suffix and the core less its last element; then the
    block's writes.  Every slot must be written once."""
    keys = keys.view(np.uint64)
    n = len(keys)
    r = s1_run(w)
    tile = THREADS * r
    out = np.full(n, POISON, np.uint64)
    out_valid = np.full(n, 7, np.uint8)
    writes = np.zeros(n, np.int64)
    s0 = LEAD + np.arange(THREADS) * r
    rows = np.arange(THREADS)
    mh = np.uint64(max_hash)

    def window_min(sk, lo, length):  # (leftmost min, its index) of [lo, lo+length)
        win = np.lib.stride_tricks.sliding_window_view(sk, length)[lo]
        at = np.argmin(win, axis=1)  # numpy: the first minimum
        return win[rows, at], lo + at

    for blk in range(-(-n // tile)):
        first = blk * tile
        base = first - LEAD
        e = base + np.arange(LEAD + tile + w + r)
        inside = (e >= 0) & (e < n)
        at = np.clip(e, 0, n - 1)
        sk = np.where(inside, keys[at], SENT)
        bad = ~inside | ((valid[at] == 0) if valid is not None else False)
        # left suffix minima of [s0 + u, s0 + R - 1)
        lk = np.zeros((THREADS, r), np.uint64)
        lp = np.zeros((THREADS, r), np.int64)
        for u in range(r - 2, -1, -1):
            v = sk[s0 + u]
            take = np.ones(THREADS, bool) if u == r - 2 else v <= lk[:, u + 1]
            lk[:, u] = np.where(take, v, lk[:, u + 1])
            lp[:, u] = np.where(take, s0 + u, lp[:, u + 1])
        core_k, core_p = window_min(sk, s0 + r - 1, w - r + 1)
        any_bad = np.concatenate([[0], np.cumsum(bad)])  # bad elements before s
        n_bad = lambda a, b: any_bad[b] - any_bad[a]  # noqa: E731
        right_k, right_p = np.zeros(THREADS, np.uint64), np.zeros(THREADS, np.int64)
        args, oks, bits = [], [], np.zeros((THREADS, r), bool)
        codes = np.zeros((THREADS, r), np.uint64)
        for j in range(r):
            if j > 0:
                v = sk[s0 + w + j - 1]
                take = np.ones(THREADS, bool) if j == 1 else v < right_k
                right_k = np.where(take, v, right_k)
                right_p = np.where(take, s0 + w + j - 1, right_p)
            mk, mp = core_k, core_p
            if j < r - 1:
                take = lk[:, j] <= mk
                mk, mp = np.where(take, lk[:, j], mk), np.where(take, lp[:, j], mp)
            if j > 0:
                take = right_k < mk
                mk, mp = np.where(take, right_k, mk), np.where(take, right_p, mp)
            args.append(mp)
            codes[:, j] = mk
            oks.append(n_bad(s0 + j, s0 + j + w) == 0)
            if mode == "syncmer":
                bits[:, j] = (mp == s0 + j) | (mp == s0 + j + w - 1)
        if mode == "minimizer":
            # window i-1 of each run's first window, [s0 - 1, s0 + w - 1):
            # element s0-1, the left suffix, the core less its last element
            pk, pa = sk[s0 - 1], s0 - 1
            if r > 1:
                take = lk[:, 0] < pk
                pk, pa = np.where(take, lk[:, 0], pk), np.where(take, lp[:, 0], pa)
            if w > r:
                bk, bp = window_min(sk, s0 + r - 1, w - r)
                take = bk < pk
                pk, pa = np.where(take, bk, pk), np.where(take, bp, pa)
            pok = n_bad(s0 - 1, s0 + w - 1) == 0
            for j in range(r):
                before_a, before_ok = (pa, pok) if j == 0 else (args[j - 1], oks[j - 1])
                bits[:, j] = (oks[j] & (~before_ok | (args[j] != before_a))
                              & (codes[:, j] <= mh))
        have = min(tile, n - first)
        i = first + np.arange(have)
        slot = (rows[:, None] * r + np.arange(r)).reshape(-1)[:have]
        if mode == "argmin":
            out[i] = base + np.stack(args, 1).reshape(-1)[:have]
        else:
            keep = bits.reshape(-1)[:have]
            if mode == "minimizer":
                code = codes.reshape(-1)[:have]
            else:
                code = khash.view(np.uint64)[i]
                keep = keep & (valid[i] != 0) & (code <= mh)
            out[i] = np.where(keep, code, SENT)
            out_valid[i] = keep
        assert (slot == np.arange(have)).all()
        writes[i] += 1
    assert (writes == 1).all()
    return out if mode == "argmin" else (out, out_valid)


def h1_outputs(rng, n, k):
    b = sketch_bases(int(rng.integers(1 << 30)), n)
    p2, vm = (torch.from_numpy(a) for a in pack_bases_2bit(b))
    return nthash.encode_nthash(p2, vm, n, k, True)


def s1_lengths(w):
    """n < w, and n at S1's run and block edges +-1 at window width w."""
    r = s1_run(w)
    tile = THREADS * r
    return sorted({1, 2, 7, max(w - 1, 1), w, w + 1, r - 1 or 1, r, r + 1,
                   tile - 1, tile, tile + 1, 2 * tile - 1, 2 * tile + 1,
                   3 * tile + 500})


S1_KINDS = ("h1", "all-equal", "poly-A", "max-key-beside-invalid")


def s1_inputs(kind, rng, n):
    """(k-mer keys, k-mer valid, s-mer keys) of one kind: H1's outputs
    (k = 21, s = 9) of random bases, all-equal keys, H1's outputs of poly-A
    runs (equal hashes broken by N), or keys with few values where a valid
    2^64-1 key sits beside an invalid one (keyed 2^64-1, as H1 keys it)."""
    if kind == "h1":
        kkeyed, kvalid = h1_outputs(rng, n, 21)
        return kkeyed, kvalid, h1_outputs(rng, n, 9)[0]
    if kind == "all-equal":
        return (torch.full((n,), 12345, dtype=torch.int64),
                torch.ones(n, dtype=torch.uint8),
                torch.full((n,), -77, dtype=torch.int64))
    if kind == "poly-A":
        b = np.zeros(n, np.uint8)
        b[np.arange(n) % 997 == 500] = 255
        p2, vm = (torch.from_numpy(a) for a in pack_bases_2bit(b))
        kkeyed, kvalid = nthash.encode_nthash(p2, vm, n, 21, True)
        return kkeyed, kvalid, nthash.encode_nthash(p2, vm, n, 9, True)[0]
    keys = rng.integers(0, 3, size=n, dtype=np.uint64)
    valid = np.ones(n, np.uint8)
    at = np.arange(n // 2, n, 37)
    keys[at] = SENT
    keys[at[at + 1 < n] + 1] = SENT
    valid[at[at + 1 < n] + 1] = 0
    skeys = np.where(rng.random(n) < 0.3, SENT, keys)
    return (torch.from_numpy(keys.view(np.int64)), torch.from_numpy(valid),
            torch.from_numpy(skeys.view(np.int64)))


S1_WALK_CASES = ([pytest.param(w, "h1", id=str(w))
                  for w in (1, 2, 15, 16, TILE + 300)]
                 + [pytest.param(w, kind, id=f"{w}-{kind}")
                    for kind in S1_KINDS[1:] for w in (2, 15, 16, 30)])


@pytest.mark.parametrize("w,kind", S1_WALK_CASES)
def test_s1_walk_matches_plain(w, kind):
    rng = np.random.default_rng(w)
    for n in s1_lengths(w):
        kkeyed, kvalid, skeyed = s1_inputs(kind, rng, n)
        mh = nthash.scaled_max_hash(3)
        got = s1_walk("minimizer", kkeyed.numpy(), w, kvalid.numpy(),
                      max_hash=mh)
        want = sketch.sketch_select("minimizer", kkeyed, w, kvalid,
                                    max_hash=mh)
        np.testing.assert_array_equal(got[0], u64(want[0]), err_msg=f"n={n}")
        np.testing.assert_array_equal(got[1], want[1].numpy())
        got = s1_walk("minimizer", kkeyed.numpy(), w, kvalid.numpy())
        want = sketch.sketch_select("minimizer", kkeyed, w, kvalid)
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


def test_s1_max_key_beside_invalid_is_kept():
    """A valid key of 2^64-1 is a window minimum the minimizer keeps; the
    invalid slot beside it, keyed the same, makes its windows invalid."""
    keys = torch.tensor([-1, -1, -1, -1], dtype=torch.int64)
    valid = torch.tensor([1, 1, 0, 1], dtype=torch.uint8)
    out, ok = sketch.sketch_select("minimizer", keys, 2, valid)
    assert ok.tolist() == [1, 0, 0, 0]
    assert out.tolist() == [-1, -1, -1, -1]
    walked = s1_walk("minimizer", keys.numpy(), 2, valid.numpy())
    np.testing.assert_array_equal(walked[1], ok.numpy())


# ---------------------------------------------------------------------
# on the card


def s1_cases(rng, dev, n, w, kind="h1"):
    """(mode, args, kwargs) of each S1 mode over n windows of width w, on
    the card, with a scaled threshold."""
    if kind == "h1":
        kkeyed, kvalid = (t.to(dev) for t in h1_outputs(rng, n, 31))
        skeyed = h1_outputs(rng, n, 16)[0].to(dev)
    else:
        kkeyed, kvalid, skeyed = (t.to(dev) for t in s1_inputs(kind, rng, n))
    mh = nthash.scaled_max_hash(7)
    return [("minimizer", (kkeyed, w, kvalid), dict(max_hash=mh)),
            ("minimizer", (kkeyed, w, kvalid), {}),
            ("syncmer", (skeyed, w, kvalid, kkeyed), dict(max_hash=mh)),
            ("argmin", (skeyed, w), {})]


S1_CARD_CASES = ([pytest.param(w, "h1", id=str(w)) for w in
                  (1, 2, 15, 16, 30, TILE - 1, TILE + 300, 5000)]
                 + [pytest.param(w, kind, id=f"{w}-{kind}")
                    for kind in S1_KINDS[1:] for w in (1, 2, 15, 16, 30)])


@pytest.mark.cuda
@pytest.mark.parametrize("w,kind", S1_CARD_CASES)
def test_s1_kernel_matches_plain_on_card(cuda_device, w, kind):
    """n < w, run and block edges +-1, w = 1, w past a block's tile
    (staged), and w past the shared stage (read from device memory)."""
    rng = np.random.default_rng(w)
    for n in [*s1_lengths(w), (1 << 20) + 3]:
        for mode, args, kw in s1_cases(rng, cuda_device, n, w, kind):
            got = sketch.sketch_select(mode, *args, **kw)
            want = sketch.sketch_select_plain(mode, *args, **kw)
            if mode == "argmin":
                assert torch.equal(got, want), (mode, n)
            else:
                assert torch.equal(got[0], want[0]), (mode, n)
                assert torch.equal(got[1], want[1]), (mode, n)
