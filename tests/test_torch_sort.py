"""The port's sort and collapse (plain K2 and C1 on the CPU) against the
JAX package (ops/sort.py, ops/pallas_sort.py in interpret mode) and
numpy.  Exact equality throughout.  K2's pass plan is checked by running
the same LSD passes in numpy, and C1's tiles, warps, neighbours, ballots,
look-back and fill are walked in numpy (``c1_walk``); the CUDA kernels
themselves are held to the plain versions on the card (marked
``cuda``)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unikmer_tpu.ops import sort as jax_sort
from unikmer_tpu.ops.pallas_sort import sort_codes_pallas
from unikmer_tpu_torch import _kernels
from unikmer_tpu_torch.ops import collapse as port_collapse
from unikmer_tpu_torch.ops import sort as port_sort
from unikmer_tpu_torch.ops.radix_sort import (
    radix_shifts, radix_sort_u64, sort_u64_plain,
)

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
SPECIAL = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def random_u64(rng, n):
    a = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    a[: min(n, 5)] = SPECIAL[: min(n, 5)]
    rng.shuffle(a)
    return a


@pytest.mark.parametrize("n", [1, 1024, 5000])
def test_k2_plain_matches_pallas_interpret(n):
    a = random_u64(np.random.default_rng(n), n)
    want = np.asarray(sort_codes_pallas(jnp.asarray(a), block_elems=1024,
                                        interpret=True))
    got = u64(radix_sort_u64(t64(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(a))


@pytest.mark.parametrize("n", [0, 1, 2, 999, 70000])
def test_k2_plain_matches_numpy(n):
    rng = np.random.default_rng(n + 1)
    for a in (random_u64(rng, n),
              rng.integers(0, 7, size=n, dtype=np.uint64) << np.uint64(45)):
        np.testing.assert_array_equal(u64(sort_u64_plain(t64(a))), np.sort(a))


def lsd_passes_numpy(keys: np.ndarray, code_bits: int) -> np.ndarray:
    """K2's algorithm in numpy: stable 8-bit digit passes at
    radix_shifts(code_bits), the sentinel ranked as 2^code_bits."""
    ranked = keys.copy()
    if code_bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(code_bits)
    order = np.arange(len(keys))
    for shift in radix_shifts(code_bits):
        digit = (ranked[order] >> np.uint64(shift)) & np.uint64(255)
        order = order[np.argsort(digit, kind="stable")]
    return keys[order]


@pytest.mark.parametrize("code_bits", [2, 10, 46, 47, 48, 56, 62, 63, 64])
def test_k2_pass_plan_sorts(code_bits):
    rng = np.random.default_rng(code_bits)
    hi = min(1 << code_bits, 1 << 63)
    a = rng.integers(0, hi, size=6000, dtype=np.uint64)
    if code_bits == 64:
        a = random_u64(rng, 6000)
    a[rng.random(6000) < 0.05] = SENT
    a[:3] = [0, np.uint64(hi - 1), SENT]
    np.testing.assert_array_equal(lsd_passes_numpy(a, code_bits), np.sort(a))


ONESWEEP_TILE, ONESWEEP_WARP = 64, 16  # small tiles: many, and a ragged last
ONESWEEP_NS = [0, 1, ONESWEEP_TILE - 1, ONESWEEP_TILE, ONESWEEP_TILE + 1,
               5 * ONESWEEP_TILE + 3]
ONESWEEP_KINDS = ["random", "equal", "sentinel", "sorted", "reverse"]


def onesweep_numpy(keys, code_bits, vals=None, tile=ONESWEEP_TILE,
                   warp_keys=ONESWEEP_WARP):
    """K2's (and, with ``vals``, K3's) onesweep kernels in numpy, step by
    step: the upfront [P, 256] histogram of all passes from one read, its
    exclusive digit bases and the trivial-pass flags; then for each pass
    that runs, the per-tile digit counts, the look-back prefix (the sum
    over earlier tiles), warp ranks in input order, the digit-major
    block-local slots, the shared-memory stage and the staged write
    positions.  Returns (keys, vals or None, passes run, passes skipped)."""
    n = len(keys)
    shifts = radix_shifts(code_bits)
    ranked = keys.copy()
    if code_bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(code_bits)

    def digits(idx, shift):
        return ((ranked[idx] >> np.uint64(shift))
                & np.uint64(255)).astype(np.int64)

    everything = np.arange(n)
    hist = np.array([np.bincount(digits(everything, s), minlength=256)
                     for s in shifts]).reshape(len(shifts), 256)
    bases = np.cumsum(hist, 1) - hist
    trivial = (hist == n).any(1)
    order = everything  # the source of the pass: keys[order]
    ran = 0
    for p, shift in enumerate(shifts):
        if trivial[p]:
            continue
        ran += 1
        d = digits(order, shift)
        tiles = -(-n // tile)
        counts = np.array([np.bincount(d[j * tile:(j + 1) * tile],
                                       minlength=256) for j in range(tiles)])
        lookback = np.cumsum(counts, 0) - counts  # earlier tiles, per digit
        out = np.full(n, -1)
        for j in range(tiles):
            part = slice(j * tile, (j + 1) * tile)
            dj, src = d[part], order[part]
            c = len(dj)
            w = np.arange(c) // warp_keys
            group = w * 256 + dj
            o = np.argsort(group, kind="stable")
            rank = np.empty(c, np.int64)
            rank[o] = np.arange(c) - np.searchsorted(group[o], group[o])
            wc = np.zeros((w[-1] + 1, 256), np.int64)
            np.add.at(wc, (w, dj), 1)
            warp_prefix = np.cumsum(wc, 0) - wc
            block_start = np.cumsum(counts[j]) - counts[j]
            slot = block_start[dj] + warp_prefix[w, dj] + rank
            assert np.array_equal(np.sort(slot), np.arange(c))
            stage = np.empty(c, np.int64)
            stage[slot] = src
            sd = digits(stage, shift)
            pos = (bases[p, sd] + lookback[j, sd] + np.arange(c)
                   - block_start[sd])
            out[pos] = stage
        assert (out >= 0).all()
        order = out
    return (keys[order], None if vals is None else vals[order], ran,
            len(shifts) - ran)


def onesweep_keys(rng, kind, n, code_bits):
    """Keys of one kind below 2^code_bits (any u64 at 64), with sentinels."""
    if code_bits == 64:
        a = random_u64(rng, n)
    else:
        a = rng.integers(0, 1 << code_bits, size=n, dtype=np.uint64)
        a[rng.random(n) < 0.05] = SENT
    if kind == "equal":
        a[:] = a[0] if n else 0
    elif kind == "sentinel":
        a[:] = SENT
    elif kind == "sorted":
        a = np.sort(a)
    elif kind == "reverse":
        a = np.sort(a)[::-1].copy()
    return a


@pytest.mark.parametrize("n", ONESWEEP_NS)
@pytest.mark.parametrize("kind", ONESWEEP_KINDS)
@pytest.mark.parametrize("code_bits", [2, 46, 47, 48, 63, 64])
def test_k2_onesweep_model_sorts(code_bits, kind, n):
    keys = onesweep_keys(np.random.default_rng([code_bits, n]), kind, n,
                         code_bits)
    got, _, ran, skipped = onesweep_numpy(keys, code_bits)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert ran + skipped == len(radix_shifts(code_bits))
    if kind in ("equal", "sentinel") or n <= 1:
        assert ran == 0  # every pass trivial: the order is left as it is


def test_radix_shifts():
    assert radix_shifts(46) == [0, 8, 16, 24, 32, 40]
    assert radix_shifts(47) == [0, 8, 16, 24, 32, 40]
    assert radix_shifts(48) == list(range(0, 56, 8))
    assert radix_shifts(62) == radix_shifts(64) == list(range(0, 64, 8))
    assert radix_shifts(2) == [0]
    with pytest.raises(ValueError):
        radix_shifts(65)


def collapse_inputs(seed, n=3000):
    """Codes with repeats, invalid slots and real sentinel-valued codes."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1 << 40, size=n, dtype=np.uint64)
    codes[rng.random(n) < 0.3] = codes[0]
    codes[100:140] = codes[200:240]
    valid = rng.random(n) < 0.9
    return codes, valid


@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
@pytest.mark.parametrize("n_real_sent", [0, 1, 2])
def test_collapse_sorted_matches_jax(mode, n_real_sent):
    codes, valid = collapse_inputs(n_real_sent)
    codes[-n_real_sent or len(codes):] = SENT  # real 2^64-1 codes
    valid[-n_real_sent or len(codes):] = True
    jo, jn = jax_sort.collapse_sorted(jnp.asarray(codes), jnp.asarray(valid),
                                      mode=mode)
    po, pn = port_sort.collapse_sorted(t64(codes), torch.from_numpy(valid),
                                       mode=mode)
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(u64(po), np.asarray(jo))


@pytest.mark.parametrize("n_real_sent", [0, 1, 3])
def test_collapse_dual_matches_jax(n_real_sent):
    codes, valid = collapse_inputs(10 + n_real_sent)
    codes[-n_real_sent or len(codes):] = SENT
    valid[-n_real_sent or len(codes):] = True
    want = jax_sort.collapse_sorted_dual(jnp.asarray(codes),
                                         jnp.asarray(valid))
    got = port_sort.collapse_sorted_dual(t64(codes), torch.from_numpy(valid))
    for g, w in zip(got, want):
        if g.dim():
            np.testing.assert_array_equal(u64(g), np.asarray(w))
        else:
            assert int(g) == int(w)


def test_collapse_matches_numpy_modes():
    codes, valid = collapse_inputs(42, n=20000)
    kept = codes[valid]
    u, counts = np.unique(kept, return_counts=True)
    want = {"distinct": u, "unique": u[counts == 1],
            "repeated": u[counts > 1]}
    for mode, w in want.items():
        out, n = port_sort.collapse_sorted(t64(codes), torch.from_numpy(valid),
                                           mode=mode, code_bits=40)
        np.testing.assert_array_equal(u64(out)[: int(n)], w)
        assert (u64(out)[int(n):] == SENT).all()


def test_collapse_empty_and_all_invalid():
    out, n = port_sort.collapse_sorted(t64(np.zeros(0, np.uint64)),
                                       torch.zeros(0, dtype=torch.bool))
    assert out.shape == (0,) and int(n) == 0
    out, n = port_sort.collapse_sorted(t64(np.arange(5, dtype=np.uint64)),
                                       torch.zeros(5, dtype=torch.bool),
                                       mode="unique")
    assert int(n) == 0 and (u64(out) == SENT).all()
    with pytest.raises(ValueError):
        port_sort.collapse_sorted(t64(np.arange(5, dtype=np.uint64)),
                                  torch.ones(5, dtype=torch.bool), mode="x")


# ---------------------------------------------------------------------------
# C1 (csrc/collapse.cu): its CPU twin against the JAX package, and the
# kernel walked in numpy (constants read from the source)

C1_SOURCE = (_kernels.CSRC / "collapse.cu").read_text()


def c1_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         C1_SOURCE).group(1))


C1_THREADS, C1_ROUNDS, C1_FILL_BLOCKS = (
    c1_const(n) for n in ("kThreads", "kRounds", "kFillBlocks"))
C1_WARP_KEYS = 64 * C1_ROUNDS  # a lane's pair a round: 2 x 32 keys
C1_TILE = C1_THREADS // 32 * C1_WARP_KEYS
C1_MODES = port_collapse.MODES
SORTED_C1 = port_collapse.SORTED_MODES


def sorted_collapse_case(rng, n, n_real_sent, bits=40):
    """(codes, valid) of length n: repeats, runs longer than a warp's
    span, invalid slots and ``n_real_sent`` real sentinel-valued codes."""
    codes = rng.integers(0, 1 << bits, size=n, dtype=np.uint64)
    if n:
        codes[rng.random(n) < 0.3] = codes[0]
        lo = int(rng.integers(0, n))
        codes[lo: lo + 700] = codes[lo]
    valid = rng.random(n) < 0.9
    m = min(n_real_sent, n)
    codes[n - m:] = SENT
    valid[n - m:] = True
    return codes, valid


@pytest.mark.parametrize("n", [0, 1, 300, C1_TILE + 1])
@pytest.mark.parametrize("n_real_sent", [0, 1, 2])
@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated", "mask"])
def test_c1_twin_matches_jax(mode, n_real_sent, n):
    """C1's CPU twin, mode by mode, against the JAX package: the sorted
    modes through ``collapse_sorted`` (K2's twin, then C1's), with the
    head of the sorted array read as ``s != sentinel`` where the JAX
    package counts ``n_head`` slots; the mask mode with an int32 aux
    column against ``compact_sorted``/``compact_aux``."""
    rng = np.random.default_rng([n, n_real_sent, C1_MODES.index(mode)])
    codes, valid = sorted_collapse_case(rng, n, n_real_sent)
    if mode == "mask":
        values = np.sort(codes)
        aux = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(
            np.uint32)
        out, aux_out, got_n = port_collapse.collapse_pass(
            t64(values), "mask", mask=torch.from_numpy(valid),
            aux=torch.from_numpy(aux.view(np.int32)))
        want = jax_sort.compact_sorted(jnp.asarray(values),
                                       jnp.asarray(valid), SENT)
        want_aux = jax_sort.compact_aux(jnp.asarray(valid), jnp.asarray(aux),
                                        0)
        np.testing.assert_array_equal(u64(out), np.asarray(want))
        np.testing.assert_array_equal(aux_out.numpy().view(np.uint32),
                                      np.asarray(want_aux))
        assert int(got_n) == int(valid.sum())
        return
    jo, jn = jax_sort.collapse_sorted(jnp.asarray(codes), jnp.asarray(valid),
                                      mode=mode)
    po, pn = port_sort.collapse_sorted(t64(codes), torch.from_numpy(valid),
                                       mode=mode)
    assert int(pn) == int(jn)
    np.testing.assert_array_equal(u64(po), np.asarray(jo))
    # every sentinel-keyed slot sorts to the tail: the JAX package's head
    # of n_head slots is exactly the slots that are not the sentinel
    keyed = np.where(valid, codes, SENT)
    s = np.sort(keyed)
    n_head = n - int((~valid).sum()) - int(((codes == SENT) & valid).sum())
    np.testing.assert_array_equal(s != SENT, np.arange(n) < n_head)
    assert n_real_sent == 0 or n == 0 or (s[n_head:] == SENT).all()


def c1_key_at(keys, i):
    """keys[i], the sentinel outside [0, n) (the kernel's key_at)."""
    i = np.asarray(i)
    ok = (i >= 0) & (i < len(keys))
    return np.where(ok, keys[np.clip(i, 0, max(len(keys) - 1, 0))]
                    if len(keys) else SENT, SENT)


def c1_lookback(counts, inclusive):
    """Warp 0's look-back of every tile over the status words: the words
    of earlier tiles hold an inclusive prefix where ``inclusive`` (tile 0
    always), else their count; lane l reads tile t - 1 - l, the lanes up
    to the nearest inclusive prefix add, else all 32 and 32 tiles
    further.  Returns each tile's exclusive prefix."""
    incl_sum = np.cumsum(counts)
    out = np.zeros(len(counts), np.int64)
    lanes = np.arange(32)
    for t in range(1, len(counts)):
        prefix, j0 = 0, t - 1
        while True:
            j = j0 - lanes
            flag = np.where(j < 0, True, inclusive[np.clip(j, 0, None)]
                            | (j == 0))
            val = np.where(j < 0, 0, np.where(flag, incl_sum[np.clip(j, 0,
                                                                    None)],
                                              counts[np.clip(j, 0, None)]))
            stop = int(np.argmax(flag)) if flag.any() else 31
            prefix += int(val[: stop + 1].sum())
            if flag.any():
                break
            j0 -= 32
        out[t] = prefix
    return out


def c1_fill_slots(n, total):
    """The slots collapse_fill writes, in order of (pass, thread): a
    grid-stride over slot pairs from total // 2."""
    pairs = (n + 1) // 2
    blocks = min(-(-pairs // C1_THREADS), C1_FILL_BLOCKS)
    stride = blocks * C1_THREADS
    p = total // 2 + np.arange(stride)
    got = []
    while (2 * p < n).any():
        p = p[2 * p < n]
        for i in (2 * p, 2 * p + 1):
            got.append(i[(i >= total) & (i < n)])
        p = p + stride
    return np.concatenate(got) if got else np.zeros(0, np.int64)


def c1_walk(keys, mode, threshold=1, mask=None, aux=None, n_sent_real=None,
            inclusive=None):
    """collapse_tile and collapse_fill in numpy, warp by warp: lane l's
    pair of round r at warp0 + 64 r + 2 l, its neighbours from the pair,
    the lanes beside it, the rounds beside it and the two halo keys; the
    mode's flags (threshold: one more read where a run starts); the
    block slots from the ballots' popcounts; the tile's offset by
    :func:`c1_lookback`; then the fill.  Returns (out, aux_out, n)."""
    n = len(keys)
    tiles = -(-n // C1_TILE)
    rounds, lanes = np.arange(C1_ROUNDS)[:, None], np.arange(32)[None, :]
    lower = np.tril(np.ones((32, 32), np.int64), -1)  # [lane, lower lane]
    reach = threshold - 1
    staged, counts = [], []
    for tile in range(tiles):
        stage_k, stage_x = [], []
        for w in range(C1_THREADS // 32):
            warp0 = tile * C1_TILE + w * C1_WARP_KEYS
            i = warp0 + 64 * rounds + 2 * lanes  # [round, lane]
            a, b = c1_key_at(keys, i), c1_key_at(keys, i + 1)
            if mode == "mask":
                inside = lambda j: (j < n) & (mask[np.clip(j, 0, n - 1)]
                                              != 0)
                ka, kb = inside(i), inside(i + 1)
            else:
                prev, nxt = np.empty_like(a), np.empty_like(a)
                prev[:, 1:], nxt[:, :-1] = b[:, :-1], a[:, 1:]
                prev[1:, 0], nxt[:-1, 31] = b[:-1, 31], a[1:, 0]
                prev[0, 0] = (c1_key_at(keys, warp0 - 1) if warp0 > 0
                              else ~a[0, 0])
                nxt[-1, 31] = c1_key_at(keys, warp0 + C1_WARP_KEYS)
                ka = (a != SENT) & (a != prev)
                kb = (b != SENT) & (a != b)
                if mode == "unique":
                    ka, kb = ka & (a != b), kb & (nxt != b)
                elif mode == "repeated":
                    ka, kb = ka & (a == b), kb & (nxt == b)
                elif mode == "threshold":
                    ka &= c1_key_at(keys, i + reach) == a
                    kb &= c1_key_at(keys, i + 1 + reach) == b
            ka, kb = ka.astype(np.int64), kb.astype(np.int64)
            base = np.concatenate([[0], np.cumsum(ka.sum(1) + kb.sum(1))])
            at = base[:-1, None] + (ka + kb) @ lower.T  # popc below the lane
            slots = np.concatenate([at[ka == 1], (at + ka)[kb == 1]])
            vals = np.concatenate([a[ka == 1], b[kb == 1]])
            srcs = np.concatenate([i[ka == 1], (i + 1)[kb == 1]])
            order = np.argsort(slots)
            assert np.array_equal(slots[order], np.arange(len(slots)))
            stage_k.append(vals[order])
            stage_x.append(srcs[order])
        staged.append((np.concatenate(stage_k), np.concatenate(stage_x)))
        counts.append(len(staged[-1][0]))
    counts = np.array(counts, np.int64)
    if inclusive is None:
        inclusive = np.ones(tiles, bool)
    prefix = c1_lookback(counts, inclusive)
    np.testing.assert_array_equal(prefix, np.cumsum(counts) - counts)
    out = np.zeros(n, np.uint64)
    aux_out = None if aux is None else np.zeros_like(aux)
    written = np.zeros(n, np.int64)
    for (k, src), p in zip(staged, prefix):
        out[p: p + len(k)] = k
        if aux is not None:
            aux_out[p: p + len(k)] = aux[src]
        written[p: p + len(k)] += 1
    total = int(counts.sum())
    tail = c1_fill_slots(n, total)
    out[tail] = SENT
    if aux is not None:
        aux_out[tail] = 0
    written[tail] += 1
    assert (written == 1).all()
    extra = 0
    if n_sent_real is not None:
        extra = {"distinct": n_sent_real > 0, "unique": n_sent_real == 1,
                 "repeated": n_sent_real > 1}.get(mode, False)
    return out, aux_out, total + int(extra)


C1_WALK_NS = [1, 2, 63, 64, 65, C1_WARP_KEYS + 1, C1_TILE - 1, C1_TILE,
              C1_TILE + 1, 3 * C1_TILE + 5]


def c1_walk_keys(rng, kind, n):
    """Sorted keys of one kind (random with runs across warp and tile
    edges, all equal, all sentinel, runs of one) and a mask."""
    if kind == "sentinel":
        keys = np.full(n, SENT)
    elif kind == "equal":
        keys = np.full(n, np.uint64(7))
    elif kind == "single":
        keys = np.arange(n, dtype=np.uint64) * np.uint64(3)
    else:
        keys = rng.integers(0, 50 + n // 4, size=n, dtype=np.uint64)
        keys[rng.random(n) < 0.1] = SENT
        keys = np.sort(keys)
    return keys, rng.random(n) < 0.6


@pytest.mark.parametrize("n", C1_WALK_NS)
@pytest.mark.parametrize("kind", ["random", "equal", "sentinel", "single"])
def test_c1_walk_matches_the_twin(kind, n):
    """The numpy walk of C1 equals the CPU twin in every mode, with and
    without an aux column, thresholds 2 to past a tile, and the real
    sentinel count's rule."""
    rng = np.random.default_rng([n, len(kind)])
    keys, mask = c1_walk_keys(rng, kind, n)
    aux = rng.integers(0, 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    cases = [("distinct", 1), ("unique", 1), ("repeated", 1), ("mask", 1)]
    cases += [("threshold", t) for t in (2, 3, 70, C1_TILE + 1)]
    for (mode, t), n_sent in zip(cases * 3, [None] * 8 + [0] * 8 + [2] * 8):
        if n_sent is not None and mode not in port_collapse.SORTED_MODES:
            continue
        with_aux = mode == "mask" or t == 3
        got = c1_walk(keys, mode, t, mask if mode == "mask" else None,
                      aux if with_aux else None, n_sent)
        want = port_collapse.collapse_plain(
            t64(keys), mode, threshold=t,
            mask=torch.from_numpy(mask) if mode == "mask" else None,
            aux=torch.from_numpy(aux) if with_aux else None,
            n_sent_real=None if n_sent is None else torch.tensor(n_sent))
        np.testing.assert_array_equal(got[0], u64(want[0]))
        if with_aux:
            np.testing.assert_array_equal(got[1], want[1].numpy())
        assert got[2] == int(want[2]), (mode, t, n_sent)


def test_c1_lookback_walks_windows_of_32():
    """The look-back's prefix over 100 tiles, whichever earlier tiles
    have published an inclusive prefix (windows of 32 with none)."""
    rng = np.random.default_rng(5)
    counts = rng.integers(0, C1_TILE + 1, size=100)
    for p in (0.0, 0.03, 0.5, 1.0):
        inclusive = rng.random(100) < p
        np.testing.assert_array_equal(c1_lookback(counts, inclusive),
                                      np.cumsum(counts) - counts)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 2 * C1_THREADS + 1,
                               2 * C1_THREADS * C1_FILL_BLOCKS + 5])
def test_c1_fill_writes_the_tail_once(n):
    for total in sorted({0, 1, n // 2, n - 1, n}):
        got = c1_fill_slots(n, total)
        np.testing.assert_array_equal(np.sort(got), np.arange(total, n))


def one_hot_keys(rng, n, code_bits):
    """Keys with one bit set below code_bits: most digits of every pass
    are 0, one long look-back chain."""
    bit = rng.integers(0, min(code_bits, 64), size=n).astype(np.uint64)
    return np.uint64(1) << bit


def card_cases(rng, code_bits, tile):
    """(n, keys) for the card tests: random keys with sentinels at ragged
    and tile-edge lengths, then all-equal, sorted, reverse-sorted and
    one-hot keys at tile - 1, tile + 1 and 3 tiles."""
    for n in (0, 1, 1000, tile - 1, tile, tile + 1, 4097, (1 << 20) + 3):
        yield n, onesweep_keys(rng, "random", n, code_bits)
    for n in (tile - 1, tile + 1, 3 * tile, (1 << 20) + 3):
        for kind in ("equal", "sorted", "reverse"):
            yield n, onesweep_keys(rng, kind, n, code_bits)
        yield n, one_hot_keys(rng, n, code_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("code_bits", [2, 46, 48, 64])
def test_k2_kernel_matches_plain_on_card(cuda_device, code_bits):
    from unikmer_tpu_torch import _kernels

    tile = _kernels.load().ukt_radix_tile()
    rng = np.random.default_rng(code_bits)
    for n, a in card_cases(rng, code_bits, tile):
        x = t64(a).to(cuda_device)
        got = radix_sort_u64(x, code_bits)
        assert torch.equal(got, sort_u64_plain(x)), n
        assert n <= 1 or got.data_ptr() != x.data_ptr()


@pytest.mark.cuda
def test_collapse_on_card_matches_cpu(cuda_device):
    codes, valid = collapse_inputs(7, n=100000)
    for mode in ("distinct", "unique", "repeated"):
        want = port_sort.collapse_sorted(t64(codes), torch.from_numpy(valid),
                                         mode=mode, code_bits=40)
        got = port_sort.collapse_sorted(t64(codes).to(cuda_device),
                                        torch.from_numpy(valid).to(cuda_device),
                                        mode=mode, code_bits=40)
        assert int(got[1]) == int(want[1])
        assert torch.equal(got[0].cpu(), want[0])


def c1_card_inputs(rng, n, tile):
    """Sorted keys of the card cases: the walk's kinds, and runs of about
    1.5 tiles (runs across tile edges, thresholds past a tile)."""
    for kind in ("random", "equal", "sentinel", "single"):
        yield c1_walk_keys(rng, kind, n)
    keys = np.sort(rng.integers(0, max(n // (tile + tile // 2), 1) + 1,
                                size=n, dtype=np.uint64))
    yield keys, rng.random(n) < 0.5


@pytest.mark.cuda
def test_c1_kernel_matches_plain_on_card(cuda_device):
    """C1 against its twin, bit for bit: lengths 0, 1, a tile and one off
    it, more tiles than a look-back window and 2^20 + 3; every mode, the
    real sentinel count's rule, thresholds up to and past a tile, int32
    and int64 aux columns, and views at a storage offset of one slot.
    ``.launches`` counts one for each call that launched."""
    tile = _kernels.load().ukt_collapse_tile()
    assert tile == C1_TILE
    rng = np.random.default_rng(22)
    wrapper = port_collapse.collapse_pass
    for n in (0, 1, tile - 1, tile, tile + 1, 37 * tile + 5, (1 << 20) + 3):
        for keys, mask in c1_card_inputs(rng, n, tile):
            aux = {torch.int32: rng.integers(-(1 << 31), 1 << 31, size=n + 1,
                                             dtype=np.int64).astype(np.int32),
                   torch.int64: rng.integers(-(1 << 62), 1 << 62, size=n + 1)}
            for off in (0, 1):
                k = t64(np.concatenate([np.full(off, SENT), keys])).to(
                    cuda_device)[off:]
                m = torch.from_numpy(np.concatenate([np.ones(off, bool),
                                                     mask])).to(
                    cuda_device)[off:]
                cases = [("mask", 1, None, dt) for dt in aux]
                cases += [(mode, 1, ns, None) for mode in SORTED_C1
                          for ns in (None, 0, 1, 2)]
                cases += [("threshold", t, None, dt) for t, dt in (
                    (1, None), (2, torch.int32), (100, None), (tile, None),
                    (tile + 1, torch.int64), (3 * tile, None))]
                for mode, t, ns, dt in cases:
                    kw = dict(threshold=t,
                              mask=m if mode == "mask" else None,
                              n_sent_real=None if ns is None else torch.tensor(
                                  ns, device=cuda_device),
                              aux=None if dt is None else torch.from_numpy(
                                  aux[dt]).to(cuda_device)[off: off + n])
                    before = wrapper.launches
                    got = wrapper(k, mode, **kw)
                    want = port_collapse.collapse_plain(k, mode, **kw)
                    torch.cuda.synchronize()
                    what = (n, mode, t, ns, dt, off)
                    assert wrapper.launches == before + (n > 0), what
                    assert torch.equal(got[0], want[0]), what
                    assert int(got[2]) == int(want[2]), what
                    assert (got[1] is None) == (want[1] is None), what
                    if dt is not None:
                        assert got[1].dtype == dt
                        assert torch.equal(got[1], want[1]), what
