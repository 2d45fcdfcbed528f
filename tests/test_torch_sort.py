"""The port's sort and collapse (plain K2 on the CPU) against the JAX
package (ops/sort.py, ops/pallas_sort.py in interpret mode) and numpy.
Exact equality throughout.  K2's pass plan is checked by running the
same LSD passes in numpy; the CUDA kernel itself is held to the plain
version on the card (marked ``cuda``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unikmer_tpu.ops import sort as jax_sort
from unikmer_tpu.ops.pallas_sort import sort_codes_pallas
from unikmer_tpu_torch import _kernels, radix_variants
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


@pytest.mark.parametrize("name", sorted(radix_variants.VARIANTS))
def test_radix_variants_apply_to_the_source(name):
    """Every substitution of radix_variants.VARIANTS finds its text in
    csrc/radix_sort.cu, so each variant still undoes one choice."""
    src = (_kernels.CSRC / "radix_sort.cu").read_text()
    for old, new in radix_variants.VARIANTS[name]:
        assert old in src and old != new
