"""The port's ops/device_sets.py and tree-walk LCA (taxonomy/lca.py)
against the JAX package's on the CPU: the same seeded sentinel-padded
sets go through both, and codes, n, taxids and bytes must be equal.
The port runs its plain versions (K2/K3's plain sorts); the JAX package
runs its own device path on the CPU, as its tests do.  The device cases
at 2^25 against these CPU results are marked ``cuda``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unikmer_tpu.ops import device_sets as jds
from unikmer_tpu.ops import sets as jax_sets
from unikmer_tpu.taxonomy import lca as jax_lca
from unikmer_tpu.taxonomy.taxdump import load_taxonomy
from unikmer_tpu_torch.ops import device_sets as pds
from unikmer_tpu_torch.ops import radix_sort
from unikmer_tpu_torch.taxonomy import lca as port_lca

from test_torch_lca import port_tax, synth_taxonomy

TAXDUMP = "tests/data/taxdump"
SENT = pds.SENT
VOCAB = np.array([0, 511145, 585057, 349741, 562, 561, 2, 1224, 83333],
                 np.uint32)
UNKNOWN = np.uint32(999999)  # not in the taxdump
CAP = 1024


def padded(vals, cap=CAP):
    out = np.full(cap, SENT, np.uint64)
    v = np.unique(np.asarray(vals, np.uint64))
    out[: len(v)] = v
    return out


def t64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def u64(t) -> np.ndarray:
    return t.numpy().view(np.uint64) if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.uint64)


def u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32) if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.uint32)


def assert_same(got, want):
    """(codes, [aux], n) of the port and the JAX package, slot for slot
    (sentinel and zero padding included)."""
    assert len(got) == len(want)
    assert int(got[-1]) == int(want[-1])
    np.testing.assert_array_equal(u64(got[0]), u64(want[0]))
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_array_equal(u32(g), u32(w))


def pair(case: str, rng, bits=46):
    """Two member arrays related as ``case`` says."""
    half = np.uint64(1 << (bits - 1))

    def draw(n):
        return rng.integers(0, half, size=n, dtype=np.uint64)

    a = draw(700)
    if case == "overlap":
        b = np.concatenate([a[:300], draw(400)])
    elif case == "all_shared":
        b = a.copy()
    elif case == "disjoint":
        b = a + half
    elif case == "a_empty":
        a, b = a[:0], draw(500)
    elif case == "b_empty":
        b = a[:0]
    elif case == "both_empty":
        a = b = a[:0]
    elif case == "full":  # no sentinel padding left in a
        a, b = draw(CAP), np.concatenate([a[:100], draw(50)])
    else:
        raise ValueError(case)
    return a, b


PAIR_CASES = ["overlap", "all_shared", "disjoint", "a_empty", "b_empty",
              "both_empty", "full"]


@pytest.mark.parametrize("case", PAIR_CASES)
@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_binary_ops_match_jax(case, op):
    a, b = pair(case, np.random.default_rng(len(case)))
    pa, pb = padded(a), padded(b, 512 if case == "full" else CAP)
    kw = {"code_bits": 46} if op == "union" else {}
    got = getattr(pds, op)(t64(pa), t64(pb), **kw)
    want = getattr(jds, op)(pa, pb, **kw)
    assert_same(got, want)
    members = {"union": np.union1d, "intersect": np.intersect1d,
               "subtract": np.setdiff1d}[op](a, b)
    np.testing.assert_array_equal(u64(got[0])[: int(got[1])], members)


@pytest.mark.parametrize("threshold", [1, 2, 4, 5])
def test_common_matches_jax(threshold):
    rng = np.random.default_rng(threshold)
    base = rng.integers(0, 1 << 40, size=600, dtype=np.uint64)
    sets = [np.concatenate([base[rng.random(600) < 0.6],
                            rng.integers(0, 1 << 40, size=100,
                                         dtype=np.uint64)])
            for _ in range(4)]
    sets[3] = sets[3][:0]  # one empty set
    stacked = np.stack([padded(s) for s in sets])
    got = pds.common(t64(stacked.reshape(-1)).view(4, CAP), threshold, 40)
    assert_same(got, jds.common(stacked, threshold, code_bits=40))
    u, counts = np.unique(np.concatenate([np.unique(s) for s in sets]),
                          return_counts=True)
    np.testing.assert_array_equal(u64(got[0])[: int(got[1])],
                                  u[counts >= threshold])


@pytest.mark.parametrize("n", [1, 8, 13, 4099])
def test_member_bits_bytes_match_jax(n):
    rng = np.random.default_rng(n)
    query = padded(rng.integers(0, 5000, size=900, dtype=np.uint64))
    codes = rng.integers(0, 6000, size=n, dtype=np.uint64)
    codes[: min(n, 2)] = SENT
    got = pds.member_bits(t64(query), t64(codes))
    want = np.asarray(jds.member_bits(query, codes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sent_in", [False, True])
def test_device_membership_matches_jax(sent_in):
    rng = np.random.default_rng(7)
    q = np.unique(rng.integers(0, 3000, size=800, dtype=np.uint64))
    if sent_in:
        q = np.append(q, SENT)
    look = rng.integers(0, 3500, size=5003, dtype=np.uint64)
    look[:3] = SENT
    got = pds.DeviceMembership(q, device="cpu")
    assert got.dev_q.device.type == "cpu"
    want = jds.DeviceMembership(q)
    for x in (look, look[:7], look[:0]):
        np.testing.assert_array_equal(got.lookup(x), want.lookup(x))


# ---------------------------------------------------------------------
# the tree-walk LCA


@pytest.fixture(scope="module")
def trees():
    """(JAX Taxonomy, port Taxonomy) of the taxdump and of a synthetic
    3,000-node tree with a 30-node chain."""
    small = load_taxonomy(TAXDUMP)
    big = synth_taxonomy(np.random.default_rng(3), 3000, chain=30)
    return {"taxdump": (small, port_tax(small)), "synth": (big, port_tax(big))}


def taxid_pool(jt) -> np.ndarray:
    known = np.flatnonzero(jt.depth >= 0).astype(np.uint32)
    return np.concatenate([known, [0, 0, UNKNOWN, np.uint32(3 << 30)]]
                          ).astype(np.uint32)


def tables(jt, pt):
    return jax_lca.device_tables(jt), port_lca.device_tables(pt, "cpu")


@pytest.mark.parametrize("tree", ["taxdump", "synth"])
def test_lca_pairs_device_matches_jax_and_host(trees, tree):
    jt, pt = trees[tree]
    pool = taxid_pool(jt)
    rng = np.random.default_rng(11)
    a, b = rng.choice(pool, 4000), rng.choice(pool, 4000)
    (jp, jd, jm), (pp, pd, pm) = tables(jt, pt)
    assert pm == jm
    got = u32(port_lca.lca_pairs_device(i32(a), i32(b), pp, pd, pm))
    np.testing.assert_array_equal(got, np.asarray(
        jax_lca.lca_pairs_device(jnp.asarray(a), jnp.asarray(b), jp, jd, jm)))
    # the host rule is the device's: unknown -> 0, 0 the identity
    np.testing.assert_array_equal(got, pt.lca_pairs(a, b))


def collapse_input(rng, pool, n, max_run):
    """Codes in runs of 1..max_run (shuffled), taxids from ``pool``
    (unknown and 0 among them), a tenth of the slots invalid."""
    runs = rng.integers(1, max_run + 1, size=n)
    codes = np.repeat(rng.integers(0, 1 << 40, size=n, dtype=np.uint64),
                      runs)[:n]
    rng.shuffle(codes)
    taxids = rng.choice(pool, n).astype(np.uint32)
    valid = rng.random(n) > 0.1
    return codes, taxids, valid


@pytest.mark.parametrize("tree,n,max_run,rounds", [
    ("taxdump", 600, 2, 1), ("taxdump", 3000, 6, 3), ("synth", 2500, 9, 4)])
def test_lca_collapse_device_matches_jax(trees, monkeypatch, tree, n,
                                         max_run, rounds):
    """Unknown taxids make a run's merge depend on its order: the port
    pairs the slots of the JAX package's stable sort of (code, invalid),
    held here to that sort (UNIKMER_TPU_SORT_STABLE=1, run eagerly)."""
    jt, pt = trees[tree]
    codes, taxids, valid = collapse_input(np.random.default_rng(n),
                                          taxid_pool(jt), n, max_run)
    (jp, jd, jm), (pp, pd, pm) = tables(jt, pt)
    monkeypatch.setenv("UNIKMER_TPU_SORT_STABLE", "1")
    want = jax_lca.lca_collapse_device.__wrapped__(
        jnp.asarray(codes), jnp.asarray(taxids), jnp.asarray(valid), jp, jd,
        jm, rounds)
    got = port_lca.lca_collapse_device(t64(codes), i32(taxids),
                                       torch.from_numpy(valid), pp, pd, pm,
                                       rounds)
    np.testing.assert_array_equal(u64(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(u32(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def taxid_pair(rng, pool, case):
    a, b = pair(case, rng)
    a, b = np.unique(a), np.unique(b)
    return (padded(a), padded(b), pad_tax(rng.choice(pool, len(a))),
            pad_tax(rng.choice(pool, len(b))))


def pad_tax(t, cap=CAP):
    out = np.zeros(cap, np.uint32)
    out[: len(t)] = t
    return out


@pytest.mark.parametrize("case", ["overlap", "all_shared", "disjoint",
                                  "a_empty"])
@pytest.mark.parametrize("tree", ["taxdump", "synth"])
def test_taxid_set_ops_match_jax(trees, tree, case):
    """union_with_taxids (tree walk), intersect_with_taxids, the
    one-sided intersection and subtract_with_taxids, with unknown and 0
    taxids in both inputs."""
    jt, pt = trees[tree]
    a, b, ta, tb = taxid_pair(np.random.default_rng(5), taxid_pool(jt), case)
    (jp, jd, jm), (pp, pd, pm) = tables(jt, pt)
    assert_same(pds.union_with_taxids(t64(a), i32(ta), t64(b), i32(tb), pp,
                                      pd, pm, 1, 46),
                jds.union_with_taxids(a, ta, b, tb, jp, jd, jm, 1))
    assert_same(pds.intersect_with_taxids(t64(a), i32(ta), t64(b), i32(tb),
                                          pp, pd, pm),
                jds.intersect_with_taxids(a, ta, b, tb, jp, jd, jm))
    zero = np.zeros(CAP, np.uint32)
    for x, y in ((ta, zero), (zero, tb)):
        assert_same(pds.intersect_one_sided_taxids(t64(a), i32(x), t64(b),
                                                   i32(y)),
                    jds.intersect_one_sided_taxids(a, x, b, y))
    assert_same(pds.subtract_with_taxids(t64(a), i32(ta), t64(b)),
                jds.subtract_with_taxids(a, ta, b))


@pytest.mark.parametrize("case", ["overlap", "all_shared", "disjoint",
                                  "a_empty", "b_empty"])
@pytest.mark.parametrize("taxonomy", [True, False])
def test_union_one_sided_taxids_matches_jax_host(trees, case, taxonomy):
    """The union when only a carries taxids (unknown, 0 and one of 2^31
    and above among them) against the JAX host engine's union with a
    zero column for b: with a taxonomy, a shared code whose taxid it
    lacks merges to 0; without one, it keeps its taxid."""
    jt, pt = trees["taxdump"]
    a, b, ta, _ = taxid_pair(np.random.default_rng(6), taxid_pool(jt), case)
    depth = torch.from_numpy(pt.depth.astype(np.int32)) if taxonomy else None
    radix_sort.radix_sort_u64.launches = 0
    c, t, n = pds.union_one_sided_taxids(t64(a), i32(ta), t64(b), depth, 46)
    assert radix_sort.radix_sort_u64.launches == 0  # the plain K2 ran
    na, nb = int((a != SENT).sum()), int((b != SENT).sum())
    want_c, want_t = jax_sets.union(
        [a[:na], b[:nb]], [ta[:na], np.zeros(nb, np.uint32)],
        jt if taxonomy else None)
    n = int(n)
    np.testing.assert_array_equal(u64(c)[:n], want_c)
    np.testing.assert_array_equal(u32(t)[:n], want_t)
    assert (u64(c)[n:] == SENT).all() and (u32(t)[n:] == 0).all()
    if case == "all_shared":
        unknown = ~jt.has(ta[:na]) & (ta[:na] != 0)
        assert unknown.any()
        assert (u32(t)[:n][unknown] == 0).all() == taxonomy


@pytest.mark.parametrize("cap", [None, "0"])
@pytest.mark.parametrize("files", [2, 3, 4, 5])
def test_union_taxids_compact_matches_jax(trees, monkeypatch, cap, files):
    """The compact-id collapse on both tiers ('table'; 'paths' under
    UNIKMER_TPU_TAXID_VOCAB_MAX=0) over 2 to 5 inputs, so runs of up to
    5 members take up to 3 merge rounds."""
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    jt, pt = trees["synth"]
    rng = np.random.default_rng(files)
    known = np.flatnonzero(jt.depth >= 0).astype(np.uint32)
    pool = np.concatenate([rng.choice(known, 60), [0]]).astype(np.uint32)
    base = rng.integers(0, 1 << 40, size=800, dtype=np.uint64)
    parts = [np.unique(np.concatenate([base[rng.random(800) < 0.5],
                                       rng.integers(0, 1 << 40, size=50,
                                                    dtype=np.uint64)]))
             for _ in range(files)]
    codes = np.concatenate(parts + [np.full(200, SENT, np.uint64)])
    taxids = np.concatenate([rng.choice(pool, len(codes) - 200),
                             np.zeros(200, np.uint32)]).astype(np.uint32)
    plan = jax_lca.device_lca_plan(jt, taxids)
    assert plan[0] == ("table" if cap is None else "paths")
    kind, closure, tab = plan
    ctax = jax_lca.compact_ids(closure, taxids)
    rounds = max(len(codes).bit_length() - 1, 1)
    want = jds.union_taxids_compact(codes, ctax, tab, rounds, kind, 64)
    got = pds.union_taxids_compact(t64(codes), torch.from_numpy(ctax),
                                   torch.from_numpy(tab), kind, 64)
    assert_same(got, want)


@pytest.mark.parametrize("cap", [None, "0"])
def test_union_taxids_device_matches_jax(trees, monkeypatch, cap):
    """The CLI's device taxid union on both tiers, and its None cases:
    an unknown nonzero taxid, a real 2^64-1 code."""
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    jt, pt = trees["synth"]
    rng = np.random.default_rng(9)
    known = np.flatnonzero(jt.depth >= 0).astype(np.uint32)
    pool = rng.choice(known, 80, replace=False)
    base = rng.integers(0, 1 << 46, size=3000, dtype=np.uint64)
    code_arrays = [np.unique(base[rng.random(3000) < 0.5]) for _ in range(3)]
    taxid_arrays = [rng.choice(pool, len(c)).astype(np.uint32)
                    for c in code_arrays]
    taxid_arrays[1][:] = known[7]  # a global taxid, as count -t writes
    radix_sort.radix_sort_kv_u64.launches = 0
    got = pds.union_taxids_device(code_arrays, taxid_arrays, pt, 46, "cpu")
    want = jds.union_taxids_device(code_arrays, taxid_arrays, jt,
                                   code_bits=46)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the plain K3 ran (a CPU call counts no launch)
    assert radix_sort.radix_sort_kv_u64.launches == 0
    bad = [t.copy() for t in taxid_arrays]
    bad[2][0] = UNKNOWN
    assert pds.union_taxids_device(code_arrays, bad, pt, 46, "cpu") is None
    assert jds.union_taxids_device(code_arrays, bad, jt, code_bits=46) is None
    ones = [c.copy() for c in code_arrays]
    ones[0][-1] = SENT
    assert pds.union_taxids_device(ones, taxid_arrays, pt, 64, "cpu") is None
    assert jds.union_taxids_device(ones, taxid_arrays, jt) is None
    empty = pds.union_taxids_device([], [], pt, 46, "cpu")
    assert len(empty[0]) == 0 and len(empty[1]) == 0


# ---------------------------------------------------------------------
# on the card: the device set functions at 2^25 against their CPU results


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def big_sets(rng, n=1 << 25):
    """Two 2^25-capacity sets sharing about half their members."""
    base = rng.integers(0, 1 << 46, size=n, dtype=np.uint64)
    a = np.unique(base[: n - n // 8])
    b = np.unique(np.concatenate([base[n // 2:],
                                  rng.integers(0, 1 << 46, size=n // 4,
                                               dtype=np.uint64)]))
    return padded(a, n), padded(b[: n - 5], n)


def on_card(fn, dev, *args):
    out = fn(*[a.to(dev) if isinstance(a, torch.Tensor) else a
               for a in args])
    return tuple(o.cpu() if isinstance(o, torch.Tensor) else o for o in out)


@pytest.mark.cuda
def test_set_ops_on_card_match_cpu(cuda_device):
    a, b = big_sets(np.random.default_rng(1))
    ta, tb = t64(a), t64(b)
    for fn, args in ((pds.union, (ta, tb, 46)), (pds.intersect, (ta, tb)),
                     (pds.subtract, (ta, tb)),
                     (pds.common, (torch.stack([ta, tb, ta]), 2, 46))):
        got = on_card(fn, cuda_device, *args)
        want = fn(*args)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
    q = t64(b[: 1 << 24])
    assert torch.equal(pds.member_bits(ta.to(cuda_device),
                                       q.to(cuda_device)).cpu(),
                       pds.member_bits(ta, q))


@pytest.mark.cuda
def test_taxid_set_ops_on_card_match_cpu(cuda_device, trees):
    jt, pt = trees["synth"]
    rng = np.random.default_rng(2)
    a, b = big_sets(rng)
    pool = taxid_pool(jt)
    ta, tb = i32(rng.choice(pool, len(a))), i32(rng.choice(pool, len(b)))
    pp, pd, pm = port_lca.device_tables(pt, "cpu")
    cp, cd, _ = port_lca.device_tables(pt, cuda_device)
    for fn, cpu_args, card_args in (
            (pds.union_with_taxids, (t64(a), ta, t64(b), tb, pp, pd, pm, 1,
                                     46),
             (t64(a), ta, t64(b), tb, cp, cd, pm, 1, 46)),
            (pds.intersect_with_taxids, (t64(a), ta, t64(b), tb, pp, pd, pm),
             (t64(a), ta, t64(b), tb, cp, cd, pm)),
            (pds.subtract_with_taxids, (t64(a), ta, t64(b)),
             (t64(a), ta, t64(b)))):
        got = on_card(fn, cuda_device, *card_args)
        want = fn(*cpu_args)
        for g, w in zip(got, want):
            assert torch.equal(g, w) if isinstance(g, torch.Tensor) \
                else int(g) == int(w)
