"""K3 (the key+value radix sort) and the port's taxonomy/lca.py against
the JAX package: the plain K3 against the TPU kernel in interpret mode,
lax.sort and numpy, K3's pass plan simulated in numpy, the LCA planners
on the test taxdump and a synthetic tree, and both collapse tiers on
the same inputs and the same JAX-built plan.  Exact equality
throughout; the CUDA kernel is held to its plain version on the card
(marked ``cuda``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unikmer_tpu.ops import sort as jax_sort
from unikmer_tpu.ops.pallas_sort import sort_codes_taxids_pallas
from unikmer_tpu.taxonomy import lca as jax_lca
from unikmer_tpu.taxonomy.taxdump import Taxonomy, load_taxonomy
from unikmer_tpu_torch.ops.codec import SENTINEL
from unikmer_tpu_torch.ops.radix_sort import (
    radix_shifts, radix_sort_kv_u64, sort_kv_plain,
)
from unikmer_tpu_torch.taxonomy import lca as port_lca
from unikmer_tpu_torch.taxonomy.taxdump import Taxonomy as PortTaxonomy

TAXDUMP = "tests/data/taxdump"
VOCAB = np.array([0, 511145, 585057, 349741, 562, 561, 2, 1224, 83333],
                 np.uint32)
VALID_BIT = port_lca._VALID_BIT
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
SPECIAL = np.array([0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1], np.uint64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def taxdb():
    return load_taxonomy(TAXDUMP)


def port_tax(t: Taxonomy) -> PortTaxonomy:
    """The port's Taxonomy from a JAX one's fields."""
    return PortTaxonomy.from_numpy(t.parent, t.depth, t.rank_ids, t.ranks,
                                   t.merged, t.root)


def synth_taxonomy(rng, n_nodes: int, chain: int = 0) -> Taxonomy:
    """Random single-rooted tree over taxids 1..n_nodes (parent of t
    uniform in [1, t)); ``chain`` grafts a linear chain at the end."""
    parent = np.zeros(n_nodes + 1, np.uint32)
    depth = np.full(n_nodes + 1, -1, np.int64)
    parent[1], depth[1] = 1, 0
    if n_nodes > 1:
        p = rng.integers(1, np.arange(2, n_nodes + 1 - chain))
        parent[2: n_nodes + 1 - chain] = p
        for t in range(2, n_nodes + 1 - chain):
            depth[t] = depth[parent[t]] + 1
    for t in range(n_nodes + 1 - chain, n_nodes + 1):
        parent[t] = t - 1
        depth[t] = depth[t - 1] + 1
    return Taxonomy(parent=parent, depth=depth.astype(np.int16),
                    rank_ids=np.full(n_nodes + 1, -1, np.int16), ranks=[])


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def random_u64(rng, n):
    a = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    a[: min(n, 5)] = SPECIAL[: min(n, 5)]
    rng.shuffle(a)
    return a


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def tie_heavy(rng, n, bits=46):
    keys = rng.integers(0, 1 << bits, size=n, dtype=np.uint64)
    keys[: n // 4] = keys[0] if n else 0
    vals = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    vals[rng.random(n) < 0.1] = 0
    return keys, vals


def pair_multiset(keys, vals):
    both = np.stack([keys, vals.astype(np.uint64)], 1)
    return both[np.lexsort((both[:, 1], both[:, 0]))]


# ---------------------------------------------------------------------
# K3


@pytest.mark.parametrize("n,blk", [(1024, 1024), (3000, 1024)])
def test_k3_plain_matches_pallas_interpret_and_lax(n, blk):
    keys, vals = tie_heavy(np.random.default_rng(n), n)
    gk, gv = sort_kv_plain(t64(keys), i32(vals))
    rk, rv = radix_sort_kv_u64(t64(keys), i32(vals))
    assert torch.equal(rk, gk) and torch.equal(rv, gv)
    gk, gv = u64(gk), gv.numpy().view(np.uint32)
    pk, pv = sort_codes_taxids_pallas(jnp.asarray(keys), jnp.asarray(vals),
                                      block_elems=blk, interpret=True)
    lk, lv = jax_sort.sort_codes_taxids(jnp.asarray(keys), jnp.asarray(vals))
    for wk, wv in ((pk, pv), (lk, lv)):
        wk, wv = np.asarray(wk), np.asarray(wv)
        np.testing.assert_array_equal(gk, wk)
        # both JAX sorts are unstable: compare (key, value) multisets
        np.testing.assert_array_equal(pair_multiset(gk, gv),
                                      pair_multiset(wk, wv))


@pytest.mark.parametrize("n", [0, 1, 2, 999, 70000])
def test_k3_plain_matches_numpy_stable(n):
    rng = np.random.default_rng(n + 5)
    keys, vals = tie_heavy(rng, n)
    for k in (keys, random_u64(rng, n), np.full(n, SENT)):
        order = np.argsort(k, kind="stable")
        gk, gv = radix_sort_kv_u64(t64(k), i32(vals))
        np.testing.assert_array_equal(u64(gk), k[order])
        np.testing.assert_array_equal(gv.numpy().view(np.uint32), vals[order])


def lsd_kv_passes_numpy(keys, vals, code_bits):
    """K3's algorithm in numpy: stable 8-bit digit passes at
    radix_shifts(code_bits), the sentinel ranked as 2^code_bits, the
    value moved with its key."""
    ranked = keys.copy()
    if code_bits < 64:
        ranked[keys == SENT] = np.uint64(1) << np.uint64(code_bits)
    order = np.arange(len(keys))
    for shift in radix_shifts(code_bits):
        digit = (ranked[order] >> np.uint64(shift)) & np.uint64(255)
        order = order[np.argsort(digit, kind="stable")]
    return keys[order], vals[order]


@pytest.mark.parametrize("code_bits", [2, 46, 47, 62, 64])
def test_k3_pass_plan_sorts_stably(code_bits):
    rng = np.random.default_rng(code_bits)
    n = 6000
    hi = min(1 << code_bits, 1 << 63)
    keys = rng.integers(0, hi, size=n, dtype=np.uint64)
    if code_bits == 64:
        keys = random_u64(rng, n)
    keys[rng.random(n) < 0.3] = keys[1]  # ties keep input order
    keys[rng.random(n) < 0.05] = SENT
    vals = np.arange(n, dtype=np.uint32) | np.uint32(VALID_BIT)
    order = np.argsort(keys, kind="stable")
    gk, gv = lsd_kv_passes_numpy(keys, vals, code_bits)
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_k3_rejects_bad_inputs():
    k = t64(np.arange(4, dtype=np.uint64))
    with pytest.raises(ValueError):
        radix_sort_kv_u64(k, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        radix_sort_kv_u64(k, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        radix_sort_kv_u64(k, torch.zeros(4, dtype=torch.int32), 65)


# ---------------------------------------------------------------------
# planners


def assert_plans_equal(got, want):
    if want is None:
        assert got is None
        return
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cap", [None, "0"])
def test_planners_match_jax_on_taxdump(taxdb, monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    ptx = port_tax(taxdb)
    for vocab in (VOCAB, VOCAB[:1], VOCAB[[0, 1, 2]], VOCAB[[3, 3, 4]]):
        for name in ("lca_closure", "path_tables"):
            for g, w in zip(getattr(port_lca, name)(ptx, vocab),
                            getattr(jax_lca, name)(taxdb, vocab)):
                np.testing.assert_array_equal(g, w)
        assert_plans_equal(port_lca.device_lca_plan(ptx, vocab),
                           jax_lca.device_lca_plan(taxdb, vocab))
        g = port_lca.closure_for_vocab(ptx, vocab)
        w = jax_lca.closure_for_vocab(taxdb, vocab)
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g[1], w[1])
    plan = port_lca.device_lca_plan(ptx, VOCAB)
    assert plan[0] == ("table" if cap is None else "paths")


@pytest.mark.parametrize("cap", [None, "0"])
def test_planners_match_jax_on_synthetic_tree(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    rng = np.random.default_rng(2000)
    tx = synth_taxonomy(rng, 2000, chain=30)
    vocab = rng.choice(np.arange(1, 2001, dtype=np.uint32), size=300,
                       replace=False)
    vocab[:5] = [2000, 1990, 1985, 0, 1]
    for name in ("path_tables", "device_lca_plan"):
        got = getattr(port_lca, name)(port_tax(tx), vocab)
        want = getattr(jax_lca, name)(tx, vocab)
        if name == "device_lca_plan":
            assert_plans_equal(got, want)
        else:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_plan_declines_like_jax(taxdb, monkeypatch):
    unknown = np.array([562, 999999], np.uint32)
    assert port_lca.device_lca_plan(port_tax(taxdb), unknown) is None
    assert jax_lca.device_lca_plan(taxdb, unknown) is None
    tx = synth_taxonomy(np.random.default_rng(3), 200, chain=60)
    deep = np.array([150, 200, 199, 180], np.uint32)
    monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", "0")
    want = jax_lca.device_lca_plan(tx, deep)
    assert want[0] == "paths"
    assert_plans_equal(port_lca.device_lca_plan(port_tax(tx), deep), want)
    # JAX declines a path past its TPU block depth; the port plans it
    monkeypatch.setenv("UNIKMER_TPU_TAXID_PATH_DEPTH_MAX", "2")
    assert jax_lca.device_lca_plan(tx, deep) is None
    assert_plans_equal(port_lca.device_lca_plan(port_tax(tx), deep), want)
    assert want[2].shape[1] > 2


# ---------------------------------------------------------------------
# collapse


def collapse_case(rng, n, closure, spanning=False):
    """Codes with long runs, runs that open with invalid slots, id 0
    members and (optionally) one run over all n slots."""
    codes = rng.integers(0, max(n // 6, 2), size=n, dtype=np.uint64)
    if spanning:
        codes[:] = 12345
    ids = rng.integers(0, len(closure), size=n).astype(np.int32)
    valid = rng.random(n) < 0.85
    valid[0] = False  # the smallest code's run may open invalid
    return codes, ids, valid


def jax_collapse(kind, codes, ids, valid, tab, code_bits):
    """The JAX collapse as its pipeline runs it: padded to a power of
    two with invalid slots, log2 rounds; kept (codes, ids)."""
    n = len(codes)
    nn = 1 << max((n - 1).bit_length(), 1)
    pad = nn - n
    f = (jax_lca.lca_collapse_compact if kind == "table"
         else jax_lca.lca_collapse_paths)
    sc, tx, keep, _ = f(
        jnp.asarray(np.concatenate([codes, np.zeros(pad, np.uint64)])),
        jnp.asarray(np.concatenate([ids, np.zeros(pad, np.int32)])),
        jnp.asarray(np.concatenate([valid, np.zeros(pad, bool)])),
        jnp.asarray(tab), nn.bit_length() - 1, code_bits)
    keep = np.asarray(keep)
    return np.asarray(sc)[keep], np.asarray(tx)[keep]


def port_collapse(kind, codes, ids, valid, tab, code_bits=64):
    """The port's collapse of a masked code array, as count -T runs it:
    (sorted codes, merged ids, keep mask, valid mask), sorted order."""
    valid = valid.bool()
    sc, tx, first, run_valid, s_valid = port_lca.collapse_keyed_taxids(
        torch.where(valid, codes, SENTINEL), ids, valid, tab, kind, code_bits)
    return sc, tx, first & (run_valid > 0), s_valid


@pytest.mark.parametrize("cap", [None, "0"])
@pytest.mark.parametrize("n,spanning", [(777, False), (4099, False),
                                        (777, True), (4099, True)])
def test_collapse_matches_jax(taxdb, monkeypatch, cap, n, spanning):
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    plan = jax_lca.device_lca_plan(taxdb, VOCAB)
    kind, closure, tab = plan
    rng = np.random.default_rng(n + 7 * spanning)
    codes, ids, valid = collapse_case(rng, n, closure, spanning)
    want_c, want_t = jax_collapse(kind, codes, ids, valid, tab, 46)
    _, _, dtab = port_lca.upload_plan(plan, torch.device("cpu"))
    sc, tx, keep, s_valid = port_collapse(
        kind, t64(codes), torch.from_numpy(ids), torch.from_numpy(valid),
        dtab, 46)
    keep = keep.numpy()
    np.testing.assert_array_equal(u64(sc)[keep], want_c)
    np.testing.assert_array_equal(tx.numpy()[keep], want_t)
    assert int(s_valid.sum()) == int(valid.sum())
    # and the host reduction over the valid slots
    order = np.argsort(codes[valid], kind="stable")
    hk, ht = taxdb.lca_reduce(codes[valid][order],
                              closure[ids[valid]][order])
    np.testing.assert_array_equal(u64(sc)[keep], hk)
    np.testing.assert_array_equal(closure[tx.numpy()[keep]], ht)


def test_collapse_keeps_real_all_ones_codes(taxdb):
    # k = 32 poly-T: real 2^64-1 codes share the last run with the
    # invalid slots; the valid bit, not the key, says which count
    plan = jax_lca.device_lca_plan(taxdb, VOCAB)
    kind, closure, tab = plan
    rng = np.random.default_rng(32)
    codes, ids, valid = collapse_case(rng, 1500, closure)
    codes[:40] = SENT
    valid[:40] = False
    valid[[3, 17]] = True
    ids[[3, 17]] = np.searchsorted(closure, [511145, 585057])
    want_c, want_t = jax_collapse(kind, codes, ids, valid, tab, 64)
    sc, tx, keep, _ = port_collapse(
        kind, t64(codes), torch.from_numpy(ids), torch.from_numpy(valid),
        torch.from_numpy(tab), 64)
    keep = keep.numpy()
    got_c = u64(sc)[keep]
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(tx.numpy()[keep], want_t)
    assert got_c[-1] == SENT and closure[tx.numpy()[keep][-1]] == 562


@pytest.mark.parametrize("mode", ["distinct", "repeated"])
def test_deep_paths_count_matches_jax_host_route(monkeypatch, mode):
    # past JAX's path depth cap the JAX package reduces on the host; the
    # port keeps the paths tier on the device and must agree with it
    from unikmer_tpu.io.fastx import Record, pack_records
    from unikmer_tpu.models import count as jax_count
    from unikmer_tpu_torch.io.fastx import PackedSeqs
    from unikmer_tpu_torch.models import count as port_count

    tx = synth_taxonomy(np.random.default_rng(3), 200, chain=60)
    rng = np.random.default_rng(4)
    shared = rng.choice(list(b"ACGT"), size=200).astype(np.uint8).tobytes()
    taxids = [200, 199, 180, 150, 141, 60, 200]
    recs = [Record(b"r%d" % i, b"r%d" % i,
                   shared + rng.choice(list(b"ACGT"), size=600)
                   .astype(np.uint8).tobytes()) for i in range(len(taxids))]
    packed = pack_records(recs, 15)
    rec_taxids = np.array(taxids, np.uint32)
    monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", "0")
    monkeypatch.setenv("UNIKMER_TPU_TAXID_PATH_DEPTH_MAX", "2")
    assert jax_lca.device_lca_plan(tx, rec_taxids) is None
    ptx = port_tax(tx)
    assert port_lca.device_lca_plan(ptx, rec_taxids)[2].shape[1] > 2
    jcfg = jax_count.CountConfig(k=15, canonical=True, mode=mode)
    want = jax_count.count_taxids_from_packed(packed, rec_taxids, jcfg, tx)
    got = port_count.count_taxids_from_packed(
        PackedSeqs.from_numpy(packed.bases, packed.starts, packed.lengths),
        rec_taxids, port_count.CountConfig.from_reference(jcfg), ptx,
        torch.device("cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) > 150 and len(np.unique(got[1])) > 1


def test_merge_rounds_cover_the_longest_run():
    # a run of 2^m + 1 slots needs m + 1 rounds: floor(log2 n) would
    # leave the last member out of the head's merge.  Ids: 0 = taxid 0,
    # 1 = a root, 2 and 3 its children.
    tab = np.array([[0, 1, 2, 3], [1, 1, 1, 1], [2, 1, 2, 1], [3, 1, 1, 3]],
                   np.int32)
    for n in (2, 3, 5, 9, 17, 1025):
        ids = np.full(n, 2, np.int32)
        ids[-1] = 3  # only the last member lifts the LCA to the root
        sc, tx, keep, _ = port_collapse(
            "table", t64(np.full(n, 7, np.uint64)), torch.from_numpy(ids),
            torch.ones(n, dtype=torch.bool), torch.from_numpy(tab))
        assert keep.numpy().tolist() == [True] + [False] * (n - 1)
        assert int(tx[0]) == 1, n


def test_collapse_empty():
    sc, tx, keep, sv = port_collapse(
        "table", t64(np.zeros(0, np.uint64)), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool), torch.zeros((1, 1), dtype=torch.int32))
    assert sc.shape == tx.shape == keep.shape == sv.shape == (0,)


# ---------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("code_bits", [2, 46, 64])
def test_k3_kernel_matches_plain_on_card(cuda_device, code_bits):
    rng = np.random.default_rng(code_bits)
    for n in (0, 1, 1000, 4097, (1 << 20) + 3):
        if code_bits == 64:
            keys = random_u64(rng, n)
        else:
            keys = rng.integers(0, 1 << code_bits, size=n, dtype=np.uint64)
        keys[rng.random(n) < 0.05] = SENT
        keys[rng.random(n) < 0.2] = keys[0] if n else 0
        vals = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
        vals[rng.random(n) < 0.5] |= np.uint32(VALID_BIT)
        k, v = t64(keys).to(cuda_device), i32(vals).to(cuda_device)
        gk, gv = radix_sort_kv_u64(k, v, code_bits)
        wk, wv = sort_kv_plain(k, v)
        assert torch.equal(gk, wk) and torch.equal(gv, wv)


@pytest.mark.cuda
def test_collapse_on_card_matches_cpu(cuda_device, taxdb, monkeypatch):
    for cap in ("4096", "0"):
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
        plan = port_lca.device_lca_plan(port_tax(taxdb), VOCAB)
        rng = np.random.default_rng(5)
        codes, ids, valid = collapse_case(rng, 100000, plan[1])
        want = port_collapse(plan[0], t64(codes), torch.from_numpy(ids),
                             torch.from_numpy(valid),
                             torch.from_numpy(plan[2]), 46)
        got = port_collapse(plan[0], t64(codes).to(cuda_device),
                            torch.from_numpy(ids).to(cuda_device),
                            torch.from_numpy(valid).to(cuda_device),
                            port_lca.upload_plan(plan, cuda_device)[2], 46)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
