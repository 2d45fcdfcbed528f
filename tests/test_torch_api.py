"""The port's ``KmerSet`` (unikmer_tpu_torch/api.py) against the JAX
package's on the CPU: the same seeded codes go through both, and every
chain of operations must give the same members, taxids, n, capacity,
repr and `.unik` bytes.  The port runs on ``cpu`` (plain versions of its
kernels); a card case (marked ``cuda``) holds the card to the CPU."""

import numpy as np
import pytest
import torch

import unikmer_tpu.api as jax_api
import unikmer_tpu_torch
import unikmer_tpu_torch.api as port_api
from unikmer_tpu.taxonomy.taxdump import load_taxonomy
from unikmer_tpu_torch.ops import radix_sort

from test_torch_lca import port_tax

JK, PK = jax_api.KmerSet, port_api.KmerSet
TAXDUMP = "tests/data/taxdump"
TAXIDS = np.array([511145, 585057, 349741, 562, 561, 2, 1224, 83333, 0],
                  np.uint32)
UNKNOWN = 999999


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Constructors called without ``device=`` take the CPU."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def taxdbs():
    j = load_taxonomy(TAXDUMP)
    return j, port_tax(j)


def both(codes, k=23, taxids=None, taxdbs=None, **kw):
    """(JAX set, port set) from the same codes and flags."""
    jdb, pdb = taxdbs if taxdbs is not None else (None, None)
    j = JK.from_codes(codes, k, taxids=taxids, taxdb=jdb, **kw)
    p = PK.from_codes(codes, k, taxids=taxids, taxdb=pdb, device="cpu", **kw)
    return j, p


def assert_same(j, p):
    assert isinstance(p, PK) and p.device.type == "cpu"
    np.testing.assert_array_equal(p.to_numpy(), np.asarray(j.to_numpy()))
    assert p.to_numpy().dtype == np.uint64
    jt, pt = j.taxids_to_numpy(), p.taxids_to_numpy()
    assert (jt is None) == (pt is None)
    if jt is not None:
        np.testing.assert_array_equal(pt, np.asarray(jt))
    assert (len(p), p.capacity, repr(p)) == (len(j), j.capacity, repr(j))


def draws(seed, n=3000, hi=1 << 20, count=4):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, hi, size=n, dtype=np.uint64)
    return [np.concatenate([base[rng.random(n) < 0.5],
                            rng.integers(0, hi, size=n // 4,
                                         dtype=np.uint64)])
            for _ in range(count)]


def test_from_codes_matches_jax(taxdbs):
    codes = draws(1)[0]
    for kw in ({}, {"assume_sorted_unique": True}):
        c = np.unique(codes) if kw else codes
        assert_same(*both(c, **kw))
    assert_same(*both(codes[:0]))
    rng = np.random.default_rng(2)
    assert_same(*both(codes, taxids=rng.choice(TAXIDS, len(codes)),
                      taxdbs=taxdbs))
    assert_same(*both(np.unique(codes) | np.uint64(1 << 60), k=31,
                      hashed=True, canonical=True, scale=4))
    for mk in (JK, PK):
        with pytest.raises(ValueError, match="all-ones"):
            mk.from_codes(np.array([3, 2**64 - 1], np.uint64), 23)
        with pytest.raises(ValueError, match="needs taxdb"):
            mk.from_codes(codes[:3], 23, taxids=TAXIDS[:3])
    # an unhashed set's codes fit in 2k bits, the width its sorts take
    with pytest.raises(ValueError, match="wider than 2k = 46 bits"):
        PK.from_codes(np.array([3, 1 << 46], np.uint64), 23)


def test_chain_matches_jax():
    """(a | b) & c - d, step by step, with the K2 launches counted."""
    sets = [both(c) for c in draws(3)]
    (ja, pa), (jb, pb), (jc, pc), (jd, pd) = sets
    ju, pu = ja | jb, pa | pb
    assert_same(ju, pu)
    assert_same((ju & jc) - jd, (pu & pc) - pd)
    assert_same(jd - ja, pd - pa)
    empty = both(np.zeros(0, np.uint64))
    for op in ("__or__", "__and__", "__sub__"):
        assert_same(getattr(ja, op)(empty[0]), getattr(pa, op)(empty[1]))
        assert_same(getattr(empty[0], op)(ja), getattr(empty[1], op)(pa))
    # on the CPU the plain sort runs, so no launch is counted
    assert radix_sort.radix_sort_u64.launches == 0


@pytest.mark.parametrize("threshold", [0, 1, 2, 4, 5])
def test_union_all_and_common_match_jax(threshold):
    sets = [both(c) for c in draws(4)]
    js, ps = [s[0] for s in sets], [s[1] for s in sets]
    assert_same(JK.union_all(js), PK.union_all(ps))
    assert_same(JK.common(js, threshold), PK.common(ps, threshold))
    small = both(draws(5, n=40)[0])
    assert_same(JK.common([small[0], js[1]], threshold),
                PK.common([small[1], ps[1]], threshold))
    for mk in (JK, PK):
        with pytest.raises(ValueError, match="at least one"):
            mk.union_all([])


def taxid_sets(taxdbs, seed):
    """Four sets with per-code taxids from the taxdump; the first holds
    an unknown nonzero taxid and some 0s."""
    rng = np.random.default_rng(seed)
    out = []
    for i, c in enumerate(draws(seed, n=2000)):
        c = np.unique(c)
        t = rng.choice(TAXIDS, len(c)).astype(np.uint32)
        if i == 0:
            t[::97] = UNKNOWN
        out.append(both(c, taxids=t, taxdbs=taxdbs,
                        assume_sorted_unique=True))
    return out


def test_taxid_chain_matches_jax(taxdbs):
    (ja, pa), (jb, pb), (jc, pc), (jd, pd) = taxid_sets(taxdbs, 6)
    ju, pu = ja | jb, pa | pb
    assert_same(ju, pu)  # the tree walk, unknown taxid included
    assert_same(jb | ja, pb | pa)
    assert_same(ja & jb, pa & pb)
    assert_same(ja - jb, pa - pb)
    assert_same((ju & jc) - jd, (pu & pc) - pd)
    assert_same(JK.union_all([ja, jb, jc]), PK.union_all([pa, pb, pc]))
    # one side without taxids: its partner's taxids pass through
    jn, pn = both(np.asarray(jc.to_numpy()))
    for jx, px in ((ja & jn, pa & pn), (jn & ja, pn & pa),
                   (ja | jn, pa | pn), (jn | ja, pn | pa),
                   (jn - ja, pn - pa), (ja - jn, pa - pn)):
        assert_same(jx, px)


def test_queries_and_transforms_match_jax():
    ja, pa = both(draws(7)[0])
    rng = np.random.default_rng(8)
    q = np.concatenate([ja.to_numpy()[::3], rng.integers(
        0, 1 << 20, size=2000, dtype=np.uint64),
        np.array([2**64 - 1], np.uint64)])
    rng.shuffle(q)
    got = pa.contains(q)
    np.testing.assert_array_equal(got, np.asarray(ja.contains(q)))
    assert 0 < got.sum() < len(q)
    for n in (0, 5, 10**6):
        assert_same(ja.head(n), pa.head(n))
    for start, window in ((0, 1), (3, 7)):
        assert_same(ja.sample(start, window), pa.sample(start, window))
    with pytest.raises(ValueError, match="window"):
        pa.sample(0, 0)
    # 2-bit codes with low-complexity runs (poly-A is code 0)
    jl, pl = both(np.concatenate([np.arange(300, dtype=np.uint64),
                                  draws(9, hi=1 << 46)[0]]))
    for invert in (False, True):
        assert_same(jl.filter_low_complexity(invert=invert),
                    pl.filter_low_complexity(invert=invert))
    jh, ph = both(np.unique(draws(9)[1]), k=31, hashed=True)
    with pytest.raises(ValueError, match="2-bit"):
        ph.filter_low_complexity()


@pytest.mark.parametrize("attached", [True, False])
@pytest.mark.parametrize("const", [True, False])
def test_one_sided_union_matches_jax(taxdbs, attached, const):
    """A union where one side carries taxids (per code with an unknown
    one, or one global taxid), with and without an attached taxonomy:
    the port's device union against the JAX package's host engine, one
    K2 sort."""
    (jt, pt), = taxid_sets(taxdbs, 18)[:1]
    codes, taxids = jt.to_numpy(), jt.taxids_to_numpy()
    if const:
        taxids = np.full(len(codes), 562, np.uint32)
    dbs = taxdbs if attached else None
    jt, pt = both(codes, taxids=taxids, taxdbs=dbs,
                  assume_sorted_unique=True)
    jn, pn = both(np.unique(draws(19)[1]))
    radix_sort.radix_sort_u64.launches = 0
    for jr, pr in ((jt | jn, pt | pn), (jn | jt, pn | pt)):
        assert_same(jr, pr)
    assert radix_sort.radix_sort_u64.launches == 0  # the plain K2 ran


@pytest.mark.parametrize("cap", [None, "4096"])
def test_transforms_keep_taxids_match_jax(taxdbs, monkeypatch, cap):
    """head, sample and filter_low_complexity of a taxid set, on the
    device and (UNIKMER_TPU_MAX_ELEMS=4096) kept on the host."""
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", cap)
    rng = np.random.default_rng(20)
    codes = np.unique(np.concatenate([
        np.arange(200, dtype=np.uint64),
        rng.integers(0, 1 << 46, size=4000, dtype=np.uint64)]))
    jt, pt = both(codes, taxids=rng.choice(TAXIDS, len(codes)),
                  taxdbs=taxdbs, assume_sorted_unique=True)
    assert isinstance(pt._codes, np.ndarray) == (cap is not None)
    for n in (0, 7, len(codes), 10**6):
        assert_same(jt.head(n), pt.head(n))
    for start, window in ((0, 1), (5, 3), (len(codes) + 1, 2)):
        assert_same(jt.sample(start, window), pt.sample(start, window))
    for invert in (False, True):
        assert_same(jt.filter_low_complexity(invert=invert),
                    pt.filter_low_complexity(invert=invert))


@pytest.mark.parametrize("cap", [str((1 << 20) + 1), "4096"])
def test_host_routes_match_jax(taxdbs, monkeypatch, cap):
    """UNIKMER_TPU_MAX_ELEMS sends the operations to the host engine: at
    2^20 + 1 the sets stay on the device and their operations (whose
    capacities add past the cap) go to the host; at 4096 the sets stay
    on the host too.  Both packages alike."""
    plain = [both(c) for c in draws(10, count=3)]
    tax = taxid_sets(taxdbs, 11)
    monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", cap)
    (ja, pa), (jb, pb), (jc, pc) = [both(j.to_numpy()) for j, _ in plain]
    assert isinstance(pa._codes, np.ndarray) == (cap == "4096")
    assert_same((ja | jb) & jc, (pa | pb) & pc)
    assert_same(ja - jb, pa - pb)
    assert_same(JK.union_all([ja, jb, jc]), PK.union_all([pa, pb, pc]))
    assert_same(JK.common([ja, jb, jc], 2), PK.common([pa, pb, pc], 2))
    (jx, px), (jy, py) = tax[:2]
    for jr, pr in ((jx | jy, px | py), (jx & jy, px & py), (jx - jy, px - py),
                   (jx & ja, px & pa), (ja | jx, pa | px)):
        assert_same(jr, pr)
    q = ja.to_numpy()[:50]
    np.testing.assert_array_equal(pa.contains(q), np.asarray(ja.contains(q)))


def test_save_bytes_match_jax(taxdbs, tmp_path):
    (jt, pt), = taxid_sets(taxdbs, 12)[:1]
    jn, pn = both(np.unique(draws(13)[0]), k=31, hashed=True, scale=3)
    for name, (j, p) in (("t", (jt, pt)), ("n", (jn, pn))):
        for compress in (False, True):
            paths = [tmp_path / f"{name}{compress}{w}.unik" for w in "jp"]
            j.save(str(paths[0]), compress=compress)
            p.save(str(paths[1]), compress=compress)
            assert paths[0].read_bytes() == paths[1].read_bytes() or (
                compress and _inflated(paths[0]) == _inflated(paths[1]))
            back = PK.from_unik(str(paths[1]), device="cpu")
            assert_same(JK.from_unik(str(paths[0])), back)


def _inflated(path):
    import gzip

    return gzip.decompress(path.read_bytes())


def test_from_reference_carries_a_jax_set(taxdbs):
    (jt, _), (ju, _) = taxid_sets(taxdbs, 14)[:2]
    pt = PK.from_reference(jt, device="cpu")
    pu = PK.from_reference(ju, device="cpu")
    assert pt._taxdb is not None and pt._taxdb is not taxdbs[0]
    assert_same(jt | ju, pt | pu)
    assert_same(jt & ju, pt & pu)
    jn, _ = both(draws(15)[0])
    assert_same(jn | jn, PK.from_reference(jn, device="cpu") | PK.from_codes(
        np.asarray(jn.to_numpy()), 23, device="cpu"))


@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_from_fasta_matches_jax(tmp_path, monkeypatch, mode):
    """One piece, then pieces of 4,096 bases (distinct: a device union of
    the pieces; unique/repeated: the capped host merge)."""
    rng = np.random.default_rng(16)
    seq = rng.choice(list(b"ACGTN"), size=30000,
                     p=[.245, .245, .245, .245, .02]).astype(np.uint8)
    seq = np.concatenate([seq, seq[:5000]]).tobytes()
    fa = tmp_path / "g.fa"
    fa.write_bytes(b">g\n" + seq + b"\n>h\n" + seq[:900] + b"\n")
    kw = dict(canonical=True, mode=mode)
    assert_same(JK.from_fasta(str(fa), 15, **kw),
                PK.from_fasta(str(fa), 15, device="cpu", **kw))
    monkeypatch.setattr(jax_api, "_stream_chunk_bases", lambda: 4096)
    monkeypatch.setattr(port_api, "_stream_chunk_bases", lambda dev: 4096)
    assert_same(JK.from_fasta(str(fa), 15, **kw),
                PK.from_fasta(str(fa), 15, device="cpu", **kw))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PK.from_fasta(str(fa), 15, mesh=2, device="cpu")


def test_devices_and_flags_must_match():
    a = PK.from_codes(np.arange(4, dtype=np.uint64), 23, device="cpu")
    b = PK.from_codes(np.arange(4, dtype=np.uint64), 25, device="cpu")
    with pytest.raises(ValueError, match="k differs"):
        _ = a | b
    c = PK.from_codes(np.arange(4, dtype=np.uint64), 23, device="cpu")
    c.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="different devices"):
        _ = a & c
    with pytest.raises(TypeError):
        _ = a - np.arange(3)


def test_lazy_export():
    assert unikmer_tpu_torch.KmerSet is PK
    with pytest.raises(AttributeError):
        _ = unikmer_tpu_torch.NoSuchName
    assert PK.from_codes(np.arange(3, dtype=np.uint64), 5).device.type == "cpu"


@pytest.mark.cuda
def test_kmerset_on_card_matches_cpu(taxdbs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(17)
    codes = [rng.integers(0, 1 << 46, size=1 << 22, dtype=np.uint64)
             for _ in range(3)]
    at_codes = np.unique(codes[0])
    at_taxids = rng.choice(TAXIDS, len(at_codes))
    at_taxids[::1001] = UNKNOWN
    for dev in ("cpu", "cuda"):
        a, b, c = [PK.from_codes(x, 23, device=dev) for x in codes]
        at = PK.from_codes(at_codes, 23, taxids=at_taxids, taxdb=taxdbs[1],
                           assume_sorted_unique=True, device=dev)
        got = {"chain": ((a | b) & c) - a, "all": PK.union_all([a, b, c]),
               "common": PK.common([a, b, c], 2),
               "one-sided": at | b, "head": at.head(1000),
               "sample": at.sample(3, 7),
               "filter": a.filter_low_complexity(invert=True)}
        if dev == "cpu":
            want = got
        else:
            assert a.device.type == "cuda"
            for key in got:
                np.testing.assert_array_equal(got[key].to_numpy(),
                                              want[key].to_numpy())
                gt, wt = got[key].taxids_to_numpy(), want[key].taxids_to_numpy()
                assert (gt is None) == (wt is None)
                if wt is not None:
                    np.testing.assert_array_equal(gt, wt)
                assert got[key].capacity == want[key].capacity


# ---------------------------------------------------------------------
# admission: past a route's element budget the host route


@pytest.fixture
def small_budget(monkeypatch):
    """The device's free bytes replaced by 64 KiB: every route's element
    budget falls below a set of one 2^20-slot capacity."""
    from unikmer_tpu_torch.ops import device_sets

    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 16)


def same_members(j, p):
    np.testing.assert_array_equal(p.to_numpy(), np.asarray(j.to_numpy()))
    jt, pt = j.taxids_to_numpy(), p.taxids_to_numpy()
    assert (jt is None) == (pt is None)
    if jt is not None:
        np.testing.assert_array_equal(pt, np.asarray(jt))


def no_device_sets(monkeypatch):
    """Make every device set function of the KmerSet routes raise."""
    from unikmer_tpu_torch.ops import device_sets

    def boom(*a, **kw):
        raise AssertionError("a device route ran past the budget")

    for name in ("union", "intersect", "subtract", "common",
                 "union_one_sided_taxids", "union_with_taxids",
                 "intersect_with_taxids", "intersect_one_sided_taxids",
                 "subtract_with_taxids"):
        monkeypatch.setattr(device_sets, name, boom)
    monkeypatch.setattr(port_api, "collapse_sorted", boom)


@pytest.mark.parametrize("taxids", ["none", "both", "one"])
@pytest.mark.parametrize("op", ["|", "&", "-", "union_all", "common"])
def test_set_ops_past_the_budget_take_the_host_route(taxdbs, monkeypatch,
                                                     op, taxids):
    """Sets made on the device, then the free bytes made small: each
    operation (and its taxid forms) takes the host engine, keeps its
    result on the host, and gives the JAX package's members."""
    if taxids == "none":
        sets = [both(c) for c in draws(30, count=3)]
    else:
        sets = taxid_sets(taxdbs, 31)[:3]
        if taxids == "one":
            sets[1] = both(np.asarray(sets[1][0].to_numpy()))
    (ja, pa), (jb, pb), (jc, pc) = sets
    assert not pa._on_host
    from unikmer_tpu_torch.ops import device_sets

    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 16)
    no_device_sets(monkeypatch)
    want, got = {
        "|": lambda: (ja | jb, pa | pb),
        "&": lambda: (ja & jb, pa & pb),
        "-": lambda: (ja - jb, pa - pb),
        "union_all": lambda: (JK.union_all([ja, jb, jc]),
                              PK.union_all([pa, pb, pc])),
        "common": lambda: (JK.common([ja, jb, jc], 2),
                           PK.common([pa, pb, pc], 2)),
    }[op]()
    assert got._on_host and len(got) > 100
    same_members(want, got)


def test_from_fasta_past_the_budget_takes_the_host_merge(tmp_path,
                                                         monkeypatch,
                                                         small_budget):
    """A multi-piece FASTA past the from_fasta budget: the pieces are
    merged on the host (no device union_all), the set stays there, and
    its members are the JAX package's."""
    rng = np.random.default_rng(32)
    seq = rng.choice(list(b"ACGTN"), size=30000,
                     p=[.245, .245, .245, .245, .02]).astype(np.uint8)
    fa = tmp_path / "g.fa"
    fa.write_bytes(b">g\n" + seq.tobytes() + b"\n>h\n" + seq[:900].tobytes()
                   + b"\n")
    monkeypatch.setattr(jax_api, "_stream_chunk_bases", lambda: 4096)
    monkeypatch.setattr(port_api, "_stream_chunk_bases", lambda dev: 4096)
    no_device_sets(monkeypatch)
    merged = []
    real = port_api.count_stream_packed
    monkeypatch.setattr(port_api, "count_stream_packed",
                        lambda *a, **kw: (merged.append(1),
                                          real(*a, **kw))[1])
    monkeypatch.setattr(PK, "union_all", staticmethod(
        lambda sets: (_ for _ in ()).throw(AssertionError("device merge"))))
    got = PK.from_fasta(str(fa), 15, canonical=True, device="cpu")
    assert merged == [1] and got._on_host and len(got) > 20000
    same_members(JK.from_fasta(str(fa), 15, canonical=True), got)


ROUTES = ["from_fasta", "from_codes", "union", "union_one_sided",
          "union_taxids", "intersect", "intersect_one_sided",
          "intersect_taxids", "subtract", "subtract_taxids", "union_all",
          "common", "union_taxids_table", "union_taxids_paths", "membership"]


@pytest.mark.parametrize("route", ROUTES)
def test_element_budget(monkeypatch, route):
    """No budget on the CPU; the free bytes over the route's bytes a slot
    where the device reports them; UNIKMER_TPU_MAX_ELEMS wins."""
    from unikmer_tpu_torch.ops import device_sets

    assert sorted(device_sets.SLOT_BYTES) == sorted(ROUTES)

    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS", raising=False)
    assert device_sets._device_free_bytes(torch.device("cpu")) is None
    assert device_sets.element_budget(route, "cpu") == 1 << 62
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 80 << 30)
    per = device_sets.SLOT_BYTES[route]
    assert 4 <= per <= 1024
    share = int((80 << 30) * device_sets.ADMIT_SHARE)
    assert device_sets.element_budget(route, "cpu") == share // per
    assert device_sets.element_budget(route, "cpu", 3, 1 << 20) == (
        share - (1 << 20)) // (per + 3 * device_sets.PATH_COLUMN_BYTES)
    monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", "12345")
    assert device_sets.element_budget(route, "cpu") == 12345


def test_union_taxids_device_declines_past_the_budget(taxdbs, monkeypatch):
    """union_taxids_device returns None past its tier's budget (the JAX
    package's nn > 2^25), which sends the CLI to the host engine."""
    from unikmer_tpu_torch.ops import device_sets

    rng = np.random.default_rng(33)
    codes = [np.unique(c) for c in draws(34, count=3)]
    taxids = [rng.choice(TAXIDS[:-1], len(c)).astype(np.uint32)
              for c in codes]
    args = (codes, taxids, taxdbs[1], 40, "cpu")
    assert device_sets.union_taxids_device(*args) is not None
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 16)
    assert device_sets.union_taxids_device(*args) is None
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 40)
    assert device_sets.union_taxids_device(*args) is not None


def test_paths_tier_budget_counts_the_table_width(monkeypatch):
    """The paths tier's bytes a code grow with its path table's width:
    under the same free bytes, codes whose taxids lie on a 64-deep chain
    go to the host engine (None) where those of a 4-deep chain are
    admitted, and the admitted union equals the host engine's."""
    from unikmer_tpu_torch.ops import device_sets
    from unikmer_tpu_torch.ops import sets as host_sets
    from unikmer_tpu_torch.slot_bytes import chain_taxonomy

    monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", "0")
    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS", raising=False)
    rng = np.random.default_rng(35)
    codes = [np.unique(c) for c in draws(36, count=3)]
    n = sum(len(c) for c in codes)
    shallow = (device_sets.SLOT_BYTES["union_taxids_paths"]
               + 4 * device_sets.PATH_COLUMN_BYTES)
    free = int(n * shallow / device_sets.ADMIT_SHARE) + (1 << 16)
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: free)
    got = {}
    for depth in (4, 64):
        taxdb = chain_taxonomy(depth)
        taxids = [rng.integers(2, depth + 2, len(c)).astype(np.uint32)
                  for c in codes]
        got[depth] = device_sets.union_taxids_device(codes, taxids, taxdb,
                                                     40, "cpu")
        if depth == 4:
            want_codes, want_taxids = host_sets.union(codes, taxids, taxdb)
    assert got[64] is None
    assert np.array_equal(got[4][0], want_codes)
    assert np.array_equal(got[4][1], want_taxids)
