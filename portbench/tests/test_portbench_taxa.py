"""Configurations that carry taxids: the seeded taxonomy, the reference's
LCA and taxid set algebra, and whole runs of a tagged cell made of added
files alone (the look for a card skipped, the port's plain versions),
over a window of a fixed count of requests.  Also: the cells that carry
no taxids keep their checks, requests and genomes."""

import hashlib
import json
import tempfile
from collections import Counter

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL, SMALL_MIX
from portbench import cell as harness
from portbench.control import control_run
from portbench.gen.genomes import clade_of, write_genomes
from portbench.gen.taxonomy import build_tree, write_taxonomy
from portbench.gen.traffic import RequestStream, sample_ordinals
from portbench.reference.compare import taxids_wrong
from portbench.reference.taxa import Lineages, TaxaSets, read_nodes
from test_portbench_imports import top_level_imports
from test_portbench_run import copy_of_harness

CPU = torch.device("cpu")
RANKS = ["superkingdom", "phylum", "class", "order", "family", "genus",
         "species", "strain"]
TAXONOMY = {"nodes": 3000, "max_taxid": 200000, "ranks": RANKS,
            "depth": [9, 14], "unranked_max": 1}
GENOME_TAXA = {"clades_per_genus": 2, "genera_per_family": 2}
SIZES = {**SMALL, "clades": 4}  # 2 genomes a clade, 2 genera, 1 family
MIX = {"loop": "closed", "clients": 1, "subset_sizes": [2, 4, 8],
       "deck": [{"kind": "pan", "per_size": 7, "op": ["union_all", "S"]},
                {"kind": "specific", "per_size": 4,
                 "op": ["subtract", "g", ["union_all", "S-g"]]},
                {"kind": "pair", "count": 12, "op": ["intersect", "a", "b"]},
                {"kind": "core", "per_size": 3,
                 "op": ["common", "S", {"share": 0.5}]}],
       "sample": {"per_kind": 2, "among_first": 16}}
CELL = "taxa-k31h.lca"


def tagged_config(name="pangenome-k31h") -> dict:
    cfg = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    return {**cfg, **SIZES, "name": "taxa-k31h", "taxonomy": TAXONOMY,
            "genome_taxa": GENOME_TAXA}


@pytest.fixture
def tagged_root(tmp_path):
    """A root whose tagged configuration, mix and cell are added files
    and entries alone."""
    bench = copy_of_harness(tmp_path)
    cfg = tagged_config()
    (tmp_path / "portbench/configs/taxa-k31h.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/lca.json").write_text(json.dumps(MIX))
    bench["configs"].append({"name": "taxa-k31h", "source": "x",
                             "file": "portbench/configs/taxa-k31h.json",
                             "reduced": ["genomes"], "why": "taxids"})
    bench["workloads"].append({"name": CELL, "config": "taxa-k31h",
                               "traffic": "lca", "chips": 1, "why": "lca"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _window_of(count: int):
    """harness.window cut to ``count`` requests whatever the host's
    speed: one request a call of the original with no time left."""
    window = harness.window

    def counted(ev, stream, seconds, keep, device, traced):
        parts = [window(ev, stream, 0, keep, device, traced)
                 for _ in range(count)]
        return ([r for p in parts for r in p[0]],
                {k: v for p in parts for k, v in p[1].items()},
                *(sum(p[i] for p in parts) for i in (2, 3, 4)))
    return counted


def counted_run(monkeypatch, root, workload, seed, sizes=None,
                mix_keys=None, count=None):
    mix = harness.load_cell(root, workload)[3]
    mix = {**mix, **(mix_keys or {})}
    count = count or mix["sample"]["among_first"]
    monkeypatch.setattr(harness, "window", _window_of(count))
    return harness.run_cell(workload, seed, 0, False, root, threads=2,
                            sizes=sizes, mix_keys=mix_keys)


# ------------------------------------------------------------- the tree
@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_nodes_dmp_loads_in_the_ports_loader(tmp_path, seed):
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    cfg = tagged_config()
    taxa = write_taxonomy(cfg, seed, str(tmp_path))
    db = load_taxonomy(str(tmp_path))
    present = np.flatnonzero(db.depth >= 0)
    assert present.size == TAXONOMY["nodes"]
    assert present[0] == 1 and present[-1] <= TAXONOMY["max_taxid"]
    assert int(db.depth.max()) == taxa.max_depth <= TAXONOMY["depth"][1]
    ranks = Counter(db.rank(int(t)) for t in present)
    assert set(RANKS) <= set(ranks) <= set(RANKS) | {"clade", "no rank"}
    strains = [t for t in present if db.rank(int(t)) == "strain"]
    lo, hi = TAXONOMY["depth"]
    assert lo <= db.depth[strains].min() and db.depth[strains].max() <= hi
    # a lineage holds each rank once, top first
    for t in present[:: 97]:
        line, x = [], int(t)
        while x != 1:
            line.append(db.rank(x))
            x = int(db.parent[x])
        line = [r for r in reversed(line) if r in RANKS]
        assert line == RANKS[: len(line)]
    g = [int(t) for t in taxa.genome_taxids]
    assert len(set(g)) == cfg["genomes"]
    assert {db.rank(t) for t in g} == {"strain"}
    # genome j of clade c: a strain of c's species; 2 species a genus, 2
    # genera a family
    per = cfg["genomes"] // cfg["clades"]
    assert db.rank(db.lca(g[0], g[1])) == "species"
    assert db.rank(db.lca(g[0], g[per])) == "genus"
    assert db.rank(db.lca(g[0], g[2 * per])) == "family"
    assert clade_of(cfg, 2 * per) == 2


def test_the_tree_repeats_by_seed_and_draws_its_own_stream(tmp_path):
    cfg = tagged_config()
    a = write_taxonomy(cfg, 5, str(tmp_path / "a"))
    b = write_taxonomy(cfg, 5, str(tmp_path / "b"))
    c = write_taxonomy(cfg, 6, str(tmp_path / "c"))
    assert (tmp_path / "a/nodes.dmp").read_bytes() == \
        (tmp_path / "b/nodes.dmp").read_bytes()
    assert (tmp_path / "a/nodes.dmp").read_bytes() != \
        (tmp_path / "c/nodes.dmp").read_bytes()
    np.testing.assert_array_equal(a.genome_taxids, b.genome_taxids)
    parent, rank, depth, genomes = build_tree(cfg, 5)
    assert parent.size == rank.size == depth.size == TAXONOMY["nodes"]
    assert (depth[parent] == depth - 1)[1:].all()


def test_a_lineage_that_does_not_fit_is_refused():
    cfg = tagged_config()
    cfg["taxonomy"] = {**TAXONOMY, "nodes": 40}
    with pytest.raises(ValueError, match="raise nodes"):
        build_tree(cfg, 1)


# --------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def tree():
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    with tempfile.TemporaryDirectory() as d:
        taxa = write_taxonomy(tagged_config(), 2024, d)
        return (taxa, load_taxonomy(d), Lineages.read(taxa.nodes_dmp, CPU),
                read_nodes(taxa.nodes_dmp))


def brute_lca(parents: dict, a: int, b: int) -> int:
    if a == 0 or b == 0:
        return a or b
    up = [a]
    while up[-1] != 1:
        up.append(parents[up[-1]])
    x = b
    while x not in up:
        x = parents[x]
    return x


def test_reference_lca_matches_the_host_lca_and_a_brute_force(tree):
    """On seeded pairs: the port's host Taxonomy.lca_pairs (a copy of the
    JAX package's, held to it by tests/test_torch_host.py) and a walk of
    the parents in Python."""
    taxa, db, lin, (ids, parents) = tree
    rng = np.random.default_rng(99)
    pool = np.concatenate([ids, taxa.genome_taxids.astype(np.int64), [0]])
    a = rng.choice(pool, 4000)
    b = rng.choice(pool, 4000)
    b[:500] = a[:500]  # equal pairs
    b[500:600] = 0
    got = lin.lca(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, db.lca_pairs(a, b))
    par = dict(zip(ids.tolist(), parents.tolist()))
    for x, y, z in zip(a[:800].tolist(), b[:800].tolist(), got[:800]):
        assert brute_lca(par, x, y) == z
    with pytest.raises(ValueError, match="does not hold"):
        lin.lca(torch.tensor([int(ids.max()) + 1]), torch.tensor([1]))


@pytest.fixture(scope="module")
def small_sets(tree):
    """(codes, taxids, TaxaSets): six sets over a shared pool, genome g
    tagged with genome g's taxid."""
    taxa, db, lin, _ = tree
    rng = np.random.default_rng(3)
    pool = np.unique(rng.integers(0, 1 << 40, 3000)).astype(np.int64)
    codes = [np.sort(pool[rng.random(pool.size) < 0.3 + 0.1 * g])
             for g in range(6)]
    tax = [int(t) for t in taxa.genome_taxids[[0, 1, 2, 4, 5, 7]]]
    sets = [torch.from_numpy(c) for c in codes]  # flipping keeps order here
    ref = TaxaSets(sets, [torch.full((len(c),), t) for c, t in
                          zip(codes, tax)], lin)
    return codes, tax, ref, db


def _by_code(codes, tax, members):
    out = {}
    for c, t in zip(codes, tax):
        for x in c.tolist():
            if x in members:
                out.setdefault(x, []).append(t)
    return out


def _want(db, merged: dict) -> tuple[np.ndarray, np.ndarray]:
    keys = np.array(sorted(merged), np.int64)
    vals = []
    for k in keys.tolist():
        t = 0
        for x in merged[k]:
            t = db.lca(t, x)
        vals.append(t)
    return keys, np.array(vals, np.uint32)


def test_taxid_set_algebra_against_python(small_sets):
    from portbench.reference.encode import SIGN

    codes, tax, ref, db = small_sets

    def got(x):  # ref.codes unflips: the held codes back
        return ref.codes(x).view(np.int64) ^ SIGN, ref.taxids(x)

    S = [0, 2, 3, 5]
    members = set().union(*(set(codes[g].tolist()) for g in S))
    keys, want = _want(db, _by_code([codes[g] for g in S],
                                    [tax[g] for g in S], members))
    k, t = got(ref.union_all(S))
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(t, want)
    # intersect: the LCA of the two sides
    both = set(codes[1].tolist()) & set(codes[4].tolist())
    keys, want = _want(db, _by_code([codes[1], codes[4]], [tax[1], tax[4]],
                                    both))
    k, t = got(ref.intersect(1, 4))
    np.testing.assert_array_equal(k, keys)
    np.testing.assert_array_equal(t, want)
    # subtract of a union: the left side's taxid
    rest = set().union(*(set(codes[g].tolist()) for g in (0, 3)))
    left = sorted(set(codes[2].tolist()) - rest)
    k, t = got(ref.subtract(2, ref.union_all([0, 3])))
    np.testing.assert_array_equal(k, left)
    assert (t == tax[2]).all()
    # common carries no taxids; a one-sided intersect keeps the one side
    core = ref.common(S, 3)
    assert ref.taxids(core) is None
    held = Counter(x for g in S for x in codes[g].tolist())
    np.testing.assert_array_equal(
        got(core)[0], sorted(x for x, n in held.items() if n >= 3))
    k, t = got(ref.intersect(core, 5))
    assert (t == tax[5]).all() and len(k) > 0
    assert ref.taxids(ref.subtract(core, 5)) is None


def test_taxids_wrong_counts_members_both_hold():
    a = np.array([1, 5, 9], np.uint64)
    t = np.array([10, 20, 30], np.uint32)
    assert taxids_wrong(a, t, a, t) == 0
    assert taxids_wrong(a, t, a, np.array([10, 21, 31], np.uint32)) == 2
    # codes that differ: only the members both hold are compared
    b = np.array([1, 6, 9, 12], np.uint64)
    assert taxids_wrong(a, t, b, np.array([10, 0, 31, 4], np.uint32)) == 1
    assert taxids_wrong(a, None, b, None) == 0
    assert taxids_wrong(a, None, b, np.zeros(4, np.uint32)) == 2
    assert taxids_wrong(a, t, b, None) == 2


# ---------------------------------------------------------- whole runs
def test_the_tagged_cell_runs_correct(on_cpu, monkeypatch, tagged_root):
    r = counted_run(monkeypatch, tagged_root, CELL, 2**31 + 5)
    assert list(r["checks"]) == ["genome_sets_wrong", "answers_wrong",
                                 "taxids_wrong", "kinds_unchecked",
                                 "requests_failed"]
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] == MIX["sample"]["among_first"]
    assert set(r["metrics"]) == {"setop_kmers_per_s", "setop_p95_ms",
                                 "setup_s"}


def _first_holder(a, b, *rest):
    """The union's LCA planted to keep the first holder's taxid."""
    return torch.where(a != 0, a, b)


def test_the_first_holders_taxid_reads_taxids_wrong_alone(
        on_cpu, monkeypatch, tagged_root):
    from unikmer_tpu_torch.taxonomy import lca

    monkeypatch.setattr(lca, "lca_pairs_device", _first_holder)
    r = counted_run(monkeypatch, tagged_root, CELL, 2**31 + 5)
    assert r["correct"] is False
    c = {k: v["value"] for k, v in r["checks"].items()}
    assert c["taxids_wrong"] > 0
    assert c["genome_sets_wrong"] == c["answers_wrong"] == 0
    assert c["kinds_unchecked"] == c["requests_failed"] == 0


def test_the_control_is_not_correct_on_a_tagged_configuration(
        tagged_root):
    checks = control_run(CELL, 2**31 + 5, CPU, tagged_root)
    assert "taxids_wrong" in checks
    assert checks["answers_wrong"]["value"] > 0
    assert checks["genome_sets_wrong"]["value"] > 0


# ------------------------------------------- the cells without taxids
MERGE = ["pangenome-k23.merge", "pangenome-k31h.merge"]
PIN_SEED = 2802000001
# computed from the harness before it knew taxids
PINNED = {
    (False, 0): "ebfdf6e5f7427bdf", (False, 1): "0e2b6929014f7cd2",
    (True, 0): "6c1ef7b3a4377939", (True, 1): "d6a0a3b143b092e5",
}
PINNED_KEEP = {False: [0, 5, 7, 8, 10, 12, 13, 18, 22, 25, 30, 45],
               True: [0, 1, 2, 3, 4, 5, 7, 9]}
PINNED_GENOMES = "d92444c01b2345cc"


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("workload", MERGE)
def test_merge_cells_draw_what_they_drew(tmp_path, workload, small):
    _, _, cfg, mix, _ = harness.load_cell(ROOT, workload)
    assert "taxonomy" not in cfg and "genome_taxa" not in cfg
    if small:
        cfg = {**cfg, **SMALL}
        mix = {**mix, **SMALL_MIX["pangenome-k23.merge"]}
    for stream in (0, 1):
        s = RequestStream(mix, cfg, PIN_SEED, stream=stream)
        reqs = [next(s) for _ in range(300)]
        got = hashlib.sha256(json.dumps(
            [[r.ordinal, r.kind, r.size, r.S, r.g, r.a, r.b] for r in reqs]
        ).encode()).hexdigest()[:16]
        assert got == PINNED[(small, stream)]
    assert sorted(sample_ordinals(mix, cfg, PIN_SEED)) == PINNED_KEEP[small]
    if small:
        h = hashlib.sha256()
        for p in write_genomes(cfg, PIN_SEED, str(tmp_path), 2):
            h.update(open(p, "rb").read())
        assert h.hexdigest()[:16] == PINNED_GENOMES


@pytest.mark.parametrize("workload", MERGE)
def test_merge_cells_keep_their_four_checks(on_cpu, monkeypatch, workload):
    mix_keys = SMALL_MIX["pangenome-k23.merge"]
    r = counted_run(monkeypatch, ROOT, workload, 31337, SMALL, mix_keys)
    assert list(r["checks"]) == ["genome_sets_wrong", "answers_wrong",
                                 "kinds_unchecked", "requests_failed"]
    assert r["correct"] is True


def test_the_reference_of_taxids_is_scanned():
    path = ROOT / "portbench" / "reference" / "taxa.py"
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}
