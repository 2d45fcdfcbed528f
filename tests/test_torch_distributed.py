"""Multi-process ingest in the port (unikmer_tpu_torch/pipeline/
distributed.py and the process-group exchange of parallel/sharded.py)
against the JAX package, on the CPU: the partition arithmetic, the
single-process sharded count over 8 CPU shards, real two-rank gloo runs
(this file is the rank process: see the ``__main__`` block at its end)
against the JAX package's single-process 4-shard count, shard by shard,
and ``sharded_union_counts`` / ``sharded_union_taxids`` against the JAX
jitted functions on an 8-device CPU mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from unikmer_tpu.io.fastx import pack_files as jax_pack_files
from unikmer_tpu.models.count import CountConfig as JaxConfig
from unikmer_tpu.models.count import count_packed as jax_count_packed
from unikmer_tpu.parallel import mesh as jax_mesh
from unikmer_tpu.parallel import sharded as jax_sharded
from unikmer_tpu.pipeline import distributed as jax_distributed
from unikmer_tpu_torch.models.count import CountConfig
from unikmer_tpu_torch.parallel import mesh, sharded
from unikmer_tpu_torch.pipeline import distributed

CPU = torch.device("cpu")
RANK_TIMEOUT = 240  # seconds a rank process may take
# the rank runs: W = 2 ranks of L = 2 local shards, the JAX package's
# D = 4 shards of tests/distributed_worker.py
RANKS, LOCAL = 2, 2
TAX_PARENT = [0, 1, 1, 1, 2, 2]  # tests/distributed_worker.py's taxonomy
TAX_DEPTH = [-1, 0, 1, 1, 2, 2]


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


def dna(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes(
    ).decode()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------
# the partition arithmetic


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [0, 1, 5, 10])
def test_partition_files_match_jax(n, hosts):
    files = [f"f{i}" for i in range(n)]
    parts = [distributed.partition_files(files, hosts, h)
             for h in range(hosts)]
    assert parts == [jax_distributed.partition_files(files, hosts, h)
                     for h in range(hosts)]
    assert sorted(sum(parts, [])) == sorted(files)


@pytest.mark.parametrize("k", [1, 11, 31])
@pytest.mark.parametrize("hosts", [1, 3, 4])
@pytest.mark.parametrize("n", [0, 5, 1000, 1001])
def test_partition_bases_match_jax(n, hosts, k):
    bases = np.arange(n, dtype=np.int64).astype(np.uint8)
    owned = 0
    for h in range(hosts):
        got, own = distributed.partition_bases(bases, hosts, h, k)
        want, want_own = jax_distributed.partition_bases(bases, hosts, h, k)
        np.testing.assert_array_equal(got, want)
        assert own == want_own
        owned += own
    assert owned == n


# ---------------------------------------------------------------------
# one process, 8 CPU shards


CFGS = {
    "2-bit -K": dict(k=13, canonical=True),
    "-H": dict(k=31, canonical=True, hashed=True),
    "-W 15": dict(k=31, minimizer_w=15),
}


def jax_shards(paths, cfg: JaxConfig, d: int):
    """The JAX package's single-process sharded count over ``d`` CPU
    devices: each shard's codes.  Its sharded_count_distinct packs every
    configuration with a k-1 halo, which drops minimizers at the rows'
    edges, so a sketch takes its build over rows with shard_halos (as
    its mesh_count_distinct packs them)."""
    m = jax_mesh.make_mesh(d)
    if cfg.minimizer_w > 0:
        front, back = jax_sharded.shard_halos(cfg)
        rows = jax_sharded.pack_host_shards(
            jax_pack_files(paths, cfg.k).bases, d, cfg.k, front, back)
        out, counts, dropped, _ = jax_sharded.build_sharded_distinct(
            m, cfg, 4096)(rows)
    else:
        out, counts, dropped, _ = jax_distributed.sharded_count_distinct(
            paths, cfg, m, capacity=4096)
    assert int(np.asarray(dropped)[0]) == 0
    out, counts = np.asarray(out), np.asarray(counts)
    return [out[i][: int(counts[i])] for i in range(d)]


def port_shards(result) -> list:
    """The codes of sharded_count_distinct's (index, codes, n) shards."""
    return [c[: int(n)].numpy().view(np.uint64) for _, c, n in result]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    rng = np.random.default_rng(20261017)
    p = tmp_path_factory.mktemp("dist") / "g.fa"
    p.write_text(f">g\n{dna(rng, 6000)}\n")
    return str(p)


@pytest.mark.parametrize("cfg", list(CFGS), ids=str)
def test_sharded_count_distinct_matches_jax(genome, cfg):
    """group=None over 8 CPU shards: each shard equals the JAX shard, and
    the concatenation the JAX single-device count."""
    m = mesh.make_mesh(devices=[CPU] * 8)
    got = distributed.sharded_count_distinct(
        [genome], CountConfig(**CFGS[cfg]), m)
    assert [g for g, _, _ in got] == list(range(8))
    assert all(c.device == CPU for _, c, _ in got)
    got = port_shards(got)
    jc = JaxConfig(**CFGS[cfg])
    for g, w in zip(got, jax_shards([genome], jc, 8)):
        np.testing.assert_array_equal(g, w)
    want = jax_count_packed(jax_pack_files([genome], jc.k), jc)
    assert len(want) > 100
    np.testing.assert_array_equal(np.concatenate(got), want)


def test_jax_sharded_count_drops_minimizers_at_row_edges(genome):
    """Why the -W case above takes the JAX build over halo rows: the JAX
    sharded_count_distinct itself loses sketch codes, the port does not."""
    jc = JaxConfig(**CFGS["-W 15"])
    out, counts, _, _ = jax_distributed.sharded_count_distinct(
        [genome], jc, jax_mesh.make_mesh(8), capacity=4096)
    assert int(np.asarray(counts).sum()) < len(
        jax_count_packed(jax_pack_files([genome], jc.k), jc))


# ---------------------------------------------------------------------
# initialize


def test_initialize_is_a_no_op_without_an_address(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed.initialize() is None
    assert not dist.is_initialized()


def test_initialize_nccl_without_cuda_raises():
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="nccl"):
        distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                               backend="nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_initialize_picks_gloo_on_the_cpu(genome, monkeypatch, how):
    """One rank from arguments or from torch's launcher variables: gloo,
    and a count through the process-group exchange equal to the count
    without a group."""
    import torch.distributed as dist

    port = free_port()
    if how == "environment":
        for key, value in (("MASTER_ADDR", "127.0.0.1"),
                           ("MASTER_PORT", str(port)), ("WORLD_SIZE", "1"),
                           ("RANK", "0")):
            monkeypatch.setenv(key, value)
        group = distributed.initialize()
    else:
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        group = distributed.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        assert dist.get_backend(group) == "gloo"
        assert dist.get_world_size(group) == 1
        m = mesh.make_mesh(devices=[CPU] * 3)
        cfg = CountConfig(**CFGS["2-bit -K"])
        got = distributed.sharded_count_distinct([genome], cfg, m,
                                                 group=group)
        want = distributed.sharded_count_distinct([genome], cfg, m)
        assert [g for g, _, _ in got] == [0, 1, 2]
        for g, w in zip(port_shards(got), port_shards(want)):
            np.testing.assert_array_equal(g, w)
        assert int(sharded.all_reduce_sum(torch.tensor(5), group)) == 5
    finally:
        dist.destroy_process_group()


def test_rank_mesh_is_one_shard_on_the_cpu():
    assert mesh.rank_mesh() == (CPU,)


# ---------------------------------------------------------------------
# two ranks over gloo


FILE_CASES = {"two files": 2, "three files": 3, "one file": 1}


def taxid_case():
    """tests/distributed_worker.py's taxid arm: rng-99 bases and taxids
    over its 6-node taxonomy."""
    rng = np.random.default_rng(99)
    tb = rng.integers(0, 4, 3000).astype(np.uint8)
    ptax = rng.integers(1, 6, 3000).astype(np.uint32)
    return tb, ptax


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two rank processes of this file over gloo, each with two CPU
    shards, running every file case, the taxid arm and the unions; their
    RESULT lines by rank, and the files."""
    d = tmp_path_factory.mktemp("ranks")
    rng = np.random.default_rng(20261018)
    paths = []
    for i in range(3):
        p = d / f"g{i}.fa"
        p.write_text(f">g{i}\n{dna(rng, 2500 + 400 * i)}\n")
        paths.append(str(p))
    spec = d / "spec.json"
    spec.write_text(json.dumps({
        "port": free_port(),
        "cases": {name: paths[:n] for name, n in FILE_CASES.items()}}))
    env = dict(os.environ, UNIKMER_TPU_TORCH_DEVICE="cpu")
    env.pop("MASTER_ADDR", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(spec), str(r)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), outs
    results = []
    for o in outs:
        lines = [ln for ln in o.splitlines() if ln.startswith("RESULT ")]
        assert len(lines) == 1, o[-3000:]
        results.append(json.loads(lines[0][len("RESULT "):]))
    return {"results": results, "paths": paths}


def merged_shards(results, key):
    """{global shard index: codes} of every rank's ``key`` shards."""
    shards = {}
    for r in results:
        for g, codes in r[key].items():
            assert int(g) not in shards
            shards[int(g)] = np.array(codes, np.uint64)
    return shards


@pytest.mark.parametrize("case", list(FILE_CASES))
def test_two_ranks_match_jax_shard_by_shard(two_ranks, case):
    """Rank r reads files r, r + 2, ... (none for rank 1 of one file),
    and each of the 4 shards holds the JAX single-process 4-shard
    count's codes of its range."""
    results = two_ranks["results"]
    assert [r["rank"] for r in results] == [0, 1]
    assert [sorted(int(g) for g in r[case]) for r in results] == [[0, 1],
                                                                  [2, 3]]
    got = merged_shards(results, case)
    paths = two_ranks["paths"][:FILE_CASES[case]]
    want = jax_shards(paths, JaxConfig(k=11, canonical=True), 4)
    for g in range(4):
        np.testing.assert_array_equal(got[g], want[g])
    assert sum(len(w) for w in want) > 1000


def test_two_ranks_taxid_arm_matches_jax_lca(two_ranks):
    """build_sharded_taxids across the ranks, each supplying its own two
    of the 4 global rows: the codes and LCA-merged taxids of the JAX
    package's Taxonomy.lca_reduce."""
    from unikmer_tpu.models.count import linear_codes_all
    from unikmer_tpu.taxonomy.taxdump import Taxonomy

    results = two_ranks["results"]
    codes = merged_shards(results, "taxid codes")
    taxids = merged_shards(results, "taxids")
    assert sorted(codes) == sorted(taxids) == [0, 1, 2, 3]
    tax = Taxonomy(parent=np.array(TAX_PARENT, np.uint32),
                   depth=np.array(TAX_DEPTH, np.int16),
                   rank_ids=np.full(6, -1, np.int16), ranks=[])
    tb, ptax = taxid_case()
    c, pos = linear_codes_all(tb, JaxConfig(k=11, canonical=True))
    want_c, want_t = tax.lca_reduce(c, ptax[pos])
    np.testing.assert_array_equal(
        np.concatenate([codes[g] for g in range(4)]), want_c)
    np.testing.assert_array_equal(
        np.concatenate([taxids[g] for g in range(4)]).astype(np.uint32),
        want_t)


def test_two_ranks_union_totals_sum_over_the_ranks(two_ranks):
    """sharded_union_counts with the group: every rank's total is the
    size of the whole union, and the shards hold it in order."""
    results = two_ranks["results"]
    a, b = union_inputs()
    want = np.union1d(a, b)
    assert [r["union total"] for r in results] == [len(want)] * RANKS
    got = merged_shards(results, "union")
    np.testing.assert_array_equal(np.concatenate([got[g] for g in range(4)]),
                                  want)


# ---------------------------------------------------------------------
# sharded_union_counts and sharded_union_taxids against the JAX jitted
# functions on 8 CPU devices


def union_inputs(seed: int = 5):
    """Two overlapping sorted sets of 62-bit codes."""
    rng = np.random.default_rng(seed)
    a = np.unique(rng.integers(0, 1 << 62, 1500, dtype=np.uint64))
    b = np.unique(rng.integers(0, 1 << 62, 1500, dtype=np.uint64))
    b[: len(a) // 3] = a[: len(a) // 3]
    return a, np.unique(b)


def test_sharded_union_counts_match_jax():
    d, cap = 8, 512
    a, b = union_inputs()
    sa = sharded.partition_host_set(a, d, cap, code_bits=62)
    sb = sharded.partition_host_set(b, d, cap, code_bits=62)
    out, n, total = jax_sharded.sharded_union_counts(jax_mesh.make_mesh(d))(
        sa, sb)
    m = mesh.make_mesh(devices=[CPU] * d)
    res, got_total = sharded.sharded_union_counts(
        sharded._upload(m, sa), sharded._upload(m, sb), 62)
    assert int(got_total) == int(np.asarray(total)[0]) == len(np.union1d(a, b))
    out, n = np.asarray(out), np.asarray(n)
    for i, (c, k) in enumerate(res):
        assert int(k) == int(n[i])
        np.testing.assert_array_equal(c[: int(k)].numpy().view(np.uint64),
                                      out[i][: int(n[i])])


@pytest.mark.parametrize("overlap", ["every code", "a third"])
def test_sharded_union_taxids_match_jax(overlap):
    from unikmer_tpu.taxonomy.lca import device_tables as jax_tables
    from unikmer_tpu.taxonomy.taxdump import load_taxonomy as jax_load
    from unikmer_tpu_torch.taxonomy.lca import device_tables
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    d, cap = 8, 512
    a, b = union_inputs(6)
    if overlap == "every code":
        b = a.copy()
    rng = np.random.default_rng(7)
    pool = np.array([511145, 585057, 562, 1, 0], np.uint32)
    ta = rng.choice(pool, len(a)).astype(np.uint32)
    tb = rng.choice(pool, len(b)).astype(np.uint32)
    sa, sta = sharded.partition_host_set(a, d, cap, 62, taxids=ta)
    sb, stb = sharded.partition_host_set(b, d, cap, 62, taxids=tb)
    jparent, jdepth, jmax = jax_tables(jax_load("tests/data/taxdump"))
    c, t, n, total = jax_sharded.sharded_union_taxids(
        jax_mesh.make_mesh(d), int(jmax))(sa, sta, sb, stb, jparent, jdepth)
    parent, depth, max_depth = device_tables(
        load_taxonomy("tests/data/taxdump"), CPU)
    assert max_depth == int(jmax)
    m = mesh.make_mesh(devices=[CPU] * d)
    ids = [sharded._upload(m, t.view(np.int32), np.int32) for t in (sta, stb)]
    res, got_total = sharded.sharded_union_taxids(
        sharded._upload(m, sa), ids[0], sharded._upload(m, sb), ids[1],
        parent, depth, max_depth)
    assert int(got_total) == int(np.asarray(total)[0]) == len(np.union1d(a, b))
    c, t, n = np.asarray(c), np.asarray(t), np.asarray(n)
    for i, (gc, gt, k) in enumerate(res):
        assert int(k) == int(n[i])
        np.testing.assert_array_equal(gc[: int(k)].numpy().view(np.uint64),
                                      c[i][: int(n[i])])
        np.testing.assert_array_equal(gt[: int(k)].numpy().astype(np.uint32),
                                      t[i][: int(n[i])])


# ---------------------------------------------------------------------
# chip_smoke.py's distributed phase, small, on the CPU


def test_chip_smoke_distributed_path_on_the_cpu(tmp_path, monkeypatch):
    """distributed_path over inputs made as the earlier phases make
    theirs: its rank processes (one, then two over gloo) hold every
    shard exactly, every run is timed beside its twin, each rank reports
    its start-up split, and the files it was handed to remove are gone."""
    import chip_smoke
    from unikmer_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(chip_smoke, "TAX_NODES", 3000)
    rng = np.random.default_rng(46)
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "in.fa")
    chip_smoke.write_records_fasta(fa, rng, [20000] * 4)
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", fa, "-o",
                      os.path.join(tmp, "k23")]) == 0
    d = os.path.join(tmp, "taxdump")
    os.mkdir(d)
    leaves, chain = chip_smoke.write_taxonomy(d, rng)
    t1 = os.path.join(tmp, "T1.fa")
    chip_smoke.write_taxid_fasta(t1, rng, chain[-8:], 2000)
    sets = {}
    for name, x in zip("ab", chip_smoke.set_bases(rng, 20000)):
        codes = chip_smoke.numpy_count(x, 23, True, "distinct")
        sets[name] = (codes, rng.choice(leaves, len(codes)).astype(np.uint32))
    inputs = {"fa": fa, "k23": os.path.join(tmp, "k23.unik"), "taxdump": d,
              "t1": t1, **sets}
    got = chip_smoke.distributed_path(tmp, inputs, CPU)
    row = got["row"]
    assert set(got["launches"]) == set(chip_smoke.MESH_KEYS)
    assert sorted(row["runs"]) == [
        "(a) k23, 4 files", "(b) k23, 4 files", "(c) -k 31 -W 15, 1 file",
        "(d) -T T1", "(e) union", "(e) union taxids"]
    for run in row["runs"].values():
        assert run["s"] >= 0 and run["single_s"] >= 0
        assert len(run["shard_codes"]) == 4
    assert row["runs"]["(b) k23, 4 files"]["backend"] == "gloo"
    assert len(row["runs"]["(b) k23, 4 files"]["exchange_s"]) == 2
    assert sum(row["runs"]["(a) k23, 4 files"]["shard_codes"]) == \
        chip_smoke.unik_number(inputs["k23"])
    assert row["runs"]["(e) union"]["total"] == len(
        np.union1d(sets["a"][0], sets["b"][0]))
    assert len(row["start_up_s"]) == 3 and all(
        set(s) == {"interpreter and imports", "cuda context", "kernels load",
                   "init_process_group"} for s in row["start_up_s"].values())
    assert sorted(os.listdir(tmp)) == ["in.fa", "k23.unik", "taxdump"]


# ---------------------------------------------------------------------
# on the card: one NCCL rank


@pytest.mark.cuda
def test_one_nccl_rank_on_the_card_matches_the_cpu(genome, monkeypatch):
    """One rank under NCCL with 2 shards on cuda:0 (K1, K2 and the NCCL
    all_to_all_single) against the CPU's count without a group."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cuda")
    group = distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert dist.get_backend(group) == "nccl"
        cfg = CountConfig(**CFGS["2-bit -K"])
        card = torch.device("cuda", 0)
        got = distributed.sharded_count_distinct(
            [genome], cfg, mesh.make_mesh(devices=[card] * 2), group=group)
        want = distributed.sharded_count_distinct(
            [genome], cfg, mesh.make_mesh(devices=[CPU] * 2))
        for (_, c, n), w in zip(got, port_shards(want)):
            assert c.device == card
            np.testing.assert_array_equal(
                c[: int(n)].cpu().numpy().view(np.uint64), w)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------
# the rank process


def rank_main(spec_path: str, rank: int) -> None:
    """One rank of the two_ranks fixture: initialize over gloo, then each
    file case's sharded_count_distinct, the taxid arm and a union, all
    with two CPU shards; prints one RESULT line."""
    from unikmer_tpu_torch.parallel.sharded import (
        build_sharded_taxids, pack_host_rows, pack_host_shards,
        partition_host_set,
    )
    from unikmer_tpu_torch.taxonomy.lca import (
        compact_ids, device_lca_plan, upload_plan,
    )
    from unikmer_tpu_torch.taxonomy.taxdump import Taxonomy

    with open(spec_path) as f:
        spec = json.load(f)
    group = distributed.initialize(f"127.0.0.1:{spec['port']}", RANKS, rank)
    m = mesh.make_mesh(devices=[CPU] * LOCAL)
    out = {"rank": rank}
    cfg = CountConfig(k=11, canonical=True)
    for name, paths in spec["cases"].items():
        res = distributed.sharded_count_distinct(paths, cfg, m, group=group)
        out[name] = {g: [int(x) for x in c[: int(n)].numpy().view(np.uint64)]
                     for g, c, n in res}

    # the taxid arm: every rank makes the same global rows and plan, then
    # supplies its own two rows
    tax = Taxonomy.from_numpy(TAX_PARENT, TAX_DEPTH, np.full(6, -1), [])
    tb, ptax = taxid_case()
    plan = device_lca_plan(tax, np.arange(6, dtype=np.uint32))
    ids = compact_ids(plan[1], ptax).astype(np.int32)
    d = RANKS * LOCAL
    rows = pack_host_shards(tb, d, cfg.k)
    trows = pack_host_rows(ids, d, 0, cfg.k - 1, np.int32(0))
    mine = slice(rank * LOCAL, (rank + 1) * LOCAL)
    (res,) = build_sharded_taxids(rows[mine], trows[mine], cfg, m,
                                  {CPU: upload_plan(plan, CPU)}, group)
    first = rank * LOCAL
    out["taxid codes"] = {first + i: [int(x) for x in
                                      c[: int(n)].numpy().view(np.uint64)]
                          for i, (c, _, n) in enumerate(res)}
    out["taxids"] = {first + i: [int(x) for x in plan[1][t[: int(n)].numpy()]]
                     for i, (_, t, n) in enumerate(res)}

    # a union whose total sums over the ranks
    a, b = union_inputs()
    sa = partition_host_set(a, d, 512, code_bits=62)[mine]
    sb = partition_host_set(b, d, 512, code_bits=62)[mine]
    res, total = sharded.sharded_union_counts(
        sharded._upload(m, sa), sharded._upload(m, sb), 62, group)
    out["union total"] = int(total)
    out["union"] = {first + i: [int(x) for x in
                                c[: int(n)].numpy().view(np.uint64)]
                    for i, (c, n) in enumerate(res)}
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rank_main(sys.argv[1], int(sys.argv[2]))
