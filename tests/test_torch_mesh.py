"""``--mesh`` in the port (unikmer_tpu_torch/parallel/) against the JAX
package, on the CPU: the host helpers of parallel/sharded.py against
their JAX twins, the sharded build against the port's single-device
count, and the CLI's ``count`` and set commands with ``--mesh`` against
the JAX CLI, byte for byte.  Most cases compare with the JAX CLI without
--mesh, which tests/test_cli_mesh.py holds equal to its --mesh output; a
few compare with the JAX --mesh output itself, to keep its shard_map
compiles few.  The port's mesh is D shards on the CPU device
(``make_mesh(devices=[cpu] * D)``, or ``device_count`` patched to 8, as
tests/conftest.py gives JAX 8 CPU devices), its kernels' plain
versions."""

import os

import numpy as np
import pytest
import torch

from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.models.count import CountConfig as JaxConfig
from unikmer_tpu.parallel import mesh as jax_mesh
from unikmer_tpu.parallel import sharded as jax_sharded
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io.fastx import pack_records
from unikmer_tpu_torch.models.count import (
    CountConfig, count_packed, count_stream_packed,
)
from unikmer_tpu_torch.ops import device_sets
from unikmer_tpu_torch.parallel import mesh, sharded

TAXDUMP = ["--data-dir", "tests/data/taxdump"]
CPU = torch.device("cpu")
RE = ["-T", "-r", r"taxid\|(\d+)"]


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


@pytest.fixture(autouse=True)
def cpu8(monkeypatch):
    """The port on the CPU with 8 devices to make meshes of."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(mesh, "device_count", lambda: 8)


def dna(rng, n: int) -> str:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes(
    ).decode()


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """Three FASTA files of three records, sharing a first record (as
    tests/test_cli_mesh.py makes them), and the same with taxids."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(20261020)
    shared = dna(rng, 1500)
    paths = []
    tagged = d / "tagged.fa"
    with open(tagged, "w") as t:
        for i, taxid in enumerate((511145, 585057, 562)):
            seqs = [shared] + [dna(rng, n) for n in (2000 + 311 * i, 900)]
            p = d / f"g{i}.fa"
            p.write_text("".join(f">s{j}\n{s}\n" for j, s in enumerate(seqs)))
            t.write("".join(f">s{j} taxid|{taxid}\n{s}\n"
                            for j, s in enumerate(seqs)))
            paths.append(str(p))
    return {"g": paths, "tagged": str(tagged), "dir": d}


def same_cli(tmp_path, caplog, port_argv, jax_argv=None):
    """(exit code, error lines, .unik bytes or None) of each CLI, which
    must be equal; ``jax_argv`` defaults to the port's arguments."""
    got = {}
    for name, main, argv, logger in (
            ("jax", jax_main, jax_argv or port_argv, "unikmer_tpu"),
            ("port", port_main, port_argv, "unikmer_tpu_torch")):
        out = tmp_path / f"{name}.unik"
        caplog.clear()
        rc = main([*argv, "-C", "-o", str(tmp_path / name)])
        errors = [r.getMessage() for r in caplog.records
                  if r.name == logger and r.levelname == "ERROR"]
        got[name] = (rc, errors, out.read_bytes() if out.exists() else None)
        if out.exists():
            out.unlink()
    assert got["port"] == got["jax"]
    return got["port"]


def without_mesh(argv):
    i = argv.index("--mesh")
    return argv[:i] + argv[i + 2:]


# ---------------------------------------------------------------------
# the mesh and the host helpers against their JAX twins


def test_make_mesh_counts_the_devices(monkeypatch):
    assert mesh.make_mesh() == (CPU,) * 8
    assert len(mesh.make_mesh(3)) == 3
    devs = [torch.device("cpu")] * 5
    assert mesh.make_mesh(devices=devs) == tuple(devs)
    with pytest.raises(ValueError) as port_err:
        mesh.make_mesh(16)
    with pytest.raises(ValueError) as jax_err:
        jax_mesh.make_mesh(16)
    assert str(port_err.value) == str(jax_err.value)
    assert mesh.as_mesh(mesh.make_mesh(2)) == (CPU, CPU)
    monkeypatch.undo()
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    assert mesh.device_count() == 1


CFGS = {
    "2-bit -K": dict(k=21, canonical=True),
    "2-bit k32": dict(k=32),
    "-H": dict(k=31, canonical=True, hashed=True),
    "-D 3": dict(k=21, canonical=True, scale=3),
    "-W 5": dict(k=21, minimizer_w=5),
    "-S 8": dict(k=21, syncmer_s=8),
}


@pytest.mark.parametrize("d", [1, 3, 4, 8])
@pytest.mark.parametrize("cfg", list(CFGS), ids=str)
def test_partition_and_halos_match_jax(cfg, d):
    jc, pc = JaxConfig(**CFGS[cfg]), CountConfig(**CFGS[cfg])
    bits = 64 if jc.hashed else 2 * jc.k
    assert pc.code_bits == bits
    want = jax_sharded.partition_boundaries(d, jc, bits)
    got = sharded.partition_boundaries(d, pc, bits)
    assert got.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert sharded.shard_halos(pc) == jax_sharded.shard_halos(jc)


@pytest.mark.parametrize("n,d,front,back", [
    (1000, 4, 0, 20), (1001, 3, 1, 24), (5, 8, 1, 4), (64, 1, 0, 0),
    (0, 2, 0, 3)])
def test_pack_host_rows_match_jax(n, d, front, back):
    rng = np.random.default_rng(n + d)
    bases = rng.integers(0, 4, n).astype(np.uint8)
    ids = rng.integers(0, 50, n).astype(np.int32)
    np.testing.assert_array_equal(
        sharded.pack_host_shards(bases, d, 21, front, back),
        jax_sharded.pack_host_shards(bases, d, 21, front, back))
    np.testing.assert_array_equal(
        sharded.pack_host_shards(bases, d, 21),
        jax_sharded.pack_host_shards(bases, d, 21))
    got = sharded.pack_host_rows(ids, d, front, back, np.int32(0))
    np.testing.assert_array_equal(
        got, jax_sharded.pack_host_rows(ids, d, front, back, np.int32(0)))
    assert got.dtype == np.int32


@pytest.mark.parametrize("d,bits", [(1, 64), (3, 46), (4, 42), (8, 64)])
def test_partition_host_set_and_collect_match_jax(d, bits):
    rng = np.random.default_rng(d)
    codes = np.unique(rng.integers(0, 1 << bits, 3000, dtype=np.uint64)
                      if bits < 64 else rng.integers(
                          0, 1 << 64, 3000, dtype=np.uint64))
    taxids = rng.integers(1, 1000, len(codes)).astype(np.uint32)
    cap = 3000
    for kw in ({}, {"taxids": taxids}):
        got = sharded.partition_host_set(codes, d, cap, bits, **kw)
        want = jax_sharded.partition_host_set(codes, d, cap, bits, **kw)
        for g, w in zip(*((got, want) if kw else ((got,), (want,)))):
            np.testing.assert_array_equal(g, w)
    rows, trows = want
    counts = (rows != sharded.SENT).sum(1)
    np.testing.assert_array_equal(sharded._collect_sharded(rows, counts),
                                  jax_sharded._collect_sharded(rows, counts))
    np.testing.assert_array_equal(sharded._collect_sharded(rows, counts),
                                  codes)
    for g, w in zip(sharded._collect_sharded_taxids(rows, trows, counts),
                    jax_sharded._collect_sharded_taxids(rows, trows,
                                                        counts)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    tensors = [torch.from_numpy(r.view(np.int64)) for r in rows]
    np.testing.assert_array_equal(sharded._collect_sharded(tensors, counts),
                                  codes)
    small = int(counts.max()) - 1
    with pytest.raises(ValueError) as port_err:
        sharded.partition_host_set(codes, d, small, bits)
    with pytest.raises(ValueError) as jax_err:
        jax_sharded.partition_host_set(codes, d, small, bits)
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------
# the sharded build against the port's single-device count

BUILD_CFGS = {
    **CFGS,
    "-u": dict(k=21, canonical=True, mode="unique"),
    "-d": dict(k=21, canonical=True, mode="repeated"),
    "-W 5 -D 3": dict(k=21, minimizer_w=5, scale=3),
    "-S 8 -d": dict(k=21, syncmer_s=8, mode="repeated"),
}


@pytest.fixture(scope="module")
def packed(genomes):
    """The three genome files packed, with a record holding a poly-T run
    (its k = 32 code is the all-ones sentinel) and one repeating itself."""
    from unikmer_tpu_torch.io.fastx import read_fastx

    recs = [r for g in genomes["g"] for r in read_fastx(g)]
    rng = np.random.default_rng(7)
    body = dna(rng, 700).encode()

    class Rec:
        def __init__(self, seq):
            self.seq, self.name, self.id = seq, b"x", b"x"

    recs.append(Rec(body + b"T" * 40 + body[:300] + b"N" * 5 + body))
    return recs


@pytest.mark.parametrize("shards", [4, 3])
@pytest.mark.parametrize("cfg", list(BUILD_CFGS), ids=str)
def test_mesh_count_matches_single_device(packed, cfg, shards):
    """mesh_count_distinct over the whole packed input equals one
    single-device piece, and mesh_count_stream_packed in pieces of 2,000
    bases the single-device stream in the same pieces."""
    c = CountConfig(**BUILD_CFGS[cfg])
    p = pack_records(packed, c.k)
    m = mesh.make_mesh(devices=[CPU] * shards)
    want = count_packed(p, c, CPU)
    got = sharded.mesh_count_distinct(p.bases, c, m)
    assert got.dtype == np.uint64 and len(got) > 100
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sharded.mesh_count_stream_packed([p], c, m, chunk_bases=2000),
        count_stream_packed([p], c, chunk_bases=2000, device=CPU))
    if cfg == "2-bit k32":
        assert got[-1] == sharded.SENT


def test_exchange_copies_what_it_sends():
    """Every shard on one device: what a shard receives is a new tensor,
    never a view of a sender's buffer."""
    m = mesh.make_mesh(devices=[CPU] * 3)
    parts = [(torch.arange(i * 10, i * 10 + 9),) for i in range(3)]
    edges = [[0, 3, 6, 9]] * 3
    recv = sharded._exchange(parts, edges, m)
    assert [r[0].tolist() for r in recv] == [
        [0, 1, 2, 10, 11, 12, 20, 21, 22], [3, 4, 5, 13, 14, 15, 23, 24, 25],
        [6, 7, 8, 16, 17, 18, 26, 27, 28]]
    recv[0][0].fill_(-1)
    assert parts[0][0][0] == 0


# ---------------------------------------------------------------------
# the CLI's count --mesh against the JAX CLI

COUNT_FLAGS = [[], ["-H"], ["-d"], ["-u"], ["-H", "-D", "3"], ["-W", "5"],
               ["-S", "8"], ["-W", "5", "-d"], ["-W", "5", "-u"],
               ["-W", "5", "-D", "3"], ["-S", "8", "-d"]]
# compared with the JAX --mesh 4 output itself; the rest with the JAX CLI
# without --mesh
JAX_MESH = ([], ["-W", "5"], ["-S", "8", "-d"])


@pytest.mark.parametrize("extra", COUNT_FLAGS, ids=" ".join)
def test_count_mesh_matches_jax_cli(genomes, tmp_path, caplog, extra):
    argv = ["count", "-k", "21", "-K", "-s", *genomes["g"], "--mesh", "4",
            *extra]
    _, _, body = same_cli(tmp_path, caplog, argv, argv if extra in JAX_MESH
                          else without_mesh(argv))
    assert len(body) > 400


@pytest.mark.parametrize("argv", [
    ["-k", "21", "-K", "-s", "-W", "7", "{g}"],
    ["-k", "21", "-K", "-s", "-S", "11", "{g}"],
    ["-k", "19", "-K", "-s", "{g}", "--circular"],
    ["-k", "21", "-K", "-s", "-B", "s1", "{g}"],  # records: not packed
], ids=" ".join)
def test_count_mesh_multirecord_matches_jax_cli(genomes, tmp_path, caplog,
                                                argv):
    """Sketches whose records land mid-shard and at shard edges, the
    circular pack, and the record stream of -B."""
    i = argv.index("{g}")
    argv = ["count", *argv[:i], *genomes["g"], *argv[i + 1:], "--mesh", "4"]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))


def test_count_mesh_spill_matches_jax_cli(genomes, tmp_path, caplog,
                                          monkeypatch):
    """UNIKMER_TPU_COUNT_MEM_MB small: the mesh stream spills to extsort
    chunks and writes the JAX --mesh stream's bytes."""
    from unikmer_tpu_torch.models import count as port_count

    results = []
    real = port_count._PartialSink.result

    def spy(self):
        results.append(real(self))
        return results[-1]

    monkeypatch.setattr(port_count._PartialSink, "result", spy)
    monkeypatch.setenv("UNIKMER_TPU_COUNT_MEM_MB", "0.02")
    argv = ["count", "-k", "21", "-K", "-s", *genomes["g"], "--mesh", "4"]
    same_cli(tmp_path, caplog, argv)  # a spilled header has no count
    assert isinstance(results[0], port_count.SpilledCount)


@pytest.mark.parametrize("vocab_cap", [None, "0"])
@pytest.mark.parametrize("extra", [[], ["-u"], ["-d"], ["-W", "5"]],
                         ids=" ".join)
def test_count_taxids_mesh_matches_jax_cli(genomes, tmp_path, caplog,
                                           monkeypatch, vocab_cap, extra):
    """count -T --mesh 4 on both LCA tiers (vocab_cap 0: the paths tier)."""
    if vocab_cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", vocab_cap)
    calls = []
    real = sharded.mesh_count_taxids

    def spy(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    # count imports it at the call: the spy sits in its module
    monkeypatch.setattr(sharded, "mesh_count_taxids", spy)
    argv = ["count", "-k", "19", "-K", "-s", *RE, *TAXDUMP,
            genomes["tagged"], "--mesh", "4", *extra]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))
    assert len(calls) == 1 and calls[0] is not None


def test_count_taxids_mesh_in_pieces_matches_jax_cli(genomes, tmp_path,
                                                     caplog, monkeypatch):
    """Past a piece (2,000 bases here) -T --mesh streams its pieces and
    merges them as the single-device -T does."""
    from unikmer_tpu_torch.parallel import sharded as port_sharded

    monkeypatch.setattr(port_sharded, "_stream_chunk_bases", lambda dev: 2000)
    for extra in ([], ["-u"]):
        argv = ["count", "-k", "19", "-K", "-s", *RE, *TAXDUMP,
                genomes["tagged"], "--mesh", "3", *extra]
        same_cli(tmp_path, caplog, argv, without_mesh(argv))


def test_count_taxids_mesh_declines_unknown_taxids(genomes, tmp_path, caplog):
    """A taxid the taxonomy lacks: the sharded build declines (None) and
    the single-device -T writes the JAX CLI's bytes."""
    import re

    from unikmer_tpu_torch.io.fastx import parse_taxid_records, read_fastx
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    fa = tmp_path / "unknown.fa"
    fa.write_text(open(genomes["tagged"]).read().replace(
        "taxid|562", "taxid|999999"))
    cfg = CountConfig(k=19, canonical=True)
    packed, taxids = parse_taxid_records(read_fastx(str(fa)), cfg.k,
                                         cfg.circular, cfg.record_gap,
                                         re.compile(RE[2].encode()))
    assert sharded.mesh_count_taxids(packed, taxids,
                                     load_taxonomy("tests/data/taxdump"),
                                     cfg, 2) is None
    argv = ["count", "-k", "19", "-K", "-s", *RE, *TAXDUMP, str(fa),
            "--mesh", "4"]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))


def test_mesh_sentinel_code_matches_jax_cli(tmp_path, caplog):
    """k = 32 without -K: 32 T's encode to 2^64-1, the padding sentinel;
    the mesh keeps it, in count and in union, as the JAX --mesh does."""
    rng = np.random.default_rng(3)
    fa = tmp_path / "polyt.fa"
    fa.write_text(f">s\n{dna(rng, 500)}{'T' * 40}{dna(rng, 200)}\n")
    argv = ["count", "-k", "32", "-s", str(fa), "--mesh", "4"]
    _, _, body = same_cli(tmp_path, caplog, argv)
    for name, main in (("jax", jax_main), ("port", port_main)):
        assert main(["count", "-k", "32", "-s", "-C", str(fa), "-o",
                     str(tmp_path / f"{name}1")]) == 0
    a, b = str(tmp_path / "jax1.unik"), str(tmp_path / "port1.unik")
    for op in (["union", "-s"], ["inter"], ["diff", "-s"]):
        same_cli(tmp_path, caplog, [*op, a, b, "--mesh", "4"],
                 [*op, a, b])


def test_mesh_one_matches_jax_cli(genomes, tmp_path, caplog):
    """--mesh 1: the sharded path over one shard."""
    argv = ["count", "-k", "21", "-K", "-s", genomes["g"][0], "--mesh", "1"]
    same_cli(tmp_path, caplog, argv)
    for name in ("a", "b"):
        assert port_main(["count", "-k", "21", "-K", "-s", "-C",
                          genomes["g"]["ab".index(name)], "-o",
                          str(tmp_path / name)]) == 0
    same_cli(tmp_path, caplog, ["union", "-s", str(tmp_path / "a.unik"),
                                str(tmp_path / "b.unik"), "--mesh", "1"])


@pytest.mark.parametrize("argv", [
    ["count", "-k", "21", "-K", "{g0}", "--mesh", "16"],
    ["count", "-k", "21", "-K", *RE, *TAXDUMP, "{t}", "--mesh", "16"],
    ["union", "{u0}", "{u1}", "--mesh", "16"],
    ["inter", *TAXDUMP, "{t0}", "{t1}", "--mesh", "9"],
], ids=" ".join)
def test_mesh_past_the_devices_dies_as_the_jax_cli(genomes, uniks, tmp_path,
                                                   caplog, argv):
    """More shards than the 8 devices: the JAX CLI's message and exit
    code, and no output."""
    names = {"{g0}": genomes["g"][0], "{t}": genomes["tagged"], **uniks}
    rc, errors, body = same_cli(tmp_path, caplog,
                                [names.get(a, a) for a in argv])
    assert rc == 255 and body is None
    assert errors == [f"--mesh {argv[-1]} needs {argv[-1]} devices, found 8"]


# ---------------------------------------------------------------------
# the set commands with --mesh against the JAX CLI


@pytest.fixture(scope="module")
def uniks(genomes):
    """.unik files of the genomes by the port's count: u0-u2 without
    taxids (k = 19), t0-t2 with global taxids, x2 with a taxid the
    taxonomy lacks, r0 with per-record taxids."""
    d = genomes["dir"]
    mp = pytest.MonkeyPatch()
    mp.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    out = {}
    try:
        for i, g in enumerate(genomes["g"]):
            for name, flags in ((f"u{i}", []),
                                (f"t{i}", ["-t", str((511145, 585057,
                                                      562)[i])])):
                assert port_main(["count", "-k", "19", "-K", "-s", *flags, g,
                                  "-o", str(d / name)]) == 0
                out["{" + name + "}"] = str(d / f"{name}.unik")
        assert port_main(["count", "-k", "19", "-K", "-s", "-t", "999999",
                          genomes["g"][2], "-o", str(d / "x2")]) == 0
        assert port_main(["count", "-k", "19", "-K", "-s", *RE, *TAXDUMP,
                          genomes["tagged"], "-o", str(d / "r0")]) == 0
        assert port_main(["count", "-k", "19", "-K", genomes["g"][1],
                          "-o", str(d / "n1")]) == 0  # unsorted
    finally:
        mp.undo()
    out.update({"{x2}": str(d / "x2.unik"), "{r0}": str(d / "r0.unik"),
                "{n1}": str(d / "n1.unik")})
    return out


SET_CASES = [
    ["union", "-s", "{u0}", "{u1}", "{u2}"],
    ["inter", "{u0}", "{u1}", "{u2}"],
    ["diff", "-s", "{u0}", "{u1}", "{u2}"],
    ["diff", "{u0}"],
    ["common", "-n", "2", "{u0}", "{u1}", "{u2}"],
    ["common", "-n", "2", "{u0}", "{n1}", "{u2}"],  # an unsorted input
    ["union", "-s", "{t0}", "{t1}", "{t2}"],
    ["inter", "{t0}", "{t1}", "{t2}"],
    ["diff", "-s", "{t0}", "{t1}", "{t2}"],
    ["diff", "-s", "{t0}", "{u1}"],  # the others' taxids are zeros
    ["diff", "-s", "-t", "{t0}", "{t1}"],  # --compare-taxid: no mesh
    ["common", "-n", "2", "{t0}", "{t1}", "{t2}"],
    ["union", "-s", "{r0}", "{t1}"],
    ["inter", "-m", "{t1}", "{u0}"],  # --mix-taxid
    ["union", "-s", "{t0}", "{x2}"],  # an unknown taxid: no mesh
]
# compared with the JAX --mesh 4 output itself
SET_JAX_MESH = ([0, 3], [7, 11])


@pytest.mark.parametrize("vocab_cap", [None, "0"])
@pytest.mark.parametrize("case", range(len(SET_CASES)),
                         ids=[" ".join(c) for c in SET_CASES])
def test_set_ops_mesh_match_jax_cli(uniks, tmp_path, caplog, monkeypatch,
                                    vocab_cap, case):
    """Each set command with --mesh 4, with and without taxids, on both
    LCA tiers (vocab_cap 0: the paths tier)."""
    if vocab_cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", vocab_cap)
    argv = [uniks.get(a, a) for a in SET_CASES[case]] + [*TAXDUMP, "--mesh",
                                                         "4"]
    jax_argv = (argv if case in SET_JAX_MESH[vocab_cap is not None]
                else without_mesh(argv))
    rc, _, body = same_cli(tmp_path, caplog, argv, jax_argv)
    assert rc == 0 and len(body) > 40


@pytest.mark.parametrize("taxids", [False, True])
@pytest.mark.parametrize("op", ["union", "inter", "diff", "common"])
def test_set_ops_mesh_past_the_budget_take_the_route_without_mesh(
        uniks, tmp_path, caplog, monkeypatch, op, taxids):
    """With the devices' free bytes made small, the mesh routes decline
    (None) and the route without --mesh writes the JAX CLI's bytes."""
    seen = []
    name = "mesh_set_op_taxids" if taxids else "mesh_set_op"
    real = getattr(sharded, name)

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(sharded, name, spy)
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 12)
    files = [uniks["{t%d}" % i if taxids else "{u%d}" % i] for i in range(3)]
    flags = {"union": ["-s"], "diff": ["-s"], "common": ["-n", "2"]}
    argv = [op, *flags.get(op, []), *files, *TAXDUMP, "--mesh", "4"]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))
    assert seen == [None]


@pytest.mark.parametrize("op,want", [("union", np.union1d),
                                     ("inter", np.intersect1d),
                                     ("diff", np.setdiff1d)])
def test_sharded_set_op_matches_numpy(op, want):
    """sharded_set_op over two range-partitioned sets, 4 shards."""
    rng = np.random.default_rng(11)
    a, b = (np.unique(rng.integers(0, 1 << 40, 5000, dtype=np.uint64))
            for _ in range(2))
    b = np.union1d(b, a[::3])
    m = mesh.make_mesh(devices=[CPU] * 4)
    parts = [sharded._upload(m, sharded.partition_host_set(x, 4, 5000, 40))
             for x in (a, b)]
    res = sharded.sharded_set_op(op, *parts, code_bits=40)
    np.testing.assert_array_equal(
        sharded._collect_sharded([c for c, _ in res], [n for _, n in res]),
        want(a, b))
    with pytest.raises(ValueError, match="unknown sharded set op"):
        sharded.sharded_set_op("xor", *parts)


@pytest.mark.parametrize("op", ["union", "inter", "diff", "common"])
def test_mesh_set_op_admits_the_shards_of_each_device(uniks, monkeypatch,
                                                      op):
    """The budget counts every shard a device holds: 4 shards on one
    device need 4 times the slots of one, and decline where one shard
    alone would fit."""
    from unikmer_tpu_torch.io import unik

    codes = [unik.UnikReader(uniks["{u%d}" % i]).read_all()[0]
             for i in range(3)]
    want = sharded.mesh_set_op(op, codes, 4, 38, threshold=2)
    arrs = [sharded._distinct(c) for c in codes]
    _, cap = sharded._partition(arrs, 4, 38)
    per = device_sets.SLOT_BYTES["common"]
    for free, fits in ((4 * 3 * cap * per * 2, True),
                       (3 * cap * per * 2, False)):
        monkeypatch.setattr(device_sets, "_device_free_bytes",
                            lambda device, free=free: free)
        got = sharded.mesh_set_op(op, codes, 4, 38, threshold=2)
        assert (got is not None) == fits
        if fits:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# KmerSet.from_fasta(mesh=...)


@pytest.mark.parametrize("mode", ["distinct", "unique"])
def test_from_fasta_mesh_matches_jax(genomes, mode):
    from unikmer_tpu.api import KmerSet as JK
    from unikmer_tpu_torch.api import KmerSet as PK

    kw = dict(canonical=True, mode=mode)
    j = JK.from_fasta(genomes["g"], 21, mesh=2, **kw)
    p = PK.from_fasta(genomes["g"], 21, mesh=2, device="cpu", **kw)
    np.testing.assert_array_equal(p.to_numpy(), np.asarray(j.to_numpy()))
    assert (len(p), p.capacity, repr(p)) == (len(j), j.capacity, repr(j))
    with pytest.raises(ValueError, match="only 8 available"):
        PK.from_fasta(genomes["g"], 21, mesh=9, device="cpu")


# ---------------------------------------------------------------------
# --mesh on the commands that read .unik files: as the JAX CLI, which
# reads opt.mesh only in count and the set commands


@pytest.mark.parametrize("argv", [
    ["view", "{t0}"], ["info", "{u0}", "{t1}"], ["sort", "-C", "-u", "{n1}"],
    ["head", "-C", "-n", "7", "{t2}"]], ids=" ".join)
def test_unik_commands_take_mesh_as_the_jax_cli(uniks, tmp_path, capsysbinary,
                                                caplog, argv):
    got = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / f"{name}.out"
        rc = main([uniks.get(a, a) for a in argv] + ["--mesh", "2", "-o",
                                                    str(out)])
        body = out.read_bytes() if out.exists() else b""
        if argv[0] in ("sort", "head"):
            out = tmp_path / f"{name}.out.unik"
            body = out.read_bytes()
        got[name] = (rc, body, capsysbinary.readouterr().out)
    assert got["port"] == got["jax"] and got["port"][0] == 0
    assert len(got["port"][1]) > 40


# ---------------------------------------------------------------------
# chip_smoke.py's mesh phase, small, on the CPU


def test_chip_smoke_mesh_path_on_the_cpu(tmp_path, monkeypatch):
    """mesh_path over inputs made as the earlier phases make theirs: every
    run equals its single-device twin, every run is timed, and the files
    it was handed to remove are gone."""
    import chip_smoke
    from unikmer_tpu_torch.taxonomy import taxdump

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: 0)
    monkeypatch.setattr(chip_smoke, "TAX_NODES", 3000)
    rng = np.random.default_rng(45)
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "in.fa")
    chip_smoke.write_records_fasta(fa, rng, [30000] * 4)
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", fa, "-o",
                      os.path.join(tmp, "k23")]) == 0
    d = os.path.join(tmp, "taxdump")
    os.mkdir(d)
    leaves, chain = chip_smoke.write_taxonomy(d, rng)
    taxdb = taxdump.load_taxonomy(d)
    taxid = []
    for name, ids in (("T1", chain[-8:]), ("T2", rng.choice(leaves, 6))):
        path = os.path.join(tmp, name + ".fa")
        chip_smoke.write_taxid_fasta(path, rng, ids, 2000)
        taxid.append((name, path, "table"))
    bases = chip_smoke.set_bases(rng, 20000)
    gtax = [int(t) for t in rng.choice(leaves, 3, replace=False)]
    uniks = []
    for name, x, t in zip("ABC", bases, gtax):
        path = os.path.join(tmp, f"set{name}.fa")
        chip_smoke.write_one_record(path, name, x)
        uniks.append(os.path.join(tmp, f"cli{name}.unik"))
        assert port_main(["count", "-k", "23", "-K", "-s", "-C", "-t", str(t),
                          path, "-o", uniks[-1][:-5]]) == 0
        os.remove(path)
    merged = chip_smoke.merge_sets([chip_smoke.numpy_count(x, 23, True,
                                                           "distinct")
                                    for x in bases])
    oracle = chip_smoke.cli_setop_oracles(merged, gtax, taxdb)
    written = {}
    from unikmer_tpu_torch.io import unik

    for key, (codes, taxids) in oracle.items():
        written[key] = os.path.join(tmp, f"cli_{key}.oracle.unik")
        chip_smoke.write_oracle(written[key], 23, unik.SORTED
                                | unik.CANONICAL | unik.INCLUDE_TAXID,
                                codes, taxids)
    inputs = {"fa": fa, "k23": os.path.join(tmp, "k23.unik"), "taxdump": d,
              "taxid": taxid, "uniks": uniks, "oracle": oracle,
              "written": written, "cli_s": {"inter": 1.5}}
    got = chip_smoke.mesh_path(tmp, inputs, CPU, shards=3)
    runs = got["row"]["runs"]
    assert len(runs) == 23 and set(got["launches"]) == set(
        chip_smoke.MESH_KEYS)
    assert runs["inter taxids (paths tier, 3 shards)"]["single_s"] == 1.5
    assert runs["stream k23"]["codes"] == runs["count --mesh 1"]["codes"]
    assert all(row["s"] >= 0 and "peak_bytes" in row for row in runs.values())
    assert sorted(os.listdir(tmp)) == sorted(
        ["in.fa", "k23.unik", "taxdump", "cliA.unik", "cliB.unik",
         "cliC.unik"])


# ---------------------------------------------------------------------
# on the card: 1 and 4 shards on cuda:0 against the CPU

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["2-bit -K", "2-bit k32", "-d", "-H",
                                 "-D 3", "-W 5", "-S 8 -d"], ids=str)
def test_mesh_count_on_the_card_matches_the_cpu(packed, cfg):
    """The sharded build launching K1/H1/S1 and K2 on the card, shards
    sharing cuda:0, against the CPU's single-device count."""
    card = _card()
    c = CountConfig(**BUILD_CFGS[cfg])
    p = pack_records(packed, c.k)
    want = count_packed(p, c, CPU)
    for d in (1, 4):
        m = mesh.make_mesh(devices=[card] * d)
        np.testing.assert_array_equal(
            sharded.mesh_count_distinct(p.bases, c, m), want)
        np.testing.assert_array_equal(
            sharded.mesh_count_stream_packed([p], c, m, chunk_bases=2000),
            count_stream_packed([p], c, chunk_bases=2000, device=CPU))


@pytest.mark.cuda
@pytest.mark.parametrize("vocab_cap", [None, "0"])
def test_mesh_taxids_and_set_ops_on_the_card_match_the_cpu(
        genomes, uniks, monkeypatch, vocab_cap):
    """count -T's sharded build (K1, K3) and the sharded set operations
    (K2, K3), 4 shards on cuda:0, against the same on 4 CPU shards."""
    import re

    from unikmer_tpu_torch.io import unik
    from unikmer_tpu_torch.io.fastx import parse_taxid_records, read_fastx
    from unikmer_tpu_torch.taxonomy.taxdump import load_taxonomy

    card = _card()
    if vocab_cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", vocab_cap)
    on_card = mesh.make_mesh(devices=[card] * 4)
    on_cpu = mesh.make_mesh(devices=[CPU] * 4)
    taxdb = load_taxonomy("tests/data/taxdump")
    for mode in ("distinct", "unique", "repeated"):
        cfg = CountConfig(k=19, canonical=True, mode=mode)
        p, taxids = parse_taxid_records(read_fastx(genomes["tagged"]), cfg.k,
                                        cfg.circular, cfg.record_gap,
                                        re.compile(RE[2].encode()))
        for got, want in zip(
                sharded.mesh_count_taxids(p, taxids, taxdb, cfg, on_card),
                sharded.mesh_count_taxids(p, taxids, taxdb, cfg, on_cpu)):
            np.testing.assert_array_equal(got, want)
    files = [unik.UnikReader(uniks["{t%d}" % i]) for i in range(3)]
    codes = [f.read_all()[0] for f in files]
    tax = [np.full(len(c), f.header.global_taxid, np.uint32)
           for c, f in zip(codes, files)]
    for op in ("union", "inter", "diff", "common"):
        np.testing.assert_array_equal(
            sharded.mesh_set_op(op, codes, on_card, 38, threshold=2),
            sharded.mesh_set_op(op, codes, on_cpu, 38, threshold=2))
        for got, want in zip(
                sharded.mesh_set_op_taxids(op, codes, tax, taxdb, on_card,
                                           38, threshold=2),
                sharded.mesh_set_op_taxids(op, codes, tax, taxdb, on_cpu,
                                           38, threshold=2)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_count_mesh_one_on_the_card_matches_jax_cli(genomes, tmp_path,
                                                    caplog, monkeypatch):
    """count --mesh 1 and union --mesh 1 through the CLI on the card."""
    _card()
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cuda")
    argv = ["count", "-k", "21", "-K", "-s", *genomes["g"], "--mesh", "1"]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))
    argv = ["count", "-k", "19", "-K", "-s", *RE, *TAXDUMP,
            genomes["tagged"], "--mesh", "1"]
    same_cli(tmp_path, caplog, argv, without_mesh(argv))
