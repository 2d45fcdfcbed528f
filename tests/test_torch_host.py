"""The port's own host layers (io/, native/, ops/sets, pipeline/extsort,
taxonomy/taxdump, chip_smoke's oracle) against the JAX package's on the
same seeded inputs, the port's native library against its numpy
branches, and the port's isolation from ``unikmer_tpu``.  Exact
equality throughout."""

import ast
import gzip
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from unikmer_tpu.io import fastx as jax_fastx
from unikmer_tpu.io import unik as jax_unik
from unikmer_tpu.ops.codec import canonical_np as jax_canonical_np
from unikmer_tpu.taxonomy import taxdump as jax_taxdump
from unikmer_tpu_torch import native
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import fastx, unik
from unikmer_tpu_torch.models import count as port_count
from unikmer_tpu_torch.ops import sets
from unikmer_tpu_torch.pipeline import extsort
from unikmer_tpu_torch.taxonomy import taxdump

REPO = Path(__file__).resolve().parent.parent
TAXDUMP = "tests/data/taxdump"
TAXIDS = np.array([0, 511145, 585057, 349741, 562, 561, 2, 1224, 83333],
                  np.uint32)


def write_both(codes, taxids=None, **kw):
    """The bytes of the JAX and the port UnikWriter for the same call."""
    out = []
    for mod in (jax_unik, unik):
        buf = io.BytesIO()
        with mod.UnikWriter(buf, **kw) as w:
            w.write_codes(codes, taxids)
        out.append(buf.getvalue())
    return out


def sorted_codes(seed, n):
    return np.unique(np.random.default_rng(seed).integers(
        0, 1 << 46, size=n, dtype=np.uint64))


@pytest.mark.parametrize("flag,max_taxid", [
    (jax_unik.SORTED, 0),
    (jax_unik.SORTED | jax_unik.INCLUDE_TAXID, (1 << 32) - 1),
    (jax_unik.SORTED | jax_unik.INCLUDE_TAXID, 600000),
    (jax_unik.INCLUDE_TAXID, 255),
    (jax_unik.COMPACT | jax_unik.CANONICAL, 0),
    (0, 0),
])
@pytest.mark.parametrize("block", [1 << 20, 1000])
def test_unik_writer_bytes_match_jax(flag, max_taxid, block):
    codes = sorted_codes(1, 20000)
    taxids = None
    if flag & jax_unik.INCLUDE_TAXID:
        taxids = np.random.default_rng(2).choice(TAXIDS, size=len(codes))
        taxids = np.minimum(taxids, max_taxid).astype(np.uint32)
    j, p = write_both(codes, taxids, k=23, flag=flag, number=len(codes),
                      max_taxid=max_taxid, compress=False, block_size=block,
                      global_taxid=9606, scale=1)
    assert len(p) > 1000 and p == j


def test_unik_writer_gzip_inflates_to_jax_bytes():
    codes = sorted_codes(3, 300000)
    taxids = np.random.default_rng(4).choice(TAXIDS, size=len(codes))
    kw = dict(k=23, flag=jax_unik.SORTED | jax_unik.INCLUDE_TAXID,
              number=len(codes), max_taxid=(1 << 32) - 1, block_size=50000)
    j, p = write_both(codes, taxids, compress=True, threads=4, **kw)
    assert gzip.decompress(p) == gzip.decompress(j)
    raw = write_both(codes, taxids, compress=False, **kw)[1]
    assert gzip.decompress(p) == raw
    # the port's reader reads back both
    for data in (p, j):
        with unik.UnikReader(io.BytesIO(data)) as r:
            blocks = list(r.iter_blocks())
        np.testing.assert_array_equal(np.concatenate([c for c, _ in blocks]),
                                      codes)
        np.testing.assert_array_equal(np.concatenate([t for _, t in blocks]),
                                      taxids)


def random_fasta(path, seed, fastq=False, gz=False):
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(7):
        n = int(rng.integers(1, 5000)) if r else 3
        seq = rng.choice(np.frombuffer(b"ACGTacgtNU", np.uint8), size=n)
        s = seq.tobytes().decode()
        if fastq:
            lines += [f"@r{r} x{r}", s, "+", "I" * n]
        else:
            lines.append(f">r{r} sample {r}")
            lines += [s[i:i + 61] for i in range(0, n, 61)]
    data = ("\n".join(lines) + "\n").encode()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)
    return str(path)


@pytest.mark.parametrize("fastq", [False, True])
@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("k,circular", [(1, False), (23, False), (15, True)])
def test_pack_files_and_records_match_jax(tmp_path, fastq, gz, k, circular):
    path = random_fasta(tmp_path / "a.fx", 5, fastq, gz)
    want = jax_fastx.pack_files([path], k, circular)
    for got in (fastx.pack_files([path], k, circular),
                fastx.pack_records(fastx.read_fastx(path), k, circular)):
        np.testing.assert_array_equal(got.bases, want.bases)
        np.testing.assert_array_equal(got.starts, want.starts)
        np.testing.assert_array_equal(got.lengths, want.lengths)
    recs = list(fastx.read_fastx(path))
    jrecs = list(jax_fastx.read_fastx(path))
    assert [(r.name, r.id, r.seq) for r in recs] == [
        (r.name, r.id, r.seq) for r in jrecs]
    for gap in (1, 5):
        np.testing.assert_array_equal(
            fastx.pack_records(recs, k, circular, gap).bases,
            jax_fastx.pack_records(jrecs, k, circular, gap).bases)


def test_pack_files_of_several_files_match_jax(tmp_path):
    paths = [random_fasta(tmp_path / f"{i}.fa", 10 + i, gz=i == 1)
             for i in range(3)]
    want = jax_fastx.pack_files(paths, 7)
    got = fastx.pack_files(paths, 7)
    for f in ("bases", "starts", "lengths"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_packed_seqs_from_numpy_round_trip():
    recs = [jax_fastx.Record(b"a", b"a", b"ACGTNACGT" * 9),
            jax_fastx.Record(b"b", b"b", b"TTGCA" * 3)]
    want = jax_fastx.pack_records(recs, 5)
    got = fastx.PackedSeqs.from_numpy(want.bases, want.starts, want.lengths)
    assert isinstance(got, fastx.PackedSeqs) and got.n_records == 2
    assert got.bases.dtype == np.uint8 and got.starts.dtype == np.int64
    np.testing.assert_array_equal(got.bases, want.bases)
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.fixture(scope="module")
def taxdbs():
    return jax_taxdump.load_taxonomy(TAXDUMP), taxdump.load_taxonomy(TAXDUMP)


def test_load_taxonomy_matches_jax(taxdbs):
    want, got = taxdbs
    for f in ("parent", "depth", "rank_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.ranks, got.merged, got.root) == (want.ranks, want.merged,
                                                 want.root)


@pytest.mark.parametrize("n,sort", [(0, False), (1, False), (5000, True),
                                    (5000, False), (100000, False)])
def test_lca_reduce_matches_jax(taxdbs, n, sort):
    want_db, got_db = taxdbs
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(n // 4, 1), size=n, dtype=np.uint64)
    if sort:
        keys.sort()
    taxids = rng.choice(np.append(TAXIDS, 999999).astype(np.uint32), size=n)
    wk, wt = want_db.lca_reduce(keys, taxids)
    ported = taxdump.Taxonomy.from_numpy(want_db.parent, want_db.depth,
                                          want_db.rank_ids, want_db.ranks,
                                          want_db.merged, want_db.root)
    for db in (got_db, ported):
        gk, gt = db.lca_reduce(keys, taxids)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gt, wt)
    a = rng.choice(TAXIDS, size=300)
    b = rng.choice(TAXIDS, size=300)
    np.testing.assert_array_equal(got_db.lca_pairs(a, b),
                                  want_db.lca_pairs(a, b))


def test_taxonomy_from_numpy_round_trip(taxdbs):
    want, _ = taxdbs
    got = taxdump.Taxonomy.from_numpy(want.parent, want.depth, want.rank_ids,
                                      want.ranks, want.merged, want.root)
    assert got.parent is not want.parent  # a copy, not a view
    for f in ("parent", "depth", "rank_ids"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.max_taxid == want.max_taxid
    np.testing.assert_array_equal(got.has(TAXIDS), want.has(TAXIDS))


@pytest.mark.parametrize("mode", ["unique", "once", "repeated"])
def test_extsort_spill_merges_like_in_ram(tmp_path, mode):
    rng = np.random.default_rng(7)
    parts = [rng.integers(0, 3000, size=2000, dtype=np.uint64)
             for _ in range(5)]
    chunks = []
    for i, c in enumerate(parts):
        path = extsort.chunk_file_name(str(tmp_path), i)
        extsort.dump_chunk(c, None, path, 11, 0, mode, None,
                           port_count._SpillOpt())
        chunks.append(path)
    out = []
    n = extsort.cascade_merge(chunks, lambda: lambda c, _t: out.append(c),
                              str(tmp_path), 11, 0, mode, None,
                              port_count._SpillOpt(), max_open_files=2)
    u, counts = np.unique(np.concatenate(parts), return_counts=True)
    want = {"unique": u, "once": u[counts == 1], "repeated": u[counts > 1]}
    np.testing.assert_array_equal(np.concatenate(out), want[mode])
    assert n == len(want[mode])


# ---------------------------------------------------------------------
# the native library against the numpy branches


@pytest.fixture
def no_native(monkeypatch):
    def off():
        monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    return off


def test_native_library_builds_here():
    # g++ is on this host: the port's library builds, inflating gzip
    # itself when zlib's header is there
    assert native.get_lib() is not None
    assert native.engine().startswith("native")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 1000, (1 << 20) + 5])
def test_native_pack_matches_numpy(no_native, n):
    bases = np.random.default_rng(n).integers(0, 6, size=n).astype(np.uint8)
    got = port_count.pack_bases_2bit(bases)
    assert native.pack_bases_2bit(bases) is not None
    no_native()
    assert native.pack_bases_2bit(bases) is None
    want = port_count.pack_bases_2bit(bases)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_native_sorts_and_sets_match_numpy():
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 64, size=(1 << 16) + 3, dtype=np.uint64)
    keys[:100] = keys[100:200]
    vals = rng.integers(0, 1 << 32, size=len(keys), dtype=np.uint64)
    sk, sv = native.host_sort_kv(keys, vals.astype(np.uint32))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[order])
    np.testing.assert_array_equal(sv, vals.astype(np.uint32)[order])
    big = rng.integers(0, 1 << 40, size=(1 << 23) + 1, dtype=np.uint64)
    np.testing.assert_array_equal(native.host_sort(big), np.sort(big))
    a, b = np.unique(keys[: 40000]), np.unique(keys[30000:])
    np.testing.assert_array_equal(native.set2_union(a, b), np.union1d(a, b))
    # sorted inputs with duplicates inside each, as the piece merge sees
    np.testing.assert_array_equal(native.set2_union(np.sort(keys), b),
                                  np.union1d(keys, b))
    np.testing.assert_array_equal(sets.union([b, a, b[:7]]),
                                  np.union1d(a, b))


def test_native_delta_encode_matches_numpy(no_native):
    codes = sorted_codes(9, 300000)
    kw = dict(k=23, flag=unik.SORTED, number=len(codes), compress=False,
              block_size=70000)
    native_bytes = write_both(codes, **kw)[1]
    no_native()
    assert native.encode_sorted_blocks(codes, None, 0, 1000) is None
    assert write_both(codes, **kw)[1] == native_bytes


@pytest.mark.parametrize("gz", [False, True])
def test_native_fastx_load_matches_python_reader(tmp_path, gz):
    path = random_fasta(tmp_path / "b.fa", 11, gz=gz)
    got = native.load_fastx_packed(path, 9, True)
    want = fastx.pack_records(fastx.read_fastx(path), 9, True)
    assert got is not None
    np.testing.assert_array_equal(got[0], want.bases)
    np.testing.assert_array_equal(got[1], want.starts)
    np.testing.assert_array_equal(got[2], want.lengths)


def test_native_fastx_load_falls_back_past_the_cap(tmp_path):
    path = random_fasta(tmp_path / "c.fa", 12)
    assert native.load_fastx_packed(path, 9, max_text=10) is None
    bad = tmp_path / "bad.fa"
    bad.write_bytes(b"xyz\n")
    with pytest.raises(ValueError, match="not FASTA/FASTQ"):
        native.load_fastx_packed(str(bad), 9)


# ---------------------------------------------------------------------
# chip_smoke's oracle


@pytest.mark.parametrize("k", [1, 5, 23, 31, 32])
def test_chip_smoke_canonical_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    codes[:2] = [0, (1 << (2 * k)) - 1]
    np.testing.assert_array_equal(chip_smoke.canonical_np(codes, k),
                                  jax_canonical_np(codes, k))


def test_chip_smoke_oracles_match_the_port_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    fa = random_fasta(tmp_path / "o.fa", 13)
    for k, canonical, mode, flags in ((23, True, "distinct", []),
                                      (15, True, "unique", ["-u"]),
                                      (32, False, "repeated", ["-d"])):
        out = str(tmp_path / f"o{k}")
        assert port_main(["count", "-k", str(k), *(["-K"] if canonical else []),
                          "-s", "-C", *flags, fa, "-o", out]) == 0
        chip_smoke.oracle_unik(fa, out + ".oracle.unik", k, canonical, mode)
        assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")
    tfa = tmp_path / "t.fa"
    rng = np.random.default_rng(14)
    shared = rng.choice(list(b"ACGT"), size=300).astype(np.uint8).tobytes()
    with open(tfa, "wb") as f:
        for i, t in enumerate((562, 511145, 585057, 562)):
            seq = shared + rng.choice(list(b"ACGT"), size=900).astype(
                np.uint8).tobytes()
            f.write(b">r%d taxid|%d\n%s\n" % (i, t, seq))
    out = str(tmp_path / "t")
    assert port_main(["count", "-k", "15", "-K", "-s", "-C", "-T", "-r",
                      chip_smoke.RE_TAXID, "--data-dir", TAXDUMP, str(tfa),
                      "-o", out]) == 0
    chip_smoke.oracle_taxid_unik(str(tfa), out + ".oracle.unik", 15, True,
                                 "distinct", TAXDUMP)
    assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")


# ---------------------------------------------------------------------
# isolation


def _port_sources():
    return sorted((REPO / "unikmer_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _bad_import(name: str) -> bool:
    return name in ("unikmer_tpu", "jax", "jaxlib") or name.startswith(
        ("unikmer_tpu.", "jax.", "jaxlib."))


def test_port_sources_import_nothing_of_unikmer_tpu():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}"
                    for n in names if _bad_import(n)]
    assert len(_port_sources()) > 30
    assert not bad, bad


def test_chip_smoke_alone_exits_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout
