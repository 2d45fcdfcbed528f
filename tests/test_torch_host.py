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
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import profiler

import chip_smoke
from portbench.records import covered, merged
from unikmer_tpu.io import fastx as jax_fastx
from unikmer_tpu.io import unik as jax_unik
from unikmer_tpu.ops.codec import canonical_np as jax_canonical_np
from unikmer_tpu.ops.codec import window_valid as jax_window_valid
from unikmer_tpu.ops.nthash import nthash_windows_np as jax_nthash_windows_np
from unikmer_tpu.ops.nthash import scaled_max_hash as jax_scaled_max_hash
from unikmer_tpu.ops import filter as jax_filter
from unikmer_tpu.ops import sets as jax_sets
from unikmer_tpu.ops import sketch as jax_sketch
from unikmer_tpu.taxonomy import taxdump as jax_taxdump
from unikmer_tpu_torch import native
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import fastx, unik
from unikmer_tpu_torch.models import count as port_count
from unikmer_tpu_torch.ops import filter as port_filter
from unikmer_tpu_torch.ops import sets
from unikmer_tpu_torch.pipeline import extsort
from unikmer_tpu_torch.taxonomy import taxdump

REPO = Path(__file__).resolve().parent.parent
TAXDUMP = "tests/data/taxdump"
TAXIDS = np.array([0, 511145, 585057, 349741, 562, 561, 2, 1224, 83333],
                  np.uint32)


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


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


@pytest.mark.parametrize("with_ranks", [True, False])
def test_taxonomy_rank_matches_jax(with_ranks):
    """rank (rfilter) answers as the JAX Taxonomy's, with and without
    ranks loaded, for every node, 0 and taxids past the tree."""
    want = jax_taxdump.load_taxonomy(TAXDUMP, with_rank=with_ranks)
    got = taxdump.load_taxonomy(TAXDUMP, with_rank=with_ranks)
    np.testing.assert_array_equal(got.rank_ids, want.rank_ids)
    assert got.ranks == want.ranks
    queries = [0, 1, 999999, 10 ** 9, *np.flatnonzero(want.depth >= 0)]
    ranks = [got.rank(int(t)) for t in queries]
    assert ranks == [want.rank(int(t)) for t in queries]
    assert ("species" in ranks) == with_ranks


@pytest.mark.parametrize("chunk_size", [0, 1, 700, 1000, 5000])
@pytest.mark.parametrize("has_taxid", [False, True])
def test_chunk_accumulator_matches_jax(chunk_size, has_taxid):
    """The same chunks (exactly chunk_size codes, the rest at flush; one
    chunk for 0), taxids zero-filled for a block without them."""
    from unikmer_tpu.pipeline import extsort as jax_extsort

    rng = np.random.default_rng(chunk_size)
    blocks = [(rng.integers(0, 1 << 40, size=n, dtype=np.uint64),
               None if i % 3 == 1 else rng.integers(1, 9, size=n,
                                                    dtype=np.uint32))
              for i, n in enumerate((900, 0, 1500, 300, 2100))]
    got = []
    for mod in (jax_extsort, extsort):
        chunks = []
        acc = mod.ChunkAccumulator(chunk_size, has_taxid,
                                   lambda c, t: chunks.append((c, t)))
        for codes, taxids in blocks:
            acc.add(codes, taxids)
        acc.flush()
        acc.flush()
        got.append(chunks)
    assert len(got[0]) == len(got[1]) > 0
    for (wc, wt), (gc, gt) in zip(*got):
        np.testing.assert_array_equal(gc, wc)
        assert (gt is None) == (wt is None) == (not has_taxid)
        if has_taxid:
            np.testing.assert_array_equal(gt, wt)
    sizes = [len(c) for c, _ in got[1]]
    if chunk_size:
        assert all(n == chunk_size for n in sizes[:-1])
        assert 0 < sizes[-1] <= chunk_size
    assert sum(sizes) == 4800


@pytest.mark.parametrize("src,has_taxid,number", [
    ("plain", False, -1), ("taxids", True, 77), ("global", True, -1),
    ("global", False, 5), ("hashed", False, -1)])
def test_make_writer_like_matches_jax(tmp_path, src, has_taxid, number):
    """The writer takes the reader's flag (+INCLUDE_TAXID with taxids),
    its scale and its taxid width, and its global taxid unless taxids
    are written: the same header and blocks as the JAX helper's."""
    from unikmer_tpu.cli.commands import _common as jax_common
    from unikmer_tpu_torch.cli.commands import _common as port_common

    codes = sorted_codes(33, 3000)
    kw = {"plain": dict(flag=unik.SORTED),
          "taxids": dict(flag=unik.SORTED | unik.INCLUDE_TAXID,
                         max_taxid=600000),
          "global": dict(flag=unik.CANONICAL, global_taxid=562),
          "hashed": dict(flag=unik.HASHED, scale=8, k=31)}[src]
    path = str(tmp_path / "in.unik")
    with unik.UnikWriter(path, **{"k": 23, **kw}, compress=False) as w:
        w.write_codes(codes, np.full(len(codes), 511145, np.uint32)
                      if src == "taxids" else None)
    opt = type("Opt", (), dict(compress=False, compression_level=5,
                               threads=2))()
    out = []
    for side, common in (("jax", jax_common), ("port", port_common)):
        with common.open_reader(path) as r:
            w = common.make_writer_like(r, str(tmp_path / side), opt,
                                        has_taxid, number)
            w.write_codes(codes, np.arange(len(codes), dtype=np.uint32)
                          if has_taxid else None)
            w.close()
        out.append((tmp_path / f"{side}.unik").read_bytes())
    assert out[0] == out[1]
    with unik.UnikReader(str(tmp_path / "port.unik")) as r:
        h = r.header
        assert h.is_include_taxid == has_taxid and h.number == number
        assert h.global_taxid == (562 if src == "global" and not has_taxid
                                  else 0)
        assert h.scale == (8 if src == "hashed" else 1)


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
# the set operations' host layers: the .unik reader, ops/sets, filter

HEADER_PROPS = ("is_compact", "is_canonical", "is_sorted",
                "is_include_taxid", "is_hashed", "is_scaled",
                "has_global_taxid", "has_taxid_info")


@pytest.mark.parametrize("flag,max_taxid,gt,scale", [
    (jax_unik.SORTED, 0, 0, 1),
    (jax_unik.SORTED | jax_unik.INCLUDE_TAXID | jax_unik.CANONICAL,
     (1 << 32) - 1, 0, 1),
    (jax_unik.SORTED | jax_unik.INCLUDE_TAXID, 600000, 0, 1),
    (jax_unik.INCLUDE_TAXID | jax_unik.HASHED, 255, 0, 7),
    (jax_unik.COMPACT | jax_unik.CANONICAL, 0, 9606, 1),
    (0, 0, 0, 1),
])
@pytest.mark.parametrize("compress", [False, True])
def test_read_all_and_header_match_jax(flag, max_taxid, gt, scale, compress,
                                       no_native):
    """read_all (the native block decoder, then the numpy branch) and the
    header properties on the bytes the JAX writer made."""
    codes = sorted_codes(21, 30000)
    if not flag & jax_unik.SORTED:
        codes = np.random.default_rng(22).permutation(codes)
    taxids = None
    if flag & jax_unik.INCLUDE_TAXID:
        taxids = np.random.default_rng(23).choice(TAXIDS, size=len(codes))
        taxids = np.minimum(taxids, max_taxid).astype(np.uint32)
    buf = io.BytesIO()
    with jax_unik.UnikWriter(buf, k=23, flag=flag, number=len(codes),
                             max_taxid=max_taxid, compress=compress,
                             block_size=7000, global_taxid=gt,
                             scale=scale) as w:
        w.write_codes(codes, taxids)
    data = buf.getvalue()
    with jax_unik.UnikReader(io.BytesIO(data)) as r:
        want_h, want = r.header, r.read_all()
    for branch in ("native", "numpy"):
        if branch == "numpy":
            no_native()
        with unik.UnikReader(io.BytesIO(data)) as r:
            got_h, got = r.header, r.read_all()
        for prop in HEADER_PROPS:
            assert getattr(got_h, prop) == getattr(want_h, prop), prop
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])


def test_read_all_of_an_empty_set_matches_jax():
    for flag in (jax_unik.SORTED, jax_unik.SORTED | jax_unik.INCLUDE_TAXID):
        j, p = write_both(np.zeros(0, np.uint64),
                          np.zeros(0, np.uint32) if flag > 4 else None,
                          k=21, flag=flag, compress=False)
        assert j == p
        with unik.UnikReader(io.BytesIO(p)) as r:
            codes, taxids = r.read_all()
        assert len(codes) == 0 and (taxids is None) == (flag == 4)


def test_reader_takes_a_stream_without_peek():
    """A raw stream (stdin's kind) is sniffed through _Concat."""
    codes = sorted_codes(24, 5000)
    data = write_both(codes, k=23, flag=unik.SORTED, compress=True)[1]

    class Raw(io.RawIOBase):
        def __init__(self, b):
            self.b = io.BytesIO(b)

        def readable(self):
            return True

        def readinto(self, out):
            chunk = self.b.read(len(out))
            out[: len(chunk)] = chunk
            return len(chunk)

    with unik.UnikReader(Raw(data)) as r:
        np.testing.assert_array_equal(r.read_all()[0], codes)


@pytest.mark.parametrize("change", [
    {}, {"k": 25}, {"flag": unik.SORTED | unik.CANONICAL},
    {"flag": unik.SORTED | unik.HASHED}, {"scale": 3},
    {"k": 25, "flag": unik.SORTED | unik.HASHED, "scale": 2}])
def test_check_compatibility_matches_jax(change):
    base = dict(k=23, flag=unik.SORTED, scale=1)
    h = {**base, **change}
    results = []
    for mod in (jax_unik, unik):
        try:
            mod.check_compatibility(mod.UnikHeader(**base),
                                    mod.UnikHeader(**h), "f.unik")
            results.append(None)
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[1] is None) == (not change)


def test_cli_common_helpers_match_jax(tmp_path):
    """effective_taxids makes a global taxid a column (None under -I, the
    file's own column where it has one), and open_reader reads a path and
    stdin ("-") alike, as the JAX helpers do."""
    from unikmer_tpu.cli.commands import _common as jax_common
    from unikmer_tpu_torch.cli.commands import _common as port_common

    codes = sorted_codes(28, 3000)
    taxids = np.random.default_rng(29).choice(TAXIDS, size=len(codes))
    src = str(tmp_path / "src.unik")
    with unik.UnikWriter(src, k=23, flag=unik.SORTED | unik.INCLUDE_TAXID,
                         max_taxid=600000, compress=False) as w:
        w.write_codes(codes, taxids)
    glob = str(tmp_path / "glob.unik")
    with unik.UnikWriter(glob, k=23, flag=unik.SORTED, global_taxid=562,
                         compress=False) as w:
        w.write_codes(codes)
    for mod in (jax_common, port_common):
        with mod.open_reader(glob) as r:
            t = mod.effective_taxids(r, 5, None, False)
            assert t.tolist() == [562] * 5
            assert mod.effective_taxids(r, 5, None, True) is None
        with mod.open_reader(src) as r:
            c, t = r.read_all()
            got = mod.effective_taxids(r, len(c), t, False)
        np.testing.assert_array_equal(c, codes)
        np.testing.assert_array_equal(got, taxids)
    with open(src, "rb") as f:
        data = f.read()
    old = sys.stdin
    try:
        sys.stdin = io.TextIOWrapper(io.BufferedReader(io.BytesIO(data)))
        with port_common.open_reader("-") as r:
            c, t = r.read_all()
    finally:
        sys.stdin = old
    np.testing.assert_array_equal(c, codes)
    np.testing.assert_array_equal(t, taxids)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_reader_gzipped_and_stream_match_jax(compress, stream):
    """UnikReader, which always streams, reads as the JAX reader does in
    either of its modes (``stream``), and its ``gzipped`` (info's column)
    says the same."""
    codes = sorted_codes(30, 4000)
    data = write_both(codes, k=23, flag=unik.SORTED, compress=compress)[0]
    with jax_unik.UnikReader(io.BytesIO(data), stream=stream) as r:
        want = (r.gzipped, r.read_all()[0])
    with unik.UnikReader(io.BytesIO(data)) as r:
        got = (r.gzipped, r.read_all()[0])
    assert got[0] == want[0] == compress
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("h0_tax,h_tax,ignore", [
    (False, False, False), (True, True, False), (False, True, False),
    (True, False, False), (True, False, True)])
def test_check_taxid_info_match_matches_jax(caplog, h0_tax, h_tax, ignore):
    from unikmer_tpu.cli.commands import _common as jax_common
    from unikmer_tpu_torch.cli.commands import _common as port_common

    def header(mod, tax):
        return mod.UnikHeader(k=23, flag=mod.SORTED | (
            mod.INCLUDE_TAXID if tax else 0), taxid_bytes=4 if tax else 0)

    got = []
    for mod, common in ((jax_unik, jax_common), (unik, port_common)):
        caplog.clear()
        opt = type("Opt", (), {"ignore_taxid": ignore})()
        try:
            common.check_taxid_info_match(header(mod, h0_tax),
                                          header(mod, h_tax), "f.unik", opt)
            got.append(None)
        except SystemExit as e:
            got.append((e.code, caplog.records[-1].getMessage()))
    assert got[0] == got[1]
    assert (got[1] is None) == (h0_tax == h_tax or ignore)


@pytest.mark.parametrize("name", ["-", "out.txt", "out.txt.gz", "OUT.GZ"])
def test_out_text_stream_matches_jax(tmp_path, name):
    from unikmer_tpu.cli import opts as jax_opts
    from unikmer_tpu_torch.cli import opts as port_opts

    text = "ACGT\t12\nä\n" * 50
    got = []
    for side, mod in (("jax", jax_opts), ("port", port_opts)):
        path = name if name == "-" else str(tmp_path / f"{side}{name}")
        out, owns = mod.out_text_stream(path, 3)
        assert owns == (name != "-")
        if name == "-":
            assert out is sys.stdout
            continue
        out.write(text)
        out.close()
        data = open(path, "rb").read()
        got.append(gzip.decompress(data) if name.lower().endswith(".gz")
                   else data)
    assert got[0] == got[1] if got else True
    assert not got or got[1] == text.encode()


def test_dump_chunk_takes_a_compression_level(tmp_path):
    """grep's spill writes its chunks at level 1: the chunk reads back
    sorted and collapsed at either level."""
    codes = np.random.default_rng(31).permutation(sorted_codes(31, 50000))
    opt = type("Opt", (), dict(max_taxid=0, compress=True,
                               compression_level=9, threads=1))()
    sizes = []
    for level in (None, 1):
        path = str(tmp_path / f"c{level}.unik")
        extsort.dump_chunk(np.concatenate([codes, codes[:99]]), None, path,
                           23, unik.CANONICAL, "unique", None, opt,
                           compression_level=level)
        with unik.UnikReader(path) as r:
            assert r.header.is_sorted
            np.testing.assert_array_equal(r.read_all()[0], np.sort(codes))
        sizes.append(os.path.getsize(path))
    assert sizes[1] > sizes[0]


@pytest.fixture(scope="module")
def set_inputs():
    """Five sorted code arrays sharing members, with taxid columns (an
    unknown taxid and 0s among them) and constant ones."""
    rng = np.random.default_rng(25)
    base = rng.integers(0, 1 << 40, size=40000, dtype=np.uint64)
    codes = [np.unique(np.concatenate([base[rng.random(40000) < 0.4],
                                       rng.integers(0, 1 << 40, size=3000,
                                                    dtype=np.uint64)]))
             for _ in range(5)]
    pool = np.append(TAXIDS, 999999).astype(np.uint32)
    taxids = [rng.choice(pool, len(c)).astype(np.uint32) for c in codes]
    consts = [np.full(len(c), t, np.uint32)
              for c, t in zip(codes, (511145, 585057, 562, 0, 2))]
    return codes, taxids, consts


def assert_pair(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("engine", ["native", "numpy"])
def test_host_set_engine_matches_jax(taxdbs, set_inputs, no_native, engine):
    """ops/sets: union (the native tree, the constant-taxid patterns and
    the generic LCA reduce), intersect, subtract (with --compare-taxid)
    and common, with and without a taxonomy."""
    jdb, pdb = taxdbs
    if engine == "numpy":
        no_native()
    codes, taxids, consts = set_inputs
    unsorted = np.random.default_rng(26).permutation(codes[2])
    for tax in (None, taxids, consts):
        for db in ((jdb, pdb), (None, None)):
            assert_pair(sets.union(codes[:4], tax and tax[:4], db[1]),
                        jax_sets.union(codes[:4], tax and tax[:4], db[0]))
            assert_pair(sets.intersect(codes[:3], tax and tax[:3], db[1]),
                        jax_sets.intersect(codes[:3], tax and tax[:3], db[0]))
            for th in (0, 1, 2, 5, 6):
                assert_pair(sets.common(codes, tax, th, db[1]),
                            jax_sets.common(codes, tax, th, db[0]))
    others = [codes[1], unsorted, codes[3][:0]]
    for cmp in (False, True):
        for ot in (None, [taxids[1], taxids[2], taxids[3][:0]]):
            qt = None if ot is None else taxids[0]
            assert_pair(
                sets.subtract(codes[0], qt, others, ot, cmp, pdb),
                jax_sets.subtract(codes[0], qt, others, ot, cmp, jdb))
    assert_pair(sets.union([unsorted, codes[1]]),
                jax_sets.union([unsorted, codes[1]]))
    q = np.sort(np.concatenate([codes[0][::5], codes[4][:500]]))
    assert_pair(sets.member_mask(codes[1], q, sorted_queries=True),
                jax_sets.member_mask(codes[1], q, sorted_queries=True))
    dup = np.sort(np.concatenate([codes[0], codes[0][::3]]))
    dt = np.random.default_rng(27).choice(TAXIDS, len(dup)).astype(np.uint32)
    for t, db in ((None, None), (dt, None), (dt, pdb)):
        assert_pair(sets.dedup_sorted(dup, t, db),
                    jax_sets.dedup_sorted(dup, t, db and jdb))


@pytest.mark.parametrize("k,window", [(1, 7), (5, 7), (21, 7), (31, 4),
                                      (32, 32)])
@pytest.mark.parametrize("penalty", [(3, 1, 15), (2, 2, 5)])
def test_low_complexity_mask_matches_jax(k, window, penalty):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    codes[:4] = [0, (1 << (2 * k)) - 1, 0x5555555555555555 >> (64 - 2 * k),
                 0x1B1B1B1B1B1B1B1B >> (64 - 2 * k)]
    got = port_filter.low_complexity_mask(
        torch.from_numpy(codes.view(np.int64)), k, *penalty, window)
    want = jax_filter.low_complexity_mask(codes, k, *penalty, window)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


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
    np.testing.assert_array_equal(sets.union([b, a, b[:7]])[0],
                                  np.union1d(a, b))


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 16) + 3, 300000])
def test_native_set_functions_match_numpy(n):
    """set2_sorted (union, inter, diff), member_mask_sorted and
    host_argsort against numpy: both sides with duplicates."""
    rng = np.random.default_rng(n + 30)
    a = np.sort(rng.integers(0, max(n, 1) * 2, size=n, dtype=np.uint64))
    b = np.sort(rng.integers(0, max(n, 1) * 2, size=n // 2 + 1,
                             dtype=np.uint64))
    for op, want in (("union", np.union1d), ("inter", np.intersect1d),
                     ("diff", np.setdiff1d)):
        np.testing.assert_array_equal(native.set2_sorted(op, a, b),
                                      want(a, b))
        assert native.set2_sorted(op, a, b, trim=False).base is not None
    np.testing.assert_array_equal(native.set2_union(b, a), np.union1d(a, b))
    ua = np.unique(a)
    mask, idx = native.member_mask_sorted(ua, b)
    np.testing.assert_array_equal(mask, np.isin(b, ua))
    np.testing.assert_array_equal(ua[idx[mask]], b[mask])
    assert native.member_mask_sorted(ua, b, want_idx=False)[1] is None
    keys = rng.integers(0, 50, size=n, dtype=np.uint64)
    sk, perm = native.host_argsort(keys)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sk, keys[order])
    np.testing.assert_array_equal(np.asarray(perm, np.int64), order)


def test_native_set_functions_fall_back_to_numpy(no_native):
    a = sorted_codes(31, 100)
    no_native()
    assert native.set2_sorted("inter", a, a) is None
    assert native.set2_union(a, a) is None
    assert native.member_mask_sorted(a, a) is None
    assert native.decode_sorted_blocks(b"", 0) is None
    sk, perm = native.host_argsort(a[::-1].copy())
    np.testing.assert_array_equal(sk, a)
    assert perm.dtype == np.int64


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


@pytest.mark.parametrize("k", [1, 5, 8, 9, 23, 31, 32])
def test_chip_smoke_canonical_matches_jax(k):
    """chip_smoke's windows from 8-base blocks: the forward codes against
    a base-by-base roll, the canonical ones against the JAX package's
    canonical_np of them (all-A and all-T windows among them)."""
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, size=5000, dtype=np.uint8)
    bases[rng.random(5000) < 0.01] = 255
    bases[100:140], bases[200:240] = 0, 3
    fwd, pos = chip_smoke.numpy_windows(bases, k, False)
    canon, pos2 = chip_smoke.numpy_windows(bases, k, True)
    want = np.zeros(len(bases) - k + 1, np.uint64)
    for j in range(k):
        want = (want << np.uint64(2)) | (bases[j:j + len(want)] & 3).astype(
            np.uint64)
    np.testing.assert_array_equal(pos, pos2)
    np.testing.assert_array_equal(fwd, want[pos])
    np.testing.assert_array_equal(canon, jax_canonical_np(fwd, k))
    assert len(pos) > 3000 and {0, (1 << (2 * k)) - 1} <= set(fwd.tolist())


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


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [1, 31, 33, 64])
def test_chip_smoke_nthash_oracle_matches_jax(k, canonical):
    """chip_smoke's ntHash oracle (the definition, in a table form over
    8-base blocks) against the JAX package's doubling composition on the
    valid windows."""
    rng = np.random.default_rng(k)
    bases = rng.integers(0, 4, size=5000, dtype=np.uint8)
    bases[rng.random(5000) < 0.01] = 255
    codes, pos = chip_smoke.nthash_oracle(bases, k, canonical)
    want = jax_nthash_windows_np(bases, k, canonical)
    valid = np.asarray(jax_window_valid(bases, k))
    np.testing.assert_array_equal(pos, np.flatnonzero(valid))
    np.testing.assert_array_equal(codes, want[valid])
    for scale in (1, 2, 15, 1000, 2**32 - 1):
        assert (chip_smoke.scaled_max_hash_oracle(scale)
                == jax_scaled_max_hash(scale))


@pytest.mark.parametrize("n", [0, 1, 2, 5000])
def test_chip_smoke_unique_counts_matches_np_unique(n):
    codes = np.random.default_rng(n).integers(0, 50, size=n).astype(np.uint64)
    got, want = chip_smoke.unique_counts(codes), np.unique(codes,
                                                           return_counts=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.uint64


@pytest.mark.parametrize("v", [
    [3.0, 1.0, 2.0, 5.0, 4.0],  # odd length
    [1.0, 2.0, 3.0, 4.0, 10.0, 20.0],  # even length
    [2.0, 2.0, 2.0, 5.0, 5.0],  # ties
    [1.5, 4.0],  # two values
    [7.25],  # one value
    list(np.random.default_rng(40).random(40) * 3),  # TURNS timings
], ids=["odd", "even", "ties", "two", "one", "turns"])
def test_chip_smoke_quartiles(v):
    """chip_smoke's median and spread are numpy's linear percentiles."""
    q1, q2, q3 = np.percentile(v, [25, 50, 75], method="linear")
    got = chip_smoke.quartiles(v)
    assert got["median"] == pytest.approx(q2, rel=1e-12, abs=1e-12)
    assert got["spread"] == pytest.approx(q3 - q1, rel=1e-12, abs=1e-12)


BUSY_CASES = {
    "empty": [],
    "one": [(3, 9)],
    "disjoint": [(0, 2), (5, 7), (10, 11)],
    "touching": [(0, 4), (4, 6), (6, 9)],
    "nested": [(0, 20), (3, 5), (8, 19)],
    "chain": [(0, 5), (3, 9), (8, 14), (13, 20)],
    "unsorted": [(12, 15), (0, 3), (2, 6), (14, 18)],
    "zero-length": [(4, 4), (2, 8), (10, 10)],
    "zero-length alone": [(5, 5)],
    "repeated": [(1, 4), (1, 4), (0, 2)],
}


def grid_runs(intervals) -> list:
    """The union of integer (start, end) intervals by brute force: every
    unit cell [t, t + 1) some interval covers, as runs of cells."""
    cells = sorted({t for a, b in intervals for t in range(a, b)})
    runs = []
    for t in cells:
        if runs and runs[-1][1] == t:
            runs[-1][1] = t + 1
        else:
            runs.append([t, t + 1])
    return [tuple(r) for r in runs]


@pytest.mark.parametrize("name", list(BUSY_CASES))
def test_chip_smoke_busy_union(name, monkeypatch):
    """device_busy's busy time, the union of the traced device intervals
    (portbench.records), against a union on an integer grid; a CPU event
    of the trace stays out of it."""
    spans = BUSY_CASES[name]
    want = grid_runs(spans)
    assert [(a, b) for a, b in merged(spans) if b > a] == want
    assert covered(spans) == sum(b - a for a, b in want)

    def event(a, b, kind):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=a, end=b),
            device_type=kind)

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    trace = [event(a, b, cuda) for a, b in spans] + [event(0, 10 ** 6, cpu)]

    class Profile:
        def __init__(self, activities):
            assert activities == [profiler.ProfilerActivity.CUDA]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiler, "profile", Profile)
    ran = []
    got = chip_smoke.device_busy(lambda: ran.append(1))
    assert ran == [1] and got["traced_s"] >= 0
    if spans:
        assert got["busy_s"] == round(sum(b - a for a, b in want) / 1e6, 6)
        assert got["busy_share"] is not None
    else:
        assert got["busy_s"] is None and got["busy_share"] is None


def test_chip_smoke_hashed_oracles_match_the_port_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    fa = random_fasta(tmp_path / "h.fa", 15)
    for k, canonical, mode, flags in ((31, True, "distinct", ["-H"]),
                                      (64, False, "unique", ["-u"]),
                                      (40, True, "repeated", ["-d"])):
        out = str(tmp_path / f"h{k}")
        assert port_main(["count", "-k", str(k), *(["-K"] if canonical else []),
                          "-s", "-C", *flags, fa, "-o", out]) == 0
        chip_smoke.oracle_unik(fa, out + ".oracle.unik", k, canonical, mode,
                               hashed=True)
        assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")
    tfa = tmp_path / "t.fa"
    rng = np.random.default_rng(16)
    shared = rng.choice(list(b"ACGT"), size=300).astype(np.uint8).tobytes()
    with open(tfa, "wb") as f:
        for i, t in enumerate((562, 511145, 585057, 562)):
            seq = shared + rng.choice(list(b"ACGT"), size=900).astype(
                np.uint8).tobytes()
            f.write(b">r%d taxid|%d\n%s\n" % (i, t, seq))
    out = str(tmp_path / "tH")
    assert port_main(["count", "-k", "31", "-K", "-H", "-s", "-C", "-T", "-r",
                      chip_smoke.RE_TAXID, "--data-dir", TAXDUMP, str(tfa),
                      "-o", out]) == 0
    chip_smoke.oracle_taxid_unik(str(tfa), out + ".oracle.unik", 31, True,
                                 "distinct", TAXDUMP, hashed=True)
    assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")


def sketch_input(seed, n=6000):
    """Bases with invalid singletons, a poly-A run (equal hashes) and a
    repeat."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 4, size=n, dtype=np.uint8)
    bases[rng.random(n) < 0.01] = 255
    bases[2000:2300] = 0
    bases[4000:4500] = bases[3000:3500]
    return bases


@pytest.mark.parametrize("k,w,s", [(31, 15, 16), (21, 5, 9), (15, 1, 15),
                                   (64, 100, 1)])
def test_chip_smoke_sketch_oracles_match_jax(k, w, s):
    """chip_smoke's minimizer, closed-syncmer and per-record compat
    oracles (written from the definitions) against the JAX package's
    sketch streams: the same positions and codes."""
    bases = sketch_input(k + w)
    kk, kv = chip_smoke.nthash_keyed_oracle(bases, k)
    sk, _ = chip_smoke.nthash_keyed_oracle(bases, s)
    for got, (codes, emit) in (
            (chip_smoke.minimizer_oracle(kk, kv, w),
             jax_sketch.minimizer_windows(jnp.asarray(bases), k, w)),
            (chip_smoke.syncmer_oracle(kk, kv, sk, k, s),
             jax_sketch.syncmer_windows(jnp.asarray(bases), k, s))):
        emit = np.asarray(emit)
        np.testing.assert_array_equal(got[1], np.flatnonzero(emit))
        np.testing.assert_array_equal(got[0], np.asarray(codes)[emit])
        assert len(got[1]) > 20
    rng = np.random.default_rng(k)
    recs = [jax_fastx.Record(b"c", b"c", rng.choice(
        np.frombuffer(b"ACGTN", np.uint8), size=int(n),
        p=[.245, .245, .245, .245, .02]).tobytes())
        for n in (1500, 3, k - 1, k, 2 * (k - s) + 1, 800, 2500)]
    packed = jax_fastx.pack_records(recs, k, gap=jax_sketch.compat_gap(k, s))
    codes, emit = jax_sketch.syncmer_compat_windows(
        jnp.asarray(packed.bases), k, s)
    emit = np.asarray(emit)
    got = chip_smoke.compat_oracle(packed, k, s)
    np.testing.assert_array_equal(got[1], np.flatnonzero(emit))
    np.testing.assert_array_equal(got[0], np.asarray(codes)[emit])


def test_chip_smoke_sketch_oracles_match_the_port_cli(tmp_path, monkeypatch):
    """The .unik files chip_smoke's sketch runs hold to its oracles: -W,
    -S and compat (-s), -l -W and -T -W, through the port's CLI on the
    CPU."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(17)
    lengths = rng.integers(1, 3000, size=12)
    lengths[:4] = (1, 20, 31, 45)
    fa = str(tmp_path / "s.fa")
    chip_smoke.write_records_fasta(fa, rng, lengths)
    with chip_smoke.numpy_host():
        bases = fastx.pack_files([fa], 31).bases
        kk, kv = chip_smoke.nthash_keyed_oracle(bases, 31)
        sk, _ = chip_smoke.nthash_keyed_oracle(bases, 16)
        want = {
            "W": chip_smoke.minimizer_oracle(kk, kv, 15)[0],
            "S": chip_smoke.syncmer_oracle(kk, kv, sk, 31, 16)[0],
            "C": chip_smoke.compat_oracle(
                fastx.pack_records(fastx.read_fastx(fa), 31), 31, 16)[0]}
        lin = chip_smoke.minimizer_oracle(*chip_smoke.nthash_keyed_oracle(
            fastx.pack_files([fa], 23).bases, 23), 5)[0]
    hashed = unik.CANONICAL | unik.HASHED
    for name, flags in (("W", ["-W", "15"]), ("S", ["-S", "16"]),
                        ("C", ["-S", "16", "--syncmer-impl", "compat"])):
        out = str(tmp_path / name)
        with monkeypatch.context() as mp:
            if name == "C":  # compat's device twin, as chip_smoke runs it
                mp.setenv("UNIKMER_TPU_NO_NATIVE", "1")
            assert port_main(["count", "-k", "31", *flags, "-s", "-C", fa,
                              "-o", out]) == 0
        chip_smoke.write_oracle(out + ".oracle.unik", 31, unik.SORTED | hashed,
                                chip_smoke.unique_counts(want[name])[0])
        assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")
    out = str(tmp_path / "l")
    assert port_main(["count", "-k", "23", "-W", "5", "-l", "-C", fa, "-o",
                      out]) == 0
    chip_smoke.write_oracle(out + ".oracle.unik", 23, hashed, lin, number=-1)
    assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")
    tfa = tmp_path / "t.fa"
    shared = rng.choice(list(b"ACGT"), size=300).astype(np.uint8).tobytes()
    with open(tfa, "wb") as f:
        for i, t in enumerate((562, 511145, 585057, 562)):
            seq = shared + rng.choice(list(b"ACGT"), size=900).astype(
                np.uint8).tobytes()
            f.write(b">r%d taxid|%d\n%s\n" % (i, t, seq))
    out = str(tmp_path / "tW")
    assert port_main(["count", "-k", "31", "-W", "15", "-s", "-C", "-T", "-r",
                      chip_smoke.RE_TAXID, "--data-dir", TAXDUMP, str(tfa),
                      "-o", out]) == 0
    chip_smoke.oracle_taxid_unik(str(tfa), out + ".oracle.unik", 31, False,
                                 "distinct", TAXDUMP, minimizer_w=15)
    assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik")


@pytest.mark.parametrize("k", [1, 5, 8, 23, 32])
def test_chip_smoke_low_complexity_oracle_matches_jax(k):
    """chip_smoke's filter oracle, written from the definition, against
    the JAX package's bit-trick form."""
    rng = np.random.default_rng(k + 40)
    codes = rng.integers(0, 1 << (2 * k), size=6000, dtype=np.uint64)
    codes[:3] = [0, (1 << (2 * k)) - 1, 0x1B1B1B1B1B1B1B1B >> (64 - 2 * k)]
    for args in ((3, 1, 15, 7), (2, 1, 6, 3), (1, 1, 1, 40)):
        np.testing.assert_array_equal(
            chip_smoke.low_complexity_oracle(codes, k, *args),
            jax_filter.low_complexity_mask(codes, k, *args))


@pytest.mark.parametrize("sizes", [(0, 0, 0), (5, 0, 9), (3000, 2000, 4000)])
def test_chip_smoke_merge_sets_matches_numpy_set_functions(sizes):
    rng = np.random.default_rng(sum(sizes))
    sets = [np.unique(rng.integers(0, 5000, size=n, dtype=np.uint64))
            for n in sizes]
    u, bits = chip_smoke.merge_sets(sets)
    np.testing.assert_array_equal(u, np.unique(np.concatenate(sets)))
    for i, x in enumerate(sets):
        np.testing.assert_array_equal(u[(bits >> i & 1) == 1], x)
    want = chip_smoke.set_oracles((u, bits))
    a, b, c = sets
    np.testing.assert_array_equal(want["A | B"], np.union1d(a, b))
    np.testing.assert_array_equal(want["A & B"], np.intersect1d(a, b))
    np.testing.assert_array_equal(want["A - B"], np.setdiff1d(a, b))
    vals, counts = np.unique(np.concatenate(sets), return_counts=True)
    np.testing.assert_array_equal(want["common 2"], vals[counts >= 2])


def test_chip_smoke_set_oracles_match_the_port(taxdbs, tmp_path):
    """The sets path's library and taxid oracles against the port's
    KmerSet on the CPU, over small records made as the path makes A, B
    and C."""
    from unikmer_tpu_torch.api import KmerSet

    rng = np.random.default_rng(41)
    abc = chip_smoke.set_bases(rng, 1 << 14)
    codes = [chip_smoke.numpy_count(x, 23, True, "distinct") for x in abc]
    want = chip_smoke.set_oracles(chip_smoke.merge_sets(codes))
    fas = [str(tmp_path / f"{n}.fa") for n in "ABC"]
    for fa, name, x in zip(fas, "ABC", abc):
        chip_smoke.write_one_record(fa, name, x)
    a, b, c = [KmerSet.from_fasta(fa, 23, canonical=True, device="cpu")
               for fa in fas]
    for got, w in zip((a, b, c), codes):
        np.testing.assert_array_equal(got.to_numpy(), w)
    for name, got in (("A | B", a | b), ("A & B", a & b), ("A - B", a - b),
                      ("union_all", KmerSet.union_all([a, b, c])),
                      ("common 2", KmerSet.common([a, b, c], 2))):
        np.testing.assert_array_equal(got.to_numpy(), want[name])
        assert len(want[name]) > 1000, name
    _, pdb = taxdbs
    ta = rng.choice(TAXIDS, len(codes[0])).astype(np.uint32)
    ta[7] = 999999
    tb = rng.choice(TAXIDS, len(codes[1])).astype(np.uint32)
    want = chip_smoke.taxid_set_oracles(codes[0], ta, codes[1], tb, pdb)
    at, bt = [KmerSet.from_codes(x, 23, canonical=True, taxids=t, taxdb=pdb,
                                 assume_sorted_unique=True, device="cpu")
              for x, t in ((codes[0], ta), (codes[1], tb))]
    for name, got in (("A | B (taxids)", at | bt), ("A & B (taxids)", at & bt),
                      ("A | B (one-sided)", at | b),
                      ("A & B (one-sided)", at & b),
                      ("A - B (taxids)", at - bt)):
        np.testing.assert_array_equal(got.to_numpy(), want[name][0])
        np.testing.assert_array_equal(got.taxids_to_numpy(), want[name][1])
        chip_smoke.check_saved(str(tmp_path), name, got, *want[name])


def test_chip_smoke_cli_setop_oracles_match_the_port_cli(tmp_path,
                                                         monkeypatch):
    """The sets path's CLI oracles against the port's union (both LCA
    tiers), inter, diff -s and common -n 2 over count -t outputs."""
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(42)
    abc = chip_smoke.set_bases(rng, 1 << 14)
    gtax = [511145, 585057, 562]
    uniks = []
    for name, x, t in zip("ABC", abc, gtax):
        fa = str(tmp_path / f"{name}.fa")
        chip_smoke.write_one_record(fa, name, x)
        assert port_main(["count", "-k", "23", "-K", "-s", "-C", "-t",
                          str(t), fa, "-o", str(tmp_path / name)]) == 0
        uniks.append(str(tmp_path / f"{name}.unik"))
    codes = [chip_smoke.numpy_count(x, 23, True, "distinct") for x in abc]
    want = chip_smoke.cli_setop_oracles(chip_smoke.merge_sets(codes), gtax,
                                        taxdump.load_taxonomy(TAXDUMP))
    flag = unik.SORTED | unik.CANONICAL | unik.INCLUDE_TAXID
    for key, cmd, vocab_max in (("union", ["union", "-s"], None),
                                ("union", ["union", "-s"], "0"),
                                ("inter", ["inter"], None),
                                ("diff", ["diff", "-s"], None),
                                ("common", ["common", "-n", "2"], None)):
        if vocab_max is not None:
            monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", vocab_max)
        out = str(tmp_path / "out")
        assert port_main([*cmd, "-C", "--data-dir", TAXDUMP, *uniks, "-o",
                          out]) == 0
        monkeypatch.delenv("UNIKMER_TPU_TAXID_VOCAB_MAX", raising=False)
        chip_smoke.write_oracle(out + ".oracle.unik", 23, flag, *want[key])
        assert chip_smoke.same_bytes(out + ".unik", out + ".oracle.unik"), key
        assert len(want[key][0]) > 500, key


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
    assert {REPO / "unikmer_tpu_torch/cli/commands" / f"{c}.py" for c in (
        "sort", "split", "merge", "tsplit", "head", "sample", "filter",
        "rfilter", "version", "autocompletion")} <= set(_port_sources())
    assert not bad, bad


def test_chip_smoke_alone_exits_without_result(tmp_path):
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_chip_smoke_names_a_missing_package(monkeypatch, capsys):
    """With a card but without the package (the script alone in a
    directory), one line names the package and the exit is non-zero."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(sys.modules, "unikmer_tpu_torch", None)
    assert chip_smoke.main() == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and "unikmer_tpu_torch" in out[0]
    assert '"ok"' not in out[0]


@pytest.fixture
def cuda_calls_on_cpu(monkeypatch):
    """chip_smoke's card-side bookkeeping (synchronize, peak memory, CUDA
    events) made no-ops, so its phases run on the CPU."""
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: 0)
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=5, before=None: (fn(), 0.0)[1])
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("half", [1 << 10, 1 << 13])
def test_chip_smoke_grep_path_holds_both_tiers(tmp_path, cuda_calls_on_cpu,
                                               half):
    """grep_path's oracle equals both tiers' output (the device tier on
    the CPU: DeviceMembership over the plain member_bits), and its row
    counts the lookups of the device tier only."""
    rng = np.random.default_rng(40)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 60000)]
    fa = tmp_path / "A.fa"
    fa.write_bytes(b">A\n" + seq.tobytes() + b"\n")
    a_unik = str(tmp_path / "cliA")
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", "-t", "562",
                      str(fa), "-o", a_unik]) == 0
    with unik.UnikReader(a_unik + ".unik") as r:
        an = r.read_all()[0]
    row = chip_smoke.grep_path(str(tmp_path), rng, an, a_unik + ".unik",
                               562, torch.device("cpu"), half=half)
    assert row["queries"] == 2 * half and row["hits"] == half
    assert row["lookups"] == 1 and row["input_codes"] == len(an)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["A.fa",
                                                          "cliA.unik"]


def test_chip_smoke_round_trip_and_admission(tmp_path, cuda_calls_on_cpu):
    rng = np.random.default_rng(41)
    # canonical 23-mers, as A's codes from count -K are
    codes = np.unique(jax_canonical_np(sorted_codes(42, 5000), 23))
    secs = chip_smoke.text_round_trip(str(tmp_path), rng, codes, n=4096)
    assert {"2-bit dump native", "hashed dump numpy",
            "hashed view -n numpy"} <= set(secs)
    assert not list(tmp_path.iterdir())
    row = chip_smoke.admission_budgets(torch.device("cpu"))
    assert row["free_bytes"] is None and set(row["budgets"]) == set(
        row["slot_bytes"])


def test_chip_smoke_file_commands_path_on_the_cpu(tmp_path, monkeypatch,
                                                  cuda_calls_on_cpu):
    """file_commands_path, at a small size on the CPU, over inputs made
    as the count -T and sets paths make theirs: every output equals its
    oracle (a cascade forced by -M 2), every call is timed and the
    temporary directory is left empty."""
    monkeypatch.setattr(chip_smoke, "TAX_NODES", 3000)
    rng = np.random.default_rng(43)
    tmp = str(tmp_path)
    d = os.path.join(tmp, "taxdump")
    os.mkdir(d)
    chip_smoke.write_taxonomy(d, rng)
    taxdb = taxdump.load_taxonomy(d)
    known = np.flatnonzero(taxdb.depth >= 0)
    # T2: records of taxids at every depth, species (7) among them
    picks = np.concatenate([rng.choice(np.flatnonzero(taxdb.depth == dp), 2)
                            for dp in (3, 6, 7, 7, 8, 10)])
    fa = os.path.join(tmp, "T2.fa")
    chip_smoke.write_taxid_fasta(fa, rng, np.repeat(picks, 2), 3000)
    t2 = os.path.join(tmp, "T2")
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", "-T", "-r",
                      chip_smoke.RE_TAXID, "--data-dir", d, fa, "-o",
                      t2]) == 0
    _, codes, taxids = chip_smoke.oracle_taxid_unik(
        fa, t2 + ".oracle.unik", 23, True, "distinct", d)
    assert chip_smoke.same_bytes(t2 + ".unik", t2 + ".oracle.unik")
    for f in (fa, t2 + ".oracle.unik"):
        os.remove(f)
    # A, B and C with global taxids, as the sets path's CLI phase
    gtax = [int(t) for t in rng.choice(known[known > 2], 3, replace=False)]
    uniks, sets_np = [], []
    for name, x, t in zip("ABC", chip_smoke.set_bases(rng, 40000), gtax):
        path = os.path.join(tmp, f"set{name}.fa")
        chip_smoke.write_one_record(path, name, x)
        assert port_main(["count", "-k", "23", "-K", "-s", "-C", "-t",
                          str(t), path, "-o", os.path.join(tmp, f"cli{name}")
                          ]) == 0
        os.remove(path)
        uniks.append(os.path.join(tmp, f"cli{name}.unik"))
        sets_np.append(chip_smoke.numpy_count(x, 23, True, "distinct"))
    cli = chip_smoke.cli_setop_oracles(chip_smoke.merge_sets(sets_np), gtax,
                                       taxdb)
    an, bn = sets_np[:2]
    ta = rng.choice(known[known > 0], len(an)).astype(np.uint32)
    tb = rng.choice(known[known > 0], len(bn)).astype(np.uint32)
    sets_in = {"uniks": uniks, "taxdump": d, "a": (an, ta), "b": (bn, tb),
               "a_low": chip_smoke.low_complexity_oracle(an, 23),
               "ab_taxids": chip_smoke.taxid_set_oracles(
                   an, ta, bn, tb, taxdb)["A | B (taxids)"],
               "union": cli["union"][0], "common": cli["common"][0]}
    before = sorted(os.listdir(tmp))
    got = chip_smoke.file_commands_path(
        tmp, sets_in, {"unik": t2 + ".unik", "codes": codes,
                       "taxids": taxids}, torch.device("cpu"), chunk="20K",
        max_open=2, head_n=5000)
    assert set(got["seconds"]) == {
        "sort -u -I", "sort -u -I -m 20K -M 2", "split -u -I -m 20K",
        "merge -D -u -I -M 2", "sort -d -I", "sort -u (per-code taxids)",
        "tsplit",
        "rfilter -E species", "rfilter -L genus", "head -n 5000",
        "sample -s 3 -w 7", "filter"}
    assert got["filter"]["kept"] < len(an)
    assert sorted(os.listdir(tmp)) == sorted(before + ["fc_tmp"])
