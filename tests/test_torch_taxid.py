"""The port's ``count -T`` and ``count -l`` (plain kernels on the CPU)
against the JAX package's models/count.py and CLI: both LCA tiers, all
three modes, k = 32 with real 2^64-1 codes, the host fallback for
unknown taxids, the streamed path and the genome-order windows, and the
CLI's ``.unik`` bytes and error exits.  Exact equality throughout."""

import re

import numpy as np
import pytest
import torch

from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.io.fastx import Record, pack_records
from unikmer_tpu.models import count as jax_count
from unikmer_tpu.taxonomy.lca import device_lca_plan as jax_plan
from unikmer_tpu.taxonomy.taxdump import load_taxonomy
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io.fastx import PackedSeqs, parse_taxid_records
from unikmer_tpu_torch.models import count as port_count
from unikmer_tpu_torch.taxonomy.taxdump import Taxonomy as PortTaxonomy

CPU = torch.device("cpu")
TAXDUMP = "tests/data/taxdump"
RE_TAXID = re.compile(rb"taxid\|(\d+)")
TAXIDS = (511145, 585057, 349741, 562, 511145, 561, 0, 83333)


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def taxdb():
    return load_taxonomy(TAXDUMP)


@pytest.fixture(scope="module")
def port_taxdb(taxdb):
    """The port's Taxonomy from the JAX one's fields."""
    return PortTaxonomy.from_numpy(taxdb.parent, taxdb.depth, taxdb.rank_ids,
                                   taxdb.ranks, taxdb.merged, taxdb.root)


def port_packed(p) -> PackedSeqs:
    """The port's PackedSeqs from a JAX one's fields."""
    return PackedSeqs.from_numpy(p.bases, p.starts, p.lengths)


def random_dna(rng, n, p_invalid=0.0):
    bases = rng.choice(list(b"ACGT"), size=n).astype(np.uint8)
    if p_invalid > 0:
        bases[rng.random(n) < p_invalid] = ord("N")
    return bases.tobytes()


def taxid_records(seed, taxids=TAXIDS, lo=250, hi=1500):
    """Records sharing a 300-base stretch (codes with several taxids),
    N runs, a poly-T run (k = 32 code 2^64-1) and one record shorter
    than any k."""
    rng = np.random.default_rng(seed)
    shared = random_dna(rng, 300)
    recs = []
    for i, t in enumerate(taxids):
        seq = bytearray(shared + random_dna(rng, int(rng.integers(lo, hi)),
                                            p_invalid=0.01))
        if i == 1:
            seq[40:120] = b"T" * 80
        recs.append(Record(b"r%d taxid|%d" % (i, t), b"r%d" % i, bytes(seq)))
    recs.append(Record(b"short taxid|562", b"short", b"ACGT"))
    return recs


def both(recs, k, canonical, mode, taxdb, port_taxdb):
    jcfg = jax_count.CountConfig(k=k, canonical=canonical, mode=mode)
    want = jax_count.count_packed_taxids(iter(recs), jcfg, RE_TAXID, taxdb)
    got = port_count.count_packed_taxids(
        iter(recs), port_count.CountConfig.from_reference(jcfg), RE_TAXID,
        port_taxdb, CPU)
    return got, want


def assert_pair_equal(got, want):
    assert got[0].dtype == np.uint64 and got[1].dtype == np.uint32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


COUNT_CASES = [
    (15, True, "distinct", None),
    (15, True, "unique", "0"),
    (15, True, "repeated", None),
    (15, True, "repeated", "0"),
    (23, True, "distinct", "0"),
    (23, True, "unique", None),
    (32, False, "distinct", None),
    (32, False, "unique", "0"),
    (32, False, "repeated", None),
]


@pytest.mark.parametrize("k,canonical,mode,cap", COUNT_CASES)
def test_count_packed_taxids_matches_jax(taxdb, port_taxdb, monkeypatch, k,
                                         canonical, mode, cap):
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    got, want = both(taxid_records(k), k, canonical, mode, taxdb, port_taxdb)
    assert_pair_equal(got, want)
    assert len(got[0]) > 100
    assert len(np.unique(got[1])) > 1
    if k == 32 and mode != "unique":
        # a real all-ones code (49 poly-T windows) is kept with its
        # record's taxid
        assert got[0][-1] == np.uint64(2**64 - 1) and got[1][-1] == 585057


@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_host_fallback_matches_jax(taxdb, port_taxdb, monkeypatch, mode):
    # an unknown nonzero taxid declines the plan: the host reduction
    # defines the merge, and on a known vocabulary it agrees with the
    # device collapse
    recs = taxid_records(7, taxids=(562, 999999, 511145, 0))
    got, want = both(recs, 15, True, mode, taxdb, port_taxdb)
    assert_pair_equal(got, want)
    assert 999999 in set(got[1])
    cfg = port_count.CountConfig(k=15, canonical=True, mode=mode)
    packed, rec_taxids = parse_taxid_records(
        iter(taxid_records(8)), cfg.k, cfg.circular, cfg.record_gap, RE_TAXID)
    host = port_count.count_taxids_unknown(packed, rec_taxids, cfg,
                                           port_taxdb, CPU)
    device, _ = both(taxid_records(8), 15, True, mode, taxdb, port_taxdb)
    assert_pair_equal(host, device)


@pytest.mark.parametrize("mode", ["distinct", "unique", "repeated"])
def test_streamed_taxids_match_jax(taxdb, port_taxdb, monkeypatch, mode):
    recs = taxid_records(11, lo=250, hi=1700)
    jcfg = jax_count.CountConfig(k=15, canonical=True, mode=mode)
    cfg = port_count.CountConfig.from_reference(jcfg)
    packed, rec_taxids = jax_count.parse_taxid_records(iter(recs), jcfg,
                                                       RE_TAXID)
    assert packed.lengths.max() > 500 + 15  # a record is segmented
    plan = jax_plan(taxdb, rec_taxids)
    want = jax_count.count_taxids_stream_device(
        packed, rec_taxids, jcfg, plan, taxdb, chunk_bases=500)
    ppacked = port_packed(packed)
    got = port_count.count_taxids_stream_device(
        ppacked, rec_taxids, cfg, plan, port_taxdb, chunk_bases=500,
        device=CPU)
    assert_pair_equal(got, want)
    # the router streams past the piece size and agrees with one piece
    one = port_count.count_taxids_from_packed(ppacked, rec_taxids, cfg,
                                              port_taxdb, CPU)
    monkeypatch.setattr(port_count, "_stream_chunk_bases", lambda _dev: 500)
    routed = port_count.count_taxids_from_packed(ppacked, rec_taxids, cfg,
                                                 port_taxdb, CPU)
    assert_pair_equal(routed, one)
    assert_pair_equal(one, want)


def test_split_packed_offsets_match_jax():
    recs = taxid_records(3, lo=100, hi=2000)
    packed = pack_records(recs, 15)
    want = list(jax_count.split_packed(packed, 600, 15, yield_offsets=True))
    got = list(port_count.split_packed(port_packed(packed), 600, 15,
                                       yield_offsets=True))
    assert len(got) == len(want) > 3
    for (gp, go), (wp, wo) in zip(got, want):
        assert go == wo
        np.testing.assert_array_equal(gp.bases, wp.bases)
        np.testing.assert_array_equal(gp.bases,
                                      packed.bases[go:go + len(gp.bases)])


@pytest.mark.parametrize("k,canonical,chunk", [(21, False, None),
                                               (15, True, 700),
                                               (32, False, 333)])
def test_linear_codes_match_jax(k, canonical, chunk):
    packed = pack_records(taxid_records(k, hi=2500), k)
    jcfg = jax_count.CountConfig(k=k, canonical=canonical)
    cfg = port_count.CountConfig.from_reference(jcfg)
    wc, wp = jax_count.linear_codes_all(packed.bases, jcfg, chunk_bases=chunk)
    gc, gp = port_count.linear_codes_all(packed.bases, cfg, chunk_bases=chunk,
                                         device=CPU)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gp, wp)
    assert gc.dtype == np.uint64 and gp.dtype == np.int64 and len(gc) > 1000
    np.testing.assert_array_equal(
        port_count.count_linear(port_packed(packed), cfg, CPU),
        jax_count.count_linear(packed, jcfg))


@pytest.mark.parametrize("kw", [
    dict(k=21, hashed=True, canonical=True),
    dict(k=40, mode="unique"),
    dict(k=21, scale=3, canonical=True, mode="repeated"),
], ids=str)
def test_hashed_taxids_and_linear_match_jax(taxdb, port_taxdb, kw):
    """-T and -l with ntHash codes (H1's plain version) against the JAX
    package's count_packed_taxids and linear_codes_all."""
    recs = taxid_records(kw["k"])
    jcfg = jax_count.CountConfig(**kw)
    cfg = port_count.CountConfig.from_reference(jcfg)
    want = jax_count.count_packed_taxids(iter(recs), jcfg, RE_TAXID, taxdb)
    got = port_count.count_packed_taxids(iter(recs), cfg, RE_TAXID,
                                         port_taxdb, CPU)
    assert_pair_equal(got, want)
    assert len(got[0]) > 20 and len(np.unique(got[1])) > 1
    packed = pack_records(recs, cfg.k)
    wc, wp = jax_count.linear_codes_all(packed.bases, jcfg, chunk_bases=900)
    gc, gp = port_count.linear_codes_all(packed.bases, cfg, chunk_bases=900,
                                         device=CPU)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gp, wp)
    assert len(gc) > 100


@pytest.mark.parametrize("kw", [
    dict(k=21, minimizer_w=5),
    dict(k=31, minimizer_w=15, mode="unique"),
    dict(k=21, syncmer_s=9, mode="repeated"),
    dict(k=21, syncmer_s=11, syncmer_impl="compat"),
], ids=str)
def test_sketch_taxids_and_linear_match_jax(taxdb, port_taxdb, kw):
    """-T and -l -T with sketches (H1 then S1, plain versions) against the
    JAX package: one piece, streamed whole-record pieces, and the
    genome-order windows of records packed with the config's gap."""
    recs = taxid_records(kw["k"] + kw.get("minimizer_w", 0), hi=2500)
    jcfg = jax_count.CountConfig(**kw)
    cfg = port_count.CountConfig.from_reference(jcfg)
    want = jax_count.count_packed_taxids(iter(recs), jcfg, RE_TAXID, taxdb)
    got = port_count.count_packed_taxids(iter(recs), cfg, RE_TAXID,
                                         port_taxdb, CPU)
    assert_pair_equal(got, want)
    assert len(got[0]) > (0 if cfg.mode == "repeated" else 100)
    assert len(np.unique(got[1])) > 1
    packed, rec_taxids = parse_taxid_records(iter(recs), cfg.k, cfg.circular,
                                             cfg.record_gap, RE_TAXID)
    streamed = port_count.count_taxids_stream_device(
        packed, rec_taxids, cfg, jax_plan(taxdb, rec_taxids), port_taxdb,
        chunk_bases=1500, device=CPU)
    assert_pair_equal(streamed, want)
    jpacked = pack_records(recs, cfg.k, gap=cfg.record_gap)
    wc, wp = jax_count.linear_codes_all(jpacked.bases, jcfg, chunk_bases=900)
    gc, gp = port_count.linear_codes_all(jpacked.bases, cfg, chunk_bases=900,
                                         device=CPU)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gp, wp)
    assert len(gc) > 100


# ---------------------------------------------------------------------
# CLI


@pytest.fixture(scope="module")
def taxid_fasta(tmp_path_factory):
    path = tmp_path_factory.mktemp("fa") / "tax.fa"
    with open(path, "wb") as f:
        for rec in taxid_records(99, lo=500, hi=6000):
            f.write(b">" + rec.name + b"\n")
            for i in range(0, len(rec.seq), 70):
                f.write(rec.seq[i:i + 70] + b"\n")
    return str(path)


@pytest.fixture
def envs(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


T = ["-T", "-r", r"taxid\|(\d+)", "--data-dir", TAXDUMP]
CLI_CASES = [
    ["-k", "15", "-K", "-s", *T],
    ["-k", "15", "-K", "-s", "-u", *T],
    ["-k", "15", "-K", "-s", "-d", *T],
    ["-k", "15", "-K", *T],
    ["-k", "21", "-l"],
    ["-k", "15", "-l", *T],
]


@pytest.mark.parametrize("flags", CLI_CASES, ids=lambda f: " ".join(f[:6]))
def test_count_taxid_and_linear_bytes_match_jax_cli(taxid_fasta, envs,
                                                    tmp_path, flags):
    outs = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        prefix = str(tmp_path / name)
        assert main(["count", *flags, "-C", taxid_fasta, "-o", prefix]) == 0
        outs[name] = (tmp_path / f"{name}.unik").read_bytes()
    assert len(outs["port"]) > 1000
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("flags,msg", [
    (["-T", "-r", r"taxid\|(\d+)", "-t", "9606"], "can not be given"),
    (["-T"], "-r/--parse-taxid-regexp needed"),
    (["-T", "-r", "taxid"], 'must contain "(" and ")"'),
    (["-l", "-s"], "are not compatible"),
])
def test_count_checks_exit_like_jax(taxid_fasta, envs, tmp_path, caplog,
                                    flags, msg):
    for main in (jax_main, port_main):
        caplog.clear()
        rc = main(["count", "-k", "15", *flags, "--data-dir", TAXDUMP,
                   taxid_fasta, "-o", str(tmp_path / "x")])
        assert rc != 0 and msg in caplog.text
        assert not (tmp_path / "x.unik").exists()


def test_count_taxid_header_without_taxid_exits(tmp_path, envs, caplog):
    fa = tmp_path / "bad.fa"
    fa.write_text(">r0 taxid|562\nACGTACGTACGTACGTACGT\n>r1 none\n"
                  "ACGTACGTTTACGTACGTAC\n")
    for flags in (["-s"], ["-l"]):
        caplog.clear()
        rc = port_main(["count", "-k", "11", *flags, *T, str(fa),
                        "-o", str(tmp_path / "x")])
        assert rc != 0 and "failed to parse taxid in header: r1" in caplog.text


# ---------------------------------------------------------------------
# on the card


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, "0"])
def test_count_taxids_on_card_matches_cpu(cuda_device, port_taxdb,
                                          monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_TAXID_VOCAB_MAX", cap)
    recs = taxid_records(21, lo=2000, hi=90000)
    for k, canonical, mode in ((23, True, "distinct"), (32, False, "unique"),
                               (15, True, "repeated")):
        cfg = port_count.CountConfig(k=k, canonical=canonical, mode=mode)
        want = port_count.count_packed_taxids(iter(recs), cfg, RE_TAXID,
                                              port_taxdb, CPU)
        got = port_count.count_packed_taxids(iter(recs), cfg, RE_TAXID,
                                             port_taxdb, cuda_device)
        assert_pair_equal(got, want)
