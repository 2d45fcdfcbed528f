"""The port's genome subcommands (``locate``, ``map`` and its alias
``uniqs``, ``view -g``) and their genome index (models/locate.py)
against the JAX package: the same genomes and queries give the same
index columns and lookups, and the same arguments the same stdout
bytes, output files, exit code and log lines, with the native library
on and with UNIKMER_TPU_NO_NATIVE=1.  The port runs on the CPU here
(UNIKMER_TPU_TORCH_DEVICE=cpu: the plain versions of K1, H1, K2 and
K3); the cases marked ``cuda`` run the same on the card.  Every output
is integers or bytes, so every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

# by their own names, as pytest imports the test files: on the card's
# host another package called tests sits on the path
from test_torch_host import cuda_calls_on_cpu  # noqa: F401 (fixture)
from test_torch_textcmds import run_both
from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.models import locate as jax_locate
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.models import locate
from unikmer_tpu_torch.ops import device_sets

CPU = (("UNIKMER_TPU_TORCH_DEVICE", "cpu"),)
CUDA = (("UNIKMER_TPU_TORCH_DEVICE", "cuda"),)


@pytest.fixture(scope="module", autouse=True)
def count_device_route():
    """The port's count on its device route (the kernels' plain versions
    on the CPU); the host engine's cases are in test_torch_count_host.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UNIKMER_TPU_HOST_COUNT", "0")
        yield


def dna(rng, n: int) -> np.ndarray:
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].copy()


def spoil(rng, seq: np.ndarray) -> np.ndarray:
    """The record text of a sequence with a lowercase stretch and an N
    run."""
    seq = seq.copy()
    a = int(rng.integers(0, len(seq) - 120))
    seq[a:a + 100] |= 32
    b = int(rng.integers(0, len(seq) - 30))
    seq[b:b + int(rng.integers(1, 25))] = ord("N")
    return seq


def fasta(records) -> bytes:
    out = []
    for head, seq in records:
        body = bytes(seq)
        lines = [body[i:i + 70] for i in range(0, len(body), 70)]
        out.append(b">" + head + b"\n" + b"".join(x + b"\n" for x in lines))
    return b"".join(out)


def genomes(rng):
    """{name: FASTA text}: g1 with a record repeating a part of itself, a
    plasmid sharing a part of chr1, an empty record and one shorter than
    any k; g2 sharing a part of chr1; g3 only a short record (no record
    kept at k >= 21); and q, the queries' genome, made of parts of g1
    and g2 with substitutions, and a part of its own."""
    chr1 = dna(rng, 3000)
    chr1[2400:2700] = chr1[300:600]  # repeated within the record
    plasmid = dna(rng, 800)
    plasmid[100:400] = chr1[1000:1300]  # shared with chr1
    chr2 = dna(rng, 1500)
    g2a = dna(rng, 1200)
    g2a[500:800] = chr1[1800:2100]
    g2b = dna(rng, 1200)
    g1 = [(b"chr1 main chromosome", spoil(rng, chr1)),
          (b"plasmid p1", spoil(rng, plasmid)),
          (b"empty", b""), (b"short", dna(rng, 12)),
          (b"chr2 second", spoil(rng, chr2))]
    g2 = [(b"g2a", g2a), (b"g2b", spoil(rng, g2b))]
    g3 = [(b"tiny", dna(rng, 15))]
    q = np.concatenate([chr1[:1600], chr2[200:900], g2b[100:700],
                        dna(rng, 400)])
    for i in rng.integers(0, len(q), size=12):
        q[i] = b"ACGT"[(b"ACGT".index(bytes(q[i:i + 1])) + 1) % 4]
    return {"g1": fasta(g1), "g2": fasta(g2), "g3": fasta(g3),
            "q": fasta([(b"q", q)])}


# name -> count flags over q.fa (or, with a genome name first, over it);
# every input is written by both CLIs and the two files must be equal
UNIK_INPUTS = {
    "q21": ["-k", "21", "-K", "-s"],
    "q21u": ["-k", "21", "-K"],  # not sorted
    "q21l": ["-k", "21", "-K", "-l"],  # duplicates within a block
    "q23": ["-k", "23", "-K", "-s"],
    "nc21": ["-k", "21", "-s"],  # not canonical
    "h31": ["-k", "31", "-K", "-H", "-s"],
    "h31g1": ["g1", "-k", "31", "-K", "-H", "-s"],
    "h31nc": ["-k", "31", "-H", "-s"],
    "k40": ["-k", "40", "-K", "-s"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("locate")
    rng = np.random.default_rng(20261019)
    out = {}
    for name, text in genomes(rng).items():
        (d / f"{name}.fa").write_bytes(text)
        out[name] = str(d / f"{name}.fa")
    mp = pytest.MonkeyPatch()
    mp.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    try:
        for name, flags in UNIK_INPUTS.items():
            fa = out["q"]
            if flags[0] in out:
                fa, flags = out[flags[0]], flags[1:]
            files = []
            for side, main in (("jax", jax_main), ("port", port_main)):
                prefix = str(d / f"{name}.{side}")
                assert main(["count", *flags, "-C", fa, "-o", prefix]) == 0
                files.append(Path(prefix + ".unik"))
            assert files[0].read_bytes() == files[1].read_bytes(), name
            out[name] = str(files[1])
    finally:
        mp.undo()
    return out


@pytest.fixture(params=["native", "numpy"])
def host(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    return request.param


# ---------------------------------------------------------------------
# the index and its lookups

INDEX_CASES = [  # (unik input, k, hashed, circular, -B filters)
    ("q21", 21, False, False, ()),
    ("q21", 21, False, True, ()),
    ("q21", 21, False, False, ("PLASMID", "^chr2")),
    ("h31", 31, True, False, ()),
    ("h31", 31, True, True, ("plasmid",)),
    ("k40", 40, True, False, ()),
    ("k40", 40, True, True, ()),
]


def filters(patterns):
    return [re.compile(("(?i)" + p).encode()) for p in patterns]


def same_index(want, got):
    assert np.array_equal(got.host_codes(), want.codes)
    assert got.host_codes().dtype == np.uint64
    assert np.array_equal(got.seq_idx, want.seq_idx)
    assert got.seq_idx.dtype == want.seq_idx.dtype == np.int32
    assert np.array_equal(got.pos, want.pos)
    assert got.pos.dtype == np.int64
    assert got.ids == want.ids and got.sequences == want.sequences
    assert np.array_equal(got.seq_file, want.seq_file)
    assert got.seq_file.dtype == np.int32 and got.k == want.k


def index_pair(inputs, case, device="cpu", files=("g1", "g2", "g3")):
    _, k, hashed, circular, pats = case
    gf = [inputs[f] for f in files]
    want = jax_locate.build_genome_index(gf, k, hashed, circular,
                                         filters(pats))
    got = locate.build_genome_index(gf, k, hashed, circular, filters(pats),
                                    device=device)
    return want, got


@pytest.mark.parametrize("case", INDEX_CASES, ids=str)
def test_genome_index_matches_jax(inputs, host, case):
    want, got = index_pair(inputs, case)
    assert got.route == "device" and isinstance(got.codes, torch.Tensor)
    assert len(want.codes) > 5000 and len(set(want.ids)) >= 3
    same_index(want, got)


def queries(rng, index_codes: np.ndarray, n: int = 3000) -> np.ndarray:
    """Codes of the index (repeated), absent codes, and the extremes."""
    present = index_codes[rng.integers(0, len(index_codes), size=n)]
    absent = rng.integers(0, 1 << 63, size=n // 3, dtype=np.uint64)
    edge = np.array([0, (1 << 64) - 1, index_codes[0], index_codes[-1]],
                    np.uint64)
    q = np.concatenate([present, present[:50], absent, edge])
    return q[rng.permutation(len(q))]


@pytest.mark.parametrize("case", INDEX_CASES[::2], ids=str)
def test_lookups_match_jax(inputs, case):
    want, got = index_pair(inputs, case)
    q = queries(np.random.default_rng(7), want.codes)
    ws, we = jax_locate.lookup_ranges(want, q)
    gs, ge = locate.lookup_ranges(got, q)
    assert np.array_equal(gs, ws) and np.array_equal(ge, we)
    assert (ge - gs).max() >= 2 and (ge == gs).sum() >= 1000
    wf, wi, wp = jax_locate.lookup_hashes(want, q)
    gf, gi, gp = locate.lookup_hashes(got, q)
    assert np.array_equal(gf, wf) and np.array_equal(gi, wi)
    assert np.array_equal(gp, wp)
    sel = np.flatnonzero(gf)[:500]
    assert np.array_equal(got.gather_kmers(gi[sel], gp[sel]),
                          want.gather_kmers(wi[sel], wp[sel]))


def test_empty_genome_gives_empty_columns(inputs):
    """No record kept (g3 is shorter than k): empty columns, as the JAX
    package's, and lookups that find nothing."""
    case = ("q21", 21, False, False, ())
    want, got = index_pair(inputs, case, files=("g3",))
    same_index(want, got)
    assert len(got.seq_idx) == 0
    s, e = locate.lookup_ranges(got, np.array([5, 7], np.uint64))
    assert list(s) == [0, 0] and list(e) == [0, 0]


@pytest.mark.parametrize("how", ["free bytes", "UNIKMER_TPU_MAX_ELEMS"])
def test_index_past_the_budget_takes_the_host_route(inputs, monkeypatch,
                                                    tmp_path, caplog,
                                                    capsysbinary, how):
    """Past the genome_index budget (the free bytes made small, or the
    JAX package's knob) the index is sorted on the host, no K3 runs, and
    it, its lookups and the CLI's outputs equal the JAX package's."""
    if how == "free bytes":
        monkeypatch.setattr(device_sets, "_device_free_bytes",
                            lambda device: 1 << 12)
    else:
        monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", "1000")

    def boom(*a, **kw):
        raise AssertionError("K3 ran past the budget")

    monkeypatch.setattr(locate, "radix_sort_kv_u64", boom)
    for case in INDEX_CASES[:4]:
        want, got = index_pair(inputs, case)
        assert got.route == "host" and isinstance(got.codes, np.ndarray)
        same_index(want, got)
        q = queries(np.random.default_rng(8), want.codes)
        for a, b in zip(locate.lookup_hashes(got, q),
                        jax_locate.lookup_hashes(want, q)):
            assert np.array_equal(a, b)
    for i, argv in enumerate((["locate", "-g", "g1", "-g", "g2", "q21",
                               "q21l"], ["view", "-g", "g1", "h31"])):
        d = tmp_path / str(i)
        d.mkdir()
        _, _, stdout, _ = run_both(argv, inputs, d, caplog, capsysbinary,
                                   port_env=CPU)
        assert len(stdout) > 1000


def test_index_budget_counts_the_joined_bases(inputs, monkeypatch):
    """The route turns at element_budget('genome_index') slots, one a
    base of the joined buffer."""
    gf = [inputs["g1"]]
    seqs = [s for _, _, s in locate.read_genome_records(gf, 21, False, None)]
    slots = len(locate.joined_bases(seqs)[0])
    per = device_sets.SLOT_BYTES["genome_index"]
    for free, route in ((slots * per / device_sets.ADMIT_SHARE + per,
                         "device"), (slots * per - 1, "host")):
        monkeypatch.setattr(device_sets, "_device_free_bytes",
                            lambda device, free=free: int(free))
        assert locate.build_genome_index(gf, 21, False,
                                         device="cpu").route == route


# ---------------------------------------------------------------------
# the CLI against the JAX CLI

LOCATE_CASES = [
    ["locate", "-g", "g1", "q21"],
    ["locate", "-g", "g1", "-g", "g2", "q21", "q21l"],
    ["locate", "-g", "g1", "--circular", "q21u"],
    ["locate", "-B", "plasmid", "-B", "CHR2", "-g", "g1", "-g", "g2", "q21"],
    ["locate", "-B", "(?i)chr", "-g", "g1", "q21l", "q21"],
    ["locate", "-g", "g1", "-g", "g2", "h31", "-o", "{out}/l.bed"],
    ["locate", "-g", "g1", "-g", "g2", "--circular", "k40", "-o",
     "{out}/l.bed.gz"],
    ["locate", "-g", "g3", "q21"],  # no record kept: nothing
    ["locate", "q21"],  # no -g
    ["locate", "-g", "g1", "q21", "q23"],  # k mismatch
    ["locate", "-g", "g1", "nc21"],  # not canonical
]


@pytest.mark.parametrize("argv", LOCATE_CASES, ids=" ".join)
def test_locate_matches_jax_cli(inputs, host, tmp_path, caplog,
                                capsysbinary, argv):
    rc, _, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                    capsysbinary, port_env=CPU)
    assert rc != 0 or "g3" in argv or len(stdout) + sum(
        map(len, files.values())) > 1000


MAP_CASES = [
    ["map", "-g", "g1", "-m", "30", "q21"],
    ["uniqs", "-g", "g1", "-g", "g2", "-m", "30", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-m", "30", "-M", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-W", "-m", "30", "q21"],
    # -W after a file with no kept record: the JAX package's unit list
    # skips that file, so each later file reads the next file's set
    ["map", "-g", "g3", "-g", "g1", "-g", "g2", "-W", "-m", "30", "q21"],
    ["map", "-g", "g1", "-g", "g3", "-g", "g2", "-W", "-m", "25", "q21"],
    ["map", "-g", "g1", "-m", "25", "-a", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-m", "21", "-x", "3", "-X", "2",
     "q21"],
    ["map", "-g", "g1", "-m", "21", "-x", "40", "-X", "1", "-a", "q21u",
     "-o", "{out}/m.fa"],
    ["map", "-g", "g1", "--circular", "-m", "30", "q21"],  # nothing
    ["map", "-g", "g1", "--circular", "-M", "-m", "30", "q21"],
    ["map", "-g", "g1", "--circular", "-M", "-a", "-m", "30", "q21"],
    ["map", "-B", "plasmid", "-g", "g1", "-g", "g2", "-m", "30", "h31",
     "-o", "{out}/m.bed"],
    ["map", "-B", "CHR2", "-g", "g1", "-M", "-m", "40", "k40"],
    ["map", "q21"],  # no -g
    ["map", "-g", "g1", "q21", "q23"],  # k mismatch
    ["map", "-g", "g1", "nc21"],  # not canonical
]


@pytest.mark.parametrize("argv", MAP_CASES, ids=" ".join)
def test_map_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                             argv):
    rc, _, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                    capsysbinary, port_env=CPU)
    if "--circular" in argv and "-M" not in argv:
        assert stdout == b""  # every hit reads as multiply mapped
    else:
        assert rc != 0 or len(stdout) + sum(map(len, files.values())) > 20


MAP_HOST_CASES = [
    ["map", "-g", "g1", "-m", "30", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-m", "30", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-W", "-m", "30", "q21"],
    ["map", "-g", "g3", "-g", "g1", "-g", "g2", "-W", "-m", "30", "q21"],
    ["map", "-g", "g1", "-g", "g2", "-m", "21", "-x", "3", "-X", "2",
     "-a", "q21"],
    ["map", "-g", "g1", "--circular", "-M", "-m", "30", "q21"],
    ["map", "-B", "plasmid", "-g", "g1", "-g", "g2", "-m", "30", "h31"],
]


def joined_len(inputs, name: str, k: int = 21) -> int:
    recs = locate.read_genome_records([inputs[name]], k, False, None)
    return len(locate.joined_bases([s for _, _, s in recs])[0])


@pytest.mark.parametrize("budget", ["none", "between"])
@pytest.mark.parametrize("argv", MAP_HOST_CASES, ids=" ".join)
def test_map_past_the_budget_takes_the_host_route(inputs, host, tmp_path,
                                                  caplog, capsysbinary,
                                                  monkeypatch, argv, budget):
    """Past element_budget('map') a genome file's windows are fetched and
    its membership, hit runs and terminators run in numpy (no K3), with
    the JAX CLI's bytes: every file on the host route (budget 'none'), or
    g2 on the card and g1 on the host ('between', so -W reads a
    multiply-mapped set across the two routes)."""
    from unikmer_tpu_torch.cli.commands import map as map_cmd

    g1, g2 = joined_len(inputs, "g1"), joined_len(inputs, "g2")
    limit = 1000 if budget == "none" else (g1 + g2) // 2
    assert limit < g2 if budget == "none" else g2 <= limit < g1
    routes = []

    class Spy(map_cmd.GenomeScan):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            routes.append(self.routes)

    def boom(*a, **kw):
        raise AssertionError("K3 ran on the host route")

    monkeypatch.setattr(map_cmd, "GenomeScan", Spy)
    if budget == "none":
        # map imports K3's wrapper at the call: the spy sits in its module
        from unikmer_tpu_torch.ops import radix_sort

        monkeypatch.setattr(radix_sort, "radix_sort_kv_u64", boom)
    rc, _, stdout, files = run_both(
        argv, inputs, tmp_path, caplog, capsysbinary,
        port_env=CPU + (("UNIKMER_TPU_MAX_ELEMS", str(limit)),))
    assert rc == 0 and len(stdout) + sum(map(len, files.values())) > 20
    want = {"g1": "host", "g2": "host" if budget == "none" else "device"}
    genomes = [argv[i + 1] for i, a in enumerate(argv) if a == "-g"]
    assert routes[0] == {i: want[g] for i, g in enumerate(genomes)
                         if g != "g3"}


def test_map_budget_counts_the_joined_bases(inputs, monkeypatch):
    """The route turns at element_budget('map') slots, one a base of a
    genome file's joined records, less the query set's bytes."""
    from unikmer_tpu_torch.cli.commands import map as map_cmd
    from unikmer_tpu_torch.models.count import CountConfig

    recs = [(rec, seq) for _, rec, seq in locate.read_genome_records(
        [inputs["g1"]], 21, False, None)]
    slots = joined_len(inputs, "g1")
    query = torch.arange(100, dtype=torch.int64)
    per = device_sets.SLOT_BYTES["map"]
    for free, route in (((slots * per + 800) / device_sets.ADMIT_SHARE + per,
                         "device"), (slots * per + 800 - 1, "host")):
        monkeypatch.setattr(device_sets, "_device_free_bytes",
                            lambda device, free=free: int(free))
        scan = map_cmd.GenomeScan([recs], CountConfig(k=21, canonical=True),
                                  query, torch.device("cpu"), False)
        scan.masks(0, 0)
        assert scan.routes == {0: route}


def test_map_terminates_regions_at_repeats(inputs, tmp_path, caplog,
                                           capsysbinary):
    """The queries hit chr1's stretch 300-600, which chr1 repeats at
    2400: without -M its k-mers are terminators, so no region covers
    either copy; with -M both copies map."""
    got = {}
    for flags in ([], ["-M"]):
        d = tmp_path / str(len(flags))
        d.mkdir()
        _, _, stdout, _ = run_both(["map", "-g", "g1", "-m", "21", *flags,
                                    "q21"], inputs, d, caplog, capsysbinary,
                                   port_env=CPU)
        got[len(flags)] = stdout
    assert b"chr1\t2399\t" in got[1] and b"chr1\t2399\t" not in got[0]
    assert b"chr1\t19\t367\n" in got[1] and b"chr1\t19\t319\n" in got[0]


VIEW_G_CASES = [
    ["view", "-g", "g1", "h31g1"],  # every hash found
    ["view", "-g", "g1", "-g", "g2", "h31"],  # some missing: warnings
    ["view", "-g", "g1", "-n", "h31"],
    ["view", "-g", "g1", "-N", "h31"],
    ["view", "-g", "g1", "-a", "h31"],
    ["view", "-g", "g1", "-q", "h31g1", "-o", "{out}/v.fq"],
    ["view", "-g", "g1", "-q", "h31"],
    ["view", "-g", "g1", "-a", "h31g1"],
    ["view", "-g", "g1", "-g", "g2", "k40"],
    ["view", "-g", "g1", "q21"],  # not hashed: ignored with a warning
    ["view", "-g", "g1", "h31nc"],  # not canonical: ignored with a warning
]


@pytest.mark.parametrize("argv", VIEW_G_CASES, ids=" ".join)
def test_view_genome_matches_jax_cli(inputs, host, tmp_path, caplog,
                                     capsysbinary, argv):
    rc, logs, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                       capsysbinary, port_env=CPU)
    assert rc == 0 and len(stdout) + sum(map(len, files.values())) > 1000
    missing = sum("fail to decode hash" in m for _, m in logs)
    assert (missing > 0) == ("h31" in argv or "k40" in argv)


def test_view_genome_warns_once_a_missing_hash(inputs, tmp_path, caplog,
                                               capsysbinary):
    """Every hash of h31 that g1 lacks prints as its integer, after one
    warning naming it; the rest print as g1's k-mers."""
    _, logs, stdout, _ = run_both(["view", "-g", "g1", "h31"], inputs,
                                  tmp_path, caplog, capsysbinary,
                                  port_env=CPU)
    warned = [m for _, m in logs if "fail to decode hash" in m]
    lines = stdout.decode().splitlines()
    ints = [x for x in lines if x.isdigit()]
    assert len(warned) == len(ints) > 10
    assert len(lines) - len(ints) > 1000
    assert all(len(x) == 31 for x in lines if not x.isdigit())


def test_every_genome_command_is_registered():
    from unikmer_tpu_torch.cli.main import build_parser

    sub = next(a for a in build_parser()._actions
               if a.dest == "command").choices
    assert {"locate", "map", "uniqs"} <= set(sub)
    assert sub["uniqs"] is sub["map"]


# ---------------------------------------------------------------------
# on the card

@pytest.mark.cuda
@pytest.mark.parametrize("case", INDEX_CASES, ids=str)
def test_genome_index_on_the_card_matches_jax(inputs, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    want, got = index_pair(inputs, case, device="cuda")
    assert got.route == "device" and got.codes.is_cuda
    same_index(want, got)
    q = queries(np.random.default_rng(9), want.codes)
    for a, b in zip(locate.lookup_hashes(got, q),
                    jax_locate.lookup_hashes(want, q)):
        assert np.array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("argv", LOCATE_CASES[:7] + MAP_CASES[:14]
                         + VIEW_G_CASES[:8], ids=" ".join)
def test_genome_commands_on_the_card_match_jax_cli(inputs, tmp_path, caplog,
                                                   capsysbinary, argv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run_both(argv, inputs, tmp_path, caplog, capsysbinary, port_env=CUDA)


def test_genome_commands_need_a_card_or_the_cpu(inputs, monkeypatch,
                                                tmp_path):
    """Without a card and without UNIKMER_TPU_TORCH_DEVICE=cpu the
    commands refuse to run: no quiet fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cuda")
    for argv in (["locate", "-g", inputs["g1"], inputs["q21"]],
                 ["map", "-g", inputs["g1"], inputs["q21"]],
                 ["view", "-g", inputs["g1"], inputs["h31"]]):
        out = tmp_path / "o.txt"
        with pytest.raises(RuntimeError, match="is_available"):
            port_main([*argv, "-o", str(out)])
        assert not out.exists() or out.read_bytes() == b""


# ---------------------------------------------------------------------
# chip_smoke.py's genome phase, small, on the CPU

def test_chip_smoke_genome_path_on_the_cpu(tmp_path, cuda_calls_on_cpu):
    """genome_path over records made as the sets path makes A and B:
    every call's output equals its oracle (terminators within records
    and, under -W, across them; map once forced to its host route), each
    call is timed with its route and the files it made are removed."""
    import chip_smoke

    rng = np.random.default_rng(44)
    a, b, _ = chip_smoke.set_bases(rng, 60000)
    a_fa = str(tmp_path / "setA.fa")
    chip_smoke.write_one_record(a_fa, "A", a)
    sets = {"a_fa": a_fa,
            "a": (chip_smoke.numpy_count(a, 23, True, "distinct"), None),
            "b": (chip_smoke.numpy_count(b, 23, True, "distinct"), None)}
    got = chip_smoke.genome_path(str(tmp_path), rng, sets,
                                 torch.device("cpu"), n_query=4096,
                                 m_records=12, m_bases=1500)
    calls = got["row"]["calls"]
    assert set(calls) == {
        "locate", "locate --circular", "locate q1 q2",
        "locate (forced host)", "map -x 5 -X 2", "map -M", "map -a",
        "map M", "map M -W", "map M (forced host)", "count -k 31 -K -H",
        "view -g"}
    assert calls["locate"]["route"] == calls["view -g"]["route"] == "device"
    assert calls["locate (forced host)"]["route"] == "host"
    assert calls["map M"]["route"] == ["device"]
    assert calls["map M (forced host)"]["route"] == ["host"]
    assert calls["locate"]["windows"] == 60000 - 22
    assert {"index encode", "index sort", "index fetch",
            "lookup"} <= set(calls["locate"]["stages"])
    assert {"map query", "map encode", "map member", "map multi",
            "map fetch"} <= set(calls["map M"]["stages"])
    assert not list(tmp_path.iterdir())


def test_slot_bytes_measures_map_on_the_cpu(tmp_path, monkeypatch):
    """slot_bytes.map_peak (the card's measurement of SLOT_BYTES['map'])
    runs map's device route over a FASTA's records, every window in the
    query set: (the joined bases, the peak less the query set's bytes)."""
    from unikmer_tpu_torch import slot_bytes

    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a, **kw: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 1 << 20)
    rng = np.random.default_rng(46)
    fa = tmp_path / "g.fa"
    fa.write_bytes(fasta([(b"r%d" % i, dna(rng, 3000)) for i in range(2)]))
    slots, peak = slot_bytes.map_peak(str(fa), torch.device("cpu"))
    assert slots == 2 * 3001
    assert (1 << 20) - 8 * 2 * 2978 <= peak < (1 << 20) - 8 * 5000
