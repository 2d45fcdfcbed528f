"""The port's split-and-merge subcommands (``sort``, ``split``, ``merge``,
``tsplit``) against ``unikmer_tpu.cli.main``: the same arguments give the
same stdout bytes, output files (gzip inflated: the JAX package deflates
with libdeflate, the port with zlib; temporary and chunk files kept with
-k are compared too), exit code and log lines.  Inputs are seeded .unik
files of a few thousand codes, written in blocks of a few hundred so
that chunks and merges cross block bounds."""

import shutil

import numpy as np
import pytest

from tests.test_torch_textcmds import _inflated, run_both
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import unik

TAXDUMP = "tests/data/taxdump"
# taxids of tests/data/taxdump (a strain under a species under a genus,
# siblings and cousins) and 0, the LCA's identity
TAXIDS = np.array([562, 83333, 511145, 585057, 349741, 239935, 561, 2, 0],
                  np.uint32)


def write_unik(path, codes, taxids=None, k=23, flag=unik.CANONICAL,
               compress=False, block=700, **kw):
    with unik.UnikWriter(str(path), k=k, flag=flag | (
            unik.INCLUDE_TAXID if taxids is not None else 0),
                         max_taxid=(1 << 32) - 1 if taxids is not None else 0,
                         compress=compress, block_size=block, **kw) as w:
        w.write_codes(codes, taxids)
    return str(path)


def sorted_unique(codes, taxids=None):
    codes, first = np.unique(codes, return_index=True)
    return codes, None if taxids is None else taxids[first]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Unsorted inputs with duplicates (within a file and across files),
    with and without per-code taxids, with a global taxid, gzipped, of
    another k, hashed, sorted, and a file that is not sorted among
    sorted ones."""
    d = tmp_path_factory.mktemp("filecmds")
    rng = np.random.default_rng(20261017)
    pool = rng.integers(0, 1 << 46, size=2500, dtype=np.uint64)
    a = pool[rng.integers(0, len(pool), size=3000)]
    b = pool[rng.integers(0, len(pool), size=2000)]
    ta = rng.choice(TAXIDS, size=len(a))
    tb = rng.choice(TAXIDS, size=len(b))
    out = {
        "a": write_unik(d / "a.unik", a),
        "b": write_unik(d / "b.unik", b),
        "at": write_unik(d / "at.unik", a, ta),
        "bt": write_unik(d / "bt.unik", b, tb),
        "ag": write_unik(d / "ag.unik", a, global_taxid=562),
        "bg": write_unik(d / "bg.unik", b, global_taxid=585057),
        "agz": write_unik(d / "agz.unik", a, compress=True),
        "c21": write_unik(d / "c21.unik", a >> np.uint64(4), k=21),
        "h31": write_unik(d / "h31.unik", rng.integers(
            0, 1 << 64, size=1500, dtype=np.uint64), k=31,
                          flag=unik.CANONICAL | unik.HASHED),
        "empty": write_unik(d / "empty.unik", a[:0]),
    }
    for name, codes, taxids in (("sa", a, None), ("sb", b, None),
                                ("sat", a, ta), ("sbt", b, tb)):
        c, t = sorted_unique(codes, taxids)
        out[name] = write_unik(d / f"{name}.unik", c, t,
                               flag=unik.CANONICAL | unik.SORTED, block=300)
    chunks = d / "chunks"
    chunks.mkdir()
    # a directory of sorted chunk files, listed out of order, and files
    # the default pattern skips
    for i, (lo, hi) in enumerate(((0, 900), (900, 2000), (2000, 3000))):
        c = np.sort(a[lo:hi])
        write_unik(chunks / f"chunk_{2 - i:03d}.unik", c,
                   flag=unik.CANONICAL | unik.SORTED, block=250)
    write_unik(chunks / "part_7.unik", np.sort(b),
               flag=unik.CANONICAL | unik.SORTED)
    (chunks / "chunk_x.unik").write_bytes(b"")
    out["chunks"] = str(chunks)
    return out


def test_inputs_are_what_the_cases_need(inputs):
    with unik.UnikReader(inputs["a"]) as r:
        blocks = [c for c, _ in r.iter_blocks()]
    codes = np.concatenate(blocks)
    assert len(blocks) > 3 and len(np.unique(codes)) < len(codes)
    with unik.UnikReader(inputs["sat"]) as r:
        assert r.header.is_sorted and r.header.is_include_taxid


SORT_CASES = [
    ["sort", "a", "b", "-C"],
    ["sort", "-u", "a", "b"],
    ["sort", "-d", "a", "b", "-C", "-o", "{out}/s"],
    ["sort", "-u", "at", "bt", "--data-dir", TAXDUMP, "-C"],
    ["sort", "-d", "at", "bt", "--data-dir", TAXDUMP, "-C"],
    ["sort", "at", "bt", "-C"],
    ["sort", "-u", "ag", "bg", "--data-dir", TAXDUMP, "-C", "-o", "{out}/s"],
    ["sort", "-u", "-I", "at", "b", "-C"],
    ["sort", "-u", "agz", "b", "-o", "{out}/s"],
    ["sort", "-u", "h31", "-C"],
    ["sort", "-u", "empty", "-C"],
    ["sort", "-u", "-d", "a"],
    ["sort", "a", "c21"],  # incompatible k
    ["sort", "at", "b"],  # taxids in one file only
    ["sort", "-u", "at", "--data-dir", "{out}/none"],  # no nodes.dmp
    # external: chunks of exactly -m codes, cascades past -M files
    ["sort", "-m", "1000", "-t", "{out}/tmp", "-k", "a", "b", "-C"],
    ["sort", "-u", "-m", "1K", "-t", "{out}/tmp", "-M", "2", "a", "b", "-C",
     "-o", "{out}/s", "--verbose"],
    ["sort", "-d", "-m", "700", "-t", "{out}/tmp", "-M", "3", "-k", "a", "b",
     "-C", "-o", "{out}/s"],
    ["sort", "-u", "-m", "900", "-t", "{out}/tmp", "-M", "2", "at", "bt",
     "--data-dir", TAXDUMP, "-C", "-o", "{out}/s", "-k"],
    ["sort", "-u", "-m", "900", "-t", "{out}/tmp", "ag", "bg", "--data-dir",
     TAXDUMP, "-o", "{out}/s"],
    ["sort", "-m", "1000", "-t", "{out}/tmp", "--compression-level", "9",
     "-k", "a", "-o", "{out}/s"],  # the chunks at level 1
    ["sort", "-m", "0", "a", "-t", "{out}/tmp"],
    ["sort", "-m", "1x", "a", "-t", "{out}/tmp"],
    ["sort", "-m", "1000", "-t", "{out}/tmp", "at", "b", "-C"],
    ["sort", "-m", "1000", "-t", "{out}/tmp", "a", "c21", "-C"],
]


@pytest.mark.parametrize("argv", SORT_CASES, ids=" ".join)
def test_sort_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary, argv):
    rc, _, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                    capsysbinary)
    if rc == 0 and "empty" not in argv:
        assert len(stdout) + sum(map(len, files.values())) > 1000


@pytest.mark.parametrize("force", [False, True])
def test_sort_tmp_dir_not_empty(inputs, tmp_path, caplog, capsysbinary,
                                force):
    def prepare(d):
        (d / "tmp" / "s.unik.tmp").mkdir(parents=True)
        (d / "tmp" / "s.unik.tmp" / "old").write_bytes(b"x")

    rc, log, _, files = run_both(
        ["sort", "-m", "1000", "-t", "{out}/tmp", "a", "-C", "-o", "{out}/s",
         *(["--force"] if force else [])], inputs, tmp_path, caplog,
        capsysbinary, prepare=prepare)
    assert (rc == 0) == force
    assert force or "tmp dir not empty" in log[-1][1]


def test_sort_writes_sorted_unique_codes(inputs, tmp_path):
    out = tmp_path / "s"
    assert port_main(["sort", "-u", "-m", "700", "-M", "2", "-t",
                      str(tmp_path), inputs["a"], inputs["b"], "-o",
                      str(out)]) == 0
    with unik.UnikReader(inputs["a"]) as ra, unik.UnikReader(
            inputs["b"]) as rb, unik.UnikReader(str(out) + ".unik") as r:
        want = np.unique(np.concatenate([ra.read_all()[0],
                                         rb.read_all()[0]]))
        assert r.header.is_sorted
        np.testing.assert_array_equal(r.read_all()[0], want)


SPLIT_MERGE_CASES = [
    # (split, merge -D of its directory, the sort that writes the same
    # bytes: the same chunks, merged the same way)
    (["split", "-m", "1000", "a", "b", "-O", "{out}/parts", "-C"],
     ["merge", "-D", "{out}/parts", "-C", "-o", "{out}/m"],
     ["sort", "-m", "1000", "a", "b", "-C"]),
    (["split", "-u", "-m", "800", "a", "b", "-O", "{out}/parts"],
     ["merge", "-u", "-D", "{out}/parts", "-o", "{out}/m", "--verbose"],
     ["sort", "-u", "-m", "800", "a", "b"]),
    (["split", "-d", "-m", "600", "a", "b", "-O", "{out}/parts", "-C"],
     ["merge", "-d", "-D", "{out}/parts", "-M", "2", "-t", "{out}/tmp", "-C",
      "-o", "{out}/m", "-k"],
     ["sort", "-d", "-m", "600", "-M", "2", "a", "b", "-C"]),
    (["split", "-u", "-m", "900", "at", "bt", "-O", "{out}/parts", "-C",
      "--data-dir", TAXDUMP],
     ["merge", "-u", "-D", "{out}/parts", "-M", "2", "-t", "{out}/tmp",
      "--data-dir", TAXDUMP, "-C", "-o", "{out}/m"],
     ["sort", "-u", "-m", "900", "-M", "2", "at", "bt", "--data-dir",
      TAXDUMP, "-C"]),
    (["split", "-m", "2K", "sa", "-O", "{out}/parts", "-C", "--verbose"],
     ["merge", "-D", "{out}/parts", "-C", "-o", "{out}/m"],
     ["sort", "-m", "2K", "sa", "-C"]),
    # no -m: one chunk, in the default <file>.split directory
    (["split", "-u", "{out}/a.unik", "-C"],
     ["merge", "-u", "-D", "{out}/a.unik.split", "-C", "-o", "{out}/m"],
     ["sort", "-u", "-m", "1G", "a", "-C"]),
]


@pytest.mark.parametrize("steps", SPLIT_MERGE_CASES,
                         ids=lambda s: " | ".join(" ".join(a) for a in s))
def test_split_then_merge_matches_jax_cli(inputs, tmp_path, caplog,
                                          capsysbinary, steps):
    """Both CLIs split in a directory of their own and merge what they
    split; the merged file has the bytes of sort -m over the same inputs
    (the same chunks, merged the same way)."""
    split, merge, sort = steps
    for i in (0, 1):
        (tmp_path / str(i)).mkdir()
    run_both(split, inputs, tmp_path / "0", caplog, capsysbinary,
             prepare=lambda d: shutil.copy(inputs["a"], d / "a.unik"))
    files = run_both(merge, inputs, tmp_path / "1", caplog, capsysbinary,
                     prepare=lambda d: shutil.copytree(
                         tmp_path / "0" / d.name, d, dirs_exist_ok=True))[3]
    out = tmp_path / "sorted"
    assert port_main([*[inputs.get(a, a) for a in sort], "-t", str(tmp_path),
                      "-o", str(out)]) == 0
    assert files["m.unik"] == _inflated(out.with_suffix(".unik").read_bytes())
    assert len(files["m.unik"]) > 1000


SPLIT_CASES = [
    ["split", "-u", "-d", "a"],
    ["split", "a", "c21", "-O", "{out}/p"],
    ["split", "at", "b", "-O", "{out}/p"],
    ["split", "-m", "1x", "a", "-O", "{out}/p"],
    ["split", "-m", "500", "ag", "b", "-I", "-O", "{out}/p", "-C"],
    ["split", "-m", "700", "agz", "-O", "{out}/p"],
]


@pytest.mark.parametrize("argv", SPLIT_CASES, ids=" ".join)
def test_split_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary, argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


@pytest.mark.parametrize("force", [False, True])
def test_split_out_dir_not_empty(inputs, tmp_path, caplog, capsysbinary,
                                 force):
    def prepare(d):
        (d / "p").mkdir()
        (d / "p" / "chunk_000.unik").write_bytes(b"old")

    rc, log, _, files = run_both(
        ["split", "-m", "1000", "a", "-O", "{out}/p", "-C",
         *(["--force"] if force else [])], inputs, tmp_path, caplog,
        capsysbinary, prepare=prepare)
    assert (rc == 0) == force
    assert files["p/chunk_000.unik"] != b"old" if force else (
        "outdir not empty" in log[-1][1])


MERGE_CASES = [
    ["merge", "sa", "sb", "-C"],
    ["merge", "-u", "sa", "sb"],
    ["merge", "-d", "sa", "sb", "-C", "-o", "{out}/m"],
    ["merge", "-u", "sat", "sbt", "--data-dir", TAXDUMP, "-C"],
    ["merge", "-u", "-M", "2", "-t", "{out}/tmp", "-k", "-D", "chunks", "-C",
     "-o", "{out}/m"],
    ["merge", "-u", "-M", "2", "-t", "{out}/tmp", "sat", "sbt", "sat",
     "--data-dir", TAXDUMP, "-C", "-o", "{out}/m"],
    ["merge", "-D", "chunks", "-C", "--verbose", "-o", "{out}/m"],
    ["merge", "-u", "-D", "-p", r"^(chunk|part)_\d+\.unik$", "chunks", "-C"],
    ["merge", "-D", "-p", "part", "chunks", "-C"],
    ["merge", "-D", "-p", "nothing", "chunks"],  # no chunk files
    ["merge", "-D", "sa"],  # not a directory
    ["merge", "-", "sa", "sb", "-C"],  # stdin skipped with a warning
    ["merge", "sa", "a"],  # not sorted
    ["merge", "sa", "sat"],  # taxids in one file only
    ["merge", "-u", "-d", "sa"],
]


@pytest.mark.parametrize("argv", MERGE_CASES, ids=" ".join)
def test_merge_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary, argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


TSPLIT_CASES = [
    ["tsplit", "at", "-O", "{out}/t", "-C", "--verbose"],
    ["tsplit", "at", "bt", "-O", "{out}/t", "-o", "x", "-j", "3"],
    ["tsplit", "ag", "bg", "-O", "{out}/t", "-C"],
    ["tsplit", "sat", "-O", "{out}/t", "-C", "-j", "1"],
    ["tsplit", "{out}/at.unik", "-C"],  # the default <file>.tsplit
    ["tsplit", "a", "-O", "{out}/t"],  # no taxids
    ["tsplit", "-I", "at", "-O", "{out}/t"],
    ["tsplit", "at", "c21", "-O", "{out}/t"],
    ["tsplit", "empty", "-O", "{out}/t"],
]


@pytest.mark.parametrize("argv", TSPLIT_CASES, ids=" ".join)
def test_tsplit_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary,
                                argv):
    def prepare(d):
        shutil.copy(inputs["at"], d / "at.unik")

    rc, _, _, files = run_both(argv, inputs, tmp_path, caplog, capsysbinary,
                               prepare=prepare)
    if rc == 0 and "empty" not in argv:
        assert len([f for f in files if ".taxid-" in f]) > 1


def test_tsplit_files_hold_each_taxids_codes(inputs, tmp_path):
    """tsplit's file of taxid t holds the input's codes with taxid t, in
    input order, under a global taxid t."""
    assert port_main(["tsplit", inputs["at"], "-O", str(tmp_path / "t"),
                      "-j", "4"]) == 0
    with unik.UnikReader(inputs["at"]) as r:
        codes, taxids = r.read_all()
    for t in np.unique(taxids):
        path = tmp_path / "t" / f"tsplit.taxid-{t}.k23.unik"
        with unik.UnikReader(str(path)) as r:
            assert r.header.global_taxid == t
            np.testing.assert_array_equal(r.read_all()[0], codes[taxids == t])
