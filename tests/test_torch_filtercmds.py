"""The port's subset subcommands (``head``, ``sample``, ``filter``,
``rfilter``) against ``unikmer_tpu.cli.main``: the same arguments give the
same stdout bytes, output files (gzip inflated), exit code and log
lines.  ``filter``'s mask runs on the port's device, the CPU here
(UNIKMER_TPU_TORCH_DEVICE=cpu); ``rfilter`` reads a copy of
tests/data/taxdump, and a copy without ranks.txt where it writes the
default rank file."""

import io
import shutil

import numpy as np
import pytest
import torch

from tests.test_torch_filecmds import write_unik
from tests.test_torch_textcmds import run_both
from unikmer_tpu_torch.cli.commands import filter as port_filter
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.io import unik

CPU = (("UNIKMER_TPU_TORCH_DEVICE", "cpu"),)
# every node of tests/data/taxdump, 0 and a taxid it lacks
TAXIDS = np.array([1, 131567, 2, 1224, 1236, 91347, 543, 561, 562, 83333,
                   511145, 585057, 74201, 203494, 48461, 1647988, 239934,
                   239935, 349741, 0, 999999], np.uint32)


def codes_of(bases: np.ndarray) -> np.ndarray:
    """2-bit codes of rows of bases (0-3), the first base highest."""
    k = bases.shape[1]
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    return np.bitwise_or.reduce(bases.astype(np.uint64) << shifts, axis=1)


def low_complexity_rich(rng, n: int, k: int) -> np.ndarray:
    """k-mers of which about half are made of runs (homopolymers and
    repeats a few bases long), the rest random."""
    bases = rng.integers(0, 4, size=(n, k), dtype=np.uint8)
    for i in range(0, n, 2):
        run = rng.integers(1, 5)
        start = rng.integers(0, k)
        bases[i, start:] = np.resize(bases[i, :run], k - start)
    return codes_of(bases)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("filtercmds")
    rng = np.random.default_rng(20261018)
    a = low_complexity_rich(rng, 3000, 23)
    b = low_complexity_rich(rng, 2000, 23)
    ta = rng.choice(TAXIDS, size=len(a))
    tb = rng.choice(TAXIDS, size=len(b))
    sat = np.unique(a, return_index=True)
    out = {
        "a": write_unik(d / "a.unik", a),
        "b": write_unik(d / "b.unik", b),
        "at": write_unik(d / "at.unik", a, ta),
        "bt": write_unik(d / "bt.unik", b, tb),
        "ag": write_unik(d / "ag.unik", a, global_taxid=562),
        "bg": write_unik(d / "bg.unik", b, global_taxid=585057),
        "agz": write_unik(d / "agz.unik", a, compress=True),
        "sat": write_unik(d / "sat.unik", sat[0], ta[sat[1]],
                          flag=unik.CANONICAL | unik.SORTED, block=300),
        "c21": write_unik(d / "c21.unik", low_complexity_rich(rng, 900, 21),
                          k=21),
        "k5": write_unik(d / "k5.unik", low_complexity_rich(rng, 900, 5),
                         k=5, flag=0),
        "h31": write_unik(d / "h31.unik", rng.integers(
            0, 1 << 62, size=1500, dtype=np.uint64), k=31, scale=4,
                          flag=unik.CANONICAL | unik.HASHED),
    }
    taxdump = d / "taxdump"
    shutil.copytree("tests/data/taxdump", taxdump)
    out["taxdump"] = str(taxdump)
    rank_files = {
        "ranks_short": "!no rank\nsuperkingdom\nphylum\nclass\norder\n"
                       "family\ngenus\nspecies\nstrain\n",
        "ranks_dup": "genus\nspecies,genus\n",
        "ranks_none": "# nothing\n\n!no rank\n",
    }
    for name, text in rank_files.items():
        (d / name).write_text(text)
        out[name] = str(d / name)
    return out


HEAD_CASES = [
    ["head", "a", "-C"],
    ["head", "-n", "1500", "a", "-C", "-o", "{out}/h"],
    ["head", "-n", "4000", "a", "b"],
    ["head", "-n", "0", "a", "-C"],
    ["head", "-n", "100000", "a", "b", "-C", "--verbose", "-o", "{out}/h"],
    ["head", "-n", "800", "at", "-C"],
    ["head", "-n", "3200", "ag", "bg", "-C"],
    ["head", "-n", "3200", "ag", "b", "-I", "-C"],
    ["head", "-n", "900", "h31", "-C"],
    ["head", "-n", "5", "sat", "-C"],
    ["head", "-n", "3100", "agz", "b"],
    ["head", "a", "c21"],  # done before c21 is opened
    ["head", "-n", "5000", "a", "c21"],
    ["head", "-n", "5000", "at", "b"],
]


@pytest.mark.parametrize("argv", HEAD_CASES, ids=" ".join)
def test_head_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary, argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


SAMPLE_CASES = [
    ["sample", "a", "-C"],
    ["sample", "-s", "3", "-w", "7", "a", "b", "-C", "-o", "{out}/s"],
    ["sample", "-s", "700", "-w", "50", "at", "bt", "-C", "--verbose"],
    ["sample", "-w", "3", "ag", "bg"],
    ["sample", "-w", "2", "sat", "-C"],
    ["sample", "-w", "4", "h31", "-C"],
    ["sample", "-s", "5000", "a", "-C"],  # past every file: nothing kept
    ["sample", "-s", "0", "a"],
    ["sample", "-w", "0", "a"],
    ["sample", "a", "c21"],
    ["sample", "at", "b"],
]


@pytest.mark.parametrize("argv", SAMPLE_CASES, ids=" ".join)
def test_sample_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary,
                                argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


FILTER_CASES = [
    ["filter", "a", "-C"],
    ["filter", "-v", "a", "-C", "-o", "{out}/f", "--verbose"],
    ["filter", "-t", "10", "-w", "5", "-s", "2", "-d", "2", "a", "-C"],
    ["filter", "-v", "-t", "30", "-w", "12", "-s", "4", "-d", "0", "a", "-C"],
    ["filter", "-t", "0", "a", "-C"],
    ["filter", "-w", "1", "-v", "a", "-C"],
    ["filter", "at", "-C"],
    ["filter", "-v", "ag", "-C"],
    ["filter", "sat", "-C"],
    ["filter", "agz"],
    ["filter", "k5", "-C"],  # window 7 > k 5: a warning
    ["filter", "-w", "30", "-v", "c21", "-C"],
    ["filter", "h31"],  # hashed: the exit
    ["filter", "a", "b"],
    ["filter", "-t", "-1", "a"],
]


@pytest.mark.parametrize("argv", FILTER_CASES, ids=" ".join)
def test_filter_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary,
                                argv):
    rc, _, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                    capsysbinary, port_env=CPU)
    if rc == 0:
        src = next(inputs[a] for a in argv if a in inputs)
        with unik.UnikReader(src) as r:
            n_in = sum(len(c) for c, _ in r.iter_blocks())
        with unik.UnikReader(io.BytesIO(stdout or files["f.unik"])) as r:
            n_out = sum(len(c) for c, _ in r.iter_blocks())
        assert n_out <= n_in
        if not {"-t", "-w", "k5", "c21"} & set(argv):
            # at the defaults a 23-mer input keeps some codes, drops some
            assert 0 < n_out < n_in


def test_filter_mask_runs_on_the_port_device(inputs, tmp_path, monkeypatch):
    """One mask call a block of the input, each on get_device()'s device,
    and one write_codes a block."""
    seen, written = [], []
    real = port_filter.low_complexity_mask
    real_write = unik.UnikWriter.write_codes

    def spy(codes, *args):
        seen.append((codes.device.type, codes.dtype, len(codes)))
        return real(codes, *args)

    def write_spy(self, codes, taxids=None):
        written.append(len(codes))
        return real_write(self, codes, taxids)

    monkeypatch.setattr(port_filter, "low_complexity_mask", spy)
    monkeypatch.setattr(unik.UnikWriter, "write_codes", write_spy)
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    assert port_main(["filter", inputs["a"], "-o",
                      str(tmp_path / "f")]) == 0
    with unik.UnikReader(inputs["a"]) as r:
        blocks = [len(c) for c, _ in r.iter_blocks()]
    assert seen == [("cpu", torch.int64, n) for n in blocks]
    assert len(written) == len(blocks) > 3


def test_filter_without_a_card_exits(inputs, tmp_path, monkeypatch, caplog):
    """No CPU fallback: asking for the card on a machine without one
    exits naming torch.cuda.is_available(), and writes no output."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cuda")
    out = tmp_path / "f"
    assert port_main(["filter", inputs["a"], "-o", str(out)]) != 0
    assert "is_available" in caplog.text
    assert not out.with_suffix(".unik").exists()


@pytest.mark.cuda
def test_filter_on_the_card_matches_jax_cli(inputs, tmp_path, caplog,
                                            capsysbinary):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run_both(["filter", "-v", "at", "-C"], inputs, tmp_path, caplog,
             capsysbinary, port_env=(("UNIKMER_TPU_TORCH_DEVICE", "cuda"),))


RFILTER_CASES = [
    ["rfilter", "--list-order"],
    ["rfilter", "--list-ranks"],
    ["rfilter", "-E", "species", "at", "-C"],
    ["rfilter", "-E", "Species,strain", "-E", "genus", "at", "bt", "-C",
     "-o", "{out}/r", "--verbose"],
    ["rfilter", "-L", "genus", "at", "-C"],
    ["rfilter", "-H", "genus", "at", "-C"],
    ["rfilter", "-L", "species", "-N", "at", "-C"],
    ["rfilter", "-L", "species", "-N", "-n", "at", "-C"],
    # 511145 (no rank) under a strain: kept at the strain cutoff itself
    ["rfilter", "-L", "strain", "-N", "-n", "at", "-C"],
    ["rfilter", "-H", "phylum", "-N", "-n", "at", "-C"],
    ["rfilter", "-E", "strain", "-L", "genus", "at", "-C"],
    ["rfilter", "-E", "class", "-H", "genus", "sat", "-C"],
    ["rfilter", "-H", "family", "-R", "at", "-C"],
    ["rfilter", "-N", "-R", "--root-taxid", "2", "at", "-C"],
    ["rfilter", "-B", "strain", "-B", "Species", "at", "-C"],
    ["rfilter", "-E", "species", "ag", "bg", "-C"],
    ["rfilter", "-E", "species", "-r", "ranks_short", "at"],
    ["rfilter", "--list-order", "-r", "ranks_short"],
    ["rfilter", "--list-ranks", "-r", "ranks_short"],
    ["rfilter", "-r", "ranks_dup", "at"],
    ["rfilter", "-r", "ranks_none", "at"],
    ["rfilter", "-L", "genus", "-H", "order", "at"],
    ["rfilter", "-E", "nonsense", "at"],
    ["rfilter", "-E", "kingdom", "at"],  # in the rank file, not the tree
    ["rfilter", "-E", "species", "a"],
    ["rfilter", "-E", "species", "-I", "at"],
]


@pytest.mark.parametrize("argv", RFILTER_CASES, ids=" ".join)
def test_rfilter_matches_jax_cli(inputs, tmp_path, caplog, capsysbinary,
                                 argv):
    rc, _, stdout, files = run_both(
        [*argv, "--data-dir", inputs["taxdump"]], inputs, tmp_path, caplog,
        capsysbinary)
    if rc == 0 and "--list-order" not in argv and "--list-ranks" not in argv:
        assert len(stdout) + sum(map(len, files.values())) > 100


@pytest.mark.parametrize("argv", [
    ["rfilter", "--list-order"],
    ["rfilter", "-E", "genus", "at", "-C", "--verbose"],
])
def test_rfilter_writes_the_default_rank_file(inputs, tmp_path, caplog,
                                              capsysbinary, argv):
    """Without ranks.txt in --data-dir each CLI writes its embedded rank
    order there (the same text), and reads it."""
    def prepare(d):
        (d / "db").mkdir()
        shutil.copy("tests/data/taxdump/nodes.dmp", d / "db")

    files = run_both([*argv, "--data-dir", "{out}/db"], inputs, tmp_path,
                     caplog, capsysbinary, prepare=prepare)[3]
    assert b"superkingdom" in files["db/ranks.txt"]


def test_rfilter_default_ranks_match_jax():
    from unikmer_tpu.cli.commands import rfilter as jax_rfilter
    from unikmer_tpu_torch.cli.commands import rfilter

    assert rfilter.DEFAULT_RANKS_TEXT == jax_rfilter.DEFAULT_RANKS_TEXT
