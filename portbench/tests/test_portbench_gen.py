"""The seeded pan-genome generator: repeats by seed, and hits its sizes."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.gen.genomes import (  # noqa: E402
    PanGenome, clade_of, draw_bases, fasta_bytes, write_genomes,
)
from portbench.reference.encode import genome_set, read_fasta  # noqa: E402

SMALL = dict(genomes=8, clades=2, core_bp=20000, gc=0.508,
             clade_substitution=0.01, genome_substitution=0.003,
             accessory_pool=100, accessory_bp=100, accessory_per_genome=20,
             accessory_zipf=1.0, fasta_line=80)


def config(name: str) -> dict:
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _written(tmp_path, name: str, seed: int, threads: int) -> list[str]:
    (tmp_path / name).mkdir()
    return write_genomes(SMALL, seed, str(tmp_path / name), threads=threads)


def test_same_seed_same_bytes_other_seed_other_bytes(tmp_path):
    a = _written(tmp_path, "a", 7, 3)
    b = _written(tmp_path, "b", 7, 1)
    c = _written(tmp_path, "c", 8, 2)
    for x, y, z in zip(a, b, c):
        assert Path(x).read_bytes() == Path(y).read_bytes()
        assert Path(x).read_bytes() != Path(z).read_bytes()


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5, 2**63 + 3])
def test_any_whole_seed(seed):
    pan = PanGenome(SMALL, seed)
    g = pan.genome(3)
    assert g.size == 20000 + 20 * 100 and g.max() <= 3


def test_sizes_shares_and_clades():
    pan = PanGenome(SMALL, 123)
    genomes = [pan.genome(i) for i in range(8)]
    for g in genomes:
        assert g.size == SMALL["core_bp"] + 20 * 100
    core = SMALL["core_bp"]
    within = np.mean(genomes[0][:core] != genomes[1][:core])
    across = np.mean(genomes[0][:core] != genomes[4][:core])
    # two genomes of a clade differ by their own substitutions (about
    # 2 x 0.3%), two of different clades by the clades' 2 x 1% too
    assert 0.003 < within < 0.01
    assert 0.02 < across < 0.035
    assert clade_of(SMALL, 3) == 0 and clade_of(SMALL, 4) == 1


def test_gc_share_and_popularity():
    rng = np.random.default_rng(5)
    b = draw_bases(rng, 2_000_000, 0.508)
    share = np.bincount(b, minlength=4) / b.size
    assert abs(share[1] + share[2] - 0.508) < 0.002
    assert abs(share[0] - share[3]) < 0.002
    pan = PanGenome(SMALL, 1)
    assert pan.popularity[0] / pan.popularity[9] == pytest.approx(10.0)


def test_fasta_wraps_and_reads_back(tmp_path):
    seq = np.random.default_rng(2).integers(0, 4, 205).astype(np.uint8)
    data = fasta_bytes("x", seq, 80)
    lines = data.split(b"\n")
    assert lines[0] == b">x" and [len(x) for x in lines[1:]] == [80, 80, 45, 0]
    p = tmp_path / "x.fa"
    p.write_bytes(data)
    import torch
    back = read_fasta(str(p), torch.device("cpu"))
    assert len(back) == 1 and np.array_equal(back[0].numpy(), seq)


def test_full_size_genome_holds_about_five_million_kmers(tmp_path):
    """One genome at the configuration's own sizes: 5.0 Mbp and about
    5.0 M distinct canonical 23-mers (MG1655: 4.64 Mbp, 4,546,632)."""
    import torch

    cfg = {**config("pangenome-k23"), "genomes": 8, "clades": 8}
    pan = PanGenome(cfg, 99)
    seq = pan.genome(0)
    assert seq.size == 4_300_000 + 700 * 1000
    p = tmp_path / "g.fa"
    p.write_bytes(fasta_bytes("g", seq, cfg["fasta_line"]))
    n = len(genome_set(str(p), 23, True, False, torch.device("cpu")))
    assert 4_950_000 < n <= seq.size - 22
