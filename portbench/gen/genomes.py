"""A seeded bacterial pan-genome, written as one FASTA file a genome.

The shape comes from a configuration file (``portbench/configs``):

- an ancestral core of ``core_bp`` bases at GC share ``gc``;
- ``clades`` clades, each the core with substitutions at
  ``clade_substitution`` a base;
- ``genomes`` genomes, the same number in each clade: the clade's core
  followed by ``accessory_per_genome`` segments of ``accessory_bp``
  bases drawn without replacement from a pool of ``accessory_pool``
  segments by a Zipf popularity of exponent ``accessory_zipf`` (rank r
  is drawn with weight r^-s), the whole then substituted at
  ``genome_substitution`` a base.

Every genome is one record of upper-case ACGT, wrapped at ``fasta_line``
bases.  The draws come from ``numpy.random.SeedSequence(seed)``: one
child stream for the ancestor, one for the pool, one a clade and one a
genome, so the same seed gives the same bytes whatever the number of
threads that write them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """The root of every draw of a run: any whole number, negative ones
    folded into 64 bits."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


def draw_bases(rng: np.random.Generator, n: int, gc: float) -> np.ndarray:
    """n bases as codes 0..3 (A, C, G, T), G and C each at gc / 2."""
    r = rng.random(n, dtype=np.float32)
    half = np.float32(gc / 2)
    out = np.full(n, 3, np.uint8)  # T
    out[r < np.float32((1 + gc) / 2)] = 0  # A below (1 + gc) / 2
    out[r < np.float32(gc)] = 2  # G below gc
    out[r < half] = 1  # C below gc/2
    return out


def substitute(rng: np.random.Generator, seq: np.ndarray, rate: float) -> None:
    """Replace bases in place, each by another base, at ``rate`` a base
    (positions drawn with replacement, so a few are hit twice)."""
    hits = rng.binomial(seq.size, rate)
    pos = rng.integers(0, seq.size, hits)
    seq[pos] = (seq[pos] + rng.integers(1, 4, hits, dtype=np.uint8)) & 3


def clade_of(cfg: dict, genome: int) -> int:
    return genome // (cfg["genomes"] // cfg["clades"])


class PanGenome:
    """The draws shared by all genomes of one seed: the clades' cores and
    the accessory pool.  :meth:`genome` makes genome i's bases."""

    def __init__(self, cfg: dict, seed: int):
        if cfg["genomes"] % cfg["clades"]:
            raise ValueError("genomes must be a multiple of clades")
        self.cfg = cfg
        kids = seed_sequence(seed).spawn(2 + cfg["clades"] + cfg["genomes"])
        self._genome_seeds = kids[2 + cfg["clades"]:]
        ancestor = draw_bases(np.random.default_rng(kids[0]), cfg["core_bp"],
                              cfg["gc"])
        self.pool = draw_bases(
            np.random.default_rng(kids[1]),
            cfg["accessory_pool"] * cfg["accessory_bp"], cfg["gc"],
        ).reshape(cfg["accessory_pool"], cfg["accessory_bp"])
        rank = np.arange(1, cfg["accessory_pool"] + 1, dtype=np.float64)
        weight = rank ** -float(cfg["accessory_zipf"])
        self.popularity = weight / weight.sum()
        self.cores = []
        for c in range(cfg["clades"]):
            core = ancestor.copy()
            substitute(np.random.default_rng(kids[2 + c]), core,
                       cfg["clade_substitution"])
            self.cores.append(core)

    def genome(self, i: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(self._genome_seeds[i])
        segs = rng.choice(cfg["accessory_pool"], cfg["accessory_per_genome"],
                          replace=False, p=self.popularity)
        seq = np.concatenate([self.cores[clade_of(cfg, i)],
                              self.pool[segs].ravel()])
        substitute(rng, seq, cfg["genome_substitution"])
        return seq


def fasta_bytes(name: str, seq: np.ndarray, line: int) -> bytes:
    """One FASTA record of codes 0..3, wrapped at ``line`` bases."""
    n = seq.size
    rows = -(-n // line)
    text = np.zeros(rows * line, np.uint8)
    text[:n] = ACGT[seq]
    grid = np.full((rows, line + 1), ord("\n"), np.uint8)
    grid[:, :line] = text.reshape(rows, line)
    tail = n - (rows - 1) * line  # bases on the last line
    body = grid.reshape(-1)[: (rows - 1) * (line + 1) + tail]
    return b">" + name.encode() + b"\n" + body.tobytes() + b"\n"


def write_genomes(cfg: dict, seed: int, directory: str,
                  threads: int = 8) -> list[str]:
    """Write every genome of the seed's pan-genome under ``directory``
    (g00.fa, g01.fa, ...); returns the paths in genome order."""
    pan = PanGenome(cfg, seed)
    paths = [os.path.join(directory, f"g{i:02d}.fa")
             for i in range(cfg["genomes"])]

    def one(i: int) -> None:
        data = fasta_bytes(f"g{i:02d} clade{clade_of(cfg, i)}",
                           pan.genome(i), cfg["fasta_line"])
        with open(paths[i], "wb") as f:
            f.write(data)

    with ThreadPoolExecutor(threads) as pool:
        for fut in [pool.submit(one, i) for i in range(cfg["genomes"])]:
            fut.result()
    return paths
