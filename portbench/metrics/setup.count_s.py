"""setup.count_s: the harness's span, synchronised at its end, around
the genomes' ``KmerSet.from_fasta`` calls (ingest, K1 or H1, K2, the
collapse)."""


def read(run):
    return run.setup.get("count_s")
