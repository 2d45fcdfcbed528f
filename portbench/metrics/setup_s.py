"""setup_s: from the harness's start to the window's: the port's import,
the CUDA context, the kernel and host libraries (built at a checkout's
first run), the genomes' generation and FASTA files, their counts, the
resident sets and the warm-up of each request class."""


def read(run):
    return run.setup.get("setup_s")
