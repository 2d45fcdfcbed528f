"""Taxonomy LCA on the port's device (port of unikmer_tpu/taxonomy/lca.py);
the host taxonomy (taxdump.py) is shared with unikmer_tpu."""
