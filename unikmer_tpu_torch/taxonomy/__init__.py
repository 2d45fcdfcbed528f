"""Taxonomy of the port: the host taxdump (taxdump.py, the port's copy of
unikmer_tpu/taxonomy/taxdump.py) and the compact-vocabulary LCA on the
device (lca.py)."""
