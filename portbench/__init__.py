"""The benchmark of unikmer_tpu_torch (see run.py)."""
