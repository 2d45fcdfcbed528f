"""Host pipelines of the port: the external-sort spill (extsort)."""
