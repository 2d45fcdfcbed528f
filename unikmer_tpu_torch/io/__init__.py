"""Host I/O of the port: its own copies of unikmer_tpu/io (FASTA/Q ingest,
the .unik writer and reader, varint-GB, parallel gzip)."""
