"""FASTA/FASTQ ingest (the port's copy of unikmer_tpu/io/fastx.py):
host-side parsing into packed device-ready batches.

Auto-detects FASTA vs FASTQ, transparently decompresses gzip (and
xz/zstd when the codecs are available), yields records with Name (full
header), ID (first word) and Seq bytes; sequences shorter than k are
skipped.

Sequences are concatenated into one flat uint8 base-code array with a
RECORD_SEP byte between records, so one device call encodes every
window of every record; windows that touch a separator are masked out
as invalid.  Circular genomes append the first k-1 bases of each record
before its separator, which gives exactly the wrap-around windows.
"""

from __future__ import annotations

import gzip
import io
import lzma
import os
from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from .. import native
from ..ops.codec import BASE_LUT, RECORD_SEP

_GZIP_MAGIC = b"\x1f\x8b"
_XZ_MAGIC = b"\xfd7zXZ\x00"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


@dataclass
class Record:
    name: bytes  # full header line after > or @
    id: bytes  # first whitespace-separated token
    seq: bytes

    def __len__(self) -> int:
        return len(self.seq)


def open_maybe_compressed(path: str, mode: str = "rb"):
    """Open a file, transparently decompressing by magic-byte sniffing."""
    if path == "-":
        return io.BufferedReader(os.fdopen(os.dup(0), "rb"))
    f = open(path, "rb")
    magic = f.read(6)
    f.seek(0)
    if magic[:2] == _GZIP_MAGIC:
        return io.BufferedReader(gzip.GzipFile(fileobj=f), 1 << 20)
    if magic[:6] == _XZ_MAGIC:
        return io.BufferedReader(lzma.LZMAFile(f), 1 << 20)
    if magic[:4] == _ZSTD_MAGIC:
        try:
            import zstandard  # optional
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(f"{path}: zstd input needs the zstandard module") from e
        return io.BufferedReader(zstandard.ZstdDecompressor().stream_reader(f), 1 << 20)
    return io.BufferedReader(f, 1 << 20)


def _parse_header(line: bytes) -> tuple[bytes, bytes]:
    name = line[1:].rstrip(b"\r\n")
    ident = name.split(None, 1)[0] if name else b""
    return name, ident


def read_fastx(path: str) -> Iterator[Record]:
    """Stream records from a FASTA or FASTQ file (format auto-detected)."""
    with open_maybe_compressed(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if not first:
            probe = f.read(1)
            if not probe:
                return
            rest = f.read()
            f = io.BufferedReader(io.BytesIO(probe + rest))
            first = probe
        if first == b">":
            yield from _read_fasta(f)
        elif first == b"@":
            yield from _read_fastq(f)
        else:
            raise ValueError(f"{path}: not a FASTA/FASTQ file (starts with {first!r})")


def _read_fasta(f) -> Iterator[Record]:
    name = ident = None
    chunks: list[bytes] = []
    for line in f:
        if line.startswith(b">"):
            if name is not None:
                yield Record(name, ident, b"".join(chunks))
            name, ident = _parse_header(line)
            chunks = []
        else:
            chunks.append(line.strip())
    if name is not None:
        yield Record(name, ident, b"".join(chunks))


def _read_fastq(f) -> Iterator[Record]:
    while True:
        header = f.readline()
        if not header:
            return
        if header.strip() == b"":
            continue
        if not header.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header: {header[:50]!r}")
        name, ident = _parse_header(header)
        seq = f.readline().strip()
        plus = f.readline()
        if not plus.startswith(b"+"):
            raise ValueError("malformed FASTQ: missing '+' line")
        qual = f.readline().strip()
        while len(qual) < len(seq):  # multi-line quality (rare)
            more = f.readline()
            if not more:
                break
            qual += more.strip()
        yield Record(name, ident, bytes(seq))


# ---------------------------------------------------------------------------
# Packing records into flat device batches
# ---------------------------------------------------------------------------


@dataclass
class PackedSeqs:
    """Flat base-code buffer with one separator byte between records.

    bases:   uint8 base codes (0..3 valid, >=4 invalid/separator)
    starts:  int64 start offset of each record in ``bases``
    lengths: int64 original record length (excludes circular wrap bases)
    """

    bases: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray

    @classmethod
    def from_numpy(cls, bases, starts, lengths) -> "PackedSeqs":
        """A PackedSeqs from the three arrays of the same fields (e.g.
        those of a unikmer_tpu PackedSeqs), cast to their dtypes."""
        return cls(np.ascontiguousarray(bases, np.uint8),
                   np.ascontiguousarray(starts, np.int64),
                   np.ascontiguousarray(lengths, np.int64))

    @property
    def n_records(self) -> int:
        return len(self.starts)


def pack_records(
    records: Iterable[Record], k: int, circular: bool = False,
    gap: int = 1,
) -> PackedSeqs:
    """Pack records for whole-batch window encoding.

    Records shorter than k are dropped.  With ``circular`` the first k-1
    bases of each record are appended after it, producing exactly the
    extra wrap-around windows.  Separators between records are
    RECORD_SEP bytes; ``gap`` widens the separator run.
    """
    gap = max(int(gap), 1)
    kept = [rec for rec in records if len(rec.seq) >= k]
    if not kept:
        return PackedSeqs(
            np.zeros(0, np.uint8), np.zeros(0, np.int64), np.zeros(0, np.int64)
        )
    lengths = np.fromiter((len(r.seq) for r in kept), np.int64, len(kept))
    wrap = (k - 1) if (circular and k > 1) else 0
    if wrap == 0:
        # fast path: one C-level join with a separator byte that the LUT
        # maps to the record separator, then ONE vectorized LUT pass
        sep = b"\n" * gap
        joined = sep.join(r.seq for r in kept) + sep
        out = BASE_LUT[np.frombuffer(joined, dtype=np.uint8)]
        starts = np.zeros(len(kept), np.int64)
        np.cumsum(lengths[:-1] + gap, out=starts[1:])
        return PackedSeqs(out, starts, lengths)
    # circular: wrap bases are appended per record (genome inputs: few
    # records, the per-record loop is fine)
    total = int(lengths.sum()) + (wrap + gap) * len(kept)
    out = np.empty(total, dtype=np.uint8)
    starts = np.empty(len(kept), dtype=np.int64)
    off = 0
    for i, rec in enumerate(kept):
        n = len(rec.seq)
        starts[i] = off
        np.take(BASE_LUT, np.frombuffer(rec.seq, dtype=np.uint8),
                out=out[off : off + n])
        off += n
        out[off : off + wrap] = out[starts[i] : starts[i] + wrap]
        off += wrap
        out[off : off + gap] = RECORD_SEP
        off += gap
    return PackedSeqs(out, starts, lengths)


def parse_taxid_records(records, k: int, circular: bool, gap: int,
                        re_taxid):
    """Parse per-record taxids from headers and pack the sequences:
    (packed, rec_taxids) aligned (records shorter than k dropped from
    both; every header is parsed).  The front half of both engines'
    -T."""
    from ..utils.log import die

    records = list(records)
    rec_taxids = np.empty(len(records), np.uint32)
    for i, rec in enumerate(records):
        m = re_taxid.search(rec.name)
        if not m:
            die(f"failed to parse taxid in header: {rec.name.decode()}")
        try:
            rec_taxids[i] = int(m.group(1))
        except (ValueError, OverflowError):
            die(
                f"failed to parse taxid {m.group(1)!r} in header: "
                f"{rec.name.decode()}"
            )
    packed = pack_records(records, k, circular, gap=gap)
    if packed.n_records != len(records):
        kept = [i for i, rec in enumerate(records) if len(rec.seq) >= k]
        rec_taxids = rec_taxids[kept]
    return packed, rec_taxids


def pack_files(paths: Iterable[str], k: int, circular: bool = False) -> PackedSeqs:
    """Pack one or more FASTA/Q files: through the fused native loader
    (native/host_native.cpp fastx_load) where it applies, else the
    Python reader, with identical layouts."""
    paths = list(paths)
    native_parts = []
    for p in paths:
        part = _try_native_load(p, k, circular)
        if part is None:
            break
        native_parts.append(part)
    else:
        if not native_parts:
            return pack_records([], k, circular)
        if len(native_parts) == 1:
            b, s, ln, _ = native_parts[0]
            return PackedSeqs(b, s, ln)
        bases = np.concatenate([x[0] for x in native_parts])
        offs = np.cumsum([0] + [len(x[0]) for x in native_parts[:-1]])
        starts = np.concatenate(
            [x[1] + off for x, off in zip(native_parts, offs)]
        )
        lengths = np.concatenate([x[2] for x in native_parts])
        return PackedSeqs(bases, starts, lengths)

    def gen():
        for p in paths:
            yield from read_fastx(p)

    return pack_records(gen(), k, circular)


# Whole-file native ingest holds one decompressed file in host RAM; the
# loader enforces this cap on the DECOMPRESSED size and falls back to
# the streaming Python reader beyond it.
NATIVE_INGEST_MAX = int(
    os.environ.get("UNIKMER_TPU_NATIVE_INGEST_MAX", 4 << 30)
)


def _try_native_load(path: str, k: int, circular: bool):
    """Native fused load when applicable; None to fall back."""
    if path == "-" or not os.path.isfile(path):
        return None
    try:
        with open(path, "rb") as f:
            magic = f.read(6)
    except OSError:
        return None
    if magic[:6] == _XZ_MAGIC or magic[:4] == _ZSTD_MAGIC:
        return None  # native loader handles plain + gzip only
    return native.load_fastx_packed(path, k, circular,
                                    max_text=NATIVE_INGEST_MAX)
