"""`.unik` v5 serialization (the port's copy of unikmer_tpu/io/unik.py):
the same header, flags and block layout, so the two packages write the
same bytes for the same codes.

Layout (all little-endian), after optional gzip:

  magic     8s   b".unikmer"
  u8        main_version (5)
  u8        minor_version (1)
  u8        k
  u8        taxid_bytes        width of per-record taxids (0 if none)
  u32       flag
  u32       global_taxid       (0 = none)
  u32       scale              (<=1 = unscaled)
  i64       number             (-1 = unknown)
  u16       desc_len ++ desc bytes (<=1024)
  blocks until EOF:
    u32     n_records          (0 terminates early; EOF also terminates)
    u32     payload_nbytes
    payload:
      plain/compact: n * code_width bytes (LE codes), ++ n * taxid_bytes
      sorted:        varint-GB block of n deltas (io/varint.py), each
                     block's delta chain restarting at 0,
                     ++ n * taxid_bytes

The reader streams blocks for the external-sort spill
(pipeline/extsort.py) and reads whole sets for the set operations
(``read_all``: the native block decoder, or numpy's varint-GB); gzip,
UK-indexed or not, streams through Python's GzipFile.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
from dataclasses import dataclass

import numpy as np

from .. import native
from .varint import decode_gb64, delta_decode, delta_encode, encode_gb64

MAGIC = b".unikmer"
MAIN_VERSION = 5
# minor 1: each sorted block's delta chain restarts at 0, so blocks are
# independently decodable; minor-0 files chain deltas across blocks and
# are still read correctly.
MINOR_VERSION = 1

# Flag bits (names follow the reference's unik.Unik* constants).
COMPACT = 1
CANONICAL = 2
SORTED = 4
INCLUDE_TAXID = 8
HASHED = 16

MAX_DESC = 1024
DEFAULT_BLOCK = 1 << 20
EXT = ".unik"

_HEADER_FMT = "<8sBBBBIIIq"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


def taxid_width(max_taxid: int) -> int:
    """Minimal byte width for taxids given the declared max."""
    if max_taxid <= 0:
        return 4
    w = 1
    while max_taxid >= (1 << (8 * w)):
        w += 1
    return min(w, 4)


def code_width(k: int, flag: int) -> int:
    if flag & SORTED:
        return 0  # varint
    if (flag & COMPACT) and not (flag & HASHED):
        return (2 * k + 7) // 8
    return 8


@dataclass
class UnikHeader:
    k: int
    flag: int = 0
    number: int = -1
    description: bytes = b""
    global_taxid: int = 0
    scale: int = 1
    taxid_bytes: int = 0
    main_version: int = MAIN_VERSION
    minor_version: int = MINOR_VERSION

    # predicates (names per reference unik.Reader)
    @property
    def is_compact(self) -> bool:
        return bool(self.flag & COMPACT)

    @property
    def is_canonical(self) -> bool:
        return bool(self.flag & CANONICAL)

    @property
    def is_sorted(self) -> bool:
        return bool(self.flag & SORTED)

    @property
    def is_include_taxid(self) -> bool:
        return bool(self.flag & INCLUDE_TAXID)

    @property
    def is_hashed(self) -> bool:
        return bool(self.flag & HASHED)

    @property
    def is_scaled(self) -> bool:
        return self.scale > 1

    @property
    def has_global_taxid(self) -> bool:
        return self.global_taxid > 0

    @property
    def has_taxid_info(self) -> bool:
        # readers treat either per-record or global taxids as "has taxid
        # info"
        return self.is_include_taxid or self.has_global_taxid


class UnikWriter:
    """Bulk-array writer.  Feed sorted or unsorted uint64 code arrays
    (optionally with a uint32 taxid column) via write_codes(); call
    close() (or use as a context manager) to finalize."""

    def __init__(
        self,
        path_or_file,
        k: int,
        flag: int = 0,
        number: int = -1,
        description: bytes = b"",
        global_taxid: int = 0,
        scale: int = 1,
        max_taxid: int = 0,
        compress: bool = True,
        compression_level: int = 5,
        block_size: int = DEFAULT_BLOCK,
        threads: int = 4,
    ):
        if isinstance(path_or_file, (str, bytes, os.PathLike)):
            self._file = open(path_or_file, "wb")
            self._owns = True
        else:
            self._file = path_or_file
            self._owns = False
        self._raw = self._file
        if compress:
            if threads > 1:
                from .pgzip import ParallelGzipWriter

                self._file = ParallelGzipWriter(
                    self._file, compresslevel=compression_level, threads=threads
                )
            else:
                self._file = gzip.GzipFile(
                    fileobj=self._file, mode="wb", compresslevel=compression_level
                )
        if len(description) > MAX_DESC:
            raise ValueError(f"description longer than {MAX_DESC} bytes")
        tw = taxid_width(max_taxid) if (flag & INCLUDE_TAXID) else 0
        self.header = UnikHeader(
            k=k,
            flag=flag,
            number=number,
            description=description,
            global_taxid=global_taxid,
            scale=scale,
            taxid_bytes=tw,
        )
        self._block = block_size
        self._compress = compress
        self._wrote_header = False

    def _write_header(self) -> None:
        h = self.header
        buf = struct.pack(
            _HEADER_FMT,
            MAGIC,
            h.main_version,
            h.minor_version,
            h.k,
            h.taxid_bytes,
            h.flag,
            h.global_taxid,
            h.scale,
            h.number,
        )
        self._file.write(buf)
        self._file.write(struct.pack("<H", len(h.description)))
        if h.description:
            self._file.write(h.description)
        self._wrote_header = True

    def write_codes(self, codes: np.ndarray, taxids: np.ndarray | None = None) -> None:
        if not self._wrote_header:
            self._write_header()
        h = self.header
        codes = np.ascontiguousarray(codes, dtype=np.uint64)
        if h.is_include_taxid:
            if taxids is None:
                raise ValueError("writer expects taxids (INCLUDE_TAXID set)")
            taxids = np.ascontiguousarray(taxids, dtype=np.uint32)
            if len(taxids) != len(codes):
                raise ValueError("codes/taxids length mismatch")
        if h.is_sorted and len(codes) > self._block:
            # all blocks encoded concurrently in one native call (delta
            # chains restart per block, minor version 1)
            region = native.encode_sorted_blocks(
                codes,
                taxids if h.is_include_taxid else None,
                h.taxid_bytes if h.is_include_taxid else 0,
                self._block,
            )
            if region is not None:
                self._file.write(region)
                return
        for off in range(0, len(codes), self._block):
            self._write_block(
                codes[off : off + self._block],
                None if taxids is None else taxids[off : off + self._block],
            )

    def _write_block(self, codes: np.ndarray, taxids) -> None:
        h = self.header
        n = len(codes)
        if n == 0:
            return
        if h.is_sorted:
            # delta base 0 per block (minor version 1)
            payload = native.encode_deltas_gb64(codes, 0)
            if payload is None:  # no native library: numpy path
                payload = encode_gb64(delta_encode(codes, 0))
        else:
            w = code_width(h.k, h.flag)
            if w == 8:
                payload = codes.astype("<u8").tobytes()
            else:
                full = codes.astype("<u8").view(np.uint8).reshape(n, 8)
                payload = np.ascontiguousarray(full[:, :w]).tobytes()
        parts = [payload]
        if h.is_include_taxid and h.taxid_bytes:
            tw = h.taxid_bytes
            if tw == 4:
                parts.append(taxids.astype("<u4").tobytes())
            else:
                tb = taxids.astype("<u4").view(np.uint8).reshape(n, 4)
                parts.append(np.ascontiguousarray(tb[:, :tw]).tobytes())
        body = b"".join(parts)
        self._file.write(struct.pack("<II", n, len(body)))
        self._file.write(body)

    def close(self) -> None:
        if not self._wrote_header:
            self._write_header()  # legal: empty output with a header
        if self._compress:
            self._file.close()
        if self._owns:
            self._raw.close()
        else:
            # handed-in stream: force buffered bytes out; its lifetime
            # stays with the caller (it may be stdout)
            self._raw.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UnikReader:
    """Reader: iter_blocks() yields (codes, taxids|None) block arrays, one
    block resident at a time; read_all() returns the whole set."""

    def __init__(self, path_or_file):
        # never a whole-file inflate (the JAX package's default for large
        # files): gzip streams, so memory stays at a buffer and one block
        if isinstance(path_or_file, (str, bytes, os.PathLike)):
            f = open(path_or_file, "rb")
            self._owns = True
        else:
            f = path_or_file
            self._owns = False
        self._raw = f
        magic2 = f.peek(2)[:2] if hasattr(f, "peek") else None
        if magic2 is None:
            head = f.read(2)
            f = io.BufferedReader(_Concat(head, f))
            magic2 = head
        self.gzipped = magic2 == b"\x1f\x8b"
        if self.gzipped:
            f = io.BufferedReader(gzip.GzipFile(fileobj=f), 1 << 20)
        elif not isinstance(f, io.BufferedReader):
            f = io.BufferedReader(f)
        self._file = f
        hdr = f.read(_HEADER_SIZE)
        if len(hdr) < _HEADER_SIZE:
            raise ValueError("truncated .unik header")
        (magic, mv, nv, k, tb, flag, gt, scale, number) = struct.unpack(
            _HEADER_FMT, hdr
        )
        if magic != MAGIC:
            raise ValueError(f"not a .unik file (magic {magic!r})")
        if mv != MAIN_VERSION:
            raise ValueError(f"unsupported .unik main version {mv}")
        (dlen,) = struct.unpack("<H", f.read(2))
        desc = f.read(dlen) if dlen else b""
        self.header = UnikHeader(
            k=k,
            flag=flag,
            number=number,
            description=desc,
            global_taxid=gt,
            scale=scale,
            taxid_bytes=tb,
            main_version=mv,
            minor_version=nv,
        )
        self._prev_code = 0

    def iter_blocks(self):
        while True:
            hdr = self._file.read(8)
            if len(hdr) < 8:
                return
            n, nbytes = struct.unpack("<II", hdr)
            if n == 0:
                return
            body = self._file.read(nbytes)
            if len(body) < nbytes:
                raise ValueError("truncated .unik block")
            yield self._decode_block(body, n)

    def _decode_block(self, body: bytes, n: int):
        h = self.header
        if h.is_sorted:
            # minor 0 chained deltas across blocks; minor >= 1 restarts
            # each block at 0
            prev = self._prev_code if h.minor_version == 0 else 0
            deltas, off = decode_gb64(body, n)
            codes = delta_decode(deltas, prev)
            self._prev_code = int(codes[-1])
        else:
            w = code_width(h.k, h.flag)
            if w == 8:
                codes = np.frombuffer(body, dtype="<u8", count=n).astype(np.uint64)
            else:
                raw = np.frombuffer(body, dtype=np.uint8, count=n * w).reshape(n, w)
                full = np.zeros((n, 8), dtype=np.uint8)
                full[:, :w] = raw
                codes = full.view("<u8").reshape(n).astype(np.uint64)
            off = n * w
        taxids = None
        if h.is_include_taxid and h.taxid_bytes:
            tw = h.taxid_bytes
            raw = np.frombuffer(body, dtype=np.uint8, count=n * tw, offset=off)
            if tw == 4:
                taxids = raw.view("<u4").astype(np.uint32)
            else:
                full = np.zeros((n, 4), dtype=np.uint8)
                full[:, :tw] = raw.reshape(n, tw)
                taxids = full.view("<u4").reshape(n).astype(np.uint32)
        return codes, taxids

    def read_all(self):
        """(codes, taxids or None) of every remaining block: the native
        concurrent decoder for sorted minor-1 files, else the block loop."""
        h = self.header
        if h.is_sorted and h.minor_version >= 1:
            rest = self._file.read()
            res = native.decode_sorted_blocks(
                rest, h.taxid_bytes if h.is_include_taxid else 0)
            if res is not None:
                return res
            # no native library: the block loop over ``rest``
            self._file = io.BufferedReader(io.BytesIO(rest))
        codes_list, tax_list = [], []
        for codes, taxids in self.iter_blocks():
            codes_list.append(codes)
            if taxids is not None:
                tax_list.append(taxids)
        if not codes_list:
            return np.zeros(0, np.uint64), (
                np.zeros(0, np.uint32) if h.is_include_taxid else None
            )
        codes = np.concatenate(codes_list)
        taxids = np.concatenate(tax_list) if tax_list else None
        return codes, taxids

    def close(self) -> None:
        self._file.close()
        if self._owns and self._raw is not self._file:
            self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Concat(io.RawIOBase):
    """Prepend consumed sniff bytes back onto a raw stream."""

    def __init__(self, head: bytes, rest):
        self._head = head
        self._rest = rest

    def readable(self):
        return True

    def readinto(self, b):
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._rest.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)


def check_compatibility(h0: UnikHeader, h: UnikHeader, file: str = "") -> None:
    """Equal k / canonical / hashed / scaled across multi-file inputs."""
    problems = []
    if h.k != h0.k:
        problems.append(f"k mismatch ({h.k} vs {h0.k})")
    if h.is_canonical != h0.is_canonical:
        problems.append("canonical flag mismatch")
    if h.is_hashed != h0.is_hashed:
        problems.append("hashed flag mismatch")
    if h.is_scaled != h0.is_scaled or (
        h.is_scaled and h.scale != h0.scale
    ):
        problems.append("scale mismatch")
    if problems:
        raise ValueError(f"incompatible .unik file {file}: " + "; ".join(problems))
