"""Parallel gzip writer (the port's copy of unikmer_tpu/io/pgzip.py).

Chunks are compressed concurrently (zlib releases the GIL) and written
in order as independent gzip MEMBERS: concatenated members are valid
gzip per RFC 1952, and every gzip reader (including Python's) handles
them transparently.

Each member carries a BGZF-style FEXTRA subfield ('U','K', u32 = total
compressed byte length of the member), so readers that know the tag can
split the stream without inflating.  Stock gzip readers skip FEXTRA per
RFC 1952.  The port deflates with Python's zlib only (the JAX package
may use libdeflate): the compressed bytes may differ, the inflated
bytes are the same.
"""

from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

DEFAULT_CHUNK = 1 << 20


def _compress_member(data: bytes, level: int) -> bytes:
    # raw deflate body; header/trailer built by hand to add the FEXTRA
    # member-length subfield (header 20B incl. subfield, trailer 8B)
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(data) + co.flush()
    xfl = 2 if level >= 9 else (4 if level == 1 else 0)
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00"  # magic, deflate, FEXTRA, mtime 0
        + bytes((xfl, 255))                  # XFL, OS=unknown
        + struct.pack("<H", 8)               # XLEN
        + b"UK" + struct.pack("<HI", 4, 28 + len(body))
    )
    trailer = struct.pack("<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)
    return header + body + trailer


class ParallelGzipWriter(io.RawIOBase):
    """File-like write-only object producing multi-member gzip output."""

    def __init__(self, fileobj, compresslevel: int = 5, threads: int = 4,
                 chunk_size: int = DEFAULT_CHUNK):
        self._f = fileobj
        self._level = compresslevel
        self._chunk = chunk_size
        self._pool = ThreadPoolExecutor(max_workers=max(threads, 1))
        self._pending = []  # ordered futures
        self._buf = bytearray()
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        # slice the incoming buffer directly: appending everything to
        # self._buf and repeatedly deleting the front is quadratic for
        # writes much larger than the chunk size
        view = memoryview(data)
        total = len(view)
        off = 0
        if self._buf:
            need = self._chunk - len(self._buf)
            take = min(need, total)
            self._buf += view[:take]
            off = take
            if len(self._buf) == self._chunk:
                self._submit(bytes(self._buf))
                self._buf = bytearray()
        while total - off >= self._chunk:
            self._submit(bytes(view[off : off + self._chunk]))
            off += self._chunk
        if off < total:
            self._buf += view[off:]
        return total

    def _submit(self, chunk: bytes) -> None:
        self._pending.append(self._pool.submit(_compress_member, chunk, self._level))
        # bound memory: drain finished prefix when deep
        while len(self._pending) > 4 * self._pool._max_workers:
            self._f.write(self._pending.pop(0).result())

    def flush(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf = bytearray()
        while self._pending:
            self._f.write(self._pending.pop(0).result())
        self._f.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._pool.shutdown()
        self._closed = True
        super().close()
