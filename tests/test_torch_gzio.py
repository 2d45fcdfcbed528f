"""The port's `.unik` gzip I/O: the writer's native member deflate
(native.pgz_compress_member), the member-parallel inflate
(native.pgz_inflate_all) and the reader's modes (io/unik.py
``UnikReader(stream=)``, ``_try_parallel_inflate``, ``_UKMemberStream``,
UNIKMER_TPU_INFLATE_CAP), against Python's gzip and zlib and the JAX
package's reader on the same bytes, from both packages' writers.  The
cases of tests/test_native.py and tests/test_unik_io.py on these
functions are restated for the port.  The native cases skip where the
port's host library has no zlib (no g++ or no <zlib.h>)."""

import gzip
import io
import os

import numpy as np
import pytest

from unikmer_tpu import native as jax_native
from unikmer_tpu.io import pgzip as jax_pgzip
from unikmer_tpu.io import unik as jax_unik
from unikmer_tpu_torch import native
from unikmer_tpu_torch.io import pgzip, unik
from unikmer_tpu_torch.pipeline import extsort


@pytest.fixture(scope="module")
def zlib_lib():
    """The port's host library, built with zlib: decided here, so that a
    host without g++ or <zlib.h> skips rather than fails."""
    lib = native.get_lib()
    if lib is None or not lib.ukt_have_zlib():
        pytest.skip("the port's host library has no zlib here")
    return lib


@pytest.fixture
def rng():
    return np.random.default_rng(18)


def pgz_bytes(mod, data: bytes, level=5, threads=3, chunk=1 << 19,
              step=100_003) -> bytes:
    """``data`` through a package's ParallelGzipWriter in ``step`` writes."""
    buf = io.BytesIO()
    w = mod.ParallelGzipWriter(buf, compresslevel=level, threads=threads,
                               chunk_size=chunk)
    for i in range(0, len(data), step):
        w.write(data[i:i + step])
    w.close()
    return buf.getvalue()


def write_unik(path, codes, **kw):
    with unik.UnikWriter(str(path), k=23, flag=unik.SORTED,
                         number=len(codes), **kw) as w:
        w.write_codes(codes)


# ---------------------------------------------------------------------
# native.pgz_inflate_all and pgz_compress_member


def test_pgz_indexed_roundtrip_and_interop(zlib_lib, rng):
    data = rng.integers(0, 256, size=3_456_789, dtype=np.uint8).tobytes()
    raw = pgz_bytes(pgzip, data)
    assert gzip.decompress(raw) == data  # stock readers: plain members
    assert native.pgz_inflate_all(raw) == data
    assert native.pgz_inflate_all(raw, threads=1) == data
    assert native.pgz_inflate_all(gzip.compress(data[:100_000])) is None
    assert native.pgz_inflate_all(raw[:-3]) is None  # truncated
    # one write far past the chunk, after a partial buffer
    buf = io.BytesIO()
    w = pgzip.ParallelGzipWriter(buf, compresslevel=1, threads=3,
                                 chunk_size=1 << 18)
    w.write(data[:1000])
    w.write(data[1000:])
    w.close()
    assert gzip.decompress(buf.getvalue()) == data
    assert native.pgz_inflate_all(buf.getvalue()) == data


def test_pgz_small_and_empty_members(zlib_lib):
    raw = pgz_bytes(pgzip, b"x", level=9, threads=2)
    assert gzip.decompress(raw) == b"x"
    assert native.pgz_inflate_all(raw) == b"x"
    empty = io.BytesIO()
    pgzip.ParallelGzipWriter(empty).close()
    assert empty.getvalue() == b""
    assert native.pgz_inflate_all(b"") is None


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("threads", [0, 1, 4])
def test_pgz_inflate_all_matches_jax(zlib_lib, rng, writer, threads):
    """The port's and the JAX package's inflate give the same bytes from
    either package's writer (the JAX one deflates with libdeflate where
    its library builds)."""
    data = rng.integers(0, 4, size=2_500_001, dtype=np.uint8).tobytes()
    raw = pgz_bytes(pgzip if writer == "port" else jax_pgzip, data)
    got = native.pgz_inflate_all(raw, threads=threads)
    assert got == data
    if jax_native.get_lib() is not None:
        assert jax_native.pgz_inflate_all(raw, threads=threads) == got


@pytest.mark.parametrize("case", ["foreign", "truncated", "bad_crc",
                                  "bad_isize", "short_index", "empty"])
def test_pgz_inflate_all_refuses(zlib_lib, rng, case):
    """None for a member without the index, a cut buffer, a member that
    fails zlib's CRC-32 or length check, and an empty buffer."""
    data = rng.integers(0, 256, size=300_000, dtype=np.uint8).tobytes()
    raw = bytearray(pgz_bytes(pgzip, data, chunk=1 << 17))
    if case == "foreign":
        raw += gzip.compress(b"tail")
    elif case == "truncated":
        del raw[-1]
    elif case == "bad_crc":
        raw[-8] ^= 1  # the last member's CRC-32
    elif case == "bad_isize":
        raw[-4] ^= 1  # the last member's ISIZE
    elif case == "short_index":
        raw[16] = 27  # the first member's length below a header + trailer
    else:
        raw = bytearray()
    assert native.pgz_inflate_all(bytes(raw)) is None
    if case in ("bad_crc", "bad_isize") and jax_native.get_lib() is not None:
        assert jax_native.pgz_inflate_all(bytes(raw)) is None


@pytest.mark.parametrize("level", [-1, 1, 2, 5, 6, 9])
@pytest.mark.parametrize("size", [0, 1, 1000, 1 << 20])
def test_pgz_compress_member_is_the_python_route(zlib_lib, rng, level, size):
    """The native member is byte for byte the one Python's zlib route of
    io/pgzip._compress_member builds."""
    data = (rng.integers(0, 4, size=size, dtype=np.uint8) + 65).tobytes()
    got = native.pgz_compress_member(data, level)
    assert got is not None
    co = __import__("zlib").compressobj(level, 8, -15)
    body = co.compress(data) + co.flush()
    assert len(got) == 28 + len(body) and got[20:-8] == body
    assert got[8] == (2 if level >= 9 else 4 if level == 1 else 0)
    assert gzip.decompress(got) == data
    assert native.pgz_inflate_all(got, threads=1) == data


def test_pgz_compress_member_python_route_equality(zlib_lib, rng,
                                                   monkeypatch):
    """_compress_member's two routes give the same member; level 0 (whose
    stored blocks follow the caller's output buffers) takes Python's."""
    data = rng.integers(0, 256, size=300_000, dtype=np.uint8).tobytes()
    for level in (1, 5, 9):
        native_member = pgzip._compress_member(data, level)
        with monkeypatch.context() as m:
            m.setattr(native, "pgz_compress_member", lambda d, lv: None)
            python_member = pgzip._compress_member(data, level)
        assert native_member == python_member
    assert native.pgz_compress_member(data, 0) is None
    assert gzip.decompress(pgzip._compress_member(data, 0)) == data


def test_writer_deflates_through_the_native_library(zlib_lib, rng,
                                                    monkeypatch):
    calls = []
    real = native.pgz_compress_member

    def counted(data, level):
        calls.append(level)
        return real(data, level)

    monkeypatch.setattr(native, "pgz_compress_member", counted)
    data = rng.integers(0, 256, size=700_000, dtype=np.uint8).tobytes()
    raw = pgz_bytes(pgzip, data, level=3, chunk=1 << 18)
    assert calls == [3, 3, 3] and gzip.decompress(raw) == data


def test_without_the_library_everything_takes_python(rng, monkeypatch,
                                                     tmp_path):
    """UNIKMER_TPU_NO_NATIVE=1: no native member functions; the writer
    deflates with Python's zlib and the reader inflates with gzip."""
    monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    assert native.pgz_compress_member(b"abc", 5) is None
    data = rng.integers(0, 256, size=200_000, dtype=np.uint8).tobytes()
    raw = pgz_bytes(pgzip, data, chunk=1 << 16)
    assert native.pgz_inflate_all(raw) is None
    codes = np.sort(rng.integers(0, 1 << 46, size=300_000, dtype=np.uint64))
    path = tmp_path / "n.unik"
    write_unik(path, codes, threads=2)
    for stream in (False, True):
        with unik.UnikReader(str(path), stream=stream) as r:
            np.testing.assert_array_equal(r.read_all()[0], codes)


# ---------------------------------------------------------------------
# the reader's modes


@pytest.fixture
def big_unik(tmp_path, rng):
    """A UK-indexed gzipped sorted .unik above the 1 MiB inflate floor."""
    codes = np.sort(rng.integers(0, 1 << 46, size=400_000, dtype=np.uint64))
    path = tmp_path / "big.unik"
    write_unik(path, codes, threads=4)
    assert os.path.getsize(path) >= (1 << 20)
    return str(path), codes


def test_reader_stream_mode_equivalent(zlib_lib, big_unik):
    path, codes = big_unik
    with unik.UnikReader(path) as r1:
        assert isinstance(r1._file.raw, io.BytesIO)  # inflated whole
        c1, _ = r1.read_all()
    with unik.UnikReader(path, stream=True) as r2:
        blocks = [c for c, _ in r2.iter_blocks()]
        assert isinstance(r2._file.raw, unik._UKMemberStream)
    np.testing.assert_array_equal(c1, codes)
    np.testing.assert_array_equal(np.concatenate(blocks), codes)


@pytest.mark.parametrize("cap,whole", [("0", False), ("1048575", False),
                                       ("4294967296", True)])
def test_inflate_cap(zlib_lib, big_unik, monkeypatch, cap, whole):
    """Past UNIKMER_TPU_INFLATE_CAP bytes the file streams by members."""
    path, codes = big_unik
    monkeypatch.setenv("UNIKMER_TPU_INFLATE_CAP", cap)
    with unik.UnikReader(path) as r:
        kind = type(r._file.raw)
        np.testing.assert_array_equal(r.read_all()[0], codes)
    assert (kind is io.BytesIO) == whole
    assert (kind is unik._UKMemberStream) == (not whole)


def test_small_files_stream(zlib_lib, tmp_path, rng):
    """Below the 1 MiB floor a UK-indexed file reads by members."""
    codes = np.sort(rng.integers(0, 1 << 46, size=5_000, dtype=np.uint64))
    path = tmp_path / "small.unik"
    write_unik(path, codes)
    with unik.UnikReader(str(path)) as r:
        assert isinstance(r._file.raw, unik._UKMemberStream)
        np.testing.assert_array_equal(r.read_all()[0], codes)


@pytest.mark.parametrize("stream", [False, True])
def test_reader_stream_mode_foreign_gzip(tmp_path, rng, stream):
    """A plain gzip file (no index) reads through GzipFile either way."""
    codes = np.sort(rng.integers(0, 1 << 40, size=50_000, dtype=np.uint64))
    buf = io.BytesIO()
    with unik.UnikWriter(buf, k=20, flag=unik.SORTED, compress=False) as w:
        w.write_codes(codes)
    path = tmp_path / "foreign.unik"
    path.write_bytes(gzip.compress(buf.getvalue(), 1) * 1)
    with unik.UnikReader(str(path), stream=stream) as r:
        assert isinstance(r._file.raw, gzip.GzipFile)
        out, _ = r.read_all()
    np.testing.assert_array_equal(out, codes)


def test_foreign_gzip_above_the_floor_is_not_slurped(tmp_path, rng,
                                                     monkeypatch):
    """A foreign first member past 1 MiB streams without a whole read."""
    payload = rng.integers(0, 256, size=1_300_000, dtype=np.uint8).tobytes()
    path = tmp_path / "foreign.gz"
    path.write_bytes(gzip.compress(payload, 1))
    monkeypatch.setattr(native, "pgz_inflate_all",
                        lambda *a, **kw: pytest.fail("slurped"))
    with open(path, "rb") as f:
        assert unik.UnikReader._try_parallel_inflate(f) is None
        assert f.tell() == 0


def test_member_stream_mixed_members(zlib_lib, tmp_path, rng):
    """UK members, then a foreign one: the member stream switches to
    GzipFile mid-file without losing a byte."""
    payload = rng.integers(0, 256, size=3_000_000, dtype=np.uint8).tobytes()
    path = tmp_path / "mixed.gz"
    with open(path, "wb") as f:
        w = pgzip.ParallelGzipWriter(f, compresslevel=1, threads=2)
        w.write(payload[:2_500_000])
        w.close()
        f.write(gzip.compress(payload[2_500_000:], 1))
    with open(path, "rb") as f:
        br = io.BufferedReader(f)
        assert unik._UKMemberStream.sniff(br)
        got = io.BufferedReader(unik._UKMemberStream(br), 1 << 20).read()
    assert got == payload
    # the whole-file inflate refuses the mixed file and rewinds it
    with open(path, "rb") as f:
        assert unik.UnikReader._try_parallel_inflate(f) is None
        assert f.tell() == 0


def test_member_stream_without_native_inflates_with_gzip(rng, monkeypatch):
    payload = rng.integers(0, 256, size=600_000, dtype=np.uint8).tobytes()
    raw = pgz_bytes(pgzip, payload, chunk=1 << 17)
    monkeypatch.setattr(native, "pgz_inflate_all", lambda *a, **kw: None)
    ms = io.BufferedReader(unik._UKMemberStream(
        io.BufferedReader(io.BytesIO(raw))), 1 << 20)
    assert ms.read() == payload


def test_member_stream_fails_a_corrupt_member(zlib_lib, rng):
    """A member that fails its CRC-32 is not passed on: the native
    inflate refuses it and gzip raises."""
    payload = rng.integers(0, 256, size=300_000, dtype=np.uint8).tobytes()
    raw = bytearray(pgz_bytes(pgzip, payload, chunk=1 << 17))
    raw[-8] ^= 1
    ms = io.BufferedReader(unik._UKMemberStream(
        io.BufferedReader(io.BytesIO(bytes(raw)))), 1 << 20)
    with pytest.raises(gzip.BadGzipFile):
        ms.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("cap", [None, "0"])
def test_reader_matches_jax_on_the_same_files(zlib_lib, tmp_path, rng,
                                              monkeypatch, writer, stream,
                                              cap):
    """Both packages' readers read the same arrays and taxids from a
    gzipped file of either package's writer, in either mode and cap."""
    codes = np.sort(rng.integers(0, 1 << 46, size=300_000, dtype=np.uint64))
    taxids = rng.integers(1, 1 << 20, size=len(codes)).astype(np.uint32)
    path = str(tmp_path / f"{writer}.unik")
    mod = unik if writer == "port" else jax_unik
    with mod.UnikWriter(path, k=23, flag=mod.SORTED | mod.INCLUDE_TAXID,
                        number=len(codes), max_taxid=(1 << 20),
                        threads=4) as w:
        w.write_codes(codes, taxids)
    if cap is not None:
        monkeypatch.setenv("UNIKMER_TPU_INFLATE_CAP", cap)
    with jax_unik.UnikReader(path, stream=stream) as r:
        want = r.read_all()
    with unik.UnikReader(path, stream=stream) as r:
        got = r.read_all()
        assert r.gzipped
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)
    np.testing.assert_array_equal(got[0], codes)
    np.testing.assert_array_equal(got[1], taxids)


@pytest.mark.parametrize("argv,whole", [
    (["num", "{f}"], False),
    (["info", "{f}"], False),
    (["head", "-n", "1", "{f}", "-o", "{out}/h"], False),
    (["concat", "{f}", "-o", "{out}/c"], False),
    (["sample", "-w", "7", "{f}", "-o", "{out}/s"], False),
    (["sort", "-m", "100000", "-t", "{out}", "{f}", "-o", "{out}/o"], False),
    (["sort", "{f}", "-o", "{out}/o"], True),  # in memory: the whole set
    (["split", "-m", "100000", "{f}", "-O", "{out}/parts"], False),
    (["union", "{f}", "{f}", "-o", "{out}/u"], True),
    (["inter", "{f}", "{f}", "-o", "{out}/i"], True),
], ids=lambda v: "-".join(a for a in v if "{" not in a)
   if isinstance(v, list) else None)
def test_commands_stream_or_inflate_whole(zlib_lib, big_unik, tmp_path,
                                          monkeypatch, argv, whole):
    """Commands that take blocks one at a time (and the external sort)
    open a gzipped .unik over the 1 MiB floor through the member stream,
    so memory stays bounded; whole-set commands keep the parallel
    inflate."""
    from unikmer_tpu_torch.cli.main import main as port_main

    path, _ = big_unik
    kinds = []
    init = unik.UnikReader.__init__

    def recording_init(self, *a, **kw):
        init(self, *a, **kw)
        kinds.append(type(self._file.raw))

    monkeypatch.setattr(unik.UnikReader, "__init__", recording_init)
    args = [a.format(f=path, out=tmp_path) for a in argv]
    assert port_main(args) == 0
    opened = [k for k in kinds if k is not io.FileIO]  # the outputs' reads
    assert opened
    want = io.BytesIO if whole else unik._UKMemberStream
    assert all(k is want for k in opened), opened


def test_extsort_chunk_readers_stream(zlib_lib, big_unik):
    """The external merge's chunk readers stream by members: up to 400
    are open at once, so none reads its file whole."""
    path, codes = big_unik
    s = extsort._ChunkStream(path)
    assert isinstance(s.reader._file.raw, unik._UKMemberStream)
    got = []
    while not s.exhausted:
        got.append(s.codes)
        s.codes = np.zeros(0, np.uint64)
        s._fill()
    s.reader.close()
    np.testing.assert_array_equal(np.concatenate(got), codes)
