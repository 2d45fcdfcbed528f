"""The port's format subcommands (``view``, ``dump``, ``info``/``stats``,
``num``, ``encode``, ``decode``) against ``unikmer_tpu.cli.main``: the
same arguments give the same stdout bytes, output-file bytes (gzip
outputs inflated: their headers carry a name and a time, and the JAX
package deflates with libdeflate), exit code and log lines, with the
native library on and with UNIKMER_TPU_NO_NATIVE=1.  Their host helpers
(``utils/sizes``, ``utils/textout``, the codec's numpy helpers, the
native ``render_lines`` / ``decode_codes_ascii`` /
``parse_code_lines``) are held to the JAX package's on seeded arrays."""

import gzip
from pathlib import Path

import numpy as np
import pytest

from unikmer_tpu import native as jax_native
from unikmer_tpu.cli.main import main as jax_main
from unikmer_tpu.ops import codec as jax_codec
from unikmer_tpu.utils import sizes as jax_sizes
from unikmer_tpu.utils import textout as jax_textout
from unikmer_tpu_torch import native
from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.ops import codec
from unikmer_tpu_torch.utils import sizes, textout

TAXDUMP = ["--data-dir", "tests/data/taxdump"]


def records(rng, n_records=2, length=10_000):
    """FASTA text of seeded records (``sample<i>`` headers), with a few
    N bases, lowercase and a repeat."""
    out = []
    for r in range(n_records):
        seq = rng.choice(np.frombuffer(b"ACGTacgtN", np.uint8), size=length,
                         p=[.24, .24, .24, .24, .01, .01, .01, .005, .005])
        seq[-500:] = seq[:500]
        out.append(b">r%d sample%d\n%s\n" % (r, (562, 511145)[r % 2],
                                             seq.tobytes()))
    return b"".join(out)


# name -> count flags; every input is written by both CLIs and the two
# files must be equal
UNIK_INPUTS = {
    "s23": ["-k", "23", "-K", "-s", "-C"],
    "c21": ["-k", "21", "-c", "-C"],
    "g23": ["-k", "23", "-K", "-s", "-t", "9606", "-C"],
    "T21": ["-k", "21", "-K", "-s", "-T", "-r", r"sample(\d+)", *TAXDUMP,
            "-C"],
    "h31": ["-k", "31", "-K", "-H", "-s", "-C"],
    "k64": ["-k", "64", "-C"],
    "gz23": ["-k", "23", "-K", "-s"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The .unik inputs of UNIK_INPUTS (count by both CLIs, on the CPU),
    text inputs for dump/encode/decode, and a file that is not .unik."""
    d = tmp_path_factory.mktemp("textcmds")
    rng = np.random.default_rng(20261017)
    fa = d / "in.fa"
    fa.write_bytes(records(rng))
    mp = pytest.MonkeyPatch()
    mp.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    out = {}
    try:
        for name, flags in UNIK_INPUTS.items():
            files = []
            for side, main in (("jax", jax_main), ("port", port_main)):
                prefix = str(d / f"{name}.{side}")
                assert main(["count", *flags, str(fa), "-o", prefix]) == 0
                files.append(Path(prefix + ".unik"))
            if name == "gz23":
                assert (gzip.decompress(files[0].read_bytes())
                        == gzip.decompress(files[1].read_bytes()))
            else:
                assert files[0].read_bytes() == files[1].read_bytes(), name
            out[name] = str(files[1])
        # number unknown (-1): concat without -n
        assert port_main(["concat", "-C", out["s23"], out["s23"], "-o",
                          str(d / "cat")]) == 0
        out["cat"] = str(d / "cat.unik")
    finally:
        mp.undo()
    kmers = codec.decode_codes(rng.integers(0, 1 << 42, size=3000,
                                            dtype=np.uint64), 21)
    rows = [bytes(r) for r in kmers]
    text = {
        "k21": b"\n".join(rows) + b"\n",
        "k21tax": b"".join(b"%s\t%d\n" % (r, t) for r, t in zip(
            rows, rng.integers(0, 1 << 20, size=len(rows)))),
        "k21dup": b"\n".join(rows + rows[::7]) + b"\n\n",
        "k40": b"".join(bytes(a) + bytes(b)[:19] + b"\n"
                        for a, b in zip(kmers[:500], kmers[500:1000])),
        "ints": b"".join(b"%d\n" % v for v in rng.integers(
            0, 1 << 63, size=2000, dtype=np.uint64)),
        "codes21": b"".join(b"%d\n" % v for v in rng.integers(
            0, 1 << 42, size=2000, dtype=np.uint64)),
        "mixed": b"acgtu\nACGTN\n",
        "lower": b"acgtuacgtuAC\nggccaatt\n  tttt  \n\n",
        "badbase": b"\n".join(rows[:5] + [rows[5][:10] + b"N" + rows[5][11:]]
                              + rows[6:9]) + b"\n",
        "badlen": b"\n".join(rows[:4] + [rows[4][:15]]) + b"\n",
        "badtax": b"%s\t12\n%s\tx7\n" % (rows[0], rows[1]),
        "badint": b"12\n1x\n",
        "bigint": b"5\n%d\n" % (1 << 42),
        "badhash": b"5\n%d\n" % (1 << 64),
        "k70": b"A" * 70 + b"\n",
    }
    for name, body in text.items():
        p = d / f"{name}.txt"
        p.write_bytes(body)
        out[name] = str(p)
    bad = d / "bad.unik"
    bad.write_bytes(b"not a unik file at all, just text\n" * 4)
    out["bad"] = str(bad)
    return out


@pytest.fixture(params=["native", "numpy"])
def host(request, monkeypatch):
    """Each case with the native library, then on the numpy branches of
    both packages."""
    if request.param == "numpy":
        monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    return request.param


def _records(caplog, logger):
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == logger]


def _outputs(d: Path) -> dict:
    """{path under d: bytes} of the files under d, gzip files inflated
    (the JAX package deflates .unik files with libdeflate, the port with
    zlib)."""
    got = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            got[str(p.relative_to(d))] = _inflated(p.read_bytes())
    return got


def _inflated(data: bytes) -> bytes:
    return gzip.decompress(data) if _is_gzip(data) else data


def _is_gzip(data: bytes) -> bool:
    return data[:2] == b"\x1f\x8b"


def _gzipped(stdout: bytes, d: Path) -> tuple:
    """Whether stdout is gzip, and the files under d that are: a side
    must compress what the other does, whatever its deflate's bytes."""
    return _is_gzip(stdout), sorted(
        str(p.relative_to(d)) for p in d.rglob("*")
        if p.is_file() and _is_gzip(p.read_bytes()[:2]))


def run_both(argv, inputs, tmp_path, caplog, capsysbinary, port_env=(),
             prepare=None):
    """Each CLI on the same arguments (names looked up in ``inputs``;
    "{out}" a path in a directory of each side, empty but for what
    ``prepare(directory)`` puts there), the port under the environment
    ``port_env`` adds: (exit code, log lines with the side's directory
    read as "{out}", stdout bytes, output files; gzip inflated) a side,
    which must be equal, as must what each side compressed."""
    got, gzipped = {}, {}
    for name, main, logger in (("jax", jax_main, "unikmer_tpu"),
                               ("port", port_main, "unikmer_tpu_torch")):
        d = tmp_path / name
        d.mkdir()
        if prepare is not None:
            prepare(d)
        args = [str(d / a[len("{out}"):].lstrip("/")) if a.startswith("{out}")
                else inputs.get(a, a) for a in argv]
        caplog.clear()
        capsysbinary.readouterr()
        with pytest.MonkeyPatch.context() as mp:
            for key, val in (port_env if name == "port" else ()):
                mp.setenv(key, val)
            rc = main(args)
        stdout = capsysbinary.readouterr().out
        got[name] = (rc, [(level, msg.replace(str(d), "{out}"))
                          for level, msg in _records(caplog, logger)],
                     _inflated(stdout), _outputs(d))
        gzipped[name] = _gzipped(stdout, d)
    assert got["port"] == got["jax"]
    assert gzipped["port"] == gzipped["jax"]
    return got["jax"]


VIEW_CASES = [
    ["view", "s23"],
    ["view", "-n", "s23"],
    ["view", "-N", "c21"],
    ["view", "c21", "-o", "{out}/v.txt"],
    ["view", "-a", "s23"],
    ["view", "-q", "s23", "-o", "{out}/v.fq.gz"],
    ["view", "-t", "g23"],
    ["view", "-T", "T21"],
    ["view", "-t", "-a", "T21"],
    ["view", "-t", "-q", "g23"],
    ["view", "-t", "s23"],  # no taxids: a warning
    ["view", "-I", "-t", "T21"],
    ["view", "h31"],
    ["view", "-n", "h31"],
    ["view", "-t", "-a", "k64"],
    ["view", "-q", "k64"],
    ["view", "-g", "x.fa", "s23"],  # not hashed: ignored with a warning
    ["view", "gz23", "s23"],
    ["view", "s23", "T21"],  # taxids in one file only
    ["view", "s23", "c21"],  # incompatible k
    ["view", "--skip-flag-check", "-N", "s23", "c21"],
    ["view", "bad"],
]


@pytest.mark.parametrize("argv", VIEW_CASES, ids=" ".join)
def test_view_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                              argv):
    rc, _, stdout, files = run_both(argv, inputs, tmp_path, caplog,
                                    capsysbinary)
    assert rc != 0 or len(stdout) + sum(map(len, files.values())) > 1000


def test_view_genome_exits_naming_roadmap(inputs, tmp_path, caplog,
                                         capsysbinary):
    """-g over hashed canonical k-mers decodes them through the genome
    they were counted from (the port's genome index, on the CPU here):
    the JAX CLI's bytes and log lines, every hash found.  (The name is
    the test's from when the port exited naming ROADMAP.md here.)"""
    genome = str(Path(inputs["h31"]).parent / "in.fa")
    rc, logs, _, files = run_both(
        ["view", "-g", genome, "h31", "-o", "{out}/v.txt"], inputs, tmp_path,
        caplog, capsysbinary,
        port_env=(("UNIKMER_TPU_TORCH_DEVICE", "cpu"),))
    lines = files["v.txt"].splitlines()
    assert rc == 0 and not logs and len(lines) > 1000
    assert all(len(x) == 31 and not x.isdigit() for x in lines)


DUMP_CASES = [
    ["dump", "k21", "-o", "{out}/d"],
    ["dump", "-K", "-s", "k21", "-C", "-o", "{out}/d"],
    ["dump", "-O", "k21", "-C", "-c", "-o", "{out}/d"],
    ["dump", "-u", "-K", "k21dup", "-C", "-o", "{out}/d"],
    ["dump", "-t", "9606", "k21", "-C", "-o", "{out}/d"],
    ["dump", "-t", "9606", "k21tax", "-C", "-o", "{out}/d"],
    ["dump", "-H", "-K", "k21", "-C", "-o", "{out}/d"],
    ["dump", "k40", "-C", "-o", "{out}/d"],  # k > 32: hashed
    ["dump", "--hashed", "-k", "31", "ints", "-C", "-o", "{out}/d"],
    ["dump", "--hashed", "ints", "-o", "{out}/d"],  # -k missing
    ["dump", "k21", "k21", "-u", "-C", "-o", "{out}/d"],
    ["dump", "lower", "-C", "-o", "{out}/d"],
    ["dump", "badbase", "-C", "-o", "{out}/d"],
    ["dump", "badlen", "-C", "-o", "{out}/d"],
    ["dump", "badtax", "-C", "-o", "{out}/d"],
    ["dump", "--hashed", "-k", "21", "badhash", "-C", "-o", "{out}/d"],
    ["dump", "k70", "-C", "-o", "{out}/d"],
]


@pytest.mark.parametrize("argv", DUMP_CASES, ids=" ".join)
def test_dump_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                              argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


ENCODE_CASES = [
    ["encode", "k21"],
    ["encode", "-a", "-K", "k21", "-o", "{out}/e.txt.gz"],
    ["encode", "-H", "k21"],
    ["encode", "-a", "k40"],
    ["encode", "-a", "-K", "mixed"],  # N: the error line
    ["encode", "-K", "lower"],
    ["encode", "k70"],  # past 64
]


@pytest.mark.parametrize("argv", ENCODE_CASES, ids=" ".join)
def test_encode_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                                argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


DECODE_CASES = [
    ["decode", "-k", "21", "codes21"],
    ["decode", "-k", "21", "-a", "codes21", "-o", "{out}/d.txt"],
    ["decode", "-k", "21", "bigint"],  # overflows k = 21
    ["decode", "-k", "21", "badint"],
    ["decode", "-k", "33", "codes21"],
]


@pytest.mark.parametrize("argv", DECODE_CASES, ids=" ".join)
def test_decode_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                                argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


INFO_CASES = [
    ["info", "s23", "c21", "g23", "T21", "h31", "k64", "gz23", "cat"],
    ["info", "-a", "-b", "cat", "gz23"],
    ["stats", "-T", "s23", "gz23", "k64", "-o", "{out}/i.tsv"],
    ["info", "-a", "-T", "cat", "-o", "{out}/i.tsv.gz"],
    ["info", "s23", "bad"],
    ["info", "-e", "s23", "bad"],
    ["info", "--symbol-true", "y", "--symbol-false", "y", "s23"],
]


@pytest.mark.parametrize("argv", INFO_CASES, ids=" ".join)
def test_info_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                              argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


NUM_CASES = [
    ["num", "s23", "c21", "cat"],
    ["num", "-n", "-b", "cat", "gz23"],
    ["num", "-f", "-n", "s23", "-o", "{out}/n.txt"],
]


@pytest.mark.parametrize("argv", NUM_CASES, ids=" ".join)
def test_num_matches_jax_cli(inputs, host, tmp_path, caplog, capsysbinary,
                             argv):
    run_both(argv, inputs, tmp_path, caplog, capsysbinary)


def test_view_dump_round_trip(inputs, tmp_path):
    """view's text dumped back gives the input's codes."""
    from unikmer_tpu_torch.io.unik import UnikReader

    txt = tmp_path / "s.txt"
    assert port_main(["view", inputs["s23"], "-o", str(txt)]) == 0
    assert port_main(["dump", "-K", "-s", "-C", str(txt), "-o",
                      str(tmp_path / "back")]) == 0
    with UnikReader(inputs["s23"]) as a, UnikReader(
            str(tmp_path / "back.unik")) as b:
        want, got = a.read_all()[0], b.read_all()[0]
    assert len(want) > 1000
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------
# host helpers


@pytest.mark.parametrize("s", ["", "0", "12", "1.5K", "2m", " 3G ", "7B",
                               "-4K", "K", "1Kb", "abc"])
def test_parse_byte_size_matches_jax(s):
    assert _error(sizes.parse_byte_size, s) == _error(
        jax_sizes.parse_byte_size, s)
    assert sizes.parse_byte_size(s) == jax_sizes.parse_byte_size(s) if \
        _error(sizes.parse_byte_size, s) is None else True
    assert sizes.humanize(len(s) * 123457) == jax_sizes.humanize(
        len(s) * 123457)


def test_textout_matches_jax():
    rng = np.random.default_rng(3)
    vals = np.concatenate([np.array([0, 1, 9, 10, (1 << 64) - 1], np.uint64),
                           rng.integers(0, 1 << 63, size=500,
                                        dtype=np.uint64)])
    fixed = rng.integers(65, 91, size=(len(vals), 7)).astype(np.uint8)
    other = rng.integers(0, 1 << 32, size=len(vals), dtype=np.uint64)
    for fn, args in (
            ("lines_fixed_plus_int", (fixed, vals)),
            ("lines_fixed_plus_int", (None, vals)),
            ("lines_int_plus_fixed", (vals, fixed, b">", b"\n", b"\n+\nx\n")),
            ("lines_fixed", (fixed,)),
            ("lines_two_ints", (vals, other))):
        assert getattr(textout, fn)(*args) == getattr(jax_textout, fn)(*args)


def _error(fn, arg):
    try:
        fn(arg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("k", [1, 5, 21, 31, 32])
def test_codec_host_helpers_match_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), size=400, dtype=np.uint64)
    codes[:2] = [0, (1 << (2 * k)) - 1]
    assert codec.max_code(k) == jax_codec.max_code(k)
    np.testing.assert_array_equal(codec.decode_codes(codes, k),
                                  jax_codec.decode_codes(codes, k))
    np.testing.assert_array_equal(codec.revcomp_np(codes, k),
                                  jax_codec.revcomp_np(codes, k))
    np.testing.assert_array_equal(codec.canonical_np(codes, k),
                                  jax_codec.canonical_np(codes, k))
    for c in codes[:20]:
        s = codec.decode_kmer(int(c), k)
        assert s == jax_codec.decode_kmer(int(c), k)
        assert codec.encode_kmer(s.lower()) == jax_codec.encode_kmer(
            s.lower()) == int(c)
        assert codec.bits_string(int(c), k) == jax_codec.bits_string(int(c), k)
    for bad in (b"ACGN", "A" * 33):
        assert _error(codec.encode_kmer, bad) == _error(jax_codec.encode_kmer,
                                                        bad) is not None
    with pytest.raises(ValueError, match="overflows"):
        codec.decode_kmer(codec.max_code(k) + 1, k)


@pytest.mark.parametrize("k", [None, 3, 21, 32])
@pytest.mark.parametrize("with_vals", [False, True])
def test_native_render_lines_matches_jax_and_numpy(k, with_vals):
    rng = np.random.default_rng(5)
    hi = (1 << 64) - 1 if k is None else (1 << (2 * k)) - 1
    codes = rng.integers(0, hi, size=3001, dtype=np.uint64, endpoint=True)
    vals = rng.integers(0, 1 << 64, size=len(codes), dtype=np.uint64) \
        if with_vals else None
    got = native.render_lines(codes, k, vals)
    assert got is not None and got == jax_native.render_lines(codes, k, vals)
    if k is None:
        want = (textout.lines_fixed_plus_int(None, codes) if vals is None
                else textout.lines_two_ints(codes, vals))
    else:
        arr = codec.decode_codes(codes, k)
        want = (textout.lines_fixed(arr) if vals is None
                else textout.lines_fixed_plus_int(arr, vals))
        np.testing.assert_array_equal(native.decode_codes_ascii(codes, k),
                                      arr)
    assert got == want
    assert native.render_lines(codes[:0], k, None if vals is None
                               else vals[:0]) == b""


@pytest.mark.parametrize("body,kmer_mode,k,tax", [
    (b"ACGTA\nacgtu\n\n  TTTTT \r\n", True, 5, False),
    (b"ACGTA\t12\nCCCCC\t4294967295\t7\n", True, 5, True),
    (b"12\n18446744073709551615\n0\n", False, 0, False),
    (b"ACGTA\nACGT\n", True, 5, False),  # a short token: its offset
    (b"ACGTA\t12\nACGTA\n", True, 5, True),  # no taxid column
    (b"ACGTA\t4294967296\n", True, 5, True),  # taxid past u32
    (b"18446744073709551616\n", False, 0, False),  # past u64
    (b"ACGTA\tx\n", True, 5, True),
    (b"ACNTA\n", True, 5, False),
])
def test_native_parse_code_lines_matches_jax(body, kmer_mode, k, tax):
    got = native.parse_code_lines(body, kmer_mode, k, tax)
    want = jax_native.parse_code_lines(body, kmer_mode, k, tax)
    if isinstance(want, int):
        assert got == want
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])


def test_native_text_functions_fall_back(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_NO_NATIVE", "1")
    codes = np.arange(5, dtype=np.uint64)
    assert native.render_lines(codes, 5) is None
    assert native.decode_codes_ascii(codes, 5) is None
    assert native.parse_code_lines(b"ACGTA\n", True, 5, False) is None
