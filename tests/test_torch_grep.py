"""The port's lookup subcommands (``grep``, ``concat``) against
``unikmer_tpu.cli.main``: the same arguments give the same stdout bytes,
output files (gzip outputs inflated), exit code and log lines.  Each
``grep`` case runs the port with UNIKMER_TPU_GREP_DEVICE at 0 and at 1
(on the CPU the device tier is DeviceMembership over the plain torch
``member_bits``); the extsort spill runs with UNIKMER_TPU_GREP_MEM_MB at
0.0001 on both sides."""

import numpy as np
import pytest

from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.ops import codec, device_sets

from test_torch_textcmds import inputs, run_both  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def queries(inputs, tmp_path_factory):
    """Query strings and files over the inputs: k-mers of s23 (members,
    their reverse complements and new ones), a query file, .unik query
    files (a k = 23 subset written by dump, and h31 itself) and taxids."""
    from unikmer_tpu_torch.io.unik import UnikReader

    d = tmp_path_factory.mktemp("grepq")
    rng = np.random.default_rng(20261018)
    with UnikReader(inputs["s23"]) as r:
        codes = r.read_all()[0]
    pick = codes[rng.choice(len(codes), 40, replace=False)]
    members = [bytes(x).decode() for x in codec.decode_codes(pick, 23)]
    rc = [bytes(x).decode() for x in codec.decode_codes(
        codec.revcomp_np(pick[:5], 23), 23)]
    new = [bytes(x).decode() for x in codec.decode_codes(
        rng.integers(0, 1 << 46, size=5, dtype=np.uint64), 23)]
    out = {"q23": ",".join(members[:10] + rc + new),
           "q23lower": ",".join(m.lower() for m in members[10:14])}
    qf = d / "q.txt"
    qf.write_text("\n".join(members[14:] + ["", new[0]]) + "\n")
    out["qfile"] = str(qf)
    sub = d / "sub.txt"
    sub.write_text("\n".join(members[::2]) + "\n")
    assert port_main(["dump", "-K", "-s", "-C", str(sub), "-o",
                      str(d / "qsub")]) == 0
    out["qunik"] = str(d / "qsub.unik")
    deg = members[0][:20] + "NRY"
    out["qdeg"] = deg
    out["qdegbad"] = members[0][:22] + "Z"
    out["qdegmany"] = "N" * 10 + members[0][10:]
    out["qshort"] = members[0][:20]
    with UnikReader(inputs["h31"]) as r:
        hcodes = r.read_all()[0]
    out["qhash"] = "ACGT" * 7 + "ACG"
    out["qh31"] = inputs["h31"]
    assert len(hcodes) > 1000
    return out


O = ["-C", "-o", "{out}/g"]
GREP_CASES = [
    ["grep", "-q", "q23", "s23", *O],
    ["grep", "-q", "q23", "-q", "q23lower", "-f", "qfile", "s23", *O],
    ["grep", "-q", "q23", "-v", "s23", *O],
    ["grep", "-q", "q23", "c21", *O],  # length mismatch
    ["grep", "-F", "qunik", "s23", "gz23", *O],
    ["grep", "-F", "qunik", "-v", "-u", "s23", "gz23", *O],
    ["grep", "-F", "qunik", "-v", "-d", "s23", "gz23", *O],
    ["grep", "-F", "qunik", "-s", "g23", *O],
    ["grep", "-F", "qunik", "-c", "-v", "g23", "s23", *O],  # taxid mismatch
    ["grep", "-F", "qunik", "c21", *O],  # k of the query files
    ["grep", "-F", "qh31", "-q", "qhash", "h31", *O],
    ["grep", "-q", "qhash", "-v", "h31", "-o", "{out}/g"],
    ["grep", "-q", "q23", "-F", "qunik", "T21", "-s", *O],
    ["grep", "-D", "-q", "qdeg", "-q", "q23", "s23", *O],
    ["grep", "-D", "-q", "qdegbad", "s23", *O],
    ["grep", "-D", "-q", "qdegmany", "s23", *O],
    ["grep", "-q", "qshort", "s23", *O],
    ["grep", "-t", "-q", "562,9606", "T21", *O],
    ["grep", "-t", "-q", "9606", "-v", "g23", *O],
    ["grep", "-t", "-q", "562", "s23", *O],  # no taxids
    ["grep", "-t", "-q", "x", "T21", *O],
    ["grep", "-q", "q23", "-u", "-d", "s23", *O],
    ["grep", "-q", "q23", "-m", "-O", "{out}/dir", "s23", "gz23", "-C"],
    ["grep", "-q", "q23", "-m", "-O", "{out}/dir", "-S", ".x", "-v", "-s",
     "s23", "gz23", "-C"],
    ["grep", "-q", "q23", "-s", "-I", "T21", "s23", *O],
]


@pytest.mark.parametrize("knob", ["0", "1"])
@pytest.mark.parametrize("argv", GREP_CASES, ids=" ".join)
def test_grep_matches_jax_cli(inputs, queries, tmp_path, caplog,
                              capsysbinary, argv, knob):
    rc, _, _, files = run_both(argv, {**inputs, **queries}, tmp_path,
                               caplog, capsysbinary,
                               [("UNIKMER_TPU_GREP_DEVICE", knob)])
    if rc == 0:
        assert files


@pytest.mark.parametrize("argv", [
    ["grep", "-F", "qunik", "-v", "-s", "s23", "gz23", "s23", *O],
    ["grep", "-F", "qunik", "-v", "-u", "s23", "gz23", "s23", *O],
    ["grep", "-F", "qunik", "-v", "-d", "s23", "gz23", "s23", *O],
    ["grep", "-t", "-q", "562", "-s", "T21", "T21", *O],
], ids=" ".join)
def test_grep_spill_matches_jax_cli(inputs, queries, tmp_path, caplog,
                                    capsysbinary, monkeypatch, argv):
    """A buffer of 0.0001 MB: every block spills a sorted chunk, and the
    close merges them (pipeline/extsort)."""
    from unikmer_tpu_torch.pipeline import extsort

    monkeypatch.setenv("UNIKMER_TPU_GREP_MEM_MB", "0.0001")
    chunks = []
    real = extsort.dump_chunk
    monkeypatch.setattr(extsort, "dump_chunk",
                        lambda *a, **kw: (chunks.append(a[2]),
                                          real(*a, **kw))[1])
    rc, _, _, files = run_both(argv, {**inputs, **queries}, tmp_path,
                               caplog, capsysbinary)
    assert rc == 0 and len(files["g.unik"]) > 1000 and len(chunks) >= 2


@pytest.mark.parametrize("knob,device", [("1", True), ("0", False),
                                         (None, False)])
def test_grep_device_tier_is_opt_in(inputs, queries, tmp_path, monkeypatch,
                                    knob, device):
    """UNIKMER_TPU_GREP_DEVICE=1 sends membership through
    DeviceMembership.lookup; the default, as 0, stays on the host."""
    calls = []
    real = device_sets.DeviceMembership.lookup
    monkeypatch.setattr(device_sets.DeviceMembership, "lookup",
                        lambda self, look: (calls.append(len(look)),
                                            real(self, look))[1])
    if knob is None:
        monkeypatch.delenv("UNIKMER_TPU_GREP_DEVICE", raising=False)
    else:
        monkeypatch.setenv("UNIKMER_TPU_GREP_DEVICE", knob)
    assert port_main(["grep", "-F", queries["qunik"], inputs["s23"],
                      inputs["gz23"], "-C", "-o",
                      str(tmp_path / "g")]) == 0
    assert bool(calls) == device
    assert (sum(calls) > 10000) == device


def test_grep_device_route_admits_by_the_budget(monkeypatch):
    """The query set must fit the device's membership budget: past it
    (free bytes replaced by a small value, or UNIKMER_TPU_MAX_ELEMS
    below the padded query) the tier declines even with the knob on."""
    monkeypatch.setenv("UNIKMER_TPU_GREP_DEVICE", "1")
    assert device_sets.grep_device_route(5000)
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 20)
    assert not device_sets.grep_device_route(5000)
    monkeypatch.setattr(device_sets, "_device_free_bytes",
                        lambda device: 1 << 40)
    assert device_sets.grep_device_route(5000)
    monkeypatch.setenv("UNIKMER_TPU_MAX_ELEMS", str((1 << 20) - 1))
    assert not device_sets.grep_device_route(5000)
    monkeypatch.setenv("UNIKMER_TPU_GREP_DEVICE", "0")
    monkeypatch.delenv("UNIKMER_TPU_MAX_ELEMS")
    assert not device_sets.grep_device_route(5000)


CONCAT_CASES = [
    ["concat", "s23", "gz23", *O],
    ["concat", "-s", "s23", "-n", "7", *O],
    ["concat", "c21", "c21", "-c", *O],
    ["concat", "T21", "T21", *O],
    ["concat", "g23", "T21", "-o", "{out}/g"],
    ["concat", "-t", "9606", "T21", "s23", *O],
    ["concat", "T21", "s23", *O],  # taxid mismatch
    ["concat", "-I", "T21", "s23", *O],
    ["concat", "s23", "c21", *O],  # k mismatch
    ["concat", "h31", "h31", *O],
    ["concat", "k64", *O],
]


@pytest.mark.parametrize("argv", CONCAT_CASES, ids=" ".join)
def test_concat_matches_jax_cli(inputs, queries, tmp_path, caplog,
                                capsysbinary, argv):
    rc, _, _, files = run_both(argv, {**inputs, **queries}, tmp_path,
                               caplog, capsysbinary)
    if rc == 0:
        assert len(files["g.unik"]) > 1000
