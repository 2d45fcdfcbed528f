"""The port's resident server (unikmer_tpu_torch/server.py) on the CPU,
the cases of tests/test_server.py on the port: the same bytes and exit
codes as local calls, stdout routed to the client, the per-request
environment and cwd, the fallback to a local run when no server
answers, and no local rerun once a request was delivered.  Besides: a
process on the client path imports no torch, and memory that torch's
allocator keeps from an earlier request counts as free to a later
request's admission.
"""

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from unikmer_tpu_torch.cli.main import main as port_main
from unikmer_tpu_torch.ops import device_sets

REPO = Path(__file__).resolve().parents[1]


def base_env() -> dict:
    env = dict(os.environ)
    env["UNIKMER_TPU_TORCH_DEVICE"] = "cpu"
    env["UNIKMER_TPU_HOST_COUNT"] = "0"  # the device route's plain versions
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("UNIKMER_TPU_SERVER", None)
    return env


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("srv") / "unikmer.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "unikmer_tpu_torch.server", "--socket", sock,
         "--idle-timeout", "120"],
        env=base_env(), stderr=subprocess.PIPE, text=True,
    )
    try:
        for _ in range(300):
            if os.path.exists(sock):
                break
            if proc.poll() is not None:
                raise RuntimeError(
                    f"server died: {proc.stderr.read()[-2000:]}")
            time.sleep(0.1)
        else:
            raise RuntimeError("server socket never appeared")
        yield sock
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        assert not os.path.exists(sock)  # SIGTERM removes the socket


def run_client(sock, argv, cwd=None, extra_env=None, stdin=None):
    env = base_env()
    env["UNIKMER_TPU_SERVER"] = sock
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "unikmer_tpu_torch.cli.main", *map(str, argv)],
        env=env, cwd=cwd, capture_output=True, input=stdin, timeout=180,
    )


def write_fa(tmp_path, seed: int = 0):
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    p = tmp_path / "in.fa"
    p.write_text(f">s1\n{lut[rng.integers(0, 4, 600)].tobytes().decode()}\n"
                 f">s2\n{lut[rng.integers(0, 4, 450)].tobytes().decode()}\n")
    return p


def test_server_count_matches_local(server, tmp_path, monkeypatch):
    fa = write_fa(tmp_path, 1)
    monkeypatch.setenv("UNIKMER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("UNIKMER_TPU_HOST_COUNT", "0")
    a = tmp_path / "local"
    assert port_main(["count", "-k", "23", "-K", "-s", "-C", str(fa), "-o",
                      str(a)]) == 0
    b = tmp_path / "srv"
    r = run_client(server, ["count", "-k", 23, "-K", "-s", "-C", fa, "-o", b])
    assert r.returncode == 0, r.stderr.decode()
    assert Path(f"{a}.unik").read_bytes() == Path(f"{b}.unik").read_bytes()


def test_server_second_command_is_fast(server, tmp_path):
    """Request 2 must not pay the interpreter and the imports again."""
    fa = write_fa(tmp_path, 2)
    r = run_client(server, ["count", "-k", 23, "-K", "-s", fa, "-o",
                            tmp_path / "o1"])
    assert r.returncode == 0, r.stderr.decode()
    t0 = time.time()
    r = run_client(server, ["count", "-k", 23, "-K", "-s", fa, "-o",
                            tmp_path / "o2"])
    dt = time.time() - t0
    assert r.returncode == 0, r.stderr.decode()
    assert dt < 10, f"warm request took {dt:.1f}s"


def test_server_stdout_and_exit_codes(server, tmp_path):
    fa = write_fa(tmp_path, 3)
    out = tmp_path / "o"
    r = run_client(server, ["count", "-k", 23, "-K", "-s", fa, "-o", out])
    assert r.returncode == 0
    # text stdout routes back through the passed fd, as a local call's
    r = run_client(server, ["view", f"{out}.unik"])
    assert r.returncode == 0, r.stderr.decode()
    local = subprocess.run(
        [sys.executable, "-m", "unikmer_tpu_torch.cli.main", "view",
         f"{out}.unik"], env=base_env(), capture_output=True, timeout=180)
    assert r.stdout == local.stdout
    lines = r.stdout.decode().strip().splitlines()
    assert len(lines) > 100 and len(lines[0]) == 23
    # error path: missing file -> the local call's exit code, on stderr
    r = run_client(server, ["view", str(tmp_path / "nope.unik")])
    assert r.returncode != 0
    assert b"nope.unik" in r.stderr or b"ERROR" in r.stderr.upper()
    assert r.returncode == port_main(["view", str(tmp_path / "nope.unik")])


def test_server_env_scoping(server, tmp_path):
    """A request's UNIKMER_* env applies to that request and does not
    leak into the next one (UNIKMER_TPU_DEBUG's traceback as the probe)."""
    bad = tmp_path / "bad.unik"
    bad.write_bytes(b"garbage-not-a-unik-file-0123456789")
    r = run_client(server, ["view", bad],
                   extra_env={"UNIKMER_TPU_DEBUG": "1"})
    assert r.returncode != 0
    assert b"Traceback" in r.stderr, r.stderr.decode()
    r = run_client(server, ["view", bad])
    assert r.returncode != 0
    assert b"Traceback" not in r.stderr, r.stderr.decode()


def test_server_cwd_per_request(server, tmp_path):
    fa = write_fa(tmp_path, 4)
    r = run_client(server, ["count", "-k", 23, "-K", "-s", fa.name,
                            "-o", "rel_out"], cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "rel_out.unik").exists()


def test_client_falls_back_without_server(tmp_path):
    fa = write_fa(tmp_path, 5)
    r = run_client(str(tmp_path / "no-such.sock"),
                   ["count", "-k", 23, "-K", "-s", fa, "-o", tmp_path / "o"])
    assert r.returncode == 0, r.stderr.decode()
    assert (tmp_path / "o.unik").exists()


def test_client_no_local_rerun_after_delivery(tmp_path):
    """If the server dies after the request was delivered, the client
    does not run it again locally: it exits 255 with a diagnostic."""
    sock = str(tmp_path / "half.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(1)

    def half_server():
        conn, _ = srv.accept()
        # receive the fds and the request, then close without replying
        _, fds, *_ = socket.recv_fds(conn, 1, 3)
        for fd in fds:
            os.close(fd)
        n = int.from_bytes(conn.recv(4), "big")
        while n > 0:
            n -= len(conn.recv(n))
        conn.close()

    t = threading.Thread(target=half_server, daemon=True)
    t.start()
    fa = write_fa(tmp_path, 6)
    r = run_client(sock, ["count", "-k", 23, "-K", "-s", fa, "-o",
                          tmp_path / "o"])
    t.join(timeout=10)
    assert not t.is_alive()
    srv.close()
    assert r.returncode == 255, (r.returncode, r.stderr.decode())
    assert b"NOT re-running locally" in r.stderr
    assert not (tmp_path / "o.unik").exists()


CLIENT_PROBE = """
import sys
from unikmer_tpu_torch.cli.main import main
rc = main(sys.argv[1:])
print(rc, "torch" in sys.modules)
"""


def test_server_auto_count_takes_the_device_route(server, tmp_path):
    """Through the server, count under UNIKMER_TPU_HOST_COUNT=auto
    takes the device route (its start-up is paid) and =1 the host
    engine, each with a local call's bytes."""
    fa = write_fa(tmp_path, seed=4)
    local = tmp_path / "local"
    env = base_env()
    env["UNIKMER_TPU_HOST_COUNT"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "unikmer_tpu_torch.cli.main", "count", "-k",
         "23", "-K", "-s", "-C", str(fa), "-o", str(local)],
        env=env, capture_output=True, timeout=180)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    for knob, route in (("auto", "device"), ("1", "host")):
        out = tmp_path / knob
        r = run_client(server, ["count", "-k", 23, "-K", "-s", "-C", "-V",
                                fa, "-o", out],
                       extra_env={"UNIKMER_TPU_HOST_COUNT": knob})
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert f"count: the {route} route" in r.stderr.decode()
        assert ((tmp_path / f"{knob}.unik").read_bytes()
                == (tmp_path / "local.unik").read_bytes())


def test_client_path_does_not_import_torch(server, tmp_path):
    fa = write_fa(tmp_path, 7)
    env = base_env()
    env["UNIKMER_TPU_SERVER"] = server
    res = subprocess.run(
        [sys.executable, "-c", CLIENT_PROBE, "count", "-k", "23", "-K", "-s",
         str(fa), "-o", str(tmp_path / "o")],
        env=env, capture_output=True, text=True, timeout=180)
    assert res.stdout.split() == ["0", "False"], res.stderr
    assert (tmp_path / "o.unik").exists()


def test_admission_counts_memory_the_allocator_keeps(monkeypatch):
    """Bytes torch's caching allocator holds reserved and unused (left by
    an earlier request) count as free: the budget equals a fresh
    process's, where mem_get_info alone would shrink it."""
    card = torch.device("cuda", 0)
    total = 80 << 30
    fresh = {"free": total - (1 << 30), "reserved": 0, "allocated": 0}
    warm = {"free": total - (9 << 30), "reserved": 8 << 30,
            "allocated": 0}
    budgets = []
    monkeypatch.setattr(device_sets, "_CEILINGS", {})
    for state in (fresh, warm):
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda d, s=state: (s["free"], total))
        monkeypatch.setattr(
            torch.cuda, "memory_stats_as_nested_dict",
            lambda d, s=state: {
                "reserved_bytes": {"all": {"current": s["reserved"]}},
                "allocated_bytes": {"all": {"current": s["allocated"]}}})
        assert (device_sets._device_free_bytes(card)
                == state["free"] + state["reserved"] - state["allocated"])
        budgets.append(device_sets.element_budget("union", card))
    assert budgets[1] == budgets[0] > 0


def test_profiled_count_leaves_later_requests_unrecorded(tmp_path,
                                                          monkeypatch):
    """The server runs every request in its own process: after a count
    with UNIKMER_TPU_PROFILE_STREAM=1 the stream profiler is off again,
    so a later request without the knob (locate, whose stages would
    record) times no stage and synchronises nothing."""
    from unikmer_tpu_torch import server
    from unikmer_tpu_torch.utils import stages

    fa = write_fa(tmp_path, 5)
    entered = []
    real = stages.StageTimes.stage

    def counted(self, name, device):
        entered.append(name)
        return real(self, name, device)

    monkeypatch.setattr(stages.StageTimes, "stage", counted)

    def request(argv, env_extra, name):
        env = base_env()
        env.update(env_extra)
        fds = [os.open(os.devnull, os.O_RDONLY),
               os.open(tmp_path / f"{name}.out", os.O_WRONLY | os.O_CREAT),
               os.open(tmp_path / f"{name}.err", os.O_WRONLY | os.O_CREAT)]
        try:
            return server._run_request(argv, str(tmp_path), env, fds)
        finally:
            for fd in fds:
                os.close(fd)

    assert request(["count", "-k", "23", "-K", "-s", str(fa), "-o", "o"],
                   {"UNIKMER_TPU_PROFILE_STREAM": "1"}, "count") == 0
    report = (tmp_path / "count.err").read_text()
    assert "# stream profile (exclusive wall per phase):" in report
    assert entered and stages._PROFILE is None
    entered.clear()
    assert request(["locate", "-g", str(fa), "o.unik"], {}, "locate") == 0
    assert (tmp_path / "locate.out").read_text()
    assert (tmp_path / "locate.err").read_text() == ""
    assert entered == []


def test_request_cleanup_releases_the_pinned_host_cache(monkeypatch):
    """After each request the server empties torch's device cache and its
    pinned host cache (the streams' uploads), so that a
    served stream keeps no pinned memory between requests."""
    from unikmer_tpu_torch import server

    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("device"))
    monkeypatch.setattr(torch._C, "_host_emptyCache",
                        lambda: calls.append("host"), raising=False)
    server._release_device_memory()
    assert calls == ["device", "host"]


def test_request_cleanup_without_device_work_touches_nothing(monkeypatch):
    """A request that ran no device work (torch not initialised on the
    card) leaves both caches alone."""
    from unikmer_tpu_torch import server

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: pytest.fail("emptied without device work"))
    server._release_device_memory()
