"""Resident server: one warm process serves many CLI calls.

A fresh process of the port pays seconds before its first kernel: the
interpreter and the imports (torch above all), the CUDA context and the
load of the kernel library.  One long-lived process holds all three;
later calls reuse them.  The port of unikmer_tpu/server.py, with the
same protocol.

Protocol (unix domain socket, one request per connection):

  client -> server:  1 byte (0x01) carrying SCM_RIGHTS fds
                     [stdin, stdout, stderr]
                     4-byte big-endian length + JSON request
                     {"argv": [...], "cwd": "...", "env": {...}}
  server -> client:  4-byte big-endian signed exit code (after the
                     command finished and its output was written
                     directly to the passed fds)

The server runs each command in-process through cli.main.main() with
fds 0/1/2 dup2'd to the client's (so native code and Python writes both
land in the client's terminal or pipes), the cwd switched and the
client's UNIKMER* environment applied for the duration.  Requests run
one after another: one card, one command at a time.  The port reads its
knobs when a call runs, so each request's environment applies to it,
but for UNIKMER_TPU_HUGEPAGE, which binds when the package is imported:
the server's own environment sets it for every request.  ``count``
under UNIKMER_TPU_HOST_COUNT=auto takes the device route here (the host
engine saves the start-up that the server has paid); =1 still selects
the host engine.  Unless -q, the server's log (its stderr) has a line
for each request: its exit code, its seconds and the launches of each
device kernel's wrapper it made.  After each request (and the warm-up)
the server hands the memory torch's caching allocator keeps back to
the card, so an idle server holds its CUDA context and little else, and
a later request's admission (ops/device_sets.fits), in the server or in
another process on the card, finds the earlier requests' memory free;
it also drops the admission's kept reading of the card, so that each
request's first admission reads the card as it finds it.

Run:    python -m unikmer_tpu_torch.server --socket /tmp/u.sock --warm
Client: UNIKMER_TPU_SERVER=/tmp/u.sock python -m unikmer_tpu_torch.cli.main count ...
        (cli.main dispatches by itself and runs the call locally when the
        socket is absent or dead)
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import sys
import time
import traceback

DEFAULT_SOCKET = "/tmp/unikmer-tpu-torch.sock"
_REQ_MAX = 1 << 20
# a command running in the server must not dispatch to the server again
_ENV_STRIP = ("UNIKMER_TPU_SERVER",)
# the device kernels' wrappers (module, function) whose launches the log
# reports for each request, by the kernel's key
_WRAPPERS = {"k1": ("ops.encode", "encode_2bit"),
             "h1": ("ops.nthash", "encode_nthash"),
             "s1": ("ops.sketch", "sketch_select"),
             "k2": ("ops.radix_sort", "radix_sort_u64"),
             "k3": ("ops.radix_sort", "radix_sort_kv_u64")}


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("client closed mid-request")
        buf += part
    return buf


def _apply_env(env: dict) -> dict:
    """Set the request's env view; return the saved state to restore."""
    saved = {}
    for k, v in env.items():
        if k in _ENV_STRIP:
            continue
        saved[k] = os.environ.get(k)
        os.environ[k] = v
    # UNIKMER* vars the client did NOT send must not leak in from a
    # previous request: clear any not in this request
    for k in list(os.environ):
        if (k.startswith("UNIKMER") and k not in env
                and k not in _ENV_STRIP and k != "UNIKMER_TPU_IN_SERVER"
                and k not in _SERVER_OWN_ENV):
            saved[k] = os.environ.pop(k)
    return saved


def _restore_env(saved: dict) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


# env vars that belong to the server process itself (captured at
# startup) and survive request-scoped clearing
_SERVER_OWN_ENV: set = set()


def _launches() -> dict:
    """Each device wrapper's launch count so far (its module looked up,
    not imported: 0 until a request imported it)."""
    out = {}
    for key, (mod, fn) in _WRAPPERS.items():
        m = sys.modules.get(f"{__package__}.{mod}")
        out[key] = getattr(m, fn).launches if m is not None else 0
    return out


def _handle(conn: socket.socket, verbose: bool) -> None:
    msg, fds, _flags, _addr = socket.recv_fds(conn, 1, 3)
    if len(fds) < 3:
        for fd in fds:
            os.close(fd)
        raise ConnectionError(f"expected 3 fds, got {len(fds)}")
    try:
        n = int.from_bytes(_recv_exact(conn, 4), "big")
        if n > _REQ_MAX:
            raise ConnectionError(f"request too large ({n} bytes)")
        req = json.loads(_recv_exact(conn, n).decode())
        argv = [str(a) for a in req.get("argv", [])]
        cwd = req.get("cwd", os.getcwd())
        env = {str(k): str(v) for k, v in req.get("env", {}).items()}
        if verbose:
            print(f"[server] {time.strftime('%H:%M:%S')} "
                  f"run: {' '.join(argv)}", file=sys.stderr, flush=True)
        t0 = time.time()
        before = _launches()
        code = _run_request(argv, cwd, env, fds)
        if verbose:
            launches = {key: n - before[key]
                        for key, n in _launches().items()}
            print(f"[server] done rc={code} in {time.time()-t0:.2f}s, "
                  f"launches {json.dumps(launches)}", file=sys.stderr,
                  flush=True)
    finally:
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass
    conn.sendall(int(code).to_bytes(4, "big", signed=True))


def _run_request(argv: list, cwd: str, env: dict, fds: list) -> int:
    old_cwd = os.getcwd()
    saved_env = _apply_env(env)
    saved_fds = [os.dup(i) for i in (0, 1, 2)]
    old_streams = (sys.stdin, sys.stdout, sys.stderr)
    old_argv = sys.argv
    for s in (sys.stdout, sys.stderr):
        try:
            s.flush()
        except Exception:
            pass
    try:
        os.chdir(cwd)
        for i, fd in zip((0, 1, 2), fds):
            os.dup2(fd, i)
        # fresh wrappers so a command closing sys.stdout (BrokenPipe
        # path) cannot take down the server's own streams
        sys.stdin = open(0, "r", closefd=False)
        sys.stdout = open(1, "w", closefd=False)
        sys.stderr = open(2, "w", closefd=False)
        sys.argv = ["unikmer-tpu-torch", *argv]
        from .cli.main import main

        try:
            return int(main(argv) or 0)
        except SystemExit as e:  # belt and braces: main() converts these
            c = e.code
            return 0 if c is None else (c if isinstance(c, int) else 255)
        except BaseException:
            traceback.print_exc()
            return 255
    finally:
        for s in (sys.stdout, sys.stderr):
            try:
                s.flush()
            except Exception:
                pass
        sys.stdin, sys.stdout, sys.stderr = old_streams
        sys.argv = old_argv
        for i, fd in zip((0, 1, 2), saved_fds):
            os.dup2(fd, i)
            os.close(fd)
        os.chdir(old_cwd)
        _restore_env(saved_env)


def _warm(pretouch: bool) -> None:
    """Open the device (the CUDA context on a card), load the kernel and
    host libraries and, with ``pretouch``, count 2^23 random bases so K1
    and K2 have launched before the first request; print each step's
    seconds."""
    import numpy as np
    import torch

    from . import _kernels, native
    from ._device import get_device

    def step(what, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"[server] {what} in {time.perf_counter() - t0:.4f} s",
              file=sys.stderr, flush=True)
        return out

    dev = get_device()
    step(f"device {dev} opened",
         lambda: torch.zeros(1, device=dev).sum().item())
    if dev.type == "cuda":
        step("kernel library loaded", _kernels.load)
    step("host library loaded", native.get_lib)
    print(f"[server] host engine: {native.engine()}", file=sys.stderr,
          flush=True)
    if pretouch:
        from .io.fastx import PackedSeqs
        from .models.count import CountConfig, count_packed

        bases = np.random.default_rng(0).integers(0, 4, size=1 << 23,
                                                  dtype=np.uint8)
        packed = PackedSeqs(bases, np.zeros(1, np.int64),
                            np.asarray([len(bases)], np.int64))
        n = step("pre-touch count of 2^23 bases", lambda: len(count_packed(
            packed, CountConfig(k=23, canonical=True), dev)))
        print(f"[server] pre-touch kept {n} codes", file=sys.stderr,
              flush=True)


def _release_device_memory() -> None:
    """Return the cached blocks of torch's allocator to the card, and the
    pinned host blocks of its host allocator (a streamed count's uploads)
    to the host, so that a served stream holds no pinned
    memory between requests, and drop the admission's kept reading of the
    card, which other processes may have changed by the next request
    (torch and the admission are looked up, not imported: a server that
    ran no device work has neither)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()
    device_sets = sys.modules.get(f"{__package__}.ops.device_sets")
    if device_sets is not None:
        device_sets.forget_free_bytes()


def serve(sock_path: str, idle_timeout: float | None = None,
          warm: bool = False, pretouch: bool = False,
          verbose: bool = True, ready_cb=None) -> None:
    global _SERVER_OWN_ENV
    _SERVER_OWN_ENV = {k for k in os.environ if k.startswith("UNIKMER")}
    os.environ["UNIKMER_TPU_IN_SERVER"] = "1"
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(sock_path)
        os.chmod(sock_path, 0o600)
        srv.listen(8)
        if warm or pretouch:
            _warm(pretouch)
            _release_device_memory()
        if idle_timeout:
            srv.settimeout(idle_timeout)
        if verbose:
            print(f"[server] listening on {sock_path}", file=sys.stderr,
                  flush=True)
        if ready_cb is not None:
            ready_cb()
        while True:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                if verbose:
                    print(f"[server] idle {idle_timeout:.0f}s — exiting",
                          file=sys.stderr, flush=True)
                break
            try:
                _handle(conn, verbose)
            except (ConnectionError, OSError) as e:
                if verbose:
                    print(f"[server] request failed: {e}",
                          file=sys.stderr, flush=True)
            except Exception:
                traceback.print_exc()
            finally:
                try:
                    conn.close()
                except OSError:
                    pass
                _release_device_memory()
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="unikmer-tpu-torch-server",
        description="resident unikmer-tpu-torch server")
    ap.add_argument("--socket", default=os.environ.get(
        "UNIKMER_TPU_SERVER", DEFAULT_SOCKET))
    ap.add_argument("--idle-timeout", type=float, default=0,
                    help="exit after N seconds with no requests "
                         "(0 = run forever)")
    ap.add_argument("--warm", action="store_true",
                    help="open the device and load the kernel and host "
                         "libraries at startup")
    ap.add_argument("--pretouch", action="store_true",
                    help="also count 2^23 bases at startup, so the "
                         "encode and sort kernels have launched (implies "
                         "--warm)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    # SIGTERM leaves through serve()'s finally, which removes the socket
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    serve(args.socket, idle_timeout=args.idle_timeout or None,
          warm=args.warm, pretouch=args.pretouch,
          verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
