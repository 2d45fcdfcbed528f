"""Thin client for the resident server (unikmer_tpu_torch/server.py).

Import-light on purpose: the whole point of the server is that the
client process does nothing heavy (no torch, no numpy, no native
library), just a unix-socket round trip with fd passing, so a CLI call
costs milliseconds of client CPU whatever it computes.  The port's copy
of unikmer_tpu/_client.py."""

from __future__ import annotations

import json
import os
import socket
import sys


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("server closed mid-reply")
        buf += part
    return buf


def try_server(argv: list) -> int | None:
    """Dispatch ``argv`` to the resident server if one is configured
    and reachable; returns its exit code, or None to run locally
    (no UNIKMER_TPU_SERVER set, socket dead, or already in-server)."""
    path = os.environ.get("UNIKMER_TPU_SERVER")
    if not path or os.environ.get("UNIKMER_TPU_IN_SERVER"):
        return None
    try:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.connect(path)
    except OSError:
        if os.environ.get("UNIKMER_TPU_VERBOSE"):
            print(f"[client] server {path} unreachable — running locally",
                  file=sys.stderr)
        return None
    sent = False
    try:
        env = {k: v for k, v in os.environ.items()
               if k.startswith("UNIKMER") or k in ("TMPDIR",)}
        req = json.dumps({
            "argv": [str(a) for a in argv],
            "cwd": os.getcwd(),
            "env": env,
        }).encode()
        for s in (sys.stdout, sys.stderr):
            try:
                s.flush()
            except Exception:
                pass

        def _fd(stream, default):
            try:
                return stream.fileno()
            except Exception:  # closed/captured stream (pytest, daemons)
                return default

        fds = [_fd(sys.stdin, 0), _fd(sys.stdout, 1), _fd(sys.stderr, 2)]
        socket.send_fds(conn, [b"\x01"], fds)
        conn.sendall(len(req).to_bytes(4, "big") + req)
        sent = True
        code = int.from_bytes(_recv_exact(conn, 4), "big", signed=True)
        return code
    except (OSError, ConnectionError, ValueError) as e:
        if sent:
            # The request reached the server: it may have executed
            # (partially or fully) and written to our fds / consumed
            # stdin.  Re-running locally would duplicate side effects
            # and corrupt output — fail loudly instead.
            print(f"[client] server died mid-request ({e}); NOT "
                  "re-running locally (output/side effects may be "
                  "partial)", file=sys.stderr)
            return 255
        print(f"[client] server request failed ({e}) — running locally",
              file=sys.stderr)
        return None
    finally:
        conn.close()
