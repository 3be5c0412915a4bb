"""AdminSocket — per-daemon Unix socket for live introspection.

The port's copy of ``ceph_tpu.core.admin_socket``.

Reference behavior re-created (``src/common/admin_socket.{h,cc}``;
SURVEY.md §3.1): each daemon binds ``<name>.asok``; ``ceph daemon
<sock> <command> [args]`` sends a JSON request and reads a
length-prefixed JSON reply.  Handlers register by command prefix; the
built-ins (`help`, `version`, `perf dump`, `config show/set`,
`log dump`) are wired by CephContext.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import struct
import threading
from typing import Callable

Handler = Callable[[dict], object]   # cmd dict -> JSON-serializable

# pid alone is not enough to keep paths distinct: two MiniClusters in
# one process would bind the same <name>.<pid>.asok and the second
# unlinks the first's socket out from under it
_seq = itertools.count()


def default_path(name: str) -> str:
    # the port's own prefix: a process that runs both packages counts
    # <seq> from 0 in each, and mon.0 of each would bind one path
    return f"/tmp/ceph_tpu_torch-{name}.{os.getpid()}.{next(_seq)}.asok"


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._handlers: dict[str, tuple[Handler, str]] = {}
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._stop = False
        self.register("help", lambda cmd: {
            name: desc for name, (_, desc) in sorted(
                self._handlers.items())}, "list available commands")

    def register(self, prefix: str, handler: Handler, desc: str = ""):
        if prefix in self._handlers:
            raise ValueError(f"admin command {prefix!r} already registered")
        self._handlers[prefix] = (handler, desc)

    # -- server ------------------------------------------------------------
    def start(self):
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._thread = threading.Thread(target=self._serve,
                                        name="admin_socket", daemon=True)
        self._thread.start()

    def shutdown(self):
        self._stop = True
        if self._sock:
            try:
                # connect to unblock accept()
                poke = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                poke.connect(self.path)
                poke.close()
            except OSError:
                pass
            self._sock.close()
        if self._thread:
            self._thread.join(timeout=5)
        if os.path.exists(self.path):
            os.unlink(self.path)

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._stop:
                conn.close()
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            data = b""
            while not data.endswith(b"\0"):
                part = conn.recv(65536)
                if not part:
                    break
                data += part
            req = json.loads(data.rstrip(b"\0").decode() or "{}")
            reply = self._dispatch(req)
            payload = json.dumps(reply, default=str).encode()
            conn.sendall(struct.pack("<I", len(payload)) + payload)
        except Exception as e:  # noqa: BLE001 — report, don't die
            try:
                payload = json.dumps({"error": str(e)}).encode()
                conn.sendall(struct.pack("<I", len(payload)) + payload)
            except OSError:
                pass
        finally:
            conn.close()

    def _dispatch(self, req: dict):
        prefix = req.get("prefix", "")
        # longest-prefix match ("config show" beats "config")
        best = None
        for name in self._handlers:
            if prefix == name or prefix.startswith(name + " "):
                if best is None or len(name) > len(best):
                    best = name
        if best is None:
            return {"error": f"unknown command {prefix!r}; try 'help'"}
        handler, _ = self._handlers[best]
        return handler(req)


def admin_command(sock_path: str, prefix: str, *,
                  timeout: float = 10.0, **kwargs):
    """Client side: `ceph daemon <sock> <cmd>` (tools use this).
    Bounded: a wedged daemon (accepts, never replies) must not hang
    the caller — mgr modules scrape on threads that feed beacons."""
    req = dict(kwargs)
    req["prefix"] = prefix
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(timeout)
    try:
        s.connect(sock_path)
        s.sendall(json.dumps(req).encode() + b"\0")
        s.shutdown(socket.SHUT_WR)
        hdr = b""
        while len(hdr) < 4:
            part = s.recv(4 - len(hdr))
            if not part:
                raise ConnectionError("short admin reply header")
            hdr += part
        (n,) = struct.unpack("<I", hdr)
        payload = b""
        while len(payload) < n:
            part = s.recv(n - len(payload))
            if not part:
                raise ConnectionError("short admin reply body")
            payload += part
        return json.loads(payload.decode())
    finally:
        s.close()
