"""Line-delimited-JSON TCP front end for the serving daemon, plus the
reconnecting client the router and remote callers use (PyTorch port of
`lightgbm_tpu/serving/frontend.py`, the same wire).

One request per line, one response per line (the reference CLI's
analogue is file-in/file-out prediction; a daemon needs a wire):

    {"model": "m", "rows": [[...], ...], "mode": "predict",
     "deadline_ms": 250}
      -> {"ok": true, "version": 2, "preds": [...]}
    {"op": "stats"}      -> {"ok": true, "stats": {...}}
    {"op": "models"}     -> {"ok": true, "models": [...]}
    {"op": "health"}     -> {"ok": true, "ready": true, "pending": 0,
                             "shedding": false, "models": {...}}
    {"op": "metrics"}    -> {"ok": true, "metrics": "<prometheus text>"}
    {"op": "publish", "model": "m", "path": "model.txt"}
      -> {"ok": true, "version": 3}

Deliberately minimal: newline-framed JSON over TCP is debuggable with
`nc`, needs no dependency, and each connection gets its own handler
thread (socketserver.ThreadingTCPServer) feeding the SAME coalescer —
concurrent connections batch together exactly like in-process clients.
Malformed input answers `{"ok": false, "error": ...}` on that line and
keeps the connection; serving errors never kill the server.

Fleet semantics:

* `deadline_ms` rides each predict request and BOUNDS the wait on this
  replica — the router decrements it by time already spent, so a
  request near its budget fails fast here instead of camping on a
  replica the client has already given up on;
* a full queue answers `{"ok": false, "shed": true, ...}` — a
  structured, retryable rejection the router maps to "try another
  replica", distinct from a caller error (bad rows, unknown model)
  which retrying cannot fix;
* `op=health` is the fleet probe (readiness = warmup ledger complete);
  `op=publish` is the rollout hook — the router rolls a new model
  version replica-by-replica through it (load + warmup on the
  replica's background thread, atomic swap at the end).
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
from typing import Optional

import numpy as np

from ..observability.tracing import TraceContext
from ..utils import log
from .coalescer import ShedError


class _Handler(socketserver.StreamRequestHandler):
    def _reply(self, obj) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()

    def handle(self) -> None:
        daemon = self.server.serving_daemon
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            trace_id = None   # echoed on EVERY reply shape, errors included
            try:
                msg = json.loads(line)
                op = msg.get("op", "predict")
                ctx = TraceContext.from_wire(msg.get("trace"))
                trace_id = ctx.trace_id if ctx is not None else None
                if op == "stats":
                    self._reply({"ok": True, "stats": daemon.stats()})
                    continue
                if op == "models":
                    self._reply({"ok": True,
                                 "models": daemon.registry.names()})
                    continue
                if op == "health":
                    # the fleet probe: cheap (no device interaction),
                    # answered even while models are still warming
                    h = daemon.health()
                    h["ok"] = True
                    self._reply(h)
                    continue
                if op == "metrics":
                    # the Prometheus text page inline, for clients
                    # already on this wire (the HTTP listener on
                    # `metrics_port` is the scraper-facing surface)
                    from ..observability import render_prometheus
                    self._reply({"ok": True,
                                 "metrics": render_prometheus(
                                     daemon=daemon)})
                    continue
                if op == "publish":
                    # rollout hook: load + warm the new version on the
                    # registry's background thread, swap atomically,
                    # answer with the live version.  block=True — the
                    # ROUTER paces the rollout replica-by-replica, so
                    # the reply must mean "this replica serves it now"
                    daemon.registry.register(
                        msg["model"], model_file=msg["path"], block=True,
                        timeout=msg.get("timeout_s"))
                    self._reply({"ok": True,
                                 "version": daemon.registry
                                 .versions().get(msg["model"])})
                    continue
                rows = np.asarray(msg["rows"], np.float64)
                timeout_s = self.server.request_timeout_s
                deadline_ms = msg.get("deadline_ms")
                if deadline_ms is not None:
                    # fail fast below 1 ms remaining: even a warm
                    # coalesced dispatch cannot answer inside that, and
                    # the router's per-hop decrement clamps forwarded
                    # deadlines to >= 1 ms — so sub-millisecond budgets
                    # only arrive from clients that have already given
                    # up (deterministic, instead of racing the
                    # dispatcher for a microsecond future wait)
                    if float(deadline_ms) < 1.0:
                        raise TimeoutError(
                            "deadline_ms exhausted before dispatch")
                    timeout_s = min(timeout_s, float(deadline_ms) / 1000.0)
                fut = daemon.submit(msg.get("model", "default"), rows,
                                    mode=msg.get("mode", "predict"),
                                    trace=ctx)
                out = fut.result(timeout=timeout_s)
                reply = {"ok": True, "version": fut.version,
                         "latency_ms": round(fut.latency_ms, 3),
                         "preds": np.asarray(out).tolist()}
                if trace_id is not None:
                    reply["trace_id"] = trace_id
                    # sampled context: the replica-side child spans ride
                    # the envelope back to the router's SpanAssembler
                    spans = fut.spans
                    if spans:
                        reply["spans"] = spans
                self._reply(reply)
            except ShedError as e:
                # structured shed: retryable elsewhere, by contract
                try:
                    self._reply({"ok": False, "shed": True,
                                 "error": str(e), "pending": e.pending,
                                 "trace_id": trace_id})
                except OSError:
                    return
            except TimeoutError as e:
                try:
                    self._reply({"ok": False, "timeout": True,
                                 "error": str(e), "trace_id": trace_id})
                except OSError:
                    return
            except Exception as e:  # noqa: BLE001 - per-line error reply
                try:
                    self._reply({"ok": False, "error": str(e),
                                 "trace_id": trace_id})
                except OSError:
                    return  # peer went away mid-reply


class ServeFrontend(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ServeUdsFrontend(socketserver.ThreadingUnixStreamServer):
    """The SAME line-JSON wire over a Unix domain socket
    (`serve_uds_path`): one handler class serves both transports, so
    predict/publish/health/metrics/trace behave identically — no TCP
    stack, no port allocation, natural for same-host sidecars."""
    allow_reuse_address = True
    daemon_threads = True


def start_frontend(daemon, port: int = 0, host: str = "127.0.0.1",
                   request_timeout_s: float = 60.0) -> ServeFrontend:
    """Bind (port 0 = ephemeral) and serve on a background thread.
    Returns the server; `server.server_address[1]` is the bound port and
    `server.shutdown()` stops it (the daemon drain path calls that).
    `request_timeout_s` (param `serve_request_timeout_s`) bounds each
    request's wait when the caller sends no `deadline_ms`."""
    srv = ServeFrontend((host, int(port)), _Handler)
    srv.serving_daemon = daemon
    srv.request_timeout_s = float(request_timeout_s)
    t = threading.Thread(target=srv.serve_forever,
                         name="lgbm-serve-frontend", daemon=True)
    t.start()
    log.info(f"Serving front end listening on "
             f"{srv.server_address[0]}:{srv.server_address[1]}")
    return srv


def start_uds_frontend(daemon, path: str,
                       request_timeout_s: float = 60.0
                       ) -> ServeUdsFrontend:
    """Bind the line-JSON wire on a Unix socket at `path` and serve on
    a background thread.  A stale socket file from a previous process
    is unlinked first (the bind would fail on it); the live socket is
    left for the OS/operator on shutdown, like any pidfile-adjacent
    artifact."""
    path = os.fspath(path)
    try:
        os.unlink(path)
    except OSError:
        pass  # no stale socket — the common case
    srv = ServeUdsFrontend(path, _Handler)
    srv.serving_daemon = daemon
    srv.request_timeout_s = float(request_timeout_s)
    t = threading.Thread(target=srv.serve_forever,
                         name="lgbm-serve-uds", daemon=True)
    t.start()
    log.info(f"Serving UDS front end listening on {path}")
    return srv


class LineClient:
    """One line-JSON connection to a replica, with
    reconnect-with-backoff (a dropped TCP connection does not raise
    straight to the caller).

    NOT thread-safe by design: the wire is strictly
    one-request-one-response per connection, so each router worker
    thread owns its own LineClient (thread-local pool).  `request()`
    reconnects lazily — when the socket is gone it retries the
    CONNECT with exponential backoff inside the deadline; it never
    silently re-SENDS a request on a connection that died mid-exchange
    (the caller decides whether the operation is idempotent enough to
    retry, which for predicts the router does, on a different
    replica)."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None,
                 connect_timeout_s: float = 5.0,
                 backoff_ms: float = 25.0, max_connect_attempts: int = 4,
                 uds_path: Optional[str] = None):
        if (uds_path is None) == (host is None or port is None):
            raise ValueError("LineClient needs either host+port (TCP) or "
                             "uds_path (Unix socket)")
        self.host = host
        self.port = int(port) if port is not None else None
        self.uds_path = os.fspath(uds_path) if uds_path else None
        self._connect_timeout_s = float(connect_timeout_s)
        self._backoff_ms = float(backoff_ms)
        self._max_connect_attempts = max(int(max_connect_attempts), 1)
        self._sock: Optional[socket.socket] = None
        self._file = None

    @property
    def _peer(self) -> str:
        return self.uds_path if self.uds_path is not None \
            else f"{self.host}:{self.port}"

    def _open_socket(self, timeout: float) -> socket.socket:
        if self.uds_path is None:
            return socket.create_connection((self.host, self.port),
                                            timeout=timeout)
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(timeout)
            s.connect(self.uds_path)
        except OSError:
            s.close()
            raise
        return s

    # ------------------------------------------------------------ plumbing
    def _connect(self, deadline: Optional[float]) -> None:
        delay = self._backoff_ms / 1000.0
        last: Optional[Exception] = None
        for attempt in range(self._max_connect_attempts):
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                timeout = self._connect_timeout_s
                if deadline is not None:
                    timeout = min(timeout,
                                  max(deadline - time.monotonic(), 0.05))
                self._sock = self._open_socket(timeout)
                self._file = self._sock.makefile("rwb")
                return
            except OSError as e:
                last = e
                self.close()
                if attempt + 1 < self._max_connect_attempts:
                    time.sleep(delay)
                    delay *= 2
        raise ConnectionError(
            f"could not connect to {self._peer} within "
            f"{self._max_connect_attempts} attempts: {last}")

    def close(self) -> None:
        for obj in (self._file, self._sock):
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass
        self._file = None
        self._sock = None

    @property
    def connected(self) -> bool:
        return self._sock is not None

    # ------------------------------------------------------------- request
    def request(self, msg: dict, timeout_s: Optional[float] = None) -> dict:
        """One request -> one decoded reply.  Reconnects (with backoff)
        when the connection is gone BEFORE sending; a connection that
        dies mid-exchange raises ConnectionError and is closed — the
        caller owns the retry decision."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        if self._sock is None:
            self._connect(deadline)
        try:
            # per-exchange socket timeout; a bounded default even with
            # no explicit deadline — a vanished peer must never wedge a
            # router worker forever
            self._sock.settimeout(max(timeout_s, 0.05)
                                  if timeout_s is not None else 120.0)
            self._file.write((json.dumps(msg) + "\n").encode())
            self._file.flush()
            line = self._file.readline()
        except (OSError, ValueError) as e:
            self.close()
            raise ConnectionError(
                f"connection to {self._peer} failed "
                f"mid-request: {e}") from e
        if not line:
            self.close()
            raise ConnectionError(
                f"connection to {self._peer} closed by peer")
        try:
            return json.loads(line)
        except ValueError as e:
            self.close()
            raise ConnectionError(
                f"malformed reply from {self._peer}: "
                f"{line[:128]!r}") from e
