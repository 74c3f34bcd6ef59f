"""Prometheus text-format exposition of the metrics registry (PyTorch
port of `lightgbm_tpu/observability/prom.py`).

`render_prometheus` renders the process-wide registry (counters,
gauges) in the Prometheus text format (version 0.0.4: `# TYPE` lines +
`name{label="v"} value`), the same page the JAX package renders for the
same registry contents; `start_metrics_http` serves it as `GET /metrics`
on a tiny threaded HTTP listener (param `metrics_port`: -1 off, 0
ephemeral, >0 fixed) for the length of a `train()` call.  Counters whose
registry name carries a `::label` suffix render as labelled series
(`name::higgs` -> `lgbm_name{model="higgs"}`).  The serving daemon's
series, the trace endpoint and the cost model's roofline totals come
with the serving slice and the cost model (ROADMAP Queue 1 item 16).

Everything renders from one `snapshot()` read: a scrape costs two dict
copies and string formatting, no device interaction, no lock held
across I/O.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from ..utils import log

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str, prefix: str) -> str:
    return prefix + _NAME_OK.sub("_", name)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(value) -> str:
    if value is None:
        return "NaN"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_prometheus_text(page: str) -> Dict[str, Dict[str, float]]:
    """Inverse of `render_prometheus`: a text-format page parsed into
    `{"counters": {...}, "gauges": {...}}` keyed by the FULL series name
    (labels included).  `# TYPE` lines route each family to its kind;
    unparseable lines are skipped."""
    out: Dict[str, Dict[str, float]] = {"counters": {}, "gauges": {}}
    kinds: Dict[str, str] = {}
    for line in page.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                kinds[parts[2]] = parts[3]
            continue
        name, sep, value = line.rpartition(" ")
        if not sep or not name:
            continue
        try:
            val = float(value)
        except ValueError:
            continue
        base = name.split("{", 1)[0]
        table = out["counters"] if kinds.get(base) == "counter" \
            else out["gauges"]
        table[name] = val
    return out


def render_prometheus(registry=None, prefix: str = "lgbm_") -> str:
    """One Prometheus text page: registry counters/gauges (+ labelled
    `name::label` series)."""
    if registry is None:
        from .registry import global_registry
        registry = global_registry
    snap = registry.snapshot()
    lines: List[str] = []

    def emit_family(kind: str, base: str, series: List[tuple]) -> None:
        # series: [(labels_dict_or_None, value), ...]
        lines.append(f"# TYPE {base} {kind}")
        for labels, value in series:
            if labels:
                lab = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{base}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{base} {_fmt(value)}")

    # plain names become one series; `name::label` names fold into one
    # labelled family per base name
    for kind, table in (("counter", snap["counters"]),
                        ("gauge", snap["gauges"])):
        families: Dict[str, List[tuple]] = {}
        for name in sorted(table):
            base, sep, label = name.partition("::")
            key = _metric_name(base, prefix)
            families.setdefault(key, []).append(
                ({"model": label} if sep else None, table[name]))
        for base, series in families.items():
            emit_family(kind, base, series)
    return "\n".join(lines) + "\n"


class _MetricsServer:
    """Tiny threaded HTTP listener exposing `GET /metrics`."""

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread

    @property
    def port(self) -> int:
        return int(self._server.server_address[1])

    def shutdown(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except OSError:
            pass


def start_metrics_http(port: int = 0, host: str = "127.0.0.1",
                       registry=None, prefix: str = "lgbm_"
                       ) -> Optional[_MetricsServer]:
    """Bind `GET /metrics` (port 0 = ephemeral; read `server.port`) and
    serve on a background thread.  Returns None (with a warning) when
    the bind fails: a metrics port conflict must never block training."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            if self.path.split("?", 1)[0] != "/metrics":
                self.send_error(404, "try /metrics")
                return
            try:
                body = render_prometheus(registry=registry,
                                         prefix=prefix).encode()
            except Exception as e:  # noqa: BLE001 - scrape must answer, not raise
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # route through utils.log
            log.debug(f"/metrics: {fmt % args}")

    try:
        srv = ThreadingHTTPServer((host, int(port)), _Handler)
    except OSError as e:
        log.warning(f"Could not bind the metrics listener on "
                    f"{host}:{port}: {e}")
        return None
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever,
                         name="lgbm-metrics-http", daemon=True)
    t.start()
    log.info(f"Prometheus /metrics listening on "
             f"{srv.server_address[0]}:{srv.server_address[1]}")
    return _MetricsServer(srv, t)
