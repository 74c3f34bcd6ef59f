"""Prometheus text-format exposition of the metrics registry (PyTorch
port of `lightgbm_tpu/observability/prom.py`): the scrape surface the
fleet, router and canary layer needs.

This module renders the process-wide registry (counters, gauges), the
serving daemon's latency window and per-model state, and the cost
model's roofline aggregates (`cost_{flops,bytes,calls}_total`) in the
Prometheus text format (version 0.0.4: `# TYPE` lines +
`name{label="v"} value`), the same page the JAX package renders for the
same contents, and serves it two ways:

* `GET /metrics` on a tiny threaded HTTP listener (`start_metrics_http`,
  param `metrics_port`: -1 off, 0 ephemeral, >0 fixed), for a
  `train()` call or a serving daemon's or router's lifetime;
* `op=metrics` on the line-JSON front end (serving/frontend.py): the
  same text inline, for clients already on that wire.

Everything renders from one `snapshot()` read: a scrape costs two dict
copies and string formatting, no device interaction, no lock held
across I/O.  Counters whose registry name carries a `::label` suffix
(e.g. `serve_requests_by_model::higgs`, maintained by the coalescer)
render as labelled series: `lgbm_serve_requests_by_model{model="higgs"}`.
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
    """Inverse of `render_prometheus`, for the fleet aggregator: parse a
    text-format page into `{"counters": {...}, "gauges": {...}}` keyed
    by the FULL series name (labels included, e.g.
    `lgbm_serve_requests_by_model{model="higgs"}`).  `# TYPE` lines
    route each family to its kind; unparseable lines are skipped (a
    replica mid-restart must never poison the merged view)."""
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


def render_prometheus(registry=None, daemon=None, prefix: str = "lgbm_",
                      extra_gauges: Optional[Dict[str, float]] = None,
                      gauges_cb=None, text_cb=None) -> str:
    """One Prometheus text page: registry counters/gauges (+ labelled
    `name::label` series), serving latency quantiles / queue depth /
    per-model state when a daemon is given, roofline aggregates when
    the cost model is enabled, and any `extra_gauges`.  `gauges_cb` is
    the LIVE form of extra_gauges — a zero-arg callable re-evaluated at
    every scrape (the fleet router feeds its p50/p99 and replica-state
    gauges through it; a static dict would freeze at registration).
    `text_cb` returns a pre-rendered text BLOCK appended verbatim —
    the fleet aggregator renders its merged multi-replica families
    through it (labelled series with non-`model` label keys, which the
    `::label` counter folding cannot express)."""
    if registry is None:
        from .registry import global_registry
        registry = global_registry
    snap = registry.snapshot()
    lines: List[str] = []

    def emit_family(kind: str, base: str,
                    series: List[tuple]) -> None:
        # series: [(labels_dict_or_None, value), ...]
        lines.append(f"# TYPE {base} {kind}")
        for labels, value in series:
            if labels:
                lab = ",".join(f'{k}="{_escape_label(v)}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{base}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{base} {_fmt(value)}")

    # registry counters: plain names become one series; `name::label`
    # names fold into one labelled family per base name
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

    if daemon is not None:
        try:
            p50, p99 = daemon.latency.percentiles((50.0, 99.0))
            emit_family("gauge", f"{prefix}serve_latency_ms",
                        [({"quantile": "0.5"}, p50),
                         ({"quantile": "0.99"}, p99)])
            emit_family("gauge", f"{prefix}serve_queue_pending",
                        [(None, daemon.coalescer.pending)])
            rstats = daemon.registry.stats()
            emit_family("gauge", f"{prefix}serve_recompiles",
                        [(None, rstats.get("serve_recompiles", 0))])
            models = rstats.get("models", {})
            for field in ("version", "in_flight"):
                emit_family(
                    "gauge", f"{prefix}serve_model_{field}",
                    [({"model": n}, m.get(field))
                     for n, m in sorted(models.items())] or [(None, 0)])
        except Exception as e:  # noqa: BLE001 - a scrape must never kill serving
            log.warning(f"/metrics: daemon stats unavailable: {e}")

    from .costmodel import global_cost_model
    if global_cost_model.enabled:
        cm = global_cost_model.snapshot()
        for field, kind in (("flops", "counter"), ("bytes", "counter"),
                            ("calls", "counter")):
            series = [({"phase": g}, tot[field])
                      for g, tot in sorted(cm.items())]
            if series:
                emit_family(kind, f"{prefix}cost_{field}_total", series)

    live = dict(extra_gauges or {})
    if gauges_cb is not None:
        try:
            live.update(gauges_cb() or {})
        except Exception as e:  # noqa: BLE001 - a scrape must never kill serving
            log.warning(f"/metrics: gauges_cb failed: {e}")
    for name, value in sorted(live.items()):
        emit_family("gauge", _metric_name(name, prefix), [(None, value)])
    if text_cb is not None:
        try:
            block = text_cb()
            if block:
                lines.append(str(block).rstrip("\n"))
        except Exception as e:  # noqa: BLE001 - a scrape must never kill serving
            log.warning(f"/metrics: text_cb failed: {e}")
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
                       daemon=None, registry=None,
                       prefix: str = "lgbm_",
                       gauges_cb=None, text_cb=None,
                       traces_cb=None) -> Optional[_MetricsServer]:
    """Bind `GET /metrics` (port 0 = ephemeral; read `server.port`) and
    serve on a background thread.  Returns None (with a warning) when
    the bind fails — a metrics port conflict must never block serving
    or training.  With `traces_cb` (a `trace_id_or_None -> dict|None`
    callable, the router's SpanAssembler) the listener also answers
    `GET /trace/<id>` — and bare `GET /trace` with the newest — as the
    assembled cross-process waterfall JSON (docs/Observability.md
    "Distributed tracing")."""
    import json as _json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - http.server API
            path = self.path.split("?", 1)[0]
            if traces_cb is not None and (path == "/trace"
                                          or path.startswith("/trace/")):
                trace_id = path[len("/trace/"):] or None \
                    if path.startswith("/trace/") else None
                try:
                    trace = traces_cb(trace_id)
                except Exception as e:  # noqa: BLE001 - debug surface must answer
                    self.send_error(500, str(e))
                    return
                if trace is None:
                    self.send_error(404, "no such trace (sampled out, "
                                         "evicted, or never assembled)")
                    return
                body = _json.dumps(trace, indent=1, default=str).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path != "/metrics":
                self.send_error(404, "try /metrics"
                                + (" or /trace/<id>" if traces_cb else ""))
                return
            try:
                body = render_prometheus(registry=registry, daemon=daemon,
                                         prefix=prefix,
                                         gauges_cb=gauges_cb,
                                         text_cb=text_cb).encode()
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
