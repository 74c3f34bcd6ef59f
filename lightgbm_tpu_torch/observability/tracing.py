"""Zero-dependency distributed tracing + SLO burn-rate tracking (the
PyTorch port's copy of `lightgbm_tpu/observability/tracing.py`; the same
wire form, so a trace crosses processes of either package).

Serving runs as a multi-process fleet, and the flight recorder's
sampled stage traces are per-process; this module is the shared
vocabulary that follows ONE request across client -> router -> replica
-> coalescer -> device dispatch:

* **TraceContext** — (trace_id, span_id, parent_id, sampled) propagated
  as a `trace` field on the existing line-JSON wire protocol.  The
  client or router EDGE generates a context when a request arrives
  without one and honors one that is already present; every hop that
  does work derives a child context so its spans parent correctly.
  Ids come from `os.urandom` (no interaction with training's random
  streams).

* **Spans** — plain dicts (`make_span`), deliberately JSON-ready so
  they ride the response envelope back to the router with zero
  serialization ceremony: `{trace_id, span_id, parent_id, name, ts,
  dur_ms, pid, attrs[, links]}`.  `ts` is wall-clock (`time.time()`);
  all fleet processes share a host today, and a cross-host skew shows
  up as a bounded offset in the waterfall rather than corrupt data.
  `links` attribute a COALESCED dispatch to every batch-mate request it
  served (the one-span-many-traces relation OpenTelemetry models the
  same way).

* **SpanAssembler** — router-side: joins the router's own route/attempt
  spans with the replica-returned spans into one cross-process
  waterfall, records it into the flight recorder ring, and keeps a
  bounded id-indexed map behind `op=trace` / `GET /trace/<id>`.

* **SloTracker** — multi-window burn-rate computation over the
  router's request outcomes: a request is BAD when it failed or when
  its latency exceeded `serve_slo_p99_ms`; the bad-fraction over a
  fast (default 1 min) and a slow (default 30 min) window, divided by
  the error budget `serve_slo_error_pct`, gives the burn rates.  Both
  above `serve_slo_burn_threshold` = the SLO is burning: one
  structured `slo_burn` event per onset (edge-triggered), a
  `fleet_slo_burning` gauge while it lasts, and an `slo_burn_total`
  counter — the signal the canary/auto-rollback machinery and future
  autoscaling key off.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

# spans returned in one response envelope are bounded: a pathological
# request must not balloon the reply it rides in
MAX_SPANS_PER_REQUEST = 32


def _hex_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def new_trace_id() -> str:
    return _hex_id(8)


def new_span_id() -> str:
    return _hex_id(4)


class TraceContext:
    """One hop's position in a trace (see module docstring)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None, sampled: bool = False):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_id = parent_id if parent_id is None else str(parent_id)
        self.sampled = bool(sampled)

    @classmethod
    def new(cls, sampled: bool = False) -> "TraceContext":
        """Root context, generated at the client/router edge."""
        return cls(new_trace_id(), new_span_id(), None, sampled)

    def child(self) -> "TraceContext":
        """Context for a child span: fresh span id, this span as parent."""
        return TraceContext(self.trace_id, new_span_id(), self.span_id,
                            self.sampled)

    # ----------------------------------------------------------------- wire
    def to_wire(self) -> Dict[str, object]:
        """The `trace` field of a line-JSON request."""
        out: Dict[str, object] = {"id": self.trace_id, "span": self.span_id,
                                  "sampled": self.sampled}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        return out

    @classmethod
    def from_wire(cls, obj) -> Optional["TraceContext"]:
        """Parse a request's `trace` field; None (never a raise) on
        anything malformed — a bad trace header must not fail the
        request it annotates."""
        if not isinstance(obj, dict):
            return None
        tid, sid = obj.get("id"), obj.get("span")
        if not tid or not sid:
            return None
        return cls(str(tid), str(sid), obj.get("parent"),
                   bool(obj.get("sampled")))

    def __repr__(self) -> str:  # greppable in logs
        return (f"trace={self.trace_id} span={self.span_id} "
                f"sampled={int(self.sampled)}")


def make_span(ctx: TraceContext, name: str, t_start: float, t_end: float,
              links: Optional[List[Dict[str, str]]] = None,
              **attrs) -> Dict[str, object]:
    """One completed span as a JSON-ready dict.  `t_start`/`t_end` are
    wall-clock seconds (`time.time()`); attrs with None values are
    dropped so envelopes stay small."""
    span: Dict[str, object] = {
        "trace_id": ctx.trace_id,
        "span_id": ctx.span_id,
        "parent_id": ctx.parent_id,
        "name": str(name),
        "ts": round(float(t_start), 6),
        "dur_ms": round(max(t_end - t_start, 0.0) * 1000.0, 3),
        "pid": os.getpid(),
    }
    clean = {k: v for k, v in attrs.items() if v is not None}
    if clean:
        span["attrs"] = clean
    if links:
        span["links"] = list(links)
    return span


class SpanAssembler:
    """Router-side joiner: spans from every hop -> one waterfall.

    Bounded id-indexed retention (`capacity` most recent traces) behind
    the `op=trace` / `GET /trace/<id>` debug surface; every assembled
    trace is also recorded into the flight recorder ring (kind
    `assembled_trace`), so a crash dump carries the recent cross-process
    waterfalls next to the router's own stage traces."""

    def __init__(self, capacity: int = 128):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, Dict]" = OrderedDict()
        self._capacity = max(int(capacity), 8)

    def assemble(self, trace_id: str, spans: List[Dict],
                 **meta) -> Dict[str, object]:
        """Build + retain the waterfall for one trace.  Spans sort by
        start stamp; `rel_ms` offsets each from the trace start so the
        dumped JSON reads as a waterfall without clock context."""
        spans = sorted((s for s in spans if s), key=lambda s: s.get("ts", 0))
        t0 = spans[0]["ts"] if spans else 0.0
        for s in spans:
            s["rel_ms"] = round((s["ts"] - t0) * 1000.0, 3)
        trace: Dict[str, object] = {
            "trace_id": str(trace_id),
            "ts": t0,
            "spans": spans,
            "span_count": len(spans),
            "processes": sorted({s.get("pid") for s in spans
                                 if s.get("pid") is not None}),
        }
        trace.update({k: v for k, v in meta.items() if v is not None})
        with self._lock:
            self._traces[str(trace_id)] = trace
            self._traces.move_to_end(str(trace_id))
            while len(self._traces) > self._capacity:
                self._traces.popitem(last=False)
        from .flightrec import flight_recorder
        flight_recorder.record_trace(
            kind="assembled_trace", trace_id=str(trace_id),
            spans=len(spans), processes=trace["processes"],
            **{k: v for k, v in meta.items() if v is not None})
        from .events import emit_event
        emit_event("trace_assembled", trace_id=str(trace_id),
                   spans=len(spans), processes=len(trace["processes"]),
                   **{k: v for k, v in meta.items() if v is not None})
        return trace

    def get(self, trace_id: str) -> Optional[Dict[str, object]]:
        with self._lock:
            return self._traces.get(str(trace_id))

    def latest(self) -> Optional[Dict[str, object]]:
        with self._lock:
            return next(reversed(self._traces.values()), None) \
                if self._traces else None

    def ids(self) -> List[str]:
        """Newest-last trace ids currently retained."""
        with self._lock:
            return list(self._traces)

    def traces(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._traces.values())


class SloTracker:
    """Multi-window SLO burn-rate computation (module docstring).

    `observe()` is called once per routed request outcome; the retained
    per-request records are bounded by the slow window AND a hard cap,
    so a hot router cannot hoard unbounded history.  All state is
    lock-guarded — router worker threads observe concurrently."""

    _EVAL_EVERY = 8      # evaluate burn state every N observations
    _MAX_SAMPLES = 65536

    def __init__(self, p99_ms: float, error_pct: float = 1.0,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 1800.0,
                 burn_threshold: float = 1.0):
        self.p99_ms = float(p99_ms)
        # budget: allowed bad-request fraction (1.0 pct -> 0.01)
        self.budget = max(float(error_pct), 1e-6) / 100.0
        self.fast_window_s = max(float(fast_window_s), 0.5)
        self.slow_window_s = max(float(slow_window_s), self.fast_window_s)
        self.burn_threshold = float(burn_threshold)
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=self._MAX_SAMPLES)
        self._n = 0
        self._burning = False

    @property
    def enabled(self) -> bool:
        return self.p99_ms > 0

    def observe(self, latency_ms: float, ok: bool = True,
                now: Optional[float] = None) -> None:
        """Record one request outcome; re-evaluates the burn state every
        few observations (edge-triggered `slo_burn` event on onset)."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else float(now)
        bad = (not ok) or (float(latency_ms) > self.p99_ms)
        with self._lock:
            self._samples.append((now, bad))
            self._n += 1
            evaluate = self._n % self._EVAL_EVERY == 0
        if evaluate:
            self.evaluate(now=now)

    def _window_rate(self, now: float, window_s: float) -> float:
        """Bad fraction over [now - window_s, now]; caller holds lock."""
        lo = now - window_s
        total = bad = 0
        for ts, is_bad in reversed(self._samples):
            if ts < lo:
                break
            total += 1
            bad += int(is_bad)
        return bad / total if total else 0.0

    def burn_rates(self, now: Optional[float] = None
                   ) -> Dict[str, float]:
        """{"fast": rate, "slow": rate}: window bad-fraction / budget."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            fast = self._window_rate(now, self.fast_window_s)
            slow = self._window_rate(now, self.slow_window_s)
        return {"fast": fast / self.budget, "slow": slow / self.budget}

    def evaluate(self, now: Optional[float] = None) -> bool:
        """Re-derive the burning state; emits/clears the telemetry on
        transitions.  Returns the current state."""
        rates = self.burn_rates(now=now)
        burning = (rates["fast"] > self.burn_threshold
                   and rates["slow"] > self.burn_threshold)
        with self._lock:
            onset = burning and not self._burning
            cleared = self._burning and not burning
            self._burning = burning
        from .registry import global_registry
        global_registry.set_gauge("fleet_slo_burning", 1.0 if burning
                                  else 0.0)
        if onset:
            global_registry.inc("slo_burn_total")
            from .events import emit_event
            emit_event("slo_burn",
                       slo_p99_ms=self.p99_ms,
                       error_budget_pct=self.budget * 100.0,
                       burn_rate_fast=round(rates["fast"], 3),
                       burn_rate_slow=round(rates["slow"], 3),
                       fast_window_s=self.fast_window_s,
                       slow_window_s=self.slow_window_s)
            from ..utils import log
            log.warning(
                f"SLO BURNING: p99<={self.p99_ms:g}ms budget "
                f"{self.budget * 100.0:g}% — burn rates fast="
                f"{rates['fast']:.2f} slow={rates['slow']:.2f} "
                f"(threshold {self.burn_threshold:g})")
        elif cleared:
            from ..utils import log
            log.info("SLO burn cleared")
        return burning

    @property
    def burning(self) -> bool:
        with self._lock:
            return self._burning

    def stats(self) -> Dict[str, object]:
        rates = self.burn_rates()
        return {"slo_p99_ms": self.p99_ms,
                "slo_error_budget_pct": self.budget * 100.0,
                "burn_rate_fast": round(rates["fast"], 4),
                "burn_rate_slow": round(rates["slow"], 4),
                "burning": self.burning}
