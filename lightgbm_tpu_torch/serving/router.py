"""Request router over a replica fleet: retry/backoff routing,
deadline propagation, load-shedding admission, canary auto-rollback
(PyTorch port of `lightgbm_tpu/serving/router.py`).

The router is the fleet's single client-facing door (its own line-JSON
TCP front end, same protocol as a replica's) and owns three policies:

* **Routing + retry.** Requests round-robin over the ROUTABLE replicas
  (healthy + warmup-ready, from the fleet's health probes).  A
  connection error, a timeout, or a structured `shed` retries on a
  DIFFERENT replica with exponential backoff — predicts are idempotent
  (same model version, same rows, same bytes), which is what makes the
  blind retry safe.  Every hop decrements the request's `deadline_ms`,
  so a retry never outlives the client's patience and a replica never
  works on a request its caller already abandoned.

* **Load shedding / admission.** A replica whose bounded queue is full
  FAILS FAST with `shed` (coalescer.ShedError) instead of blocking;
  the router retries the request elsewhere and counts the shed.  Once
  EVERY routable replica is shedding (health-probe `shedding` flag, or
  all attempts in a request shed), the fleet-wide admission controller
  rejects with `overloaded` immediately — queueing more work into a
  saturated fleet only converts overload into timeout storms.

* **Rollout + canary auto-rollback.** `publish(model, path)` rolls the
  new version replica-by-replica (each `op=publish` loads + warms on
  the replica's background thread, then swaps atomically; a mixed
  FLEET is fine mid-roll because each coalesced batch lives inside one
  replica — the per-version grouping in coalescer.py).  With a canary
  share (`serve_canary_pct`), only ONE replica gets the candidate
  first; the router routes that share of the model's traffic to it and
  compares the score distribution online against the incumbent
  replicas (Welford mean/std over per-request mean scores — the cheap
  online form of the byte-identity guardrail `bench.py --serve-fleet`
  applies exactly).  Divergence beyond `serve_canary_max_divergence`
  sigmas or a canary error rate above `serve_canary_max_error_rate`
  triggers AUTO-ROLLBACK: the incumbent version is re-published to the
  canary replica and a `serve_rollback` event (+ counter) lands.  A
  clean canary promotes: the remaining replicas roll one at a time.

Counters (fleet `/metrics`, prefix `lgbm_`): `router_requests`,
`router_rows`, `router_retries`, `router_failed`, `serve_shed`
(router-observed sheds), `serve_overloaded`, `serve_rollback`,
`serve_publish`; gauges via `gauges_cb`: `router_p50_ms`,
`router_p99_ms`, `fleet_replicas_routable`, `fleet_replicas_down`.
"""

from __future__ import annotations

import json
import math
import socketserver
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..observability import emit_event
from ..observability.registry import LatencyWindow, global_registry
from ..observability.tracing import (MAX_SPANS_PER_REQUEST, SloTracker,
                                     SpanAssembler, TraceContext,
                                     make_span)
from ..utils import log
from .coalescer import ShedError
from .fleet import ReplicaEndpoint, ReplicaFleet
from .frontend import LineClient


class OverloadedError(RuntimeError):
    """Fleet-wide admission rejection: every routable replica is
    shedding (or shed this request's every attempt).  Retrying
    immediately is pointless — back off client-side."""


class NoReplicaError(RuntimeError):
    """No routable replica at all (fleet still warming, or every
    replica is down/unhealthy)."""


class RouterReply:
    """One routed request's outcome: result rows plus which replica and
    model version served it, how many retries it took, and the
    request's trace id (greppable in replica logs and the flight
    recorder; `op=trace` / `GET /trace/<id>` resolves it to the
    assembled waterfall when the request was sampled)."""

    __slots__ = ("preds", "version", "replica", "retries", "latency_ms",
                 "trace_id")

    def __init__(self, preds, version, replica, retries, latency_ms,
                 trace_id=None):
        self.preds = preds
        self.version = version
        self.replica = replica
        self.retries = retries
        self.latency_ms = latency_ms
        self.trace_id = trace_id


class _Welford:
    """Online mean/std (Welford) — the canary's score-distribution
    accumulator; O(1) per observation, no sample retention."""

    __slots__ = ("n", "mean", "_m2")

    def __init__(self):
        self.n = 0
        self.mean = 0.0
        self._m2 = 0.0

    def add(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self._m2 += d * (x - self.mean)

    @property
    def std(self) -> float:
        return math.sqrt(self._m2 / self.n) if self.n > 1 else 0.0


class _CanaryState:
    """One in-flight canary rollout (guarded by the router's lock)."""

    def __init__(self, model: str, path_new: str, path_old: str,
                 replica: int, pct: float):
        self.model = model
        self.path_new = path_new
        self.path_old = path_old
        self.replica = replica          # the canary arm's replica idx
        self.pct = float(pct)
        self.canary = _Welford()
        self.incumbent = _Welford()
        self.canary_errors = 0
        self.canary_requests = 0
        self.resolved: Optional[str] = None  # promoted | rolled_back
        self.reason: Optional[str] = None
        self.done = threading.Event()
        self.seq = 0                    # traffic-split counter


class Router:
    """Client-facing router over a ReplicaFleet (docs/Serving.md)."""

    def __init__(self, fleet: ReplicaFleet, config=None, **params):
        if config is None:
            from ..config import Config
            config = Config(params)
        self.fleet = fleet
        self.config = config
        self.retry_max = int(config.serve_retry_max)
        self.backoff_s = max(float(config.serve_retry_backoff_ms), 0.0) \
            / 1000.0
        self.timeout_s = float(config.serve_request_timeout_s)
        self.latency = LatencyWindow()
        self._lock = threading.Lock()
        self._rr = 0                         # round-robin cursor
        self._seq = 0                        # request counter (tracing)
        self._trace_sample = max(int(config.serve_trace_sample), 0)
        self._canaries: Dict[str, _CanaryState] = {}
        self._published: Dict[str, str] = {}  # model -> incumbent path
        self._tls = threading.local()        # per-thread replica conns
        self.frontend = None
        self.metrics_server = None
        # cross-process span assembly (docs/Observability.md
        # "Distributed tracing"): sampled requests' spans from every hop
        # join here into the op=trace / GET /trace/<id> waterfalls
        self.assembler = SpanAssembler()
        # SLO burn-rate tracking over the router's own request-outcome
        # stream (client-perceived, so retries/sheds are already folded
        # in); inert until serve_slo_p99_ms > 0
        self.slo = SloTracker(
            p99_ms=float(config.serve_slo_p99_ms),
            error_pct=float(config.serve_slo_error_pct),
            fast_window_s=float(config.serve_slo_fast_window_s),
            slow_window_s=float(config.serve_slo_slow_window_s),
            burn_threshold=float(config.serve_slo_burn_threshold))

    # ---------------------------------------------------------- connections
    def _conn_for(self, ep: ReplicaEndpoint) -> LineClient:
        """Per-(thread, replica-generation) connection: the wire is
        one-request-one-response, so router worker threads never share
        a socket; a restarted replica (new gen, new port) gets a fresh
        connection and the stale one is closed lazily."""
        pool = getattr(self._tls, "conns", None)
        if pool is None:
            pool = self._tls.conns = {}
        key = ep.idx
        conn, gen = pool.get(key, (None, -1))
        if conn is None or gen != ep.gen:
            if conn is not None:
                conn.close()
            conn = LineClient(ep.host, ep.port,
                              backoff_ms=self.backoff_s * 1000.0 or 25.0,
                              max_connect_attempts=2)
            pool[key] = (conn, ep.gen)
        return conn

    # -------------------------------------------------------------- routing
    def _pick(self, model: str, tried: set) -> Optional[ReplicaEndpoint]:
        """Choose the next replica for one attempt.  Canary traffic
        split first; then round-robin over untried, non-shedding
        routable replicas; shedding ones only as a last resort (their
        probe flag may be stale by up to the probe interval)."""
        eps = self.fleet.endpoints(model)
        if not eps:
            return None
        with self._lock:
            canary = self._canaries.get(model)
            if canary is not None and canary.resolved is None:
                canary.seq += 1
                take_canary = (canary.seq * canary.pct) % 100.0 < canary.pct
                if take_canary and canary.replica not in tried:
                    for ep in eps:
                        if ep.idx == canary.replica:
                            return ep
                # incumbent arm: never the canary replica, so the
                # reference distribution stays version-pure
                eps = [ep for ep in eps if ep.idx != canary.replica] or eps
            self._rr += 1
            cursor = self._rr
        fresh = [ep for ep in eps if ep.idx not in tried]
        if not fresh:
            return None
        ranked = ([ep for ep in fresh if not ep.shedding]
                  or fresh)
        return ranked[cursor % len(ranked)]

    def _edge_context(self, trace) -> TraceContext:
        """The trace context for one routed request: honor an incoming
        wire context (the client edge already stamped one), else
        generate here — the router IS the edge for bare clients.  Every
        request gets ids (error replies and replica logs carry the
        trace_id either way); the `sampled` flag — every
        `serve_trace_sample`-th edge-generated request — decides
        whether spans are collected and assembled."""
        ctx = TraceContext.from_wire(trace) if trace is not None else None
        if ctx is not None:
            return ctx
        with self._lock:
            self._seq += 1
            sampled = (self._trace_sample > 0
                       and self._seq % self._trace_sample == 0)
        return TraceContext.new(sampled=sampled)

    def predict(self, model: str, rows, mode: str = "predict",
                deadline_ms: Optional[float] = None,
                trace=None) -> RouterReply:
        """Route one predict with retry/backoff + deadline propagation.
        Raises OverloadedError (every attempt shed / fleet saturated),
        NoReplicaError, TimeoutError (deadline exhausted), or the
        replica's non-retryable error (bad rows, unknown model); every
        raised error carries `.trace_id` so a client-side failure is
        greppable in replica logs and the flight recorder.  `trace` is
        the wire-format context dict (honored when present, generated
        at this edge when absent); sampled requests assemble a
        cross-process span waterfall into `self.assembler`."""
        t0 = time.monotonic()
        w0 = time.time()

        def wall(mono: float) -> float:
            return w0 + (mono - t0)

        ctx = self._edge_context(trace)
        route_ctx = ctx.child()
        spans: List[Dict] = []       # router-side spans (sampled only)
        replica_spans: List[Dict] = []

        def finish_ok(reply, ep, retries) -> RouterReply:
            lat = (time.monotonic() - t0) * 1000.0
            self.latency.record(lat)
            global_registry.inc("router_requests")
            global_registry.inc("router_rows", n_rows)
            preds = np.asarray(reply["preds"])
            self._observe(model, ep, preds=preds)
            self.slo.observe(lat, ok=True)
            if ctx.sampled:
                replica_spans.extend(reply.get("spans") or ())
                spans.append(make_span(
                    route_ctx, "route", w0, wall(time.monotonic()),
                    model=model, rows=n_rows, retries=retries,
                    replica=ep.idx, deadline_ms=deadline_ms))
                self.assembler.assemble(
                    ctx.trace_id,
                    (spans + replica_spans)[:MAX_SPANS_PER_REQUEST],
                    model=model, rows=n_rows, retries=retries,
                    latency_ms=round(lat, 3), outcome="ok")
            return RouterReply(preds, reply.get("version"), ep.idx,
                               retries, lat, trace_id=ctx.trace_id)

        def fail(exc: BaseException) -> BaseException:
            """Terminal failure: stamp the trace id on the exception,
            feed the SLO tracker, and (sampled) assemble the partial
            waterfall so the failure is findable by id."""
            exc.trace_id = ctx.trace_id  # type: ignore[attr-defined]
            self.slo.observe((time.monotonic() - t0) * 1000.0, ok=False)
            if ctx.sampled:
                spans.append(make_span(
                    route_ctx, "route", w0, wall(time.monotonic()),
                    model=model, rows=n_rows, retries=retries,
                    outcome="error", error=str(exc)[:200]))
                self.assembler.assemble(
                    ctx.trace_id,
                    (spans + replica_spans)[:MAX_SPANS_PER_REQUEST],
                    model=model, outcome="error",
                    error=str(exc)[:200])
            return exc

        budget_s = (float(deadline_ms) / 1000.0
                    if deadline_ms is not None else self.timeout_s)
        deadline = t0 + budget_s
        rows_list = (rows.tolist()
                     if isinstance(rows, np.ndarray) else list(rows))
        n_rows = len(rows_list)
        tried: set = set()
        sheds = 0
        attempts_made = 0
        retries = 0
        last_error: Optional[BaseException] = None
        # fleet-wide admission: all routable replicas advertising
        # `shedding` means the fleet is saturated — reject before
        # burning a round trip (the `overloaded` contract)
        eps = self.fleet.endpoints(model)
        if eps and all(ep.shedding for ep in eps):
            global_registry.inc("serve_overloaded")
            raise fail(OverloadedError(
                f"fleet overloaded: all {len(eps)} routable replicas "
                "are shedding"))
        for attempt in range(self.retry_max + 1):
            remaining = deadline - time.monotonic()
            if remaining <= 0.001:
                global_registry.inc("router_failed")
                raise fail(TimeoutError(
                    f"deadline_ms={deadline_ms} exhausted after "
                    f"{attempt} attempt(s)"
                    + (f" (last: {last_error})" if last_error else "")))
            ep = self._pick(model, tried)
            if ep is None:
                if not tried:
                    global_registry.inc("router_failed")
                    raise fail(NoReplicaError(
                        f"no routable replica for model {model!r} "
                        f"(fleet: {self.fleet.describe()})"))
                # every routable replica tried once; with retry budget
                # (and deadline) remaining, start a fresh round — a
                # shed or a mid-restart replica may well answer the
                # next attempt (the failures were all transient, or we
                # would have raised already)
                tried.clear()
                ep = self._pick(model, tried)
                if ep is None:
                    break
            tried.add(ep.idx)
            backoff = 0.0
            if attempt > 0:
                retries += 1
                global_registry.inc("router_retries")
                backoff = min(self.backoff_s * (2 ** (attempt - 1)),
                              max(remaining - 0.001, 0.0))
                if backoff > 0:
                    time.sleep(backoff)
                remaining = deadline - time.monotonic()
                if remaining <= 0.001:
                    continue  # the deadline check above raises
            # each attempt is its own child span context; the replica
            # parents its `serve` span under it, so the assembled
            # waterfall shows exactly which attempt did the work
            attempt_ctx = route_ctx.child()
            a_start = time.monotonic()

            def note_attempt(outcome: str) -> None:
                if ctx.sampled and len(spans) < MAX_SPANS_PER_REQUEST:
                    spans.append(make_span(
                        attempt_ctx, "attempt", wall(a_start),
                        wall(time.monotonic()), replica=ep.idx,
                        gen=ep.gen, outcome=outcome,
                        backoff_ms=round(backoff * 1000.0, 3) or None))

            msg = {"model": model, "rows": rows_list, "mode": mode,
                   "deadline_ms": max(remaining * 1000.0, 1.0),
                   "trace": attempt_ctx.to_wire()}
            attempts_made += 1
            try:
                reply = self._conn_for(ep).request(
                    msg, timeout_s=remaining + 0.25)
            except (ConnectionError, OSError) as e:
                # replica died / restarted mid-exchange: idempotent
                # predict, retry on a different replica
                last_error = e
                global_registry.inc("router_conn_errors")
                self._observe(model, ep, error=True)
                note_attempt("conn_error")
                continue
            if reply.get("ok"):
                note_attempt("ok")
                return finish_ok(reply, ep, retries)
            if reply.get("shed"):
                sheds += 1
                last_error = ShedError(reply.get("error", "shed"))
                global_registry.inc("serve_shed")
                note_attempt("shed")
                continue
            if reply.get("timeout"):
                last_error = TimeoutError(reply.get("error", "timeout"))
                global_registry.inc("router_timeouts")
                self._observe(model, ep, error=True)
                note_attempt("timeout")
                continue
            # non-retryable: the request itself is wrong (unknown
            # model, bad rows, width mismatch) — retrying cannot fix it
            global_registry.inc("router_failed")
            self._observe(model, ep, error=True)
            note_attempt("error")
            raise fail(RuntimeError(reply.get("error", "serving error")))
        global_registry.inc("router_failed")
        if sheds and sheds == attempts_made:
            global_registry.inc("serve_overloaded")
            raise fail(OverloadedError(
                f"fleet overloaded: all {sheds} attempts shed"))
        raise fail(RuntimeError(
            f"request failed after {attempts_made} attempt(s) "
            f"({retries} retries): {last_error}"))

    # -------------------------------------------------------------- rollout
    def register_incumbent(self, model: str, path: str) -> None:
        """Record the currently-published model file for `model` — the
        version a failed canary rolls BACK to.  The fleet runner calls
        this for every model it loads at startup."""
        with self._lock:
            self._published[model] = str(path)

    def publish(self, model: str, path: str,
                canary_pct: Optional[float] = None,
                timeout_s: float = 300.0) -> Dict[str, object]:
        """Roll `path` out for `model`, replica by replica.

        Plain rollout (no canary share, or nothing to roll back to):
        every routable replica gets `op=publish` in turn — each loads +
        warms in the background and swaps atomically, so the fleet is
        temporarily mixed-version but every BATCH is single-version
        (per-process coalescing).  Canary rollout: one replica gets the
        candidate and the traffic split + online comparison decide
        promotion vs auto-rollback asynchronously; this returns
        immediately with `{"canary": True, ...}` — `canary_wait()`
        blocks for the verdict."""
        pct = (float(canary_pct) if canary_pct is not None
               else float(self.config.serve_canary_pct))
        eps = self.fleet.endpoints(model) or self.fleet.endpoints()
        if not eps:
            raise NoReplicaError("no routable replica to publish to")
        with self._lock:
            incumbent = self._published.get(model)
            if self._canaries.get(model) is not None and \
                    self._canaries[model].resolved is None:
                raise RuntimeError(
                    f"a canary rollout for {model!r} is already in "
                    "flight; wait for its verdict first")
        if pct <= 0 or incumbent is None or len(eps) < 2:
            versions = self._roll(model, path,
                                  [ep.idx for ep in eps], timeout_s)
            with self._lock:
                self._published[model] = str(path)
            # relaunches must load the published version too
            self.fleet.set_model_path(model, path)
            emit_event("serve_publish", model=model, path=str(path),
                       canary=False, replicas=sorted(versions),
                       version=max(versions.values()) if versions else None)
            global_registry.inc("serve_publish")
            return {"canary": False, "replicas": versions}
        canary_ep = eps[0]
        state = _CanaryState(model, str(path), incumbent,
                             canary_ep.idx, pct)
        self._publish_one(model, path, canary_ep, timeout_s)
        with self._lock:
            self._canaries[model] = state
        emit_event("serve_publish", model=model, path=str(path),
                   canary=True, replicas=[canary_ep.idx],
                   canary_pct=pct)
        global_registry.inc("serve_publish")
        log.info(f"Canary for {model!r} live on replica "
                 f"{canary_ep.idx} ({pct:g}% of traffic)")
        return {"canary": True, "replica": canary_ep.idx, "pct": pct}

    def canary_wait(self, model: str,
                    timeout: Optional[float] = None) -> Optional[str]:
        """Block until the in-flight canary for `model` resolves;
        returns "promoted" / "rolled_back" (None: no canary)."""
        with self._lock:
            state = self._canaries.get(model)
        if state is None:
            return None
        if not state.done.wait(timeout):
            raise TimeoutError(f"canary for {model!r} unresolved after "
                               f"{timeout}s")
        return state.resolved

    def _publish_one(self, model: str, path: str, ep: ReplicaEndpoint,
                     timeout_s: float) -> int:
        reply = self._conn_for(ep).request(
            {"op": "publish", "model": model, "path": str(path),
             "timeout_s": timeout_s}, timeout_s=timeout_s)
        if not reply.get("ok"):
            raise RuntimeError(f"publish to replica {ep.idx} failed: "
                               f"{reply.get('error')}")
        return int(reply.get("version") or 0)

    def _roll(self, model: str, path: str, idxs: List[int],
              timeout_s: float) -> Dict[int, int]:
        """Sequential rolling publish: one replica at a time, so a
        load/warmup failure stops the roll with the rest of the fleet
        untouched (and still serving the incumbent)."""
        versions: Dict[int, int] = {}
        for idx in idxs:
            ep = next((e for e in self.fleet.endpoints()
                       if e.idx == idx), None)
            if ep is None:
                log.warning(f"Rolling publish: replica {idx} became "
                            "unroutable; skipping")
                continue
            versions[idx] = self._publish_one(model, path, ep, timeout_s)
            log.info(f"Rolled {model!r} v{versions[idx]} onto replica "
                     f"{idx}")
        return versions

    # --------------------------------------------------------------- canary
    def _observe(self, model: str, ep: ReplicaEndpoint,
                 preds: Optional[np.ndarray] = None,
                 error: bool = False) -> None:
        """Feed one routed outcome into the canary comparison."""
        with self._lock:
            state = self._canaries.get(model)
            if state is None or state.resolved is not None:
                return
            arm_canary = ep.idx == state.replica
            if arm_canary:
                state.canary_requests += 1
                if error:
                    state.canary_errors += 1
                elif preds is not None and preds.size:
                    state.canary.add(float(np.mean(preds)))
            elif not error and preds is not None and preds.size:
                state.incumbent.add(float(np.mean(preds)))
            verdict = self._canary_verdict(state)
            if verdict is None:
                return
            state.resolved, state.reason = verdict
        # resolve OFF the serving path: the rollback/promotion publishes
        # are blocking round trips with warmup behind them
        threading.Thread(target=self._resolve_canary, args=(state,),
                         name=f"lgbm-canary-{model}", daemon=True).start()

    @staticmethod
    def _divergence(state: _CanaryState) -> float:
        """Canary-vs-incumbent mean shift in incumbent sigmas (floored
        so a near-constant incumbent distribution cannot divide the
        shift into infinity)."""
        scale = max(state.incumbent.std,
                    1e-3 * max(abs(state.incumbent.mean), 1.0), 1e-9)
        return abs(state.canary.mean - state.incumbent.mean) / scale

    def _canary_verdict(self, state: _CanaryState):
        """(resolved, reason) once the evidence suffices, else None.
        Caller holds the lock."""
        min_n = int(self.config.serve_canary_min_samples)
        max_err = float(self.config.serve_canary_max_error_rate)
        max_div = float(self.config.serve_canary_max_divergence)
        if state.canary_requests >= max(min_n // 4, 8):
            err_rate = state.canary_errors / max(state.canary_requests, 1)
            if err_rate > max_err:
                return ("rolled_back",
                        f"canary error rate {err_rate:.3f} > {max_err}")
        if state.canary.n >= min_n and state.incumbent.n >= min_n:
            div = self._divergence(state)
            if div > max_div:
                return ("rolled_back",
                        f"score divergence {div:.3f} sigma > {max_div}")
            return ("promoted", f"divergence {div:.3f} <= {max_div}")
        return None

    def _resolve_canary(self, state: _CanaryState) -> None:
        model = state.model
        try:
            if state.resolved == "rolled_back":
                # put the incumbent back on the canary replica
                ep = next((e for e in self.fleet.endpoints()
                           if e.idx == state.replica), None)
                if ep is not None:
                    self._publish_one(model, state.path_old, ep, 300.0)
                global_registry.inc("serve_rollback")
                emit_event("serve_rollback", model=model,
                           replica=state.replica, reason=state.reason,
                           candidate=state.path_new,
                           restored=state.path_old,
                           canary_mean=state.canary.mean,
                           incumbent_mean=state.incumbent.mean,
                           canary_errors=state.canary_errors,
                           canary_requests=state.canary_requests)
                log.warning(f"Canary for {model!r} ROLLED BACK: "
                            f"{state.reason}")
            else:
                idxs = [e.idx for e in self.fleet.endpoints()
                        if e.idx != state.replica]
                self._roll(model, state.path_new, idxs, 300.0)
                with self._lock:
                    self._published[model] = state.path_new
                self.fleet.set_model_path(model, state.path_new)
                emit_event("serve_publish", model=model,
                           path=state.path_new, canary=True,
                           promoted=True, reason=state.reason)
                global_registry.inc("serve_publish")
                log.info(f"Canary for {model!r} promoted fleet-wide: "
                         f"{state.reason}")
        except Exception as e:  # noqa: BLE001 - a failed resolution must be visible, not fatal
            log.warning(f"Canary resolution for {model!r} failed: {e}")
        finally:
            state.done.set()

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, object]:
        p50, p99 = self.latency.percentiles((50.0, 99.0))
        with self._lock:
            canaries = {m: {"resolved": s.resolved, "reason": s.reason,
                            "replica": s.replica,
                            "canary_requests": s.canary_requests,
                            "canary_errors": s.canary_errors,
                            "divergence": (self._divergence(s)
                                           if s.canary.n > 1
                                           and s.incumbent.n > 1
                                           else None)}
                        for m, s in self._canaries.items()}
        return {
            "router_requests": global_registry.counter("router_requests"),
            "router_rows": global_registry.counter("router_rows"),
            "router_retries": global_registry.counter("router_retries"),
            "router_failed": global_registry.counter("router_failed"),
            "router_conn_errors":
                global_registry.counter("router_conn_errors"),
            "router_timeouts": global_registry.counter("router_timeouts"),
            "serve_shed": global_registry.counter("serve_shed"),
            "serve_overloaded":
                global_registry.counter("serve_overloaded"),
            "serve_rollback": global_registry.counter("serve_rollback"),
            "serve_publish": global_registry.counter("serve_publish"),
            "router_p50_ms": p50,
            "router_p99_ms": p99,
            "replicas": self.fleet.describe(),
            "canaries": canaries,
            "traces_assembled": len(self.assembler.ids()),
            "fleet_metrics": {
                "replicas_scraped":
                    len(self.fleet.aggregator.snapshot()),
                "latency_ms": self.fleet.aggregator.merged_latency_ms(),
            },
            **({"slo": self.slo.stats()} if self.slo.enabled else {}),
        }

    def health(self) -> Dict[str, object]:
        eps = self.fleet.endpoints()
        return {"ready": bool(eps),
                "routable": len(eps),
                "shedding": bool(eps) and all(e.shedding for e in eps),
                "replicas": self.fleet.describe()}

    def _metric_gauges(self) -> Dict[str, float]:
        """Live gauges for the /metrics page (prom.py gauges_cb)."""
        p50, p99 = self.latency.percentiles((50.0, 99.0))
        desc = self.fleet.describe()
        out = {
            "router_p50_ms": p50 if p50 is not None else float("nan"),
            "router_p99_ms": p99 if p99 is not None else float("nan"),
            "fleet_replicas_routable": float(len(self.fleet.endpoints())),
            "fleet_replicas_down": float(
                sum(1 for r in desc if r["down"])),
        }
        if self.slo.enabled:
            rates = self.slo.burn_rates()
            out["slo_burn_rate_fast"] = rates["fast"]
            out["slo_burn_rate_slow"] = rates["slow"]
        return out

    def _fleet_metrics_block(self) -> str:
        """The /metrics `text_cb`: merged per-replica scrape families
        (fleet.FleetAggregator.render)."""
        return self.fleet.aggregator.render(self.fleet.describe())

    def trace_lookup(self, trace_id: Optional[str] = None):
        """`GET /trace/<id>` / `op=trace` resolver: the assembled
        waterfall for `trace_id`, or the newest when None."""
        return (self.assembler.get(trace_id) if trace_id
                else self.assembler.latest())

    # ------------------------------------------------------------ front end
    def start_frontend(self, port: int = 0, host: str = "127.0.0.1",
                       metrics_port: int = -1) -> "RouterFrontend":
        self.frontend = start_router_frontend(self, port=port, host=host)
        if metrics_port >= 0 and self.metrics_server is None:
            from ..observability import start_metrics_http
            self.metrics_server = start_metrics_http(
                port=metrics_port, gauges_cb=self._metric_gauges,
                text_cb=self._fleet_metrics_block,
                traces_cb=self.trace_lookup)
        return self.frontend

    def stop(self) -> None:
        if self.frontend is not None:
            self.frontend.shutdown()
            self.frontend = None
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
            self.metrics_server = None


class _RouterHandler(socketserver.StreamRequestHandler):
    """Line-JSON handler: the router speaks the SAME wire protocol as a
    replica's front end, so a client cannot tell (and need not care)
    whether it is talking to one daemon or a routed fleet."""

    def _reply(self, obj) -> None:
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()

    def handle(self) -> None:
        router: Router = self.server.router
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                op = msg.get("op", "predict")
                if op == "stats":
                    self._reply({"ok": True, "stats": router.stats()})
                    continue
                if op == "health":
                    h = router.health()
                    h["ok"] = True
                    self._reply(h)
                    continue
                if op == "models":
                    models = sorted({m for ep in
                                     router.fleet.endpoints()
                                     for m in ep.versions})
                    self._reply({"ok": True, "models": models})
                    continue
                if op == "metrics":
                    from ..observability import render_prometheus
                    self._reply({"ok": True, "metrics": render_prometheus(
                        gauges_cb=router._metric_gauges,
                        text_cb=router._fleet_metrics_block)})
                    continue
                if op == "trace":
                    # debug surface: the assembled cross-process
                    # waterfall by id (or the newest sampled one)
                    tid = msg.get("trace_id") or msg.get("id")
                    trace = router.trace_lookup(tid)
                    if trace is None:
                        self._reply({"ok": False,
                                     "error": "no such trace (sampled "
                                              "out, evicted, or never "
                                              "assembled)",
                                     "retained": router.assembler
                                     .ids()[-8:]})
                    else:
                        self._reply({"ok": True, "trace": trace})
                    continue
                if op == "publish":
                    out = router.publish(
                        msg["model"], msg["path"],
                        canary_pct=msg.get("canary_pct"),
                        timeout_s=float(msg.get("timeout_s", 300.0)))
                    out["ok"] = True
                    self._reply(out)
                    continue
                r = router.predict(
                    msg.get("model", "default"), msg["rows"],
                    mode=msg.get("mode", "predict"),
                    deadline_ms=msg.get("deadline_ms"),
                    trace=msg.get("trace"))
                self._reply({"ok": True, "version": r.version,
                             "replica": r.replica, "retries": r.retries,
                             "latency_ms": round(r.latency_ms, 3),
                             "trace_id": r.trace_id,
                             "preds": np.asarray(r.preds).tolist()})
            except OverloadedError as e:
                try:
                    self._reply({"ok": False, "overloaded": True,
                                 "error": str(e),
                                 "trace_id": getattr(e, "trace_id", None)})
                except OSError:
                    return
            except ShedError as e:
                try:
                    self._reply({"ok": False, "shed": True,
                                 "error": str(e),
                                 "trace_id": getattr(e, "trace_id", None)})
                except OSError:
                    return
            except TimeoutError as e:
                try:
                    self._reply({"ok": False, "timeout": True,
                                 "error": str(e),
                                 "trace_id": getattr(e, "trace_id", None)})
                except OSError:
                    return
            except Exception as e:  # noqa: BLE001 - per-line error reply
                try:
                    self._reply({"ok": False, "error": str(e),
                                 "trace_id": getattr(e, "trace_id", None)})
                except OSError:
                    return


class RouterFrontend(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def start_router_frontend(router: Router, port: int = 0,
                          host: str = "127.0.0.1") -> RouterFrontend:
    srv = RouterFrontend((host, int(port)), _RouterHandler)
    srv.router = router
    t = threading.Thread(target=srv.serve_forever,
                         name="lgbm-router-frontend", daemon=True)
    t.start()
    log.info(f"Fleet router listening on "
             f"{srv.server_address[0]}:{srv.server_address[1]}")
    return srv
