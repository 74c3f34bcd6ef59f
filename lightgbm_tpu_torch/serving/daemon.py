"""ServingDaemon: one long-lived process owning the card, serving many
models (PyTorch port of `lightgbm_tpu/serving/daemon.py`).

Composition of parts that already existed: the bucket ladder of the
tensor traversal + slice-keyed packing (inference/) and the SIGTERM
drain machinery (observability/hostio.py); the daemon wires them behind
a model registry (hot swap) and a request coalescer
(tail-latency-bounded batching).  The traversal runs on the device
named by `device_type` (the card unless the caller asks for the CPU),
and every response is byte-identical to `Booster.predict` of the
version that served it with `device_predict=true` on that device: the
traversal sums each row's leaf values in float32 in tree order, so a
row's bits depend neither on its bucket nor on its batch-mates.  The reference's
analogue is the long-lived `Predictor` the CLI keeps per model
(ref: src/application/predictor.hpp); "millions of users" needs that
predictor to be multi-model, swap-safe, and batched.

Request path: `submit()` validates and copies the rows to an immutable
float32 matrix (float64 accepted when losslessly f32-representable —
the same exactness gate as GBDT._device_predictor), acquires the
CURRENT registry entry, and queues; the coalescer thread merges queued
requests into one padded bucket dispatch and splits the rows back.
SIGTERM = drain notice: `install_signal_handlers()` reuses the
preemption-hook slot so a supervisor kill completes every queued
request, emits a final `serve_drain` event, flushes host I/O, and
re-delivers the signal (exit stays 143).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import Config
from ..inference import DevicePredictor
from ..observability import emit_event
from ..observability.costmodel import global_cost_model
from ..observability.registry import LatencyWindow, global_registry
from ..utils import log
from .coalescer import Coalescer, ServeFuture, ServeRequest
from .registry import ModelRegistry

_MODES = ("predict", "raw", "leaf")


def _as_f32_rows(X) -> np.ndarray:
    """Validate + copy request rows to an immutable float32 matrix.

    The copy is deliberate: the request sits in a queue after submit
    returns, so serving must never alias caller-owned memory the caller
    may mutate.  float64 is accepted only when losslessly
    f32-representable (NaN kept as missing) — the bit-exact routing
    argument (docs/Inference.md) needs float32 inputs; lossy float64
    is the caller's error, not a silent precision downgrade."""
    arr = np.asarray(X)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.shape[0] == 0:
        raise ValueError(f"Serving rows must be a non-empty 2-D matrix "
                         f"(got shape {arr.shape})")
    if arr.dtype == np.float32:
        return np.array(arr, np.float32, copy=True)
    if arr.dtype == np.float64 or np.issubdtype(arr.dtype, np.integer):
        x64 = arr.astype(np.float64, copy=False)
        x32 = x64.astype(np.float32)
        if bool(np.all((x32 == x64) | np.isnan(x64))):
            return x32
        raise ValueError(
            "float64 request is not losslessly float32-representable; "
            "the device traversal serves float32 (docs/Serving.md "
            "fallback matrix) — downcast client-side to accept the "
            "rounding")
    raise ValueError(f"Unsupported request dtype {arr.dtype}")


class ServingDaemon:
    """Long-lived multi-model serving daemon (threads front end).

    Parameters arrive as a `Config` (or `key=value` params), using the
    `serve_*` family plus `device_predict_min_bucket` and the
    `pred_early_stop*` knobs (early stopping runs device-side via the
    masked accumulation scan, so it serves with zero extra traces)."""

    def __init__(self, config: Optional[Config] = None, **params):
        if config is None:
            config = Config(params)
        self.config = config
        es: Optional[Tuple[int, float]] = None
        if config.pred_early_stop and config.pred_early_stop_freq > 0:
            es = (int(config.pred_early_stop_freq),
                  float(config.pred_early_stop_margin))
        self._early_stop = es
        self.latency = LatencyWindow()
        self.registry = ModelRegistry(
            min_bucket=config.device_predict_min_bucket,
            warmup_rows=config.serve_max_batch_rows,
            warmup=config.serve_warmup, early_stop=es,
            device_type=config.device_type)
        self.coalescer = Coalescer(
            max_wait_ms=config.serve_max_coalesce_wait_ms,
            queue_depth=config.serve_queue_depth,
            max_batch_rows=config.serve_max_batch_rows,
            latency_window=self.latency,
            trace_sample=config.serve_trace_sample,
            adaptive=config.serve_adaptive_coalesce == "auto")
        self._stopped = threading.Event()
        self.metrics_server = None
        # analytic cost accounting (costmodel.py): enabled for the
        # daemon's lifetime so stats()/`/metrics` carry measured MFU per
        # dispatch; warmup dispatches stay out of the ledger
        self._prev_cost_enabled = global_cost_model.enabled
        if config.roofline:
            global_cost_model.enabled = True

    # -------------------------------------------------------------- control
    def start(self) -> "ServingDaemon":
        self.coalescer.start()
        if self.config.metrics_port >= 0 and self.metrics_server is None:
            # fleet scrape surface (observability/prom.py): routers,
            # canary controllers and Prometheus pull GET /metrics here
            from ..observability import start_metrics_http
            self.metrics_server = start_metrics_http(
                port=self.config.metrics_port, daemon=self)
        emit_event("serve_start", pid=os.getpid(),
                   max_coalesce_wait_ms=self.config
                   .serve_max_coalesce_wait_ms,
                   queue_depth=self.config.serve_queue_depth,
                   max_batch_rows=self.config.serve_max_batch_rows,
                   metrics_port=(self.metrics_server.port
                                 if self.metrics_server else None))
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Stop serving: reject new submits, optionally complete the
        queued backlog (bounded), then retire every model.  Idempotent."""
        if self._stopped.is_set():
            return True
        drained = self.coalescer.stop(drain=drain, timeout=timeout)
        self.registry.close()
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
            self.metrics_server = None
        global_cost_model.enabled = self._prev_cost_enabled
        self._stopped.set()
        emit_event("serve_stop", drained=drained,
                   requests=int(global_registry.counter("serve_requests")))
        return drained

    @property
    def stopped(self) -> bool:
        return self._stopped.is_set()

    def install_signal_handlers(self) -> bool:
        """SIGTERM = drain notice: complete the queued requests (bounded
        by serve_drain_timeout_s), emit `serve_drain`, flush host I/O,
        re-deliver — the daemon analogue of training's
        checkpoint-on-demand preemption hook, riding the exact same
        hostio machinery (install_sigterm_flush + preemption hook)."""
        from ..observability import install_sigterm_flush, set_preemption_hook
        ok = install_sigterm_flush()
        if ok:
            set_preemption_hook(self._sigterm_drain)
        return ok

    def _sigterm_drain(self):
        pending = self.coalescer.pending
        drained = self.stop(drain=True,
                            timeout=self.config.serve_drain_timeout_s)
        from ..observability.events import emit_event_sync
        try:
            emit_event_sync(
                "serve_drain", pending_at_signal=int(pending),
                drained=bool(drained),
                # a missed drain deadline abandons queued requests; the
                # count rides the terminal event (and its own
                # serve_drain_abandoned event from coalescer.stop) so
                # rc=143 with drained=false is diagnosable
                abandoned=int(self.coalescer.last_abandoned),
                requests=int(global_registry.counter("serve_requests")))
        except Exception:  # noqa: BLE001 - dying anyway; flush next
            pass
        return None  # finish_preemption() flushes and re-delivers

    # -------------------------------------------------------------- serving
    def submit(self, model: str, X, mode: str = "predict",
               trace=None) -> ServeFuture:
        """Queue one request; returns its future.  Rejects (without
        queueing) unknown models, bad dtypes/shapes and feature-count
        mismatches — a malformed request must fail ITS caller, never
        poison a coalesced bucket or run a program warmup never ran.  `trace` is a
        propagated TraceContext (docs/Observability.md "Distributed
        tracing"): its id correlates this request across processes, and
        a SAMPLED context makes the dispatcher attach the replica-side
        child spans to the future (`future.spans`)."""
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES} (got {mode!r})")
        from ..reliability import faults
        if faults.active():
            # serve-side fault points (docs/Reliability.md): @N matches
            # the per-process request counter ticked here
            n = faults.serve_request_tick()
            faults.maybe_serve_crash(n)
            if faults.maybe_serve_shed(n):
                self.coalescer.shed(reason="serve_shed fault injected")
            faults.maybe_serve_slow(n)
        rows = _as_f32_rows(X)
        entry = self.registry.get(model)   # acquired; release on response
        try:
            if rows.shape[1] != entry.num_features:
                raise ValueError(
                    f"Model {model!r} serves {entry.num_features} "
                    f"features, request has {rows.shape[1]} (a varying "
                    "width would run a bucket program warmup never ran)")
            req = ServeRequest(entry, rows, mode,
                               early_stop=self._early_stop, trace=trace)
            self.coalescer.submit(req)
            return req.future
        except BaseException:
            entry.release()
            raise

    def predict(self, model: str, X, mode: str = "predict",
                timeout: Optional[float] = None, trace=None):
        """Blocking convenience wrapper over submit()."""
        return self.submit(model, X, mode=mode,
                           trace=trace).result(timeout=timeout)

    # --------------------------------------------------------------- health
    # a shed inside this window marks the replica `shedding` on the
    # health probe, so the router's admission controller can reject
    # fleet-wide BEFORE burning a round trip on a replica that just shed
    _SHED_WINDOW_S = 1.0

    def health(self) -> Dict[str, object]:
        """Readiness + load state for the fleet health probe
        (`op=health`): `ready` means every registered model finished its
        load AND its warmup ledger (a replica serving cold would pay
        first runs on live traffic), `shedding` means the bounded queue
        shed within the last second — the router skips shedding
        replicas and answers `overloaded` once all of them are.
        `device` and `dispatches` (by device type) show a replica
        serving on the card."""
        shed_age = self.coalescer.last_shed_age_s()
        pending = self.coalescer.pending
        return {
            "ready": (not self._stopped.is_set()
                      and self.registry.ready()),
            "models": {n: v for n, v in self.registry.versions().items()},
            "pending": pending,
            # a shed counts as CURRENT pressure only while the queue is
            # still backed up — one isolated shed followed by a drained
            # queue must not advertise saturation for a whole window
            "shedding": (shed_age is not None
                         and shed_age < self._SHED_WINDOW_S
                         and pending > 0),
            "stopped": self._stopped.is_set(),
            "pid": os.getpid(),
            # the port's addition: where this replica serves, and its
            # process's traversal dispatches by device type
            "device": str(self.registry.device),
            "dispatches": DevicePredictor.dispatch_counts(),
        }

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        p50, p99 = self.latency.percentiles((50.0, 99.0))
        out = {
            "serve_requests": global_registry.counter("serve_requests"),
            "serve_rows": global_registry.counter("serve_rows"),
            "serve_batches": global_registry.counter("serve_batches"),
            "serve_dispatches": global_registry.counter("serve_dispatches"),
            "serve_errors": global_registry.counter("serve_errors"),
            "serve_swaps": global_registry.counter("serve_swaps"),
            "serve_shed": global_registry.counter("serve_shed"),
            "serve_p50_ms": p50,
            "serve_p99_ms": p99,
            "queue_pending": self.coalescer.pending,
        }
        out.update(self.registry.stats())
        rl = self.roofline_stats()
        if rl is not None:
            out["roofline"] = rl
        return out

    def roofline_stats(self) -> Optional[Dict[str, object]]:
        """Measured serving roofline (costmodel.py): analytic
        flops/bytes and wall seconds accumulated AT THE DISPATCH SITE
        (DevicePredictor._run, warmup excluded), so the MFU numerator
        and denominator describe the same work.  None when the cost
        model is off or nothing dispatched yet."""
        if not global_cost_model.enabled:
            return None
        flops = float(global_registry.counter("device_predict_flops"))
        bytes_accessed = float(
            global_registry.counter("device_predict_bytes"))
        seconds = float(global_registry.counter("device_predict_s"))
        dispatches = int(
            global_registry.counter("device_predict_dispatches"))
        if dispatches <= 0:
            return None
        from ..observability.costmodel import roofline
        out = roofline(flops, bytes_accessed, seconds,
                       backend=self.registry.device.type)
        out["dispatch_s"] = round(seconds, 6)
        out["dispatches"] = dispatches
        out["measured_mfu"] = out.pop("mfu")
        return out


class ServingClient:
    """Client handle for a serving daemon — in-process (wrap the
    `ServingDaemon` directly) or remote over the line-JSON TCP wire
    (`ServingClient.connect(host, port)`).

    The in-process form is thread-safe: any number of client threads
    may call concurrently (that is the point).  The TCP form owns ONE
    connection (the wire is one-request-one-response), serializes
    calls behind a lock, and RECONNECTS with exponential backoff when
    the connection drops — a replica restart no longer raises to the
    caller on the next call.  `deadline_ms` rides
    each request: in-process it bounds the future wait; over TCP it
    propagates to the replica so the server gives up when the client
    has.

    Tracing (docs/Observability.md "Distributed tracing"): the client
    is the outermost EDGE, so every request is stamped with a fresh
    TraceContext (ids make failures greppable end to end); every
    `trace_sample`-th request is stamped SAMPLED, which makes each hop
    attach real spans.  `last_trace_id`/`last_spans` expose the most
    recent request's identity and (sampled only) replica-side spans."""

    def __init__(self, daemon: Optional[ServingDaemon] = None,
                 address: Optional[Tuple[str, int]] = None,
                 request_timeout_s: float = 60.0,
                 retry_backoff_ms: float = 25.0,
                 trace_sample: int = 0,
                 uds_path: Optional[str] = None):
        if sum(x is not None for x in (daemon, address, uds_path)) != 1:
            raise ValueError("ServingClient needs exactly one of daemon= "
                             "(in-process), address= (TCP) or uds_path= "
                             "(Unix socket)")
        self._daemon = daemon
        self._conn = None
        self._timeout_s = float(request_timeout_s)
        self._trace_sample = max(int(trace_sample), 0)
        self._trace_lock = threading.Lock()
        self._trace_seq = 0
        self.last_trace_id: Optional[str] = None
        self.last_spans = None
        if address is not None or uds_path is not None:
            from .frontend import LineClient
            if address is not None:
                self._conn = LineClient(address[0], int(address[1]),
                                        backoff_ms=retry_backoff_ms)
            else:
                self._conn = LineClient(uds_path=uds_path,
                                        backoff_ms=retry_backoff_ms)
            self._conn_lock = threading.Lock()

    @classmethod
    def connect(cls, host: str, port: int,
                request_timeout_s: float = 60.0,
                retry_backoff_ms: float = 25.0,
                trace_sample: int = 0) -> "ServingClient":
        """TCP client for a daemon's front end (`serve_port`)."""
        return cls(address=(host, port),
                   request_timeout_s=request_timeout_s,
                   retry_backoff_ms=retry_backoff_ms,
                   trace_sample=trace_sample)

    @classmethod
    def connect_uds(cls, path: str,
                    request_timeout_s: float = 60.0,
                    retry_backoff_ms: float = 25.0,
                    trace_sample: int = 0) -> "ServingClient":
        """Unix-socket client for a daemon's UDS front end
        (`serve_uds_path`) — same wire, same semantics as TCP."""
        return cls(uds_path=path,
                   request_timeout_s=request_timeout_s,
                   retry_backoff_ms=retry_backoff_ms,
                   trace_sample=trace_sample)

    def _edge_context(self, trace_ctx=None):
        """Stamp (or pass through) the request's trace context."""
        from ..observability.tracing import TraceContext
        if trace_ctx is not None:
            return trace_ctx
        with self._trace_lock:
            self._trace_seq += 1
            sampled = (self._trace_sample > 0
                       and self._trace_seq % self._trace_sample == 0)
        return TraceContext.new(sampled=sampled)

    # ---------------------------------------------------------------- wire
    def _request(self, msg: dict,
                 timeout_s: Optional[float] = None) -> dict:
        wait = self._timeout_s if timeout_s is None else timeout_s
        with self._conn_lock:
            try:
                reply = self._conn.request(msg, timeout_s=wait)
            except ConnectionError:
                # the daemon restarted between calls (hot replica
                # churn): reconnect-with-backoff and resend ONCE —
                # predict/stats/health are idempotent
                reply = self._conn.request(msg, timeout_s=wait)
        if reply.get("ok"):
            return reply
        from .coalescer import ShedError
        err = reply.get("error", "serving error")
        if reply.get("shed"):
            exc: BaseException = ShedError(
                err, pending=int(reply.get("pending", 0)))
        elif reply.get("timeout"):
            exc = TimeoutError(err)
        else:
            exc = RuntimeError(err)
        # the server echoes the request's trace id on error replies so a
        # client-side failure is greppable in replica logs / the flight
        # recorder; surface it on the raised exception too
        exc.trace_id = reply.get("trace_id")  # type: ignore[attr-defined]
        raise exc

    # ----------------------------------------------------------------- API
    def predict(self, model: str, X, mode: str = "predict",
                timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None,
                trace_ctx=None):
        ctx = self._edge_context(trace_ctx)
        if self._daemon is not None:
            if deadline_ms is not None:
                t = float(deadline_ms) / 1000.0
                timeout = t if timeout is None else min(timeout, t)
            fut = self._daemon.submit(model, X, mode=mode, trace=ctx)
            out = fut.result(timeout=timeout)
            with self._trace_lock:
                self.last_trace_id = ctx.trace_id
                self.last_spans = fut.spans
            return out
        msg = {"model": model, "rows": np.asarray(X).tolist(),
               "mode": mode, "trace": ctx.to_wire()}
        if deadline_ms is not None:
            msg["deadline_ms"] = float(deadline_ms)
        wait = timeout if timeout is not None else (
            float(deadline_ms) / 1000.0 + 1.0
            if deadline_ms is not None else None)
        reply = self._request(msg, timeout_s=wait)
        with self._trace_lock:
            self.last_trace_id = reply.get("trace_id", ctx.trace_id)
            self.last_spans = reply.get("spans")
        return np.asarray(reply["preds"])

    def predict_async(self, model: str, X,
                      mode: str = "predict") -> ServeFuture:
        if self._daemon is None:
            raise RuntimeError("predict_async is in-process only; the "
                               "TCP wire is one-request-one-response")
        return self._daemon.submit(model, X, mode=mode)

    def models(self):
        if self._daemon is not None:
            return self._daemon.registry.names()
        return self._request({"op": "models"})["models"]

    def stats(self):
        if self._daemon is not None:
            return self._daemon.stats()
        return self._request({"op": "stats"})["stats"]

    def health(self):
        if self._daemon is not None:
            return self._daemon.health()
        return self._request({"op": "health"})

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


def serve_counters_reset() -> None:
    """Zero the serve_* counters (tests and the bench isolate phases);
    the registry is process-global, so only the serving keys reset —
    including the per-model `serve_*_by_model::<name>` series and the
    dispatch-seconds accumulator."""
    for key in list(global_registry.snapshot()["counters"]):
        if key.startswith("serve_"):
            global_registry.inc(key, -global_registry.counter(key))
    log.debug("serve counters reset")
