"""Request coalescing: a bounded queue + one dispatcher thread (PyTorch
port of `lightgbm_tpu/serving/coalescer.py`).

The card serves a 4096-row padded bucket in about the time it serves 4
rows: per-dispatch overhead (host -> device copy, the traversal's
launches, the copy back) dominates tiny batches.  So concurrent small requests are MERGED: the
coalescer thread pops the first queued request, drains more for up to
`serve_max_coalesce_wait_ms` (bounded by `serve_max_batch_rows`), and
dispatches ONE padded bucket per (model entry, mode, width) group, then
splits the result rows back per request.  The wait knob is the explicit
batching-efficiency vs p99 trade: 0 disables waiting (drain whatever is
already queued, lowest latency), larger values build fuller buckets.

Invariants the tests pin:
* order/identity — responses are row-slices of the request's own rows;
  grouping keys include the model ENTRY (a specific version acquired at
  submit), so a hot swap can never cross-wire rows between versions;
* bounded queue, shed fast — a full queue FAILS the submit immediately
  with the structured `ShedError` instead of blocking the submitter:
  a blocked frontend thread turns one slow replica into a
  stalled fleet, while a structured shed lets the router retry the
  request on another replica within its deadline.  `serve_shed` counts
  every shed and `last_shed_age_s()` feeds the health probe's
  `shedding` flag so the fleet admission controller can reject before
  even trying;
* drain — `stop(drain=True)` completes every queued request before the
  thread exits (the SIGTERM path), failed dispatches park the error on
  every affected future rather than killing the thread, and requests
  the drain DEADLINE abandons are counted and announced with one
  `serve_drain_abandoned` event (sync write path — stop() runs from
  the SIGTERM hook) instead of disappearing silently.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability.flightrec import flight_recorder
from ..observability.registry import LatencyWindow, global_registry
from ..observability.tracing import (MAX_SPANS_PER_REQUEST, TraceContext,
                                     make_span)
from ..utils import log
from ..utils.timer import global_timer


class ShedError(RuntimeError):
    """Structured load-shed rejection: the replica's bounded queue is
    full (or a serve_shed fault forced the path), so this submit failed
    FAST instead of blocking.  Idempotent predicts make a retry on a
    different replica safe — the router does exactly that, and answers
    `overloaded` only once every replica sheds."""

    def __init__(self, message: str, pending: int = 0, depth: int = 0):
        super().__init__(message)
        self.pending = int(pending)
        self.depth = int(depth)


class ServeFuture:
    """Completion handle for one request: result rows, model version,
    submit->response latency; `result()` blocks and re-raises errors."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self._version: Optional[int] = None
        self._latency_ms: Optional[float] = None
        self._spans: Optional[List[dict]] = None

    def _set(self, result=None, error=None, version=None,
             latency_ms=None, spans=None) -> None:
        with self._lock:
            self._result = result
            self._error = error
            self._version = version
            self._latency_ms = latency_ms
            self._spans = spans
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("Serving request did not complete in "
                               f"{timeout}s")
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._result

    @property
    def version(self) -> Optional[int]:
        with self._lock:
            return self._version

    @property
    def latency_ms(self) -> Optional[float]:
        with self._lock:
            return self._latency_ms

    @property
    def spans(self) -> Optional[List[dict]]:
        """Completed child spans for a trace-sampled request (None
        otherwise): the replica-side half of the cross-process waterfall
        the response envelope carries back to the router."""
        with self._lock:
            return self._spans


class ServeRequest:
    __slots__ = ("entry", "X", "mode", "n", "future", "t_submit",
                 "early_stop", "t_coalesce", "trace")

    def __init__(self, entry, X: np.ndarray, mode: str,
                 early_stop: Optional[Tuple[int, float]] = None,
                 trace: Optional[TraceContext] = None):
        self.entry = entry
        self.X = X
        self.mode = mode
        self.early_stop = early_stop
        self.n = int(X.shape[0])
        self.future = ServeFuture()
        self.t_submit = time.monotonic()
        # propagated trace context (docs/Observability.md "Distributed
        # tracing"): when present its id correlates this request across
        # processes; when additionally `sampled`, the dispatcher builds
        # real child spans from the stage stamps below
        self.trace = trace
        # stamped by the dispatcher when the request leaves the queue;
        # the flight recorder's stage breakdown reads it
        self.t_coalesce: Optional[float] = None


class Coalescer:
    """One dispatcher thread merging queued requests into bucket
    dispatches (docs/Serving.md)."""

    # EWMA weight of the newest inter-arrival gap (adaptive mode): ~10
    # arrivals of history, enough to ride out one odd gap without
    # lagging a real load change by more than a few requests
    _EWMA_ALPHA = 0.2

    def __init__(self, max_wait_ms: float = 2.0, queue_depth: int = 1024,
                 max_batch_rows: int = 65536,
                 latency_window: Optional[LatencyWindow] = None,
                 trace_sample: int = 0, adaptive: bool = False):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(queue_depth), 1))
        self._max_wait_s = max(float(max_wait_ms), 0.0) / 1000.0
        self._max_rows = max(int(max_batch_rows), 1)
        self._window = latency_window
        # adaptive coalescing (serve_adaptive_coalesce=auto): track an
        # EWMA of request inter-arrival gaps at submit and derive the
        # per-batch wait from it — capped at the static window under
        # burst (batch shapes unchanged), shrunk to 0 when arrivals are
        # sparse (nobody else is coming inside the window, so waiting
        # would only buy p50).  Guarded by self._lock: submit threads
        # write, the dispatcher reads.
        self._adaptive = bool(adaptive)
        self._ewma_gap_s: Optional[float] = None
        self._last_arrival: Optional[float] = None
        # flight-recorder request tracing: every `trace_sample`-th
        # request gets a full enqueue->coalesce->dispatch->settle->
        # respond stage record (0 = off); only touched by the dispatcher
        # thread, so a plain counter suffices
        self._trace_sample = max(int(trace_sample), 0)
        self._req_seq = 0
        self._stop = threading.Event()
        # set when the drain deadline has passed (or drain was not
        # requested): the dispatcher must NOT start another batch —
        # whatever is still queued gets failed as abandoned
        self._abandon = threading.Event()
        self._lock = threading.Lock()
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        # monotonic stamp of the most recent shed; the health probe's
        # `shedding` flag reads it through last_shed_age_s()
        self._last_shed: Optional[float] = None
        # requests failed by the most recent drain deadline (stop())
        self.last_abandoned = 0

    # -------------------------------------------------------------- control
    def start(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._abandon.clear()
                self._closing = False
                self._thread = threading.Thread(
                    target=self._loop, name="lgbm-serve-coalescer",
                    daemon=True)
                self._thread.start()

    @property
    def running(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def submit(self, req: ServeRequest) -> None:
        """Queue one request; a FULL queue sheds (raises ShedError)
        instead of blocking — fail fast so the router can retry on
        another replica while the deadline still has budget."""
        with self._lock:
            closing = self._closing or self._thread is None
            if not closing and self._adaptive:
                now = time.monotonic()
                if self._last_arrival is not None:
                    gap = now - self._last_arrival
                    self._ewma_gap_s = gap if self._ewma_gap_s is None \
                        else ((1.0 - self._EWMA_ALPHA) * self._ewma_gap_s
                              + self._EWMA_ALPHA * gap)
                self._last_arrival = now
        if closing:
            raise RuntimeError("Serving daemon is not accepting requests "
                               "(stopped or draining)")
        try:
            self._q.put_nowait(req)
        except queue.Full:
            self.shed(reason="queue full")

    def shed(self, reason: str = "queue full") -> None:
        """Record one load shed and raise the structured ShedError (the
        serve_shed fault point calls this to force the path)."""
        with self._lock:
            self._last_shed = time.monotonic()
        global_registry.inc("serve_shed")
        raise ShedError(
            f"request shed: {reason} "
            f"({self._q.qsize()}/{self._q.maxsize} queued); retry on "
            "another replica", pending=self._q.qsize(),
            depth=self._q.maxsize)

    def last_shed_age_s(self) -> Optional[float]:
        """Seconds since the most recent shed, None when never shed —
        the health probe's `shedding` flag is `age < window`."""
        with self._lock:
            last = self._last_shed
        return None if last is None else time.monotonic() - last

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Stop the dispatcher.  `drain=True` first completes everything
        queued (bounded by `timeout`); anything still queued after the
        deadline fails with a RuntimeError on its future.  Returns True
        when the queue fully drained."""
        with self._lock:
            self._closing = True
        drained = True
        if drain:
            deadline = (time.monotonic() + timeout) if timeout else None
            while self._q.unfinished_tasks > 0:
                if deadline is not None and time.monotonic() >= deadline:
                    drained = False
                    break
                if not self.running:
                    drained = self._q.unfinished_tasks == 0
                    break
                time.sleep(0.005)
        # past this point nothing more may dispatch: a missed drain
        # deadline (or drain=False) means the remaining queue is
        # ABANDONED, not quietly served during the thread join below
        self._abandon.set()
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            # bounded: the dispatcher pops with a 50 ms timeout and
            # re-checks the stop event, so this join is capped
            t.join(timeout=10.0)
        # fail whatever the drain deadline abandoned — and SAY SO: a
        # preemption drain that quietly dropped queued requests would
        # read as a clean exit in the event log
        leftovers: List[ServeRequest] = []
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            req.future._set(error=RuntimeError("Serving daemon stopped "
                                               "before dispatch"))
            req.entry.release()
            self._q.task_done()
        self.last_abandoned = len(leftovers)
        if leftovers:
            global_registry.inc("serve_drain_abandoned", len(leftovers))
            # sync write path: stop() runs from the SIGTERM preemption
            # hook, where the AsyncWriter may be exactly what is stuck
            # (the terminal-event rule)
            from ..observability.events import emit_event_sync
            try:
                emit_event_sync("serve_drain_abandoned",
                                abandoned=len(leftovers),
                                timeout_s=timeout)
            except Exception:  # noqa: BLE001 - telemetry must not block the exit
                pass
            log.warning(f"Serving drain abandoned {len(leftovers)} queued "
                        f"request(s) at the {timeout}s deadline")
        return drained and not leftovers

    @property
    def pending(self) -> int:
        return self._q.qsize()

    def effective_wait_s(self) -> float:
        """The wait window for the NEXT batch.  Static mode: the
        configured window unconditionally.  Adaptive mode: arrivals
        coming faster than the window (EWMA gap <= window) keep the FULL
        static window — burst batches coalesce exactly as before — while
        sparse arrivals (EWMA gap beyond the window, or no history yet)
        shrink it to 0: the expected next arrival misses the window
        anyway, so waiting only inflates p50 (docs/Serving.md)."""
        if not self._adaptive:
            return self._max_wait_s
        with self._lock:
            gap = self._ewma_gap_s
        if gap is None or gap > self._max_wait_s:
            return 0.0
        return self._max_wait_s

    # --------------------------------------------------------------- worker
    def _loop(self) -> None:
        while True:
            if self._abandon.is_set():
                return  # stop() fails the remaining queue itself
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            first.t_coalesce = time.monotonic()
            batch = [first]
            rows = first.n
            wait_s = self.effective_wait_s()
            if wait_s > 0 and not self._stop.is_set():
                deadline = time.monotonic() + wait_s
                while rows < self._max_rows:
                    rem = deadline - time.monotonic()
                    if rem <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=rem)
                    except queue.Empty:
                        break
                    nxt.t_coalesce = time.monotonic()
                    batch.append(nxt)
                    rows += nxt.n
            else:
                while rows < self._max_rows:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                    nxt.t_coalesce = time.monotonic()
                    batch.append(nxt)
                    rows += nxt.n
            try:
                # serve_slow fault point: latency injected on the
                # dispatcher thread, just before the dispatch — the
                # queue keeps filling behind it (docs/Reliability.md).
                # Unconditional (not behind active()): the one-shot spec
                # already fired at submit, arming the pending sleep.
                from ..reliability import faults
                faults.consume_serve_slow()
                self._dispatch(batch)
            finally:
                for _ in batch:
                    self._q.task_done()

    def _dispatch(self, batch: List[ServeRequest]) -> None:
        # group by (entry, mode, width): the ENTRY key pins each request
        # to the model version it acquired at submit, so a concurrent
        # hot swap splits cleanly into an old-version group and a
        # new-version group — never a mixed dispatch
        groups: Dict[tuple, List[ServeRequest]] = {}
        for req in batch:
            key = (id(req.entry), req.mode, req.X.shape[1], req.early_stop)
            groups.setdefault(key, []).append(req)
        global_registry.inc("serve_batches")
        # coalesce-shape telemetry: the batch-size histogram says what
        # the wait-knob trade actually bought (flight recorder + dump)
        flight_recorder.record_batch(len(batch),
                                     sum(r.n for r in batch))
        for reqs in groups.values():
            self._dispatch_group(reqs)

    def _dispatch_group(self, reqs: List[ServeRequest]) -> None:
        entry = reqs[0].entry
        mode = reqs[0].mode
        dp = entry.predictor
        try:
            t_dispatch = time.monotonic()
            with global_timer.scope("Serve::dispatch"):
                X = (np.concatenate([r.X for r in reqs], axis=0)
                     if len(reqs) > 1 else reqs[0].X)
                if mode == "leaf":
                    out = dp.predict_leaf(X)
                elif mode == "raw":
                    out = dp.predict_raw(X, early_stop=reqs[0].early_stop)
                else:
                    out = dp.predict(X, early_stop=reqs[0].early_stop)
            # the predictor returned a host ndarray, so the device has
            # settled by here: t_settle - t_dispatch covers pad + H2D +
            # program + D2H for the whole fused group
            t_settle = time.monotonic()
            span_map = self._group_spans(reqs, entry, mode, dp,
                                         t_dispatch, t_settle)
            off = 0
            for r in reqs:
                lat = (t_settle - r.t_submit) * 1000.0
                r.future._set(result=out[off:off + r.n],
                              version=entry.version, latency_ms=lat,
                              spans=span_map.get(id(r)))
                off += r.n
                if self._window is not None:
                    self._window.record(lat)
                self._req_seq += 1
                if self._trace_sample and \
                        self._req_seq % self._trace_sample == 0:
                    self._record_trace(r, entry, mode, len(reqs),
                                       t_dispatch, t_settle)
            global_registry.inc("serve_requests", len(reqs))
            global_registry.inc("serve_rows", int(off))
            global_registry.inc("serve_dispatches")
            # per-model serve counts + dispatch seconds: the Prometheus
            # page renders the `::name` suffix as a {model=...} label,
            # and the serving roofline divides the cost model's totals
            # by the accumulated dispatch seconds
            global_registry.inc(f"serve_requests_by_model::{entry.name}",
                                len(reqs))
            global_registry.inc(f"serve_rows_by_model::{entry.name}",
                                int(off))
            global_registry.inc("serve_dispatch_s", t_settle - t_dispatch)
        except Exception as e:  # noqa: BLE001 - a bad request must not kill the thread
            trace_ids = sorted({r.trace.trace_id for r in reqs
                                if r.trace is not None})
            log.warning(f"Serving dispatch failed for model "
                        f"{entry.name!r} v{entry.version}: {e}"
                        + (f" (traces: {', '.join(trace_ids)})"
                           if trace_ids else ""))
            global_registry.inc("serve_errors", len(reqs))
            if trace_ids:
                # failures stay greppable by trace id in the flight
                # recorder even when the client never reads the future
                flight_recorder.record_trace(
                    kind="dispatch_error", model=entry.name,
                    version=entry.version, error=str(e)[:200],
                    trace_ids=trace_ids)
            for r in reqs:
                r.future._set(error=e)
        finally:
            for r in reqs:
                r.entry.release()

    @staticmethod
    def _group_spans(reqs: List[ServeRequest], entry, mode: str, dp,
                     t_dispatch: float, t_settle: float
                     ) -> Dict[int, List[dict]]:
        """Child spans for the trace-SAMPLED requests of one fused
        dispatch: serve (submit->respond) wrapping queue
        (enqueue->coalesce), dispatch (dispatch->device-settle) and
        respond (settle->now).  The dispatch spans of all batch-mates
        CROSS-LINK (span links, OpenTelemetry-style): one physical
        device dispatch served N requests, and each request's waterfall
        says so, plus how the card's time was spent (the cost model's
        flop/byte count of exactly this dispatch, stamped by
        DevicePredictor at the dispatch site)."""
        traced = [r for r in reqs if r.trace is not None
                  and r.trace.sampled]
        if not traced:
            return {}
        # wall-clock anchors derived from ONE time.time() read: spans
        # are cross-process comparable, monotonic stamps stay the
        # latency source of truth
        m_now = time.monotonic()
        w_now = time.time()

        def wall(mono: Optional[float]) -> float:
            return w_now - (m_now - (mono if mono is not None else m_now))

        info = dp.last_dispatch_info() if hasattr(
            dp, "last_dispatch_info") else None
        group_rows = sum(r.n for r in reqs)
        # span contexts first: links need every mate's dispatch span id
        # before any span is finalized
        serve_ctxs = {id(r): r.trace.child() for r in traced}
        dispatch_ctx = {id(r): serve_ctxs[id(r)].child() for r in traced}
        anon_mates = len(reqs) - len(traced)
        out: Dict[int, List[dict]] = {}
        for r in traced:
            serve_ctx = serve_ctxs[id(r)]
            d_ctx = dispatch_ctx[id(r)]
            links = [{"trace_id": m.trace.trace_id,
                      "span_id": dispatch_ctx[id(m)].span_id}
                     for m in traced if m is not r]
            links += [{"trace_id": m.trace.trace_id}
                      for m in reqs
                      if m is not r and m.trace is not None
                      and not m.trace.sampled]
            spans = [
                make_span(serve_ctx, "serve", wall(r.t_submit), wall(None),
                          model=entry.name, version=entry.version,
                          mode=mode, rows=r.n),
                make_span(serve_ctx.child(), "queue", wall(r.t_submit),
                          wall(r.t_coalesce)),
                make_span(d_ctx, "dispatch", wall(t_dispatch),
                          wall(t_settle), links=links or None,
                          group_requests=len(reqs),
                          group_rows=group_rows,
                          unsampled_mates=anon_mates or None,
                          **(info or {})),
                make_span(serve_ctx.child(), "respond", wall(t_settle),
                          wall(None)),
            ]
            out[id(r)] = spans[:MAX_SPANS_PER_REQUEST]
        return out

    @staticmethod
    def _record_trace(r: ServeRequest, entry, mode: str,
                      group_requests: int, t_dispatch: float,
                      t_settle: float) -> None:
        """One sampled request's stage breakdown into the flight
        recorder: all stamps as ms offsets from enqueue, so a dumped
        trace reads as a waterfall without clock context."""
        t0 = r.t_submit
        ms = lambda t: (round((t - t0) * 1000.0, 3)
                        if t is not None else None)
        t_respond = time.monotonic()
        flight_recorder.record_trace(
            trace_id=flight_recorder.next_trace_id(),
            model=entry.name, version=entry.version, mode=mode,
            rows=r.n, group_requests=group_requests,
            coalesce_ms=ms(r.t_coalesce), dispatch_ms=ms(t_dispatch),
            device_settle_ms=ms(t_settle), respond_ms=ms(t_respond))
