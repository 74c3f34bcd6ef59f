"""Always-on flight recorder: the last N training iterations, in memory,
dumpable on a dying or wedged process's last breath (PyTorch port of
`lightgbm_tpu/observability/flightrec.py`, the same `flight-rank<r>.json`).

The stall watchdog's diagnosis answers "where is it stuck"; a crash
log's traceback answers "what raised".  Neither answers "what was the
run DOING just before": the per-iteration JSONL log has that, but it may
be buffered behind a hung AsyncWriter, rotated away, or on a disk the
failing rank cannot reach.  So a bounded ring keeps the recent
iteration records IN PROCESS, always on (one deque append per
iteration): iteration, wall time, per-phase ms (device split included),
device-memory gauge, rows/s.  Serving adds, as in the JAX recorder:

* sampled per-request serving traces: trace id plus the enqueue ->
  coalesce -> dispatch -> device-settle -> respond stage timestamps
  (param `serve_trace_sample`: every Nth request); in the ROUTER
  process the same ring also holds `kind: "assembled_trace"` summaries
  of the cross-process span waterfalls (observability/tracing.py
  SpanAssembler), and replicas record `kind: "dispatch_error"` entries
  carrying the failed requests' trace ids;
* a coalesce-batch-size histogram (power-of-two buckets, requests and
  rows).

`dump_flight_record` writes the ring and a registry snapshot to
`<dir>/flight-rank<r>.json` SYNCHRONOUSLY via the atomic-write path,
never through the AsyncWriter: the dump runs from the stall watchdog's
exit, the crash path and the SIGUSR2 handler, where the writer thread
may be exactly what is hung.  The read side is deliberately LOCK-FREE
(a snapshot of a deque plus retry): a signal handler interrupting the
thread that holds the recorder's lock must not deadlock on it.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..utils import atomic_write_text, log


# power-of-two histogram: bucket k counts dispatches with batch size in
# [2^k, 2^(k+1)); the last bucket is open-ended
_HIST_BUCKETS = 17


def _bucket_of(n: int) -> int:
    return min(max(int(n), 1).bit_length() - 1, _HIST_BUCKETS - 1)


class FlightRecorder:
    """Bounded in-memory ring of recent iteration records and serving
    traces."""

    def __init__(self, capacity: int = 256, trace_capacity: int = 256):
        self._iters: deque = deque(maxlen=max(int(capacity), 8))
        self._traces: deque = deque(maxlen=max(int(trace_capacity), 8))
        self._batch_req_hist = [0] * _HIST_BUCKETS
        self._batch_row_hist = [0] * _HIST_BUCKETS
        self._trace_seq = itertools.count()
        # guards appends only; every read path is lock-free on purpose
        # (signal handlers dump through here, see the module docstring)
        self._lock = threading.Lock()

    def resize(self, capacity: int) -> None:
        """Re-bound the ring (param `flight_recorder_size`); keeps the
        newest records."""
        capacity = max(int(capacity), 8)
        with self._lock:
            if self._iters.maxlen != capacity:
                self._iters = deque(self._iters, maxlen=capacity)

    def record_iteration(self, **fields) -> None:
        rec = {"ts": time.time()}
        rec.update(fields)
        with self._lock:
            self._iters.append(rec)

    def next_trace_id(self) -> int:
        return next(self._trace_seq)

    def record_trace(self, **fields) -> None:
        rec = {"ts": time.time()}
        rec.update(fields)
        with self._lock:
            self._traces.append(rec)

    def record_batch(self, num_requests: int, num_rows: int) -> None:
        with self._lock:
            self._batch_req_hist[_bucket_of(num_requests)] += 1
            self._batch_row_hist[_bucket_of(num_rows)] += 1

    @staticmethod
    def _tail_of(buf: deque, n: Optional[int]) -> List[Dict[str, Any]]:
        # lock-free: a deque snapshot can raise RuntimeError when an
        # append lands mid-iteration; retry a few times, then settle for
        # whatever copied (a partial tail beats a deadlocked handler)
        for _ in range(4):
            try:
                items = list(buf)
                return items[-n:] if n else items
            except RuntimeError:
                continue
        return []

    def tail(self, n: int = 32) -> List[Dict[str, Any]]:
        """Newest `n` iteration records (lock-free, signal-safe)."""
        return self._tail_of(self._iters, n)

    def trace_tail(self, n: int = 32) -> List[Dict[str, Any]]:
        return self._tail_of(self._traces, n)

    def contents(self) -> Dict[str, Any]:
        """Everything the recorder holds, as one JSON-ready dict
        (lock-free: it runs from signal handlers; a list copy racing one
        int increment reads a momentarily stale bucket, never a torn
        structure)."""
        return {
            "iterations": self._tail_of(self._iters, None),
            "serve_traces": self._tail_of(self._traces, None),
            "coalesce_batch_requests_hist": list(self._batch_req_hist),
            "coalesce_batch_rows_hist": list(self._batch_row_hist),
            "hist_bucket_base": 2,
        }

    def reset(self) -> None:
        with self._lock:
            self._iters.clear()
            self._traces.clear()
            self._batch_req_hist = [0] * _HIST_BUCKETS
            self._batch_row_hist = [0] * _HIST_BUCKETS


# the process-wide recorder; always on (bounded memory, O(1) appends)
flight_recorder = FlightRecorder()


def flight_file_path(directory: str, rank: int) -> str:
    return os.path.join(os.fspath(directory), f"flight-rank{rank}.json")


def dump_flight_record(directory: str, rank: int,
                       reason: str = "on_demand") -> Optional[str]:
    """Write the flight recorder + a registry snapshot to
    `<directory>/flight-rank<rank>.json`, synchronously and atomically.
    Safe from signal handlers and watchdog exit paths: lock-free reads,
    no AsyncWriter, no device call, which is why `rank` is the CALLER's
    (handlers resolve it at registration time).  Returns the path, or
    None on failure (a failed telemetry dump must never worsen the
    failure being dumped)."""
    from .registry import global_registry
    payload = {
        "kind": "flight_record",
        "reason": reason,
        "rank": int(rank),
        "pid": os.getpid(),
        "ts": time.time(),
    }
    payload.update(flight_recorder.contents())
    payload["registry"] = global_registry.snapshot_nolock()
    path = flight_file_path(directory, int(rank))
    try:
        os.makedirs(os.fspath(directory), exist_ok=True)
        atomic_write_text(path, json.dumps(payload, indent=1, default=str))
        return path
    except (OSError, ValueError) as e:
        log.warning(f"Could not write the flight record to {path}: {e}")
        return None
