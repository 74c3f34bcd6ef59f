"""Structured JSONL event log of a training run (PyTorch port of
`lightgbm_tpu/observability/events.py`: the same file name and the same
JSON lines).

One `EventLogger` per process writes append-only JSON lines to
`<metrics_dir>/events-rank<r>.jsonl` (rank-tagged so multi-process SPMD
runs produce one file per rank with no write contention).  Every record
carries `event`, `ts` (unix seconds) and `rank`; the `iteration` event —
one per boosting round, emitted by the `record_metrics` callback — adds
the phase-timing breakdown, eval results, tree shape stats and the
cumulative counter/gauge snapshot.

A module-level "current logger" lets deep layers (checkpoint writes,
fault injection, the memory sampler) emit events without threading a
logger handle through every call: `engine.train` installs its logger for
the duration of the run and `emit_event(...)` is a no-op outside one.
Writes are flushed per event so a crashed run's log is complete up to
the failure.

Multi-day runs: `rotate_mb` (param `metrics_rotate_mb`, 0 = off) caps
the live file's size — when an emit would push `events-rank<r>.jsonl`
past the cap, existing rollovers shift up (`.1` -> `.2`, ...), the live
file becomes `.1`, and a fresh live file is opened.  Newest events are
always in the unsuffixed file; history is unbounded by design (the
operator prunes old `.N` files, the logger never deletes data).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

import numpy as np

from .registry import process_rank


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, (np.floating, np.float32, np.float64)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


class EventLogger:
    """Append-only JSONL writer for one process of one run.

    With `writer` (an observability.hostio.AsyncWriter) the file append
    runs on the writer thread: emit() serializes the record on the
    calling thread (field values and `ts` are captured at emit time)
    and queues only the finished line, so async and sync runs produce
    byte-identical logs in the same order (single FIFO worker)."""

    def __init__(self, directory: str, rank=None, rotate_mb: float = 0,
                 writer=None):
        self.dir = os.fspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.rank = process_rank() if rank is None else rank
        self.path = os.path.join(self.dir, f"events-rank{self.rank}.jsonl")
        self.rotate_bytes = int(float(rotate_mb) * (1 << 20))
        self.writer = writer
        # the stall watchdog embeds the run's last record in its
        # diagnosis: the "how far did we get" marker
        self.last_record = None
        # serializes appends against rotation's handle swap: _append
        # runs on the writer thread in async mode but on the calling
        # thread in sync mode, and both coexist around train end
        self._io_lock = threading.RLock()
        self._fh = open(self.path, "a")

    def _rotate(self) -> None:
        """Shift events-rank<r>.jsonl -> .1 -> .2 -> ... and reopen."""
        with self._io_lock:
            self._fh.close()
            n = 1
            while os.path.exists(f"{self.path}.{n}"):
                n += 1
            for i in range(n, 1, -1):
                os.replace(f"{self.path}.{i - 1}", f"{self.path}.{i}")
            os.replace(self.path, f"{self.path}.1")
            self._fh = open(self.path, "a")

    def _record(self, event: str, fields) -> str:
        rec = {"event": event, "ts": time.time(), "rank": self.rank}
        rec.update(fields)
        self.last_record = rec
        return json.dumps(rec, default=_json_default) + "\n"

    def emit(self, event: str, **fields) -> None:
        line = self._record(event, fields)
        if self.writer is not None:
            self.writer.submit(self._append, line)
        else:
            self._append(line)

    def emit_sync(self, event: str, **fields) -> None:
        """Terminal-path emit for DYING processes: the SIGTERM handler
        and the stall watchdog's exit path must record their final
        event even when the AsyncWriter worker is wedged — queueing
        through `submit` would block forever on a full bounded queue
        (a signal-handler hazard).  The
        record is appended on THIS thread through a private O_APPEND
        handle: no queue, no shared-handle lock a hung worker could be
        holding; one JSONL line is a single buffered write, flushed on
        close, so it cannot interleave mid-record with the worker."""
        line = self._record(event, fields)
        try:
            with open(self.path, "a") as f:
                f.write(line)
        except OSError:
            pass  # a failed telemetry write must never block the exit

    def _append(self, line: str) -> None:
        with self._io_lock:
            if self.rotate_bytes > 0 and self._fh.tell() \
                    and self._fh.tell() + len(line) > self.rotate_bytes:
                try:
                    self._rotate()
                except OSError:
                    pass  # a failed rotation must never kill training
            self._fh.write(line)
            self._fh.flush()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Land every queued record on disk (bounded wait in async mode:
        the SIGTERM handler calls this and must not wedge the exit).
        The handle flush deliberately takes NO lock: a wedged worker
        holding `_io_lock` must not deadlock the terminal flush, and a
        handle closed mid-rotation lands in the except below."""
        try:
            if self.writer is not None:
                self.writer.flush(timeout=timeout)
            self._fh.flush()
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        try:
            if self.writer is not None:
                self.writer.flush()
            self._fh.close()
        except OSError:
            pass


_current: Optional[EventLogger] = None


def set_event_logger(logger: Optional[EventLogger]) -> None:
    """Install (or clear, with None) the run-scoped event logger that
    `emit_event` routes to."""
    global _current
    _current = logger


def get_event_logger() -> Optional[EventLogger]:
    return _current


def emit_event(event: str, **fields) -> None:
    """Emit through the current run's logger; silently a no-op when no
    run is recording (so instrumented subsystems cost nothing outside
    metrics runs)."""
    if _current is not None:
        try:
            _current.emit(event, **fields)
        except (OSError, ValueError):
            pass  # a failed telemetry write must never kill training


def emit_event_sync(event: str, **fields) -> None:
    """`emit_event` for a process on its way out: routes around the
    AsyncWriter queue and the shared file handle entirely (see
    EventLogger.emit_sync).  The SIGTERM flush and the stall watchdog's
    exit path call this: terminal records are written synchronously,
    never via the possibly-hung AsyncWriter."""
    if _current is not None:
        try:
            _current.emit_sync(event, **fields)
        except (OSError, ValueError):
            pass
