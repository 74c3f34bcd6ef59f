"""Bounded single-worker host-I/O thread (PyTorch port of
`lightgbm_tpu/observability/hostio.py`).

CUDA launches are asynchronous, so the training loop only goes as fast
as its slowest HOST work: an inline JSONL event append or checkpoint
(model-text serialization, npz packing, fsync, rename) stalls the
launch queue for milliseconds to seconds while the card idles.
`AsyncWriter` drains that work on ONE worker thread:

* single worker + FIFO queue — writes land in submission order, so the
  event log and checkpoint rotation behave exactly like the synchronous
  path (byte-identical files);
* bounded queue — a slow disk backpressures the training loop instead
  of buffering unboundedly (the reference's equivalent is simply "the
  CLI blocks on fwrite");
* failure isolation — a task that raises is logged and counted
  (`host_io_errors`), never re-raised into training; checkpoint tasks
  install their own handler so a failed write still increments
  `checkpoint_failures` and training continues.

`flush()` blocks until everything queued so far has executed; the engine
flushes on train end and on error so a crashed run's log is complete up
to the failure.  After `close()`, submissions run inline (synchronous
fallback) rather than being dropped.
"""

from __future__ import annotations

import os
import queue
import signal
import threading
import time
import weakref

from ..utils import log
from .registry import global_registry

# every live AsyncWriter, so the SIGTERM flush handler can drain them
# all without the engine threading handles into the signal layer
_live_writers: "weakref.WeakSet" = weakref.WeakSet()


class AsyncWriter:
    """One daemon worker draining host-I/O callables in FIFO order."""

    def __init__(self, max_queue: int = 256):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(int(max_queue), 1))
        self._thread = None
        self._lock = threading.Lock()
        self._closed = False
        _live_writers.add(self)

    # ------------------------------------------------------------- worker
    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="lgbm-tpu-hostio", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                fn, args, kwargs = task
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - I/O must not kill training
                global_registry.inc("host_io_errors")
                log.warning(f"Async host write failed: {e}")
            finally:
                self._q.task_done()

    # -------------------------------------------------------------- API
    def submit(self, fn, *args, **kwargs) -> None:
        """Queue `fn(*args, **kwargs)` for the worker.  Blocks when the
        queue is full (bounded backpressure).  After close(), runs the
        task inline so late stragglers are never silently dropped."""
        if self._closed:
            try:
                fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001
                global_registry.inc("host_io_errors")
                log.warning(f"Host write failed: {e}")
            return
        self._ensure_thread()
        self._q.put((fn, args, kwargs))

    def flush(self, timeout: float = None) -> None:
        """Block until every task submitted so far has executed.  With
        `timeout` the wait is bounded (polling unfinished_tasks): the
        stall watchdog and the SIGTERM handler flush through here and
        must never wedge on a worker that is itself part of the hang."""
        with self._lock:
            t = self._thread
        if t is None or not t.is_alive():
            return
        if timeout is None:
            self._q.join()
            return
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._q.all_tasks_done:
                if self._q.unfinished_tasks == 0:
                    return
            time.sleep(0.02)

    def close(self) -> None:
        """Flush, stop the worker, switch to inline fallback."""
        self.flush()
        with self._lock:
            self._closed = True
            t = self._thread
            self._thread = None
        if t is not None and t.is_alive():
            self._q.put(None)
            t.join(timeout=10.0)


# --------------------------------------------------------------------------
# SIGTERM: preemption notice handling.  A supervisor kill must never drop
# the final events that would explain the failure, and a preemption
# notice with a grace window should not cost completed work either — the
# run-scoped preemption hook (engine.train) captures an out-of-band
# checkpoint before the signal is re-delivered.
# --------------------------------------------------------------------------

_sigterm_installed = False

# bound on every terminal-path drain (SIGTERM flush, stall exit): long
# enough to land a realistic queue on a healthy disk, short enough that
# a wedged worker cannot eat the whole preemption grace window.  Module
# level so the reliability drills can shorten it.
TERMINAL_FLUSH_TIMEOUT_S = 5.0

# run-scoped preemption hook: a zero-arg callable (engine.train's
# checkpoint-on-demand closure) installed for the duration of a train()
# call.  Kept out of the signal layer's signature on purpose: the
# handler is installed once per process, the hook swaps per run.
_preempt_hook = None


def set_preemption_hook(fn) -> None:
    """Install the callable the SIGTERM handler runs BEFORE flushing and
    re-delivering — the engine's bounded checkpoint-on-demand."""
    global _preempt_hook
    _preempt_hook = fn


def clear_preemption_hook() -> None:
    global _preempt_hook
    _preempt_hook = None


def finish_preemption() -> None:
    """Terminal half of preemption handling: final `sigterm` event,
    bounded host-I/O flush, then restore the default disposition and
    re-deliver — the exit status stays "killed by SIGTERM" (143), which
    supervisors classify as *preempt*.  Called by the SIGTERM handler
    directly, or by the engine's iteration boundary when the save was
    deferred past a mid-update signal.

    The queued records are drained FIRST (bounded), then the terminal
    event is written through `emit_event_sync` — NEVER the AsyncWriter:
    queueing it would block forever on a full bounded queue whose
    worker is exactly what may be hung.  With a healthy worker the order is unchanged — every
    queued record lands, then `sigterm` is the log's last line; with a
    wedged worker the flush times out and the `sigterm` record still
    lands."""
    flush_host_io(timeout=TERMINAL_FLUSH_TIMEOUT_S)
    from .events import emit_event_sync
    try:
        emit_event_sync("sigterm", pid=os.getpid())
    except Exception:  # noqa: BLE001
        pass
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def flush_host_io(timeout: float = 5.0) -> None:
    """Bounded flush of every live AsyncWriter and the run's EventLogger
    (in that order: the logger's queued appends drain through its
    writer first, then its file handle is fsync'd to the OS)."""
    for w in list(_live_writers):
        try:
            w.flush(timeout=timeout)
        except Exception:  # noqa: BLE001 - flushing must never raise
            pass
    from .events import get_event_logger
    lg = get_event_logger()
    if lg is not None:
        lg.flush(timeout=timeout)


def install_sigterm_flush() -> bool:
    """Install a SIGTERM handler that treats the signal as a PREEMPTION
    NOTICE: run the preemption hook (when a train() call installed one —
    it captures an out-of-band checkpoint inside its grace budget and
    emits a `preempt` event), emit a final `sigterm` event, drain the
    async host-I/O queue (bounded wait), then re-raise the default
    termination — so a preempted worker dies with its completed work
    checkpointed and a COMPLETE event log, and its exit status is still
    "killed by SIGTERM" (143), which `classify_returncode` maps to
    *preempt*, distinct from crash/hang.  Idempotent; returns False when
    it cannot be installed (non-main thread, platforms without SIGTERM
    handling)."""
    global _sigterm_installed
    if _sigterm_installed:
        return True

    def _handler(signum, frame):
        hook = _preempt_hook
        if hook is not None:
            # CPython delivers signals on the main thread, which IS the
            # training thread here, so the hook's state capture (the
            # score buffer's copy to the host included) runs where the
            # capture/write split expects it to.  A False return means
            # the signal landed MID-UPDATE (model/scores/iteration are
            # not a consistent triple): the hook has queued the save for
            # the iteration boundary, where the engine finishes it and
            # calls finish_preemption() itself — exiting here would
            # checkpoint a torn state.
            try:
                if hook() is False:
                    return
            except Exception as e:  # noqa: BLE001 - dying anyway; flush next
                log.warning(f"Preemption checkpoint hook failed: {e}")
        finish_preemption()

    try:
        signal.signal(signal.SIGTERM, _handler)
    except (ValueError, OSError, AttributeError):
        return False  # not the main thread / unsupported platform
    _sigterm_installed = True
    return True
