"""Stall watchdog + graceful-degradation ladder (PyTorch port of
`lightgbm_tpu/reliability/guard.py`).

A rank wedged inside a collective or a device call is LIVE, so dead-PID
supervision never fires, and the run eats its full deadline with no
stack, no last-iteration marker and no record of which risky knobs were
active.  The reference engine's posture is the opposite: its network
layer surfaces per-rank failure context instead of stalling silently
(PAPER.md §Network).  `RunGuard` brings that posture to the port:

* the boosting loop ticks a heartbeat once per iteration (and touches a
  per-rank heartbeat FILE when the distributed supervisor asked for one,
  so the parent can see liveness from outside the process);
* a daemon watchdog thread trips when no tick lands within
  `max(stall_floor_s, stall_factor * rolling-median iteration time)` —
  with a separate, much larger deadline while the first iteration is
  still building and loading its kernels;
* on a trip it writes a structured stall diagnosis —
  `<metrics_dir>/stall-rank<r>.json` with a faulthandler all-thread
  stack dump, a device snapshot from `torch.cuda.memory_stats()`
  (allocated, reserved and peak bytes, active allocations), the last event
  the run logged, and the active risky-knob fingerprint — then exits
  with `STALL_EXIT_CODE` so the supervisor classifies *hang*, not
  *crash*.

The degradation ladder turns the diagnosis into a recovered run: with
`auto_degrade=true`, a relaunch after a hang resumes from the newest
checkpoint with the next risky knob disabled, in the fixed order
`DEGRADE_LADDER` (donation -> compile cache -> async host I/O -> device
eval), logging a `degrade` event each step.  The engine applies the
ladder itself at startup (it finds the previous attempt's stall file in
`metrics_dir`).  The ladder keeps the JAX package's order and values, so
`degrade-state.json` crosses between the packages; in the port its first
two rungs change nothing (the port donates no buffers and keeps no
compile cache; its kernels build once into `build/kernels`), so a
hang's first two relaunches retry unchanged in effect.  The heartbeat
file and the exit code feed the distributed supervisor
(`supervisor.py`); `distributed.train_distributed` walks the ladder
when an attempt hangs (the parent owns it there: its workers run with
auto_degrade off).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import atomic_write_text, log
from .faults import WORKER_LOST_EXIT_CODE

# Distinct from faults.CRASH_EXIT_CODE (17), POSIX signal codes (>128)
# and timeout(1)'s 124: a process that exits with this code diagnosed
# its own stall and wrote a stall-rank<r>.json before dying.
STALL_EXIT_CODE = 86

# Deterministic degradation order: (knob, disabled-value, predicate
# "is this knob currently enabled").  Donation first, then the compile
# cache, then async host I/O, then device eval (the JAX package's order).
DEGRADE_LADDER: List[Tuple[str, Any]] = [
    ("tpu_donate_buffers", False),
    ("compile_cache_dir", ""),
    ("async_host_io", False),
    ("device_eval", "false"),
]

_LADDER_KNOBS = [k for k, _ in DEGRADE_LADDER]

# rolling window for the per-iteration median (odd so the median is a
# real sample, long enough to ride out eval/checkpoint ticks)
_MEDIAN_WINDOW = 31

DEGRADE_STATE = "degrade-state.json"


def knob_enabled(knob: str, value: Any) -> bool:
    """Is a ladder knob active at this value?  (device_eval "auto" counts
    as enabled: the ladder's job is to force it off.)"""
    if knob == "tpu_donate_buffers" or knob == "async_host_io":
        return bool(value)
    if knob == "compile_cache_dir":
        return bool(str(value or "").strip())
    if knob == "device_eval":
        return str(value).strip().lower() != "false"
    return bool(value)


def stall_file_path(directory: str, rank: int) -> str:
    return os.path.join(os.fspath(directory), f"stall-rank{rank}.json")


def classify_returncode(returncode: Optional[int]) -> str:
    """Supervisor-side classification of a worker exit: 'hang' when the
    worker's own watchdog diagnosed a stall (STALL_EXIT_CODE) or an
    external timeout killed it (None / 124 / SIGKILL-shaped); 'preempt'
    when the worker died of SIGTERM — the preemption-notice shape, where
    the handler saved an on-demand checkpoint before re-delivering the
    signal; 'lost' when the rank declared itself permanently gone
    (tombstoned — relaunching at this world size is futile, shrink
    instead); 'crash' for every other non-zero exit, 'ok' for zero."""
    if returncode == 0:
        return "ok"
    if returncode == STALL_EXIT_CODE:
        return "hang"
    if returncode is None or returncode == 124:
        return "hang"  # killed for overrunning a deadline: live-but-hung
    if returncode in (143, -15):
        return "preempt"  # SIGTERM: a preemption notice, not a bug
    if returncode == WORKER_LOST_EXIT_CODE:
        return "lost"
    return "crash"


def _dump_all_stacks() -> List[str]:
    """faulthandler all-thread stack dump, captured as text lines.
    faulthandler writes to a real fd, so bounce through a temp file."""
    import faulthandler
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read().splitlines()
    except Exception as e:  # noqa: BLE001 - diagnosis must not throw
        return [f"(stack dump unavailable: {e})"]


def _device_snapshot(device=None) -> Dict[str, Any]:
    """Allocated, reserved and peak bytes and the count of active
    allocations on the training device, from the caching allocator's
    host-side counters (`torch.cuda.memory_stats`, no device call, so a
    wedged stream cannot block it); best-effort and fenced."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return {"device": str(device)}
    out: Dict[str, Any] = {}
    try:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return {"device": "cuda (not initialized)"}
        dev = torch.device(device) if device is not None \
            else torch.device("cuda", torch.cuda.current_device())
        stats = torch.cuda.memory_stats(dev)
        out["device"] = str(dev)
        for src, dst in (("allocated_bytes.all.current", "allocated_bytes"),
                         ("reserved_bytes.all.current", "reserved_bytes"),
                         ("allocated_bytes.all.peak", "peak_allocated_bytes"),
                         ("active.all.current", "active_allocations")):
            out[dst] = int(stats.get(src, 0))
    except Exception as e:  # noqa: BLE001
        out["device_memory_error"] = str(e)
    return out


class RunGuard:
    """Watchdog around one training run's boosting loop.

    `tick(iteration)` is called by the engine after each completed
    iteration; `start()`/`stop()` bracket the loop.  The watchdog thread
    polls the time since the last tick against the active deadline:

    * before the first tick: `first_deadline_s` (default
      `max(10 * stall_floor_s, 600)`) — the first iteration may build
      the kernels with nvcc and legitimately takes minutes;
    * after it: `max(stall_floor_s, stall_factor * median(recent iteration
      times))` — adapts to the workload instead of hardcoding a budget.

    On a trip the guard writes the stall diagnosis (atomic JSON), then
    calls `on_stall(diagnosis)` if given (tests), else flushes the host
    I/O writer with a bounded wait and `os._exit(STALL_EXIT_CODE)` —
    the main thread is by definition wedged, so a thread-side process
    exit is the only honest way out.
    """

    def __init__(self, diagnosis_dir: str, rank: int = 0, *,
                 stall_floor_s: float = 120.0, stall_factor: float = 20.0,
                 first_deadline_s: Optional[float] = None,
                 knobs: Optional[Dict[str, Any]] = None,
                 heartbeat_path: Optional[str] = None,
                 writer=None, device=None,
                 on_stall: Optional[Callable[[Dict[str, Any]], None]] = None,
                 poll_interval: Optional[float] = None):
        self.dir = os.fspath(diagnosis_dir)
        self.rank = int(rank)
        self.stall_floor_s = float(stall_floor_s)
        self.stall_factor = float(stall_factor)
        self.first_deadline_s = (float(first_deadline_s)
                                 if first_deadline_s is not None
                                 else max(10.0 * self.stall_floor_s, 600.0))
        self.knobs: Dict[str, Any] = dict(knobs or {})
        self.heartbeat_path = heartbeat_path
        self.writer = writer
        # the training device, whose allocator the diagnosis reads
        self.device = device
        self.on_stall = on_stall
        self.poll_interval = (float(poll_interval) if poll_interval
                              else min(1.0, max(self.stall_floor_s / 4.0,
                                                0.05)))
        self._durations: deque = deque(maxlen=_MEDIAN_WINDOW)
        self._last_tick: Optional[float] = None
        self._last_iteration: Optional[int] = None
        self._started_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tripped = False
        # guards the tick state shared with the watchdog thread
        # (_last_tick/_last_iteration/_durations/_tripped): uncontended
        # acquisition is ~100ns, noise next to one boosting iteration
        self._state_lock = threading.Lock()

    # ----------------------------------------------------------- engine API
    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        self._started_at = time.monotonic()
        self._touch_heartbeat()
        self._thread = threading.Thread(target=self._watch,
                                        name="lgbm-tpu-stall-watchdog",
                                        daemon=True)
        self._thread.start()

    def tick(self, iteration: int) -> None:
        """One boosting iteration completed.  Cheap: a lock, a monotonic
        read, a deque append and (in supervised runs) one utime on the
        heartbeat file."""
        now = time.monotonic()
        with self._state_lock:
            prev = self._last_tick if self._last_tick is not None \
                else self._started_at
            if prev is not None and self._last_tick is not None:
                self._durations.append(now - prev)
            self._last_tick = now
            self._last_iteration = int(iteration)
        self._touch_heartbeat()

    def update_knobs(self, **knobs) -> None:
        """Refresh the risky-knob fingerprint (the engine learns e.g.
        whether the sharded wave engaged only after the booster builds)."""
        self.knobs.update(knobs)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def tripped(self) -> bool:
        with self._state_lock:
            return self._tripped

    # ------------------------------------------------------------ deadlines
    def median_iter_s(self) -> Optional[float]:
        with self._state_lock:
            return self._median_locked()

    def _median_locked(self) -> Optional[float]:
        if not self._durations:
            return None
        s = sorted(self._durations)
        return s[len(s) // 2]

    def current_deadline_s(self) -> float:
        with self._state_lock:
            med = self._median_locked()
            if self._last_tick is None or med is None:
                return self.first_deadline_s
            return max(self.stall_floor_s, self.stall_factor * med)

    # ------------------------------------------------------------- watchdog
    def _touch_heartbeat(self) -> None:
        if not self.heartbeat_path:
            return
        try:
            with open(self.heartbeat_path, "a"):
                os.utime(self.heartbeat_path, None)
        except OSError:
            pass  # a lost heartbeat must never kill training

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            with self._state_lock:
                anchor = self._last_tick if self._last_tick is not None \
                    else self._started_at
            if anchor is None:
                continue
            silent_s = time.monotonic() - anchor
            deadline = self.current_deadline_s()
            if silent_s < deadline:
                continue
            with self._state_lock:
                self._tripped = True
            diagnosis = self.build_diagnosis(silent_s, deadline)
            self.write_diagnosis(diagnosis)
            if self.on_stall is not None:
                try:
                    self.on_stall(diagnosis)
                except Exception:  # noqa: BLE001
                    pass
                return
            self._flush_and_exit(diagnosis)
            return

    # ------------------------------------------------------------ diagnosis
    def build_diagnosis(self, silent_s: float,
                        deadline_s: float) -> Dict[str, Any]:
        from ..observability.events import get_event_logger
        from ..observability.flightrec import flight_recorder
        last_event = None
        lg = get_event_logger()
        if lg is not None:
            last_event = getattr(lg, "last_record", None)
        with self._state_lock:
            med = self._median_locked()
            first = self._last_tick is None
            last_it = self._last_iteration
        return {
            "kind": "stall",
            "rank": self.rank,
            "pid": os.getpid(),
            "ts": time.time(),
            "silent_s": round(silent_s, 3),
            "deadline_s": round(deadline_s, 3),
            "stall_floor_s": self.stall_floor_s,
            "stall_factor": self.stall_factor,
            "first_iteration": first,
            "last_iteration": last_it,
            "median_iter_s": round(med, 6) if med is not None else None,
            "knobs": dict(self.knobs),
            "last_event": last_event,
            # what the run was DOING just before it went silent: the
            # flight recorder's newest iteration records (lock-free
            # read — this thread is diagnosing a wedged process)
            "flight": flight_recorder.tail(32),
            "device": _device_snapshot(self.device),
            "stacks": _dump_all_stacks(),
            "exit_code": STALL_EXIT_CODE,
        }

    def write_diagnosis(self, diagnosis: Dict[str, Any]) -> Optional[str]:
        """Atomic, SYNCHRONOUS write — never through the AsyncWriter,
        whose thread may be part of what is hung.  The full flight
        record lands next to it (flight-rank<r>.json) through the same
        sync path, so the supervisor can surface both tails."""
        try:
            from ..observability.flightrec import dump_flight_record
            dump_flight_record(self.dir, rank=self.rank, reason="stall")
        except Exception:  # noqa: BLE001 - diagnosis must not throw
            pass
        path = stall_file_path(self.dir, self.rank)
        try:
            atomic_write_text(path, json.dumps(diagnosis, indent=1,
                                               default=str))
            return path
        except OSError as e:
            log.warning(f"Could not write the stall diagnosis to {path}: "
                        f"{e}")
            return None

    def _flush_and_exit(self, diagnosis: Dict[str, Any]) -> None:
        import sys
        msg = (f"[stall-watchdog] rank {self.rank}: no boosting iteration "
               f"completed in {diagnosis['silent_s']:.1f}s (deadline "
               f"{diagnosis['deadline_s']:.1f}s, last iteration "
               f"{diagnosis['last_iteration']}); wrote "
               f"{stall_file_path(self.dir, self.rank)}; exiting "
               f"{STALL_EXIT_CODE} (hang)\n")
        try:
            sys.stderr.write(msg)
            sys.stderr.flush()
        except Exception:  # noqa: BLE001
            pass
        # bounded flush FIRST (the writer thread may itself be wedged —
        # never wait on it without a deadline), then the terminal stall
        # record bypasses the writer entirely (emit_event_sync: private
        # handle, no queue — queueing through the AsyncWriter here could
        # block this exit path forever on a full bounded queue, the
        # signal-handler-safety hazard)
        if self.writer is not None:
            try:
                from ..observability import hostio
                self.writer.flush(timeout=hostio.TERMINAL_FLUSH_TIMEOUT_S)
            except Exception:  # noqa: BLE001
                pass
        try:
            from ..observability.events import emit_event_sync
            emit_event_sync("stall", rank=self.rank,
                            silent_s=diagnosis["silent_s"],
                            deadline_s=diagnosis["deadline_s"],
                            last_iteration=diagnosis["last_iteration"])
        except Exception:  # noqa: BLE001
            pass
        try:
            from ..observability.events import get_event_logger
            lg = get_event_logger()
            if lg is not None:
                lg.flush(timeout=1.0)
        except Exception:  # noqa: BLE001
            pass
        os._exit(STALL_EXIT_CODE)


# --------------------------------------------------------------------------
# degradation ladder
# --------------------------------------------------------------------------

def next_degradation(effective: Dict[str, Any],
                     already: List[str]) -> Optional[str]:
    """First ladder knob that is still enabled under `effective` values
    and not already degraded, or None when the ladder is exhausted."""
    for knob, _off in DEGRADE_LADDER:
        if knob in already:
            continue
        if knob_enabled(knob, effective.get(knob)):
            return knob
    return None


def disabled_value(knob: str) -> Any:
    for k, off in DEGRADE_LADDER:
        if k == knob:
            return off
    raise KeyError(knob)


def _load_state(metrics_dir: str) -> Dict[str, Any]:
    path = os.path.join(metrics_dir, DEGRADE_STATE)
    try:
        with open(path) as f:
            state = json.load(f)
        if isinstance(state.get("degraded_knobs"), list):
            return state
    except (OSError, ValueError):
        pass
    return {"degraded_knobs": [], "stalls_handled": 0}


def _save_state(metrics_dir: str, state: Dict[str, Any]) -> None:
    atomic_write_text(os.path.join(metrics_dir, DEGRADE_STATE),
                      json.dumps(state, indent=1))


def apply_auto_degrade(cfg, params: Dict[str, Any],
                       metrics_dir: Optional[str],
                       rank: int = 0) -> Dict[str, Any]:
    """Engine-side ladder step (single-process runs): called at train()
    startup when `auto_degrade=true`.

    Consumes a pending `stall-rank<rank>.json` left by the previous
    attempt's watchdog: picks the next enabled ladder knob, persists the
    accumulated set in `<metrics_dir>/degrade-state.json`, archives the
    stall file (so the NEXT stall degrades the NEXT knob), and applies
    every accumulated degradation to both `cfg` and `params` so the
    restarted run actually trains without them.  Returns
    `{"applied": [...all active degradations...], "new": [knob-or-none],
    "stall": <diagnosis dict or None>}`.
    """
    out = {"applied": [], "new": [], "stall": None}
    if not metrics_dir:
        return out
    state = _load_state(metrics_dir)
    spath = stall_file_path(metrics_dir, rank)
    if os.path.exists(spath):
        try:
            with open(spath) as f:
                out["stall"] = json.load(f)
        except (OSError, ValueError) as e:
            log.warning(f"Unreadable stall diagnosis {spath}: {e}")
        effective = {k: getattr(cfg, k) for k in _LADDER_KNOBS}
        # the previous run already trained with the accumulated set off;
        # its fingerprint (if readable) is authoritative for what was
        # live when it hung
        fp = (out["stall"] or {}).get("knobs") or {}
        for k in _LADDER_KNOBS:
            if k in fp:
                effective[k] = fp[k]
        knob = next_degradation(effective, state["degraded_knobs"])
        handled = int(state.get("stalls_handled", 0))
        # archive: the stall file is consumed exactly once per stall
        try:
            os.replace(spath, f"{spath}.handled-{handled}")
        except OSError:
            pass
        state["stalls_handled"] = handled + 1
        if knob is not None:
            state["degraded_knobs"].append(knob)
            out["new"].append(knob)
            log.warning(
                f"auto_degrade: previous attempt hung (stall diagnosis "
                f"consumed from {spath}); disabling {knob} and resuming "
                f"from the last checkpoint "
                f"(ladder: {' -> '.join(_LADDER_KNOBS)})")
        else:
            log.warning("auto_degrade: previous attempt hung but the "
                        "degradation ladder is exhausted (all risky knobs "
                        "already disabled); retrying unchanged")
        _save_state(metrics_dir, state)
    for knob in state["degraded_knobs"]:
        off = disabled_value(knob)
        setattr(cfg, knob, off)
        params[knob] = off
        out["applied"].append(knob)
    return out


def degraded_knobs(metrics_dir: Optional[str]) -> List[str]:
    """The accumulated degradations recorded for a run directory."""
    if not metrics_dir:
        return []
    return list(_load_state(metrics_dir)["degraded_knobs"])
