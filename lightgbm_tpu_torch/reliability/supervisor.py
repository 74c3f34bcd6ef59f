"""Worker-process supervision for the multi-process launcher (PyTorch
port of `lightgbm_tpu/reliability/supervisor.py`).

The reference engine's socket linkers notice a dead peer quickly; the
port's workers instead block inside a torch.distributed collective when
a peer dies (until the process group's timeout), so the SPAWNING
process must watch the children: poll every worker, and on the first
non-zero exit kill the rest of the cluster immediately instead of
letting the survivors stall to the global timeout.

Dead PIDs are the easy half.  A rank can also stay LIVE while wedged
inside a collective, and then no exit code ever arrives.  Two
complementary detectors close that hole:

* each worker's `RunGuard` (reliability/guard.py) ticks a per-rank
  heartbeat FILE once per boosting iteration; the supervisor polls the
  files' mtimes and, when every process is still alive but a heartbeat
  has gone stale past `stall_timeout`, kills the cluster and classifies
  the stale rank as HUNG — surfacing its `stall-rank<r>.json` tail (the
  guard usually wrote one just before, or will not get the chance —
  either way the mtime is the ground truth);
* a worker whose own watchdog fired exits with `STALL_EXIT_CODE`, which
  `classify_returncode` maps to "hang" rather than "crash", so the retry
  layer can choose the degradation ladder instead of a plain relaunch
  (`distributed.train_distributed`'s retries).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .guard import classify_returncode, stall_file_path


@dataclass
class WorkerFailure:
    rank: int
    returncode: Optional[int]  # None = killed after timeout/stall
    log_tail: str
    kind: str = "crash"  # "crash" | "hang" | "timeout"
    stall_tail: str = ""  # tail of stall-rank<r>.json when one exists
    flight_tail: str = ""  # tail of flight-rank<r>.json when one exists


@dataclass
class SuperviseResult:
    ok: bool
    timed_out: bool
    failures: List[WorkerFailure] = field(default_factory=list)

    @property
    def hang(self) -> bool:
        """True when the attempt died of a stall (live-but-hung rank or
        a worker's own watchdog), not a crash — the degradation ladder
        only makes sense for hangs."""
        return any(f.kind == "hang" for f in self.failures)

    @property
    def classification(self) -> str:
        """Dominant failure kind of the attempt, for event logs and the
        retry policy: permanence ('lost') outranks hangs, hangs outrank
        crashes, and 'preempt' only when nothing worse happened (a
        preempted rank plus a crashed rank is still a crash)."""
        kinds = {f.kind for f in self.failures}
        for k in ("lost", "hang", "crash", "preempt", "timeout"):
            if k in kinds:
                return k
        return "timeout" if self.timed_out else "ok"

    def describe(self) -> str:
        if self.ok:
            return "all workers exited 0"
        parts = []
        if self.timed_out:
            parts.append("cluster hit the launch deadline")
        for f in self.failures:
            if f.returncode is None:
                rc = ("killed (heartbeat stale: live-but-hung)"
                      if f.kind == "hang" else "killed (timeout)")
            else:
                rc = f"exit code {f.returncode} ({f.kind})"
            parts.append(f"rank {f.rank} failed ({rc}); log tail:\n"
                         f"{f.log_tail or '(empty log)'}")
            if f.stall_tail:
                parts.append(f"rank {f.rank} stall diagnosis "
                             f"(stall-rank{f.rank}.json):\n{f.stall_tail}")
            if f.flight_tail:
                parts.append(f"rank {f.rank} flight record "
                             f"(flight-rank{f.rank}.json):\n"
                             f"{f.flight_tail}")
        return "\n".join(parts)


def tail_file(path: str, max_bytes: int = 4096) -> str:
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            data = f.read().decode("utf-8", "replace")
        if size > max_bytes:
            data = "...(truncated)...\n" + data
        return data.strip()
    except OSError:
        return "(log unavailable)"


def _stall_tail(stall_dir: Optional[str], rank: int) -> str:
    """Tail of rank's stall diagnosis, '' when none was written."""
    if not stall_dir:
        return ""
    path = stall_file_path(stall_dir, rank)
    if not os.path.exists(path):
        return ""
    return tail_file(path, max_bytes=2048)


def _flight_tail(stall_dir: Optional[str], rank: int) -> str:
    """Tail of rank's flight record — the guard dumps one on a stall
    and the engine dumps one on a crash, so a classified failure
    carries what the rank was DOING, not just where it died."""
    if not stall_dir:
        return ""
    from ..observability.flightrec import flight_file_path
    path = flight_file_path(stall_dir, rank)
    if not os.path.exists(path):
        return ""
    return tail_file(path, max_bytes=2048)


def _stale_ranks(heartbeats: Optional[List[str]], stall_timeout: float,
                 started: float, pending) -> List[int]:
    """Ranks whose heartbeat file has not been touched for
    `stall_timeout` seconds.  A missing file counts from launch time:
    a worker that never completed one iteration is exactly the
    wedged-in-first-collective shape."""
    if not heartbeats or stall_timeout <= 0:
        return []
    now = time.time()
    stale = []
    for r in sorted(pending):
        try:
            age = now - os.path.getmtime(heartbeats[r])
        except OSError:
            age = now - started
        if age >= stall_timeout:
            stale.append(r)
    return stale


def supervise(procs, log_paths: List[str], timeout: float,
              poll_interval: float = 0.25,
              heartbeats: Optional[List[str]] = None,
              stall_timeout: float = 0.0,
              stall_dir: Optional[str] = None) -> SuperviseResult:
    """Watch `procs` until they all exit, one fails, a heartbeat goes
    stale, or `timeout` passes.

    On the first non-zero exit the remaining workers are killed at once
    (they are wedged in collectives waiting for the dead rank).  With
    `heartbeats` (one path per rank) and `stall_timeout > 0`, a rank
    that is ALIVE but has not ticked for `stall_timeout` seconds is
    classified as hung and the cluster is killed the same way — the old
    behavior was to wait out the full `timeout` on such ranks.  Always
    reaps every process before returning."""
    started = time.time()
    deadline = time.monotonic() + timeout
    pending = set(range(len(procs)))
    failed: List[int] = []
    stalled: List[int] = []
    timed_out = False
    while pending:
        for r in sorted(pending):
            rc = procs[r].poll()
            if rc is None:
                continue
            pending.discard(r)
            if rc != 0:
                failed.append(r)
        if failed or not pending:
            break
        stalled = _stale_ranks(heartbeats, stall_timeout, started, pending)
        if stalled:
            break
        if time.monotonic() >= deadline:
            timed_out = True
            break
        time.sleep(poll_interval)

    for r in pending:  # kill survivors: wedged (peer died/hung) or overdue
        procs[r].kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except Exception:
            p.kill()
            p.wait()

    failures = [
        WorkerFailure(r, procs[r].returncode, tail_file(log_paths[r]),
                      kind=classify_returncode(procs[r].returncode),
                      stall_tail=_stall_tail(stall_dir, r),
                      flight_tail=_flight_tail(stall_dir, r))
        for r in failed]
    for r in stalled:
        # killed by US for heartbeat staleness: the returncode is the
        # kill signal, which classify_returncode would miscall "crash"
        failures.append(WorkerFailure(
            r, None, tail_file(log_paths[r]), kind="hang",
            stall_tail=_stall_tail(stall_dir, r),
            flight_tail=_flight_tail(stall_dir, r)))
    if timed_out:
        failures.extend(
            WorkerFailure(r, None, tail_file(log_paths[r]), kind="timeout",
                          stall_tail=_stall_tail(stall_dir, r),
                          flight_tail=_flight_tail(stall_dir, r))
            for r in sorted(pending))
    ok = not failures and not timed_out
    return SuperviseResult(ok=ok, timed_out=timed_out, failures=failures)
