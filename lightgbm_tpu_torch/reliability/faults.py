"""Env-driven fault injection (PyTorch port of
`lightgbm_tpu/reliability/faults.py`: every kind, the same environment
variables).

`LGBM_TPU_FAULT` holds a comma-separated list of `kind@iteration` specs,
optionally `kind@iteration@attempt` (attempt defaults to 0, matched
against `LGBM_TPU_FAULT_ATTEMPT` so a supervised retry does not re-fire
the fault).  Kinds:

* `worker_crash@3`   — `os._exit(17)` at the start of boosting iteration 3
* `nan_grad@5`       — poison the iteration-5 gradients with NaN
* `ckpt_write_fail@2`— raise OSError from the iteration-2 checkpoint write
* `hang@3`           — wedge forever at the start of iteration 3 (a rank
  wedged in a collective: the process stays LIVE, so only the stall
  watchdog / heartbeat staleness can catch it)
* `slow_iter@4`      — sleep `LGBM_TPU_FAULT_SLOW_S` (default 2.0)
  seconds inside iteration 4: slow, but NOT a stall — the watchdog's
  rolling-median deadline must not trip on it
* `collective_stall@2` — wedge forever immediately BEFORE the tree
  growth of iteration 2; rank-gated, it models one rank entering a
  collective late so every peer blocks inside the histogram reduction
* `ckpt_corrupt@4`    — AFTER the iteration-4 checkpoint lands on disk
  (manifest included), truncate or bit-flip its newest artifact — the
  torn-write/bad-disk shape the manifest digests exist to catch.
  `LGBM_TPU_FAULT_CORRUPT=truncate|bitflip` picks the damage (default
  truncate; bitflip targets the state npz when one exists)
* `worker_lost@3`     — permanent rank loss: write a tombstone file
  keyed by (rank, world size) and `os._exit(WORKER_LOST_EXIT_CODE)`;
  on every relaunch at the SAME world size the worker main finds its
  tombstone and refuses to start, so only an elastic shrink (smaller
  world, different tombstone key) recovers the run

Serve-side fault points (their callers come with the serving slice):
the serving daemon ticks a per-process REQUEST counter at submit and
the `@N` in these specs matches it — "the N-th request this replica
accepts" — instead of a boosting iteration.  The fleet bench and
tests drill the router's retry/shed/restart paths with them:

* `serve_crash@N`     — `os._exit(CRASH_EXIT_CODE)` when request N is
  submitted: the replica dies with requests in flight, the fleet
  supervisor must relaunch it and the router must retry elsewhere
* `serve_shed@N`      — force the queue-full path for request N: the
  daemon raises the structured `shed` error exactly as if the bounded
  queue were full
* `serve_slow@N`      — arm a `LGBM_TPU_FAULT_SLOW_S` (default 2.0)
  sleep consumed by the coalescer IMMEDIATELY BEFORE its next
  dispatch: latency injection on the dispatcher thread, the shape a
  wedged device presents to the frontend (queue backs up -> shed)

Online-loop fault points (called by online/chunks.py and
online/trainer.py): the `@N` matches the CHUNK GENERATION id the online
trainer is processing:

* `online_chunk_corrupt@N` — damage chunk generation N before the
  trainer reads it: an on-disk chunk is truncated in place (the read
  that follows fails, the torn-upload shape); an in-memory chunk is
  poisoned via the True return.  The trainer must SKIP the generation
  (counted `online_generations_skipped`) and keep the previous
  generation serving
* `online_publish_fail@N`  — raise from the publish of generation N:
  the trainer must keep the old generation serving and retry with
  backoff — a half-published model must never serve

Rank gating applies to replicas too: the fleet sets
`LGBM_TPU_FAULT_SELF_RANK` to each replica's index, so
`LGBM_TPU_FAULT_RANK=1` drills exactly one replica of a fleet.

`LGBM_TPU_FAULT_RANK` (optional) restricts firing to one worker: it is
compared against `LGBM_TPU_FAULT_SELF_RANK`, which the distributed worker
main sets to its own rank (unset processes count as rank 0).

Each spec fires at most once per process, so an in-process rollback retry
(engine.train's NaN sentinel) re-runs the poisoned iteration cleanly.
When `LGBM_TPU_FAULT` is unset every hook is a no-op behind a single
`active()` check — zero steady-state cost.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Tuple

from ..utils import log

CRASH_EXIT_CODE = 17
# a rank that exits with this code has declared itself PERMANENTLY lost
# (tombstoned): relaunching it at the same world size is futile, so the
# supervisor's elastic policy shrinks the cluster around it instead
WORKER_LOST_EXIT_CODE = 77

# parsed (kind, iteration, attempt) specs; None = env not parsed yet
_specs: Optional[List[Tuple[str, int, int]]] = None

_KINDS = ("worker_crash", "nan_grad", "ckpt_write_fail",
          "hang", "slow_iter", "collective_stall",
          "ckpt_corrupt", "worker_lost",
          "serve_crash", "serve_shed", "serve_slow",
          "online_chunk_corrupt", "online_publish_fail")


def _parse() -> List[Tuple[str, int, int]]:
    raw = os.environ.get("LGBM_TPU_FAULT", "")
    specs: List[Tuple[str, int, int]] = []
    for item in raw.split(","):
        item = item.strip()
        if not item:
            continue
        parts = item.split("@")
        if len(parts) not in (2, 3) or parts[0] not in _KINDS:
            log.warning(f"Ignoring malformed LGBM_TPU_FAULT spec {item!r}; "
                        f"expected kind@iteration[@attempt] with kind in "
                        f"{_KINDS}")
            continue
        try:
            it = int(parts[1])
            attempt = int(parts[2]) if len(parts) == 3 else 0
        except ValueError:
            log.warning(f"Ignoring malformed LGBM_TPU_FAULT spec {item!r}: "
                        "iteration/attempt must be integers")
            continue
        specs.append((parts[0], it, attempt))
    return specs


def reload() -> None:
    """Re-read LGBM_TPU_FAULT (tests change the env mid-process)."""
    global _specs, _serve_requests, _serve_slow_pending
    _specs = None
    _serve_requests = 0
    _serve_slow_pending = 0.0


def active() -> bool:
    global _specs
    if _specs is None:
        _specs = _parse()
    return bool(_specs)


def _rank_matches() -> bool:
    want = os.environ.get("LGBM_TPU_FAULT_RANK")
    if want is None:
        return True
    have = os.environ.get("LGBM_TPU_FAULT_SELF_RANK", "0")
    return want.strip() == have.strip()


def _should_fire(kind: str, iteration: int) -> bool:
    if not active() or not _rank_matches():
        return False
    attempt = int(os.environ.get("LGBM_TPU_FAULT_ATTEMPT", "0"))
    for i, (k, it, at) in enumerate(_specs):
        if k == kind and it == iteration and at == attempt:
            del _specs[i]  # one-shot
            return True
    return False


def _record_injection(kind: str, iteration: int) -> None:
    """Count the fired fault and put it on the structured event log (the
    telemetry record every injected fault leaves behind, so a metrics run
    under LGBM_TPU_FAULT is self-describing)."""
    from ..observability import emit_event, global_registry
    global_registry.inc("faults_injected")
    emit_event("fault_injected", kind=kind, iteration=iteration)


def maybe_crash(iteration: int) -> None:
    """worker_crash hook (boosting update loop / worker main)."""
    if _should_fire("worker_crash", iteration):
        _record_injection("worker_crash", iteration)
        sys.stderr.write(f"[LGBM_TPU_FAULT] injected worker_crash at "
                         f"iteration {iteration}: exiting "
                         f"{CRASH_EXIT_CODE}\n")
        sys.stderr.flush()
        os._exit(CRASH_EXIT_CODE)


def maybe_nan_grad(grad, hess, iteration: int):
    """nan_grad hook: returns (grad, hess), poisoned when the spec fires."""
    if _should_fire("nan_grad", iteration):
        _record_injection("nan_grad", iteration)
        log.warning(f"[LGBM_TPU_FAULT] injecting NaN gradients at "
                    f"iteration {iteration}")
        return grad * float("nan"), hess
    return grad, hess


def _wedge(kind: str, iteration: int) -> None:
    """Simulate a live-but-hung process: sleep forever in short slices
    (so os._exit from the watchdog thread, SIGTERM/SIGKILL from the
    supervisor, and SIGUSR1 stack dumps all still work)."""
    sys.stderr.write(f"[LGBM_TPU_FAULT] injected {kind} at iteration "
                     f"{iteration}: process stays alive but makes no "
                     "progress\n")
    sys.stderr.flush()
    import time
    while True:
        time.sleep(1.0)


def maybe_hang(iteration: int) -> None:
    """hang / slow_iter hooks, at the start of a boosting iteration."""
    if _should_fire("hang", iteration):
        _record_injection("hang", iteration)
        _wedge("hang", iteration)
    if _should_fire("slow_iter", iteration):
        _record_injection("slow_iter", iteration)
        import time
        dur = float(os.environ.get("LGBM_TPU_FAULT_SLOW_S", "2.0"))
        log.warning(f"[LGBM_TPU_FAULT] injecting slow_iter at iteration "
                    f"{iteration}: sleeping {dur:.1f}s")
        time.sleep(dur)


def maybe_collective_stall(iteration: int) -> None:
    """collective_stall hook, immediately before a tree's growth: with
    rank gating, the other ranks enter the histogram reduction and
    block on this one."""
    if _should_fire("collective_stall", iteration):
        _record_injection("collective_stall", iteration)
        _wedge("collective_stall", iteration)


# serve-side fault state: the daemon ticks `_serve_requests` once per
# accepted request (under its own submit path, GIL-serialized int adds;
# the off-by-one a torn increment could cause is acceptable for an
# injection drill), and serve_slow arms a sleep the coalescer consumes
# just before its next dispatch
_serve_requests = 0
_serve_slow_pending = 0.0


def serve_request_tick() -> int:
    """Count one accepted serving request; returns the 1-based request
    index this process has seen (the `@N` the serve_* specs match)."""
    global _serve_requests
    _serve_requests += 1
    return _serve_requests


def maybe_serve_crash(request_n: int) -> None:
    """serve_crash hook (daemon submit path): replica dies mid-load."""
    if _should_fire("serve_crash", request_n):
        _record_injection("serve_crash", request_n)
        sys.stderr.write(f"[LGBM_TPU_FAULT] injected serve_crash at "
                         f"request {request_n}: exiting "
                         f"{CRASH_EXIT_CODE}\n")
        sys.stderr.flush()
        os._exit(CRASH_EXIT_CODE)


def maybe_serve_shed(request_n: int) -> bool:
    """serve_shed hook: True = treat this submit as queue-full and fail
    fast with the structured shed error (coalescer.ShedError)."""
    if _should_fire("serve_shed", request_n):
        _record_injection("serve_shed", request_n)
        log.warning(f"[LGBM_TPU_FAULT] injecting serve_shed at request "
                    f"{request_n}: forcing the queue-full path")
        return True
    return False


def maybe_serve_slow(request_n: int) -> None:
    """serve_slow hook (submit path): arm the dispatcher-side sleep."""
    global _serve_slow_pending
    if _should_fire("serve_slow", request_n):
        _record_injection("serve_slow", request_n)
        dur = float(os.environ.get("LGBM_TPU_FAULT_SLOW_S", "2.0"))
        log.warning(f"[LGBM_TPU_FAULT] arming serve_slow at request "
                    f"{request_n}: next dispatch sleeps {dur:.1f}s")
        _serve_slow_pending = dur


def consume_serve_slow() -> None:
    """Dispatcher-side half of serve_slow: sleep the armed duration
    once, immediately before the next coalesced dispatch."""
    global _serve_slow_pending
    dur, _serve_slow_pending = _serve_slow_pending, 0.0
    if dur > 0:
        import time
        time.sleep(dur)


def maybe_online_chunk_corrupt(generation: int,
                               path: Optional[str] = None) -> bool:
    """online_chunk_corrupt hook (online chunk sources, per generation):
    models a torn upload / bad-sector chunk.  An on-disk chunk is
    truncated in place so the read that follows fails exactly like real
    damage; an in-memory chunk has no bytes to damage, so the True
    return poisons it.  The trainer's contract either way: skip the
    generation, keep the previous one serving."""
    if not _should_fire("online_chunk_corrupt", generation):
        return False
    _record_injection("online_chunk_corrupt", generation)
    if path:
        try:
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        except OSError as e:
            log.warning(f"[LGBM_TPU_FAULT] online_chunk_corrupt could not "
                        f"damage {path}: {e}")
    log.warning(f"[LGBM_TPU_FAULT] injected online_chunk_corrupt at "
                f"generation {generation}")
    return True


def maybe_online_publish_fail(generation: int) -> None:
    """online_publish_fail hook (online trainer, before the publish of
    one generation): the publish raises, the trainer must keep the old
    generation serving and retry — never serve a half-published
    model."""
    if _should_fire("online_publish_fail", generation):
        _record_injection("online_publish_fail", generation)
        raise RuntimeError(f"[LGBM_TPU_FAULT] injected online_publish_fail "
                           f"at generation {generation}")


def register_stack_dump_signal() -> bool:
    """Register faulthandler on SIGUSR1 so an operator (or the
    supervisor) can get an all-thread stack dump from a LIVE worker
    without killing it: `kill -USR1 <pid>`.  Returns False where
    unsupported (non-main thread, platforms without SIGUSR1)."""
    try:
        import faulthandler
        import signal
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=True)
        return True
    except (AttributeError, ImportError, ValueError, RuntimeError):
        return False


def register_flight_dump_signal(directory: str,
                                rank: Optional[int] = None) -> bool:
    """SIGUSR1's sibling: `kill -USR2 <pid>` dumps the flight recorder
    plus a registry snapshot to `<directory>/flight-rank<r>.json`
    WITHOUT killing the process — recent iteration history, sampled
    serving traces and counters from a live (possibly misbehaving)
    worker, where SIGUSR1 only gives stacks.  The dump rides the
    signal-safe synchronous write path (flightrec.dump_flight_record:
    lock-free reads, atomic write, no AsyncWriter; the rank is resolved
    HERE, at registration, because resolving it queries the process
    group, which a handler on a wedged process must never touch).  Returns False where
    unsupported."""
    directory = os.fspath(directory)
    if rank is None:
        from ..observability.registry import process_rank
        rank = process_rank()

    def _handler(signum, frame):
        from ..observability.flightrec import dump_flight_record
        dump_flight_record(directory, rank=rank, reason="sigusr2")

    try:
        import signal
        signal.signal(signal.SIGUSR2, _handler)
        return True
    except (AttributeError, ImportError, ValueError, OSError,
            RuntimeError):
        return False  # non-main thread / no SIGUSR2 on this platform


def maybe_ckpt_write_fail(iteration: int) -> None:
    """ckpt_write_fail hook, called before the checkpoint touches disk."""
    if _should_fire("ckpt_write_fail", iteration):
        _record_injection("ckpt_write_fail", iteration)
        raise OSError(f"[LGBM_TPU_FAULT] injected ckpt_write_fail at "
                      f"iteration {iteration}")


def maybe_ckpt_corrupt(iteration: int, model_path: str,
                       state_path: Optional[str]) -> None:
    """ckpt_corrupt hook, called AFTER a checkpoint (manifest included)
    has fully landed: damages the artifact bytes on disk while the
    manifest's digests still describe the healthy write — exactly what
    a torn write or bad sector leaves behind.  The integrity check on
    the next resume must quarantine this generation and fall back."""
    if not _should_fire("ckpt_corrupt", iteration):
        return
    _record_injection("ckpt_corrupt", iteration)
    mode = os.environ.get("LGBM_TPU_FAULT_CORRUPT", "truncate").strip()
    target = (state_path if mode == "bitflip" and state_path
              and os.path.exists(state_path) else model_path)
    try:
        size = os.path.getsize(target)
        if mode == "bitflip":
            with open(target, "r+b") as f:
                f.seek(size // 2)
                byte = f.read(1) or b"\0"
                f.seek(size // 2)
                f.write(bytes([byte[0] ^ 0xFF]))
        else:
            with open(target, "r+b") as f:
                f.truncate(max(size // 2, 1))
        log.warning(f"[LGBM_TPU_FAULT] injected ckpt_corrupt ({mode}) at "
                    f"iteration {iteration}: damaged {target}")
    except OSError as e:
        log.warning(f"[LGBM_TPU_FAULT] ckpt_corrupt could not damage "
                    f"{target}: {e}")


def tombstone_path(directory: str, rank: int, world: int) -> str:
    """Tombstone key: (rank, world size).  A shrink relaunch renumbers
    the surviving ranks into a smaller world, so its workers never
    collide with the dead rank's tombstone — which keeps refusing
    same-world relaunches forever, like the dead host it models."""
    return os.path.join(os.fspath(directory),
                        f"tombstone-rank{rank}-of-{world}")


def write_tombstone(directory: str, rank: int, world: int,
                    reason: str) -> None:
    """Atomically drop a rank's tombstone.  The file's EXISTENCE is the
    permanent-loss signal every later relaunch gates on, so it must
    never be observable half-written: a torn tombstone read as present
    is correct, but a crash that leaves a zero-byte temp where the
    marker should be would let a dead rank rejoin."""
    from ..utils import atomic_write_text
    try:
        os.makedirs(directory, exist_ok=True)
        atomic_write_text(tombstone_path(directory, rank, world),
                          reason + "\n")
    except OSError:
        pass


def _tombstone_ctx() -> Optional[Tuple[str, int, int]]:
    d = os.environ.get("LGBM_TPU_TOMBSTONE_DIR")
    if not d:
        return None
    rank = int(os.environ.get("LGBM_TPU_FAULT_SELF_RANK", "0"))
    world = int(os.environ.get("LGBM_TPU_WORLD_SIZE", "1"))
    return d, rank, world


def check_tombstone() -> None:
    """Worker-startup gate: a rank that died with worker_lost refuses
    every relaunch at the same world size (`os._exit`, before any device
    initialization, so the refusal is fast and never wedges peers in
    collectives)."""
    ctx = _tombstone_ctx()
    if ctx is None:
        return
    d, rank, world = ctx
    path = tombstone_path(d, rank, world)
    if os.path.exists(path):
        sys.stderr.write(f"[LGBM_TPU_FAULT] rank {rank}/{world} is "
                         f"tombstoned ({path}): refusing relaunch, "
                         f"exiting {WORKER_LOST_EXIT_CODE}\n")
        sys.stderr.flush()
        os._exit(WORKER_LOST_EXIT_CODE)


def maybe_worker_lost(iteration: int) -> None:
    """worker_lost hook (boosting update loop): tombstone this rank and
    exit WORKER_LOST_EXIT_CODE — a permanent host loss, as opposed to
    worker_crash's transient one."""
    if not _should_fire("worker_lost", iteration):
        return
    _record_injection("worker_lost", iteration)
    ctx = _tombstone_ctx()
    if ctx is not None:
        d, rank, world = ctx
        write_tombstone(d, rank, world,
                        f"worker_lost injected at iteration {iteration}")
    sys.stderr.write(f"[LGBM_TPU_FAULT] injected worker_lost at iteration "
                     f"{iteration}: exiting {WORKER_LOST_EXIT_CODE} "
                     "(permanent)\n")
    sys.stderr.flush()
    os._exit(WORKER_LOST_EXIT_CODE)
