"""Replica fleet: K serving daemons under poll-based supervision
(PyTorch port of `lightgbm_tpu/serving/fleet.py`).

One daemon process is a fault domain of one: a crash loses every
in-flight request and a wedged device stalls every caller.  The fleet
layer runs K replica daemons (each its own process, its own device
context, its own bounded queue) behind the router (router.py), and
supervises them as the JAX package's launcher supervises training
ranks: poll the PIDs, classify the exit (`classify_returncode`:
crash / preempt / hang / lost), surface the log tail, and relaunch with
exponential backoff, capped by `serve_max_replica_restarts` per
replica.  A dead replica is detected in seconds (poll interval), not
when a client times out.

Replica lifecycle:

    spawn -> (daemon warms its models) -> ready file lands
          -> health probes (`op=health`) pass -> ROUTABLE
          -> exit observed -> `serve_replica_down` event
          -> backoff (0.5 s * 2^restarts, capped) -> respawn, new port
          -> restart budget exhausted -> permanently down

Readiness is the daemon's own warmup ledger (`op=health` `ready`): a
replica is never routed to until every registered model finished load
AND bucket-ladder warmup, so replica churn cannot leak compiles into
live traffic.  The probe also carries `shedding` (the replica's bounded
queue shed within the last second) — the router skips shedding replicas
and the fleet-wide admission controller answers `overloaded` once all
of them shed.

The fleet also ADOPTS replicas it did not spawn (`adopt_endpoints`):
externally managed daemons (k8s pods, another host) get health-checked
and routed to, just not relaunched.

Fault drills: `fault_envs={idx: {"LGBM_TPU_FAULT": "serve_crash@40"}}`
injects the serve-side fault points (reliability/faults.py) into chosen
replicas; every replica gets `LGBM_TPU_FAULT_SELF_RANK=<idx>` so
rank-gated specs drill exactly one replica of a fleet.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..observability import emit_event
from ..observability.prom import parse_prometheus_text
from ..observability.registry import global_registry
from ..reliability.guard import classify_returncode
from ..utils import log

# the CLI bootstrap for spawned replicas: a fresh interpreter (never a
# fork of a process that holds a CUDA context) running the port's
# command line.  LGBM_TPU_SERVE_FORCE_CPU=1 serves on the CPU
# (device_type=cpu put first: the first value of a key wins over the
# inherited parameters); otherwise the child serves on the card
_BOOTSTRAP = (
    "import os, sys\n"
    "argv = sys.argv[1:]\n"
    "if os.environ.get('LGBM_TPU_SERVE_FORCE_CPU') == '1':\n"
    "    argv = ['device_type=cpu'] + argv\n"
    "from lightgbm_tpu_torch.cli import main\n"
    "sys.exit(main(argv))\n")


def tail_file(path: str, max_bytes: int = 4096) -> str:
    """The last `max_bytes` of a replica's log, for its down event."""
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


class ReplicaState:
    """One replica's supervised state.  All mutable fields are guarded
    by the owning fleet's lock; router threads read through
    `ReplicaFleet.endpoints()` snapshots only."""

    def __init__(self, idx: int, adopted: bool = False,
                 host: str = "127.0.0.1", port: Optional[int] = None):
        self.idx = idx
        self.adopted = adopted
        self.host = host
        self.port = port
        self.proc: Optional[subprocess.Popen] = None
        self.ready = False          # daemon's warmup ledger complete
        self.healthy = False        # last health probe answered
        self.shedding = False       # shed within the probe's window
        self.restarts = 0           # relaunches consumed (budgeted)
        self.gen = 0                # bumped per (re)spawn
        self.down = False           # permanently out of budget
        self.spawned_at = 0.0
        self.relaunch_at: Optional[float] = None  # backoff deadline
        self.last_probe = 0.0
        self.versions: Dict[str, int] = {}

    def describe(self) -> Dict[str, object]:
        return {"idx": self.idx, "port": self.port, "gen": self.gen,
                "ready": self.ready, "healthy": self.healthy,
                "shedding": self.shedding, "restarts": self.restarts,
                "down": self.down, "adopted": self.adopted,
                "pid": self.proc.pid if self.proc else None,
                "versions": dict(self.versions)}


class ReplicaEndpoint:
    """Immutable routing view of one replica (snapshot semantics: the
    router holds these across a request; staleness is resolved by the
    retry path, not by locking)."""

    __slots__ = ("idx", "host", "port", "gen", "shedding", "versions")

    def __init__(self, idx: int, host: str, port: int, gen: int,
                 shedding: bool, versions: Dict[str, int]):
        self.idx = idx
        self.host = host
        self.port = port
        self.gen = gen
        self.shedding = shedding
        self.versions = versions


class FleetAggregator:
    """Merged fleet view of every replica's `/metrics` scrape
    (docs/Observability.md "Fleet metrics & SLO").

    The supervisor's health probe pulls each routable replica's
    Prometheus page (`op=metrics` on the same wire round trip as
    `op=health`) and records the parsed snapshot here; `render()`
    produces ONE text block for the router's own `/metrics` page:

    * `lgbm_fleet_<name>` counters — the per-series SUM over every
      replica with a live scrape (so one router scrape answers "how
      many requests did the FLEET serve" without K per-replica pulls);
    * `lgbm_fleet_replica_{up,routable,restarts}{replica="i"}` gauges
      from the supervisor's own state (a down replica has no scrape to
      speak for it);
    * merged latency quantiles: `lgbm_fleet_latency_ms{quantile=}` —
      p50 as the serve-request-weighted mean of the replica p50s, p99
      as the MAX over replicas (quantiles do not sum; the weighted
      mean is the honest central estimate and the max is the
      conservative tail bound — documented approximation).

    A replica's snapshot is dropped when it goes down or restarts
    (`forget`): a relaunched daemon restarts its counters from zero,
    and a stale pre-crash snapshot would double-count its history."""

    def __init__(self):
        self._lock = threading.Lock()
        # replica idx -> {"ts", "counters", "gauges"}
        self._scrapes: Dict[int, Dict[str, object]] = {}

    # ------------------------------------------------------------- writers
    def record_scrape(self, idx: int, page: str) -> None:
        parsed = parse_prometheus_text(page)
        with self._lock:
            self._scrapes[int(idx)] = {"ts": time.time(),
                                       "counters": parsed["counters"],
                                       "gauges": parsed["gauges"]}

    def forget(self, idx: int) -> None:
        """Drop a replica's snapshot (down or relaunched: its counter
        history must not double-count into the merged view)."""
        with self._lock:
            self._scrapes.pop(int(idx), None)

    # ------------------------------------------------------------- readers
    def snapshot(self) -> Dict[int, Dict[str, object]]:
        """Per-replica parsed scrapes (copies)."""
        with self._lock:
            return {i: {"ts": s["ts"],
                        "counters": dict(s["counters"]),
                        "gauges": dict(s["gauges"])}
                    for i, s in self._scrapes.items()}

    def merged_counters(self) -> Dict[str, float]:
        """Per-series sums over every live replica scrape."""
        out: Dict[str, float] = {}
        with self._lock:
            scrapes = list(self._scrapes.values())
        for s in scrapes:
            for name, val in s["counters"].items():
                out[name] = out.get(name, 0.0) + val
        return out

    def replica_counter(self, idx: int, series: str) -> float:
        with self._lock:
            s = self._scrapes.get(int(idx))
            return float(s["counters"].get(series, 0.0)) if s else 0.0

    def merged_latency_ms(self) -> Dict[str, Optional[float]]:
        """{"p50": weighted mean, "p99": max} over replica quantile
        gauges (see class docstring for the approximation)."""
        with self._lock:
            scrapes = list(self._scrapes.values())
        p50s, p99s = [], []
        for s in scrapes:
            g = s["gauges"]
            p50 = g.get('lgbm_serve_latency_ms{quantile="0.5"}')
            p99 = g.get('lgbm_serve_latency_ms{quantile="0.99"}')
            weight = s["counters"].get("lgbm_serve_requests", 0.0)
            if p50 is not None and p50 == p50:       # NaN-safe
                p50s.append((p50, max(weight, 1.0)))
            if p99 is not None and p99 == p99:
                p99s.append(p99)
        p50 = (sum(v * w for v, w in p50s) / sum(w for _, w in p50s)
               if p50s else None)
        return {"p50": p50, "p99": max(p99s) if p99s else None}

    # -------------------------------------------------------------- render
    def render(self, describe: List[Dict[str, object]]) -> str:
        """The router /metrics `text_cb` block (Prometheus text)."""
        lines: List[str] = []
        merged = self.merged_counters()
        families: Dict[str, List[str]] = {}
        for name in sorted(merged):
            rest = name[len("lgbm_"):] if name.startswith("lgbm_") else name
            base = "lgbm_fleet_" + rest.split("{", 1)[0]
            series = ("lgbm_fleet_" + rest).split("{", 1)
            rendered = series[0] + ("{" + series[1] if len(series) > 1
                                    else "")
            val = merged[name]
            sval = str(int(val)) if val == int(val) else repr(val)
            families.setdefault(base, []).append(f"{rendered} {sval}")
        for base in sorted(families):
            lines.append(f"# TYPE {base} counter")
            lines.extend(families[base])
        for field, kind in (("up", "healthy"), ("routable", "ready"),
                            ("restarts", "restarts")):
            lines.append(f"# TYPE lgbm_fleet_replica_{field} gauge")
            for r in describe:
                if field == "restarts":
                    val = int(r.get("restarts", 0))
                else:
                    val = int(bool(r.get(kind)) and not r.get("down"))
                lines.append(
                    f'lgbm_fleet_replica_{field}{{replica="{r["idx"]}"}} '
                    f"{val}")
        lat = self.merged_latency_ms()
        lines.append("# TYPE lgbm_fleet_latency_ms gauge")
        for q, key in (("0.5", "p50"), ("0.99", "p99")):
            v = lat[key]
            lines.append(f'lgbm_fleet_latency_ms{{quantile="{q}"}} '
                         + ("NaN" if v is None else f"{float(v):g}"))
        return "\n".join(lines)


class ReplicaFleet:
    """Spawn/adopt + supervise K serving replicas (docs/Serving.md).

    `model_entries` are the `(name, path)` pairs every replica serves;
    `params` flow to each replica daemon's CLI as `key=value` (the
    `serve_*` family, `device_predict*`, verbosity...).  `spawn_cmd`
    overrides the command factory — tests supervise stub processes
    through the very same machinery that runs real daemons."""

    POLL_INTERVAL_S = 0.2
    BACKOFF_BASE_S = 0.5
    BACKOFF_CAP_S = 10.0
    READY_TIMEOUT_S = 180.0

    def __init__(self, num_replicas: int, model_entries: Sequence[Tuple[str, str]],
                 workdir: str, params: Optional[Dict[str, object]] = None,
                 max_restarts: int = 3, health_interval_s: float = 0.5,
                 force_cpu: bool = False,
                 fault_envs: Optional[Dict[int, Dict[str, str]]] = None,
                 spawn_cmd: Optional[Callable[[int, str], List[str]]] = None,
                 adopt_endpoints: Sequence[Tuple[str, int]] = ()):
        self.workdir = os.fspath(workdir)
        self.model_entries = [(str(n), str(p)) for n, p in model_entries]
        self.params = dict(params or {})
        self.max_restarts = int(max_restarts)
        self.health_interval_s = max(float(health_interval_s), 0.05)
        self.force_cpu = bool(force_cpu)
        self.fault_envs = {int(k): dict(v)
                           for k, v in (fault_envs or {}).items()}
        self.spawn_cmd = spawn_cmd
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # merged fleet /metrics view, refreshed on the health-probe tick
        # (docs/Observability.md "Fleet metrics & SLO"); always on — one
        # op=metrics round trip per probe is noise next to the probe
        self.aggregator = FleetAggregator()
        self.replicas: List[ReplicaState] = [
            ReplicaState(i) for i in range(int(num_replicas))]
        for host, port in adopt_endpoints:
            r = ReplicaState(len(self.replicas), adopted=True,
                             host=host, port=int(port))
            self.replicas.append(r)
        if not self.replicas:
            raise ValueError("ReplicaFleet needs num_replicas >= 1 or "
                             "adopt_endpoints")

    # ------------------------------------------------------------ spawning
    def _ready_file(self, idx: int) -> str:
        return os.path.join(self.workdir, f"replica-{idx}.ready.json")

    def _log_file(self, idx: int) -> str:
        return os.path.join(self.workdir, f"replica-{idx}.log")

    def _default_cmd(self, idx: int, ready_file: str) -> List[str]:
        with self._lock:  # RLock: _spawn's callers already hold it
            entries = ",".join(f"{n}={p}" for n, p in self.model_entries)
        argv = [sys.executable, "-c", _BOOTSTRAP, "task=serve",
                f"serve_models={entries}", "serve_port=0",
                f"serve_ready_file={ready_file}"]
        for k, v in sorted(self.params.items()):
            if isinstance(v, bool):
                v = "true" if v else "false"
            argv.append(f"{k}={v}")
        return argv

    def _spawn(self, r: ReplicaState) -> None:
        """Launch (or relaunch) replica r; caller holds the lock."""
        ready_file = self._ready_file(r.idx)
        try:
            os.makedirs(self.workdir, exist_ok=True)
            if os.path.exists(ready_file):
                os.unlink(ready_file)  # a stale port must never route
        except OSError:
            pass
        env = dict(os.environ)
        # the package must be importable from the bootstrap -c child:
        # prepend the REPO root (the directory CONTAINING
        # lightgbm_tpu_torch; the package dir itself would shadow the
        # stdlib's `io`)
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        env["LGBM_TPU_FAULT_SELF_RANK"] = str(r.idx)
        # relaunch = next attempt: one-shot fault specs (serve_crash@N)
        # must not re-fire on every generation, exactly like the
        # training supervisor's attempt gating (reliability/faults.py)
        env["LGBM_TPU_FAULT_ATTEMPT"] = str(r.gen)
        if self.force_cpu:
            env["LGBM_TPU_SERVE_FORCE_CPU"] = "1"
        env.update(self.fault_envs.get(r.idx, {}))
        cmd = (self.spawn_cmd(r.idx, ready_file) if self.spawn_cmd
               else self._default_cmd(r.idx, ready_file))
        logf = open(self._log_file(r.idx), "ab")
        try:
            r.proc = subprocess.Popen(cmd, stdout=logf, stderr=logf,
                                      env=env, cwd=self.workdir)
        finally:
            logf.close()  # the child inherited the fd
        r.gen += 1
        r.ready = False
        r.healthy = False
        r.shedding = False
        r.port = None
        r.spawned_at = time.monotonic()
        r.relaunch_at = None
        log.info(f"Fleet replica {r.idx} spawned (gen {r.gen}, "
                 f"pid {r.proc.pid})")

    # ------------------------------------------------------------- control
    def start(self) -> "ReplicaFleet":
        with self._lock:
            for r in self.replicas:
                if not r.adopted:
                    self._spawn(r)
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._supervise, name="lgbm-fleet-supervisor",
                    daemon=True)
                self._thread.start()
        emit_event("serve_fleet_start",
                   replicas=len(self.replicas),
                   models=[n for n, _ in self.model_entries])
        return self

    def wait_ready(self, timeout: Optional[float] = None,
                   min_replicas: Optional[int] = None) -> bool:
        """Block until `min_replicas` (default: all non-down) replicas
        are routable.  False on timeout."""
        deadline = (time.monotonic() + timeout) if timeout else None
        while True:
            with self._lock:
                up = sum(1 for r in self.replicas
                         if r.healthy and r.ready)
                want = (min_replicas if min_replicas is not None
                        else sum(1 for r in self.replicas if not r.down))
            if want > 0 and up >= want:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if self._stop.is_set():
                return False
            time.sleep(0.05)

    def stop(self, drain: bool = True, timeout: float = 30.0
             ) -> Dict[int, Optional[int]]:
        """Stop supervision and the replicas: SIGTERM each spawned
        replica (its own drain machinery completes the queued backlog
        and exits 143), bounded wait, then SIGKILL stragglers.  Returns
        {idx: returncode}.  Adopted replicas are left running."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        rcs: Dict[int, Optional[int]] = {}
        with self._lock:
            procs = [(r.idx, r.proc) for r in self.replicas
                     if r.proc is not None]
        sig = signal.SIGTERM if drain else signal.SIGKILL
        for _idx, proc in procs:
            if proc.poll() is None:
                try:
                    proc.send_signal(sig)
                except OSError:
                    pass
        deadline = time.monotonic() + max(float(timeout), 0.1)
        for idx, proc in procs:
            rem = max(deadline - time.monotonic(), 0.1)
            try:
                rcs[idx] = proc.wait(timeout=rem)
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs[idx] = proc.wait()
        emit_event("serve_fleet_stop", returncodes={
            str(k): v for k, v in sorted(rcs.items())})
        return rcs

    # ---------------------------------------------------------- supervision
    def _supervise(self) -> None:
        """Poll loop: exits, ready files, health probes, relaunches."""
        while not self._stop.is_set():
            with self._lock:
                replicas = list(self.replicas)
            now = time.monotonic()
            for r in replicas:
                try:
                    self._tick_replica(r, now)
                except Exception as e:  # noqa: BLE001 - supervision must survive a probe error
                    log.warning(f"Fleet supervisor tick failed for "
                                f"replica {r.idx}: {e}")
            self._stop.wait(self.POLL_INTERVAL_S)

    def _tick_replica(self, r: ReplicaState, now: float) -> None:
        # snapshot under the lock; the slow work (waitpid, file read,
        # health round trip) runs lock-free on locals, and the writes
        # re-take the lock — endpoints() must never block on a probe
        with self._lock:
            proc, down, relaunch_at = r.proc, r.down, r.relaunch_at
            port, adopted, spawned_at = r.port, r.adopted, r.spawned_at
            probe_due = (now - r.last_probe >= self.health_interval_s)
        # 1) exit detection + classified relaunch (spawned replicas)
        if proc is not None and not down and relaunch_at is None:
            rc = proc.poll()
            if rc is not None and not self._stop.is_set():
                self._on_replica_exit(r, rc)
                return
        # 2) pending relaunch after backoff
        if relaunch_at is not None and now >= relaunch_at and not down:
            with self._lock:
                self._spawn(r)
                gen, restarts = r.gen, r.restarts
            global_registry.inc("serve_replica_restarts")
            emit_event("serve_replica_restart", replica=r.idx,
                       gen=gen, restarts=restarts)
            return
        # 3) ready-file discovery (port lands once the daemon warmed)
        if port is None and not adopted:
            if proc is None or relaunch_at is not None:
                return
            info = self._read_ready_file(r.idx)
            if info is not None:
                new_port = int(info.get("port", -1))
                with self._lock:
                    # <0 = replica runs without a TCP front end
                    r.port = new_port if new_port >= 0 else None
                    port = r.port
            elif now - spawned_at > self.READY_TIMEOUT_S:
                log.warning(f"Fleet replica {r.idx} produced no ready "
                            f"file within {self.READY_TIMEOUT_S}s")
        # 4) health probe
        if port is not None and probe_due:
            with self._lock:
                r.last_probe = now
            self._probe(r, port)

    def _on_replica_exit(self, r: ReplicaState, rc: int) -> None:
        kind = classify_returncode(rc)
        tail = tail_file(self._log_file(r.idx), max_bytes=2048)
        global_registry.inc("serve_replica_down")
        # the dead process's counters are gone; a relaunch restarts them
        # from zero — keeping the stale scrape would double-count
        self.aggregator.forget(r.idx)
        with self._lock:
            r.healthy = False
            r.ready = False
            r.port = None
            exhausted = r.restarts >= self.max_restarts
            if exhausted:
                r.down = True
            else:
                r.restarts += 1
                backoff = min(self.BACKOFF_BASE_S * (2 ** (r.restarts - 1)),
                              self.BACKOFF_CAP_S)
                r.relaunch_at = time.monotonic() + backoff
            restarts = r.restarts
        emit_event("serve_replica_down", replica=r.idx, returncode=rc,
                   kind=kind, restarts=restarts,
                   permanent=bool(exhausted), log_tail=tail[-512:])
        log.warning(f"Fleet replica {r.idx} exited rc={rc} ({kind}); "
                    + ("restart budget exhausted — replica is down"
                       if exhausted else
                       f"relaunching (restart {restarts}/"
                       f"{self.max_restarts})"))

    def _read_ready_file(self, idx: int) -> Optional[Dict[str, object]]:
        path = self._ready_file(idx)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None  # not landed yet (atomic write: never torn)

    def _probe(self, r: ReplicaState, port: int) -> None:
        """One `op=health` round trip (+ an `op=metrics` scrape for the
        fleet aggregator on the same connection); mutates r under the
        lock."""
        from .frontend import LineClient
        client = LineClient(r.host, port, connect_timeout_s=0.75,
                            max_connect_attempts=1)
        try:
            h = client.request({"op": "health"}, timeout_s=2.0)
            with self._lock:
                r.healthy = bool(h.get("ok"))
                r.ready = bool(h.get("ready"))
                r.shedding = bool(h.get("shedding"))
                r.versions = {str(k): int(v) for k, v in
                              (h.get("models") or {}).items()}
            if h.get("ok"):
                # the aggregator's scrape rides the probe tick: same
                # wire, same connection, one extra round trip
                m = client.request({"op": "metrics"}, timeout_s=2.0)
                if m.get("ok") and m.get("metrics"):
                    self.aggregator.record_scrape(r.idx, m["metrics"])
        except (ConnectionError, OSError):
            with self._lock:
                r.healthy = False
                r.ready = False
        finally:
            client.close()

    def scrape_all(self) -> int:
        """Force one synchronous aggregator refresh of every ROUTABLE
        replica (tests and the bench compare merged-vs-per-replica
        counters and need a consistent snapshot, not a probe-tick-stale
        one).  Returns the number of replicas scraped."""
        from .frontend import LineClient
        n = 0
        for ep in self.endpoints():
            client = LineClient(ep.host, ep.port, connect_timeout_s=0.75,
                                max_connect_attempts=1)
            try:
                m = client.request({"op": "metrics"}, timeout_s=5.0)
                if m.get("ok") and m.get("metrics"):
                    self.aggregator.record_scrape(ep.idx, m["metrics"])
                    n += 1
            except (ConnectionError, OSError):
                pass
            finally:
                client.close()
        return n

    # -------------------------------------------------------------- access
    def endpoints(self, model: Optional[str] = None
                  ) -> List[ReplicaEndpoint]:
        """Snapshot of the ROUTABLE replicas (healthy + ready + port
        known), optionally filtered to those serving `model`."""
        with self._lock:
            out = []
            for r in self.replicas:
                if r.down or not r.healthy or not r.ready \
                        or r.port is None:
                    continue
                if model is not None and r.versions \
                        and model not in r.versions:
                    continue
                out.append(ReplicaEndpoint(r.idx, r.host, r.port, r.gen,
                                           r.shedding, dict(r.versions)))
            return out

    def describe(self) -> List[Dict[str, object]]:
        with self._lock:
            return [r.describe() for r in self.replicas]

    def alive(self) -> bool:
        with self._lock:
            return any(not r.down for r in self.replicas)

    def set_model_path(self, name: str, path: str) -> None:
        """Fleet-coordinated rollout, relaunch half: after a publish
        lands (router.publish / canary promotion), future RELAUNCHES
        must load the new version — otherwise a crash during steady
        state would resurrect the retired incumbent into the fleet."""
        with self._lock:
            found = False
            for i, (n, _p) in enumerate(self.model_entries):
                if n == name:
                    self.model_entries[i] = (name, str(path))
                    found = True
            if not found:
                self.model_entries.append((name, str(path)))
