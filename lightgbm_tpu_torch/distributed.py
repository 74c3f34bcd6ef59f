"""Programmatic multi-process training (PyTorch port of
`lightgbm_tpu/distributed.py`; the role the reference's Dask integration
plays in its Python stack, ref: python-package/lightgbm/dask.py:414
_train: resolve workers -> build machine list -> run train on every
worker -> return the model).  The "network" is a torch.distributed
process group, one process per rank (parallel/data_parallel.py).

Two entry points:

* `join_cluster(...)` — for users who already run one process per rank
  (SLURM, k8s): resolves this worker's rank from a reference-style
  machine list (or explicit rank), picks the rank's device and the
  cluster's backend (`cluster_backend`: NCCL where every rank has a card
  of its own, gloo on the CPU or where ranks share one card) and forms the
  group over a TCPStore at `machines[0]` (or a FileStore at
  `store_path`), with `initialize_timeout` seconds for every
  collective.  After it returns, `train(params with tree_learner=data)`
  trains this rank's rows.  This is the library form of the CLI's
  `machines=` launch (cli.py `_maybe_init_distributed`).

* `train_distributed(...)` — single-host convenience that SPAWNS
  `num_machines` worker processes (the LocalCluster analogue), each
  importing only this package, joined over a FileStore in a private
  work directory, trains a parallel learner (tree_learner=data unless
  the params name feature or voting) across them under the supervisor
  (reliability/supervisor.py: the first failed rank kills the rest),
  and returns rank 0's model as a Booster.  Every worker loads the whole
  host arrays and keeps its rows (or, under feature, its columns) on its
  device; the ranks' models are identical by construction.  With
  `max_retries > 0` a failed cluster is relaunched from its checkpoints
  (a group's checkpoint holds the serial run's state, so it resumes at
  any world size); a rank lost for good (`ElasticPolicy`) shrinks the
  next attempt around it, and a hung attempt walks the degradation
  ladder.
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

from .utils import log


def _local_names() -> set:
    names = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        names.update(socket.gethostbyname_ex(socket.gethostname())[2])
    except OSError:
        pass
    return names


def _split_entry(entry: str):
    host, sep, port = entry.rpartition(":")
    if not sep or not port.isdigit():
        log.fatal(f"Malformed machines entry {entry!r}; expected host:port")
    return host, int(port)


def resolve_rank(machines: List[str], local_listen_port: int) -> int:
    """Reference-style rank resolution: this host's (name/ip, port) found
    in the ordered machine list (ref: network.cpp Network::Init)."""
    local = _local_names()
    for i, e in enumerate(machines):
        host, port = _split_entry(e)
        if host in local and port == local_listen_port:
            return i
    log.fatal("This machine is not in the machine list; include host:port "
              "for every worker")


def _wait_for_coordinator(address: str, timeout: float) -> None:
    """Pre-flight TCP probe of the coordinator (machines[0], which holds
    the TCPStore): a clear error instead of a store that waits out its
    timeout.  Retries until `timeout`; workers may legitimately start
    before the coordinator is up."""
    host, port = _split_entry(address)
    deadline = time.monotonic() + timeout
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=2):
                return
        except OSError as e:
            last_err = e
            time.sleep(0.5)
    log.fatal(
        f"Coordinator {address} is unreachable after {timeout:.0f}s "
        f"({last_err}). Check that the rank-0 process is running, that "
        "every worker uses the SAME machine list (entry 0 is the "
        "coordinator), and that the port is not blocked by a firewall.")


def _ranks_on_host(machines: List[str], rank: int) -> List[int]:
    """The machine list's entries on `rank`'s host, in list order."""
    local = _local_names()
    hosts = [_split_entry(e)[0] for e in machines]
    return [i for i, h in enumerate(hosts) if h in local or h == hosts[rank]]


def cluster_backend(store, machines: List[str], rank: int,
                    device_type: str) -> str:
    """The backend of the whole cluster, the same on every rank: NCCL
    only when every rank's host has a card for each of its ranks
    (`backend_for` on that host's count), else gloo.  Each rank publishes
    its host's answer on the group's store and reads every other's, so
    hosts with different numbers of ranks or cards still agree."""
    import torch.distributed as dist

    from .parallel.data_parallel import backend_for
    votes = dist.PrefixStore("lgbm_tpu_torch_backend", store)
    votes.set(str(rank), backend_for(device_type,
                                     len(_ranks_on_host(machines, rank))))
    chosen = [votes.get(str(r)).decode() for r in range(len(machines))]
    return "nccl" if all(c == "nccl" for c in chosen) else "gloo"


def join_cluster(machines, rank: Optional[int] = None,
                 local_listen_port: int = 12400,
                 initialize_timeout: Optional[float] = None, *,
                 device_type: str = "cuda",
                 store_path: Optional[str] = None) -> int:
    """Form the torch.distributed group of a reference-style machine list
    and return this process's rank.  Entry 0 is the coordinator: rank 0
    serves a TCPStore at its host:port (`store_path` replaces it with a
    FileStore that every rank can reach).  The rank's index among the
    entries on its host picks the card, `cuda:(index % device_count)`;
    the backend is the cluster's (`cluster_backend`).
    `initialize_timeout` (seconds, default 120, the reference's
    `time_out`) bounds the wait for the coordinator and every later
    collective.  A group that fails to form raises; it never falls back
    to serial training."""
    import torch.distributed as dist

    from .parallel.data_parallel import forget_network, rank_device
    if isinstance(machines, str):
        machines = [e.strip() for e in machines.split(",") if e.strip()]
    machines = list(machines)
    world = len(machines)
    if world < 1:
        log.fatal("join_cluster needs at least one machines entry")
    if rank is None:
        rank = resolve_rank(machines, local_listen_port)
    if not 0 <= rank < world:
        log.fatal(f"rank {rank} outside a cluster of {world}")
    timeout = float(initialize_timeout if initialize_timeout is not None
                    else 120.0)
    device = rank_device(device_type,
                         _ranks_on_host(machines, rank).index(rank))
    host0, port0 = _split_entry(machines[0])
    td = datetime.timedelta(seconds=timeout)
    try:
        if store_path:
            store = dist.FileStore(store_path, world)
            store.set_timeout(td)
        else:
            if rank != 0:
                _wait_for_coordinator(machines[0], timeout)
            store = dist.TCPStore(host0, port0, world, is_master=rank == 0,
                                  timeout=td)
        backend = cluster_backend(store, machines, rank, device_type)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=td)
    except Exception as e:  # noqa: BLE001 - re-raised with the cause
        log.fatal(
            f"Could not join the training cluster as rank {rank}/{world} "
            f"({type(e).__name__}: {e}). Check that the rank-0 process is "
            "running, that every worker uses the SAME machine list (entry "
            "0 is the coordinator), and that the port is not blocked.")
    forget_network()
    log.info(f"Joined cluster as rank {rank}/{world} (coordinator "
             f"{machines[0]}) on {device} over {backend} (NCCL where "
             "every rank has a card of its own, else gloo)")
    return rank


def leave_cluster() -> None:
    """Destroy the default process group (if any)."""
    import torch.distributed as dist

    from .parallel.data_parallel import forget_network
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    forget_network()


_WORKER_MAIN = r"""
import json, os, pickle, sys, time
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
for k, v in spec.get("env", {}).items():
    os.environ[k] = v
# fault-injection context: which worker and which attempt this is (a
# retried cluster bumps the attempt, so one-shot faults do not re-fire)
os.environ["LGBM_TPU_FAULT_SELF_RANK"] = str(rank)
os.environ["LGBM_TPU_FAULT_ATTEMPT"] = str(spec.get("attempt", 0))
os.environ["LGBM_TPU_WORLD_SIZE"] = str(spec["num_machines"])
sys.path.insert(0, spec["repo"])
# permanent-loss model (reliability/faults.py): a tombstoned (rank,
# world) refuses every same-world relaunch before joining the cluster,
# a fast clean exit the supervisor sees at once; only an elastic shrink
# (another world size) gets past it
if spec.get("tombstone_dir"):
    os.environ["LGBM_TPU_TOMBSTONE_DIR"] = spec["tombstone_dir"]
    from lightgbm_tpu_torch.reliability import faults as _faults
    _faults.check_tombstone()
# stall detection (reliability/guard.py): the engine's RunGuard touches
# this file once per boosting iteration; the supervising parent polls its
# mtime to catch live-but-hung ranks
if spec.get("heartbeat_dir"):
    os.makedirs(spec["heartbeat_dir"], exist_ok=True)
    os.environ["LGBM_TPU_HEARTBEAT_FILE"] = os.path.join(
        spec["heartbeat_dir"], f"heartbeat-rank{rank}")
    os.environ["LGBM_TPU_STALL_DIR"] = spec["heartbeat_dir"]
import torch
if spec.get("torch_threads"):
    torch.set_num_threads(int(spec["torch_threads"]))
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.distributed import join_cluster, leave_cluster
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.parallel import current_network
from lightgbm_tpu_torch.reliability import faults
faults.register_stack_dump_signal()
params = dict(spec["params"])
params.setdefault("tree_learner", "data")
if spec.get("reshard"):
    # elastic relaunch: every rank derives the same row plan from the
    # same three integers (parallel/elastic.py), with no communication
    from lightgbm_tpu_torch.parallel import reshard_plan, rows_of
    rs = spec["reshard"]
    if rs.get("num_rows"):
        plan = reshard_plan(rs["old_n"], rs["new_n"], rs["num_rows"])
        assert plan.new_n == spec["num_machines"]
        print(f"worker {rank} reshard {json.dumps(plan.summary())} rows="
              f"{list(rows_of(rs['num_rows'], rs['new_n'], rank))}",
              flush=True)
join_cluster(["localhost:0"] * spec["num_machines"], rank=rank,
             initialize_timeout=spec["timeout"],
             device_type=params.get("device_type", "cuda"),
             store_path=spec["store"])
with open(spec["data"], "rb") as f:
    payload = pickle.load(f)
if isinstance(payload, str):
    ds = lgb.Dataset(payload, params=params)
else:
    ds = lgb.Dataset(payload["X"], label=payload.get("y"),
                     weight=payload.get("weight"),
                     group=payload.get("group"), params=params)
ds.construct()
kernels = (H.build_histogram_wave, H.build_histogram_wave_hl,
           H.build_histogram_wave_int, H.build_histogram_rows_pallas)
for k in kernels:
    k.launches = 0
net = current_network()
before = dict(net.stats())
t0 = time.perf_counter()
ckpt_dir = spec.get("checkpoint_dir") or None
booster = lgb.train(params, ds, num_boost_round=spec["num_boost_round"],
                    checkpoint_dir=ckpt_dir,
                    checkpoint_freq=spec.get("checkpoint_freq", 0),
                    resume=bool(ckpt_dir))
if torch.cuda.is_available() and params.get("device_type", "cuda") != "cpu":
    torch.cuda.synchronize()
seconds = time.perf_counter() - t0
after = net.stats()
stats = {"rank": rank, "attempt": spec.get("attempt", 0),
         "seconds": seconds, "iterations": booster.current_iteration(),
         "backend": after["backend"], "world": after["world"],
         "allreduce_calls": after["calls"] - before["calls"],
         "allreduce_bytes": after["bytes"] - before["bytes"],
         "allreduce_seconds": after["seconds"] - before["seconds"],
         "launches": {k.__name__: k.launches for k in kernels}}
# the train metrics every rank reads at the end (one collective tick)
stats["train_metrics"] = {m: v for _, m, v, _ in booster.eval_train()}
print("worker_stats " + json.dumps(stats), flush=True)
if rank == 0:
    booster.save_model(spec["model_out"])
leave_cluster()
print(f"worker {rank} done", flush=True)
"""


def _parse_stats(log_path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(log_path) as f:
            for ln in f:
                if ln.startswith("worker_stats "):
                    return json.loads(ln[len("worker_stats "):])
    except OSError:
        pass
    return None


def _ckpt_num_rows(checkpoint_dir: Optional[str]) -> Optional[int]:
    """The training-row count in the checkpoint manifest: the one number
    the elastic reshard plan derives from, so the parent and every
    relaunched rank agree on it without communicating."""
    if not checkpoint_dir:
        return None
    try:
        from .reliability.checkpoint import MANIFEST
        with open(os.path.join(checkpoint_dir, MANIFEST)) as f:
            n = json.load(f).get("num_rows")
        return int(n) if n else None
    except (OSError, ValueError, TypeError):
        return None


def train_distributed(params: Dict[str, Any], data, label=None, *,
                      weight=None, group=None, num_boost_round: int = 100,
                      num_machines: int = 2,
                      worker_env: Optional[Dict[str, str]] = None,
                      force_cpu: bool = False, timeout: int = 900,
                      max_retries: int = 0,
                      checkpoint_dir: Optional[str] = None,
                      checkpoint_freq: int = 0, retry_backoff: float = 1.0,
                      poll_interval: float = 0.25,
                      stall_timeout: Optional[float] = None):
    """Spawn `num_machines` local worker processes, train a parallel
    learner (tree_learner=data unless the params name feature or voting)
    across them, and return rank 0's model as a Booster (all ranks hold
    the same model).

    `data` may be a file path (each worker loads it) or an array; arrays
    are shipped to the workers through a temp file.  `worker_env` sets
    per-worker env vars; `force_cpu` trains on the CPU (device_type=cpu,
    gloo).  The workers are SUPERVISED: the first non-zero exit, a stale
    heartbeat (`stall_timeout` seconds) or `timeout` kills every worker.

    Fault tolerance (the JAX package's relaunch loop): with
    `max_retries > 0` the whole cluster is relaunched after
    `retry_backoff * 2**attempt` seconds, on a fresh store, resuming
    from the newest checkpoint in `checkpoint_dir` (a per-run directory
    with checkpoint_freq=1 when none is given, so a retry repeats at
    most one iteration).  A rank lost for good (it tombstoned itself,
    or failed twice past `elastic_rank_grace_s`) shrinks the next
    attempt around it (`ElasticPolicy`; below `elastic_min_machines` the
    run gives up), every rank re-deriving its rows from the
    checkpoint's row count; a hung attempt with `auto_degrade` relaunches
    with the next ladder knob off.  When every attempt fails this call
    raises with the last failed rank's log tail.

    The returned Booster's `worker_stats` holds each rank's seconds,
    iterations, backend, collective calls/bytes/seconds, kernel launch
    counts and final train metrics in the attempt that finished;
    `elastic_shrinks`, `degraded_knobs`, `final_num_machines` and
    `attempts` describe the relaunches."""
    import shutil

    if num_machines < 1:
        log.fatal(f"num_machines must be positive, got {num_machines}")
    work = tempfile.mkdtemp(prefix="lgbtorch_dist")
    try:
        return _train_distributed_in(
            work, params, data, label, weight, group, num_boost_round,
            num_machines, worker_env, force_cpu, timeout, poll_interval,
            stall_timeout, max_retries=max_retries,
            checkpoint_dir=checkpoint_dir, checkpoint_freq=checkpoint_freq,
            retry_backoff=retry_backoff)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _train_distributed_in(work, params, data, label, weight, group,
                          num_boost_round, num_machines, worker_env,
                          force_cpu, timeout, poll_interval, stall_timeout,
                          *, max_retries=0, checkpoint_dir=None,
                          checkpoint_freq=0, retry_backoff=1.0):
    from .basic import Booster
    from .config import Config
    from .reliability.elastic import (GIVE_UP, SHRINK, ElasticPolicy,
                                      plan_for_shrink)
    from .reliability.guard import (_LADDER_KNOBS, disabled_value,
                                    next_degradation)
    from .reliability.supervisor import supervise

    params = dict(params)
    if force_cpu:
        params["device_type"] = "cpu"
    params.setdefault("tree_learner", "data")
    run_cfg = Config(dict(params))
    auto_degrade = bool(run_cfg.auto_degrade)
    if stall_timeout is None:
        stall_timeout = (max(10.0 * run_cfg.stall_floor_s, 600.0)
                         if run_cfg.stall_floor_s > 0 else 0.0)
    data_path = os.path.join(work, "data.pkl")
    with open(data_path, "wb") as f:
        if isinstance(data, (str, os.PathLike)):
            pickle.dump(str(data), f)
        else:
            pickle.dump({"X": data if hasattr(data, "tocsr")
                         else np.asarray(data),
                         "y": None if label is None else np.asarray(label),
                         "weight": (None if weight is None
                                    else np.asarray(weight)),
                         "group": (None if group is None
                                   else np.asarray(group))}, f)
    model_out = os.path.join(work, "model.txt")
    if max_retries > 0 and not checkpoint_dir:
        # retries without checkpoints would replay the whole run: a
        # per-run directory, so a retry loses at most one iteration
        checkpoint_dir = os.path.join(work, "ckpt")
        if checkpoint_freq <= 0:
            checkpoint_freq = 1
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER_MAIN)
    # the supervisor's own event stream beside the workers' when the run
    # has a metrics_dir: cluster relaunches, shrinks and degradations
    evt = None
    if params.get("metrics_dir"):
        from .observability import EventLogger
        try:
            evt = EventLogger(params["metrics_dir"], rank="supervisor")
        except OSError as e:
            log.warning(f"Could not open the supervisor event log in "
                        f"{params['metrics_dir']}: {e}")
    # the parent walks the degradation ladder: the workers must not also
    # consume stall files and degrade twice
    worker_params = dict(params)
    worker_params["auto_degrade"] = False
    degraded_knobs: List[str] = []
    policy = ElasticPolicy(num_machines,
                           min_machines=run_cfg.elastic_min_machines,
                           rank_grace_s=run_cfg.elastic_rank_grace_s)
    reshard: Optional[Dict[str, Any]] = None
    last_failure = "no workers launched"
    for attempt in range(max_retries + 1):
        world = policy.num_machines
        torch_threads = 0
        if str(worker_params.get("device_type")) == "cpu":
            # CPU ranks share the host's cores instead of oversubscribing
            torch_threads = max(1, (os.cpu_count() or 1) // world)
        # per attempt: a fresh store (the last attempt's may hold a dead
        # rank's keys) and heartbeat directory; tombstones key on the
        # stable work directory and so outlive attempts
        hb_dir = os.path.join(work, f"hb_a{attempt}")
        spec = {"num_machines": int(world), "params": dict(worker_params),
                "num_boost_round": int(num_boost_round), "data": data_path,
                "model_out": model_out,
                "store": os.path.join(work, f"store_a{attempt}"),
                "repo": os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))),
                "env": dict(worker_env or {}), "heartbeat_dir": hb_dir,
                "timeout": float(timeout), "torch_threads": torch_threads,
                "attempt": attempt, "checkpoint_dir": checkpoint_dir,
                "checkpoint_freq": int(checkpoint_freq),
                "tombstone_dir": work, "reshard": reshard}
        spec_path = os.path.join(work, f"spec_a{attempt}.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        # worker output goes to files, not PIPEs: a chatty rank filling a
        # pipe buffer would block inside a collective and stall every rank
        log_paths = [os.path.join(work, f"worker_{r}_a{attempt}.log")
                     for r in range(world)]
        log_files = [open(p, "w") for p in log_paths]
        procs = []
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    [sys.executable, script, spec_path, str(r)],
                    stdout=log_files[r], stderr=subprocess.STDOUT,
                    text=True))
            result = supervise(
                procs, log_paths, timeout, poll_interval=poll_interval,
                heartbeats=[os.path.join(hb_dir, f"heartbeat-rank{r}")
                            for r in range(world)],
                stall_timeout=stall_timeout,
                stall_dir=str(params.get("metrics_dir") or "") or hb_dir)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for lf in log_files:
                lf.close()
        if result.ok and os.path.exists(model_out):
            if attempt > 0:
                log.info(f"Distributed training succeeded on retry "
                         f"{attempt} (resumed from {checkpoint_dir})"
                         + (f" with degraded knobs {degraded_knobs}"
                            if degraded_knobs else "")
                         + (f" on a shrunken {world}-rank cluster"
                            if policy.shrinks else ""))
                if evt is not None:
                    evt.emit("cluster_retry_succeeded", attempt=attempt,
                             degraded_knobs=degraded_knobs,
                             num_machines=world,
                             elastic_shrinks=policy.shrinks)
            booster = Booster(model_file=model_out, params={
                "device_type": params.get("device_type", "cuda")})
            booster.worker_stats = [_parse_stats(p) for p in log_paths]
            booster.degraded_knobs = list(degraded_knobs)
            booster.elastic_shrinks = policy.shrinks
            booster.final_num_machines = int(world)
            booster.attempts = attempt + 1
            return booster
        last_failure = (result.describe() if not result.ok else
                        "all workers exited 0 but no model file was written")
        genuine = bool(result.failures) or result.timed_out
        classification = result.classification if genuine else "crash"
        if evt is not None:
            evt.emit("cluster_attempt_failed", attempt=attempt,
                     classification=classification,
                     failure=(last_failure.splitlines()[0]
                              if last_failure else ""))
        if attempt >= max_retries:
            break
        decision = policy.observe(result) if genuine else None
        if decision is not None and decision.action == GIVE_UP:
            log.fatal(f"distributed training cannot continue: "
                      f"{decision.reason}\n{last_failure}")
        if decision is not None and decision.action == SHRINK:
            # shrink first, then walk knobs (the ladder's hang evidence
            # was gathered on a topology that no longer exists); the
            # relaunch resumes from the checkpoint on the surviving ranks
            old_n, new_n = world, decision.num_machines
            plan = plan_for_shrink(old_n, new_n,
                                   _ckpt_num_rows(checkpoint_dir))
            reshard = {"old_n": old_n, "new_n": new_n,
                       "num_rows": plan.num_rows if plan else None}
            log.warning(f"elastic_shrink: {decision.reason}; relaunching "
                        f"on {new_n} rank(s)"
                        + (f", reshard {plan.summary()}" if plan else "")
                        + (f", resuming from {checkpoint_dir}"
                           if checkpoint_dir else ""))
            if evt is not None:
                evt.emit("elastic_shrink", old_num_machines=old_n,
                         new_num_machines=new_n,
                         lost_ranks=decision.lost_ranks,
                         attempt=attempt + 1,
                         reshard=plan.summary() if plan else None)
        elif result.hang and auto_degrade:
            # the attempt hung: relaunch with the next risky knob off
            # instead of replaying the same configuration into the stall
            effective = {k: getattr(Config(dict(worker_params)), k)
                         for k in _LADDER_KNOBS}
            knob = next_degradation(effective, degraded_knobs)
            if knob is not None:
                worker_params[knob] = disabled_value(knob)
                degraded_knobs.append(knob)
                log.warning(f"auto_degrade: attempt {attempt} hung; "
                            f"relaunching with {knob} disabled (degraded "
                            f"so far: {degraded_knobs})")
                if evt is not None:
                    evt.emit("degrade", knob=knob, attempt=attempt + 1,
                             active=list(degraded_knobs))
            else:
                log.warning("auto_degrade: ladder exhausted; relaunching "
                            "unchanged")
        elif classification == "preempt":
            log.warning(f"attempt {attempt} was preempted (SIGTERM); "
                        "relaunching at the same world size"
                        + (f", resuming from {checkpoint_dir}"
                           if checkpoint_dir else ""))
        delay = retry_backoff * (2 ** attempt)
        if evt is not None:
            evt.emit("cluster_retry", next_attempt=attempt + 1,
                     delay_s=delay)
        log.warning(f"Distributed training attempt {attempt + 1}/"
                    f"{max_retries + 1} failed:\n{last_failure}\n"
                    f"Relaunching the cluster in {delay:.1f}s"
                    + (f", resuming from checkpoints in {checkpoint_dir}"
                       if checkpoint_dir else ""))
        time.sleep(delay)
    log.fatal(f"distributed training failed after {attempt + 1} "
              f"attempt(s):\n{last_failure}")
