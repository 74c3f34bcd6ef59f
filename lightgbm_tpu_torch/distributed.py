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
  work directory, trains tree_learner=data across them under the
  supervisor (reliability/supervisor.py: the first failed rank kills the
  rest), and returns rank 0's model as a Booster.  Every worker loads
  the whole host arrays and keeps its own rows on its device; the ranks'
  models are identical by construction.  Retries, checkpoints and the
  elastic shrink wait for ROADMAP Queue 1 item 15.
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
# fault-injection context: which worker this is
os.environ["LGBM_TPU_FAULT_SELF_RANK"] = str(rank)
os.environ["LGBM_TPU_FAULT_ATTEMPT"] = "0"
os.environ["LGBM_TPU_WORLD_SIZE"] = str(spec["num_machines"])
# stall detection (reliability/guard.py): the engine's RunGuard touches
# this file once per boosting iteration; the supervising parent polls its
# mtime to catch live-but-hung ranks
if spec.get("heartbeat_dir"):
    os.makedirs(spec["heartbeat_dir"], exist_ok=True)
    os.environ["LGBM_TPU_HEARTBEAT_FILE"] = os.path.join(
        spec["heartbeat_dir"], f"heartbeat-rank{rank}")
    os.environ["LGBM_TPU_STALL_DIR"] = spec["heartbeat_dir"]
sys.path.insert(0, spec["repo"])
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
booster = lgb.train(params, ds, num_boost_round=spec["num_boost_round"])
if torch.cuda.is_available() and params.get("device_type", "cuda") != "cpu":
    torch.cuda.synchronize()
seconds = time.perf_counter() - t0
after = net.stats()
stats = {"rank": rank, "seconds": seconds,
         "iterations": booster.current_iteration(),
         "backend": after["backend"], "world": after["world"],
         "allreduce_calls": after["calls"] - before["calls"],
         "allreduce_bytes": after["bytes"] - before["bytes"],
         "allreduce_seconds": after["seconds"] - before["seconds"],
         "launches": {k.__name__: k.launches for k in kernels}}
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
    """Spawn `num_machines` local worker processes, train
    tree_learner=data across them, and return rank 0's model as a
    Booster (all ranks hold the same model).

    `data` may be a file path (each worker loads it) or an array; arrays
    are shipped to the workers through a temp file.  `worker_env` sets
    per-worker env vars; `force_cpu` trains on the CPU (device_type=cpu,
    gloo).  The workers are SUPERVISED: the first non-zero exit, a stale
    heartbeat (`stall_timeout` seconds) or `timeout` kills every worker,
    and this call raises with the failed rank's log tail.  The returned
    Booster's `worker_stats` holds each rank's seconds, iterations,
    backend, all-reduce calls/bytes/seconds and kernel launch counts.
    `max_retries > 0`, `checkpoint_dir`, `checkpoint_freq` and
    `retry_backoff` (relaunch from checkpoints) are not ported yet
    (ROADMAP Queue 1 item 15): any of them off its default raises."""
    import shutil

    if (max_retries > 0 or checkpoint_dir or checkpoint_freq
            or retry_backoff != 1.0):
        raise NotImplementedError(
            "train_distributed's relaunch with retries and checkpoints is "
            "not ported yet (ROADMAP Queue 1 item 15)")
    if num_machines < 1:
        log.fatal(f"num_machines must be positive, got {num_machines}")
    work = tempfile.mkdtemp(prefix="lgbtorch_dist")
    try:
        return _train_distributed_in(
            work, params, data, label, weight, group, num_boost_round,
            num_machines, worker_env, force_cpu, timeout, poll_interval,
            stall_timeout)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _train_distributed_in(work, params, data, label, weight, group,
                          num_boost_round, num_machines, worker_env,
                          force_cpu, timeout, poll_interval, stall_timeout):
    from .basic import Booster
    from .config import Config
    from .reliability.supervisor import supervise

    params = dict(params)
    if force_cpu:
        params["device_type"] = "cpu"
    params.setdefault("tree_learner", "data")
    torch_threads = 0
    if str(params.get("device_type")) == "cpu":
        # CPU ranks share the host's cores instead of oversubscribing them
        torch_threads = max(1, (os.cpu_count() or 1) // num_machines)
    run_cfg = Config(dict(params))
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
    hb_dir = os.path.join(work, "hb")
    spec = {"num_machines": int(num_machines), "params": params,
            "num_boost_round": int(num_boost_round), "data": data_path,
            "model_out": model_out, "store": os.path.join(work, "store"),
            "repo": os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
            "env": dict(worker_env or {}), "heartbeat_dir": hb_dir,
            "timeout": float(timeout),
            "torch_threads": torch_threads}
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER_MAIN)
    # worker output goes to files, not PIPEs: a chatty rank filling a
    # pipe buffer would block inside a collective and stall every rank
    log_paths = [os.path.join(work, f"worker_{r}.log")
                 for r in range(num_machines)]
    log_files = [open(p, "w") for p in log_paths]
    procs = []
    try:
        for r in range(num_machines):
            procs.append(subprocess.Popen(
                [sys.executable, script, spec_path, str(r)],
                stdout=log_files[r], stderr=subprocess.STDOUT, text=True))
        result = supervise(
            procs, log_paths, timeout, poll_interval=poll_interval,
            heartbeats=[os.path.join(hb_dir, f"heartbeat-rank{r}")
                        for r in range(num_machines)],
            stall_timeout=stall_timeout,
            stall_dir=str(params.get("metrics_dir") or "") or hb_dir)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in log_files:
            lf.close()
    if not result.ok or not os.path.exists(model_out):
        why = (result.describe() if not result.ok else
               "all workers exited 0 but no model file was written")
        log.fatal(f"distributed training failed:\n{why}")
    booster = Booster(model_file=model_out,
                      params={"device_type": params.get("device_type",
                                                        "cuda")})
    booster.worker_stats = [_parse_stats(p) for p in log_paths]
    booster.final_num_machines = int(num_machines)
    return booster
