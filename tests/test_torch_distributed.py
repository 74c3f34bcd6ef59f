"""PyTorch port: the cluster entry points of data-parallel training, on
the CPU.

* `train_distributed` spawns its ranks (gloo), supervises them and
  returns rank 0's model, whose text equals the serial run's; a rank
  that exits non-zero (the port's `reliability/faults.py` worker_crash)
  makes it raise within its deadline, with no child left.
* `join_cluster` over a FileStore, in this process at world 1: the
  refusals that remain under the row-sharding learners name ROADMAP
  Queue 1 item 15 (ranking, percentile renewal, linear trees; voting's
  too), while the feature learner, which shards no rows, trains a
  ranking objective; a group's checkpoints resume to the serial model,
  and so do `train_distributed`'s retries.
* The command line with num_machines=2 and a machines list: two CLI
  processes (their rank from LIGHTGBM_TPU_MACHINE_RANK, the group's
  TCPStore at the first entry's free port), both models equal to the
  serial one.
* `resolve_rank`, `backend_for`, `cluster_backend` on a machine list
  with an uneven number of ranks per host, `rows_of`/`reshard_plan` and
  `merged_bin_mappers` against the JAX package's.

Every child process is killed in a `finally` and waited for with a
deadline.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch.parallel import (backend_for, merged_bin_mappers,
                                         reshard_plan, rows_of, sample_rows)
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
          "max_bin": 32, "verbosity": -1, "tree_learner": "data",
          "device_type": "cpu"}
DEADLINE_S = 120


def _data(n=4096, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit))).astype(np.float64)
    return X, y


def _serial_text(params, X, y, rounds):
    return tlgb.train(params, tlgb.Dataset(X, label=y),
                      rounds).model_to_string()


def test_train_distributed_equals_serial():
    X, y = _data()
    b = tdist.train_distributed(PARAMS, X, y, num_boost_round=4,
                                num_machines=2, force_cpu=True,
                                timeout=DEADLINE_S)
    assert b.model_to_string() == _serial_text(PARAMS, X, y, 4)
    assert [st["rank"] for st in b.worker_stats] == [0, 1]
    for st in b.worker_stats:
        assert st["backend"] == "gloo" and st["world"] == 2
        assert st["iterations"] == 4 and st["allreduce_bytes"] > 0
    assert b.final_num_machines == 2


def _workers_left():
    """The pids of this process's live train_distributed workers (their
    script lies in a `lgbtorch_dist*` work directory; other test
    processes run clusters of their own at the same time), or None
    without pgrep."""
    try:
        out = subprocess.run(["pgrep", "-P", str(os.getpid()), "-f",
                              "lgbtorch_dist.*worker.py"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return [int(p) for p in out.stdout.split()]


def test_failed_rank_ends_the_cluster():
    """Rank 1 crashes at iteration 2 (worker_crash@2): rank 0 would wait
    in its next collective; the supervisor kills it and
    train_distributed raises with the failed rank's log, well inside the
    deadline."""
    X, y = _data()
    t0 = time.monotonic()
    with pytest.raises(LightGBMError, match="rank 1 failed"):
        tdist.train_distributed(
            PARAMS, X, y, num_boost_round=6, num_machines=2,
            force_cpu=True, timeout=DEADLINE_S,
            worker_env={"LGBM_TPU_FAULT": "worker_crash@2",
                        "LGBM_TPU_FAULT_RANK": "1"})
    assert time.monotonic() - t0 < DEADLINE_S / 2
    for _ in range(10):
        left = _workers_left()
        if not left:
            break
        time.sleep(0.5)
    assert not left, subprocess.run(
        ["ps", "-o", "pid,stat,args", "-p", ",".join(map(str, left))],
        capture_output=True, text=True).stdout


def test_train_distributed_refuses_retries(tmp_path):
    """The relaunch options once refused run now: rank 1 crashes at
    iteration 2 of the first attempt, the cluster is relaunched from the
    checkpoint in `checkpoint_dir` (every second iteration) and ends
    with the serial model."""
    X, y = _data(1024)
    ck = tmp_path / "ck"
    b = tdist.train_distributed(
        PARAMS, X, y, num_boost_round=4, num_machines=2, force_cpu=True,
        timeout=DEADLINE_S, max_retries=1, checkpoint_dir=str(ck),
        checkpoint_freq=2, retry_backoff=0.01,
        worker_env={"LGBM_TPU_FAULT": "worker_crash@2",
                    "LGBM_TPU_FAULT_RANK": "1"})
    assert b.model_to_string() == _serial_text(PARAMS, X, y, 4)
    assert b.attempts == 2 and b.elastic_shrinks == 0
    assert (ck / "manifest.json").is_file()


@pytest.fixture
def world_one(tmp_path):
    """This process as rank 0 of a one-machine gloo cluster over a
    FileStore; the group is destroyed after the test."""
    tdist.join_cluster(["localhost:0"], rank=0, device_type="cpu",
                       initialize_timeout=60,
                       store_path=str(tmp_path / "store"))
    try:
        yield
    finally:
        tdist.leave_cluster()


def test_join_cluster_world_one_trains_the_serial_model(world_one):
    from lightgbm_tpu_torch.parallel import current_network
    X, y = _data()
    b = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 3)
    net = current_network()
    assert net.world == 1 and net.backend == "gloo"
    assert b._gbdt.shard is not None and b._gbdt.shard.count == len(y)
    tdist.leave_cluster()
    assert b.model_to_string() == _serial_text(PARAMS, X, y, 3)


@pytest.mark.parametrize("extra,what", [
    ({"objective": "lambdarank"}, "ranking objective"),
    ({"objective": "regression_l1"}, "renewal by percentile"),
    ({"objective": "quantile"}, "renewal by percentile"),
    ({"linear_tree": True}, "linear_tree"),
])
def test_sharded_refusals_name_item_15(world_one, extra, what):
    X, y = _data(1024)
    ds = tlgb.Dataset(X, label=y, group=[256] * 4, params={
        "linear_tree": bool(extra.get("linear_tree"))})
    with pytest.raises(NotImplementedError, match=f"{what}.*item 15"):
        tlgb.train({**PARAMS, **extra}, ds, 1)


def test_sharded_checkpoints_refuse(world_one, tmp_path):
    """Checkpoints inside a group (refused once): two iterations with a
    checkpoint each, then a resume to four, give the serial model."""
    X, y = _data(1024)
    ck = str(tmp_path / "ck")
    tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 2, checkpoint_dir=ck,
               checkpoint_freq=1)
    b = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 4, checkpoint_dir=ck,
                   checkpoint_freq=1)
    assert b._gbdt.shard is not None
    tdist.leave_cluster()
    assert b.model_to_string() == _serial_text(PARAMS, X, y, 4)


@pytest.mark.parametrize("learner", ["feature", "voting"])
def test_feature_and_voting_refuse(world_one, learner):
    """In a group: the voting learner shards the rows and keeps the
    ranking refusal; the feature learner keeps every row, so a ranking
    objective trains, the serial model."""
    X, y = _data(1024)
    y = np.floor(y * 2 + X[:, 0] * 2)
    params = {**PARAMS, "objective": "lambdarank", "tree_learner": learner}
    ds = tlgb.Dataset(X, label=y, group=[256] * 4)
    if learner == "voting":
        with pytest.raises(NotImplementedError,
                           match="ranking objective.*voting.*item 15"):
            tlgb.train(params, ds, 1)
        return
    b = tlgb.train(params, ds, 2)
    assert b._gbdt.block is not None and b._gbdt.shard is None
    tdist.leave_cluster()
    want = tlgb.train(params, tlgb.Dataset(X, label=y, group=[256] * 4), 2)
    assert b.model_to_string() == want.model_to_string()


def test_data_without_a_group_trains_on_one_device():
    """tree_learner=data with no process group: the serial trees (the
    JAX package's `_make_training_mesh` on one device)."""
    X, y = _data()
    b = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 3)
    assert b._gbdt.shard is None
    want = _serial_text({**PARAMS, "tree_learner": "serial"}, X, y, 3)
    assert (b.model_to_string().split("\nparameters:")[0]
            == want.split("\nparameters:")[0])


def _free_ports(k):
    socks, ports = [], []
    try:
        for _ in range(k):
            s = socket.socket()
            s.bind(("localhost", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def _run_cli_cluster(tmp_path, X, y, attempt):
    np.savetxt(tmp_path / "train.tsv", np.column_stack([y, X]),
               delimiter="\t", fmt="%.17g")
    ports = _free_ports(2)
    machines = ",".join(f"localhost:{p}" for p in ports)
    procs, logs = [], []
    try:
        for r in range(2):
            env = {**os.environ, "LIGHTGBM_TPU_MACHINE_RANK": str(r)}
            logs.append(open(tmp_path / f"cli{attempt}_{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lightgbm_tpu_torch",
                 f"data={tmp_path / 'train.tsv'}", "num_iterations=3",
                 "objective=binary", "num_leaves=15", "min_data_in_leaf=5",
                 "max_bin=32", "verbosity=-1", "tree_learner=data",
                 "device_type=cpu", "num_machines=2", f"machines={machines}",
                 f"local_listen_port={ports[r]}", "time_out=60",
                 f"output_model={tmp_path / f'model{r}.txt'}"],
                env=env, cwd=ROOT, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DEADLINE_S
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline
               and not any(p.poll() not in (None, 0) for p in procs)):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for lf in logs:
            lf.close()
    return [p.returncode for p in procs]


def test_cli_two_machines_equal_serial(tmp_path):
    """Two CLI workers over a machine list (a free port each; one retry
    if the coordinator's port was taken meanwhile): both models equal
    the serial one's trees."""
    X, y = _data(2048)
    rcs = _run_cli_cluster(tmp_path, X, y, 0)
    if rcs != [0, 0]:
        log = "".join((tmp_path / f"cli0_{r}.log").read_text()
                      for r in range(2))
        if "in use" not in log and "EADDRINUSE" not in log:
            raise AssertionError(f"cli workers exited {rcs}:\n{log[-3000:]}")
        rcs = _run_cli_cluster(tmp_path, X, y, 1)
    assert rcs == [0, 0]
    ds = tlgb.Dataset(str(tmp_path / "train.tsv"))
    want = tlgb.train({**PARAMS, "min_data_in_leaf": 5}, ds, 3)
    want = want.model_to_string().split("\nparameters:")[0]
    for r in range(2):
        got = (tmp_path / f"model{r}.txt").read_text()
        assert got.split("\nparameters:")[0] == want


def test_resolve_rank_and_backend_rule():
    me = socket.gethostname()
    assert tdist.resolve_rank(["10.255.255.1:1", f"{me}:7", "localhost:9"],
                              7) == 1
    assert tdist.resolve_rank(["localhost:5", "localhost:6"], 6) == 1
    with pytest.raises(LightGBMError, match="not in the machine list"):
        tdist.resolve_rank(["10.255.255.1:1"], 1)
    with pytest.raises(LightGBMError, match="Malformed"):
        tdist.resolve_rank(["nohostport"], 1)
    assert backend_for("cpu", 1) == "gloo"
    if not torch.cuda.is_available():
        assert backend_for("cuda", 1) == "gloo"


def test_cluster_backend_agrees_across_uneven_hosts(monkeypatch):
    """One card per host: hostA's two ranks cannot take NCCL, so no rank
    does, hostB's included; with one rank per host every rank takes
    NCCL.  The ranks vote over one store, each in its own thread."""
    import datetime
    import threading

    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for machines, want in ((["hostA.invalid:1", "hostA.invalid:2",
                             "hostB.invalid:3"], "gloo"),
                           (["hostA.invalid:1", "hostB.invalid:2"], "nccl")):
        store = dist.HashStore()
        store.set_timeout(datetime.timedelta(seconds=30))
        got = [None] * len(machines)

        def vote(r):
            got[r] = tdist.cluster_backend(store, machines, r, "cuda")
        threads = [threading.Thread(target=vote, args=(r,))
                   for r in range(len(machines))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert got == [want] * len(machines), (machines, got)


def test_elastic_and_binning_equal_jax():
    from lightgbm_tpu.parallel import binning as jbin
    from lightgbm_tpu.parallel import elastic as jel
    for n, w in ((4096, 3), (4001, 2), (10, 4)):
        for r in range(w):
            assert rows_of(n, w, r) == jel.rows_of(n, w, r)
        assert tuple(reshard_plan(w, 1 + w // 2, n).segments) == tuple(
            tuple(s) for s in jel.reshard_plan(w, 1 + w // 2, n).segments)
    X, _ = _data(3000)
    shards = [sample_rows(X[a:b], 500, seed=1)
              for a, b in (rows_of(3000, 3, r) for r in range(3))]
    mine = merged_bin_mappers(shards, max_bin=32)
    theirs = jbin.merged_bin_mappers(shards, max_bin=32)
    for m, t in zip(mine, theirs):
        assert m.num_bin == t.num_bin
        np.testing.assert_array_equal(m.bin_upper_bound, t.bin_upper_bound)


def test_worker_script_imports_only_the_port():
    """The spawned workers' script imports no jax and nothing of the JAX
    package."""
    import ast
    tree = ast.parse(tdist._WORKER_MAIN)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert "lightgbm_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "lightgbm_tpu"}
