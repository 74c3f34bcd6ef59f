"""PyTorch port: `train_distributed`'s elastic relaunch with checkpoints
under data-parallel training, on the CPU.

* `ElasticPolicy` and `plan_for_shrink` (reliability/elastic.py, the
  port's own copy) give the JAX package's decisions on the same
  `SuperviseResult` sequences (tests/test_elastic.py's cases).
* A group's checkpoint holds the serial run's state: a world-2
  checkpoint resumes serially and at world 3 to the serial model text,
  a serial checkpoint at world 2 (quantized gradients, bagging every
  second iteration and 4,001 rows, so the padding's scores, the bag mask
  and the fixed-point maxima all ride the checkpoint).
* `worker_crash@2` with `max_retries=1` relaunches at the same world and
  ends with the serial model text; `worker_lost@2` at world 3 shrinks to
  2 ranks, which re-derive their rows from the checkpoint's row count,
  and ends with the serial model text (`elastic_shrinks == 1`,
  `final_num_machines == 2`, the supervisor's `elastic_shrink` event);
  the `elastic_min_machines` floor gives up and raises; a tombstoned
  rank refuses a relaunch at its world and joins a smaller one.

`retry_backoff` is small, so no test sleeps.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import distributed as tdist
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 120
PARAMS = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
          "max_bin": 32, "verbosity": -1, "tree_learner": "data",
          "device_type": "cpu", "use_quantized_grad": True,
          "bagging_fraction": 0.7, "bagging_freq": 2}


def _data(n=4001, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 6)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit))).astype(np.float64)
    return X, y


_SERIAL = {}


def _serial_text(rounds):
    if rounds not in _SERIAL:
        X, y = _data()
        _SERIAL[rounds] = tlgb.train(PARAMS, tlgb.Dataset(X, label=y),
                                     rounds).model_to_string()
    return _SERIAL[rounds]


def _cluster(rounds, world, **kw):
    X, y = _data()
    return tdist.train_distributed(PARAMS, X, y, num_boost_round=rounds,
                                   num_machines=world, force_cpu=True,
                                   timeout=DEADLINE_S, retry_backoff=0.01,
                                   **kw)


# ------------------------------------------------ the policy against JAX
def _sequences():
    """(world, min_machines, grace, [(clock, [(rank, kind, rc)])]) of
    tests/test_elastic.py's policy cases."""
    return {
        "lost": (8, 1, 3600, [(0, [(3, "lost", 77)])]),
        "crash_streak": (4, 1, 10.0, [(0, [(2, "crash", 1)]),
                                      (5, [(2, "crash", 1)]),
                                      (12, [(2, "hang", None)])]),
        "alternating_preempt": (4, 1, 0.0, [
            (0, [(0, "crash", 1)]), (100, [(1, "crash", 1)]),
            (200, [(0, "crash", 1)]), (300, [(1, "crash", 1)]),
            (400, [(2, "preempt", -15)]), (500, [(2, "preempt", -15)])]),
        "floor": (2, 2, 0.0, [(0, [(1, "lost", 77)])]),
        "two_lost_then_crash": (5, 1, 0.0, [
            (0, [(1, "lost", 77), (3, "lost", 77)]),
            (1, [(0, "crash", 1)]), (2, [(0, "crash", 1)])]),
    }


@pytest.mark.parametrize("name", list(_sequences()))
def test_policy_decisions_equal_jax(name):
    from lightgbm_tpu.reliability import elastic as jel
    from lightgbm_tpu.reliability import supervisor as jsup
    from lightgbm_tpu_torch.reliability import elastic as tel
    from lightgbm_tpu_torch.reliability import supervisor as tsup
    world, floor, grace, steps = _sequences()[name]
    decisions = []
    for el, sup in ((jel, jsup), (tel, tsup)):
        now = [0.0]
        pol = el.ElasticPolicy(world, min_machines=floor, rank_grace_s=grace,
                               clock=lambda: now[0])
        out = []
        for t, fails in steps:
            now[0] = t
            res = sup.SuperviseResult(ok=False, timed_out=False, failures=[
                sup.WorkerFailure(r, rc, "", kind=k) for r, k, rc in fails])
            d = pol.observe(res)
            out.append((d.action, d.num_machines, d.lost_ranks, d.reason,
                        pol.num_machines, pol.shrinks))
        decisions.append(out)
    assert decisions[0] == decisions[1]
    assert tel.RETRY == jel.RETRY and tel.SHRINK == jel.SHRINK
    assert tel.GIVE_UP == jel.GIVE_UP


@pytest.mark.parametrize("old_n,new_n,rows", [(8, 7, 1000), (3, 2, 4001),
                                              (2, 1, 17), (4, 2, None)])
def test_plan_for_shrink_equals_jax(old_n, new_n, rows):
    from lightgbm_tpu.reliability.elastic import plan_for_shrink as jplan
    from lightgbm_tpu_torch.reliability import plan_for_shrink
    a, b = jplan(old_n, new_n, rows), plan_for_shrink(old_n, new_n, rows)
    if rows is None:
        assert a is None and b is None
        return
    assert tuple(a.segments) == tuple(b.segments)
    assert a.summary() == b.summary()


# ---------------------------------- a group's checkpoint, any world size
@pytest.fixture(scope="module")
def world2_ckpt(tmp_path_factory):
    """A world-2 cluster's checkpoints after 3 of 5 iterations."""
    ck = str(tmp_path_factory.mktemp("w2") / "ck")
    _cluster(3, 2, checkpoint_dir=ck, checkpoint_freq=1)
    with open(os.path.join(ck, "manifest.json")) as f:
        assert json.load(f)["num_rows"] == 4001
    return ck


def test_world2_checkpoint_resumes_serially(world2_ckpt, tmp_path):
    ck = str(tmp_path / "ck")
    shutil.copytree(world2_ckpt, ck)
    X, y = _data()
    b = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 5, checkpoint_dir=ck)
    assert b.model_to_string() == _serial_text(5)


def test_world2_checkpoint_resumes_at_world3(world2_ckpt, tmp_path):
    ck = str(tmp_path / "ck")
    shutil.copytree(world2_ckpt, ck)
    b = _cluster(5, 3, checkpoint_dir=ck, checkpoint_freq=1)
    assert b.model_to_string() == _serial_text(5)
    # every rank of the relaunch ends at the fifth iteration
    assert all(st["iterations"] == 5 for st in b.worker_stats)


def test_serial_checkpoint_resumes_at_world2(tmp_path):
    ck = str(tmp_path / "ck")
    X, y = _data()
    tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 3, checkpoint_dir=ck,
               checkpoint_freq=1)
    b = _cluster(5, 2, checkpoint_dir=ck, checkpoint_freq=1)
    assert b.model_to_string() == _serial_text(5)


# ------------------------------------------------------------ the drills
def test_crashed_rank_retries_at_the_same_world():
    b = _cluster(5, 2, max_retries=1,
                 worker_env={"LGBM_TPU_FAULT": "worker_crash@2",
                             "LGBM_TPU_FAULT_RANK": "1"})
    assert b.model_to_string() == _serial_text(5)
    assert b.attempts == 2 and b.elastic_shrinks == 0
    assert b.final_num_machines == 2
    assert [st["attempt"] for st in b.worker_stats] == [1, 1]


def test_lost_rank_shrinks_the_cluster(tmp_path):
    md = str(tmp_path / "metrics")
    X, y = _data()
    b = tdist.train_distributed(
        {**PARAMS, "metrics_dir": md}, X, y, num_boost_round=5,
        num_machines=3, force_cpu=True, timeout=DEADLINE_S, max_retries=1,
        retry_backoff=0.01,
        worker_env={"LGBM_TPU_FAULT": "worker_lost@2",
                    "LGBM_TPU_FAULT_RANK": "1"})
    want = _serial_text(5).split("\nparameters:")[0]
    assert b.model_to_string().split("\nparameters:")[0] == want
    assert b.elastic_shrinks == 1 and b.final_num_machines == 2
    assert [st["world"] for st in b.worker_stats] == [2, 2]
    with open(os.path.join(md, "events-ranksupervisor.jsonl")) as f:
        events = [json.loads(ln) for ln in f if ln.strip()]
    shrink = [e for e in events if e.get("event") == "elastic_shrink"]
    assert len(shrink) == 1
    assert shrink[0]["old_num_machines"] == 3
    assert shrink[0]["new_num_machines"] == 2
    assert shrink[0]["lost_ranks"] == [1]
    assert shrink[0]["reshard"]["num_rows"] == 4001


def test_min_machines_floor_gives_up():
    X, y = _data(1024)
    with pytest.raises(LightGBMError, match="cannot continue"):
        tdist.train_distributed(
            {**PARAMS, "elastic_min_machines": 2}, X, y, num_boost_round=4,
            num_machines=2, force_cpu=True, timeout=DEADLINE_S,
            max_retries=2, retry_backoff=0.01,
            worker_env={"LGBM_TPU_FAULT": "worker_lost@1",
                        "LGBM_TPU_FAULT_RANK": "1"})


def test_tombstoned_rank_refuses_a_same_world_relaunch(tmp_path):
    """The worker script's gate: rank 1 of 2 tombstoned exits 77 before
    it joins; the same rank number of a world of 1 (a shrink) passes."""
    from lightgbm_tpu_torch.reliability import faults
    faults.write_tombstone(str(tmp_path), 1, 2, "drill")
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from lightgbm_tpu_torch.reliability import faults\n"
            "faults.check_tombstone()\n"
            "print('joined')\n")
    rcs = []
    for rank, world in ((1, 2), (0, 1)):
        env = {**os.environ, "LGBM_TPU_TOMBSTONE_DIR": str(tmp_path),
               "LGBM_TPU_FAULT_SELF_RANK": str(rank),
               "LGBM_TPU_WORLD_SIZE": str(world)}
        r = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                           capture_output=True, text=True, timeout=60)
        rcs.append(r.returncode)
    assert rcs == [faults.WORKER_LOST_EXIT_CODE, 0]
