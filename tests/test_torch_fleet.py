"""PyTorch port: the replica fleet and its router on the CPU.

* Over the JAX-free stub replicas of `tests/fleet_stub.py` (real
  processes and sockets speaking the serving wire with a linear
  "model"), the port's `ReplicaFleet` and `Router` do what the JAX
  package's do in tests/test_fleet.py: a replica killed mid-load costs
  zero requests (retry, relaunch with backoff), a structured shed
  retries elsewhere, all replicas shedding answer `OverloadedError`
  (on the attempts and at admission), a rolling publish keeps every
  response consistent with its version, a diverging canary rolls back,
  and health gates routing until warmup.
* One real fleet of two `python -m lightgbm_tpu_torch serve` children
  on the CPU (LGBM_TPU_SERVE_FORCE_CPU=1): replica 1 crashes on its
  third request (serve_crash@3) and is relaunched, no client request
  fails, every reply is byte-identical to `Booster.predict` of the
  model, a sampled trace assembles across two processes, and SIGTERM
  drains both replicas to rc 143.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.observability.registry import global_registry
from lightgbm_tpu_torch.serving import (OverloadedError, ReplicaFleet,
                                        Router, serve_counters_reset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "fleet_stub.py")
ROWS = np.arange(12, dtype=np.float64).reshape(3, 4)
SUMS = ROWS.sum(axis=1)


def _stub_fleet(workdir, n=2, max_restarts=2, envs=None):
    fault_envs = {}
    for i in range(n):
        e = {"STUB_READY_FILE": os.path.join(str(workdir),
                                             f"replica-{i}.ready.json")}
        e.update((envs or {}).get(i, {}))
        fault_envs[i] = e
    return ReplicaFleet(n, [("m", "scale1")], str(workdir),
                        max_restarts=max_restarts, health_interval_s=0.1,
                        spawn_cmd=lambda idx, rf: [sys.executable, STUB],
                        fault_envs=fault_envs)


def _router(fleet, **overrides):
    p = {"serve_retry_max": 3, "serve_retry_backoff_ms": 5.0,
         "serve_request_timeout_s": 15.0, "serve_canary_pct": 50.0,
         "serve_canary_min_samples": 12,
         "serve_canary_max_divergence": 2.0,
         "serve_canary_max_error_rate": 0.25}
    p.update(overrides)
    return Router(fleet, Config(p))


@pytest.fixture(autouse=True)
def _reset_counters():
    serve_counters_reset()
    for key in ("router_requests", "router_rows", "router_retries",
                "router_failed", "serve_replica_down",
                "serve_replica_restarts"):
        global_registry.inc(key, -global_registry.counter(key))
    yield


def _load(router, threads, n, check, deadline_ms=10_000):
    """`threads` clients of `n` requests each; returns the failures."""
    failures, lock = [], threading.Lock()

    def client():
        for _ in range(n):
            try:
                check(router.predict("m", ROWS, deadline_ms=deadline_ms))
            except Exception as e:  # noqa: BLE001
                with lock:
                    failures.append(repr(e))

    ts = [threading.Thread(target=client) for _ in range(threads)]
    for t in ts:
        t.start()
    return ts, failures


# ------------------------------------------------------------ stub replicas
def test_replica_kill_costs_zero_requests(tmp_path):
    fleet = _stub_fleet(tmp_path, n=3).start()
    try:
        assert fleet.wait_ready(timeout=20)
        router = _router(fleet)
        done, gate = [0], threading.Event()

        def check(r):
            np.testing.assert_allclose(r.preds, SUMS)
            done[0] += 1
            if done[0] >= 20:
                gate.set()

        ts, failures = _load(router, 4, 40, check)
        assert gate.wait(timeout=30)
        fleet.replicas[0].proc.kill()          # hard kill, mid-load
        for t in ts:
            t.join(timeout=60)
        assert not failures, failures[:3]
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            d = fleet.describe()[0]
            if d["restarts"] == 1 and d["healthy"] and d["ready"]:
                break
            time.sleep(0.05)
        d = fleet.describe()[0]
        assert d["restarts"] == 1 and d["gen"] == 2 and d["healthy"]
        assert global_registry.counter("serve_replica_restarts") == 1
    finally:
        fleet.stop(drain=False)


def test_shed_retries_elsewhere_and_all_shedding_is_overloaded(tmp_path):
    fleet = _stub_fleet(tmp_path, envs={0: {"STUB_SHED": "1"}}).start()
    try:
        assert fleet.wait_ready(timeout=20)
        router = _router(fleet)
        for _ in range(10):
            r = router.predict("m", ROWS, deadline_ms=10_000)
            assert np.allclose(r.preds, SUMS) and r.replica == 1
        assert global_registry.counter("router_retries") > 0
        assert router.stats()["router_failed"] == 0
    finally:
        fleet.stop(drain=False)
    for env, match in (({"STUB_SHED": "1"}, "shed"),
                       ({"STUB_SHED_HEALTH": "1"}, "routable replicas")):
        serve_counters_reset()
        fleet = _stub_fleet(tmp_path / match.replace(" ", "_"),
                            envs={0: env, 1: env}).start()
        try:
            assert fleet.wait_ready(timeout=20)
            with pytest.raises(OverloadedError, match=match):
                _router(fleet).predict("m", ROWS, deadline_ms=10_000)
            assert global_registry.counter("serve_overloaded") == 1
        finally:
            fleet.stop(drain=False)


def test_rolling_publish_and_canary_rollback(tmp_path):
    fleet = _stub_fleet(tmp_path, n=3).start()
    try:
        assert fleet.wait_ready(timeout=20)
        router = _router(fleet)
        router.register_incumbent("m", "scale1")
        mismatches = []

        def check(r):
            exp = SUMS if r.version == 1 else SUMS * 3
            if not np.allclose(r.preds, exp):
                mismatches.append((r.version, list(r.preds)))

        ts, failures = _load(router, 4, 30, check)
        out = router.publish("m", "v2_scale3", canary_pct=0)
        for t in ts:
            t.join(timeout=60)
        assert out == {"canary": False, "replicas": {0: 2, 1: 2, 2: 2}}
        assert not failures and not mismatches
        assert dict(fleet.model_entries)["m"] == "v2_scale3"
        # a canary whose scores diverge rolls back, with no errors
        out = router.publish("m", "bad_scale100")
        assert out["canary"] is True
        ts, failures = _load(router, 3, 200, lambda r: None)
        verdict = router.canary_wait("m", timeout=60)
        for t in ts:
            t.join(timeout=60)
        assert verdict == "rolled_back" and not failures
        assert global_registry.counter("serve_rollback") >= 1
        assert router.stats()["canaries"]["m"]["resolved"] == "rolled_back"
    finally:
        fleet.stop(drain=False)


def test_health_gates_routing_until_warmup(tmp_path):
    fleet = _stub_fleet(tmp_path, n=1,
                        envs={0: {"STUB_WARMUP_S": "1.0"}}).start()
    try:
        deadline = time.monotonic() + 0.7
        while time.monotonic() < deadline:
            assert fleet.endpoints() == []
            time.sleep(0.1)
        assert fleet.wait_ready(timeout=20)
        assert len(fleet.endpoints()) == 1
    finally:
        fleet.stop(drain=False)


# ------------------------------------------------------------- real replicas
def test_real_cpu_fleet_crash_relaunch_and_sigterm_drain(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(800, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    b = tlgb.train({"objective": "binary", "num_leaves": 15, "verbose": -1,
                    "device_type": "cpu"}, tlgb.Dataset(X, label=y), 5)
    model = tmp_path / "model.txt"
    b.save_model(str(model))
    oracle = tlgb.Booster(model_file=str(model), params={
        "device_type": "cpu", "device_predict": "true"})
    fleet = ReplicaFleet(
        2, [("m", str(model))], str(tmp_path / "fleet"),
        params={"device_predict_min_bucket": 64,
                "serve_max_batch_rows": 256, "verbosity": -1},
        max_restarts=2, health_interval_s=0.2, force_cpu=True,
        fault_envs={1: {"LGBM_TPU_FAULT": "serve_crash@3"}}).start()
    rcs = None
    try:
        assert fleet.wait_ready(timeout=120), fleet.describe()
        router = _router(fleet, serve_trace_sample=5,
                         serve_request_timeout_s=30.0)
        bad, lock = [], threading.Lock()

        def client(tid):
            for i in range(15):
                lo = (tid * 50 + i * 7) % 780
                rows = X[lo:lo + 4]
                try:
                    r = router.predict("m", rows, deadline_ms=30_000)
                    got = np.asarray(r.preds).astype(np.float32)
                    if got.tobytes() != oracle.predict(rows).tobytes():
                        raise AssertionError(f"rows {lo} differ")
                except Exception as e:  # noqa: BLE001
                    with lock:
                        bad.append(repr(e))

        ts = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=180)
        assert not bad, bad[:3]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            d = fleet.describe()[1]
            if d["restarts"] == 1 and d["healthy"] and d["ready"]:
                break
            time.sleep(0.1)
        d = fleet.describe()[1]
        assert d["restarts"] == 1 and d["healthy"], d
        traces = router.assembler.traces()
        assert any(len(t["processes"]) >= 2 for t in traces), traces[:1]
    finally:
        rcs = fleet.stop(drain=True, timeout=60.0)
    assert sorted(rcs) == [0, 1]
    assert all(rc in (143, -15) for rc in rcs.values()), rcs
