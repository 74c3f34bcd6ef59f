"""PyTorch port: the stall watchdog, the degradation ladder, SIGTERM and
preemption on the CPU, held to the JAX package's `tests/test_guard.py`.

`RunGuard` trips on a missing heartbeat and writes a parseable stall
diagnosis (its device snapshot from `torch.cuda.memory_stats()` in place
of the JAX live-array census); the ladder is the JAX package's, order and
values, and `degrade-state.json` crosses between the packages.  In child
processes (signal handlers install only on a main thread): an injected
hang exits with the stall code and a relaunch with `auto_degrade` resumes
to the model of a clean run with the degraded knob set; SIGTERM drains
the async event log; a preemption checkpoint resumes byte-identically.
Each child blocks JAX, pins `device_type=cpu` and one torch thread; the
bounds are the JAX tests' (SUBPROC_BUDGET_S, stall_floor_s 1.0,
stall_factor 3.0).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu.reliability.guard as jguard
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.reliability.guard import (DEGRADE_LADDER,
                                                  STALL_EXIT_CODE, RunGuard,
                                                  apply_auto_degrade,
                                                  classify_returncode,
                                                  degraded_knobs,
                                                  disabled_value,
                                                  knob_enabled,
                                                  next_degradation)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# wall-clock bound for each child (imports, a few rounds and the ~3 s
# stall deadline; a real runaway blows far past it)
SUBPROC_BUDGET_S = 240.0

# the head of every child: JAX blocked, the CPU, one torch thread
_CHILD_HEAD = r"""
import os, sys
for m in ("jax", "jaxlib", "lightgbm_tpu"):
    sys.modules[m] = None
sys.path.insert(0, os.environ["GUARD_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as tlgb
"""


# ------------------------------------------------------- RunGuard units
def test_watchdog_trips_and_writes_parseable_diagnosis(tmp_path):
    hits = []
    g = RunGuard(str(tmp_path), rank=3, stall_floor_s=0.2, stall_factor=2.0,
                 first_deadline_s=0.3, knobs={"tpu_donate_buffers": True},
                 on_stall=hits.append, poll_interval=0.05,
                 device=torch.device("cpu"))
    g.start()
    try:
        deadline = time.monotonic() + 10.0
        while not g.tripped and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        g.stop()
    assert g.tripped and len(hits) == 1
    diag = json.load(open(tmp_path / "stall-rank3.json"))
    for key in ("kind", "rank", "silent_s", "deadline_s", "last_iteration",
                "knobs", "stacks", "device", "flight", "exit_code"):
        assert key in diag, f"diagnosis missing {key}"
    assert diag["kind"] == "stall" and diag["rank"] == 3
    assert diag["exit_code"] == STALL_EXIT_CODE
    assert diag["knobs"]["tpu_donate_buffers"] is True
    assert diag["device"] == {"device": "cpu"}
    assert any("File" in line for line in diag["stacks"])
    # the flight record lands beside the diagnosis
    assert (tmp_path / "flight-rank3.json").exists()


def test_first_deadline_then_median_takes_over(tmp_path):
    g = RunGuard(str(tmp_path), stall_floor_s=1.0, stall_factor=2.0,
                 first_deadline_s=50.0)
    assert g.current_deadline_s() == 50.0
    g._started_at = time.monotonic()
    g.tick(1)
    # one tick but no duration sample yet: still the first deadline
    assert g.current_deadline_s() == 50.0
    g.tick(2)
    assert g.median_iter_s() is not None
    assert g.current_deadline_s() == pytest.approx(
        max(1.0, 2.0 * g.median_iter_s()))
    assert g.current_deadline_s() < 50.0


def test_default_first_deadline_scales_with_floor(tmp_path):
    assert RunGuard(str(tmp_path),
                    stall_floor_s=120.0).first_deadline_s == 1200.0
    assert RunGuard(str(tmp_path),
                    stall_floor_s=2.0).first_deadline_s == 600.0


def test_slow_iteration_under_deadline_does_not_trip(tmp_path):
    g = RunGuard(str(tmp_path), stall_floor_s=1.0, stall_factor=20.0,
                 first_deadline_s=30.0, on_stall=lambda d: None,
                 poll_interval=0.05)
    g.start()
    try:
        for i in range(1, 5):
            time.sleep(0.05)
            g.tick(i)
        time.sleep(0.5)  # slow_iter-shaped pause, under the 1 s floor
        g.tick(5)
    finally:
        g.stop()
    assert not g.tripped


def test_tick_touches_heartbeat_file(tmp_path):
    hb = tmp_path / "heartbeat-rank0"
    g = RunGuard(str(tmp_path), stall_floor_s=60.0, heartbeat_path=str(hb))
    g._started_at = time.monotonic()
    g.tick(1)
    assert hb.exists()
    first = hb.stat().st_mtime
    time.sleep(0.05)
    g.tick(2)
    assert hb.stat().st_mtime >= first


# ------------------------------------------------ classification, ladder
@pytest.mark.parametrize("rc", [0, STALL_EXIT_CODE, None, 124, 143, -15,
                                17, 77, 1])
def test_classify_returncode_equals_jax(rc):
    assert classify_returncode(rc) == jguard.classify_returncode(rc)


def test_degradation_ladder_equals_jax():
    """The JAX package's order and values, so degrade-state.json crosses
    between the packages (in the port the first two rungs change
    nothing: ROADMAP Queue 3)."""
    assert DEGRADE_LADDER == jguard.DEGRADE_LADDER
    assert [k for k, _ in DEGRADE_LADDER] == [
        "tpu_donate_buffers", "compile_cache_dir", "async_host_io",
        "device_eval"]
    enabled = {"tpu_donate_buffers": True, "compile_cache_dir": "/c",
               "async_host_io": True, "device_eval": "auto"}
    order, done = [], []
    while True:
        k = next_degradation(enabled, done)
        if k is None:
            break
        order.append(k)
        done.append(k)
    assert order == [k for k, _ in DEGRADE_LADDER]
    assert next_degradation({**enabled, "tpu_donate_buffers": False},
                            []) == "compile_cache_dir"
    assert disabled_value("device_eval") == "false"
    assert knob_enabled("device_eval", "auto")
    assert not knob_enabled("compile_cache_dir", "  ")


def _stall_once(mdir, cfg):
    """A watchdog trip's file with cfg's effective knobs."""
    with open(os.path.join(mdir, "stall-rank0.json"), "w") as f:
        json.dump({"kind": "stall", "last_iteration": 3,
                   "knobs": {k: getattr(cfg, k) for k, _ in DEGRADE_LADDER}},
                  f)


def test_apply_auto_degrade_walks_the_ladder(tmp_path):
    mdir = str(tmp_path)
    params = {"compile_cache_dir": "/tmp/cache"}
    seen = []
    for expect in ("tpu_donate_buffers", "compile_cache_dir",
                   "async_host_io", "device_eval"):
        cfg = Config(dict(params))
        apply_auto_degrade(cfg, params, mdir)
        _stall_once(mdir, cfg)
        cfg = Config(dict(params))
        out = apply_auto_degrade(cfg, params, mdir)
        assert out["new"] == [expect]
        seen.append(expect)
        assert out["applied"] == seen
        assert not knob_enabled(expect, getattr(cfg, expect))
    _stall_once(mdir, Config(dict(params)))
    out = apply_auto_degrade(Config(dict(params)), params, mdir)
    assert out["new"] == [] and out["applied"] == seen
    assert not os.path.exists(os.path.join(mdir, "stall-rank0.json"))
    assert len([p for p in os.listdir(mdir) if ".handled-" in p]) == 5


def test_degrade_state_crosses_between_packages(tmp_path):
    """Two stalls degraded by the JAX package, the third by the port: the
    port continues the JAX walk from its degrade-state.json."""
    mdir = str(tmp_path)
    params = {"compile_cache_dir": "/tmp/cache"}
    for _ in range(2):
        _stall_once(mdir, JConfig(dict(params)))
        jguard.apply_auto_degrade(JConfig(dict(params)), params, mdir)
    assert degraded_knobs(mdir) == ["tpu_donate_buffers",
                                    "compile_cache_dir"]
    cfg = Config(dict(params))
    _stall_once(mdir, cfg)
    out = apply_auto_degrade(cfg, params, mdir)
    assert out["new"] == ["async_host_io"]
    assert cfg.async_host_io is False and cfg.compile_cache_dir == ""
    assert jguard.degraded_knobs(mdir) == out["applied"]


# -------------------------------------------- hang -> 86 -> degraded resume
_HANG_CHILD = _CHILD_HEAD + r"""
d = os.environ["GUARD_DIR"]
rng = np.random.RandomState(5)
X = rng.rand(512, 5)
y = (3 * (X[:, 0] - 0.5) + X[:, 1] * X[:, 2]).astype(np.float64)
params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "device_type": "cpu"}
if os.environ.get("GUARD_MODE") == "clean":
    # the uninterrupted run, with the knob the ladder disables already off
    params["tpu_donate_buffers"] = False
else:
    params.update({"metrics_dir": os.path.join(d, "metrics"),
                   "checkpoint_dir": os.path.join(d, "ckpt"),
                   "checkpoint_freq": 1, "auto_degrade": True,
                   "stall_floor_s": 1.0, "stall_factor": 3.0})
b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=6)
txt = b.model_to_string(num_iteration=-1).split("\nparameters:")[0]
with open(os.path.join(d, os.environ["GUARD_MODEL"]), "w") as f:
    f.write(txt)
print("GUARD_DONE", b.current_iteration(), flush=True)
"""


def _run_child(tmp_path, script, env_extra, fault=""):
    env = dict(os.environ)
    env.update({"GUARD_REPO": REPO, "GUARD_DIR": str(tmp_path),
                **env_extra})
    env.pop("LGBM_TPU_FAULT", None)
    if fault:
        env["LGBM_TPU_FAULT"] = fault
    t0 = time.monotonic()
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True,
                         timeout=SUBPROC_BUDGET_S)
    assert time.monotonic() - t0 < SUBPROC_BUDGET_S
    return res


def test_injected_hang_diagnosed_then_degraded_resume(tmp_path):
    """hang@3 trips the watchdog (exit 86, a parseable stall-rank0.json);
    the auto_degrade relaunch resumes from the checkpoint with one ladder
    knob disabled, logs one `degrade` event, and trains the model of an
    uninterrupted run with that knob off, byte for byte."""
    script = tmp_path / "child.py"
    script.write_text(_HANG_CHILD)
    fault = "hang@3@0"
    r0 = _run_child(tmp_path, script, {"GUARD_MODE": "guard",
                                       "GUARD_MODEL": "a0.txt",
                                       "LGBM_TPU_FAULT_ATTEMPT": "0"}, fault)
    assert r0.returncode == STALL_EXIT_CODE, r0.stdout + r0.stderr
    assert classify_returncode(r0.returncode) == "hang"
    spath = tmp_path / "metrics" / "stall-rank0.json"
    diag = json.load(open(spath))
    assert diag["last_iteration"] == 3
    assert diag["knobs"]["tpu_donate_buffers"] is True
    assert diag["knobs"]["device"] == "cpu"
    assert any("File" in line for line in diag["stacks"])
    assert diag["last_event"] is not None
    assert [r["iteration"] for r in diag["flight"]] == [1, 2, 3]

    r1 = _run_child(tmp_path, script, {"GUARD_MODE": "guard",
                                       "GUARD_MODEL": "deg.txt",
                                       "LGBM_TPU_FAULT_ATTEMPT": "1"}, fault)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    assert "GUARD_DONE 6" in r1.stdout
    state = json.load(open(tmp_path / "metrics" / "degrade-state.json"))
    assert state["degraded_knobs"] == ["tpu_donate_buffers"]
    assert not spath.exists(), "the stall file must be consumed"
    events = [json.loads(ln) for ln in
              (tmp_path / "metrics" / "events-rank0.jsonl")
              .read_text().splitlines()]
    degrades = [e for e in events if e["event"] == "degrade"]
    assert len(degrades) == 1
    assert degrades[0]["knobs"] == ["tpu_donate_buffers"]
    assert events[-1]["event"] == "train_end"

    r2 = _run_child(tmp_path, script, {"GUARD_MODE": "clean",
                                       "GUARD_MODEL": "clean.txt",
                                       "LGBM_TPU_FAULT_ATTEMPT": "2"})
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert (tmp_path / "deg.txt").read_bytes() == \
        (tmp_path / "clean.txt").read_bytes()


# ------------------------------------------------------ SIGTERM, preempt
@pytest.mark.skipif(not hasattr(signal, "SIGTERM"), reason="no SIGTERM")
def test_sigterm_flushes_async_event_log(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD_HEAD + r"""
import signal, time
from lightgbm_tpu_torch.observability import (AsyncWriter, EventLogger,
                                              install_sigterm_flush,
                                              set_event_logger)
w = AsyncWriter()
lg = EventLogger(os.environ["GUARD_DIR"], rank=0, writer=w)
set_event_logger(lg)
assert install_sigterm_flush()
for i in range(200):
    lg.emit("iteration", iteration=i)
os.kill(os.getpid(), signal.SIGTERM)
time.sleep(30)  # never reached: the handler re-raises SIGTERM
""")
    res = _run_child(tmp_path, script, {})
    assert res.returncode in (-signal.SIGTERM, 128 + signal.SIGTERM), \
        f"rc={res.returncode}\n{res.stderr}"
    assert classify_returncode(res.returncode) == "preempt"
    lines = [json.loads(ln) for ln in
             (tmp_path / "events-rank0.jsonl").read_text().splitlines()]
    its = [r["iteration"] for r in lines if r["event"] == "iteration"]
    assert its == list(range(200)), "queued events were dropped on SIGTERM"
    assert lines[-1]["event"] == "sigterm"


_PREEMPT_CHILD = _CHILD_HEAD + r"""
import time
d = os.environ["GUARD_DIR"]
rng = np.random.RandomState(7)
X = rng.rand(800, 5)
y = X[:, 0] * 2 + X[:, 1] ** 2 + 0.1 * rng.randn(800)
params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "device_type": "cpu"}
def slow(env):
    time.sleep(0.25)  # keep the run alive long enough to be preempted
b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=40,
               checkpoint_dir=os.path.join(d, "ckpt"),
               checkpoint_freq=0,  # the ONLY checkpoint is the preempt one
               metrics_dir=os.path.join(d, "metrics"), callbacks=[slow])
print("PREEMPT_CHILD_FINISHED", b.current_iteration(), flush=True)
"""


def _events(path):
    try:
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    except (OSError, ValueError):
        return []


def test_preemption_checkpoint_resumes_byte_identical(tmp_path):
    """SIGTERM mid-run: the handler checkpoints within the grace budget
    (no periodic checkpoints at all), the exit classifies as preempt,
    and resuming reproduces the uninterrupted run byte for byte."""
    script = tmp_path / "child.py"
    script.write_text(_PREEMPT_CHILD)
    env = dict(os.environ, GUARD_DIR=str(tmp_path), GUARD_REPO=REPO)
    env.pop("LGBM_TPU_FAULT", None)
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    ev_path = str(tmp_path / "metrics" / "events-rank0.jsonl")
    deadline = time.monotonic() + SUBPROC_BUDGET_S
    preempt_at = None
    try:
        while time.monotonic() < deadline:
            its = [e["iteration"] for e in _events(ev_path)
                   if e["event"] == "iteration"]
            if its and max(its) >= 3:
                preempt_at = max(its)
                break
            time.sleep(0.2)
        assert preempt_at is not None, "child never reached iteration 3"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "PREEMPT_CHILD_FINISHED" not in out
    assert classify_returncode(proc.returncode) == "preempt", \
        f"rc={proc.returncode}\n{out[-2000:]}"
    evs = _events(ev_path)
    pre = [e for e in evs if e["event"] == "preempt"]
    assert len(pre) == 1 and pre[0]["saved"] is True
    assert pre[0]["elapsed_s"] <= pre[0]["grace_s"]
    saved_it = pre[0]["iteration"]
    assert saved_it >= 3
    assert evs[-1]["event"] == "sigterm"
    m = json.load(open(tmp_path / "ckpt" / "manifest.json"))
    assert m["iteration"] == saved_it and m["digests"]

    rng = np.random.RandomState(7)
    X = rng.rand(800, 5)
    y = X[:, 0] * 2 + X[:, 1] ** 2 + 0.1 * rng.randn(800)
    params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
              "min_data_in_leaf": 5, "device_type": "cpu"}
    full = tlgb.train(dict(params), tlgb.Dataset(X, label=y), saved_it + 3)
    resumed = tlgb.train(dict(params), tlgb.Dataset(X, label=y),
                         saved_it + 3, checkpoint_dir=str(tmp_path / "ckpt"))
    assert resumed.model_to_string(num_iteration=-1) \
        == full.model_to_string(num_iteration=-1)


def test_register_stack_dump_signal():
    from lightgbm_tpu_torch.reliability import faults
    if not hasattr(signal, "SIGUSR1"):
        pytest.skip("no SIGUSR1 on this platform")
    assert faults.register_stack_dump_signal()
