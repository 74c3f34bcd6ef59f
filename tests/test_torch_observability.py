"""PyTorch port: the training telemetry on the CPU, against the JAX
package's.

* The same small run (a validation set, checkpoints every 2 iterations,
  synchronous host I/O) logs the same event types in the same order in
  both packages, and each event the same keys (the iteration event's
  `roofline` included), less the JAX package's `recompile` events
  (eager torch does not recompile).
* Registry counters in a run (trees grown, checkpoint writes), the
  Prometheus page equal to the JAX package's for the same registry
  contents and its parse round trip, `GET /metrics` on an ephemeral
  port, the flight recorder's dump on an exception and on SIGUSR2 (in a
  child process), event-log rotation, the device `predict` event, and a
  `profile_dir` Chrome trace.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.observability import MetricsRegistry as JRegistry
from lightgbm_tpu.observability import render_prometheus as jrender
from lightgbm_tpu_torch.observability import (EventLogger, MetricsRegistry,
                                              flight_recorder,
                                              global_registry,
                                              parse_prometheus_text,
                                              render_prometheus,
                                              sample_device_memory,
                                              set_event_logger,
                                              start_metrics_http,
                                              update_memory_gauges)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "device_type": "cpu",
          "tpu_growth_strategy": "leafwise", "async_host_io": False,
          "metric": ["auc", "binary_logloss"]}


def _data(n=1024, F=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.randn(n) > 0.8)
    return X, y.astype(np.float64)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _run(pkg, tmp_path, tag, n_iter=4, **kw):
    X, y = _data()
    Xv, yv = _data(256, seed=4)
    ds = pkg.Dataset(X, label=y)
    mx = str(tmp_path / f"mx_{tag}")
    b = pkg.train(dict(PARAMS), ds, n_iter,
                  valid_sets=[ds, pkg.Dataset(Xv, label=yv, reference=ds)],
                  checkpoint_dir=str(tmp_path / f"ck_{tag}"),
                  checkpoint_freq=2, metrics_dir=mx, **kw)
    return b, _events(os.path.join(mx, "events-rank0.jsonl"))


def test_event_stream_equals_jax(tmp_path):
    _, jev = _run(jlgb, tmp_path, "jax")
    _, tev = _run(tlgb, tmp_path, "torch")
    jev = [e for e in jev if e["event"] != "recompile"]
    assert [e["event"] for e in tev] == [e["event"] for e in jev]
    # the checkpoint callback (order 40) runs before the event's (50)
    assert [e["event"] for e in tev] == (
        ["train_start", "iteration", "checkpoint", "iteration",
         "iteration", "checkpoint", "iteration", "train_end"])
    for te, je in zip(tev, jev):
        assert set(te) == set(je), te["event"]
    its = [e for e in tev if e["event"] == "iteration"]
    assert [e["iteration"] for e in its] == [1, 2, 3, 4]
    for e in its:
        assert set(e["train"]) == {"auc", "binary_logloss"}
        assert set(e["valid"]) == {"valid_1 auc", "valid_1 binary_logloss"}
        assert any(k.startswith("GBDT::") for k in e["phases"])
        assert e["trees"][0]["leaves"] == 7 and e["trees"][0]["depth"] >= 3
    # the same evaluation numbers in both packages' events
    jits = [e for e in jev if e["event"] == "iteration"]
    for te, je in zip(its, jits):
        for k, v in je["valid"].items():
            assert te["valid"][k] == pytest.approx(v, abs=1e-6)
    assert tev[0]["params"] == jev[0]["params"]


def test_run_counters(tmp_path):
    before = global_registry.snapshot()["counters"]
    b, ev = _run(tlgb, tmp_path, "counters", n_iter=5)
    after = ev[-1]["counters"]
    assert after["trees_grown"] - before.get("trees_grown", 0) == 5
    assert after["checkpoint_writes"] \
        - before.get("checkpoint_writes", 0) == 3      # at 2, 4 and 5
    its = [e for e in ev if e["event"] == "iteration"]
    grown = [e["counters"]["trees_grown"] for e in its]
    assert grown == sorted(grown) and len(set(grown)) == 5


def test_registry_counters_and_gauges():
    r = MetricsRegistry()
    r.inc("a")
    r.inc("a", 2)
    r.set_gauge("g", 1.5)
    r.set_gauge("g", 2.5)
    assert r.counter("a") == 3 and r.gauge("g") == 2.5
    assert r.gauge("missing", 7) == 7
    assert r.snapshot() == r.snapshot_nolock() == {
        "counters": {"a": 3}, "gauges": {"g": 2.5}}
    r.reset()
    assert r.snapshot() == {"counters": {}, "gauges": {}}


@pytest.mark.parametrize("contents", [
    {"counters": {"trees_grown": 13, "checkpoint_writes": 4},
     "gauges": {"device_bytes_in_use": 123456789, "ratio": 0.25}},
    {"counters": {"serve_requests_by_model::higgs": 3,
                  "serve_requests_by_model::a\"b\\c": 1, "x-y.z": 2},
     "gauges": {"big": 3e15, "neg": -1.0}}],
    ids=["plain", "labelled"])
def test_prometheus_page_equals_jax(contents):
    pages = []
    for reg in (MetricsRegistry(), JRegistry()):
        for k, v in contents["counters"].items():
            reg.inc(k, v)
        for k, v in contents["gauges"].items():
            reg.set_gauge(k, v)
        render = render_prometheus if isinstance(reg, MetricsRegistry) \
            else jrender
        pages.append(render(registry=reg))
    assert pages[0] == pages[1]
    parsed = parse_prometheus_text(pages[0])
    n_series = sum(1 for ln in pages[0].splitlines()
                   if ln and not ln.startswith("#"))
    assert len(parsed["counters"]) + len(parsed["gauges"]) == n_series
    for name, v in contents["counters"].items():
        if "::" not in name:
            key = "lgbm_" + name.replace("-", "_").replace(".", "_")
            assert parsed["counters"][key] == v


def test_metrics_http_serves_the_registry():
    r = MetricsRegistry()
    r.inc("trees_grown", 5)
    srv = start_metrics_http(0, registry=r)
    assert srv is not None and srv.port > 0
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            assert resp.status == 200
            page = resp.read().decode()
        assert parse_prometheus_text(page)["counters"][
            "lgbm_trees_grown"] == 5
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/other", timeout=10)
    finally:
        srv.shutdown()


def test_train_metrics_port_serves_during_the_run():
    """`metrics_port=0` serves the global registry while train() runs and
    shuts the listener down with the run."""
    pages = []

    def scrape(env):
        if env.iteration == 1:
            srv = [t for t in threading.enumerate()
                   if t.name == "lgbm-metrics-http"]
            assert srv, "no listener thread during the run"
            # the listener's socket: the only one ThreadingHTTPServer
            # holds, found through the serve_forever thread's target
            server = srv[0]._target.__self__
            port = server.server_address[1]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                pages.append(r.read().decode())
    X, y = _data()
    tlgb.train({**PARAMS, "metrics_port": 0}, tlgb.Dataset(X, label=y), 3,
               callbacks=[scrape])
    assert pages and "lgbm_trees_grown" in pages[0]
    assert not [t for t in threading.enumerate()
                if t.name == "lgbm-metrics-http" and t.is_alive()]


def test_flight_record_dumped_on_exception(tmp_path):
    X, y = _data()

    def boom(env):
        if env.iteration == 2:
            raise RuntimeError("injected callback failure")
    mx = str(tmp_path / "mx")
    with pytest.raises(RuntimeError, match="injected"):
        tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                   metrics_dir=mx, callbacks=[boom])
    rec = json.load(open(os.path.join(mx, "flight-rank0.json")))
    assert rec["kind"] == "flight_record" and rec["reason"] == "crash"
    assert [r["iteration"] for r in rec["iterations"]][-2:] == [1, 2]
    assert "trees_grown" in rec["registry"]["counters"]


def test_flight_record_dumped_on_sigusr2(tmp_path):
    if not hasattr(signal, "SIGUSR2"):
        pytest.skip("no SIGUSR2 on this platform")
    script = tmp_path / "child.py"
    script.write_text(r"""
import os, signal, sys, time
for m in ("jax", "jaxlib", "lightgbm_tpu"):
    sys.modules[m] = None
sys.path.insert(0, os.environ["OBS_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as tlgb
d = os.environ["OBS_DIR"]
rng = np.random.RandomState(3)
X = rng.rand(512, 5)
y = (X[:, 0] > 0.5).astype(np.float64)
def poke(env):
    if env.iteration == 2:
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.2)
b = tlgb.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                "device_type": "cpu"}, tlgb.Dataset(X, label=y), 4,
               metrics_dir=d, callbacks=[poke])
print("OBS_DONE", b.current_iteration(), flush=True)
""")
    env = dict(os.environ, OBS_REPO=REPO, OBS_DIR=str(tmp_path / "mx"))
    env.pop("LGBM_TPU_FAULT", None)
    res = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OBS_DONE 4" in res.stdout       # the dump did not kill it
    rec = json.load(open(tmp_path / "mx" / "flight-rank0.json"))
    assert rec["reason"] == "sigusr2"
    assert [r["iteration"] for r in rec["iterations"]][-2:] == [1, 2]


def test_event_log_rotation(tmp_path):
    lg = EventLogger(str(tmp_path), rank=0, rotate_mb=0.001)   # ~1 KB
    for i in range(60):
        lg.emit("iteration", iteration=i, pad="x" * 40)
    lg.close()
    live = tmp_path / "events-rank0.jsonl"
    rolled = sorted(tmp_path.glob("events-rank0.jsonl.*"))
    assert live.exists() and rolled
    its = []
    for p in list(reversed(rolled)) + [live]:
        its += [json.loads(ln)["iteration"]
                for ln in p.read_text().splitlines()]
    assert its == list(range(60))


def test_record_metrics_needs_a_sink():
    with pytest.raises(ValueError):
        tlgb.record_metrics()


def test_device_predict_event_and_memory_gauges(tmp_path):
    """The device predictor's dispatch logs a `predict` event while an
    EventLogger is installed; the memory sampler is empty on the CPU, as
    the JAX sampler is on its CPU backend."""
    X, y = _data()
    b = tlgb.train(dict(PARAMS, device_predict="true"),
                   tlgb.Dataset(X, label=y), 3)
    lg = EventLogger(str(tmp_path), rank=0)
    set_event_logger(lg)
    try:
        # float32 rows: float64 ones that float32 cannot hold go to the
        # host paths
        b.predict(X[:100].astype(np.float32), raw_score=True)
    finally:
        set_event_logger(None)
        lg.close()
    ev = _events(str(tmp_path / "events-rank0.jsonl"))
    assert [e["event"] for e in ev] == ["predict"]
    assert ev[0]["path"] == "device" and ev[0]["rows"] == 100
    assert ev[0]["trees"] == 3 and ev[0]["mode"] == "raw"
    assert sample_device_memory(torch.device("cpu")) == {}
    assert update_memory_gauges(torch.device("cpu")) == {}


def test_flight_recorder_ring_is_bounded():
    flight_recorder.reset()
    flight_recorder.resize(8)
    try:
        for i in range(20):
            flight_recorder.record_iteration(iteration=i)
        assert [r["iteration"] for r in flight_recorder.tail(100)] \
            == list(range(12, 20))
        flight_recorder.resize(10)
        assert [r["iteration"] for r in flight_recorder.tail(3)] \
            == [17, 18, 19]
    finally:
        flight_recorder.reset()
        flight_recorder.resize(256)


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    X, y = _data()
    pd = tmp_path / "prof"
    b = tlgb.train({**PARAMS, "profile_dir": str(pd)},
                   tlgb.Dataset(X, label=y), 2)
    assert b.current_iteration() == 2
    trace = json.load(open(pd / "trace-rank0.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(str(n).startswith("Tree::") for n in names), sorted(
        str(n) for n in names)[:20]
