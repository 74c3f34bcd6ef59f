"""PyTorch port: the serving daemon on the CPU, against the JAX package's.

* One model text (trained by the JAX package) served by both daemons:
  leaf ids equal, raw scores within 2·T·2^-24·Σ_t|leaf value| of each
  row's leaves (PERF.md §2's predict bound).
* Byte identity: every response equals the port's `Booster.predict`
  (device_predict=true, the same traversal on the CPU) of the version
  that served it, across a hot swap under 8 client threads; the same
  rows give the same bits in buckets 64 and 4096 and beside any
  batch-mates.
* The daemon's contracts: zero programs first run after warmup, queue
  full sheds fast, the serve_shed / serve_slow faults, a drain whose
  deadline abandons requests says so, the TCP and UDS front ends with
  the TCP client's deadline and reconnect, `stats()` keys and the
  Prometheus families equal to the JAX daemon's, sampled traces, and
  `LatencyWindow` percentiles equal to the JAX package's.
"""

import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.observability import render_prometheus as jrender
from lightgbm_tpu.observability.registry import LatencyWindow as JWindow
from lightgbm_tpu.serving import ServingDaemon as JDaemon
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.inference import DevicePredictor
from lightgbm_tpu_torch.observability import render_prometheus
from lightgbm_tpu_torch.observability.flightrec import flight_recorder
from lightgbm_tpu_torch.observability.registry import (LatencyWindow,
                                                       global_registry)
from lightgbm_tpu_torch.reliability import faults
from lightgbm_tpu_torch.serving import (LineClient, ServingClient,
                                        ServingDaemon, ShedError,
                                        serve_counters_reset,
                                        start_frontend, start_uds_frontend)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "metric": "none", "min_data_in_leaf": 5,
          "device_predict": "true", "device_predict_min_bucket": 32}
CPU = {"device_type": "cpu"}


def _mk_xy(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.1, 0] = np.nan
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(np.float32)
    return X, y


def _train(rounds=8, seed=0, **extra):
    X, y = _mk_xy(600, seed=seed)
    b = tlgb.train({**PARAMS, **CPU, **extra}, tlgb.Dataset(X, label=y),
                   rounds)
    return b.model_to_string(), X


def _oracle(text):
    """The port's Booster.predict through the device traversal on the
    CPU: the byte-identity oracle."""
    return tlgb.Booster(model_str=text,
                        params={**CPU, "device_predict": "true"})


def _daemon(**overrides):
    p = dict(PARAMS, **CPU, serve_max_batch_rows=256,
             serve_max_coalesce_wait_ms=1.0)
    p.update(overrides)
    serve_counters_reset()
    return ServingDaemon(Config(p)).start()


@pytest.fixture(scope="module")
def served():
    text, X = _train()
    d = _daemon()
    d.registry.register("m", model_str=text, block=True)
    yield d, _oracle(text), X
    d.stop(drain=True, timeout=10)


@pytest.fixture
def clean_faults():
    yield
    for k in ("LGBM_TPU_FAULT", "LGBM_TPU_FAULT_SLOW_S",
              "LGBM_TPU_FAULT_RANK"):
        os.environ.pop(k, None)
    faults.reload()


# ------------------------------------------------------------ against JAX
def test_port_daemon_agrees_with_jax_daemon():
    X, y = _mk_xy(600, seed=1)
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X, label=y), 8)
    text = jb.model_to_string()
    jd = JDaemon(JConfig(dict(PARAMS, serve_max_batch_rows=256))).start()
    td = _daemon()
    try:
        jd.registry.register("m", model_str=text, block=True)
        td.registry.register("m", model_str=text, block=True)
        rows = X[:100]
        jleaf = np.asarray(jd.predict("m", rows, mode="leaf"))
        tleaf = td.predict("m", rows, mode="leaf")
        np.testing.assert_array_equal(tleaf, jleaf)
        jraw = np.asarray(jd.predict("m", rows, mode="raw"), np.float64)
        traw = td.predict("m", rows, mode="raw").astype(np.float64)
        trees = _oracle(text)._gbdt.models_
        T = len(trees)
        abs_sum = sum(np.abs(np.asarray(t.leaf_value)[tleaf[:, i]])
                      for i, t in enumerate(trees))
        bound = 2 * T * 2.0 ** -24 * abs_sum
        assert np.all(np.abs(traw - jraw) <= bound)
        # the same version numbering and readiness in both daemons
        assert td.health()["models"] == jd.health()["models"] == {"m": 1}
    finally:
        jd.stop()
        td.stop()


def test_stats_and_prometheus_names_equal_jax(served):
    d, _, X = served
    X2, y2 = _mk_xy(600, seed=2)
    jb = jlgb.train(dict(PARAMS), jlgb.Dataset(X2, label=y2), 4)
    jd = JDaemon(JConfig(dict(PARAMS, serve_max_batch_rows=256))).start()
    try:
        jd.registry.register("m", model_str=jb.model_to_string(),
                             block=True)
        # both packages' process counters start from nothing here: a
        # fleet or online test run earlier in this process by one package
        # alone (its router's `serve_publish`) would name a family the
        # other lacks
        from lightgbm_tpu.observability import global_registry as jreg
        from lightgbm_tpu_torch.observability import global_registry as treg
        jreg.reset()
        treg.reset()
        for _ in range(3):
            jd.predict("m", X[:4])
            d.predict("m", X[:4])
        js, ts = jd.stats(), d.stats()
        assert set(ts) == set(js)
        assert set(ts["roofline"]) == set(js["roofline"])
        assert set(ts["models"]["m"]) == set(js["models"]["m"])

        def families(page):
            return {ln.split()[2] for ln in page.splitlines()
                    if ln.startswith("# TYPE ")
                    and ln.split()[2].startswith(
                        ("lgbm_serve_", "lgbm_device_predict_",
                         "lgbm_cost_"))}
        jf = families(jrender(daemon=jd))
        tf = families(render_prometheus(daemon=d))
        assert tf == jf and "lgbm_cost_flops_total" in tf
    finally:
        jd.stop()


def test_latency_window_percentiles_equal_jax():
    rng = np.random.RandomState(7)
    tw, jw = LatencyWindow(capacity=64), JWindow(capacity=64)
    assert tw.percentiles() == jw.percentiles() == (None, None)
    for v in rng.exponential(3.0, size=200):
        tw.record(v)
        jw.record(v)
    qs = (50.0, 90.0, 99.0)
    assert tw.percentiles(qs) == jw.percentiles(qs)
    assert tw.count == jw.count == 200


# ------------------------------------------------------------ byte identity
def test_responses_byte_identical_to_booster_predict(served):
    d, bst, X = served
    c = ServingClient(d)
    for n in (1, 7, 32, 100):
        assert c.predict("m", X[:n]).tobytes() == bst.predict(
            X[:n]).tobytes()
        assert c.predict("m", X[:n], mode="raw").tobytes() == bst.predict(
            X[:n], raw_score=True).tobytes()
        np.testing.assert_array_equal(c.predict("m", X[:n], mode="leaf"),
                                      bst.predict(X[:n], pred_leaf=True))
    X64 = np.asarray(X[:16], np.float64)           # lossless round trip
    assert d.predict("m", X64).tobytes() == bst.predict(X[:16]).tobytes()
    bad = X64 + 1e-12                              # not float32-exact
    bad[np.isnan(bad)] = 0.0
    with pytest.raises(ValueError, match="losslessly"):
        d.predict("m", bad)


def test_rows_bits_independent_of_bucket_and_batch_mates():
    text, X = _train(seed=4)
    b = _oracle(text)
    g = b._gbdt
    small, big = (DevicePredictor(list(g.models_), convert=g.objective
                                  .convert_output, min_bucket=mb,
                                  device="cpu") for mb in (64, 4096))
    rows = X[:40]
    assert small.bucket_rows(40) == 64 and big.bucket_rows(40) == 4096
    for fn in ("predict", "predict_raw", "predict_leaf"):
        a = getattr(small, fn)(rows)
        assert a.tobytes() == getattr(big, fn)(rows).tobytes(), fn
        # the same rows beside 300 other rows (bucket 512 of the small
        # ladder) and alone, one at a time
        mates = np.concatenate([X[300:450], rows, X[450:600]])
        assert getattr(small, fn)(mates)[150:190].tobytes() == a.tobytes()
        one = np.concatenate([getattr(big, fn)(rows[i:i + 1])
                              for i in range(0, 40, 13)])
        assert one.tobytes() == a[::13].tobytes()


def test_hot_swap_under_eight_threads_byte_identical():
    t1, X = _train(rounds=6, seed=0)
    t2, _ = _train(rounds=9, seed=5)
    want = {1: _oracle(t1), 2: _oracle(t2)}
    d = _daemon(serve_max_coalesce_wait_ms=0.5)
    try:
        d.registry.register("m", model_str=t1, block=True)
        errors, seen = [], {1: 0, 2: 0}
        lock = threading.Lock()
        swapped = threading.Event()

        def client(tid):
            for i in range(60):
                lo = (tid * 37 + i * 11) % 590
                rows = X[lo:lo + 1 + (i % 9)]
                fut = d.submit("m", rows)
                try:
                    out = fut.result(timeout=60)
                    v = fut.version
                    ok = out.tobytes() == want[v].predict(rows).tobytes()
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    seen[v] += 1
                    if not ok:
                        errors.append(f"v{v} rows {lo} differ")
                if i == 20 and tid == 0:
                    d.registry.register("m", model_str=t2, block=True)
                    swapped.set()

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert swapped.is_set() and not errors, errors[:3]
        assert seen[1] > 0 and seen[2] > 0
        assert d.registry.serve_recompiles() == 0
        assert global_registry.counter("serve_swaps") >= 2
    finally:
        d.stop()


def test_zero_new_programs_after_warmup_and_traces(served):
    d, _, X = served
    before = len(flight_recorder.trace_tail(256))
    for n in (1, 3, 17, 33, 64, 128, 200, 256):
        d.predict("m", X[:n])
        d.predict("m", X[:n], mode="raw")
    for i in range(70):                   # serve_trace_sample is 64
        d.predict("m", X[i % 16:(i % 16) + 4])
    assert d.registry.serve_recompiles() == 0
    rl = d.stats()["roofline"]
    assert rl["dispatches"] >= 70 and rl["measured_mfu"] > 0
    assert rl["bound"] in ("compute", "hbm") and rl["bw_util"] < 1.05
    traces = flight_recorder.trace_tail(256)
    assert len(traces) > before
    t = traces[-1]
    stages = [t["coalesce_ms"], t["dispatch_ms"], t["device_settle_ms"],
              t["respond_ms"]]
    assert stages == sorted(stages) and stages[0] >= 0
    assert sum(flight_recorder.contents()
               ["coalesce_batch_requests_hist"]) > 0


# ---------------------------------------------------------- load and faults
def test_queue_full_sheds_fast(clean_faults):
    text, X = _train(rounds=4)
    os.environ["LGBM_TPU_FAULT"] = "serve_slow@1"
    os.environ["LGBM_TPU_FAULT_SLOW_S"] = "2.0"
    faults.reload()
    d = _daemon(serve_queue_depth=2)
    try:
        d.registry.register("m", model_str=text, block=True)
        futs = [d.submit("m", X[:2])]      # the dispatcher sleeps 2 s
        time.sleep(0.3)
        shed, t0 = None, time.monotonic()
        for _ in range(8):                 # 2 fill the queue, then shed
            try:
                futs.append(d.submit("m", X[:2]))
            except ShedError as e:
                shed = e
                break
        assert shed is not None and shed.depth == 2
        assert time.monotonic() - t0 < 1.0
        assert global_registry.counter("serve_shed") >= 1
        assert d.health()["shedding"] is True
        for f in futs:                     # queued work still completes
            assert f.result(timeout=30) is not None
    finally:
        d.stop()


def test_serve_shed_and_slow_faults(clean_faults):
    text, X = _train(rounds=4)
    os.environ["LGBM_TPU_FAULT"] = "serve_shed@2,serve_slow@3"
    os.environ["LGBM_TPU_FAULT_SLOW_S"] = "0.5"
    faults.reload()
    d = _daemon()
    try:
        d.registry.register("m", model_str=text, block=True)
        assert d.predict("m", X[:2]) is not None      # request 1: clean
        with pytest.raises(ShedError):                # request 2: shed
            d.submit("m", X[:2])
        t0 = time.monotonic()
        assert d.predict("m", X[:2]) is not None      # request 3: slow
        assert time.monotonic() - t0 >= 0.45
    finally:
        d.stop()
    # rank gating: a spec aimed at another replica never fires here
    os.environ["LGBM_TPU_FAULT"] = "serve_shed@1"
    os.environ["LGBM_TPU_FAULT_RANK"] = "5"
    faults.reload()
    d = _daemon()
    try:
        d.registry.register("m", model_str=text, block=True)
        assert d.predict("m", X[:2]) is not None
    finally:
        d.stop()


def test_drain_abandonment_is_announced(clean_faults):
    text, X = _train(rounds=4)
    os.environ["LGBM_TPU_FAULT"] = "serve_slow@1"
    os.environ["LGBM_TPU_FAULT_SLOW_S"] = "2.0"
    faults.reload()
    d = _daemon(serve_queue_depth=64)
    d.registry.register("m", model_str=text, block=True)
    futs = [d.submit("m", X[:2])]
    time.sleep(0.2)
    futs += [d.submit("m", X[:2]) for _ in range(5)]
    before = global_registry.counter("serve_drain_abandoned")
    assert d.stop(drain=True, timeout=0.2) is False
    assert d.coalescer.last_abandoned == 5
    assert global_registry.counter("serve_drain_abandoned") - before == 5
    for f in futs[1:]:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=30)
    # a clean drain completes every queued request
    d = _daemon()
    d.registry.register("m", model_str=text, block=True)
    futs = [d.submit("m", X[:3]) for _ in range(20)]
    assert d.stop(drain=True, timeout=30) is True
    assert all(f.result(timeout=1) is not None for f in futs)


# --------------------------------------------------------------- front ends
def test_tcp_front_end_and_client(served):
    d, bst, X = served
    srv = start_frontend(d, port=0, request_timeout_s=30.0)
    port = srv.server_address[1]
    try:
        c = ServingClient.connect("127.0.0.1", port)
        exp = bst.predict(X[:3])
        assert np.array_equal(c.predict("m", X[:3]), exp)
        with pytest.raises(TimeoutError):
            c.predict("m", X[:3], deadline_ms=0.001)
        lc = LineClient("127.0.0.1", port)
        r = lc.request({"op": "metrics"}, timeout_s=30)
        assert r["ok"] and "# TYPE lgbm_serve_requests counter" in r[
            "metrics"]
        lc.close()
        # a restart on the same port is invisible to the client
        srv.shutdown()
        srv.server_close()
        srv = start_frontend(d, port=port, request_timeout_s=30.0)
        assert np.array_equal(c.predict("m", X[:3]), exp)
        assert c.health()["ready"] is True
        c.close()
    finally:
        srv.shutdown()


def test_uds_front_end_publish_and_drain(tmp_path):
    text, X = _train()
    d = _daemon(metrics_port=0)
    d.registry.register("m", model_str=text, block=True)
    sock = str(tmp_path / "serve.sock")
    open(sock, "w").close()              # a stale file is replaced
    srv = start_uds_frontend(d, sock, request_timeout_s=60.0)
    try:
        c = ServingClient.connect_uds(sock)
        # the wire carries float64 text of the float32 results: exact
        wire = c.predict("m", X[:5])
        assert wire.astype(np.float32).tobytes() == _oracle(
            text).predict(X[:5]).tobytes()
        assert c.health()["models"] == {"m": 1}
        text2, _ = _train(rounds=4, seed=3)
        path2 = tmp_path / "m2.txt"
        path2.write_text(text2)
        lc = LineClient(uds_path=sock)
        reply = lc.request({"op": "publish", "model": "m",
                            "path": str(path2)}, timeout_s=120)
        assert reply["ok"] and reply["version"] == 2
        assert c.predict("m", X[:5]).astype(np.float32).tobytes() == \
            _oracle(text2).predict(X[:5]).tobytes()
        lc.close()
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{d.metrics_server.port}/metrics",
            timeout=30).read().decode()
        assert 'lgbm_serve_model_version{model="m"} 2' in body
        assert "lgbm_cost_flops_total" in body
        d.stop(drain=True, timeout=10)
        reply = LineClient(uds_path=sock).request(
            {"model": "m", "rows": X[:1].tolist()}, timeout_s=30)
        assert not reply["ok"] and "error" in reply
        c.close()
    finally:
        srv.shutdown()
        d.stop(drain=False)


def test_refusals():
    text, X = _train(rounds=3)
    d = _daemon()
    try:
        d.registry.register("m", model_str=text, block=True)
        with pytest.raises(KeyError):
            d.predict("nope", X[:2])
        with pytest.raises(ValueError, match="features"):
            d.predict("m", X[:2, :4])
        lin, _ = _train(rounds=2, linear_tree=True)
        with pytest.raises(RuntimeError, match="device-servable"):
            d.registry.register("lin", model_str=lin, block=True)
    finally:
        d.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingDaemon(Config(dict(PARAMS)))


def test_serving_exports_the_jax_names():
    import lightgbm_tpu.serving as jserving
    import lightgbm_tpu_torch.serving as tserving
    assert sorted(tserving.__all__) == sorted(jserving.__all__)
    for name in tserving.__all__:
        assert getattr(tserving, name).__module__.startswith(
            "lightgbm_tpu_torch.serving")
