"""PyTorch port: the analytic cost model on the CPU, against the JAX
package's compiled-cost model.

* `roofline()` equals the JAX function on the same numbers and peaks
  (the cpu row, and an override of both peaks through the environment);
  `phase_roofline` over the same snapshots equals JAX's; `account` /
  `snapshot` deltas; the gpu row holds the H100 SXM's peaks.
* The analytic byte and operation counts of K1-K4 and of the traversal
  at fixed shapes equal hand-computed ones, and `chip_smoke.py`'s bound
  column, which now reads them, gives the values of its own formula.
* `grow_tree` (the histogram passes) reads the seconds of the
  Tree::histogram scope the passes run in, not GBDT::grow_tree's settle
  wait; the bound column ignores the peak overrides.
* A `metrics_dir` run with `roofline=true` (the default) gives each
  iteration event a `roofline` with the JAX event's group names, on
  both engines, its grow_tree seconds those of Tree::histogram; a
  daemon's roofline counts no warmup dispatch.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.observability import costmodel as jcm
from lightgbm_tpu_torch.observability import costmodel as tcm
import lightgbm_tpu_torch as tlgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "async_host_io": False,
          "metric": ["auc", "binary_logloss"]}


def _data(n=1024, F=5, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.2 * rng.randn(n) > 0.8)
    return X, y.astype(np.float64)


CASES = [(1e9, 4e8, 0.01), (3.2e6, 8e7, 2.5e-4), (5e10, 0.0, 0.1),
         (7e5, 1e6, 0.0)]


@pytest.mark.parametrize("flops,nbytes,secs", CASES)
def test_roofline_equals_jax(flops, nbytes, secs, monkeypatch):
    assert tcm.roofline(flops, nbytes, secs, backend="cpu") == \
        jcm.roofline(flops, nbytes, secs, backend="cpu")
    monkeypatch.setenv("LGBM_TPU_PEAK_FLOPS", "6.7e13")
    monkeypatch.setenv("LGBM_TPU_PEAK_BYTES_PER_S", "3.35e12")
    assert tcm.roofline(flops, nbytes, secs, backend="gpu") == \
        jcm.roofline(flops, nbytes, secs, backend="gpu")


def test_peak_table_and_phase_roofline_equal_jax():
    assert tcm.PEAK_TABLE["gpu"] == (67e12, 3.35e12)
    assert tcm.backend_peaks("cuda") == tcm.backend_peaks("gpu")
    assert tcm.PEAK_TABLE["cpu"] == jcm.PEAK_TABLE["cpu"]
    cm = tcm.CostModel()
    cm.account("grow_tree[histogram]", 10.0, 100.0)
    prev = cm.snapshot()
    for _ in range(3):
        cm.account("grow_tree[histogram]", 2e6, 3e6)
    cm.account("gradients", 5e5, 7e5)
    cm.account("device_predict[raw@4096]", 1e6, 2e6)
    cur = cm.snapshot()
    assert cur["grow_tree"] == {"flops": 10.0 + 6e6, "bytes": 100.0 + 9e6,
                                "calls": 4, "unharvested": 0}
    assert cm.per_call("device_predict[raw@4096]") == (1e6, 2e6)
    phases = {"GBDT::gradients": 0.004, "DevicePredictor::dispatch": 0.001}
    # the same grow_tree seconds, each under its package's scope (the
    # port's grow_tree group is the histogram passes, timed by
    # Tree::histogram; its GBDT::grow_tree::device is the settle wait)
    got = cm.phase_roofline(prev, cur, {
        **phases, "Tree::histogram::device": 0.02, "Tree::histogram": 0.05,
        "GBDT::grow_tree::device": 1e-5, "GBDT::grow_tree": 0.06},
        backend="cpu")
    want = jcm.CostModel().phase_roofline(prev, cur, {
        **phases, "GBDT::grow_tree::device": 0.02,
        "GBDT::grow_tree": 0.05}, backend="cpu")
    assert got == want
    assert set(got) == {"grow_tree", "gradients", "device_predict"}
    assert got["grow_tree"]["calls"] == 3
    assert got["grow_tree"]["device_s"] == 0.02
    cm.reset()
    assert cm.snapshot() == {} and cm.per_call("gradients") is None


def test_grow_tree_reads_the_histogram_passes_time():
    """grow_tree counts the histogram passes, so its seconds are those of
    the scope the passes run in: the CUDA-event `::device` split of
    Tree::histogram on the card, its host seconds off it; never the
    settle wait of GBDT::grow_tree."""
    assert tcm.GROUP_PHASES["grow_tree"] == "Tree::histogram"
    assert {g: s for g, s in tcm.GROUP_PHASES.items() if g != "grow_tree"} \
        == {g: s for g, s in jcm.GROUP_PHASES.items() if g != "grow_tree"}
    cm = tcm.CostModel()
    prev = cm.snapshot()
    cm.account("grow_tree[histogram]", 4e7, 5e8)
    cur = cm.snapshot()
    card = {"GBDT::grow_tree::device": 7e-5, "GBDT::grow_tree": 0.12,
            "Tree::histogram::device": 3.4e-3, "Tree::histogram": 2.3e-3}
    got = cm.phase_roofline(prev, cur, card, backend="gpu")["grow_tree"]
    assert got["device_s"] == 3.4e-3
    assert got["bw_util"] == pytest.approx(5e8 / 3.4e-3 / 3.35e12)
    host = {"GBDT::grow_tree": 0.12, "Tree::histogram": 2.3e-3}
    got = cm.phase_roofline(prev, cur, host, backend="cpu")["grow_tree"]
    assert got["device_s"] == 2.3e-3


def test_bound_ms_ignores_peak_overrides(monkeypatch):
    """The bound column is a fixed yardstick: the peak overrides move
    the runtime roofline, not bound_ms."""
    want = tcm.bound_ms(3.35e9, 6.7e9)
    assert want == (1.0, "bytes")
    monkeypatch.setenv("LGBM_TPU_PEAK_FLOPS", "1e9")
    monkeypatch.setenv("LGBM_TPU_PEAK_BYTES_PER_S", "1e9")
    assert tcm.backend_peaks("gpu") == (1e9, 1e9)
    assert tcm.bound_ms(3.35e9, 6.7e9) == want
    assert tcm.bound_ms(2e10, 1e11, backend="cpu") == (1000.0, "bytes")


def test_analytic_counts_by_hand():
    n, F, B, C = 1 << 20, 28, 255, 2
    # K1/K3 at 8 slots: codes (1 byte), slot (4), gh (4 x 3) per row;
    # 8 x 28 x 255 x 2 float32 cells and 8 counts out
    assert tcm.wave_hist_bytes(F * n, n, 8, F, B, C) == (
        28 * n + 4 * n + 12 * n + 8 * 28 * 255 * 2 * 4 + 8 * 4)
    assert tcm.wave_hist_ops(n // 2, F, C) == (n // 2) * 57
    # K4 at 4096 rows of 16-bit codes
    assert tcm.rows_hist_bytes(4096, F, 1023, C, code_bytes=2) == (
        4096 * 28 * 2 + 8 * 4096 + 4 * 4096 + 28 * 1023 * 2 * 4)
    assert tcm.rows_hist_ops(1000, F, C) == 56000
    # a 4096-row bucket through 13 trees of depth 9, raw scores
    flops, nbytes = tcm.traverse_cost(4096, F, 13, 9, 1, pack_bytes=5000)
    assert flops == 4096 * 13 * 10
    assert nbytes == 4096 * 28 * 4 + 5000 + 4096 * 4
    flops, nbytes = tcm.traverse_cost(64, F, 13, 9, 13, 5000, sums=False)
    assert flops == 64 * 13 * 9 and nbytes == 64 * 28 * 4 + 5000 + 64 * 52
    f, b = tcm.gradients_cost(1, 1000, weighted=True)
    assert (f, b) == (8000.0, 1000 * (4 + 4 + 4 + 8))
    f, b = tcm.eval_cost(2, 1, 1000, weighted=False)
    assert (f, b) == (16000.0, 8000.0 + 16)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bounds", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [
    ("wave", 28 << 20, 1 << 20, 256, 300_000, (28, 255)),
    ("wave", 28 << 20, 1 << 20, 8, 900_000, (28, 255)),
    ("wave", 2 * 28 << 20, 1 << 20, 16, 500_000, (28, 1023)),
    ("rows", 1 << 20, 1 << 19, 1, (28, 255)),
    ("rows", 4096, 4096, 2, (28, 1023))])
def test_chip_smoke_bounds_read_the_cost_model(shape):
    """The bound column of chip_smoke.py gives the numbers of the
    formula it carried before it read the cost model."""
    cs = _chip_smoke()
    hbm, f32 = 3.35e12, 67e12
    if shape[0] == "wave":
        _, bb, n, slots, rows_in, (Fw, Bw) = shape
        nbytes = (bb + 4 * n + 4 * 3 * n + slots * Fw * Bw * 2 * 4
                  + slots * 4)
        t_b, t_o = nbytes / hbm * 1e3, rows_in * (Fw * 2 + 1) / f32 * 1e3
        got = cs.bound_of(bb, n, slots, rows_in, width=(Fw, Bw))
    else:
        _, S, rows_in, cb, (Fw, Bw) = shape
        nbytes = S * Fw * cb + 8 * S + 4 * S + Fw * Bw * 8
        t_b, t_o = nbytes / hbm * 1e3, rows_in * Fw * 2 / f32 * 1e3
        got = cs.bound_rows(S, rows_in, width=(Fw, Bw), code_bytes=cb)
    assert got == (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def _iteration_events(pkg, tmp_path, tag, **extra):
    X, y = _data()
    mx = str(tmp_path / f"mx_{tag}")
    params = {**PARAMS, **extra}
    if pkg is tlgb:
        params["device_type"] = "cpu"
    pkg.train(params, pkg.Dataset(X, label=y), 3, metrics_dir=mx)
    with open(os.path.join(mx, "events-rank0.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["event"] == "iteration"]


@pytest.mark.parametrize("engine", ["leafwise", "wave"])
def test_iteration_roofline_groups_equal_jax(tmp_path, engine):
    extra = {"tpu_growth_strategy": engine}
    tev = _iteration_events(tlgb, tmp_path, "t", **extra)
    jev = _iteration_events(jlgb, tmp_path, "j", **extra)
    assert len(tev) == len(jev) == 3
    for te, je in zip(tev, jev):
        assert set(te["roofline"]) == set(je["roofline"])
        for group, entry in te["roofline"].items():
            assert set(entry) == set(je["roofline"][group]), group
            assert entry["calls"] > 0 and entry["bytes"] > 0
            assert entry["bound"] in ("compute", "hbm")
    assert tcm.global_cost_model.enabled is False   # restored


@pytest.mark.parametrize("engine", ["leafwise", "wave"])
def test_iteration_grow_tree_reads_the_histogram_scope(tmp_path, engine):
    """Each iteration event's grow_tree seconds are its Tree::histogram
    phase (the host seconds here; on the card the CUDA-event split)."""
    tev = _iteration_events(tlgb, tmp_path, "h",
                            tpu_growth_strategy=engine)
    for e in tev:
        assert "Tree::histogram::device" not in e["phases"]
        g = e["roofline"]["grow_tree"]
        assert g["device_s"] == pytest.approx(e["phases"]["Tree::histogram"],
                                              abs=1e-6)
        assert g["device_s"] < e["phases"]["GBDT::grow_tree"]


def test_roofline_off_leaves_the_event_without_it(tmp_path):
    tev = _iteration_events(tlgb, tmp_path, "off", roofline=False)
    assert all("roofline" not in e for e in tev)


def test_daemon_roofline_excludes_warmup():
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.observability.registry import global_registry
    from lightgbm_tpu_torch.serving import ServingDaemon
    X, y = _data(600)
    b = tlgb.train({**PARAMS, "device_type": "cpu"},
                   tlgb.Dataset(X, label=y), 4)
    d = ServingDaemon(Config({"device_type": "cpu",
                              "device_predict_min_bucket": 64,
                              "serve_max_batch_rows": 512})).start()
    try:
        before = global_registry.counter("device_predict_dispatches")
        d.registry.register("m", model_str=b.model_to_string(), block=True)
        # the ladder 64..512 in three modes ran, and counted nothing
        assert d.registry.stats()["models"]["m"]["warmup_traces"] == 12
        assert global_registry.counter(
            "device_predict_dispatches") == before
        d.predict("m", X[:5].astype(np.float32))
        dp = d.registry.get("m")
        info = dp.predictor.last_dispatch_info()
        dp.release()
        assert info["bucket"] == 64 and info["bytes"] > 0
        assert global_registry.counter(
            "device_predict_dispatches") == before + 1
    finally:
        d.stop()
