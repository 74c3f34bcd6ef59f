"""PyTorch port: the device eval tick (lightgbm_tpu_torch/ops/metrics.py)
against the JAX package's (lightgbm_tpu/ops/metrics.py) on the CPU.

The same scores, labels, weights and padding mask (n = 1,000 rows padded
to 1,024, made from a seed) go through both ticks.  The JAX tick sums in
float32, the port's in float64 with fixed-point cumulative sums, so the
two agree within the float32 sum's error: |port - jax| <= log2(n) *
2^-23 * |jax| (+ 2^-23 absolute for values near 0).  The port's tick also
agrees with its own float64 host `Metric` within the rounding of the
packed float32 vector (2^-23 relative, + 1e-12).  The tick gives the
same bits on a repeat call, and `DeviceEval` makes exactly one transfer
per tick.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.metric import create_metrics as jcreate_metrics
from lightgbm_tpu.objective import BinaryLogloss as JBinary
from lightgbm_tpu.ops import metrics as jops
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.metric import create_metrics as tcreate_metrics
from lightgbm_tpu_torch.objective import BinaryLogloss as TBinary
from lightgbm_tpu_torch.ops import metrics as tops

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, N_PAD, K = 1000, 1024, 3
POINTWISE = ["l2", "rmse", "l1", "quantile", "huber", "fair", "poisson",
             "mape", "gamma", "gamma_deviance", "tweedie", "binary_logloss",
             "binary_error", "cross_entropy", "kullback_leibler",
             "cross_entropy_lambda"]
RANKED = ["auc", "average_precision"]
TOL_JAX = np.log2(N_PAD) * 2.0 ** -23


def _inputs(metrics, K_, weighted, variant, seed=0):
    """(scores [K_, N_PAD] f32, label, weight | None, pad_mask)."""
    rng = np.random.RandomState(seed)
    binary_label = any(m in ("auc", "average_precision", "binary_logloss",
                             "binary_error") for m in metrics)
    if K_ > 1:
        label = rng.randint(0, K_, N_PAD)
    elif binary_label:
        label = rng.rand(N_PAD) < 0.4
    else:
        label = rng.rand(N_PAD) * (1.0 if "cross_entropy" in metrics[0]
                                   or "kullback" in metrics[0] else 3.0)
    if K_ > 1 or metrics[0] in ("cross_entropy", "kullback_leibler",
                                "binary_logloss", "binary_error",
                                "cross_entropy_lambda", "poisson", "gamma",
                                "gamma_deviance", "tweedie"):
        scores = rng.rand(K_, N_PAD) * 0.9 + 0.05
    else:
        scores = rng.randn(K_, N_PAD)
    if variant == "ties":
        scores = np.round(scores * 8) / 8 + 0.01
        if K_ > 1 or metrics[0] != "l2":
            scores = np.clip(scores, 0.01, 0.99)
    elif variant == "nan":
        scores = np.where(rng.rand(K_, N_PAD) < 0.05, np.nan, scores)
    label = label.astype(np.float32)
    label[N:] = 0.0
    pad = np.zeros(N_PAD, np.float32)
    pad[:N] = 1.0
    w = ((rng.rand(N_PAD) * 2 + 0.1).astype(np.float32) if weighted
         else None)
    return scores.astype(np.float32), label, w, pad


def _ticks(metrics, K_, weighted, variant, obj_pair=(None, None)):
    params = {"metric": metrics, "num_class": K_, "verbosity": -1,
              "multi_error_top_k": 2,
              "objective": "multiclass" if K_ > 1 else "binary"}
    tcfg, jcfg = TConfig(params), JConfig(params)
    tm, jm = tcreate_metrics(tcfg), jcreate_metrics(jcfg)
    tplans = tops.build_plans(tm, tcfg, obj_pair[0], K_)
    jplans = jops.build_plans(jm, jcfg, obj_pair[1], K_)
    assert [p[:2] for p in tplans] == [p[:2] for p in jplans]
    sc, lab, w, pad = _inputs(metrics, K_, weighted, variant)
    tick = tops.make_tick_fn(tplans, obj_pair[0], K_, 2)
    targs = (torch.from_numpy(sc), torch.from_numpy(lab),
             None if w is None else torch.from_numpy(w),
             torch.from_numpy(pad), torch.tensor(True))
    got = tick(*targs).numpy()
    again = tick(*targs).numpy()
    jtick = jops.make_tick_fn(jplans, obj_pair[1], K_, 2)
    want = np.asarray(jtick(jnp.asarray(sc), jnp.asarray(lab),
                            None if w is None else jnp.asarray(w),
                            jnp.asarray(pad), jnp.asarray(True)))
    host = []
    md = types.SimpleNamespace(label=lab[:N],
                               weight=None if w is None else w[:N],
                               query_boundaries=None)
    for m in tm:
        m.init(md, N)
        s64 = sc[:, :N].astype(np.float64)
        host.extend(v for _, v in m.eval(s64[0] if K_ == 1 else s64,
                                         obj_pair[0]))
    return got, again, want, np.array(host), tplans


def _check(got, again, want, host):
    np.testing.assert_array_equal(got, again)      # same bits on repeat
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL_JAX, atol=2.0 ** -23)
    np.testing.assert_allclose(got[:-2], host, rtol=2.0 ** -23, atol=1e-12)


@pytest.mark.parametrize("variant", ["plain", "ties"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", POINTWISE)
def test_pointwise_tick_equals_jax(name, weighted, variant):
    got, again, want, host, _ = _ticks([name], 1, weighted, variant)
    _check(got, again, want, host)
    assert got[-2:].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("variant", ["plain", "ties", "nan"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", RANKED)
def test_ranked_tick_equals_jax(name, weighted, variant):
    """Exact AUC / average precision: tie blocks and NaN scores (sorted
    last, singleton groups) as the host classes treat them."""
    got, again, want, host, _ = _ticks([name], 1, weighted, variant)
    _check(got, again, want, host)
    assert got[-1] == (0.0 if variant == "nan" else 1.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_tick_equals_jax(weighted):
    got, again, want, host, _ = _ticks(["multi_logloss", "multi_error"], K,
                                       weighted, "ties")
    _check(got, again, want, host)


def test_tick_through_binary_objective():
    """Converted scores: the port's sigmoid in float64 against the JAX
    objective's in float32."""
    cfg = {"objective": "binary", "sigmoid": 1.5, "verbosity": -1}
    objs = (TBinary(TConfig(cfg)), JBinary(JConfig(cfg)))
    got, again, want, host, _ = _ticks(
        ["auc", "binary_logloss", "binary_error", "cross_entropy"], 1, True,
        "plain", objs)
    _check(got, again, want, host)


def test_probability_one_stays_finite():
    """A probability of exactly 1.0f: the JAX tick's clip to 1 - 1e-15 is
    lost in float32, so its logloss of a negative row is inf, while its
    host class gives -log(1e-15)-ish finite values; the port's tick
    computes in float64 and gives the host's value (a divergence of the
    reference, stated here)."""
    params = {"metric": ["binary_logloss"], "objective": "binary",
              "verbosity": -1}
    tm = tcreate_metrics(TConfig(params))
    jm = jcreate_metrics(JConfig(params))
    sc = np.array([[1.0, 0.5, 0.25, 0.0]], np.float32)
    lab = np.array([0.0, 1.0, 0.0, 1.0], np.float32)
    pad = np.ones(4, np.float32)
    got = tops.make_tick_fn(tops.build_plans(tm, TConfig(params), None, 1),
                            None, 1, 1)(
        torch.from_numpy(sc), torch.from_numpy(lab), None,
        torch.from_numpy(pad), torch.tensor(True)).numpy()
    want = np.asarray(jops.make_tick_fn(
        jops.build_plans(jm, JConfig(params), None, 1), None, 1, 1)(
        jnp.asarray(sc), jnp.asarray(lab), None, jnp.asarray(pad),
        jnp.asarray(True)))
    md = types.SimpleNamespace(label=lab, weight=None, query_boundaries=None)
    tm[0].init(md, 4)
    host = tm[0].eval(sc[0].astype(np.float64))[0][1]
    assert np.isinf(want[0]) and np.isfinite(host)
    np.testing.assert_allclose(got[0], host, rtol=2.0 ** -23)


def test_gradient_flag_rides_the_tick():
    got = tops.make_tick_fn([], None, 1, 1)(
        torch.zeros(1, 8), torch.zeros(8), None, torch.ones(8),
        torch.tensor(False))
    assert got.tolist() == [0.0, 1.0]


def test_no_device_form_falls_back_to_host():
    for metrics in (["auc", "ndcg"], ["auc_mu"], ["map"]):
        cfg = TConfig({"metric": metrics, "objective": "binary"})
        assert tops.build_plans(tcreate_metrics(cfg), cfg, None, 1) is None


def _booster(extra, group=None):
    rng = np.random.RandomState(5)
    X = rng.randn(3000, 6).astype(np.float32)
    y = (X[:, 0] + rng.randn(3000) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "device_type": "cpu",
              "metric": ["auc", "binary_logloss"], **extra}
    ds = tlgb.Dataset(X, label=y, params=params).construct()
    ds._core.metadata.set_group(group)
    b = tlgb.Booster(params, ds)
    b.update()
    b.update()
    return b


def test_device_eval_one_transfer_per_tick():
    b = _booster({})
    first = b.eval_train()
    second = b.eval_train()
    de = b._gbdt._device_eval
    assert de.ok and de.fetches == 2
    assert first == second
    # the sentinel's flags came with the tick: no second transfer
    assert b._gbdt.gradients_finite() and b._gbdt.scores_finite()
    assert de.fetches == 2
    host = b._gbdt._eval(
        b._inner_predict_train()[None, :].astype(np.float64),
        b._gbdt.train_metrics)
    np.testing.assert_allclose([v for _, _, v, _ in first],
                               [v for _, v in host], rtol=2.0 ** -23)


@pytest.mark.parametrize("extra", [{"device_eval": "false"},
                                   {"metric": ["auc", "map"]}])
def test_host_path_when_device_eval_off_or_incomplete(extra):
    """device_eval=false, or one metric with no device form: every
    training metric goes to the host path (all or nothing)."""
    b = _booster(extra, group=[1500, 1500])
    res = b.eval_train()
    assert not b._gbdt._device_eval.ok
    assert b._gbdt._device_eval.fetches == 0
    assert res[0][1] == "auc"
