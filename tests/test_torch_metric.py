"""PyTorch port: the host `Metric` classes (lightgbm_tpu_torch/metric.py)
against the JAX package's (lightgbm_tpu/metric.py) on the same arrays.

Both are float64 NumPy code, so every metric must give the JAX
package's value exactly (the port's unweighted AUC sums its blocks at
once, which is exact: every term is a multiple of 0.5 below 2^52).  Each
class runs unweighted and weighted, on scores with ties and on scores
with NaN, at n = 600 rows made from a seed.
"""

import types

import numpy as np
import pytest

from lightgbm_tpu import metric as jmetric
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective import BinaryLogloss as JBinary
from lightgbm_tpu_torch import metric as tmetric
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective import BinaryLogloss as TBinary

N, K = 600, 3
PARAMS = {"num_class": K, "objective": "multiclass", "eval_at": [1, 3, 5],
          "alpha": 0.7, "fair_c": 0.8, "tweedie_variance_power": 1.3,
          "multi_error_top_k": 2, "verbosity": -1}

REGRESSION = ["l2", "rmse", "l1", "quantile", "huber", "fair", "poisson",
              "mape", "gamma", "gamma_deviance", "tweedie"]
BINARY = ["binary_logloss", "binary_error", "auc", "average_precision"]
MULTICLASS = ["multi_logloss", "multi_error", "auc_mu"]
RANKING = ["ndcg", "map"]
XENT = ["cross_entropy", "cross_entropy_lambda", "kullback_leibler"]
ALL = REGRESSION + BINARY + MULTICLASS + RANKING + XENT


def _case(name, weighted, variant, seed=0):
    """(metadata, score) for one metric: labels of the metric's kind,
    scores with ties (rounded to a coarse grid) or with NaN."""
    rng = np.random.RandomState(seed)
    if name in BINARY:
        label = (rng.rand(N) < 0.4).astype(np.float32)
    elif name in MULTICLASS:
        label = rng.randint(0, K, N).astype(np.float32)
    elif name in RANKING:
        label = rng.randint(0, 4, N).astype(np.float32)
    elif name in XENT:
        label = rng.rand(N).astype(np.float32)
    else:
        label = (rng.rand(N) * 3).astype(np.float32)
    shape = (K, N) if name in MULTICLASS else (N,)
    if name in XENT or name in ("multi_logloss", "multi_error"):
        score = rng.rand(*shape) * 0.98 + 0.01     # probabilities
    elif name in ("poisson", "gamma", "gamma_deviance", "tweedie"):
        score = rng.rand(*shape) * 3 + 0.05
    else:
        score = rng.randn(*shape)
    if variant == "ties":
        score = np.round(score * 4) / 4
        if name in XENT or name in ("multi_logloss", "multi_error"):
            score = np.clip(score, 0.25, 0.75)
    else:
        score = np.where(rng.rand(*shape) < 0.05, np.nan, score)
    weight = ((rng.rand(N) * 2 + 0.1).astype(np.float32) if weighted
              else None)
    qb = None
    if name in RANKING:
        sizes = rng.randint(1, 40, 200)
        sizes = sizes[np.cumsum(sizes) <= N]
        sizes[-1] += N - sizes.sum()
        qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    md = types.SimpleNamespace(label=label, weight=weight,
                               query_boundaries=qb)
    return md, score


def _pair(name):
    return (tmetric._METRIC_CLASSES[name](TConfig(PARAMS)),
            jmetric._METRIC_CLASSES[name](JConfig(PARAMS)))


@pytest.mark.parametrize("variant", ["ties", "nan"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ALL)
def test_host_metric_equals_jax(name, weighted, variant):
    md, score = _case(name, weighted, variant)
    tm, jm = _pair(name)
    tm.init(md, N)
    jm.init(md, N)
    got = tm.eval(score.copy())
    want = jm.eval(score.copy())
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_array_equal(np.array([v for _, v in got]),
                                  np.array([v for _, v in want]))


@pytest.mark.parametrize("name", BINARY + ["cross_entropy"])
def test_host_metric_through_binary_objective(name):
    """Binary metrics convert raw scores with the objective's host
    sigmoid, as the JAX package's do."""
    md, score = _case(name, True, "ties")
    tm, jm = _pair(name)
    tm.init(md, N)
    jm.init(md, N)
    cfg = {"objective": "binary", "sigmoid": 1.5}
    got = tm.eval(score, TBinary(TConfig(cfg)))
    want = jm.eval(score, JBinary(JConfig(cfg)))
    assert got == want


@pytest.mark.parametrize("params", [
    {"objective": "binary"}, {"objective": "binary", "metric": "auc"},
    {"objective": "binary", "metric": ["auc", "binary_logloss", "auc"]},
    {"objective": "binary", "metric": "none"},
    {"objective": "regression", "metric": ["mse", "l2_root", "mae"]},
    {"objective": "multiclass", "num_class": 3},
    {"objective": "lambdarank"},
    {"objective": "binary", "metric": ["xentropy", "kldiv", "map"]}])
def test_create_metrics_resolves_as_jax(params):
    """Default metrics per objective, aliases and duplicates: the same
    metric list in both packages (objective=binary defaults to
    binary_logloss)."""
    got = [m.name for m in tmetric.create_metrics(TConfig(params))]
    want = [m.name for m in jmetric.create_metrics(JConfig(params))]
    assert got == want
    if params == {"objective": "binary"}:
        assert got == ["binary_logloss"]


def test_unweighted_auc_matches_the_block_loop_at_scale():
    """The port's vectorized unweighted AUC against the block loop it
    replaces, on 200,000 rows with many ties: the same bits."""
    rng = np.random.RandomState(3)
    n = 200_000
    md = types.SimpleNamespace(
        label=(rng.rand(n) < 0.3).astype(np.float32), weight=None,
        query_boundaries=None)
    score = np.round(rng.randn(n) * 50) / 50
    tm, jm = _pair("auc")
    tm.init(md, n)
    jm.init(md, n)
    assert tm.eval(score) == jm.eval(score)
