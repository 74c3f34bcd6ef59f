"""PyTorch port: every objective, custom objectives, RF and DART on the
card against the same training on the CPU.  These tests skip without a
CUDA device.  The file imports neither JAX nor the JAX package, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_objectives_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.objective import (_weighted_percentile,
                                          percentile_by_leaf)

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F, K = 20_000, 8, 3
OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie", "multiclass",
              "multiclassova", "cross_entropy", "cross_entropy_lambda"]
BAG = {"bagging_fraction": 0.632, "bagging_freq": 1,
       "feature_fraction": 0.8}
CASES = ([(o, {"tpu_growth_strategy": e}) for o in OBJECTIVES
          for e in ("wave", "leafwise")]
         + [("multiclass", {"use_quantized_grad": True}),
            ("binary", {"boosting": "rf", **BAG}),
            ("regression_l1", {"boosting": "rf", **BAG,
                               "tpu_growth_strategy": "leafwise"}),
            ("binary", {"boosting": "dart", "drop_rate": 0.3,
                        "skip_drop": 0.2}),
            ("multiclass", {"boosting": "dart", "drop_rate": 0.3,
                            "skip_drop": 0.2, "uniform_drop": True})])


def _data(objective, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    sig = X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * X[:, 3]
    if objective.startswith("multiclass"):
        y = np.digitize(sig + rng.logistic(size=N), [-1.0, 1.0])
    elif objective == "binary":
        y = sig + rng.randn(N) > 0
    elif objective.startswith("cross_entropy"):
        y = 1 / (1 + np.exp(-sig))
    elif objective in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.4 * sig))
    elif objective == "gamma":
        y = np.exp(0.3 * sig) * rng.gamma(2.0, 0.5, N)
    else:
        y = 3.0 + sig + 0.5 * rng.randn(N)
    w = (0.5 + rng.rand(N)).astype(np.float32)
    return X, y.astype(np.float32), w


@pytest.mark.cuda
@pytest.mark.parametrize("objective,extra", CASES,
                         ids=[f"{o}-" + "-".join(f"{k}={v}" for k, v in
                                                  x.items()
                                                  if k != "feature_fraction")
                              for o, x in CASES])
def test_card_trees_equal_cpu_trees(objective, extra):
    """Three iterations at 20,000 x 8 weighted rows, 31 leaves: the
    gradients are float64 rounded once on both devices and the
    histograms exact sums, so the card grows the CPU's trees (split
    features and thresholds equal, leaf values within rtol 1e-4), the
    renewal of L1, quantile and MAPE included; predictions agree and
    the training metric runs through the device tick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, w = _data(objective)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, **extra}
    if objective.startswith("multiclass"):
        params["num_class"] = K
    boosters = {}
    for dev in ("cuda", "cpu"):
        boosters[dev] = tlgb.train({**params, "device_type": dev},
                                   tlgb.Dataset(X, label=y, weight=w), 3)
    a_models = boosters["cuda"]._gbdt.models_
    c_models = boosters["cpu"]._gbdt.models_
    assert len(a_models) == len(c_models) > 0
    for i, (a, c) in enumerate(zip(a_models, c_models)):
        ni = a.num_leaves - 1
        assert a.num_leaves == c.num_leaves, i
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      c.split_feature[:ni])
        np.testing.assert_array_equal(a.threshold[:ni], c.threshold[:ni])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-9)
    pa = boosters["cuda"].predict(X)
    pc = boosters["cpu"].predict(X)
    np.testing.assert_allclose(pa, pc, rtol=1e-4, atol=1e-6)
    g = boosters["cuda"]._gbdt
    g.eval_train()
    assert g.device.type == "cuda"
    assert g._device_eval is not None and g._device_eval.ok


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_percentile_by_leaf_on_the_card(weighted):
    """The renewal's device version on the card against its NumPy plain
    version: 200,000 rows over 255 leaves (leaf 7 empty, 20% out of the
    bag), values with ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(5)
    n, L = 200_000, 255
    leaf = rng.randint(0, L, n)
    leaf[leaf == 7] = 8
    leaf[rng.rand(n) < 0.2] = -1
    vals = (np.round(rng.randn(n) * 50) / 16).astype(np.float32)
    w = (0.25 + rng.rand(n)).astype(np.float32) if weighted else None
    dev = torch.device("cuda")
    got = percentile_by_leaf(
        torch.from_numpy(leaf).to(dev), torch.from_numpy(vals).to(dev),
        None if w is None else torch.from_numpy(w).to(dev), 0.9, L)
    want = [_weighted_percentile(vals[leaf == i],
                                 None if w is None else w[leaf == i], 0.9)
            if (leaf == i).any() else 0.0 for i in range(L)]
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.cuda
def test_custom_objective_on_the_card():
    """An L2 `fobj` on the card grows the trees of objective=regression
    without boost_from_average."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, _ = _data("regression")
    params = {"num_leaves": 31, "max_bin": 63, "verbosity": -1,
              "device_type": "cuda", "boost_from_average": False}
    builtin = tlgb.train({**params, "objective": "regression"},
                         tlgb.Dataset(X, label=y), 3)
    custom = tlgb.train({**params, "objective": "none"},
                        tlgb.Dataset(X, label=y), 3,
                        fobj=lambda s, d: (s - d.get_label(),
                                           np.ones_like(s)))
    for a, c in zip(builtin._gbdt.models_, custom._gbdt.models_):
        ni = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      c.split_feature[:ni])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4)
