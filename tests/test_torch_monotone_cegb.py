"""PyTorch port: intermediate and advanced monotone constraints and lazy
CEGB on the leaf-wise engine, against the JAX package, on the CPU.

Data: 4096 x 8 binary logloss with random row weights (the data of
tests/test_torch_constraints.py).  `train` runs three iterations in both
packages for each case, and the trees are compared under the tie rule of
tests/test_torch_categorical.py.  Then, on the port alone, what
tests/test_monotone.py and tests/test_cegb.py check of the JAX package:
monotone predictions on slices of the other features, the fall-backs and
their warnings, and lazy CEGB under RF, bagging, the split penalty and
basic monotone constraints.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils import log as tlog

from test_torch_categorical import compare_training
from test_torch_constraints import BASE, CPU, MONO, _data

# lazy penalties per row: a 4096-row root pays 0.4 for feature 1; small
# enough that trees grow (a penalty of 1.0 per row with tradeoff 0.5
# stops every split at 4,000 rows)
LAZY = [1e-4, 1e-4, 2e-4, 0.0, 1e-4, 0.0, 3e-4, 1e-4]

TRAIN_CASES = {
    "intermediate": {"monotone_constraints": MONO,
                     "monotone_constraints_method": "intermediate",
                     "num_leaves": 15},
    "advanced": {"monotone_constraints": MONO,
                 "monotone_constraints_method": "advanced",
                 "num_leaves": 15, "path_smooth": 1.0},
    # asked for the wave engine: the mode takes the leaf-wise one
    "advanced_wave_asked": {"monotone_constraints": MONO,
                            "monotone_constraints_method": "advanced",
                            "tpu_growth_strategy": "wave",
                            "monotone_penalty": 1.5},
    "lazy": {"cegb_penalty_feature_lazy": LAZY, "cegb_tradeoff": 0.5},
    "lazy_bagging_split_penalty": {
        "cegb_penalty_feature_lazy": LAZY, "cegb_penalty_split": 1e-4,
        "bagging_fraction": 0.7, "bagging_freq": 1},
    "lazy_basic_monotone": {"cegb_penalty_feature_lazy": LAZY,
                            "monotone_constraints": MONO,
                            "monotone_constraints_method": "intermediate"},
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case):
    X, y, wt = _data()
    params = {**BASE, "tpu_growth_strategy": "leafwise",
              **TRAIN_CASES[case]}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt), 3)
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=wt),
                    3)
    bj._gbdt._sync_model()
    g, gj = bt._gbdt, bj._gbdt
    assert g.growth_strategy == gj.growth_strategy == "leafwise"
    gp, gpj = g.grow_params, gj.grow_params
    assert gp.monotone_intermediate == gpj.monotone_intermediate
    assert gp.monotone_advanced == gpj.monotone_advanced
    assert gp.split.has_cegb_lazy == gpj.split.has_cegb_lazy
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)
    if gp.split.has_cegb_lazy:
        # the fetched rows ride from tree to tree, as the JAX booster's
        np.testing.assert_array_equal(g.lazy_used.numpy(),
                                      np.asarray(gj._lazy_used))


@pytest.fixture
def warnings_seen(monkeypatch):
    seen = []
    monkeypatch.setattr(tlog, "warning", lambda msg, *a: seen.append(msg))
    return seen


@pytest.mark.parametrize("extra,inter,strategy,warning", [
    # basic again: the port's `auto` takes the wave engine at 8 leaves
    ({"extra_trees": True}, False, "wave", "falls back to basic"),
    ({"feature_fraction_bynode": 0.5}, False, "wave",
     "falls back to basic"),
    ({"cegb_penalty_feature_lazy": LAZY}, False, "leafwise",
     "falls back to basic with cegb_penalty_feature_lazy"),
    # no room for the histogram stack: basic, and the wave engine free
    ({"histogram_pool_size": 0.001}, False, "wave", "histogram stack"),
    ({"tpu_growth_strategy": "wave"}, True, "leafwise",
     "use the leaf-wise engine"),
])
def test_fallbacks_and_warnings(extra, inter, strategy, warning,
                                warnings_seen):
    """Each fall-back of the JAX booster (gbdt.py:381-431, :508-514,
    :604-619): the same flags in both packages, the engine, and the
    warning."""
    X, y, wt = _data(n=1024)
    params = {**BASE, "monotone_constraints": MONO,
              "monotone_constraints_method": "advanced",
              "tpu_growth_strategy": "auto", **extra}
    bj = jlgb.Booster(params, jlgb.Dataset(X, label=y, weight=wt))
    bt = tlgb.Booster({**params, **CPU}, tlgb.Dataset(X, label=y,
                                                      weight=wt))
    g, gj = bt._gbdt, bj._gbdt
    assert g.grow_params.monotone_intermediate == inter
    assert gj.grow_params.monotone_intermediate == inter
    assert g.growth_strategy == strategy
    assert any(warning in m for m in warnings_seen), warnings_seen


def _problem(n=3000, seed=0):
    """tests/test_monotone.py's landscape: rising in x0, falling in x1."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3)
    y = (2 * X[:, 0] + np.sin(6 * X[:, 0]) * 0.3 - 1.5 * X[:, 1]
         + 0.4 * np.cos(5 * X[:, 2]) + 0.1 * rng.randn(n))
    return X, y


def _is_monotone(b, f, direction, others):
    grid = np.linspace(0.01, 0.99, 64)
    Xs = np.tile(np.asarray([0.0] + list(others), np.float64), (64, 1))
    Xs = Xs[:, [1, 0, 2]] if f == 1 else Xs
    Xs[:, f] = grid
    d = np.diff(b.predict(Xs))
    return bool((d * direction >= -1e-10).all())


@pytest.fixture(scope="module")
def mode_boosters():
    X, y = _problem()
    base = {"objective": "regression", "num_leaves": 31, "verbosity": -1,
            "learning_rate": 0.2, "min_data_in_leaf": 5,
            "monotone_constraints": [1, -1, 0],
            "tpu_growth_strategy": "leafwise", **CPU}
    out = {}
    for mode in ("basic", "intermediate", "advanced"):
        out[mode] = tlgb.train({**base, "monotone_constraints_method": mode},
                               tlgb.Dataset(X, label=y), 20)
    return X, y, out


@pytest.mark.parametrize("mode", ["intermediate", "advanced"])
def test_predictions_monotone_on_slices(mode, mode_boosters):
    """tests/test_monotone.py:96-150 on the port: every slice of the other
    features is monotone, and the looser bounds fit at least as well as
    the tighter mode's (basic for intermediate, intermediate for
    advanced)."""
    X, y, b = mode_boosters
    rng = np.random.RandomState(11)
    for _ in range(10):
        others = tuple(rng.rand(2))
        assert _is_monotone(b[mode], 0, +1, others)
        assert _is_monotone(b[mode], 1, -1, others)
    tighter = "basic" if mode == "intermediate" else "intermediate"
    mse = float(np.mean((b[mode].predict(X) - y) ** 2))
    mse_t = float(np.mean((b[tighter].predict(X) - y) ** 2))
    slack = 1.02 if mode == "intermediate" else 1.005
    assert mse <= mse_t * slack, (mse, mse_t)


def test_advanced_differs_from_intermediate_when_slack_matters():
    """tests/test_monotone.py:152-180 on the port."""
    rng = np.random.RandomState(3)
    n = 3000
    X = rng.rand(n, 2)
    y = (np.where(X[:, 0] > 0.5, 2.0, 0.0) * (0.5 + X[:, 1])
         + 0.05 * rng.randn(n))
    base = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
            "min_data_in_leaf": 5, "monotone_constraints": [1, 0],
            "tpu_growth_strategy": "leafwise", **CPU}
    b_int = tlgb.train({**base, "monotone_constraints_method":
                        "intermediate"}, tlgb.Dataset(X, label=y), 10)
    b_adv = tlgb.train({**base, "monotone_constraints_method": "advanced"},
                       tlgb.Dataset(X, label=y), 10)
    assert b_int.model_to_string() != b_adv.model_to_string()
    grid = np.linspace(0.01, 0.99, 50)
    for x1 in np.linspace(0.05, 0.95, 7):
        d = np.diff(b_adv.predict(np.column_stack([grid, np.full(50, x1)])))
        assert (d >= -1e-10).all()


def _cegb_data(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.mark.parametrize("extra", [
    {},
    {"monotone_constraints": [1, 0, 0, 0]},
    {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.6, "bagging_freq": 2},
])
def test_lazy_keeps_expensive_features_out(extra):
    """tests/test_cegb.py:69-82, :121-132 and :134-143 on the port: lazy
    penalties of 1e5 per row keep two noise features out of every tree,
    alone, beside basic monotone constraints, under RF and with bagging;
    the fetched-rows state rides from tree to tree and marks rows only
    of the used features."""
    X, y = _cegb_data()
    b = tlgb.train({"objective": "binary", "num_leaves": 15,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "cegb_penalty_feature_lazy": [0.0, 0.0, 1e5, 1e5],
                    **extra, **CPU}, tlgb.Dataset(X, label=y), 5)
    imp = b.feature_importance("split")
    assert imp[2] == 0 and imp[3] == 0, imp
    assert imp[0] > 0, imp
    used = b._gbdt.lazy_used.numpy()
    assert used[0].any() and not used[2:].any()


def test_lazy_charged_per_row_not_per_feature():
    """tests/test_cegb.py:85-116 on the port: the root dodges the lazy
    charge, the first tree's child splits fetch feature 1's rows, and the
    second tree's root uses it for free."""
    rng = np.random.RandomState(7)
    n = 2000
    X = np.stack([rng.rand(n), rng.rand(n)], 1)
    y = (1.1 * (X[:, 1] > 0.5) + 1.0 * (X[:, 0] > 0.5)
         + 0.05 * rng.randn(n))
    b = tlgb.train({"objective": "regression", "num_leaves": 4,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "learning_rate": 0.5,
                    "cegb_penalty_feature_lazy": [0.0, 0.1],
                    "cegb_tradeoff": 1.0, **CPU},
                   tlgb.Dataset(X, label=y), 3)
    t0, t1 = b._gbdt.models_[:2]
    assert t0.split_feature[0] == 0
    assert b.feature_importance("split")[1] > 0
    assert t1.split_feature[0] == 1


def test_lazy_composes_with_split_penalty():
    """tests/test_cegb.py:119-130 on the port."""
    X, y = _cegb_data(n=1500)
    b = tlgb.train({"objective": "binary", "num_leaves": 15,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "cegb_penalty_split": 1e-4,
                    "cegb_penalty_feature_lazy": [1e-4] * 4, **CPU},
                   tlgb.Dataset(X, label=y), 5)
    p = b.predict(X)
    assert np.isfinite(p).all()
    assert np.mean((p > 0.5) == (y > 0.5)) > 0.8
