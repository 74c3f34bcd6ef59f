"""PyTorch port: basic monotone constraints, path smoothing and CEGB's
split and coupled penalties end to end against the JAX package, on the
CPU.

Data: 4096 x 8 binary logloss with random row weights; feature 1 rises
and feature 2 falls with the label, each with a non-monotone ripple.
`train` runs three iterations in both packages for each case (monotone
with monotone_penalty and path_smooth on the wave engine; monotone,
path_smooth and CEGB on the leaf-wise engine; CEGB on the wave engine,
where overgrow-and-prune is off and a wave's splits pay a new feature's
coupled penalty each, the JAX engine's accounting), compared under the
tie rule of tests/test_torch_categorical.py.  Then, on the port alone:
predictions of a constrained model are monotone exactly along a grid of
each constrained feature (float addition in tree order keeps the order,
so no tolerance), where the unconstrained model's are not; and a
coupled penalty is paid once over the model, as
tests/test_cegb.py::test_coupled_penalty_paid_once checks.
"""

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_categorical import compare_training

N, FEATS = 4096, 8
BASE = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}
MONO = [0, 1, -1, 0, 0, 0, 0, 0]


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    logit = (1.2 * X[:, 1] + 0.6 * np.sin(4 * X[:, 1]) - 1.0 * X[:, 2]
             + 0.5 * np.sin(5 * X[:, 2]) + 0.8 * X[:, 0] * X[:, 3]
             + 0.4 * X[:, 4])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    wt = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, wt


TRAIN_CASES = {
    "monotone_smooth_wave": {"tpu_growth_strategy": "wave",
                             "monotone_constraints": MONO,
                             "monotone_penalty": 1.5, "path_smooth": 1.0},
    "monotone_smooth_cegb_leafwise": {
        "tpu_growth_strategy": "leafwise", "monotone_constraints": MONO,
        "path_smooth": 1.0, "cegb_penalty_split": 1e-4,
        "cegb_penalty_feature_coupled": [5.0] * FEATS},
    "cegb_wave": {"tpu_growth_strategy": "wave", "cegb_tradeoff": 0.5,
                  "cegb_penalty_split": 1e-4,
                  "cegb_penalty_feature_coupled": [8.0] * FEATS},
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case):
    X, y, wt = _data()
    params = {**BASE, **TRAIN_CASES[case]}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt), 3)
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=wt),
                    3)
    bj._gbdt._sync_model()
    sp = bt._gbdt.grow_params.split
    assert sp.has_monotone == ("monotone_constraints" in params)
    assert sp.has_cegb == ("cegb_penalty_split" in params)
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def _violations(booster, rows, feature, direction):
    """Steps against `direction` when `feature` sweeps a grid of 64 values
    in each of `rows` (the other features as they are)."""
    grid = np.linspace(-3.0, 3.0, 64)
    Xs = np.repeat(rows, len(grid), axis=0).astype(np.float64)
    Xs[:, feature] = np.tile(grid, len(rows))
    pred = booster.predict(Xs, raw_score=True).reshape(len(rows), -1)
    return int((np.diff(pred, axis=1) * direction < 0).sum())


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_predictions_respect_constraints(engine):
    X, y, wt = _data()
    params = {**BASE, **CPU, "num_leaves": 15, "tpu_growth_strategy": engine,
              "min_data_in_leaf": 5}
    rows = _data(seed=1, n=200)[0]
    free = tlgb.train(params, tlgb.Dataset(X, label=y, weight=wt), 10)
    assert _violations(free, rows, 1, +1) + _violations(free, rows, 2,
                                                        -1) > 0
    mc = tlgb.train({**params, "monotone_constraints": MONO},
                    tlgb.Dataset(X, label=y, weight=wt), 10)
    assert _violations(mc, rows, 1, +1) == 0
    assert _violations(mc, rows, 2, -1) == 0
    # the constrained features still carry the model
    imp = mc.feature_importance("split")
    assert imp[1] > 0 and imp[2] > 0
    assert float(np.corrcoef(mc.predict(X), y)[0, 1]) > 0.4


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_coupled_penalty_paid_once(engine):
    """Once a coupled feature is bought, later trees use it freely: with a
    penalty each tree could just afford, it appears in every tree, and
    the booster's used-feature vector marks it after the first."""
    rng = np.random.RandomState(3)
    n = 2048
    X = rng.randn(n, 2).astype(np.float32)
    y = (X[:, 0] + 0.05 * rng.randn(n) > 0).astype(np.float32)
    b = tlgb.Booster({**BASE, **CPU, "num_leaves": 7, "min_data_in_leaf": 5,
                      "tpu_growth_strategy": engine,
                      "cegb_penalty_feature_coupled": [50.0, 50.0]},
                     tlgb.Dataset(X, label=y))
    b.update()
    assert b._gbdt.cegb_used.tolist() == [True, False]
    for _ in range(7):
        b.update()
    for t in b._gbdt.models_:
        assert 0 in t.split_feature[:t.num_leaves - 1]
    imp = b.feature_importance("split")
    assert imp[0] >= 8 and imp[1] == 0, imp
