"""PyTorch port: `Booster.refit` and SHAP contributions
(`predict(pred_contrib=True)`) against the JAX package, on the CPU.

* Refit (ref: gbdt.cpp:252 RefitTree): both packages refit the same
  model on new rows.  A model read from text gives both packages the
  same trees: their refitted leaf values agree within REFIT_REL (the
  JAX package's gradients are float32 device math, the port's float64
  rounded once) and their leaf counts exactly.  Trained boosters
  (binary, 3-class, weighted regression with lambda_l1, lambda_l2,
  max_delta_step and refit_decay_rate) grow the same trees in both
  packages, whose leaf values stray by up to 4e-5 relative (ROADMAP),
  so their refits agree within TRAINED_REL; the port's refit also
  equals the plain formula from its own leaf ids and float64 host
  gradients.  The predictor caches are dropped, also when a refit
  raises midway.
* Contributions (TreeSHAP, `native/treeshap.c`): the JAX package's
  trained boosters (binary, 3-class, categorical, NaN, RF, a linear
  model) and the port's Booster read from their model text give the
  same contributions within 1e-12, dense, CSR (CSR out) and an empty
  CSR, on slices of iterations too; a port booster read from text gives
  its trained booster's bits (the JAX package's needs the training data
  and leaf depths a loaded booster lacks); each row sums to the
  raw score within 1e-9 of its summed |phi|; the brute-force Shapley
  values of a small tree (tests/test_shap.py); the native library
  equals the Python fallback.  A linear model's contributions explain
  its constant leaves, as the JAX package's do.
"""

import itertools
import math

import numpy as np
import pytest
import scipy.sparse as sps
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.boosting.gbdt import K_EPSILON

N, F = 2000, 5
CPU = {"device_type": "cpu"}
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.3,
        "min_data_in_leaf": 10, "verbosity": -1,
        "tpu_growth_strategy": "leafwise", "tpu_donate_buffers": False}
REFIT_REL = 1e-5
TRAINED_REL = 1e-3


def _data(n=N, seed=0, kind="binary", nan=0.0, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    if cat:
        X[:, 4] = rng.randint(0, 8, n)
    sig = 2 * X[:, 0] + X[:, 1] * X[:, 2] + 0.5 * np.isin(X[:, 4], [1, 3])
    if nan:
        X[rng.rand(n, F) < nan] = np.nan
    if kind == "binary":
        y = (sig + rng.logistic(size=n) > 0).astype(np.float64)
    elif kind == "multiclass":
        y = np.digitize(sig + rng.logistic(size=n), [-1.0, 1.0]).astype(
            np.float64)
    else:
        y = sig + 0.3 * rng.randn(n)
    w = 0.5 + np.random.RandomState(100 + seed).rand(n)
    return X, y, w


def _params(kind, **extra):
    p = {**BASE, "objective": kind, **extra}
    if kind == "multiclass":
        p["num_class"] = 3
    return p


def _text(kind, rounds=4, **extra):
    X, y, w = _data(kind=kind, nan=extra.pop("nan", 0.0),
                    cat="categorical_feature" in extra)
    ds_kw = ({"categorical_feature": extra.pop("categorical_feature")}
             if "categorical_feature" in extra else {})
    b = tlgb.train({**_params(kind, **extra), **CPU},
                   tlgb.Dataset(X, label=y, weight=w, **ds_kw), rounds)
    return b.model_to_string()


def _leaves(booster):
    return [t.leaf_value[:t.num_leaves].copy()
            for t in booster._gbdt.models_]


# ---------------------------------------------------------------- refit
@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_refit_of_model_text_equals_jax(kind):
    text = _text(kind)
    X2, y2, w2 = _data(1500, seed=5, kind=kind)
    jb = jlgb.Booster(model_str=text)
    tb = tlgb.Booster(model_str=text, params=CPU)
    assert tb.refit(X2, y2, weight=w2) is tb
    jb.refit(X2, y2, weight=w2)
    for a, b in zip(jb._gbdt.models_, tb._gbdt.models_):
        nl = a.num_leaves
        np.testing.assert_allclose(b.leaf_value[:nl], a.leaf_value[:nl],
                                   rtol=REFIT_REL, atol=1e-12)
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
    np.testing.assert_allclose(tb.predict(X2), jb.predict(X2), rtol=1e-5)


REFIT_CASES = {
    "binary": ("binary", {}),
    "multiclass": ("multiclass", {"min_data_in_leaf": 1}),
    "regression_l1_l2_max_delta": ("regression", {
        "lambda_l1": 0.5, "lambda_l2": 2.0, "max_delta_step": 0.3,
        "refit_decay_rate": 0.5}),
}


def _plain_refit(booster, X, y, w, old):
    """The refit formula on the host: the port's leaf ids, its objective's
    gradients pulled as float64, per-leaf sums by np.bincount."""
    g = booster._gbdt
    cfg = g.config
    K = g.num_tree_per_iteration
    lp = g.predict_leaf_index(X)
    score = np.zeros((K, len(X)))
    new_all = []
    for it in range(len(g.models_) // K):
        sc = torch.from_numpy(score.astype(np.float32))
        lab = torch.from_numpy(np.asarray(g.objective.label, np.float32))
        gg, hh = g.objective.get_gradients(
            sc if K > 1 else sc[0], lab, torch.from_numpy(
                w.astype(np.float32)))
        gg = gg.reshape(K, -1).numpy().astype(np.float64)
        hh = hh.reshape(K, -1).numpy().astype(np.float64)
        for k in range(K):
            m = it * K + k
            t = g.models_[m]
            nl = t.num_leaves
            ids = lp[:, m]
            sg = np.array([gg[k][ids == j].sum() for j in range(nl)])
            sh = np.array([hh[k][ids == j].sum() for j in range(nl)])
            sh += K_EPSILON
            sg = np.sign(sg) * np.maximum(np.abs(sg) - cfg.lambda_l1, 0)
            out = -sg / (sh + cfg.lambda_l2)
            if cfg.max_delta_step > 0:
                out = np.clip(out, -cfg.max_delta_step, cfg.max_delta_step)
            new = (cfg.refit_decay_rate * old[m]
                   + (1 - cfg.refit_decay_rate) * out * t.shrinkage)
            new_all.append(new)
            score[k] += new[ids]
    return new_all


@pytest.mark.parametrize("case", list(REFIT_CASES))
def test_refit_of_trained_booster_equals_jax(case):
    kind, extra = REFIT_CASES[case]
    X, y, w = _data(kind=kind)
    X2, y2, w2 = _data(1500, seed=5, kind=kind)
    params = _params(kind, **extra)
    jb = jlgb.train(params, jlgb.Dataset(X, label=y, weight=w), 4)
    tb = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=w),
                    4)
    jb._gbdt._sync_model()
    old = _leaves(tb)
    jb.refit(X2, y2, weight=w2)
    tb.refit(X2, y2, weight=w2)
    for a, b in zip(jb._gbdt.models_, tb._gbdt.models_):
        nl = a.num_leaves
        np.testing.assert_array_equal(a.split_feature[:nl - 1],
                                      b.split_feature[:nl - 1])
        np.testing.assert_allclose(b.leaf_value[:nl], a.leaf_value[:nl],
                                   rtol=TRAINED_REL, atol=1e-9)
        np.testing.assert_array_equal(b.leaf_count[:nl], a.leaf_count[:nl])
    want = _plain_refit(tb, X2, y2, w2, old)
    for got, exp in zip(_leaves(tb), want):
        np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-14)


def test_refit_drops_the_predictor_caches_even_when_it_raises():
    text = _text("binary")
    X2, y2, _ = _data(500, seed=5)
    tb = tlgb.Booster(model_str=text, params=CPU)
    before = tb.predict(X2)
    tb.refit(X2, y2)
    assert not np.array_equal(tb.predict(X2), before)
    g = tb._gbdt
    count = g._model_mutations
    get = g.objective.get_gradients
    calls = []

    def second_raises(*args):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("gradients failed")
        return get(*args)
    g.objective.get_gradients = second_raises
    mid = tb.predict(X2)
    with pytest.raises(RuntimeError, match="gradients failed"):
        tb.refit(X2, y2)
    # the first iteration's trees were refitted: the prediction moves
    assert g._model_mutations == count + 1
    assert not np.array_equal(tb.predict(X2), mid)


# ---------------------------------------------------------- contributions
CONTRIB_CASES = {
    "binary": ("binary", {}),
    "multiclass": ("multiclass", {"min_data_in_leaf": 1}),
    "categorical": ("binary", {"categorical_feature": [4]}),
    "nan": ("regression", {"nan": 0.05}),
    "rf": ("binary", {"boosting": "rf", "bagging_fraction": 0.632,
                      "bagging_freq": 1}),
    "linear": ("regression", {"linear_tree": True, "nan": 0.05}),
}


def _jax_booster(kind, rounds=4, **extra):
    X, y, w = _data(kind=kind, nan=extra.pop("nan", 0.0),
                    cat="categorical_feature" in extra)
    ds_kw = ({"categorical_feature": extra.pop("categorical_feature")}
             if "categorical_feature" in extra else {})
    b = jlgb.train(_params(kind, **extra),
                   jlgb.Dataset(X, label=y, weight=w, **ds_kw), rounds)
    b._gbdt._sync_model()
    return b


@pytest.fixture(scope="module")
def jax_boosters():
    """The JAX package's trained boosters: its TreeSHAP reads the training
    data's feature count and sizes its scratch from the trees' leaf
    depths, which a booster read from model text lacks.  The port reads
    their model text, every number of which it gets back exactly."""
    return {case: _jax_booster(kind, **dict(extra))
            for case, (kind, extra) in CONTRIB_CASES.items()}


def _contrib_pair(jb, X, **kw):
    tb = tlgb.Booster(model_str=jb.model_to_string(), params=CPU)
    return (tb, jb.predict(X, pred_contrib=True, **kw),
            tb.predict(X, pred_contrib=True, **kw))


@pytest.mark.parametrize("case", list(CONTRIB_CASES))
def test_contrib_equals_jax(jax_boosters, case):
    kind, extra = CONTRIB_CASES[case]
    X, _, _ = _data(300, seed=9, kind=kind, nan=extra.get("nan", 0.0),
                    cat="categorical_feature" in extra)
    tb, cj, ct = _contrib_pair(jax_boosters[case], X)
    K = 3 if kind == "multiclass" else 1
    assert ct.shape == (300, K * (F + 1))
    np.testing.assert_allclose(ct, cj, rtol=1e-12, atol=1e-15)
    per_class = ct.reshape(300, K, F + 1)
    total = per_class.sum(2)
    scale = np.abs(per_class).sum(2)
    if case == "linear":
        # the contributions explain the constant leaf values (the JAX
        # package's divergence): they sum to the trees' leaf_value sums
        const = sum(t.leaf_value[t.get_leaf_index(X)]
                    for t in tb._gbdt.models_)
        assert (np.abs(total[:, 0] - const) <= 1e-9 * scale[:, 0]).all()
        raw = tb.predict(X, raw_score=True)
        assert np.abs(total[:, 0] - raw).max() > 1e-3
        return
    raw = tb.predict(X, raw_score=True).reshape(300, K)
    assert (np.abs(total - raw) <= 1e-9 * scale).all()


def test_contrib_iteration_slices_equal_jax(jax_boosters):
    X, _, _ = _data(200, seed=9)
    for kw in ({"start_iteration": 1}, {"num_iteration": 2},
               {"start_iteration": 1, "num_iteration": 2}):
        tb, cj, ct = _contrib_pair(jax_boosters["binary"], X, **kw)
        np.testing.assert_allclose(ct, cj, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(ct.sum(1), tb.predict(
            X, raw_score=True, **kw), rtol=1e-9, atol=1e-12)


def test_contrib_sparse_input_returns_csr(jax_boosters):
    X, _, _ = _data(256, seed=9)
    Xs = np.where(np.abs(X) > 0.8, X, 0.0)
    jb = jax_boosters["binary"]
    tb, cj, ct = _contrib_pair(jb, Xs)
    out = tb.predict(sps.csr_matrix(Xs), pred_contrib=True)
    assert sps.isspmatrix_csr(out)
    np.testing.assert_array_equal(out.toarray(), ct)
    jout = jb.predict(sps.csr_matrix(Xs), pred_contrib=True)
    np.testing.assert_allclose(out.toarray(), jout.toarray(), rtol=1e-12,
                               atol=1e-15)
    empty = tb.predict(sps.csr_matrix((0, F)), pred_contrib=True)
    assert sps.issparse(empty) and empty.shape == (0, F + 1)


def test_contrib_of_trained_booster_equals_loaded():
    X, y, w = _data()
    b = tlgb.train({**_params("binary"), **CPU},
                   tlgb.Dataset(X, label=y, weight=w), 4)
    loaded = tlgb.Booster(model_str=b.model_to_string(), params=CPU)
    np.testing.assert_array_equal(b.predict(X[:50], pred_contrib=True),
                                  loaded.predict(X[:50], pred_contrib=True))


def test_contrib_matches_brute_force_shapley():
    """tests/test_shap.py's check: on a 4-leaf tree of 2 features, TreeSHAP
    equals the exact Shapley values under the tree's path weights."""
    rng = np.random.RandomState(2)
    X = rng.rand(800, 2)
    y = 1.0 * (X[:, 0] > 0.5) + 2.0 * (X[:, 1] > 0.5)
    b = tlgb.train({"objective": "regression", "num_leaves": 4,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "learning_rate": 1.0, "boost_from_average": False,
                    **CPU}, tlgb.Dataset(X, label=y), 1)
    tree = b._gbdt.models_[0]

    def cond_exp(x, S):
        def rec(node, w):
            if node < 0:
                return w * tree.leaf_value[~node]
            f = tree.split_feature[node]
            lc, rc = tree.left_child[node], tree.right_child[node]
            if f in S:
                return rec(lc if x[f] <= tree.threshold[node] else rc, w)
            cl = tree.leaf_count[~lc] if lc < 0 else tree.internal_count[lc]
            cr = tree.leaf_count[~rc] if rc < 0 else tree.internal_count[rc]
            return rec(lc, w * cl / (cl + cr)) + rec(rc, w * cr / (cl + cr))
        return rec(0, 1.0)

    xs = X[:5]
    contrib = b.predict(xs, pred_contrib=True)
    for r, x in enumerate(xs):
        for j in range(2):
            others = [f for f in range(2) if f != j]
            phi = 0.0
            for k in range(len(others) + 1):
                for S in itertools.combinations(others, k):
                    wgt = (math.factorial(len(S))
                           * math.factorial(2 - len(S) - 1) / math.factorial(2))
                    phi += wgt * (cond_exp(x, set(S) | {j})
                                  - cond_exp(x, set(S)))
            np.testing.assert_allclose(contrib[r, j], phi, rtol=1e-6,
                                       atol=1e-9)
        np.testing.assert_allclose(contrib[r, -1], cond_exp(x, set()),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", ["categorical", "nan"])
def test_native_equals_python_fallback(jax_boosters, case):
    assert native.treeshap_lib() is not None
    kind, extra = CONTRIB_CASES[case]
    X, _, _ = _data(16, seed=9, kind=kind, nan=extra.get("nan", 0.0),
                    cat="categorical_feature" in extra)
    tb = tlgb.Booster(model_str=jax_boosters[case].model_to_string(),
                      params=CPU)
    for tree in tb._gbdt.models_[:2]:
        a = np.zeros((16, F + 1))
        b = np.zeros((16, F + 1))
        calls = dict(native.TREESHAP_CALLS)
        native.tree_shap(tree, X, a)
        assert native.TREESHAP_CALLS["native"] == calls["native"] + 1
        native._tree_shap_py(tree, X, b)
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
