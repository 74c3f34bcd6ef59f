"""PyTorch port: linear trees (`linear_tree=true`) against the JAX
package, on the CPU.

Data: 2,000 x 5 rows made from a seed, 3% of them NaN, with random row
weights (so that no split ties exactly) and a piecewise-linear label;
a 1,000-row valid set.  Both packages grow 15 leaves on 63 bins for 4
rounds on the wave engine (`tpu_growth_strategy=wave` in both) or the
leaf-wise engine.

* The fit alone: given one tree, its rows' leaves and gradients, the
  port's device fit (`learner/linear.py fit_linear`, torch on the CPU),
  its plain version `calculate_linear_plain` and the JAX booster's
  `_calculate_linear` give each row the same leaf output within
  FIT_REL · max(1, |output|); the plain version equals the JAX loop bit
  for bit.  Cases: linear_lambda 0 and 1, a singular leaf (a branch
  feature constant in it: the pseudo-inverse) and a leaf left with too
  few rows (its constant kept).
* Training: the trees' structure equals the JAX package's (split
  features, thresholds, children), each tree's per-row outputs within
  OUT_ATOL + OUT_REL · |output| of the JAX tree's, on both engines, with
  bagging, quantized gradients, monotone constraints, DART, multiclass,
  a valid set and continued training.  The training scores equal the
  host float64 predictions of the trees within float32 rounding.
* RF: the JAX booster never fits linear leaves in RF mode; neither does
  the port.  Model text crosses both ways.  Objectives that renew leaf
  outputs are refused with the JAX package's error.
"""

import copy

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.learner.linear import (calculate_linear_plain,
                                               fit_linear, linear_outputs,
                                               raw_to_device)
from lightgbm_tpu.utils.log import LightGBMError as JaxLightGBMError
from lightgbm_tpu_torch.utils.log import LightGBMError

N, NV, F, ROUNDS = 2000, 1000, 5, 4
BASE = {"objective": "regression", "num_leaves": 15, "max_bin": 63,
        "learning_rate": 0.3, "min_data_in_leaf": 20, "verbosity": -1,
        "linear_tree": True, "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}
# the fits of one tree: float64 products and solves in another order
FIT_REL = 1e-9
# trained trees: their gradients come from float32 scores in which each
# package's leaf sums stray by up to 4e-5 relative (ROADMAP, "JAX's
# float32 leaf values stray from the exact sums")
OUT_REL, OUT_ATOL = 1e-4, 1e-6


def _data(n=N, seed=0, classes=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    X[rng.rand(n, F) < 0.03] = np.nan
    Z = np.nan_to_num(X, nan=0.5)
    y = (np.where(Z[:, 0] > 0.5, 2.0 * Z[:, 1], -1.5 * Z[:, 2])
         + Z[:, 3] * Z[:, 4] + 0.05 * rng.randn(n))
    if classes:
        y = np.digitize(y, np.quantile(y, np.linspace(0, 1, classes + 1)
                                       [1:-1])).astype(np.float64)
    w = 0.5 + np.random.RandomState(100 + seed).rand(n)
    return X, y, w


def _is_num(ds):
    return lambda f: ds.bin_mappers[f].bin_type == 0


def _fit_three(lam, X, hess_of=None):
    """A tree of the JAX package, refitted by the three fits on the same
    leaves and gradients; returns (tree by JAX, by plain, by the port's
    device fit, leaf ids, the fit stats of plain and device)."""
    X, y, w = X
    bj = jlgb.train({**BASE, "tpu_growth_strategy": "leafwise",
                     "linear_lambda": lam}, jlgb.Dataset(X, label=y), 1)
    bj._gbdt._sync_model()
    g_j = bj._gbdt
    tree = g_j.models_[0]
    lid = tree.get_leaf_index(X)
    rng = np.random.RandomState(3)
    grad = rng.randn(len(X)).astype(np.float32)
    hess = (0.2 + rng.rand(len(X))).astype(np.float32)
    if hess_of is not None:
        hess = hess_of(lid, hess)
    ds = g_j.train_data
    t_jax, t_plain, t_dev = (copy.deepcopy(tree) for _ in range(3))
    g_j._calculate_linear(t_jax, lid, grad, hess)
    s_plain = calculate_linear_plain(t_plain, X, lid, grad, hess, lam,
                                     _is_num(ds), ds.inner_feature_index)
    s_dev = fit_linear(t_dev, raw_to_device(X, torch.device("cpu")),
                       torch.from_numpy(lid), torch.from_numpy(grad),
                       torch.from_numpy(hess), lam, _is_num(ds),
                       ds.inner_feature_index)
    return t_jax, t_plain, t_dev, lid, s_plain, s_dev


def _linear_fields(t):
    nl = t.num_leaves
    return (list(t.leaf_const[:nl]), t.leaf_coeff[:nl],
            t.leaf_features[:nl], t.leaf_features_inner[:nl])


def _outputs(tree, X, lid):
    """Each row's output of the tree at its leaf `lid`, evaluated on the
    CPU."""
    return linear_outputs(tree, raw_to_device(X, torch.device("cpu")),
                          torch.from_numpy(lid)).numpy()


def _hold_outputs(t_ref, t_got, X, lid, rel=FIT_REL):
    a, b = _outputs(t_ref, X, lid), _outputs(t_got, X, lid)
    assert (np.abs(a - b) <= rel * np.maximum(1.0, np.abs(a))).all(), (
        np.abs(a - b).max())


@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_fit_equals_plain_and_jax(lam):
    X = _data()
    t_jax, t_plain, t_dev, lid, s_plain, s_dev = _fit_three(lam, X)
    assert _linear_fields(t_plain) == _linear_fields(t_jax)
    _hold_outputs(t_plain, t_dev, X[0], lid)
    assert s_dev.fitted == s_plain.fitted == t_dev.num_leaves
    assert s_dev.mean_k == s_plain.mean_k > 0
    # every leaf takes the same features and keeps a coefficient for each
    assert t_dev.leaf_features[:t_dev.num_leaves] == \
        t_plain.leaf_features[:t_plain.num_leaves]


def test_fit_singular_leaf_takes_the_pseudo_inverse():
    """A branch feature that is constant in a leaf makes its system
    singular: both fits take the pseudo-inverse there."""
    X, y, w = _data()
    X[:, 1] = (X[:, 1] > 0.5).astype(np.float64)       # two values
    y = 3.0 * X[:, 1] + np.nan_to_num(X[:, 0])
    t_jax, t_plain, t_dev, lid, s_plain, s_dev = _fit_three(0.0, (X, y, w))
    assert s_plain.pinv > 0 and s_dev.pinv > 0
    assert _linear_fields(t_plain) == _linear_fields(t_jax)
    _hold_outputs(t_plain, t_dev, X, lid)


def test_fit_leaf_with_too_few_rows_keeps_its_constant():
    def starve(lid, hess):
        hess = hess.copy()
        hess[lid == 0] = 0.0          # no usable row in leaf 0
        hess[np.nonzero(lid == 1)[0][1:]] = 0.0     # one in leaf 1
        return hess
    X = _data()
    t_jax, t_plain, t_dev, lid, s_plain, s_dev = _fit_three(0.0, X, starve)
    assert s_dev.degenerate == s_plain.degenerate == 2
    for t in (t_plain, t_dev):
        for leaf in (0, 1):
            assert t.leaf_features[leaf] == [] and t.leaf_coeff[leaf] == []
            assert t.leaf_const[leaf] == t.leaf_value[leaf]
    assert _linear_fields(t_plain) == _linear_fields(t_jax)
    _hold_outputs(t_plain, t_dev, X[0], lid)


def test_fit_gives_the_same_bits_twice():
    _, _, t1, _, _, _ = _fit_three(1.0, _data())
    _, _, t2, _, _, _ = _fit_three(1.0, _data())
    assert _linear_fields(t1) == _linear_fields(t2)


CASES = {
    "wave": {"tpu_growth_strategy": "wave"},
    "leafwise": {"tpu_growth_strategy": "leafwise"},
    "lambda_bagging": {"tpu_growth_strategy": "wave", "linear_lambda": 0.5,
                       "bagging_fraction": 0.7, "bagging_freq": 1},
    # test_combos.py's quantized_linear, linear_monotone, dart_linear
    "quantized": {"tpu_growth_strategy": "wave",
                  "use_quantized_grad": True},
    "monotone": {"tpu_growth_strategy": "leafwise",
                 "monotone_constraints": [1, 0, 0, 0, 0]},
    "dart": {"tpu_growth_strategy": "wave", "boosting": "dart",
             "drop_rate": 0.3, "skip_drop": 0.2},
    "multiclass": {"tpu_growth_strategy": "leafwise",
                   "objective": "multiclass", "num_class": 3,
                   "min_data_in_leaf": 1, "num_leaves": 7},
}


def _reach(tree, X, node):
    """The rows of X that reach the node."""
    at = np.zeros(len(X), np.int64)
    reached = np.zeros(len(X), bool)
    for _ in range(tree.num_leaves):
        inside = at >= 0
        reached |= at == node
        if not inside.any():
            break
        nodes = at[inside]
        left = tree._decision(X[np.nonzero(inside)[0],
                                tree.split_feature[nodes]], nodes)
        at[inside] = np.where(left, tree.left_child[nodes],
                              tree.right_child[nodes])
    return reached


def _same_trees(ja, tb, X):
    """Equal structure up to exact ties the packages break by float32
    noise: a node's threshold may differ where no row reaching it lies
    between the two (the same partition), and its default direction
    where no row reaching it has NaN in its feature (ROADMAP, "A NaN
    bin's default direction often ties")."""
    assert len(ja) == len(tb)
    for i, (a, b) in enumerate(zip(ja, tb)):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni], err_msg=k)
        for j in range(ni):
            if (a.threshold[j], a.decision_type[j]) == (
                    b.threshold[j], b.decision_type[j]):
                continue
            x = X[_reach(a, X, j), a.split_feature[j]]
            lo, hi = sorted((a.threshold[j], b.threshold[j]))
            assert not ((x > lo) & (x <= hi)).any(), ("threshold", i, j)
            if a.decision_type[j] != b.decision_type[j]:
                assert a.decision_type[j] ^ b.decision_type[j] == 2, (i, j)
                assert not np.isnan(x).any(), ("default_left", i, j)
        assert a.is_linear == b.is_linear
        pa, pb = a.predict(X), b.predict(X)
        assert (np.abs(pa - pb) <= OUT_ATOL + OUT_REL * np.abs(pa)).all(), (
            i, np.abs(pa - pb).max())


@pytest.fixture(scope="module")
def run():
    cache = {}

    def _run(case):
        if case not in cache:
            extra = CASES[case]
            X, y, w = _data(classes=extra.get("num_class", 0))
            Xv, yv, _ = _data(NV, seed=1, classes=extra.get("num_class", 0))
            bj = jlgb.train({**BASE, **extra},
                            jlgb.Dataset(X, label=y, weight=w), ROUNDS)
            bj._gbdt._sync_model()
            # the JAX package scores a valid set on the values its bins
            # reconstruct, +inf in a feature's last bin (its metrics turn
            # NaN): the port's valid set is held to its own predictions
            hist = {}
            bt = tlgb.train({**BASE, **extra, **CPU},
                            tlgb.Dataset(X, label=y, weight=w), ROUNDS,
                            valid_sets=[tlgb.Dataset(Xv, label=yv)],
                            callbacks=[tlgb.record_evaluation(hist)])
            cache[case] = bj, bt, hist["valid_0"]
        return cache[case]
    return _run


@pytest.mark.parametrize("case", list(CASES))
def test_linear_training_equals_jax(run, case):
    bj, bt, hist = run(case)
    classes = CASES[case].get("num_class", 0)
    X, _, _ = _data(classes=classes)
    ja, tb = bj._gbdt.models_, bt._gbdt.models_
    _same_trees(ja, tb, X)
    assert all(t.is_linear for t in tb)
    assert sum(len(f) for t in tb for f in t.leaf_features) > 0
    pj, pt = bj.predict(X, raw_score=True), bt.predict(X, raw_score=True)
    np.testing.assert_allclose(pt, pj, rtol=OUT_REL,
                               atol=OUT_ATOL * len(tb))
    # the recorded valid metric is the host metric of the trees'
    # predictions on the valid rows
    Xv, yv, _ = _data(NV, seed=1, classes=classes)
    yv = yv.astype(np.float32).astype(np.float64)     # the metric's labels
    (metric, values), = hist.items()
    # (DART re-weights earlier trees: only its last value is the trees')
    for i in ((ROUNDS - 1,) if "boosting" in CASES[case] else (0, ROUNDS - 1)):
        p = bt.predict(Xv, num_iteration=i + 1)
        want = (np.mean((p - yv) ** 2) if metric == "l2" else
                -np.mean(np.log(p[np.arange(len(yv)), yv.astype(int)])))
        assert np.isfinite(values[i])
        np.testing.assert_allclose(values[i], want, rtol=1e-9)


@pytest.mark.parametrize("case", ["wave", "quantized", "multiclass"])
def test_training_scores_equal_host_predictions(run, case):
    """The card-side update (const + coeff · x at the grown leaf, float64
    rounded once) gives what the host trees predict on the raw rows."""
    _, bt, _ = run(case)
    g = bt._gbdt
    X, _, _ = _data(classes=CASES[case].get("num_class", 0))
    K = g.num_tree_per_iteration
    host = g._predict_raw_impl(X, 0, -1, False, 10, 10.0)
    host = host.reshape(N, K).T
    scores = g.scores[:, :N].numpy().astype(np.float64)
    bound = 2 * ROUNDS * 2.0 ** -24 * (np.abs(host) + 1.0)
    assert (np.abs(scores - host) <= bound).all()


def test_valid_scores_follow_the_linear_trees(run):
    """The float64 valid scores are the trees' host predictions on the
    valid set's raw rows, which it keeps under linear_tree."""
    _, bt, _ = run("wave")
    g = bt._gbdt
    Xv, _, _ = _data(NV, seed=1)
    np.testing.assert_array_equal(g._valid_raw[0], Xv)
    np.testing.assert_allclose(g.valid_scores[0][0],
                               g._predict_raw_impl(Xv, 0, -1, False, 10,
                                                   10.0),
                               rtol=0, atol=1e-12)


def test_rf_fits_no_linear_leaves():
    X, y, w = _data()
    params = {**BASE, "boosting": "rf", "bagging_fraction": 0.632,
              "bagging_freq": 1, "tpu_growth_strategy": "wave"}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=w), 3)
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=w),
                    3)
    bj._gbdt._sync_model()
    assert not any(t.is_linear for t in bj._gbdt.models_)
    _same_trees(bj._gbdt.models_, bt._gbdt.models_, X)


def test_continued_training_from_a_linear_model():
    X, y, w = _data()
    params = {**BASE, "tpu_growth_strategy": "wave"}
    text = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=w),
                      2).model_to_string()
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=w), 2,
                    init_model=jlgb.Booster(model_str=text))
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=w), 2,
                    init_model=text)
    bj._gbdt._sync_model()
    assert bt.num_trees() == 4
    _same_trees(bj._gbdt.models_[2:], bt._gbdt.models_[2:], X)


def test_linear_model_text_crosses_both_ways(run):
    bj, bt, _ = run("leafwise")
    X, _, _ = _data()
    text_t = bt.model_to_string()
    assert "is_linear=1" in text_t and "leaf_coeff=" in text_t
    want = bt.predict(X)
    np.testing.assert_array_equal(
        tlgb.Booster(model_str=text_t, params=CPU).predict(X), want)
    np.testing.assert_allclose(jlgb.Booster(model_str=text_t).predict(X),
                               want, rtol=1e-12, atol=1e-12)
    text_j = bj.model_to_string()
    np.testing.assert_allclose(
        tlgb.Booster(model_str=text_j, params=CPU).predict(X),
        jlgb.Booster(model_str=text_j).predict(X), rtol=1e-12, atol=1e-12)


def test_linear_tree_beats_constant_leaves():
    """tests/test_linear_tree.py's case on the port."""
    rng = np.random.RandomState(9)
    X = rng.rand(3000, 3)
    y = (np.where(X[:, 0] > 0.5, 2.0 * X[:, 1], -1.5 * X[:, 1])
         + 0.05 * rng.randn(3000))
    base = {"objective": "regression", "num_leaves": 4, "verbosity": -1,
            "min_data_in_leaf": 20, "learning_rate": 0.5, **CPU}
    mse = {}
    for lin in (False, True):
        b = tlgb.train({**base, "linear_tree": lin},
                       tlgb.Dataset(X, label=y), 8)
        mse[lin] = float(np.mean((b.predict(X) - y) ** 2))
    assert mse[True] < 0.5 * mse[False], mse


@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_renewal_objectives_refuse(objective):
    X, y, _ = _data(500)
    for pkg, extra, err in ((jlgb, {}, JaxLightGBMError),
                            (tlgb, CPU, LightGBMError)):
        with pytest.raises(err, match="with linear_tree"):
            pkg.train({**BASE, "objective": objective, **extra},
                      pkg.Dataset(np.abs(X), label=np.abs(y) + 1), 1)
