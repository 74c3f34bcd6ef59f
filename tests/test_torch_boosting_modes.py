"""PyTorch port: the boosting modes RF and DART against the JAX package,
on the CPU.

Data: 3,000 x 6 rows made from a seed with random row weights (so that
no split ties exactly), a binary, a regression and a 3-class label, and
a 1,500-row valid set.  Both packages train 6 rounds at 15 leaves and 63
bins on the wave engine (`tpu_growth_strategy=wave` in both) or the
leaf-wise engine.

* DART (drop_rate 0.3, skip_drop 0.2): weighted drops, uniform_drop and
  xgboost_dart_mode, binary and multiclass.  The trees each iteration
  drops equal the JAX package's (both draw from RandomState(drop_seed)
  in the same order), and so does the normalization's bookkeeping.
* RF: bagging 0.632 every iteration with feature_fraction 0.8, binary;
  regression_l1 on the leaf-wise engine (the renewal against the
  constant init score); feature_fraction alone; multiclass.
* Trees: equal split features and thresholds, leaf values within rtol
  1e-4 plus atol 1e-6.  Raw predictions within the leaf-value bound of
  tests/test_torch_valid.py (LEAF_REL x the row's summed |leaf value|),
  the valid sets' recorded metrics within 1e-4 relative of the JAX
  package's, and model text that reloads to the same predictions in
  both packages (RF's `average_output` included).
* RF's fatals: GOSS, no bagging, a custom objective, init_score.
The multiclass cases take min_data_in_leaf 1: the scan estimates a
child's rows as RoundInt(hess x rows / sum_hess), and with multiclass
hessians p(1 - p) that estimate can sit at the min_data_in_leaf bound,
where the JAX package's float32 sums and the port's exact ones round to
either side (ROADMAP "Divergences of the reference").
"""

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.utils.log import LightGBMError

N, NV, F, K = 3000, 1500, 6, 3
ROUNDS = 6
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}
LEAF_REL = 4e-5 + 1.3e-5        # tests/test_torch_valid.py
DART = {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.2}
BAG = {"bagging_fraction": 0.632, "bagging_freq": 1,
       "feature_fraction": 0.8}
CASES = {
    "dart_binary": ("binary", {**DART}),
    "dart_uniform": ("binary", {**DART, "uniform_drop": True}),
    "dart_xgboost": ("binary", {**DART, "xgboost_dart_mode": True,
                                "max_drop": 2}),
    "dart_multiclass": ("multiclass", {**DART, "min_data_in_leaf": 1}),
    "dart_l1_leafwise": ("regression_l1", {**DART,
                                           "tpu_growth_strategy":
                                           "leafwise"}),
    "rf_binary": ("binary", {"boosting": "rf", **BAG}),
    "rf_l1_leafwise": ("regression_l1", {"boosting": "rf", **BAG,
                                         "tpu_growth_strategy":
                                         "leafwise"}),
    "rf_feature_fraction": ("regression", {"boosting": "rf",
                                           "feature_fraction": 0.6}),
    "rf_multiclass": ("multiclass", {"boosting": "rf", **BAG,
                                     "min_data_in_leaf": 1}),
}


def _data(objective, n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    sig = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    if objective == "multiclass":
        y = np.digitize(sig + rng.logistic(size=n), [-1.0, 1.0])
    elif objective == "binary":
        y = rng.rand(n) < 1 / (1 + np.exp(-sig))
    else:
        y = sig + 0.5 * rng.randn(n)
    wt = (0.5 + np.random.RandomState(100 + seed).rand(n)).astype(np.float32)
    return X, y.astype(np.float32), wt


def _drops(store):
    def _cb(env):
        store.append(list(getattr(env.model._gbdt, "drop_index_", [])))
    _cb.order = 30
    return _cb


def _run(case):
    """Both packages' boosters of a case:
    (bj, bt, drops_j, drops_t, hist_j, hist_t)."""
    objective, extra = CASES[case]
    X, y, wt = _data(objective)
    Xv, yv, _ = _data(objective, NV, seed=1)
    params = {**BASE, "objective": objective, "tpu_growth_strategy": "wave",
              **extra}
    if objective == "multiclass":
        params["num_class"] = K
    out = []
    for pkg, extra_p in ((jlgb, {}), (tlgb, CPU)):
        drops, hist = [], {}
        b = pkg.train({**params, **extra_p},
                      pkg.Dataset(X, label=y, weight=wt), ROUNDS,
                      valid_sets=[pkg.Dataset(Xv, label=yv)],
                      callbacks=[_drops(drops),
                                 pkg.record_evaluation(hist)])
        out.append((b, drops, hist["valid_0"]))
    (bj, dj, hj), (bt, dt, ht) = out
    bj._gbdt._sync_model()
    return bj, bt, dj, dt, hj, ht


@pytest.fixture(scope="module")
def run():
    """run(case): `_run(case)`, trained once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run(case)
        return cache[case]
    return get


def _row_bound(b, X):
    g = b._gbdt
    Kc = g.num_tree_per_iteration
    leaves = b.predict(X, pred_leaf=True)
    out = np.zeros((len(X), Kc))
    for t in range(leaves.shape[1]):
        out[:, t % Kc] += np.abs(g.models_[t].leaf_value[leaves[:, t]])
    if g.average_output_:
        out /= leaves.shape[1] // Kc
    out *= LEAF_REL
    return out[:, 0] if Kc == 1 else out


@pytest.mark.parametrize("case", list(CASES))
def test_mode_trains_like_jax(run, case):
    bj, bt, dj, dt, hj, ht = run(case)
    objective, extra = CASES[case]
    gt = bt._gbdt
    assert type(gt).__name__ == type(bj._gbdt).__name__
    assert gt.average_output_ == bj._gbdt.average_output_ == (
        extra["boosting"] == "rf")
    if extra["boosting"] == "dart":
        # the same trees dropped in every iteration, some of them
        assert dt == dj
        assert sum(map(len, dt)) > 0
        assert np.allclose(gt.tree_weight_, bj._gbdt.tree_weight_,
                           rtol=1e-12)
    ja, tb = bj._gbdt.models_, gt.models_
    assert len(ja) == len(tb) == ROUNDS * gt.num_tree_per_iteration
    for i, (a, b) in enumerate(zip(ja, tb)):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      b.split_feature[:ni])
        np.testing.assert_array_equal(a.threshold[:ni], b.threshold[:ni])
        np.testing.assert_allclose(b.leaf_value[:ni + 1],
                                   a.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-6)
    X, _, _ = _data(objective)
    Xv, _, _ = _data(objective, NV, seed=1)
    for Xs in (X, Xv):
        rj = bj.predict(Xs, raw_score=True)
        rt = bt.predict(Xs, raw_score=True)
        assert (np.abs(rt - rj) <= _row_bound(bj, Xs) + 1e-12).all()
    # the valid scores follow the drops, normalizations and averages
    for metric in hj:
        np.testing.assert_allclose(ht[metric], hj[metric], rtol=1e-4)


@pytest.mark.parametrize("case", ["dart_binary", "rf_binary",
                                  "rf_multiclass"])
def test_mode_model_text_round_trips(run, case):
    bj, bt, _, _, _, _ = run(case)
    objective, _ = CASES[case]
    Xv, _, _ = _data(objective, NV, seed=1)
    text = bt.model_to_string()
    assert ("average_output" in text.splitlines()) == (
        bt._gbdt.average_output_)
    want = bt.predict(Xv)
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(Xv),
                               want, rtol=1e-12, atol=1e-300)
    np.testing.assert_array_equal(
        tlgb.Booster(model_str=text, params=CPU).predict(Xv), want)


def test_dart_valid_scores_follow_the_trees(run):
    """After drops and normalizations the float64 valid scores equal the
    host predictions of the re-weighted trees."""
    bj, bt, _, _, _, _ = run("dart_multiclass")
    g = bt._gbdt
    Xv, _, _ = _data("multiclass", NV, seed=1)
    np.testing.assert_allclose(g.valid_scores[0].T,
                               g._predict_raw_impl(Xv, 0, -1, False, 10,
                                                   10.0),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["dart_binary", "rf_binary"])
def test_mode_continues_like_jax(case):
    """`init_model` continues a DART or RF model from its text: the
    adopted trees are never dropped (DART), the averages carry on (RF),
    and both packages grow the same trees."""
    objective, extra = CASES[case]
    X, y, wt = _data(objective)
    params = {**BASE, "objective": objective, "tpu_growth_strategy": "wave",
              **extra}
    text = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y,
                                                      weight=wt),
                      3).model_to_string()
    out = []
    for pkg, extra_p in ((jlgb, {}), (tlgb, CPU)):
        drops = []
        # the JAX package takes a Booster, the port the text itself
        init = text if pkg is tlgb else jlgb.Booster(model_str=text)
        b = pkg.train({**params, **extra_p},
                      pkg.Dataset(X, label=y, weight=wt), 3,
                      init_model=init, callbacks=[_drops(drops)])
        if pkg is jlgb:
            b._gbdt._sync_model()
        out.append((b, drops))
    (bj, dj), (bt, dt) = out
    assert dt == dj
    assert all(i >= 3 for d in dt for i in d)
    assert bt.num_trees() == bj.num_trees() == 6
    for a, b in zip(bj._gbdt.models_[3:], bt._gbdt.models_[3:]):
        ni = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      b.split_feature[:ni])
        np.testing.assert_array_equal(a.threshold[:ni], b.threshold[:ni])
        np.testing.assert_allclose(b.leaf_value[:ni + 1],
                                   a.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-6)
    rj, rt = bj.predict(X, raw_score=True), bt.predict(X, raw_score=True)
    assert (np.abs(rt - rj) <= _row_bound(bj, X) + 1e-12).all()


@pytest.mark.parametrize("extra,message", [
    ({"data_sample_strategy": "goss"},
     "RF mode does not support data_sample_strategy=goss"),
    ({"bagging_fraction": 1.0, "feature_fraction": 1.0},
     "RF mode requires bagging"),
    ({"objective": "none"},
     "RF mode does not support custom objective functions"),
    ({"init_score": True}, "RF mode does not support init_score")])
def test_rf_fatals(extra, message):
    X, y, _ = _data("binary", 1000)
    extra = dict(extra)
    init = np.zeros(len(y)) if extra.pop("init_score", False) else None
    params = {**BASE, "objective": "binary", "boosting": "rf", **BAG,
              **extra}
    for pkg, extra_p in ((jlgb, {}), (tlgb, CPU)):
        with pytest.raises(Exception, match=message) as e:
            pkg.train({**params, **extra_p},
                      pkg.Dataset(X, label=y, init_score=init), 2)
        if pkg is tlgb:
            assert isinstance(e.value, LightGBMError)
