"""PyTorch port: the scikit-learn estimators against the JAX package's, on
the CPU (the cases of `tests/test_sklearn.py` rewritten against the
port).

The port's estimators take `device_type="cpu"`; both packages' take
`tpu_growth_strategy="wave"` where trees are compared.  The binary case
is the setup of `tests/test_torch_train.py` (4,096 x 8, 31 leaves, 63
bins); the multiclass and regression cases train weighted rows so that
no two splits tie exactly (ROADMAP "Divergences": discrete gradients tie
across features).  Tolerances: the same split features, thresholds,
decision types, children and leaf counts; leaf values within 1e-5; raw
scores within LEAF_REL x the row's summed |leaf value| (the bound of
`tests/test_torch_valid.py`: the JAX package's float32 leaf sums stray
from the exact ones), probabilities within that bound too (the sigmoid's
and softmax's slopes are at most 1); split importances equal exactly;
the regressor's recorded valid l2 within 1e-4 relative (each row's
score within that bound moves its squared error by far less).
`LGBMRanker` is held in tests/test_torch_ranking.py.
"""

import copy
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 4096, 8
WAVE = {"tpu_growth_strategy": "wave"}
CPU = {"device_type": "cpu"}
LEAF_ATOL = 1e-5
LEAF_REL = 4e-5 + 1.3e-5        # tests/test_torch_valid.py


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    sig = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    y = (rng.rand(n) < 1 / (1 + np.exp(-sig))).astype(np.float32)
    return X, y, sig, rng


def _weight(n=N):
    return (0.5 + np.random.RandomState(100).rand(n)).astype(np.float32)


def _cls_data(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(int)
    return X, y


def _same_trees(bj, bt):
    bj._gbdt._sync_model()
    tj, tt = bj._gbdt.models_, bt._gbdt.models_
    assert len(tj) == len(tt) > 0
    for i, (a, b) in enumerate(zip(tj, tt)):
        assert a.num_leaves == b.num_leaves, i
        ni = a.num_leaves - 1
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni],
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_array_equal(a.leaf_count[:ni + 1],
                                      b.leaf_count[:ni + 1])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   b.leaf_value[:ni + 1], rtol=0,
                                   atol=LEAF_ATOL)


def _leaf_bound(bt, X):
    """LEAF_REL x the summed |leaf value| of each row, per class."""
    g = bt._gbdt
    K = g.num_tree_per_iteration
    leaf = bt.predict(X, pred_leaf=True)
    out = np.zeros((len(X), K))
    for t in range(leaf.shape[1]):      # the trees predict reads
        out[:, t % K] += np.abs(g.models_[t].leaf_value[leaf[:, t]])
    return LEAF_REL * (out[:, 0] if K == 1 else out)


def _pair(cls, **kw):
    """The same estimator of both packages, fitted on the same call."""
    est = []
    for pkg, extra in ((jlgb, {}), (tlgb, CPU)):
        est.append(getattr(pkg, cls)(**WAVE, **kw, **extra))
    return est


# --------------------------------------------------- against the JAX one
def test_classifier_binary_equals_jax():
    X, y, _, _ = _data()
    ej, et = _pair("LGBMClassifier", n_estimators=5, num_leaves=31,
                   max_bin=63)
    ej.fit(X, y.astype(int))
    et.fit(X, y.astype(int))
    assert et.n_features_ == 8 and list(et.classes_) == [0, 1]
    _same_trees(ej.booster_, et.booster_)
    bound = _leaf_bound(et.booster_, X)
    pt, pj = et.predict_proba(X), ej.predict_proba(X)
    assert pt.shape == (N, 2)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=1e-12)
    assert (np.abs(pt[:, 1] - pj[:, 1]) <= bound).all()
    assert (np.abs(et.predict(X, raw_score=True)
                   - ej.predict(X, raw_score=True)) <= bound).all()
    clear = np.abs(pj[:, 1] - 0.5) > bound
    np.testing.assert_array_equal(et.predict(X)[clear], ej.predict(X)[clear])
    np.testing.assert_array_equal(et.feature_importances_,
                                  ej.feature_importances_)
    assert et.feature_name_ == ej.feature_name_


def test_classifier_multiclass_equals_jax():
    X, _, sig, rng = _data()
    y = np.digitize(sig + rng.logistic(size=N), [-1.0, 1.0])
    ej, et = _pair("LGBMClassifier", n_estimators=3, num_leaves=15,
                   max_bin=63)
    ej.fit(X, y, sample_weight=_weight())
    et.fit(X, y, sample_weight=_weight())
    assert et.n_classes_ == 3 and et.objective_ == "multiclass"
    _same_trees(ej.booster_, et.booster_)
    pt, pj = et.predict_proba(X), ej.predict_proba(X)
    assert pt.shape == (N, 3)
    np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=1e-6)
    bound = _leaf_bound(et.booster_, X).sum(axis=1, keepdims=True)
    assert (np.abs(pt - pj) <= bound).all()


def test_regressor_eval_set_and_early_stopping_equal_jax():
    X, _, sig, rng = _data()
    y = (sig + 0.5 * rng.randn(N)).astype(np.float32)
    ej, et = _pair("LGBMRegressor", n_estimators=60, num_leaves=15,
                   max_bin=63, learning_rate=0.3, early_stopping_round=3)
    for est in (ej, et):
        est.fit(X[:3000], y[:3000], sample_weight=_weight(3000),
                eval_set=[(X[3000:], y[3000:])])
    assert 0 < et.best_iteration_ == ej.best_iteration_ < 60
    assert et.n_estimators_ == ej.n_estimators_
    _same_trees(ej.booster_, et.booster_)
    bound = _leaf_bound(et.booster_, X[3000:])
    assert (np.abs(et.predict(X[3000:]) - ej.predict(X[3000:]))
            <= bound).all()
    lt = et.evals_result_["valid_0"]["l2"]
    lj = ej.evals_result_["valid_0"]["l2"]
    assert len(lt) == len(lj)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


# ------------------------------------------------------------ the port
def test_classifier_string_labels():
    X, y = _cls_data(800)
    labels = np.array(["neg", "pos"])[y]
    clf = tlgb.LGBMClassifier(n_estimators=10, num_leaves=7, **CPU)
    clf.fit(X, labels)
    num = tlgb.LGBMClassifier(n_estimators=10, num_leaves=7, **CPU)
    num.fit(X, y)
    assert list(clf.classes_) == ["neg", "pos"]
    np.testing.assert_array_equal(clf.predict(X),
                                  np.array(["neg", "pos"])[num.predict(X)])
    assert float(np.mean(clf.predict(X) == labels)) > 0.85


def test_regressor_sklearn_params_round_trip():
    reg = tlgb.LGBMRegressor(num_leaves=63, learning_rate=0.05,
                             min_child_samples=7, reg_lambda=0.5, **CPU)
    params = reg.get_params()
    assert params["num_leaves"] == 63 and params["reg_lambda"] == 0.5
    assert params["device_type"] == "cpu"
    reg.set_params(num_leaves=31)
    assert reg.get_params()["num_leaves"] == 31


def test_sklearn_clone_and_cross_val_score():
    from sklearn.base import clone
    from sklearn.model_selection import cross_val_score
    X, y = _cls_data(900)
    clf = tlgb.LGBMClassifier(n_estimators=5, num_leaves=7, **CPU)
    clf2 = clone(clf)
    assert clf2.get_params() == clf.get_params()
    scores = cross_val_score(clf, X, y, cv=2)
    assert scores.mean() > 0.8, scores


def test_feature_importances():
    X, y = _cls_data()
    clf = tlgb.LGBMClassifier(n_estimators=10, num_leaves=15, **CPU)
    imp = clf.fit(X, y).feature_importances_
    assert imp.shape == (6,)
    assert imp[:3].sum() > imp[3:].sum()
    np.testing.assert_array_equal(imp,
                                  clf.booster_.feature_importance("split"))


def test_pickle_and_copy_round_trip():
    """Estimators and their boosters pickle through the model text and
    predict bit for bit after it."""
    X, y = _cls_data(800)
    clf = tlgb.LGBMClassifier(n_estimators=8, num_leaves=7, **CPU).fit(X, y)
    for other in (pickle.loads(pickle.dumps(clf)), copy.deepcopy(clf)):
        np.testing.assert_array_equal(other.predict(X), clf.predict(X))
        np.testing.assert_array_equal(other.predict_proba(X),
                                      clf.predict_proba(X))
        assert other.booster_._gbdt.device.type == "cpu"
    b = clf.booster_
    b2 = pickle.loads(pickle.dumps(b))
    np.testing.assert_array_equal(b2.predict(X), b.predict(X))


def test_estimator_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _cls_data(300)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlgb.LGBMClassifier(n_estimators=2, num_leaves=7).fit(X, y)


def test_sklearn_fit_params_and_attributes():
    rng = np.random.RandomState(0)
    X = rng.rand(500, 4)
    y = X[:, 0] + 0.2 * rng.randn(500)
    reg = tlgb.LGBMRegressor(n_estimators=6, num_leaves=7,
                             min_child_samples=5, **CPU)
    reg.fit(X, y, eval_set=[(X[:100], y[:100])], eval_metric="l1",
            init_score=np.zeros(len(y)), feature_name=["a", "b", "c", "d"])
    assert "l1" in next(iter(reg.evals_result_.values()))
    assert reg.feature_name_ == ["a", "b", "c", "d"]
    assert reg.n_estimators_ == 6 and reg.n_iter_ == 6
    assert reg.objective_ == "regression" and reg.n_features_in_ == 4


def test_sklearn_feature_names_in_from_pandas():
    pd = pytest.importorskip("pandas")
    rng = np.random.RandomState(0)
    df = pd.DataFrame(rng.rand(300, 3), columns=["f1", "f2", "f3"])
    y = df["f1"] + 0.1 * rng.randn(300)
    reg = tlgb.LGBMRegressor(n_estimators=3, num_leaves=7,
                             min_child_samples=5, **CPU).fit(df, y)
    assert list(reg.feature_names_in_) == ["f1", "f2", "f3"]
    assert reg.feature_name_ == ["f1", "f2", "f3"]
    np.testing.assert_array_equal(reg.predict(df), reg.predict(df.values))


def test_eval_metric_merges_and_callable_feval():
    rng = np.random.RandomState(1)
    X = rng.rand(400, 3)
    y = X[:, 0] + 0.1 * rng.randn(400)

    def my_metric(preds, ds):
        return ("my_mae", float(np.mean(np.abs(preds - ds.get_label()))),
                False)

    reg = tlgb.LGBMRegressor(n_estimators=4, num_leaves=7,
                             min_child_samples=5, metric="rmse", **CPU)
    reg.fit(X, y, eval_set=[(X[:100], y[:100])],
            eval_metric=["l1", my_metric])
    res = next(iter(reg.evals_result_.values()))
    assert "rmse" in res and "l1" in res and "my_mae" in res, res.keys()


def test_eval_set_aliasing_train_uses_own_labels():
    rng = np.random.RandomState(2)
    X = rng.rand(300, 3)
    y = X[:, 0] + 0.05 * rng.randn(300)
    reg = tlgb.LGBMRegressor(n_estimators=3, num_leaves=7,
                             min_child_samples=5, **CPU)
    reg.fit(X, y, eval_set=[(X, y + 100.0)], eval_metric="l1")
    l1 = next(iter(reg.evals_result_.values()))["l1"][-1]
    assert l1 > 50, l1
