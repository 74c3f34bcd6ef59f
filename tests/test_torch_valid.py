"""PyTorch port: `train` with validation sets, feval, callbacks and early
stopping, against the JAX package's, on the CPU.

Both packages train binary logloss on the wave engine
(`tpu_growth_strategy=wave` in both: on the CPU the JAX package's `auto`
picks its leaf-wise engine) at n = 4,096 x 8, 31 leaves, 63 bins, the
port on `device_type="cpu"`; they grow the same trees
(tests/test_torch_train.py).  Their leaf values differ only by the
stated divergence (ROADMAP "Divergences": JAX's float32 leaf values
stray from the exact sums by up to 4e-5 relative, the port's by up to
1.3e-5), so a row's raw score after i trees differs by at most
delta = 5.3e-5 * sum_t |leaf value_t(row)| (the test checks this on the
predictions), plus, for the training scores, the float32 accumulation
of the score buffers, (i + 1) * 2^-23 * max |score| each.  From it:
- logloss and the Brier feval move by at most delta (their slopes in the
  raw score are at most 1);
- AUC moves by at most the share of (positive, negative) pairs whose
  JAX scores lie within 2 * delta of each other (only those can swap);
- the JAX tick sums in float32: log2(n) * 2^-23 relative on top.
The port's own numbers are held tighter: each recorded valid metric
equals, bit for bit, the host metric of `predict(num_iteration=i + 1)`,
and each training metric (the device tick) equals the float64 host
metric of the scores pulled at that iteration within 2^-23 relative.
"""

import json
import types

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.metric import create_metrics
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu.utils import log as jlog

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 4096, 8
PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_growth_strategy": "wave"}
MAIN = {**PARAMS, "metric": ["auc", "binary_logloss"],
        "early_stopping_round": 3, "early_stopping_min_delta": 0.002}
ROUNDS = 40
LEAF_REL = 4e-5 + 1.3e-5
TICK_REL = np.log2(N) * 2.0 ** -23


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    logit = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _brier(score, ds):
    p = 1 / (1 + np.exp(-np.asarray(score, np.float64)))
    return "brier", float(np.mean((p - ds.get_label()) ** 2)), False


def _pulled_host_metrics(store):
    """A callback that evaluates the port's host Metric classes on the
    training scores pulled at each iteration."""
    def _cb(env):
        b = env.model
        score = b._inner_predict_train().astype(np.float64)
        store.append(b._gbdt._eval(score[None, :], b._gbdt.train_metrics))
    _cb.order = 25
    return _cb


def _train(pkg, params, rounds, **kw):
    X, y = _data()
    Xv, yv = _data(2048, seed=1)
    ds = pkg.Dataset(X, label=y)
    hist = {}
    extra = dict(params)
    if pkg is tlgb:
        extra["device_type"] = "cpu"
    cbs = [pkg.record_evaluation(hist)] + kw.pop("callbacks", [])
    b = pkg.train(extra, ds, rounds, valid_sets=[ds, ds.create_valid(
        Xv, label=yv)], feval=_brier, callbacks=cbs, **kw)
    return b, hist


@pytest.fixture(scope="module")
def runs():
    pulled = []
    bt, ht = _train(tlgb, MAIN, ROUNDS,
                    callbacks=[_pulled_host_metrics(pulled)])
    bj, hj = _train(jlgb, MAIN, ROUNDS)
    return bt, ht, bj, hj, pulled


def _row_bound(bj, X, i):
    """delta per row after i + 1 trees, from the JAX trees' leaf values."""
    g = bj._gbdt
    g._sync_model()
    leaves = bj.predict(X, num_iteration=i + 1, pred_leaf=True)
    lv = np.stack([g.models_[t].leaf_value[leaves[:, t]]
                   for t in range(i + 1)], 1)
    return LEAF_REL * np.abs(lv).sum(1)


def _auc_swap_share(score, label, delta):
    """Share of (positive, negative) pairs whose scores lie within
    2 * delta: the most an AUC can move when every score moves by at
    most delta."""
    pos, neg = np.sort(score[label > 0]), np.sort(score[label <= 0])
    lo = np.searchsorted(neg, pos - 2 * delta, "left")
    hi = np.searchsorted(neg, pos + 2 * delta, "right")
    return float((hi - lo).sum()) / (len(pos) * len(neg))


def _expected_best(hist, evals_order, rounds, min_delta, first_only,
                   higher):
    """Replay the early-stopping rule over the recorded history: (best
    iteration index, stop iteration index) or None."""
    first = evals_order[0][1]
    best, best_it = {}, {}
    n_it = len(hist[evals_order[0][0]][evals_order[0][1]])
    for i in range(n_it):
        for name, metric in evals_order:
            if name == "training" or (first_only and metric != first):
                continue
            v = hist[name][metric][i]
            key = (name, metric)
            if key not in best or (v > best[key] + min_delta if higher[metric]
                                   else v < best[key] - min_delta):
                best[key], best_it[key] = v, i
            elif i - best_it[key] >= rounds:
                return best_it[key], i
    return None


def test_metric_names_and_lengths(runs):
    bt, ht, bj, hj, _ = runs
    assert list(ht) == list(hj) == ["training", "valid_1"]
    for name in ht:
        assert list(ht[name]) == list(hj[name]) == ["auc", "binary_logloss",
                                                    "brier"]
    n_it = bt.current_iteration()
    assert all(len(v) == n_it for d in ht.values() for v in d.values())
    assert bt._gbdt._device_eval.ok
    assert bt._gbdt._device_eval.fetches == n_it


def test_metrics_match_jax_within_the_leaf_value_bound(runs):
    bt, ht, bj, hj, _ = runs
    X, y = _data()
    Xv, yv = _data(2048, seed=1)
    n_it = min(bt.current_iteration(), bj.current_iteration())
    for i in range(n_it):
        for name, Xs, ys in (("training", X, y), ("valid_1", Xv, yv)):
            pj = bj.predict(Xs, num_iteration=i + 1, raw_score=True)
            pt = bt.predict(Xs, num_iteration=i + 1, raw_score=True)
            rows = _row_bound(bj, Xs, i)
            assert (np.abs(pt - pj) <= rows).all(), (name, i)
            delta = rows.max()
            tick = 0.0
            if name == "training":
                delta += 2 * (i + 1) * 2.0 ** -23 * np.abs(pj).max()
                tick = TICK_REL
            for metric, bound in (
                    ("auc", _auc_swap_share(pj, ys, delta)),
                    ("binary_logloss", delta), ("brier", delta)):
                a, b = ht[name][metric][i], hj[name][metric][i]
                assert abs(a - b) <= bound + tick * abs(b) + 1e-12, \
                    (name, metric, i, a, b, bound)


def test_valid_metrics_equal_host_recomputation(runs):
    """Each recorded valid metric is the host metric of
    predict(num_iteration=i + 1), bit for bit: the float64 valid scores
    add the same leaf values in the same order."""
    bt, ht, _, _, _ = runs
    Xv, yv = _data(2048, seed=1)
    md = types.SimpleNamespace(label=yv, weight=None, query_boundaries=None)
    ms = create_metrics(bt._gbdt.config)
    for m in ms:
        m.init(md, len(yv))
    vds = types.SimpleNamespace(get_label=lambda: yv)
    for i in range(bt.current_iteration()):
        s = bt.predict(Xv, num_iteration=i + 1, raw_score=True)
        want = [v for m in ms for _, v in m.eval(s, bt._gbdt.objective)]
        want.append(_brier(s, vds)[1])
        got = [ht["valid_1"][k][i] for k in ("auc", "binary_logloss",
                                              "brier")]
        assert got == want, i


def test_training_metrics_equal_host_on_pulled_scores(runs):
    """The device tick against the float64 host Metric classes on the
    same float32 training scores: within the packed float32 rounding."""
    _, ht, _, _, pulled = runs
    assert len(pulled) == len(ht["training"]["auc"])
    for i, host in enumerate(pulled):
        for metric, v in host:
            assert abs(ht["training"][metric][i] - v) <= 2.0 ** -23 * abs(v)


def test_same_best_iteration_and_best_score(runs):
    bt, ht, bj, hj, _ = runs
    assert 0 < bt.best_iteration < bt.current_iteration() < ROUNDS
    assert bt.best_iteration == bj.best_iteration
    assert bt.current_iteration() == bj.current_iteration()
    order = [(n, m) for n in ht for m in ht[n]]
    higher = {"auc": True, "binary_logloss": False, "brier": False}
    best, stop = _expected_best(ht, order, 3, 0.002, False, higher)
    assert bt.best_iteration == best + 1
    assert bt.current_iteration() == stop + 1
    assert set(bt.best_score) == set(bj.best_score) == {"training",
                                                        "valid_1"}
    for name in bt.best_score:
        for metric, v in bt.best_score[name].items():
            assert v == ht[name][metric][bt.best_iteration - 1]
            np.testing.assert_allclose(v, bj.best_score[name][metric],
                                       rtol=1e-4)


def test_predict_and_model_text_honour_best_iteration(runs, tmp_path):
    bt, _, _, _, _ = runs
    Xv, _ = _data(2048, seed=1)
    best = bt.best_iteration
    np.testing.assert_array_equal(bt.predict(Xv),
                                  bt.predict(Xv, num_iteration=best))
    assert not np.array_equal(
        bt.predict(Xv), bt.predict(Xv, num_iteration=bt.current_iteration()))
    text = bt.model_to_string()
    assert text == bt.model_to_string(num_iteration=best)
    assert text.count("Tree=") == best
    path = tmp_path / "m.txt"
    bt.save_model(str(path))
    assert path.read_text() == text


def test_first_metric_only_init_score_and_reset_parameter():
    """Two valid sets (the first with an init_score), no training metric,
    first_metric_only on binary_logloss, and a learning-rate schedule:
    the same per-iteration values within the bound, the same stop."""
    X, y = _data()
    Xv, yv = _data(2048, seed=1)
    Xw, yw = _data(1024, seed=2)
    init = np.random.RandomState(3).randn(2048) * 0.2
    params = {**PARAMS, "metric": ["binary_logloss", "auc"],
              "early_stopping_round": 2, "first_metric_only": True}
    out = {}
    for pkg in (tlgb, jlgb):
        extra = {**params, "device_type": "cpu"} if pkg is tlgb else params
        ds = pkg.Dataset(X, label=y)
        hist = {}
        sched = pkg.reset_parameter(learning_rate=lambda i: 0.6 * 0.9 ** i)
        b = pkg.train(extra, ds, ROUNDS, valid_sets=[
            ds.create_valid(Xv, label=yv, init_score=init),
            ds.create_valid(Xw, label=yw)], valid_names=["v", "w"],
            callbacks=[pkg.record_evaluation(hist), sched])
        out[pkg] = (b, hist)
    (bt, ht), (bj, hj) = out[tlgb], out[jlgb]
    assert list(ht) == ["v", "w"]
    assert bt.best_iteration == bj.best_iteration > 0
    assert bt.current_iteration() == bj.current_iteration() < ROUNDS
    higher = {"auc": True, "binary_logloss": False}
    best, _ = _expected_best(ht, [(n, m) for n in ht for m in ht[n]], 2,
                             0.0, True, higher)
    assert bt.best_iteration == best + 1
    for i in range(bt.current_iteration()):
        for name, Xs, ys, base in (("v", Xv, yv, init), ("w", Xw, yw, 0.0)):
            pj = bj.predict(Xs, num_iteration=i + 1, raw_score=True) + base
            rows = _row_bound(bj, Xs, i)
            assert (np.abs(bt.predict(Xs, num_iteration=i + 1,
                                      raw_score=True) + base - pj)
                    <= rows).all()
            delta = rows.max()
            for metric, bound in (("auc", _auc_swap_share(pj, ys, delta)),
                                  ("binary_logloss", delta)):
                a, b = ht[name][metric][i], hj[name][metric][i]
                assert abs(a - b) <= bound + 1e-12, (name, metric, i)
    # the schedule reached the trees: the second tree was shrunk by 0.54
    assert bt._gbdt.shrinkage_rate == pytest.approx(
        0.6 * 0.9 ** (bt.current_iteration() - 1))
    assert bt._gbdt.models_[1].shrinkage == pytest.approx(0.54)


@pytest.mark.parametrize("pkg", [tlgb, jlgb], ids=["port", "jax"])
def test_early_stopping_warns_once_without_valid_sets(pkg):
    X, y = _data()
    lines = []
    log = tlog if pkg is tlgb else jlog
    extra = {**PARAMS, "verbosity": 0}
    if pkg is tlgb:
        extra["device_type"] = "cpu"
    log.register_callback(lines.append)
    try:
        b = pkg.train(extra, pkg.Dataset(X[:2048], label=y[:2048]), 3,
                      callbacks=[pkg.early_stopping(1)])
    finally:
        log.register_callback(None)
    warned = [s for s in lines if "Early stopping requires" in s]
    assert len(warned) == 1
    assert b.current_iteration() == 3 and b.best_iteration == -1


@pytest.mark.parametrize("where", ["training", "valid"])
def test_nan_label_raises_nonfinite(where):
    """A NaN label makes cross_entropy NaN: both packages stop with
    NonFiniteError at the first iteration."""
    X, y = _data()
    ybad = y.copy()
    ybad[5] = np.nan
    for pkg in (tlgb, jlgb):
        extra = {**PARAMS, "metric": "cross_entropy",
                 "nonfinite_check_freq": 1}
        if pkg is tlgb:
            extra["device_type"] = "cpu"
        if where == "training":
            ds = pkg.Dataset(X, label=ybad)
            extra["is_provide_training_metric"] = True
            valid = []
        else:
            ds = pkg.Dataset(X, label=y)
            valid = [ds.create_valid(X[:512], label=ybad[:512])]
        with pytest.raises(pkg.NonFiniteError, match="is NaN at iteration 1"):
            pkg.train(extra, ds, 3, valid_sets=valid)


@pytest.mark.parametrize("pkg", [tlgb, jlgb], ids=["port", "jax"])
def test_nan_init_score_trips_the_sentinel(pkg):
    """A NaN init score makes the scores and gradients non-finite: the
    first update grows no split (NaN gains are masked), and the sentinel
    reads both device flags false and raises."""
    from importlib import import_module
    X, y = _data()
    init = np.zeros(N)
    init[7] = np.nan
    extra = {**PARAMS, "nonfinite_check_freq": 1}
    if pkg is tlgb:
        extra["device_type"] = "cpu"
    b = pkg.Booster(extra, pkg.Dataset(X, label=y, init_score=init))
    b.update()
    assert not b._gbdt.gradients_finite() and not b._gbdt.scores_finite()
    engine = import_module(pkg.__name__ + ".engine")
    with pytest.raises(pkg.NonFiniteError, match="Non-finite gradients"):
        engine._check_finite(b, [], 0, check_scores=True)


@pytest.mark.parametrize("grouped", [False, True])
def test_cv_folds_equal_jax(grouped, tmp_path):
    """The same folds as the JAX package's cv for the same seed (label-
    stratified, or whole queries per fold when the data has groups):
    each fold's training and test rows carry the same labels and bins,
    the per-round means agree within 1e-4 relative and the deviations
    (differences of near-equal fold values) within 1e-5 absolute."""
    X, y = _data()
    params = {**PARAMS, "metric": ["auc", "binary_logloss"]}
    group = np.full(64, N // 64) if grouped else None
    dt = tlgb.Dataset(X, label=y, params={**params, "device_type": "cpu"})
    if grouped:
        dt.construct()._core.metadata.set_group(group)
    rt = tlgb.cv({**params, "device_type": "cpu"}, dt, num_boost_round=4,
                 nfold=3, seed=11, return_cvbooster=True)
    rj = jlgb.cv(params, jlgb.Dataset(X, label=y, group=group,
                                      params=params),
                 num_boost_round=4, nfold=3, seed=11, return_cvbooster=True)
    keys = [k for k in rj if k != "cvbooster"]
    assert [k for k in rt if k != "cvbooster"] == keys
    for k in keys:
        assert len(rt[k]) == len(rj[k]) == 4
        if k.endswith("-mean"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4)
        else:
            np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=1e-5)
    cbt, cbj = rt["cvbooster"], rj["cvbooster"]
    assert len(cbt.boosters) == len(cbj.boosters) == 3
    for bt, bj in zip(cbt.boosters, cbj.boosters):
        dt, dj = bt._gbdt.train_data, bj._gbdt.train_data
        np.testing.assert_array_equal(dt.metadata.label, dj.metadata.label)
        np.testing.assert_array_equal(dt.binned_host(),
                                      np.asarray(dj.binned_host()))
        vt, vj = bt._gbdt.valid_sets[0], bj._gbdt.valid_sets[0]
        np.testing.assert_array_equal(vt.binned_host(),
                                      np.asarray(vj.binned_host()))
    assert len(cbt.predict(X[:10])) == 3
    path = tmp_path / "cv.json"
    cbt.save_model(str(path))
    payload = json.loads(path.read_text())
    assert payload["best_iteration"] == cbt.best_iteration
    assert payload["boosters"] == [b.model_to_string() for b in cbt.boosters]


def test_booster_eval_of_a_new_dataset(runs):
    """Booster.eval on a Dataset not seen in training replays the trees
    into its float64 scores: the same numbers as the valid set added at
    train time; a loaded booster predicts the raw data."""
    bt, ht, _, _, _ = runs
    Xv, yv = _data(2048, seed=1)
    got = bt.eval(tlgb.Dataset(Xv, label=yv), "again")
    want = [e for e in bt.eval_valid() if e[0] == "valid_1"]
    assert [e[1:] for e in got] == [e[1:] for e in want]
    loaded = tlgb.Booster(model_str=bt.model_to_string(num_iteration=-1),
                          params={"device_type": "cpu"})
    res = loaded.eval(tlgb.Dataset(Xv, label=yv, free_raw_data=False), "v")
    assert [e[1] for e in res] == ["binary_logloss"]
    np.testing.assert_allclose(res[0][2], want[1][2], rtol=1e-12)


def test_booster_eval_train_and_feval(runs):
    bt, ht, _, _, _ = runs
    res = bt.eval_train(feval=_brier)
    assert [e[1] for e in res] == ["auc", "binary_logloss", "brier"]
    assert res[0][3] is True and res[1][3] is False


@pytest.mark.parametrize("kw", [
    # continued training, DART, custom and ranking objectives, linear
    # trees and the host planes (checkpoints, metrics_dir, profile_dir,
    # metrics_port and their callbacks) are ported, and so are more than
    # 256 bins, the advanced monotone mode and the feature and voting
    # learners: the cases keep their ids (kw0 and kw2 the names of the
    # linear-tree cases they replaced) and hold that each option with a
    # learner that has no process group trains the serial run's trees
    # beside a validation set, with the same evaluations
    pytest.param({"params": {"max_bin": 511, "tree_learner": "feature"}},
                 id="kw0-item 14"),
    pytest.param({"params": {"tree_learner": "voting"}}, id="kw1-item 15"),
    pytest.param({"params": {"linear_tree": True,
                             "monotone_constraints_method": "advanced",
                             "tree_learner": "feature"}},
                 id="kw2-item 14")])
def test_unported_train_options_refuse(kw):
    X, y = _data(1024)
    params = {**PARAMS, "device_type": "cpu", **kw.pop("params", {})}
    dkw = {"params": {"linear_tree": True}} if params.get("linear_tree") \
        else {}
    runs = []
    for learner in (params["tree_learner"], "serial"):
        hist = {}
        ds = tlgb.Dataset(X, label=y, **dkw)
        vs = tlgb.Dataset(X[:256], label=y[:256], reference=ds)
        b = tlgb.train({**params, "tree_learner": learner}, ds, 2,
                       valid_sets=[vs],
                       callbacks=[tlgb.record_evaluation(hist)])
        runs.append((b.model_to_string().split("\nparameters:")[0], hist))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("missing", ["nan", "zero"])
def test_bin_space_traversal_equals_jax_and_raw_space(missing):
    """The valid sets' bin-space traversal (torch) gives every row the
    leaf of the JAX package's NumPy traversal and of the tree's raw-value
    traversal, with missing values of both kinds and default
    directions."""
    from lightgbm_tpu.boosting.gbdt import leaf_index_bin_space as jtrav
    from lightgbm_tpu_torch.boosting.gbdt import leaf_index_bin_space
    rng = np.random.RandomState(9)
    X, y = _data(3000, seed=4)
    if missing == "nan":
        X[rng.rand(*X.shape) < 0.1] = np.nan
        extra = {}
    else:
        X[rng.rand(*X.shape) < 0.3] = 0.0
        extra = {"zero_as_missing": True}
    b = tlgb.train({**PARAMS, "device_type": "cpu", **extra},
                   tlgb.Dataset(X, label=y), 4)
    g = b._gbdt
    Xv, _ = _data(1500, seed=5)
    Xv[rng.rand(*Xv.shape) < 0.1] = np.nan if missing == "nan" else 0.0
    vds = tlgb.Dataset(Xv, label=np.zeros(1500), reference=b._train_set,
                       params={"device_type": "cpu", **extra}).construct()
    bins = vds._core.binned
    assert {int(g.train_data.bin_mappers[f].missing_type)
            for f in g.train_data.used_features} == {2 if missing == "nan"
                                                     else 1}
    for tree in g.models_:
        got = leaf_index_bin_space(tree, torch.from_numpy(bins),
                                   g.f_missing_type, g.f_num_bin,
                                   g.f_default_bin).numpy()
        ni = tree.num_leaves - 1
        want = jtrav(tree.split_feature_inner[:ni], tree.threshold_in_bin[:ni],
                     (tree.decision_type[:ni] & 2) > 0, tree.left_child[:ni],
                     tree.right_child[:ni], tree.num_leaves,
                     g.f_missing_type, g.f_num_bin, g.f_default_bin, bins)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tree.get_leaf_index(
            Xv.astype(np.float64)))
