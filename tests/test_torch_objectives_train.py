"""PyTorch port: training with every pointwise, multiclass and
cross-entropy objective end to end against the JAX package, on the CPU.

Data: 3,000 x 6 rows made from a seed, a label of each objective's kind
(a linear signal with noise; Poisson counts; gamma draws; class cuts;
probabilities for the cross-entropy pair), random row weights and a
1,500-row valid set.  The weights make the gradients continuous:
unweighted, L1's and quantile's two gradient values (and multiclass's at
the first iteration, from one prior per class) tie exactly across
features, and the JAX package's float32 sums break such ties by noise
(a tie that moves rows leaves the models incomparable from there on).
cross_entropy_lambda trains unweighted against the JAX package, whose
padding rows (weight 0) give it 0/0 gradients, NaN histograms and no
split; the port gives a weight-0 row no gradient (ROADMAP "Divergences
of the reference") and trains weighted data (its own test).
Both packages train 4 rounds at 15 leaves and 63 bins, on the wave
engine (`tpu_growth_strategy=wave` in both: on the CPU the JAX
package's `auto` picks its leaf-wise engine) and on the leaf-wise
engine; multiclass also quantized.  Each pair is trained once per
module.

* Trees follow the tie rule of tests/test_torch_categorical.py
  (`same_trees`): the JAX package computes the gradients in float32 and
  sums them in float32, the port in float64 and exactly, so a node where
  the two choose differently must be an exact tie, here on another
  feature too (quantile's and L1's two gradient values tie across
  features); leaf values agree within rtol 1e-4 plus atol 1e-6 (a leaf
  near zero carries the float32 sums' absolute error).  The tie check
  takes the objective's gradients at the scores the earlier JAX trees
  give.
* Predictions: raw scores within the leaf-value bound of
  tests/test_torch_valid.py (LEAF_REL x the row's summed |leaf value|:
  the JAX package's float32 leaf sums stray from the exact ones), and
  converted predictions within 1e-6 relative or that bound times the
  conversion's slope where it is wider.
* Model text crosses both ways and reloads in each package.
* Recorded valid metrics: the port's equal the host metric of its own
  predictions, and are within the bound the raw-score bound gives of
  the JAX package's (2 x the largest change of the pointwise loss when
  each row's score moves by its bound).
* A custom L2 `fobj` grows the trees of objective=regression; a softmax
  `fobj` those of objective=multiclass, in the port and in the JAX
  package.  Stratified `cv` for multiclass matches the JAX package's, at
  min_data_in_leaf 1: the scan estimates a child's rows as
  RoundInt(hess x rows / sum_hess), and with multiclass hessians
  p(1 - p) one fold of this data puts that estimate at the bound of 20,
  where the JAX package's float32 sums and the port's exact ones round
  to either side (ROADMAP "Divergences of the reference").
* Model text of JAX-trained poisson, multiclass, multiclassova,
  cross_entropy and gamma models loads in the port with its objective:
  `Booster.predict` equals the JAX package's within 1e-6 relative.
"""

import types

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.metric import create_metrics, device_pointwise_loss
from test_torch_categorical import lam_of_booster, same_trees

N, NV, F = 3000, 1500, 6
ROUNDS = 4
K = 3
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}
OBJECTIVES = ["regression", "regression_l1", "huber", "fair", "poisson",
              "quantile", "mape", "gamma", "tweedie", "multiclass",
              "multiclassova", "cross_entropy", "cross_entropy_lambda"]
ENGINES = ("wave", "leafwise")
LEAF_REL = 4e-5 + 1.3e-5        # tests/test_torch_valid.py
# each default metric's pointwise loss (metric.device_pointwise_loss)
LOSS = {"regression": "l2", "regression_l1": "l1", "huber": "huber",
        "fair": "fair", "poisson": "poisson", "quantile": "quantile",
        "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
        "cross_entropy": "xentropy", "cross_entropy_lambda": "xentropy"}


def _weight(n=N, seed=0):
    return (0.5 + np.random.RandomState(100 + seed).rand(n)).astype(
        np.float32)


def _data(objective, n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    sig = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    if objective.startswith("multiclass"):
        y = np.digitize(sig + rng.logistic(size=n), [-1.0, 1.0])
    elif objective.startswith("cross_entropy"):
        y = 1 / (1 + np.exp(-sig + 0.5 * rng.randn(n)))
    elif objective in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(0.4 * sig))
    elif objective == "gamma":
        y = np.exp(0.3 * sig) * rng.gamma(2.0, 0.5, n)
    elif objective == "mape":
        y = 3.0 + sig + 0.5 * rng.randn(n)
    else:
        y = sig + 0.5 * rng.randn(n)
    return X, y.astype(np.float32)


def _params(objective, engine, **kw):
    p = {**BASE, "objective": objective, "tpu_growth_strategy": engine, **kw}
    if objective.startswith("multiclass"):
        p["num_class"] = K
    return p


def _train_pair(objective, engine, **kw):
    X, y = _data(objective)
    Xv, yv = _data(objective, NV, seed=1)
    params = _params(objective, engine, **kw)
    hj, ht = {}, {}
    wt = None if objective == "cross_entropy_lambda" else _weight()
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt), ROUNDS,
                    valid_sets=[jlgb.Dataset(Xv, label=yv)],
                    callbacks=[jlgb.record_evaluation(hj)])
    bt = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, weight=wt), ROUNDS,
                    valid_sets=[tlgb.Dataset(Xv, label=yv)],
                    callbacks=[tlgb.record_evaluation(ht)])
    bj._gbdt._sync_model()
    return types.SimpleNamespace(bj=bj, bt=bt, X=X, y=y, Xv=Xv, yv=yv,
                                 hj=hj["valid_0"], ht=ht["valid_0"],
                                 objective=objective)


@pytest.fixture(scope="module")
def pair():
    """pair(objective, engine, **params): the trained pair of both
    packages, trained once per module."""
    cache = {}

    def get(objective, engine="wave", **kw):
        key = (objective, engine, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _train_pair(objective, engine, **kw)
        return cache[key]
    return get


def compare_trees(p, rtol=1e-4):
    """Every port tree against the JAX tree under the tie rule, the tie
    gains from the objective's gradients at the scores of the earlier
    JAX trees; stops after a tie that moved rows.  Returns the tie
    count."""
    ja, tb = p.bj._gbdt.models_, p.bt._gbdt.models_
    assert len(ja) == len(tb)
    g = p.bt._gbdt
    obj, Kc = g.objective, g.num_tree_per_iteration
    lam = lam_of_booster(g)
    X64 = p.X.astype(np.float64)
    score = np.zeros((Kc, len(p.y)))
    if g.config.boost_from_average:
        score += np.array([obj.boost_from_score(k) for k in range(Kc)])[:,
                                                                        None]
    lab = torch.from_numpy(obj.label)
    wt = None if obj.weight is None else torch.from_numpy(obj.weight)
    n_ties = 0
    for it in range(len(ja) // Kc):
        sc = torch.from_numpy(score.astype(np.float32))
        gr, he = obj.get_gradients(sc if Kc > 1 else sc[0], lab, wt)
        gr, he = gr.reshape(Kc, -1).numpy(), he.reshape(Kc, -1).numpy()
        nxt = score.copy()
        for k in range(Kc):
            a, b = ja[it * Kc + k], tb[it * Kc + k]
            ties, changed = same_trees(a, b, X64, gr[k], he[k], lam,
                                       atol=1e-6, rtol=rtol,
                                       feature_ties=True)
            n_ties += len(ties)
            if changed:
                return n_ties
            pred = a.predict(X64)
            nxt[k] = pred if it == 0 and g.config.boost_from_average \
                else nxt[k] + pred
        score = nxt
    return n_ties


def row_bound(b, X):
    """LEAF_REL x each row's summed |leaf value| per class, from the JAX
    booster's trees: [n, K] (or [n])."""
    g = b._gbdt
    Kc = g.num_tree_per_iteration
    leaves = b.predict(X, pred_leaf=True)
    out = np.zeros((len(X), Kc))
    for t in range(leaves.shape[1]):
        out[:, t % Kc] += np.abs(g.models_[t].leaf_value[leaves[:, t]])
    out *= LEAF_REL
    return out[:, 0] if Kc == 1 else out


SLOPE = {"regression": 1.0, "regression_l1": 1.0, "huber": 1.0,
         "fair": 1.0, "quantile": 1.0, "mape": 1.0,
         "multiclass": 0.5, "multiclassova": 0.25, "cross_entropy": 0.25,
         "cross_entropy_lambda": 1.0}


def check_predictions(p):
    """Raw scores within the leaf-value bound; converted predictions
    within 1e-6 relative, or the bound times the conversion's slope
    (exp's is the prediction itself)."""
    for Xs in (p.X, p.Xv):
        rj = p.bj.predict(Xs, raw_score=True)
        rt = p.bt.predict(Xs, raw_score=True)
        rows = row_bound(p.bj, Xs)
        assert (np.abs(rt - rj) <= rows + 1e-12).all()
        cj, ct = p.bj.predict(Xs), p.bt.predict(Xs)
        slope = SLOPE.get(p.objective, None)
        conv_bound = (np.abs(cj) * (np.exp(rows) - 1) if slope is None
                      else slope * (rows.max(1, keepdims=True)
                                    if rows.ndim == 2 else rows))
        np.testing.assert_array_less(
            np.abs(ct - cj), np.maximum(1e-6 * np.abs(cj), conv_bound)
            + 1e-15)


# ------------------------------------------------------------ trains like JAX
CASES = ([(o, e, {}) for o in OBJECTIVES for e in ENGINES]
         + [("regression", "wave", {"reg_sqrt": True}),
            ("multiclass", "wave", {"use_quantized_grad": True})])


@pytest.mark.parametrize(
    "objective,engine,extra", CASES,
    ids=[f"{o}-{e}" + "".join(f"-{k}" for k in x) for o, e, x in CASES])
def test_trains_like_jax(pair, objective, engine, extra):
    p = pair(objective, engine, **extra)
    g = p.bt._gbdt
    assert g.growth_strategy == engine
    assert g.num_tree_per_iteration == (K if objective.startswith(
        "multiclass") else 1)
    assert p.bt.num_trees() == p.bj.num_trees() == ROUNDS * \
        g.num_tree_per_iteration
    ties = compare_trees(p)
    print(f"{objective}/{engine}{extra}: {ties} tie nodes")
    check_predictions(p)


@pytest.mark.parametrize("objective", OBJECTIVES + ["reg_sqrt"])
def test_model_text_crosses_both_ways(pair, objective):
    extra = {"reg_sqrt": True} if objective == "reg_sqrt" else {}
    p = pair("regression" if extra else objective, "wave", **extra)
    Xv = p.Xv
    text_t = p.bt.model_to_string()
    text_j = p.bj.model_to_string()
    # the port's text in both packages
    bj2 = jlgb.Booster(model_str=text_t)
    bt2 = tlgb.Booster(model_str=text_t, params=CPU)
    want = p.bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(bj2.predict(Xv, raw_score=True), want,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(bt2.predict(Xv, raw_score=True), want)
    # converted predictions of the reloaded models agree between the
    # packages: reg_sqrt's text drops the sqrt token in both (ROADMAP
    # "Divergences of the reference"), so both predict in sqrt space
    np.testing.assert_allclose(bt2.predict(Xv), bj2.predict(Xv),
                               rtol=1e-12, atol=1e-300)
    if not extra:
        np.testing.assert_allclose(bt2.predict(Xv), p.bt.predict(Xv),
                                   rtol=1e-12, atol=1e-300)
    # and the JAX package's text in the port
    bt3 = tlgb.Booster(model_str=text_j, params=CPU)
    np.testing.assert_allclose(bt3.predict(Xv),
                               jlgb.Booster(model_str=text_j).predict(Xv),
                               rtol=1e-6, atol=1e-300)


def _metric_bound(p, i, metric):
    """The most the valid metric can move when every score moves by its
    row bound after i + 1 trees: 2 x the mean largest pointwise change
    at the bound's ends (multi_logloss: 2 x the mean bound, log-sum-exp
    being 1-Lipschitz in the largest class move)."""
    g = p.bt._gbdt
    Xv, yv = p.Xv, p.yv.astype(np.float64)
    raw = p.bj.predict(Xv, num_iteration=i + 1, raw_score=True)
    leaves = p.bj.predict(Xv, num_iteration=i + 1, pred_leaf=True)
    Kc = g.num_tree_per_iteration
    rows = np.zeros((len(Xv), Kc))
    for t in range(leaves.shape[1]):
        rows[:, t % Kc] += np.abs(p.bj._gbdt.models_[t].leaf_value[
            leaves[:, t]])
    rows *= LEAF_REL
    if metric == "multi_logloss":
        return 2 * rows.max(1).mean()
    name = LOSS[p.objective]
    fn = device_pointwise_loss(name, g.config)
    conv = g.objective.convert_output
    if p.objective == "cross_entropy_lambda":
        def conv(s):
            return 1 / (1 + torch.exp(-s))
    y = torch.from_numpy(yv)

    def loss(s):
        return fn(conv(torch.from_numpy(s)), y).numpy()
    base = loss(raw)
    d = np.maximum(np.abs(loss(raw + rows[:, 0]) - base),
                   np.abs(loss(raw - rows[:, 0]) - base))
    return 2 * d.mean()


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_valid_metrics_match_jax(pair, objective):
    p = pair(objective, "wave")
    g = p.bt._gbdt
    assert list(p.ht) == list(p.hj)
    # the training metrics run on the device tick, no host fallback
    p.bt.eval_train()
    assert g._device_eval is not None and g._device_eval.ok
    md = types.SimpleNamespace(label=p.yv, weight=None,
                               query_boundaries=None)
    ms = create_metrics(g.config)
    for m in ms:
        m.init(md, len(p.yv))
    for i in range(ROUNDS):
        s = p.bt.predict(p.Xv, num_iteration=i + 1, raw_score=True)
        s = s.T if s.ndim == 2 else s
        own = {mn: v for m in ms for mn, v in m.eval(s, g.objective)}
        for metric in p.ht:
            a, b = p.ht[metric][i], p.hj[metric][i]
            # the port's recorded metric is its predictions' host metric
            np.testing.assert_allclose(a, own[metric], rtol=1e-12)
            bound = _metric_bound(p, i, metric)
            assert abs(a - b) <= bound + 1e-12 * abs(b), (metric, i, a, b,
                                                          bound)


# ---------------------------------------------------------- custom objectives
def _l2_fobj(score, ds):
    return score - ds.get_label(), np.ones_like(score)


def _softmax_fobj(score, ds):
    """score [n, K] -> class-major gradients [K * n] (the layout
    Booster.update also takes)."""
    p = np.exp(score - score.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = np.eye(K)[ds.get_label().astype(int)]
    return ((p - onehot).T.reshape(-1),
            (K / (K - 1.0) * p * (1 - p)).T.reshape(-1))


@pytest.mark.parametrize("case", ["l2", "softmax"])
def test_custom_objective_grows_the_builtin_trees(case):
    objective = "regression" if case == "l2" else "multiclass"
    X, y = _data(objective)
    params = {**_params(objective, "wave"), **CPU}
    builtin = tlgb.train({**params, "boost_from_average": False},
                         tlgb.Dataset(X, label=y), ROUNDS)
    fobj = _l2_fobj if case == "l2" else _softmax_fobj
    custom = tlgb.train({**params, "objective": "none"},
                        tlgb.Dataset(X, label=y), ROUNDS, fobj=fobj)
    pj = jlgb.train({**_params(objective, "wave"), "objective": "none"},
                    jlgb.Dataset(X, label=y), ROUNDS, fobj=fobj)
    pj._gbdt._sync_model()
    assert custom.num_trees() == builtin.num_trees() == pj.num_trees()
    for a, b, c in zip(builtin._gbdt.models_, custom._gbdt.models_,
                       pj._gbdt.models_):
        nl = a.num_leaves
        assert nl == b.num_leaves == c.num_leaves
        for t in (b, c):
            np.testing.assert_array_equal(a.split_feature[:nl - 1],
                                          t.split_feature[:nl - 1])
            np.testing.assert_array_equal(a.threshold[:nl - 1],
                                          t.threshold[:nl - 1])
            np.testing.assert_allclose(t.leaf_value[:nl], a.leaf_value[:nl],
                                       rtol=1e-4, atol=1e-6)
    # with no objective the booster predicts raw scores, the JAX
    # package's within the leaf-value bound
    assert custom._gbdt.objective is None
    np.testing.assert_array_equal(custom.predict(X),
                                  custom.predict(X, raw_score=True))
    assert (np.abs(custom.predict(X) - pj.predict(X))
            <= row_bound(pj, X) + 1e-12).all()


def test_weighted_cross_entropy_lambda_trains():
    """Weighted cross_entropy_lambda grows trees in the port (a row of
    weight 0, the padding rows among them, gets no gradient); its
    gradients on the weighted rows are the JAX package's
    (tests/test_torch_objective.py)."""
    X, y = _data("cross_entropy_lambda")
    wt = _weight()
    wt[:10] = 0.0
    b = tlgb.train({**_params("cross_entropy_lambda", "wave"), **CPU},
                   tlgb.Dataset(X, label=y, weight=wt), ROUNDS)
    assert b.num_trees() == ROUNDS
    assert all(t.num_leaves > 1 for t in b._gbdt.models_)
    g = b._gbdt
    gr, he = g._compute_gradients()
    assert torch.isfinite(gr).all() and torch.isfinite(he).all()
    assert (gr[0, :10] == 0).all() and (gr[0, N:] == 0).all()
    assert (he[0, :10] == 0).all() and (he[0, N:] == 0).all()


def test_custom_objective_nonfinite_gradients_raise():
    X, y = _data("regression")

    def bad(score, ds):
        g = score - ds.get_label()
        g[3] = np.nan
        return g, np.ones_like(score)
    with pytest.raises(tlgb.NonFiniteError,
                       match="Custom objective returned NaN/Inf"):
        tlgb.train({**_params("regression", "wave"), **CPU,
                    "objective": "none"}, tlgb.Dataset(X, label=y), 2,
                   fobj=bad)


def test_stratified_cv_multiclass_matches_jax():
    X, y = _data("multiclass")
    wt = _weight()
    params = _params("multiclass", "wave", min_data_in_leaf=1)
    rt = tlgb.cv({**params, **CPU}, tlgb.Dataset(X, label=y, weight=wt),
                 num_boost_round=3, nfold=3, stratified=True, seed=5,
                 return_cvbooster=True)
    rj = jlgb.cv(params, jlgb.Dataset(X, label=y, weight=wt),
                 num_boost_round=3, nfold=3, stratified=True, seed=5)
    assert list(rj) == ["valid multi_logloss-mean",
                        "valid multi_logloss-stdv"]
    assert list(rt) == list(rj) + ["cvbooster"]
    # stratified: each fold holds a third of each class, to one row
    folds = tlgb.engine.make_folds(y, None, 3, True, True, "multiclass", 5)
    for _, test_idx in folds:
        for c in range(K):
            assert abs(3 * int((y[test_idx] == c).sum())
                       - int((y == c).sum())) <= 3
    assert all(b._gbdt.num_tree_per_iteration == K
               for b in rt["cvbooster"].boosters)
    np.testing.assert_allclose(rt["valid multi_logloss-mean"],
                               rj["valid multi_logloss-mean"], rtol=1e-4)
    np.testing.assert_allclose(rt["valid multi_logloss-stdv"],
                               rj["valid multi_logloss-stdv"], rtol=0,
                               atol=1e-5)


# ------------------------------------------- model text of JAX-trained models
@pytest.mark.parametrize("objective", ["poisson", "multiclass",
                                       "multiclassova", "cross_entropy",
                                       "gamma"])
def test_jax_model_text_predicts_converted(objective):
    """The port loads a JAX model's text with its objective: converted
    predictions equal the JAX package's, not raw scores."""
    X, y = _data(objective, 2000)
    params = {**_params(objective, "wave"), "num_leaves": 7}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), 3)
    text = bj.model_to_string()
    bt = tlgb.Booster(model_str=text, params=CPU)
    assert bt._gbdt.objective is not None
    assert bt._gbdt.objective.name == objective
    want = bj.predict(X)
    np.testing.assert_allclose(bt.predict(X), want, rtol=1e-6, atol=0)
    assert not np.allclose(bt.predict(X, raw_score=True), want)


def test_model_text_with_a_broken_objective_raises():
    """Only custom/none and the unported ranking objectives load with no
    objective; any other failure to build the objective raises."""
    X, y = _data("regression", 2000)
    bj = jlgb.train({**_params("regression", "wave"), "num_leaves": 7},
                    jlgb.Dataset(X, label=y), 2)
    text = bj.model_to_string()
    head, tail = text.split("objective=regression", 1)
    for obj, ok in (("custom", True), ("none", True), ("lambdarank", True),
                    ("rank_xendcg", True), ("no_such_objective", False),
                    ("multiclass num_class:1", False)):
        t = f"{head}objective={obj}{tail}"
        if ok:
            b = tlgb.Booster(model_str=t, params=CPU)
            assert b._gbdt.objective is None
            np.testing.assert_array_equal(
                b.predict(X), b.predict(X, raw_score=True))
        else:
            with pytest.raises(Exception):
                tlgb.Booster(model_str=t, params=CPU)
