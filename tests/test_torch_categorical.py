"""PyTorch port: categorical features end to end against the JAX package,
on the CPU.

Data: 4096 x 8 with three categorical columns passed as
`categorical_feature`: column 5 holds 3 categories (4 bins: one-hot
mode), column 0 about 7 and column 3 20 (sorted-subset mode), 1% of
column 3 NaN; random row weights, so that few candidate splits tie.
`train` runs three iterations in both packages on the wave engine, the
leaf-wise engine and the leaf-wise engine with extra-trees (the
categorical USE_RAND draws); quantized training (K2's plain version on
the CPU) grows two wave trees from the JAX package's discretized
gradients, fed to both.  Trees are compared under the tie rule of
tests/test_torch_wave.py, extended to categorical nodes (`same_trees`):
a node where the two packages choose a different threshold or category
set must be an exact tie (float64 gains of both choices on the node's
rows within 1e-6), and its subtree leaves the comparison; elsewhere
split gains agree within 1e-4 of the tree's largest.  A node whose
rows hold two categories ties exactly ({a} left or {b} left is the same
partition mirrored), which the packages break by float32 noise; a
mirrored tie leaves the predictions as they were, so later trees are
still compared.  Then: predictions equal the JAX booster's, model text
crosses both ways, the valid-set scores (the categorical bin-space
traversal) equal `predict`, and `init_model` continues a categorical
model as the JAX package does.  The JAX package compiles one program per
engine (`tpu_donate_buffers=false`, one data shape).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.learner.wave import grow_tree_wave
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.gbdt import leaf_index_bin_space
from lightgbm_tpu_torch.learner.wave import grow_tree_wave_impl

N, FEATS = 4096, 8
CAT = [0, 3, 5]
BASE = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_donate_buffers": False, "min_data_per_group": 20,
        "cat_smooth": 5.0}
CPU = {"device_type": "cpu"}


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 2)
    X[:, 3] = rng.randint(0, 20, n)
    X[:, 5] = rng.randint(0, 3, n)
    eff = np.random.RandomState(3).randn(20)
    w = np.random.RandomState(7).randn(FEATS)
    logit = (X[:, 1] * w[1] + X[:, 2] * w[2] + eff[X[:, 3].astype(int)]
             + 0.5 * X[:, 0] - 0.7 * (X[:, 5] == 1))
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    X[rng.rand(n) < 0.01, 3] = np.nan
    wt = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, wt


# ------------------------------------------------ the tie rule, host trees
def _reach(tree, X):
    """[ni, n] bool: row r reaches internal node j of a host tree."""
    ni = tree.num_leaves - 1
    reach = np.zeros((ni, len(X)), bool)
    node = np.zeros(len(X), np.int64)
    idx = np.arange(len(X))
    while len(idx):
        nd = node[idx]
        reach[nd, idx] = True
        left = tree._decision(X[idx, tree.split_feature[nd]], nd)
        nxt = np.where(left, tree.left_child[nd], tree.right_child[nd])
        node[idx] = nxt
        idx = idx[nxt >= 0]
    return reach


def _subtree(tree, j):
    """Internal nodes and leaves below node j."""
    nodes, leaves, stack = set(), set(), [j]
    while stack:
        k = stack.pop()
        for c in (int(tree.left_child[k]), int(tree.right_child[k])):
            if c >= 0:
                nodes.add(c)
                stack.append(c)
            else:
                leaves.add(~c)
    return nodes, leaves


def _node_key(t, j):
    if t.decision_type[j] & 1:
        return (int(t.split_feature[j]), int(t.decision_type[j]),
                tuple(t._cats_of_node(j)))
    return (int(t.split_feature[j]), int(t.decision_type[j]),
            float(t.threshold[j]))


def _gain(g, h, left, lam):
    g, h = g.astype(np.float64), h.astype(np.float64)
    gl, hl = g[left].sum(), h[left].sum()
    gr, hr = g.sum() - gl, h.sum() - hl
    return gl * gl / (hl + lam) + gr * gr / (hr + lam)


def same_trees(ta, tb, X, g, h, lam_of, atol=1e-5, rtol=0.0,
               feature_ties=False):
    """Tree tb (port) equals ta (JAX) up to exact ties, its leaf values
    within atol + rtol * |ta's|; returns (tie nodes, whether a tie moved
    rows to another partition).  With `feature_ties` a tie may also pick
    another feature (discrete gradients, such as quantile's two values,
    tie across features exactly)."""
    assert ta.num_leaves == tb.num_leaves
    ni = ta.num_leaves - 1
    reach = _reach(ta, X)
    gain_tol = 1e-4 * float(np.abs(ta.split_gain[:ni]).max())
    skip, moved, ties, changed = set(), set(), [], False
    for j in range(ni):
        if j in skip:
            continue
        if not feature_ties:
            assert ta.split_feature[j] == tb.split_feature[j], ("feature", j)
        if _node_key(ta, j) != _node_key(tb, j):
            rows = reach[j]
            fa, fb = ta.split_feature[j], tb.split_feature[j]
            nodes_j = np.full(int(rows.sum()), j)
            la = ta._decision(X[rows, fa], nodes_j)
            lb = tb._decision(X[rows, fb], nodes_j)
            ga = _gain(g[rows], h[rows], la, lam_of(ta, j))
            gb = _gain(g[rows], h[rows], lb, lam_of(tb, j))
            assert abs(ga - gb) <= 1e-6 * max(ga, gb), ("not a tie", j, ga,
                                                        gb)
            print(f"tie at node {j}: {_node_key(ta, j)} vs "
                  f"{_node_key(tb, j)}")
            ties.append(j)
            if not np.array_equal(la, lb):
                nodes, leaves = _subtree(ta, j)
                skip |= nodes
                moved |= leaves
                changed |= not np.array_equal(la, ~lb)
                continue
        for k in ("left_child", "right_child"):
            assert getattr(ta, k)[j] == getattr(tb, k)[j], (k, j)
        # split gains carry float32 noise at the scale of the tree's
        # largest gain (the parent's gain is subtracted)
        assert abs(float(ta.split_gain[j]) - float(tb.split_gain[j])) <= (
            gain_tol), ("split_gain", j, ta.split_gain[j], tb.split_gain[j])
    keep = [leaf for leaf in range(ta.num_leaves) if leaf not in moved]
    np.testing.assert_array_equal(ta.leaf_count[keep], tb.leaf_count[keep])
    np.testing.assert_allclose(tb.leaf_value[keep], ta.leaf_value[keep],
                               rtol=rtol, atol=atol)
    return ties, changed


def lam_of_booster(gbdt):
    """The L2 term of a node's gain: lambda_l2, plus cat_l2 on a
    sorted-subset categorical node (feature_histogram.cpp:250)."""
    cfg = gbdt.config

    def lam(tree, j):
        f = int(tree.split_feature[j])
        m = gbdt.train_data.bin_mappers[f]
        subset = (tree.decision_type[j] & 1) and (m.num_bin
                                                  > cfg.max_cat_to_onehot)
        return cfg.lambda_l2 + (cfg.cat_l2 if subset else 0.0)
    return lam


def compare_training(bj, bt, X, y, wt):
    """Every tree of the port's booster against the JAX booster's under
    the tie rule, with the gradients of binary logloss at the scores the
    earlier (JAX) trees give; stops after a tie that moved rows to
    another partition (later gradients may then differ).  Returns the
    number of tie nodes and whether every tree was compared."""
    ja, tb = bj._gbdt.models_, bt._gbdt.models_
    assert len(ja) == len(tb)
    lam = lam_of_booster(bt._gbdt)
    X64 = X.astype(np.float64)
    w = np.ones(len(y)) if wt is None else wt.astype(np.float64)
    pavg = (w * y).sum() / w.sum()
    score = np.full(len(y), np.log(pavg / (1 - pavg)))
    n_ties = 0
    for i, (a, b) in enumerate(zip(ja, tb)):
        p = 1 / (1 + np.exp(-score))
        ties, changed = same_trees(a, b, X64, (p - y) * w, p * (1 - p) * w,
                                   lam)
        n_ties += len(ties)
        if changed:
            return n_ties, False
        score = (a.predict(X64) if i == 0 else score + a.predict(X64))
    return n_ties, True


def _cat_splits(models):
    return sum(int((t.decision_type[:t.num_leaves - 1] & 1).sum())
               for t in models)


# ------------------------------------------------------ train end to end
TRAIN_CASES = {
    "wave": {"tpu_growth_strategy": "wave"},
    "leafwise": {"tpu_growth_strategy": "leafwise"},
    "leafwise_extra_trees": {"tpu_growth_strategy": "leafwise",
                             "extra_trees": True},
}


def _train_pair(case, rounds=3, **kw):
    X, y, wt = _data()
    params = {**BASE, **TRAIN_CASES[case]}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt,
                                         categorical_feature=CAT),
                    num_boost_round=rounds, **kw)
    bt = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, weight=wt,
                                 categorical_feature=CAT),
                    num_boost_round=rounds, **kw)
    bj._gbdt._sync_model()
    return bj, bt, X, y, wt


@pytest.fixture(scope="module")
def wave_pair():
    return _train_pair("wave")


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case, wave_pair):
    bj, bt, X, y, wt = wave_pair if case == "wave" else _train_pair(case)
    assert bt._gbdt.growth_strategy == TRAIN_CASES[case][
        "tpu_growth_strategy"]
    assert bt._gbdt.grow_params.split.has_categorical
    g = bt._gbdt
    # one-hot (4 bins) and sorted-subset features both present
    nbs = {g.train_data.bin_mappers[f].num_bin for f in CAT}
    assert min(nbs) <= 4 < max(nbs)
    assert _cat_splits(g.models_) >= 6
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def test_quantized_categorical_trees_match_jax():
    """use_quantized_grad on the wave engine: the port's K2 path (plain
    version on the CPU) on the JAX package's discretized gradients."""
    X, y, wt = _data()
    params = {**BASE, "tpu_growth_strategy": "wave",
              "use_quantized_grad": True}
    gj = jlgb.Booster(params=params, train_set=jlgb.Dataset(
        X, label=y, weight=wt, categorical_feature=CAT))._gbdt
    gt = tlgb.Booster(params={**params, **CPU}, train_set=tlgb.Dataset(
        X, label=y, weight=wt, categorical_feature=CAT))._gbdt
    assert gt.grow_params.quant_bins == 4
    gj._boost_from_average(0)
    lam = lam_of_booster(gt)
    X64 = X.astype(np.float64)
    cat_nodes = 0
    for it in range(2):
        grad, hess = gj._compute_gradients()
        gq, hq, sc = gj._discretize_fn(grad[0], hess[0], np.int32(it))
        jt, jlid = grow_tree_wave(gj.binned_dev, gq, hq, gj.bag_mask,
                                  gj._col_mask(), gj.meta, gj.grow_params,
                                  quant_scales=sc)
        pt, _ = grow_tree_wave_impl(
            gt.binned_dev, torch.from_numpy(np.asarray(gq)),
            torch.from_numpy(np.asarray(hq)), gt.bag_mask, gt.col_mask,
            gt.meta, gt.grow_params,
            quant_scales=torch.from_numpy(np.asarray(sc)))
        ta = gj._packed_to_tree(np.asarray(gj._pack_tree_fn(jt)))
        tb = gt._packed_to_tree(gt._pack_tree(pt).numpy())
        cat_nodes += _cat_splits([tb])
        _, changed = same_trees(ta, tb, X64, np.asarray(gq)[:N],
                                np.asarray(hq)[:N], lam, atol=1e-4)
        if changed:
            break
        gj.scores = gj.scores.at[0].add(0.1 * jnp.asarray(jt.leaf_value)[jlid])
    assert cat_nodes >= 2


# ------------------------------------------- prediction and model text
def test_predictions_and_model_text(wave_pair, tmp_path):
    bj, bt, X, _, _ = wave_pair
    Xte, _, _ = _data(seed=1, n=2000)
    for data in (X, Xte):
        np.testing.assert_allclose(bt.predict(data), bj.predict(data),
                                   rtol=0, atol=1e-5)
    # the torch traversal (device_predict=true on the CPU) and the native
    # predictor route every categorical row alike
    t_dev = tlgb.Booster(model_str=bt.model_to_string(),
                         params={**CPU, "device_predict": "true"})
    t_nat = tlgb.Booster(model_str=bt.model_to_string(),
                         params={**CPU, "device_predict": "false"})
    np.testing.assert_array_equal(t_dev.predict(Xte, pred_leaf=True),
                                  t_nat.predict(Xte, pred_leaf=True))
    np.testing.assert_allclose(t_dev.predict(Xte, raw_score=True),
                               t_nat.predict(Xte, raw_score=True),
                               rtol=0, atol=1e-5)
    # model text: the port reloads its own to the same predictions, the
    # JAX package loads it, and the port loads the JAX package's
    path = tmp_path / "cat_model.txt"
    bt.save_model(str(path))
    text = path.read_text()
    assert "cat_boundaries=" in text and "cat_threshold=" in text
    np.testing.assert_array_equal(
        tlgb.Booster(model_file=str(path), params=CPU).predict(Xte),
        bt.predict(Xte))
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(Xte),
                               bt.predict(Xte), rtol=0, atol=1e-12)
    port = convert.booster_from_jax(bj.model_to_string(), params=CPU)
    np.testing.assert_allclose(port.predict(Xte), bj.predict(Xte), rtol=0,
                               atol=1e-12)


def test_valid_scores_follow_categorical_nodes():
    """The valid set's scores advance through the bin-space traversal of
    categorical nodes: equal to `predict`'s raw scores, and each tree's
    leaf ids equal the raw-value traversal's."""
    X, y, wt = _data()
    Xv, yv, _ = _data(seed=2, n=1500)
    params = {**BASE, "tpu_growth_strategy": "wave", **CPU}
    ds = tlgb.Dataset(X, label=y, weight=wt, categorical_feature=CAT)
    vs = ds.create_valid(Xv, label=yv)
    bt = tlgb.train(params, ds, num_boost_round=3, valid_sets=[vs])
    g = bt._gbdt
    np.testing.assert_allclose(g.valid_scores[0][0],
                               bt.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-5)
    assert _cat_splits(g.models_) >= 6
    for tree in g.models_:
        got = leaf_index_bin_space(tree, g.valid_bins[0], g.f_missing_type,
                                   g.f_num_bin, g.f_default_bin).numpy()
        np.testing.assert_array_equal(
            got, tree.get_leaf_index(Xv.astype(np.float64)))


def test_init_model_continues_a_categorical_model():
    """Both packages continue the JAX package's 2-round categorical model
    (the port from its text) for 2 more rounds: the adopted trees map their category sets to
    this run's bins (`_reconstruct_bin_space`), the new trees equal under
    the tie rule."""
    X, y, wt = _data()
    params = {**BASE, "tpu_growth_strategy": "wave"}
    init = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt,
                                           categorical_feature=CAT), 2)
    text = init.model_to_string()
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt,
                                         categorical_feature=CAT), 2,
                    init_model=init)
    bt = tlgb.train({**params, **CPU},
                    tlgb.Dataset(X, label=y, weight=wt,
                                 categorical_feature=CAT), 2,
                    init_model=text)
    bj._gbdt._sync_model()
    g = bt._gbdt
    assert bt.num_trees() == 4 and g.num_init_iteration_ == 2
    assert _cat_splits(g.models_[:2]) >= 2
    # the adopted trees route the training bins as their raw values do
    for tree in g.models_[:2]:
        got = leaf_index_bin_space(tree, g.binned_dev[:, :N],
                                   g.f_missing_type, g.f_num_bin,
                                   g.f_default_bin).numpy()
        np.testing.assert_array_equal(
            got, tree.get_leaf_index(X.astype(np.float64)))
    X64 = X.astype(np.float64)
    score = sum(t.predict(X64) for t in bj._gbdt.models_[:2])
    lam = lam_of_booster(g)
    w = wt.astype(np.float64)
    for a, b in zip(bj._gbdt.models_[2:], g.models_[2:]):
        p = 1 / (1 + np.exp(-score))
        _, changed = same_trees(a, b, X64, (p - y) * w, p * (1 - p) * w, lam)
        if changed:
            return
        score = score + a.predict(X64)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
