"""PyTorch port: the leaf-wise engine (learner/grow.py grow_tree_impl)
against the JAX package, and the exact sibling subtraction of both
engines.

One tree from each package's leaf-wise engine with the JAX package's
gradients fed to both: n = 16,384 runs the partitioned engine (the
split leaf's segment, compact_min = 4,096 < n), n = 4,096 the masked
engine, and a tiny `histogram_pool_size` the no-stack mode that
rebuilds both children.  The JAX side runs at CPU defaults
(`build_histogram(method="segment")`, the JAX package's plain reference
for K4).  Structure and per-row leaf ids must be identical; float fields
are held, for both packages, to the exact float64 sums of the final
partition within 64 float32 ulps of the root's |gradient| (or hessian)
total over the node's hessian, as in tests/test_torch_wave.py, whose tie
rule also holds here: a node where the two pick a different (threshold,
default_left) must be an exact tie (float64 gains within 1e-6), and is
counted and printed.

The subtraction test shows the fault the integer histogram caches
repair: a leaf reached through two subtractions (root - smaller child,
then that - its smaller child) has no row in a band of bins that its
parent's rows fill, with large gradients elsewhere.  With the caches in
float32 (the port before this change) the band held ulp residues, so
`snap_over_empty` stopped short and the wave engine's model text
carried threshold bin 34 (seed 0), 27 (seed 1) or 34 (seed 2) for the
canonical 36, 35 and 35; with exact int64 caches every threshold sits at
the end of its empty-bin run.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.learner.grow import grow_tree
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.learner.grow import grow_tree_impl

from test_torch_wave import _leaves_under, _port_inputs

FEATS = 8


def _data(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    X[rng.rand(n, FEATS) < 0.02] = np.nan
    w = np.random.RandomState(7).randn(FEATS)
    logit = np.nan_to_num(X) @ w + 0.8 * np.nan_to_num(X[:, 0] * X[:, 1])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _exact_gain(bins_f, rows, g, h, thr, dleft, miss_bin):
    b = bins_f[rows]
    left = np.where(b == miss_bin, bool(dleft), b <= thr)
    gg, hh = g[rows].astype(np.float64), h[rows].astype(np.float64)
    return (gg[left].sum() ** 2 / hh[left].sum()
            + gg[~left].sum() ** 2 / hh[~left].sum()), left


@pytest.mark.parametrize("n,pool", [(16384, -1.0), (4096, -1.0),
                                    (4096, 0.01)])
def test_one_tree_matches_jax(n, pool):
    X, y = _data(n)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "tpu_growth_strategy": "leafwise",
              "histogram_pool_size": pool}
    b = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))
    g = b._gbdt
    assert g.growth_strategy == "leafwise"
    assert g.grow_params.use_hist_stack == (pool < 0)
    g._boost_from_average(0)
    grad, hess = (np.asarray(a[0]) for a in g._compute_gradients())
    jt, jlid = grow_tree(g.binned_dev, jnp.asarray(grad), jnp.asarray(hess),
                         g.bag_mask, g._col_mask(), g.meta, g.grow_params)
    binned, meta, tparams = _port_inputs(g)
    tparams = tparams._replace(compact_min=g.grow_params.compact_min,
                               use_hist_stack=g.grow_params.use_hist_stack)
    row_mask = torch.from_numpy(np.asarray(g.bag_mask))
    pt, plid = grow_tree_impl(
        binned, torch.from_numpy(grad), torch.from_numpy(hess), row_mask,
        torch.ones(binned.shape[0], dtype=torch.bool), meta, tparams)
    nl = int(jt.num_leaves)
    ni = nl - 1
    assert pt.num_leaves == nl == 31
    for k in ("split_feature", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(pt, k).numpy()[:ni],
                                      np.asarray(getattr(jt, k))[:ni],
                                      err_msg=k)
    for k in ("leaf_parent", "leaf_depth"):
        np.testing.assert_array_equal(getattr(pt, k).numpy()[:nl],
                                      np.asarray(getattr(jt, k))[:nl],
                                      err_msg=k)
    lid = np.asarray(jlid)[:n]
    under = _leaves_under(jt)
    bins = np.asarray(g.binned_dev)
    nb, mt, db = (np.asarray(a) for a in (g.meta.num_bin,
                                          g.meta.missing_type,
                                          g.meta.default_bin))
    thr_p, thr_j = pt.threshold_bin.numpy()[:ni], np.asarray(
        jt.threshold_bin)[:ni]
    dl_p, dl_j = pt.default_left.numpy()[:ni], np.asarray(
        jt.default_left)[:ni]
    moved = np.zeros(nl, bool)
    for j in np.nonzero((thr_p != thr_j) | (dl_p != dl_j))[0]:
        f = int(np.asarray(jt.split_feature)[j])
        rows = np.isin(lid, np.nonzero(under[j])[0])
        miss = nb[f] - 1 if mt[f] == 2 else (db[f] if mt[f] == 1 else -1)
        gp, lp = _exact_gain(bins[f, :n], rows, grad[:n], hess[:n],
                             thr_p[j], dl_p[j], miss)
        gj, lj = _exact_gain(bins[f, :n], rows, grad[:n], hess[:n],
                             thr_j[j], dl_j[j], miss)
        assert abs(gp - gj) <= 1e-6 * max(gp, gj), ("not a tie", j, gp, gj)
        print(f"tie broken differently at node {j}")
        if not np.array_equal(lp, lj):
            moved |= under[j]
    inner_moved = np.array([under[j][moved].any() for j in range(ni)])
    ok = ~np.isin(lid, np.nonzero(moved)[0])
    np.testing.assert_array_equal(plid.numpy()[:n][ok], lid[ok])
    np.testing.assert_array_equal(pt.leaf_count.numpy()[:nl][~moved],
                                  np.asarray(jt.leaf_count)[:nl][~moved])
    np.testing.assert_array_equal(
        pt.internal_count.numpy()[:ni][~inner_moved],
        np.asarray(jt.internal_count)[:ni][~inner_moved])
    assert int(pt.leaf_count[:nl].sum()) == n
    G = np.bincount(lid, grad[:n].astype(np.float64), minlength=nl)[:nl]
    H = np.bincount(lid, hess[:n].astype(np.float64), minlength=nl)[:nl]
    Gi, Hi = under.astype(np.float64) @ G, under.astype(np.float64) @ H
    res_g = 64 * 2.0 ** -24 * np.abs(grad[:n]).astype(np.float64).sum()
    res_h = 64 * 2.0 ** -24 * hess[:n].astype(np.float64).sum()
    for k, exact, bound, sel in (
            ("leaf_value", -G / H, res_g / H, ~moved),
            ("leaf_weight", H, res_h + 0 * H, ~moved),
            ("internal_value", -Gi / Hi, res_g / Hi, ~inner_moved),
            ("internal_weight", Hi, res_h + 0 * Hi, ~inner_moved)):
        for name, arr in (("port", getattr(pt, k).numpy()),
                          ("jax", np.asarray(getattr(jt, k)))):
            err = np.abs(arr[:len(exact)].astype(np.float64) - exact)[sel]
            assert np.all(err <= bound[sel]), (name, k)
    np.testing.assert_allclose(pt.split_gain.numpy()[:ni][~inner_moved],
                               np.asarray(jt.split_gain)[:ni][~inner_moved],
                               rtol=1e-4)


def test_train_leafwise_matches_jax():
    """`train` on both packages with tpu_growth_strategy=leafwise: the
    same trees for three iterations."""
    X, y = _data(4096, seed=1)
    X = np.nan_to_num(X)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "tpu_growth_strategy": "leafwise"}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=3)
    bt = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=3)
    bj._gbdt._sync_model()
    assert bt._gbdt.growth_strategy == "leafwise"
    for i, (a, b) in enumerate(zip(bj._gbdt.models_, bt._gbdt.models_)):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni],
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   b.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-4)


@pytest.mark.parametrize("num_leaves,strategy", [(4, "leafwise"),
                                                 (7, "leafwise"),
                                                 (8, "wave")])
def test_auto_strategy(num_leaves, strategy):
    """`auto` takes the wave engine from 8 leaves on (when its kernel
    tile fits), leaf-wise below, on every device; at 4 leaves the port's
    trees are the JAX package's (which picks leaf-wise on the CPU)."""
    X, y = _data(2048, seed=2)
    X = np.nan_to_num(X)
    params = {"objective": "binary", "num_leaves": num_leaves,
              "max_bin": 63, "verbosity": -1}
    bt = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=2)
    assert bt._gbdt.growth_strategy == strategy
    if num_leaves == 4:
        bj = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=2)
        bj._gbdt._sync_model()
        assert bj._gbdt.growth_strategy == "leafwise"
        for a, b in zip(bj._gbdt.models_, bt._gbdt.models_):
            ni = a.num_leaves - 1
            assert a.num_leaves == b.num_leaves == 4
            np.testing.assert_array_equal(a.split_feature[:ni],
                                          b.split_feature[:ni])
            np.testing.assert_array_equal(a.threshold[:ni], b.threshold[:ni])


# ------------------------------------------------ exact sibling subtraction
def _band_data(seed, n=4096):
    """Three features.  The root splits on f0 (<= 0.25 has gradients near
    -500), its larger child on f1 (> 0.7 has gradients near +300; f0 and
    f1 take 20 values, so both cuts fall between bins), and the leaf left
    after two subtractions splits on f2 at 0.5, where it has no row in the
    band (0.35, 0.65) that its parent's rows fill.  The large gradients
    make the float32 band sums round; their unit hessians keep those
    leaves' own splits weak, so both engines reach the band split."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 3).astype(np.float32)
    X[:, :2] = rng.randint(0, 20, (n, 2)) / 20.0
    leaf2 = (X[:, 0] > 0.25) & (X[:, 1] <= 0.7)
    band = (X[:, 2] > 0.35) & (X[:, 2] < 0.65)
    out = np.where(rng.rand(n) < 0.5, rng.rand(n) * 0.35,
                   0.65 + rng.rand(n) * 0.35)
    X[:, 2] = np.where(leaf2 & band, out, X[:, 2]).astype(np.float32)
    s1 = X[:, 0] <= 0.25
    s2 = ~s1 & (X[:, 1] > 0.7)
    g = np.where(s1, -500 + 5 * rng.randn(n),
                 np.where(s2, 300 + 5 * rng.randn(n),
                          1.5 * np.sign(X[:, 2] - 0.5)
                          + 0.3 * rng.randn(n))).astype(np.float32)
    h = np.where(s1 | s2, 1.0, 0.5 + rng.rand(n)).astype(np.float32)
    return X, g, h


def _node_rows(t, X):
    rows = [None] * (t.num_leaves - 1)
    rows[0] = np.ones(len(X), bool)
    for j in range(t.num_leaves - 1):
        left = X[:, t.split_feature[j]] <= t.threshold[j]
        for c, m in ((t.left_child[j], left), (t.right_child[j], ~left)):
            if c >= 0:
                rows[c] = rows[j] & m
    return rows


@pytest.mark.parametrize("strategy", ["wave", "leafwise"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threshold_snaps_across_bins_emptied_by_subtraction(strategy, seed):
    X, g, h = _band_data(seed)
    b = tlgb.Booster({"objective": "binary", "num_leaves": 8,
                      "max_bin": 63, "min_data_in_leaf": 5,
                      "verbosity": -1, "device_type": "cpu",
                      "tpu_growth_strategy": strategy, "wave_prune": False},
                     tlgb.Dataset(X, label=(g > 0).astype(np.float32)))
    gb = b._gbdt
    gb.train_one_iter(g, h)
    t = gb.models_[0]
    text_thr = [float(v) for v in next(
        line for line in b.model_to_string().splitlines()
        if line.startswith("threshold=")).split("=")[1].split()]
    rows = _node_rows(t, X)
    band_split = False
    for j in range(t.num_leaves - 1):
        f = int(t.split_feature[j])
        m = gb.train_data.bin_mappers[f]
        present = np.zeros(m.num_bin + 1, bool)
        present[[m.value_to_bin(v) for v in X[rows[j], f]]] = True
        tb = int(t.threshold_in_bin[j])
        canon = tb                  # the end of the empty-bin run above tb
        while canon + 1 <= m.num_bin - 2 and not present[canon + 1]:
            canon += 1
        band_split |= f == 2 and not present[tb]
        assert tb == canon, (j, f, tb, canon)
        assert text_thr[j] == m.bin_to_value(canon), (j, text_thr[j])
    assert band_split, "no split fell on a run of empty bins"
