"""PyTorch port: row and column sampling against the JAX package, on the
CPU.

Every draw is held bit for bit: the bag masks of plain and balanced
bagging (NumPy `RandomState(bagging_seed)`, drawn every `bagging_freq`
iterations), the per-tree `feature_fraction` masks, the extra-trees
thresholds and `feature_fraction_bynode` subsets of both engines (the
threefry stream under a key folded with the booster's tag and the
scan's tag), and GOSS's kept rows and rescaled gradients on identical
float32 inputs.

Trees: one tree per option from each package's wave and leaf-wise
engines (on the wave engine with extra-trees and bynode draws on top),
with the JAX package's row mask, column mask, tag and
gradients fed to both (gradients at a random score, so that few
candidates tie), compared under the tie rule of tests/test_torch_wave.py:
the same split features and children; a node where the two pick a
different (threshold, default_left) must be an exact tie (float64 gains
of the in-bag rows within 1e-6) and its moved rows leave the row-level
comparison; leaf counts equal, leaf values within rtol 1e-4 (atol 1e-6).
Then `train` end to end in both packages for three iterations of each
option (GOSS from iteration 2 at learning_rate 0.5): the same split
features and thresholds in every tree, leaf values within 1e-5.
Quantized training with bagging is held to the JAX package the same way
in tests/test_torch_continue.py, whose quantized continuation compiles
that program once for both.  The JAX package compiles one program per
engine and growth setting; the cases share them (data of one shape and
bin count, and `tpu_donate_buffers=false` so that `train` calls the
engines' plain entry), which keeps the file to seconds.  The one-tree
extra-trees case runs again on data with NaNs (NaN missing type) and
with exact zeros under `zero_as_missing` (zero missing type).  The
end-to-end data have no missing values: at the first iteration a NaN
bin's default direction is often an exact tie, which the packages break
by float32 noise (ROADMAP, "Divergences of the reference").
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.boosting.gbdt import _goss_sample
from lightgbm_tpu.learner.grow import grow_tree
from lightgbm_tpu.learner.wave import grow_tree_wave
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.gbdt import goss_sample
from lightgbm_tpu_torch.learner.grow import ScanDraws, grow_tree_impl
from lightgbm_tpu_torch.learner.wave import grow_tree_wave_impl
from lightgbm_tpu_torch.utils import random as R

from test_torch_wave import _leaves_under, _port_inputs

N, FEATS = 4096, 8
BASE = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_donate_buffers": False}


def _data(seed=0, missing=None):
    """`missing`: None; "nan" (NaN in 15% of features 0-3's rows, which
    gives them the NaN missing type); "zero" (exact zeros in 20% of
    features 0-3's rows, for `zero_as_missing`)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(N, FEATS).astype(np.float32)
    w = np.random.RandomState(7).randn(FEATS)
    logit = X @ w + 0.8 * X[:, 0] * X[:, 1]
    y = (rng.rand(N) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    if missing is not None:
        hole = rng.rand(N, 4) < (0.15 if missing == "nan" else 0.2)
        X[:, :4][hole] = np.nan if missing == "nan" else 0.0
    return X, y


def _pair(extra, missing=None):
    """The JAX and the port GBDT on the same data and params (port on the
    CPU)."""
    X, y = _data(missing=missing)
    params = {**BASE, **extra}
    gj = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))._gbdt
    gt = tlgb.Booster(params={**params, "device_type": "cpu"},
                      train_set=tlgb.Dataset(X, label=y))._gbdt
    return gj, gt


# ------------------------------------------------------------- the draws
@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"bagging_fraction": 0.7, "bagging_freq": 3, "bagging_seed": 11},
    {"bagging_fraction": 0.9, "bagging_freq": 1,
     "pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.8},
    # balanced fractions without bagging_fraction < 1: no bagging at all
    # in the JAX package, so none in the port
    {"bagging_freq": 1, "pos_bagging_fraction": 0.5}],
    ids=["plain", "freq3", "balanced", "balanced_off"])
def test_bag_masks_equal_jax(extra):
    gj, gt = _pair(extra)
    for it in range(7):
        gj.iter_ = gt.iter_ = it
        gj._update_bagging()
        mask, _, _ = gt._update_bagging(None, None)
        np.testing.assert_array_equal(gt._bag_mask_host,
                                      np.asarray(gj._bag_mask_host),
                                      err_msg=f"iteration {it}")
        np.testing.assert_array_equal(mask.numpy(), np.asarray(gj.bag_mask))
    if "bagging_fraction" not in extra:
        assert gt._bag_mask_host[:N].all()


def test_col_masks_equal_jax():
    gj, gt = _pair({"feature_fraction": 0.6, "feature_fraction_seed": 9})
    for tree in range(6):
        np.testing.assert_array_equal(gt._col_mask().numpy(),
                                      np.asarray(gj._col_mask()),
                                      err_msg=f"tree {tree}")


def _jax_draws(seed, tag, t, shape, num_bin, k=None):
    """The JAX engines' draw for scan tag `t` under booster tag `tag`:
    `_rand_bins` (k None) or `_bynode_mask(s)` (learner/wave.py:187,240,
    learner/grow.py:414,422)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(tag))
    u = jax.random.uniform(jax.random.fold_in(key, t), shape)
    if k is not None:
        return np.asarray(u >= jax.lax.top_k(u, k)[0][..., -1:])
    nb = jnp.asarray(num_bin)
    span = jnp.maximum(nb - 2, 1).astype(jnp.float32)
    return np.asarray(jnp.clip((u * span).astype(jnp.int32), 0,
                               jnp.maximum(nb - 3, 0)))


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_scan_draws_equal_jax(engine):
    gj, gt = _pair({"extra_trees": True, "extra_seed": 13,
                    "feature_fraction_bynode": 0.6,
                    "feature_fraction_seed": 4,
                    "tpu_growth_strategy": engine})
    gp = gt.grow_params
    assert gp.split.extra_trees and gp.bynode_seed == 5
    num_bin = gt.meta.num_bin.numpy()
    F = len(num_bin)
    k = max(1, int(round(0.6 * F)))
    shape = (37, F) if engine == "wave" else (F,)
    for tag in (0, 5, 2 ** 31 - 2):
        d = ScanDraws(gp, gt.meta, shape, tag, torch.device("cpu"))
        if engine == "wave":
            for t in (1, 2, 9):
                np.testing.assert_array_equal(
                    d.rand_bins(t).numpy(),
                    _jax_draws(13, tag, t, shape, num_bin))
                np.testing.assert_array_equal(
                    d.bynode(t).numpy(),
                    _jax_draws(5, tag, t, shape, num_bin, k))
        else:
            tags = torch.arange(9)
            rb, bym = d.rand_bins(tags).numpy(), d.bynode(tags).numpy()
            for t in range(9):
                np.testing.assert_array_equal(
                    rb[t], _jax_draws(13, tag, t, shape, num_bin))
                np.testing.assert_array_equal(
                    bym[t], _jax_draws(5, tag, t, shape, num_bin, k))
            assert (bym.sum(1) == k).all()
        assert (d.rand_bins(3).numpy() <= np.maximum(num_bin - 3, 0)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_goss_sample_equal_jax(seed):
    rng = np.random.RandomState(seed)
    n, n_pad = 3000, 3072
    grad = np.zeros((1, n_pad), np.float32)
    hess = np.zeros((1, n_pad), np.float32)
    grad[0, :n] = rng.randn(n).astype(np.float32)
    hess[0, :n] = rng.rand(n).astype(np.float32)
    grad[0, :40] = grad[0, 40]            # tied importances at the top
    hess[0, :40] = hess[0, 40]
    pad = np.zeros(n_pad, np.float32)
    pad[:n] = 1.0
    top_k, other_k = int(n * 0.2), int(n * 0.1)
    keep, g, h = _goss_sample(jnp.asarray(grad), jnp.asarray(hess),
                              jnp.asarray(pad),
                              jax.random.PRNGKey(3 + seed), top_k, other_k)
    pk, pg, ph = goss_sample(torch.from_numpy(grad), torch.from_numpy(hess),
                             torch.from_numpy(pad), R.PRNGKey(3 + seed),
                             top_k, other_k)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(g))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(h))
    assert pk.numpy()[n:].sum() == 0
    assert (pg.numpy() != grad).any()


# --------------------------------------------------------- one tree each
def _exact_gain(bins_f, rows, g, h, thr, dleft, miss_bin):
    b = bins_f[rows]
    left = np.where(b == miss_bin, bool(dleft), b <= thr)
    gg, hh = g[rows].astype(np.float64), h[rows].astype(np.float64)
    return (gg[left].sum() ** 2 / hh[left].sum()
            + gg[~left].sum() ** 2 / hh[~left].sum()), left


def _compare_tree(gj, jt, jlid, pt, plid, grad, hess, row_mask):
    """The tie rule of tests/test_torch_wave.py on the in-bag rows."""
    nl = int(jt.num_leaves)
    ni = nl - 1
    assert pt.num_leaves == nl and nl > 4
    for k in ("split_feature", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(pt, k).numpy()[:ni],
                                      np.asarray(getattr(jt, k))[:ni],
                                      err_msg=k)
    lid = np.asarray(jlid)[:N]
    under = _leaves_under(jt)
    bins = np.asarray(gj.binned_dev)
    nb, mt, db = (np.asarray(a) for a in (gj.meta.num_bin,
                                          gj.meta.missing_type,
                                          gj.meta.default_bin))
    m = row_mask[:N] > 0
    g, h = grad[:N] * m, hess[:N] * m
    thr_p, thr_j = pt.threshold_bin.numpy()[:ni], np.asarray(
        jt.threshold_bin)[:ni]
    dl_p, dl_j = pt.default_left.numpy()[:ni], np.asarray(
        jt.default_left)[:ni]
    moved = np.zeros(nl, bool)
    for j in np.nonzero((thr_p != thr_j) | (dl_p != dl_j))[0]:
        f = int(np.asarray(jt.split_feature)[j])
        rows = np.isin(lid, np.nonzero(under[j])[0]) & m
        miss = nb[f] - 1 if mt[f] == 2 else (db[f] if mt[f] == 1 else -1)
        gp, lp = _exact_gain(bins[f, :N], rows, g, h, thr_p[j], dl_p[j],
                             miss)
        gq, lq = _exact_gain(bins[f, :N], rows, g, h, thr_j[j], dl_j[j],
                             miss)
        assert abs(gp - gq) <= 1e-6 * max(gp, gq), ("not a tie", j, gp, gq)
        print(f"tie broken differently at node {j}")
        moved |= under[j]
    ok = ~np.isin(lid, np.nonzero(moved)[0])
    np.testing.assert_array_equal(plid.numpy()[:N][ok], lid[ok])
    np.testing.assert_array_equal(pt.leaf_count.numpy()[:nl][~moved],
                                  np.asarray(jt.leaf_count)[:nl][~moved])
    assert int(pt.leaf_count[:nl].sum()) == int(m.sum())
    np.testing.assert_allclose(pt.leaf_value.numpy()[:nl][~moved],
                               np.asarray(jt.leaf_value)[:nl][~moved],
                               rtol=1e-4, atol=1e-6)


TREE_CASES = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1,
                "feature_fraction": 0.75},
    "goss": {"data_sample_strategy": "goss"},
    "extra_bynode_bagging": {"extra_trees": True,
                             "feature_fraction_bynode": 0.75,
                             "bagging_fraction": 0.8, "bagging_freq": 1},
}


# the wave engine's cases all carry extra-trees and bynode draws (the
# engine's per-wave draw rows are the likeliest place to differ), which
# keeps the JAX package to one wave program for the file
WAVE_DRAWS = {"extra_trees": True, "feature_fraction_bynode": 0.75}


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_one_tree_matches_jax(case, engine):
    _one_tree(case, engine)


# the extra-trees candidate filter against the missing-value offsets of
# both scan directions: NaN bins (NaN missing type) and the skipped zero
# bin (zero_as_missing)
@pytest.mark.parametrize("engine", ["wave", "leafwise"])
@pytest.mark.parametrize("missing", ["nan", "zero"])
def test_one_tree_missing_values_match_jax(missing, engine):
    _one_tree("extra_bynode_bagging", engine, missing)


def _one_tree(case, engine, missing=None):
    extra = {**TREE_CASES[case], "tpu_growth_strategy": engine,
             **(WAVE_DRAWS if engine == "wave" else {}),
             **({"zero_as_missing": True} if missing == "zero" else {})}
    gj, _ = _pair(extra, missing)
    mt = np.asarray(gj.meta.missing_type)
    if missing is not None:
        assert (mt[:4] == (2 if missing == "nan" else 1)).all(), mt
    assert gj.growth_strategy == engine
    rng = np.random.RandomState(5)
    sc = np.zeros((1, gj.n_pad), np.float32)
    sc[0, :N] = 0.5 * rng.randn(N)
    gj.scores = jnp.asarray(sc)
    grad, hess = gj._compute_gradients()
    # past GOSS's warm-up of 1 / learning_rate = 10 iterations
    gj.iter_ = 12
    if case == "goss":
        mask, grad, hess = gj._update_bagging(grad, hess)
        assert 0 < float(mask.sum()) < N
    else:
        gj._update_bagging()
        mask = gj.bag_mask
    col_mask = gj._col_mask()
    # the booster passes a tag (absolute iteration x K + k) only to the
    # draws that use it
    tag = (np.int32(gj.iter_) if "extra_trees" in extra
           or "feature_fraction_bynode" in extra else None)
    tag_kw = {} if tag is None else {"extra_tag": tag}
    grad = np.asarray(grad[0])
    hess = np.asarray(hess[0])
    binned, meta, tparams = _port_inputs(gj)
    jp = gj.grow_params
    tparams = tparams._replace(
        split=tparams.split._replace(extra_trees=jp.split.extra_trees,
                                     extra_seed=jp.split.extra_seed),
        feature_fraction_bynode=jp.feature_fraction_bynode,
        bynode_seed=jp.bynode_seed)
    port_args = (binned, torch.from_numpy(grad), torch.from_numpy(hess),
                 torch.from_numpy(np.asarray(mask)),
                 torch.from_numpy(np.asarray(col_mask)), meta)
    if engine == "wave":
        jt, jlid = grow_tree_wave(gj.binned_dev, jnp.asarray(grad),
                                  jnp.asarray(hess), mask, col_mask,
                                  gj.meta, jp, **tag_kw)
        pt, plid = grow_tree_wave_impl(*port_args, tparams, extra_tag=tag)
    else:
        jt, jlid = grow_tree(gj.binned_dev, jnp.asarray(grad),
                             jnp.asarray(hess), mask, col_mask, gj.meta, jp,
                             **tag_kw)
        tparams = tparams._replace(compact_min=jp.compact_min,
                                   use_hist_stack=jp.use_hist_stack)
        pt, plid = grow_tree_impl(*port_args, tparams, extra_tag=tag)
    _compare_tree(gj, jt, jlid, pt, plid, grad, hess, np.asarray(mask))
    if "feature_fraction" in extra:
        used = np.asarray(jt.split_feature)[:int(jt.num_leaves) - 1]
        assert np.asarray(col_mask)[used].all()


# ------------------------------------------------------ train end to end
TRAIN_CASES = {
    "bagging_wave": {"bagging_fraction": 0.8, "bagging_freq": 1,
                     "feature_fraction": 0.75, **WAVE_DRAWS,
                     "tpu_growth_strategy": "wave"},
    "goss_extra_bynode_wave": {"data_sample_strategy": "goss",
                               "learning_rate": 0.5, "extra_trees": True,
                               "feature_fraction_bynode": 0.75,
                               "tpu_growth_strategy": "wave"},
    "extra_bynode_bagging_leafwise": {"extra_trees": True,
                                      "feature_fraction_bynode": 0.75,
                                      "bagging_fraction": 0.8,
                                      "bagging_freq": 1,
                                      "tpu_growth_strategy": "leafwise"},
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case):
    X, y = _data(seed=1)
    params = {**BASE, **TRAIN_CASES[case]}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), num_boost_round=3)
    bt = tlgb.train({**params, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=3)
    bj._gbdt._sync_model()
    assert bt._gbdt.growth_strategy == params["tpu_growth_strategy"]
    assert len(bj._gbdt.models_) == len(bt._gbdt.models_) == 3
    for i, (a, b) in enumerate(zip(bj._gbdt.models_, bt._gbdt.models_)):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, i
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni],
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_array_equal(a.leaf_count[:ni + 1],
                                      b.leaf_count[:ni + 1])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   b.leaf_value[:ni + 1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
