"""PyTorch port: quantized training (use_quantized_grad) against the JAX
package.

* `discretize_gradients` is bit-equal to the JAX booster's
  `_discretize_fn` (gbdt.py:841), stochastic and deterministic rounding,
  with and without a constant hessian.
* K2's plain version (`build_histogram_wave` with `quant_scales`) equals
  the integer oracle of tests/test_wave_int8.py exactly: integer sums
  per (slot, feature, bin), dequantized as float32(sum) * scale.
* Quantized wave trees: the JAX package's gradients at three successive
  iterations are discretized by both packages and grown by both wave
  engines (JAX on the CPU sums the grid values in float32 through
  `_hist_wave_xla`; the port sums the integers exactly).  Trees follow
  tests/test_torch_wave.py's rule: a node where the two pick different
  thresholds must be an exact tie (float64 gains of both choices on the
  node's rows within 1e-6), and is counted and printed.
* `renew_leaf_values` against the JAX booster's `_renew_quant_fn`
  (float32 scatter sums there, float64 here: rtol 1e-5).
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
from lightgbm_tpu_torch.boosting.gbdt import (discretize_gradients,
                                              renew_leaf_values)
from lightgbm_tpu_torch.learner import wave as twave
from lightgbm_tpu_torch.learner.wave import grow_tree_wave_impl
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.split import SplitParams
from lightgbm_tpu_torch.utils import random as R

from test_torch_histogram import (CASES, _slot_case, _slot_partition_plain,
                                  _wave_part_items)
from test_torch_wave import _leaves_under, _port_inputs

ROWS, FEATS = 6000, 10


def _data(seed=0, n=ROWS):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    X[rng.rand(n, FEATS) < 0.02] = np.nan
    w = np.random.RandomState(7).randn(FEATS)
    logit = np.nan_to_num(X) @ w + 0.8 * np.nan_to_num(X[:, 0] * X[:, 1])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _jax_booster(**extra):
    X, y = _data(n=2048)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "use_quantized_grad": True, **extra}
    return jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))


@pytest.mark.parametrize("objective", ["binary", "regression"])
@pytest.mark.parametrize("stochastic", [True, False])
def test_discretize_matches_jax(objective, stochastic):
    jb = _jax_booster(objective=objective, stochastic_rounding=stochastic,
                      seed=3)
    const_hess = objective == "regression"
    rng = np.random.RandomState(1)
    grad = rng.randn(4096).astype(np.float32)
    hess = (rng.rand(4096) * 0.25).astype(np.float32)
    if const_hess:
        hess[:] = 1.0
    for it in (0, 7):
        gq, hq, sc = jb._gbdt._discretize_fn(jnp.asarray(grad),
                                             jnp.asarray(hess), np.int32(it))
        key = R.fold_in(R.PRNGKey(3 + 5), it) if stochastic else None
        pq, pqh, psc = discretize_gradients(torch.from_numpy(grad),
                                            torch.from_numpy(hess), 4,
                                            const_hess, key)
        for a, b in ((pq, gq), (pqh, hq), (psc, sc)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))


def _int_oracle(n=1024 * 16, F=12, B=64, NL=32, seed=0):
    """The integer oracle of tests/test_wave_int8.py."""
    rng = np.random.RandomState(seed)
    qbins, qhalf = 4, 2
    gscale, hscale = np.float32(0.0123), np.float32(0.0456)
    binned = rng.randint(0, B, (F, n)).astype(np.uint8)
    slot = rng.randint(0, NL, n).astype(np.int32)
    gi = rng.randint(-qhalf, qhalf + 1, n)
    hi = rng.randint(0, qbins + 1, n)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    gh = np.stack([gi * gscale * mask, hi * hscale * mask, mask],
                  1).astype(np.float32)
    exp = np.zeros((NL, F, B, 2), np.int64)
    mi = mask.astype(np.int64)
    for f in range(F):
        np.add.at(exp[:, f, :, 0], (slot, binned[f]), gi * mi)
        np.add.at(exp[:, f, :, 1], (slot, binned[f]), hi * mi)
    scales = np.array([gscale, hscale], np.float32)
    return (binned, slot, gh, scales, exp,
            np.bincount(slot, mi, minlength=NL), B, NL)


def test_k2_plain_matches_integer_oracle():
    binned, slot, gh, scales, exp, cnt, B, NL = _int_oracle()
    args = (torch.from_numpy(binned), torch.from_numpy(slot),
            torch.from_numpy(gh))
    sc = torch.from_numpy(scales)
    h, c = th.build_histogram_wave(*args, max_bin=B, num_slots=NL,
                                   quant_bins=4, quant_scales=sc)
    np.testing.assert_array_equal(
        h.numpy(), exp.astype(np.float32) * scales[None, None, None, :])
    np.testing.assert_array_equal(c.numpy(), cnt.astype(np.float32))
    acc, cacc = th.build_histogram_wave_int(*args, sc, max_bin=B,
                                            num_slots=NL)
    assert acc.dtype == torch.int64
    np.testing.assert_array_equal(acc.numpy(), exp)
    np.testing.assert_array_equal(cacc.numpy(), cnt)


def test_k2_entry_refuses_beyond_int8_grid():
    binned, slot, gh, scales, *_ = _int_oracle(n=512, F=2, B=8, NL=8)
    with pytest.raises(ValueError):
        th.build_histogram_wave(torch.from_numpy(binned),
                                torch.from_numpy(slot), torch.from_numpy(gh),
                                max_bin=8, num_slots=8, quant_bins=127,
                                quant_scales=torch.from_numpy(scales))


@pytest.mark.parametrize("bins", [4, 127])
def test_quant_gate_matches_jax(bins):
    """quant_bins <= 126 and n_pad * bins < 2^31; outside the gate the
    wave engine falls back to K1 on the dequantized values."""
    X, y = _data(n=2048)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "use_quantized_grad": True,
              "num_grad_quant_bins": bins, "tpu_growth_strategy": "wave"}
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))
    tb = tlgb.Booster(params={**params, "device_type": "cpu"},
                      train_set=tlgb.Dataset(X, label=y))
    assert (tb._gbdt.grow_params.quant_bins
            == jb._gbdt.grow_params.quant_bins == (4 if bins == 4 else 0))
    tb.update()
    assert tb._gbdt.models_[0].num_leaves == 15


@pytest.mark.parametrize("renew", [False, True])
def test_training_takes_k2_path(monkeypatch, renew):
    """The port's `train` with use_quantized_grad grows every wave from
    K2's integer sums, deterministically, with and without leaf
    renewal from the float gradients."""
    calls = []
    orig = twave.build_histogram_wave_int

    def spy(*a, **k):
        calls.append(k["num_slots"])
        return orig(*a, **k)

    monkeypatch.setattr(twave, "build_histogram_wave_int", spy)
    X, y = _data(n=2048)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1, "device_type": "cpu",
              "use_quantized_grad": True, "quant_train_renew_leaf": renew}
    a = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=2)
    assert len(calls) > 0
    b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=2)
    assert a.model_to_string() == b.model_to_string()


def _exact_gain(binned_f, rows, g, h, thr, dleft, miss_bin):
    b = binned_f[rows]
    left = np.where(b == miss_bin, bool(dleft), b <= thr)
    gg, hh = g[rows].astype(np.float64), h[rows].astype(np.float64)
    return gg[left].sum() ** 2 / hh[left].sum() + gg[~left].sum() ** 2 / \
        hh[~left].sum(), left


def test_quantized_wave_trees_match_jax():
    X, y = _data()
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "tpu_growth_strategy": "wave",
              "use_quantized_grad": True}
    jb = jlgb.Booster(params=params, train_set=jlgb.Dataset(X, label=y))
    g = jb._gbdt
    g._boost_from_average(0)
    binned, meta, tparams = _port_inputs(g)
    tparams = tparams._replace(quant_bins=g.grow_params.quant_bins)
    assert tparams.quant_bins == 4
    row_mask = torch.from_numpy(np.asarray(g.bag_mask))
    bins = np.asarray(g.binned_dev)
    nb = np.asarray(g.meta.num_bin)
    mt = np.asarray(g.meta.missing_type)
    db = np.asarray(g.meta.default_bin)
    ties = 0
    for it in range(3):
        grad, hess = g._compute_gradients()
        gq, hq, sc = g._discretize_fn(grad[0], hess[0], np.int32(it))
        pq, pqh, psc = discretize_gradients(
            torch.from_numpy(np.asarray(grad[0])),
            torch.from_numpy(np.asarray(hess[0])), 4, False,
            R.fold_in(R.PRNGKey(5), it))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(gq))
        np.testing.assert_array_equal(pqh.numpy(), np.asarray(hq))
        jt, jlid = grow_tree_wave(g.binned_dev, gq, hq, g.bag_mask,
                                  g._col_mask(), g.meta, g.grow_params)
        pt, plid = grow_tree_wave_impl(binned, pq, pqh, row_mask,
                                       torch.ones(binned.shape[0],
                                                  dtype=torch.bool),
                                       meta, tparams, quant_scales=psc)
        nl = int(jt.num_leaves)
        ni = nl - 1
        assert pt.num_leaves == nl
        for k in ("split_feature", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(pt, k).numpy()[:ni],
                                          np.asarray(getattr(jt, k))[:ni],
                                          err_msg=f"iteration {it} {k}")
        lid = np.asarray(jlid)[:ROWS]
        under = _leaves_under(jt)
        gqn, hqn = np.asarray(gq)[:ROWS], np.asarray(hq)[:ROWS]
        thr_p = pt.threshold_bin.numpy()[:ni]
        thr_j = np.asarray(jt.threshold_bin)[:ni]
        dl_p = pt.default_left.numpy()[:ni]
        dl_j = np.asarray(jt.default_left)[:ni]
        moved = np.zeros(nl, bool)
        for j in np.nonzero((thr_p != thr_j) | (dl_p != dl_j))[0]:
            f = int(np.asarray(jt.split_feature)[j])
            rows = np.isin(lid, np.nonzero(under[j])[0])
            miss = nb[f] - 1 if mt[f] == 2 else (db[f] if mt[f] == 1 else -1)
            gp, lp = _exact_gain(bins[f, :ROWS], rows, gqn, hqn, thr_p[j],
                                 dl_p[j], miss)
            gj, lj = _exact_gain(bins[f, :ROWS], rows, gqn, hqn, thr_j[j],
                                 dl_j[j], miss)
            assert abs(gp - gj) <= 1e-6 * max(gp, gj), ("not a tie", it, j)
            ties += 1
            print(f"iteration {it}: tie at node {j} ({thr_p[j]} vs "
                  f"{thr_j[j]})")
            if not np.array_equal(lp, lj):
                moved |= under[j]
        ok = ~np.isin(lid, np.nonzero(moved)[0])
        np.testing.assert_array_equal(plid.numpy()[:ROWS][ok], lid[ok])
        np.testing.assert_array_equal(pt.leaf_count.numpy()[:nl][~moved],
                                      np.asarray(jt.leaf_count)[:nl][~moved])
        np.testing.assert_allclose(pt.leaf_value.numpy()[:nl][~moved],
                                   np.asarray(jt.leaf_value)[:nl][~moved],
                                   rtol=1e-4, atol=1e-6)
        # advance the scores by the JAX tree
        g.scores = g.scores.at[0].add(
            0.1 * jnp.asarray(jt.leaf_value)[jlid])
    print(f"exact ties broken differently: {ties}")


def test_renew_matches_jax():
    jb = _jax_booster(quant_train_renew_leaf=True)
    rng = np.random.RandomState(4)
    n, L = 2048, 15
    leaf_value = rng.randn(L).astype(np.float32)
    leaf_id = rng.randint(0, L - 1, n).astype(np.int32)  # leaf L-1 empty
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) * 0.25).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    want = np.asarray(jb._gbdt._renew_quant_fn(
        jnp.asarray(leaf_value), jnp.asarray(leaf_id), jnp.asarray(grad),
        jnp.asarray(hess), jnp.asarray(mask)))
    got = renew_leaf_values(torch.from_numpy(leaf_value),
                            torch.from_numpy(leaf_id),
                            torch.from_numpy(grad), torch.from_numpy(hess),
                            torch.from_numpy(mask), SplitParams()).numpy()
    assert got[L - 1] == leaf_value[L - 1]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------- K2's launch plans
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F,B", [(28, 255), (5, 63), (40, 16)])
def test_k2_part_plan_covers_each_cell_once(case, F, B):
    """K2's partition plan (4-byte cells): each computed row's values
    take 16 bytes (C + 1 = 3 ints rounded to 4), twice K1's features fit
    the same tile budget (2 groups of 14 at F = 28, B = 255), and the
    work items cut from it cover every (slot, feature, computed row)
    once, so every (slot, feature, bin) cell gets each of its rows once."""
    n, NL = 8192, 16
    plan = th.wave_part_plan(n, F, B, 2, NL, cell_bytes=4)
    k1 = th.wave_part_plan(n, F, B, 2, NL)
    assert plan.QS == 4 and k1.QS == 4     # 16 bytes a row against 32
    assert plan.tile_bytes == 4 * (plan.FG * B * 2 + 1) <= th.TILE_BYTES
    assert 1 <= plan.FG <= 2 * th.TILE_FEATURES and plan.FG >= k1.FG
    if (F, B) == (28, 255):
        assert (plan.FG, k1.FG) == (14, 7)
    assert plan.scratch_bytes >= n * (plan.Fp + 16)
    assert plan.scratch_bytes < k1.scratch_bytes
    slot = _slot_case(case, n, NL, seed=F + B)
    perm, counts, starts = _slot_partition_plain(torch.from_numpy(slot), NL)
    cover = np.zeros((perm.numel(), F), np.int64)
    for s, f0, fg, a, b, owner in _wave_part_items(counts.tolist(), F,
                                                   plan.FG, plan.R):
        assert 0 < b - a <= plan.R and 1 <= fg <= plan.FG
        assert starts[s] <= a and b <= starts[s + 1]
        cover[a:b, f0:f0 + fg] += 1
    assert np.all(cover == 1)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_k2_few_slot_route(S):
    """The wave engine's quantized waves pass num_slots = wave_slot_pad
    (8 for the first five waves of a tree): those take the streaming
    kernel, whose 4-byte tile fits and leaves two blocks or more per
    SM."""
    assert th.wave_slot_pad(S) <= th.K2_FEW_SLOTS
    plan = th.wave_few_plan(28, 255, 2, th.wave_slot_pad(S), cell_bytes=4)
    assert plan.tile_bytes <= th.FEW_TILE_BYTES and plan.blocks_per_sm >= 2


def _wave_fits_before(F, B, L):
    """`gbdt.wave_fits` as it stood before the streaming kernel: K2's
    (slot group x feature group) tile of 8-byte cells (`wave_tile`), K1's
    tile (`tile_feature_group`) and the partition's slot counters."""
    NL, lim = th.wave_slot_pad(L), 232448
    SG = min(NL, lim // (16 * B + 8))
    if SG < 1 or min(F, (lim - 8 * SG) // (SG * 16 * B)) < 1:
        return False
    if min(8, (32768 - 8) // (16 * B)) < 1 and 16 * B + 8 > lim:
        return False
    return lim // (4 * NL) >= 1


def test_wave_fits_decides_auto_as_before():
    """`auto` picks the same engine at every (features, max_bin, leaves)
    as before: the restated `wave_fits` equals the old rule on a grid
    around each of its edges.  Above 14,527 bins, where one feature's
    tile used to exceed a block, the kernels' bin windows make it fit,
    and only the partition's slot counters decide."""
    from lightgbm_tpu_torch.boosting.gbdt import wave_fits
    grid = [(F, B, L)
            for F in (0, 1, 2, 7, 28, 100)
            for B in (2, 15, 63, 255, 256, 1024, 14527, 14528, 20000)
            for L in (2, 7, 8, 31, 255, 1000, 58112, 58113, 60000)]
    got = [wave_fits(*x) for x in grid]
    want = [_wave_fits_before(F, B, L) if B <= 14527
            else F >= 1 and 232448 // (4 * th.wave_slot_pad(L)) >= 1
            for F, B, L in grid]
    assert got == want
    assert any(got) and not all(got)
