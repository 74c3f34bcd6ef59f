"""PyTorch port: the split scan's categorical, monotone, path-smoothing
and CEGB branches (ops/split.py find_best_split) against the JAX
package's on identical histograms.

Six features: three numerical (no, zero and NaN missing types) and three
categorical (4 bins, one-hot mode at the default max_cat_to_onehot; 20
and 32 bins, sorted-subset mode), whose category effects make them win
most leaves.  Per leaf, the feature, threshold, default_left, is_cat,
the bitset and the child counts must be identical; floats agree to 1e-6
of their scale, as tests/test_torch_split.py states.  The port sums the
sorted-subset prefixes in float64 and the JAX package in float32, so the
gains differ by float32 ulps at the leaf's scale.  The port scans all
leaves at once; the JAX package is called once per leaf.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts

F, B, L = 6, 32, 6
NUM_BIN = np.array([B, 4, 12, 20, 9, 32], np.int32)
MISSING = np.array([0, 0, 1, 0, 2, 0], np.int32)
DEFAULT_BIN = np.array([0, 0, 3, 0, 0, 0], np.int32)
IS_CAT = np.array([0, 1, 0, 1, 0, 1], bool)
CAT = (1, 3, 5)
MONO = np.array([1, 0, -1, 0, 1, 0], np.int32)


def _leaves(seed, n=4000):
    """Per-leaf [F, B, 2] histograms of rows made from a seed; categorical
    codes are geometric (a few categories hold most rows, some fewer
    than cat_smooth)."""
    rng = np.random.RandomState(seed)
    bins = np.stack([
        np.minimum(rng.geometric(0.15, n), NUM_BIN[f] - 1) if IS_CAT[f]
        else rng.randint(0, NUM_BIN[f], n) for f in range(F)])
    effect = rng.randn(F, B)
    grad = rng.randn(n) + sum(effect[f, bins[f]] for f in CAT)
    grad += 0.3 * (bins[0] - B / 2) / B          # a trend on feature 0
    grad = grad.astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    leaf = rng.randint(0, L, n)
    hists, sg, sh, cnt = [], [], [], []
    for l in range(L):
        m = leaf == l
        h = np.zeros((F, B, 2), np.float64)
        for f in range(F):
            np.add.at(h[f, :, 0], bins[f, m], grad[m])
            np.add.at(h[f, :, 1], bins[f, m], hess[m])
        hists.append(h.astype(np.float32))
        sg.append(np.float32(grad[m].astype(np.float64).sum()))
        sh.append(np.float32(hess[m].astype(np.float64).sum()))
        cnt.append(int(m.sum()))
    return (np.stack(hists), np.array(sg, np.float32),
            np.array(sh, np.float32), np.array(cnt, np.int32))


def _jax_pen(depth, pen):
    """The JAX engines' depth penalty (learner/grow.py:374-382)."""
    d = jnp.asarray(depth, jnp.float32)
    return jnp.where(pen >= d + 1.0, 1e-15,
                     jnp.where(pen <= 1.0, 1.0 - pen / jnp.exp2(d) + 1e-15,
                               1.0 - jnp.exp2(pen - 1.0 - d) + 1e-15))


def _compare(seed, kw, po=None, rand=False, mono=None, cegb=None):
    """Scan the leaves of `seed` in both packages with SplitParams(**kw)
    and the per-leaf inputs given; returns the port's result."""
    hists, sg, sh, cnt = _leaves(seed)
    jp = js.SplitParams(has_categorical=True, cat_features=CAT, **kw)
    tp = ts.SplitParams(has_categorical=True, cat_features=CAT, **kw)
    pen = np.ones(F, np.float32)
    cm = np.ones(F, bool)
    po = np.zeros(L, np.float32) if po is None else po
    t_kw, j_kw = {}, [{} for _ in range(L)]
    if rand:
        rng = np.random.RandomState(seed + 100)
        rb = rng.randint(0, 10, (L, F)).astype(np.int32)
        ru = rng.rand(L, F, 2).astype(np.float32)
        t_kw.update(rand_bin=torch.from_numpy(rb),
                    rand_cat_u=torch.from_numpy(ru))
        for l in range(L):
            j_kw[l].update(rand_bin=jnp.asarray(rb[l]),
                           rand_cat_u=jnp.asarray(ru[l]))
    if mono is not None:
        cmin, cmax, depth = mono
        t_kw.update(monotone=torch.from_numpy(MONO),
                    constraint_min=torch.from_numpy(cmin),
                    constraint_max=torch.from_numpy(cmax),
                    mono_penalty=ts.monotone_gain_penalty(
                        torch.from_numpy(depth), kw.get("monotone_penalty",
                                                        0.0)))
        for l in range(L):
            j_kw[l].update(monotone=jnp.asarray(MONO),
                           constraint_min=jnp.asarray(cmin[l]),
                           constraint_max=jnp.asarray(cmax[l]),
                           mono_penalty=_jax_pen(
                               depth[l], kw.get("monotone_penalty", 0.0)))
    if cegb is not None:
        coupled, used = cegb
        t_kw.update(cegb_coupled=torch.from_numpy(coupled),
                    cegb_used=torch.from_numpy(used))
        for l in range(L):
            j_kw[l].update(cegb_coupled=jnp.asarray(coupled),
                           cegb_used=jnp.asarray(used))
    port = ts.find_best_split(
        torch.from_numpy(hists), torch.from_numpy(NUM_BIN),
        torch.from_numpy(MISSING), torch.from_numpy(DEFAULT_BIN),
        torch.from_numpy(pen), torch.from_numpy(cm), torch.from_numpy(sg),
        torch.from_numpy(sh), torch.from_numpy(cnt), torch.from_numpy(po),
        tp, is_cat_feature=torch.from_numpy(IS_CAT), **t_kw)
    l2 = kw.get("lambda_l2", 0.0) + kw.get("cat_l2", 10.0)
    for l in range(L):
        ref = js.find_best_split(
            jnp.asarray(hists[l]), jnp.asarray(NUM_BIN), jnp.asarray(MISSING),
            jnp.asarray(DEFAULT_BIN), jnp.asarray(pen), jnp.asarray(cm),
            jnp.asarray(sg[l]), jnp.asarray(sh[l]), jnp.asarray(cnt[l]),
            jnp.asarray(po[l]), jp, is_cat_feature=jnp.asarray(IS_CAT),
            **j_kw[l])
        for k in ("feature", "threshold", "default_left", "is_cat",
                  "left_count", "right_count"):
            assert int(getattr(port, k)[l]) == int(getattr(ref, k)), (l, k)
        np.testing.assert_array_equal(port.cat_bitset[l].numpy(),
                                      np.asarray(ref.cat_bitset),
                                      err_msg=f"leaf {l} bitset")
        if not ref.gain > -np.inf:
            assert float(port.gain[l]) == float(ref.gain)
            continue
        g_abs = float(np.abs(hists[l][0, :, 0]).sum())
        h_tot = float(sh[l])
        parent = float(sg[l]) ** 2 / (h_tot + kw.get("lambda_l2", 0.0))
        out_scale = g_abs / min(float(ref.left_sum_hessian),
                                float(ref.right_sum_hessian)) + float(
                                    np.abs(po[l]))
        scales = {"gain": abs(float(ref.gain)) + parent + g_abs ** 2 / l2,
                  "left_sum_gradient": g_abs, "right_sum_gradient": g_abs,
                  "left_sum_hessian": h_tot, "right_sum_hessian": h_tot,
                  "left_output": out_scale, "right_output": out_scale}
        for k, scale in scales.items():
            got, want = float(getattr(port, k)[l]), float(getattr(ref, k))
            assert abs(got - want) <= 1e-6 * scale, (l, k, got, want)
    return port


CAT_CASES = {
    "defaults": {},
    # one-hot up to 20 bins, small cat_l2/cat_smooth, few categories per
    # subset, small groups
    "onehot_wide": dict(max_cat_to_onehot=20, cat_l2=1.0, cat_smooth=2.0),
    "subset_small": dict(cat_l2=1.0, cat_smooth=5.0, max_cat_threshold=4,
                         min_data_per_group=20),
    "regularized": dict(lambda_l1=0.5, lambda_l2=2.0, min_data_in_leaf=40,
                        max_delta_step=0.5, min_data_per_group=200),
}


@pytest.mark.parametrize("case", list(CAT_CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_scan_matches_jax(case, seed):
    port = _compare(seed, CAT_CASES[case])
    assert bool(port.is_cat.any()), "no categorical winner to compare"


@pytest.mark.parametrize("seed", [2, 3])
def test_categorical_extra_trees_draws_match_jax(seed):
    """USE_RAND: the one-hot candidate bin and the sorted-subset prefix
    length come from rand_cat_u; the numerical thresholds from rand_bin."""
    port = _compare(seed, dict(extra_trees=True, cat_smooth=5.0,
                               min_data_per_group=20), rand=True)
    assert bool(port.is_cat.any())


def _bounds(seed):
    """Per-leaf monotone bounds (some unbounded) and depths."""
    rng = np.random.RandomState(seed + 50)
    cmin = np.where(rng.rand(L) < 0.4, -np.inf,
                    -0.3 * rng.rand(L)).astype(np.float32)
    cmax = np.where(rng.rand(L) < 0.4, np.inf,
                    0.3 * rng.rand(L)).astype(np.float32)
    depth = rng.randint(0, 6, L).astype(np.int32)
    return cmin, cmax, depth


@pytest.mark.parametrize("penalty", [0.0, 0.8, 2.5])
def test_monotone_scan_matches_jax(penalty):
    """Outputs clamped to each leaf's [cmin, cmax], order-breaking splits
    of monotone features scored 0, and the depth penalty on monotone
    features' gains (both formulas of monotone_gain_penalty)."""
    port = _compare(4, dict(has_monotone=True, monotone_penalty=penalty),
                    mono=_bounds(4))
    cmin, cmax, _ = _bounds(4)
    for out in (port.left_output, port.right_output):
        assert (out.numpy() >= cmin).all() and (out.numpy() <= cmax).all()


def test_monotone_penalty_formula_matches_jax():
    depth = np.arange(8, dtype=np.int32)
    for pen in (0.0, 0.5, 1.0, 1.5, 3.0, 9.0):
        np.testing.assert_array_equal(
            ts.monotone_gain_penalty(torch.from_numpy(depth), pen).numpy(),
            np.asarray(_jax_pen(depth, pen)))


@pytest.mark.parametrize("smooth", [1.0, 50.0])
def test_path_smooth_scan_matches_jax(smooth):
    po = np.random.RandomState(9).randn(L).astype(np.float32)
    _compare(5, dict(path_smooth=smooth, max_delta_step=0.8), po=po)


@pytest.mark.parametrize("tradeoff", [1.0, 0.3])
def test_cegb_scan_matches_jax(tradeoff):
    """DeltaGain: tradeoff * (penalty_split * leaf rows + the coupled
    penalty of each feature no earlier split used)."""
    coupled = np.array([5.0, 40.0, 0.0, 80.0, 3.0, 20.0], np.float32)
    used = np.array([0, 1, 0, 0, 1, 0], bool)
    port = _compare(6, dict(has_cegb=True, cegb_tradeoff=tradeoff,
                            cegb_penalty_split=0.01), cegb=(coupled, used))
    # the same scan without the penalties picks a higher gain
    free = _compare(6, {})
    assert (port.gain <= free.gain).all()


def test_every_branch_at_once_matches_jax():
    po = np.random.RandomState(10).randn(L).astype(np.float32) * 0.1
    coupled = np.full(F, 10.0, np.float32)
    used = np.zeros(F, bool)
    _compare(7, dict(has_monotone=True, monotone_penalty=1.5,
                     path_smooth=2.0, extra_trees=True, has_cegb=True,
                     cegb_penalty_split=0.005, cat_smooth=5.0,
                     min_data_per_group=20), po=po, rand=True,
             mono=_bounds(7), cegb=(coupled, used))
