"""PyTorch port: the split scan's categorical, monotone, path-smoothing
and CEGB branches on the card against the same scan on the CPU, and
categorical training on the card against the CPU's.  These tests skip
without a CUDA device.  The file imports neither JAX nor the JAX
package, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_categorical_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import split as ts

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)


def _scan_inputs(L=128, F=28, B=255, seed=0):
    """Per-leaf histograms at the main path's width: features 0, 1 and 3
    categorical (3, 32 and 200 categories plus the NaN/other bin 0)."""
    rng = np.random.RandomState(seed)
    num_bin = np.full(F, B, np.int32)
    num_bin[[0, 1, 3]] = [4, 33, 201]
    is_cat = np.zeros(F, bool)
    is_cat[[0, 1, 3]] = True
    hist = np.zeros((L, F, B, 2), np.float32)
    for f in range(F):
        nb = num_bin[f]
        cnt = rng.poisson(40.0, (L, nb)).astype(np.float32)
        hist[:, f, :nb, 1] = cnt * 0.2
        hist[:, f, :nb, 0] = rng.randn(L, nb) * np.sqrt(cnt) + (
            rng.randn(nb) * cnt if is_cat[f] else 0.0)
    # every feature of a leaf holds the same rows: totals from feature 2
    sg = hist[:, 2, :, 0].sum(1)
    sh = hist[:, 2, :, 1].sum(1)
    for f in range(F):
        nb = num_bin[f]
        hist[:, f, 1:nb] *= (sh / hist[:, f, :, 1].sum(1))[:, None, None]
        hist[:, f, 0, 0] = sg - hist[:, f, 1:nb, 0].sum(1)
        hist[:, f, 0, 1] = sh - hist[:, f, 1:nb, 1].sum(1)
    cnt = np.round(sh / 0.2).astype(np.int32)
    meta = (num_bin, np.zeros(F, np.int32), np.zeros(F, np.int32), is_cat)
    return hist, sg, sh, cnt, meta, rng


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"extra_trees": True},
                                   {"monotone": True, "smooth": True,
                                    "cegb": True}],
                         ids=["categorical", "categorical_extra_trees",
                              "monotone_smooth_cegb"])
def test_scan_on_card_equals_cpu(extra):
    """128 leaves x 28 features x 255 bins: the same winners, bitsets and
    counts on both devices; floats within 1e-6 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hist, sg, sh, cnt, (nb, mt, db, is_cat), rng = _scan_inputs()
    L, F = hist.shape[:2]
    p = ts.SplitParams(has_categorical=True,
                       cat_features=tuple(np.nonzero(is_cat)[0].tolist()),
                       min_data_per_group=50,
                       extra_trees=bool(extra.get("extra_trees")),
                       has_monotone=bool(extra.get("monotone")),
                       monotone_penalty=1.5,
                       path_smooth=2.0 if extra.get("smooth") else 0.0,
                       has_cegb=bool(extra.get("cegb")),
                       cegb_penalty_split=1e-3)
    po = (rng.randn(L) * 0.1).astype(np.float32)
    kw = {}
    if p.extra_trees:
        kw["rand_bin"] = rng.randint(0, 200, (L, F)).astype(np.int32)
        kw["rand_cat_u"] = rng.rand(L, F, 2).astype(np.float32)
    if p.has_monotone:
        mono = np.zeros(F, np.int32)
        mono[[2, 5, 8]] = [1, -1, 1]
        kw.update(monotone=mono,
                  constraint_min=np.full(L, -0.2, np.float32),
                  constraint_max=np.full(L, 0.3, np.float32),
                  mono_penalty=ts.monotone_gain_penalty(
                      torch.from_numpy(rng.randint(0, 8, L)), 1.5).numpy())
    if p.has_cegb:
        kw.update(cegb_coupled=np.full(F, 30.0, np.float32),
                  cegb_used=rng.rand(F) < 0.5)
    res = {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        res[dev] = ts.find_best_split(
            t(hist), t(nb), t(mt), t(db), t(np.ones(F, np.float32)),
            t(np.ones(F, bool)), t(sg), t(sh), t(cnt), t(po), p,
            is_cat_feature=t(is_cat), **{k: t(v) for k, v in kw.items()})
    card, cpu = res["cuda"], res["cpu"]
    assert bool(cpu.is_cat.any()) and bool((cpu.gain > 0).any())
    for k in ("feature", "threshold", "default_left", "is_cat",
              "left_count", "right_count", "cat_bitset"):
        np.testing.assert_array_equal(getattr(card, k).cpu().numpy(),
                                      getattr(cpu, k).numpy(), err_msg=k)
    for k in ("gain", "left_sum_gradient", "left_sum_hessian",
              "left_output", "right_output"):
        np.testing.assert_allclose(getattr(card, k).cpu().numpy(),
                                   getattr(cpu, k).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_categorical_training_on_card_equals_cpu(engine):
    """Three iterations at 20,000 x 12 with categorical columns 0 (one-hot)
    and 3 (sorted subset): the same trees and category sets on both
    devices, leaf values within rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(3)
    n = 20_000
    X = rng.randn(n, 12).astype(np.float32)
    X[:, 0] = rng.randint(0, 3, n)
    X[:, 3] = rng.randint(0, 40, n)
    eff = rng.randn(40)
    y = (X[:, 1] + eff[X[:, 3].astype(int)] - (X[:, 0] == 2)
         + rng.randn(n) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, "tpu_growth_strategy": engine}
    models = {}
    for dev in ("cuda", "cpu"):
        b = tlgb.train({**params, "device_type": dev},
                       tlgb.Dataset(X, label=y, categorical_feature=[0, 3]),
                       3)
        models[dev] = b._gbdt.models_
    n_cat = 0
    for a, c in zip(models["cuda"], models["cpu"]):
        ni = a.num_leaves - 1
        assert a.num_leaves == c.num_leaves
        for k in ("split_feature", "threshold", "decision_type"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(c, k)[:ni])
        assert a.cat_threshold == c.cat_threshold
        assert a.cat_boundaries == c.cat_boundaries
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4)
        n_cat += a.num_cat
    assert n_cat > 0
