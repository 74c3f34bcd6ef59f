"""PyTorch port: the linear-leaf fit on the card.  These tests skip
without a CUDA device.  The file imports neither JAX nor the JAX
package, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_linear_cuda.py

* The device fit gives the same bits on every run.
* At 2^20 rows it gives each row the output of the plain version
  (`calculate_linear_plain`, NumPy float64) within 1e-9 · max(1,
  |output|), with every leaf fitted or kept the same way.
* A card booster's training scores equal the host float64 predictions
  of its linear trees within float32 rounding.
"""

import copy

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.learner.linear import (calculate_linear_plain,
                                               fit_linear, linear_outputs,
                                               raw_to_device)

torch.set_num_threads(1)

FIT_REL = 1e-9


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _problem(n, F=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.01] = np.nan
    Z = np.nan_to_num(X)
    y = (np.where(Z[:, 0] > 0, 2 * Z[:, 1], -Z[:, 2]) + Z[:, 3] * Z[:, 4]
         + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _tree_and_inputs(n):
    X, y = _problem(n)
    b = tlgb.train({"objective": "regression", "num_leaves": 63,
                    "verbosity": -1, "device_type": "cpu",
                    "tpu_growth_strategy": "leafwise"},
                   tlgb.Dataset(X[:65536], label=y[:65536]), 1)
    tree = b._gbdt.models_[0]
    ds = b._gbdt.train_data
    lid = tree.get_leaf_index(X.astype(np.float64))
    rng = np.random.RandomState(1)
    g = rng.randn(n).astype(np.float32)
    h = (0.1 + rng.rand(n)).astype(np.float32)
    is_num = (lambda f: ds.bin_mappers[f].bin_type == 0)
    return X, tree, lid, g, h, is_num, ds.inner_feature_index


def _device_fit(X, tree, lid, g, h, is_num, inner):
    t = copy.deepcopy(tree)
    dev = torch.device("cuda")
    stats = fit_linear(t, raw_to_device(X, dev),
                       torch.from_numpy(lid).to(dev),
                       torch.from_numpy(g).to(dev),
                       torch.from_numpy(h).to(dev), 0.1, is_num, inner)
    return t, stats


@pytest.mark.cuda
def test_device_fit_is_deterministic_and_equals_plain():
    _needs_card()
    n = 1 << 20
    X, tree, lid, g, h, is_num, inner = _tree_and_inputs(n)
    t1, s1 = _device_fit(X, tree, lid, g, h, is_num, inner)
    t2, _ = _device_fit(X, tree, lid, g, h, is_num, inner)
    nl = t1.num_leaves
    assert list(t1.leaf_const[:nl]) == list(t2.leaf_const[:nl])
    assert t1.leaf_coeff[:nl] == t2.leaf_coeff[:nl]
    tp = copy.deepcopy(tree)
    sp = calculate_linear_plain(tp, X.astype(np.float64), lid, g, h, 0.1,
                                is_num, inner)
    assert (s1.fitted, s1.degenerate) == (sp.fitted, sp.degenerate)
    raw = raw_to_device(X, torch.device("cpu"))
    a, b = (linear_outputs(t, raw, torch.from_numpy(lid)).numpy()
            for t in (tp, t1))
    assert (np.abs(a - b) <= FIT_REL * np.maximum(1.0, np.abs(a))).all()


@pytest.mark.cuda
def test_card_training_scores_equal_host_predictions():
    _needs_card()
    X, y = _problem(200_000)
    b = tlgb.train({"objective": "regression", "num_leaves": 63,
                    "linear_tree": True, "verbosity": -1},
                   tlgb.Dataset(X, label=y), 4)
    g = b._gbdt
    assert all(t.is_linear for t in g.models_)
    host = g._predict_raw_impl(X.astype(np.float64), 0, -1, False, 10, 10.0)
    scores = g.scores[0, :len(X)].cpu().numpy().astype(np.float64)
    bound = 2 * 4 * 2.0 ** -24 * sum(np.abs(t.predict(X.astype(np.float64)))
                                     for t in g.models_)
    assert (np.abs(scores - host) <= bound + 1e-12).all()
