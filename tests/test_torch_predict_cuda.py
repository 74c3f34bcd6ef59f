"""PyTorch port: the tensor traversal on the card against the same
traversal on the CPU.  These tests skip without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_predict_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.inference import DevicePredictor

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.cuda
def test_card_traversal_equals_cpu_traversal():
    """Leaf ids equal; raw scores equal bit for bit (float32 sums in tree
    order on both devices); the card's dispatches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    X = rng.randn(4096, 6).astype(np.float32)
    X[rng.rand(4096) < 0.15, 0] = np.nan
    X[:, 4] = np.where(rng.rand(4096) < 0.3, 0.0, X[:, 4])
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] > 0).astype(np.float32)
    b = tlgb.train({"objective": "binary", "num_leaves": 31,
                    "verbosity": -1, "device_type": "cpu"},
                   tlgb.Dataset(X, label=y), num_boost_round=8)
    trees = b._gbdt.models_
    Xt = X.copy()
    Xt[:6, 2] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, 1e30]
    cpu = DevicePredictor(trees, min_bucket=256, device="cpu")
    card = DevicePredictor(trees, min_bucket=256, device="cuda")
    before = DevicePredictor.dispatches["cuda"]
    np.testing.assert_array_equal(card.predict_leaf(Xt),
                                  cpu.predict_leaf(Xt))
    np.testing.assert_array_equal(card.predict_raw(Xt), cpu.predict_raw(Xt))
    np.testing.assert_array_equal(
        card.predict_raw(Xt, early_stop=(2, 0.5)),
        cpu.predict_raw(Xt, early_stop=(2, 0.5)))
    assert DevicePredictor.dispatches["cuda"] == before + 3
