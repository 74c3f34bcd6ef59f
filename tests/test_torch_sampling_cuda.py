"""PyTorch port: row and column sampling on the card against the same
training on the CPU.  These tests skip without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_sampling_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"bagging_fraction": 0.8, "bagging_freq": 1, "feature_fraction": 0.8},
    {"extra_trees": True, "bagging_fraction": 0.8, "bagging_freq": 1,
     "tpu_growth_strategy": "leafwise"}],
    ids=["bagging_wave", "extra_trees_leafwise"])
def test_card_trees_equal_cpu_trees(extra):
    """Three iterations at 20,000 x 12, 31 leaves: the NumPy bag and
    column draws and the threefry thresholds are the same bits on both
    devices, so the card grows the CPU's trees (split features and
    thresholds equal, leaf values within rtol 1e-4) and bags
    int(n * 0.8) rows each iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(3)
    n = 20_000
    X = rng.randn(n, 12).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(n) > 0).astype(np.float32)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, **extra}
    models = {}
    for dev in ("cuda", "cpu"):
        b = tlgb.Booster({**params, "device_type": dev},
                         tlgb.Dataset(X, label=y))
        for _ in range(3):
            assert not b.update()
            assert int(b._gbdt._bag_mask_host[:n].sum()) == int(n * 0.8)
        models[dev] = b._gbdt.models_
    for i, (a, c) in enumerate(zip(models["cuda"], models["cpu"])):
        ni = a.num_leaves - 1
        assert a.num_leaves == c.num_leaves, i
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      c.split_feature[:ni])
        np.testing.assert_array_equal(a.threshold[:ni], c.threshold[:ni])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4)
