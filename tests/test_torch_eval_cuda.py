"""PyTorch port: the device eval tick on the card against the same tick
on the CPU.  These tests skip without a CUDA device.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.metric import create_metrics
from lightgbm_tpu_torch.objective import BinaryLogloss
from lightgbm_tpu_torch.ops import metrics as ops

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.cuda
def test_card_tick_equals_cpu_tick():
    """AUC (tie blocks, NaN), average precision and the pointwise losses
    on 200,000 weighted rows: the card's packed vector within one float32
    rounding of the CPU's (float64 sums that differ only in the order of
    torch.sum), the same bits on a repeat launch, and one transfer per
    DeviceEval tick of a card booster."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(0)
    n = 200_000
    sc = np.round(rng.randn(1, n) * 64) / 64
    sc[0, rng.rand(n) < 0.01] = np.nan
    lab = (rng.rand(n) < 0.4).astype(np.float32)
    w = (rng.rand(n) + 0.5).astype(np.float32)
    pad = np.ones(n, np.float32)
    pad[-100:] = 0.0
    names = ["auc", "average_precision", "binary_logloss", "binary_error",
             "cross_entropy"]
    cfg = Config({"objective": "binary", "metric": names, "verbosity": -1})
    obj = BinaryLogloss(cfg)
    tick = ops.make_tick_fn(ops.build_plans(create_metrics(cfg), cfg, obj,
                                            1), obj, 1, 1)
    args = [torch.from_numpy(a) for a in (sc.astype(np.float32), lab, w,
                                          pad)]
    cpu = tick(*args, torch.tensor(True)).numpy()
    card_args = [a.cuda() for a in args]
    card = tick(*card_args, torch.tensor(True, device="cuda")).cpu().numpy()
    again = tick(*card_args, torch.tensor(True, device="cuda")).cpu().numpy()
    np.testing.assert_array_equal(card, again)
    np.testing.assert_allclose(card, cpu, rtol=2.0 ** -23, atol=0)

    X = rng.randn(20_000, 6).astype(np.float32)
    y = (X[:, 0] + rng.randn(20_000) > 0).astype(np.float32)
    ds = tlgb.Dataset(X, label=y)
    b = tlgb.train({"objective": "binary", "num_leaves": 31,
                    "verbosity": -1, "metric": ["auc", "binary_logloss"]},
                   ds, 4, valid_sets=[ds])
    de = b._gbdt._device_eval
    assert b._gbdt.device.type == "cuda" and de.ok and de.fetches == 4
