"""PyTorch port: checkpoints and training telemetry on the card.  These
tests skip without a CUDA device.  The file imports neither JAX nor the
JAX package, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_reliability_cuda.py
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "verbosity": -1, "bagging_fraction": 0.8, "bagging_freq": 1}


def _data(n=20_000, F=12, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + rng.randn(n) > 0).astype(np.float32)
    return X, y


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_async_capture_equals_sync_capture():
    """The writer's pinned non_blocking copy, read after its event, holds
    the bits of the synchronous capture; a later update does not reach
    a snapshot taken before it."""
    _need_card()
    X, y = _data()
    b = tlgb.Booster(dict(PARAMS), tlgb.Dataset(X, label=y))
    for _ in range(3):
        b.update()
    g = b._gbdt
    pending = g.capture_train_state(async_copy=True)
    sync = g.capture_train_state(async_copy=False)
    b.update()                      # changes the live buffer in place
    got = np.asarray(pending["scores"])
    assert got.dtype == np.float32 and got.shape == sync["scores"].shape
    assert np.array_equal(got, sync["scores"])
    assert not np.array_equal(got, g.scores.cpu().numpy())
    for k in ("num_data", "bag_mask"):
        assert np.array_equal(pending[k], sync[k])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{}, {"tpu_growth_strategy": "leafwise"},
                                   {"use_quantized_grad": True}],
                         ids=["wave", "leafwise", "quantized"])
def test_resume_on_the_card_is_byte_identical(tmp_path, extra):
    _need_card()
    X, y = _data()
    p = {**PARAMS, **extra}
    full = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 8)
    ck = str(tmp_path / "ck")
    tlgb.train(dict(p), tlgb.Dataset(X, label=y), 5, checkpoint_dir=ck,
               checkpoint_freq=5)
    resumed = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 8,
                         checkpoint_dir=ck, checkpoint_freq=5)
    assert resumed._gbdt.device.type == "cuda"
    assert resumed.model_to_string(num_iteration=-1) \
        == full.model_to_string(num_iteration=-1)


@pytest.mark.cuda
def test_memory_gauges_in_the_event_log(tmp_path):
    """nonfinite_check_freq=1 samples the card's allocator every
    iteration: the iteration events carry non-empty device gauges."""
    _need_card()
    X, y = _data()
    mx = str(tmp_path / "mx")
    tlgb.train(dict(PARAMS, nonfinite_check_freq=1),
               tlgb.Dataset(X, label=y), 3, metrics_dir=mx)
    with open(os.path.join(mx, "events-rank0.jsonl")) as f:
        ev = [json.loads(line) for line in f]
    its = [e for e in ev if e["event"] == "iteration"]
    assert len(its) == 3
    for e in its[1:]:
        g = e["gauges"]
        assert g["device_bytes_in_use"] > 0
        assert g["device_peak_bytes_in_use"] >= g["device_bytes_in_use"]
        assert g["device_bytes_limit"] > g["device_peak_bytes_in_use"]
