"""PyTorch port: the serving daemon on the card.  These tests skip without
a CUDA device.  The file imports neither JAX nor the JAX package, so it
also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.inference import DevicePredictor
from lightgbm_tpu_torch.observability.registry import global_registry
from lightgbm_tpu_torch.serving import ServingDaemon, serve_counters_reset

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)


def _model(rounds=13, leaves=63, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(20000, 12).astype(np.float32)
    X[rng.rand(20000) < 0.1, 0] = np.nan
    y = (np.nan_to_num(X[:, 0]) + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    b = tlgb.train({"objective": "binary", "num_leaves": leaves,
                    "verbosity": -1, "device_type": "cpu"},
                   tlgb.Dataset(X, label=y), rounds)
    return b.model_to_string(), X


@pytest.mark.cuda
def test_card_daemon_sixteen_threads_byte_identical():
    """16 client threads against a daemon on the card: every response is
    byte-identical to Booster.predict on the card (the same traversal),
    the dispatches run on the card, and live traffic first-runs no
    bucket warmup missed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    text, X = _model()
    oracle = tlgb.Booster(model_str=text, params={"device_predict": "true"})
    serve_counters_reset()
    d = ServingDaemon(Config({"device_predict_min_bucket": 256,
                              "serve_max_batch_rows": 4096,
                              "verbosity": -1})).start()
    try:
        d.registry.register("m", model_str=text, block=True)
        assert d.registry.device.type == "cuda"
        before = DevicePredictor.dispatches["cuda"]
        bad, lock = [], threading.Lock()

        def client(tid):
            for i in range(40):
                lo = (tid * 997 + i * 53) % (len(X) - 8)
                rows = X[lo:lo + 1 + (i % 8)]
                out = d.predict("m", rows, timeout=60)
                if out.tobytes() != oracle.predict(rows).tobytes():
                    with lock:
                        bad.append(lo)

        ts = [threading.Thread(target=client, args=(t,)) for t in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not bad, bad[:5]
        assert DevicePredictor.dispatches["cuda"] > before
        assert d.registry.serve_recompiles() == 0
        assert global_registry.counter("serve_errors") == 0
    finally:
        d.stop()


@pytest.mark.cuda
def test_card_roofline_bw_util_at_a_4096_row_bucket():
    """The cost model's bytes are the least the dispatch must move, so
    the measured bandwidth share of a 4096-row bucket stays <= 1.05."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    text, X = _model(rounds=13, leaves=255)
    d = ServingDaemon(Config({"device_predict_min_bucket": 4096,
                              "serve_max_batch_rows": 4096,
                              "verbosity": -1})).start()
    try:
        d.registry.register("m", model_str=text, block=True)
        for i in range(20):
            d.predict("m", X[i * 200:i * 200 + 4096 - 96 * (i % 3)])
        rl = d.stats()["roofline"]
        assert rl["dispatches"] >= 20 and rl["bytes"] > 0
        assert rl["peak_bytes_per_s"] == 3.35e12
        assert 0 < rl["bw_util"] <= 1.05, rl
        assert rl["measured_mfu"] > 0
    finally:
        d.stop()
