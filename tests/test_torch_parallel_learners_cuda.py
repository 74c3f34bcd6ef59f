"""PyTorch port on the card: the feature- and voting-parallel learners
and the elastic shrink.  Two ranks share the card through
`train_distributed` (gloo, by the backend rule): the feature learner's
model text equals the serial card run's byte for byte on the wave,
quantized and leaf-wise engines (K1, K2, K3 and K4 launched over each
rank's block of columns), the voting learner's at top_k >= F (K4 over
each rank's rows); and a 2 -> 1 shrink after a lost rank resumes on one
rank over NCCL to the serial card run's trees.  These tests skip without
a CUDA device.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_learners_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.distributed import train_distributed

torch.set_num_threads(1)

ROWS = 65_536
PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
          "min_data_in_leaf": 20, "verbosity": -1, "device_type": "cuda"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _data(n=ROWS, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


def _serial_text(params, X, y, rounds):
    return tlgb.train(params, tlgb.Dataset(X, label=y),
                      rounds).model_to_string()


@pytest.mark.cuda
@pytest.mark.parametrize("extra,rounds,kernels", [
    ({"tree_learner": "feature"}, 4,
     ("build_histogram_wave", "build_histogram_wave_hl")),
    ({"tree_learner": "feature", "use_quantized_grad": True}, 3,
     ("build_histogram_wave_int",)),
    ({"tree_learner": "feature", "tpu_growth_strategy": "leafwise"}, 3,
     ("build_histogram_rows_pallas",)),
    ({"tree_learner": "voting", "top_k": 8,
      "tpu_growth_strategy": "leafwise"}, 3,
     ("build_histogram_rows_pallas",))],
    ids=["feature_wave", "feature_quantized", "feature_leafwise",
         "voting_full_topk"])
def test_two_ranks_share_the_card(extra, rounds, kernels):
    _card()
    X, y = _data()
    params = {**PARAMS, **extra}
    b = train_distributed(params, X, y, num_boost_round=rounds,
                          num_machines=2, timeout=300)
    want = _serial_text({**params, "tree_learner": "serial"}, X, y, rounds)
    assert (b.model_to_string().split("\nparameters:")[0]
            == want.split("\nparameters:")[0])
    for st in b.worker_stats:
        assert st["backend"] == "gloo" and st["world"] == 2
        assert all(st["launches"][k] > 0 for k in kernels), st
        assert st["allreduce_calls"] > 0


@pytest.mark.cuda
def test_lost_rank_shrinks_onto_nccl():
    """worker_lost@2 on rank 1 of 2: the relaunch is one rank, which has
    the card to itself (NCCL), resumes from the checkpoint and ends with
    the serial card run's trees."""
    _card()
    X, y = _data(seed=1)
    params = {**PARAMS, "tree_learner": "data"}
    b = train_distributed(params, X, y, num_boost_round=4, num_machines=2,
                          timeout=300, max_retries=1, retry_backoff=0.01,
                          worker_env={"LGBM_TPU_FAULT": "worker_lost@2",
                                      "LGBM_TPU_FAULT_RANK": "1"})
    assert b.elastic_shrinks == 1 and b.final_num_machines == 1
    assert [st["backend"] for st in b.worker_stats] == ["nccl"]
    assert b.model_to_string() == _serial_text(params, X, y, 4)
