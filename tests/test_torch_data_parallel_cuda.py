"""PyTorch port on the card: data-parallel training (tree_learner=data).
World size 1 on NCCL in a child process, and two ranks that share the
card through `train_distributed` (gloo, by the backend rule), each run's
model text equal to the serial card run's byte for byte.  These tests
skip without a CUDA device.  The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_data_parallel_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.distributed import train_distributed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 65_536
PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
          "min_data_in_leaf": 20, "verbosity": -1, "tree_learner": "data",
          "device_type": "cuda"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _data(n=ROWS, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.randn(n) > 0)
    return X, y.astype(np.float32)


def _serial(params, X, y, rounds):
    return tlgb.train(params, tlgb.Dataset(X, label=y), rounds)


@pytest.mark.cuda
def test_gloo_all_reduce_takes_cuda_int64():
    """gloo all-reduces int64 CUDA tensors (sum) and float ones (max),
    the collectives the sharded engines call when ranks share a card."""
    _card()
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "r, store = int(sys.argv[1]), sys.argv[2]\n"
        "torch.cuda.set_device(0)\n"
        "dist.init_process_group('gloo', store=dist.FileStore(store, 2),"
        " rank=r, world_size=2)\n"
        "t = torch.full((3,), 2**40 + r, dtype=torch.int64, device='cuda')\n"
        "dist.all_reduce(t)\n"
        "m = torch.tensor([float(r)], device='cuda')\n"
        "dist.all_reduce(m, op=dist.ReduceOp.MAX)\n"
        "assert t.tolist() == [2**41 + 1] * 3, t\n"
        "assert m.item() == 1.0, m\n"
        "dist.destroy_process_group()\n")
    import tempfile
    store = os.path.join(tempfile.mkdtemp(), "store")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("extra,rounds,kernels", [
    ({}, 4, ("build_histogram_wave", "build_histogram_wave_hl")),
    ({"use_quantized_grad": True}, 3, ("build_histogram_wave_int",)),
    ({"tpu_growth_strategy": "leafwise"}, 3,
     ("build_histogram_rows_pallas",))])
def test_two_ranks_share_the_card(extra, rounds, kernels):
    _card()
    X, y = _data()
    params = {**PARAMS, **extra}
    b = train_distributed(params, X, y, num_boost_round=rounds,
                          num_machines=2, timeout=300)
    assert b.model_to_string() == _serial(params, X, y,
                                          rounds).model_to_string()
    for st in b.worker_stats:
        assert st["backend"] == "gloo" and st["world"] == 2
        assert all(st["launches"][k] > 0 for k in kernels), st
        assert st["allreduce_bytes"] > 0


@pytest.mark.cuda
def test_world_one_on_nccl(tmp_path):
    """One rank joins a one-machine cluster over a TCPStore: NCCL by the
    backend rule, the serial card run's model text."""
    _card()
    X, y = _data(seed=1)
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "y.npy", y)
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out = tmp_path / "model.txt"
    code = (
        "import json, sys, numpy as np\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import lightgbm_tpu_torch as tlgb\n"
        "from lightgbm_tpu_torch.distributed import join_cluster, "
        "leave_cluster\n"
        "from lightgbm_tpu_torch.parallel import current_network\n"
        f"join_cluster(['localhost:{port}'], rank=0, initialize_timeout=60)\n"
        f"X = np.load({str(tmp_path / 'X.npy')!r})\n"
        f"y = np.load({str(tmp_path / 'y.npy')!r})\n"
        f"b = tlgb.train({PARAMS!r}, tlgb.Dataset(X, label=y), 3)\n"
        "assert current_network().backend == 'nccl'\n"
        f"open({str(out)!r}, 'w').write(b.model_to_string())\n"
        "leave_cluster()\n")
    p = subprocess.Popen([sys.executable, "-c", code])
    try:
        assert p.wait(timeout=300) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert out.read_text() == _serial(PARAMS, X, y, 3).model_to_string()
