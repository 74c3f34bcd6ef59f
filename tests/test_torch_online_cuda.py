"""PyTorch port on the card: K1-K4 on int32 bin codes (more than 65,536
bins in one column) against their plain versions, and the online loop
training and serving on the card.  These tests skip without a CUDA
device.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_online_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import histogram as th

torch.set_num_threads(1)

SENTINEL = 10 ** 6
WAIT_S = 120.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, F, B, slots, seed, dev, qbins=0):
    """int32 codes in [0, B) (a few rows past B, which match nothing),
    slots with a sentinel share, gh with a count column; quantized gh on
    a grid of `qbins` levels when qbins > 0."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, B + 3, size=(F, n))
    binned = th.codes_to_device(codes, dev, num_bin=B + 3)
    slot = rng.randint(0, 2 * slots, size=n).astype(np.int32)
    slot = np.where(slot < slots, slot, SENTINEL).astype(np.int32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    if qbins:
        scales = np.array([0.0123, 0.0456], np.float32)
        grad = rng.randint(-qbins // 2, qbins // 2 + 1, n) * scales[0]
        hess = rng.randint(0, qbins + 1, n) * scales[1]
    else:
        scales = None
        grad, hess = rng.randn(n), rng.rand(n)
    gh = np.stack([grad * mask, hess * mask, mask], 1).astype(np.float32)
    out = (binned, torch.from_numpy(slot).to(dev),
           torch.from_numpy(gh).to(dev))
    if scales is not None:
        out += (torch.from_numpy(scales).to(dev),)
    return out


def _eq(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [70000, 131072])
def test_k1_k3_on_int32_codes(B):
    """K1 (partition) and K3 (streaming) on int32 codes, in bin windows:
    bit for bit their plain versions and themselves on a repeat, each
    call one launch."""
    dev = _card()
    n, F = 1 << 14, 2
    binned, slot, gh = _inputs(n, F, B, 12, seed=B, dev=dev)
    assert binned.dtype == torch.int32
    e = th.scale_exps(gh)
    c1 = th.build_histogram_wave.launches
    k = th.build_histogram_wave_fixed(binned, slot, gh, e, max_bin=B,
                                      num_slots=12)
    k2 = th.build_histogram_wave_fixed(binned, slot, gh, e, max_bin=B,
                                       num_slots=12)
    assert th.build_histogram_wave.launches == c1 + 2
    p = th.build_histogram_wave_plain(binned, slot, gh, max_bin=B,
                                      num_slots=12, exps=e, fixed=True)
    assert _eq(k, p) and _eq(k, k2)
    sk = torch.where(slot < 2, slot, torch.full_like(slot, SENTINEL))
    c3 = th.build_histogram_wave_hl.launches
    kh = th.build_histogram_wave_hl_fixed(binned, binned.t(), sk, gh, e,
                                          max_bin=B, num_slots=2,
                                          out_slots=8)
    assert th.build_histogram_wave_hl.launches == c3 + 1
    ph = th.build_histogram_wave_hl_plain(binned, binned.t(), sk, gh,
                                          max_bin=B, num_slots=2,
                                          out_slots=8, exps=e, fixed=True)
    assert _eq(kh, ph)


@pytest.mark.cuda
@pytest.mark.parametrize("few", [True, False])
def test_k2_on_int32_codes(few):
    """K2's two routes on int32 codes: exact integer sums."""
    dev = _card()
    n, F, NL, B = 1 << 14, 2, 8, 70000
    binned, slot, gh, sc = _inputs(n, F, B, NL, seed=7, dev=dev, qbins=4)
    k = th._launch_wave_int(binned, slot, gh, sc, B, NL, False, few=few)
    p = th.build_histogram_wave_int_plain(binned, slot, gh, sc, max_bin=B,
                                          num_slots=NL, fixed=True)
    assert _eq(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [512, 1 << 14])
def test_k4_on_int32_codes(S):
    """K4 on row-major int32 codes, one block (the owner stores) and many,
    in bin windows."""
    dev = _card()
    F, B = 3, 70000
    binned, _, gh = _inputs(S, F, B, 1, seed=S, dev=dev)
    rows = binned.t().contiguous()
    g2 = gh[:, :2].contiguous()
    mask = gh[:, 2].contiguous()
    e = th.scale_exps(g2 * mask[:, None])
    c4 = th.build_histogram_rows_pallas.launches
    k = th.build_histogram_rows_fixed(rows, g2, mask, e, max_bin=B)
    assert th.build_histogram_rows_pallas.launches == c4 + 1
    p = th.build_histogram_rows_plain(rows, g2, mask, max_bin=B, exps=e,
                                      fixed=True)
    assert torch.equal(k, p)


@pytest.mark.cuda
def test_online_loop_on_the_card(tmp_path):
    """Three boost generations (15 leaves: the wave engine, whose waves
    of at most 8 computed slots all go to K3) into a daemon on the card;
    each published generation serves `Booster.predict` of its text on
    the card byte for byte."""
    _card()
    from lightgbm_tpu_torch.online import (LocalPublisher,
                                           MemoryChunkSource, OnlineTrainer)
    from lightgbm_tpu_torch.serving import ServingDaemon
    rng = np.random.RandomState(0)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 10, "device_predict": "true",
              "device_predict_min_bucket": 64, "serve_warmup": False,
              "online_trees_per_chunk": 2, "online_mode": "boost"}
    daemon = ServingDaemon(Config(params)).start()
    try:
        src = MemoryChunkSource()
        seen = []
        tr = OnlineTrainer(src, LocalPublisher(daemon, timeout_s=WAIT_S),
                           params=params,
                           checkpoint_dir=str(tmp_path / "ck"),
                           on_publish=lambda g, v, s: seen.append(s))
        before = (th.build_histogram_wave_hl.launches,
                  th.build_histogram_wave_int.launches,
                  th.build_histogram_rows_pallas.launches)
        for _ in range(3):
            X = rng.randn(4096, 8).astype(np.float32)
            src.push(X, (X[:, 0] + X[:, 1] > 0).astype(np.float32))
        assert tr.run(max_generations=3)["published"] == 3
        assert th.build_histogram_wave_hl.launches > before[0]
        assert (th.build_histogram_wave_int.launches,
                th.build_histogram_rows_pallas.launches) == before[1:]
        assert tr.booster._gbdt.device.type == "cuda"
        Xq = rng.randn(64, 8).astype(np.float32)
        got = np.asarray(daemon.submit("online", Xq).result(timeout=WAIT_S))
        want = tlgb.Booster(model_str=seen[-1], params={
            "device_predict": "true"}).predict(Xq)
        assert got.tobytes() == want.tobytes()
    finally:
        daemon.stop(drain=True, timeout=WAIT_S)


@pytest.mark.cuda
def test_train_at_70000_bins_on_the_card():
    """max_bin 70,000: int32 device codes, the leaf-wise engine (K4) and
    the wave engine (K1/K3) on the card give the CPU's trees."""
    _card()
    rng = np.random.RandomState(0)
    X = rng.rand(70000, 2)
    y = (X[:, 0] + 0.3 * rng.randn(70000) > 0.5).astype(np.float32)
    base = {"objective": "binary", "max_bin": 70000, "min_data_in_bin": 1,
            "bin_construct_sample_cnt": 70000, "num_leaves": 8,
            "verbosity": -1}
    for strategy in ("leafwise", "wave"):
        p = {**base, "tpu_growth_strategy": strategy}
        card = tlgb.train(p, tlgb.Dataset(X, label=y), 2)
        cpu = tlgb.train({**p, "device_type": "cpu"},
                         tlgb.Dataset(X, label=y), 2)
        assert card._gbdt.binned_dev.dtype == torch.int32
        for a, b in zip(card._gbdt.models_, cpu._gbdt.models_):
            ni = a.num_leaves - 1
            assert a.num_leaves == b.num_leaves
            np.testing.assert_array_equal(a.split_feature[:ni],
                                          b.split_feature[:ni])
            np.testing.assert_array_equal(a.threshold[:ni], b.threshold[:ni])
            np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                       b.leaf_value[:ni + 1], atol=1e-6)
