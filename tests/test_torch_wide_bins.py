"""PyTorch port: more than 256 bins (16-bit device codes and bin windows)
against the JAX package, on the CPU.

* The plain versions of K1-K4 on 16-bit codes (int16 storage) equal the
  JAX package's `build_histogram(method="segment")` at 1023 bins and at
  20,000, where the kernels cut the bin axis into windows: exactly on
  gradients snapped to multiples of 2^-6 (every float32 partial sum
  exact) and on K2's integers, within rtol 1e-5 on unsnapped gradients
  (float32 summation order on the JAX side).
* `train` at max_bin 511 and 1023 gives the JAX package's trees under the
  tie rule of tests/test_torch_categorical.py: on the wave engine (both
  packages asked for it, so the JAX package takes `_hist_wave_xla`), on
  the leaf-wise engine, quantized, and with EFB (one-hot columns beside
  wide features, each of which keeps a bundle column of its own).
* The valid-set traversal of wide codes and model text both ways.
* Above 65,536 bins the device codes are int32: the codes round-trip
  exactly, the plain versions of K1-K4 on them equal the segment method
  at 70,000 bins, and `train` at max_bin 70,000 gives the JAX package's
  leaf-wise trees on both of the port's engines (the JAX package's wave
  engine does not take that width on the CPU: it asks for tens of GB).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.ops import histogram as jh
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io.device_bin import pull_host
from lightgbm_tpu_torch.ops import histogram as th

from test_torch_categorical import compare_training
from test_torch_constraints import BASE, CPU, _data

CPU_DEV = torch.device("cpu")
SENTINEL = 10 ** 6


def _mk(n, F, B, slots, seed, snap=True):
    """Codes [F, n] in [0, B), slots with a sentinel share, gh
    [n, 3] with the count column last."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, B, size=(F, n))
    slot = rng.randint(0, 2 * slots, size=n).astype(np.int32)
    slot = np.where(slot < slots, slot, SENTINEL).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) + 0.5).astype(np.float32)
    if snap:
        grad = np.clip(np.round(grad * 64) / 64, -3.96875, 3.96875)
        hess = np.round(hess * 64) / 64
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    gh = np.stack([grad * mask, hess * mask, mask], 1).astype(np.float32)
    return codes, slot, gh


def _segment(codes, vals, mask, B):
    """The JAX package's segment histogram [F, B, C]."""
    return np.asarray(jh.build_histogram(
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(vals),
        jnp.asarray(mask), max_bin=B, method="segment"))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B", [1023, 20000])
def test_codes_are_16_bit(B):
    codes, _, _ = _mk(1024, 2, B, 1, seed=0)
    b = th.codes_to_device(codes, CPU_DEV)
    assert b.dtype == torch.int16
    # codes past 32,767 are stored with the sign bit and read back whole
    assert np.array_equal(th.codes_to_int(b).numpy(), codes)
    assert th.codes_to_device(codes % 256, CPU_DEV).dtype == torch.uint8
    assert th.code_dtype(65536) == torch.int16
    assert th.code_dtype(65537) == torch.int32


@pytest.mark.parametrize("B", [65537, 70000, 1 << 20])
def test_codes_are_int32_above_65536(B):
    """int32 above 65,536 bins, round trip exact (the codes' top values
    included)."""
    codes, _, _ = _mk(1024, 2, B, 1, seed=1)
    codes[:, :2] = [B - 1, 65536]
    b = th.codes_to_device(codes, CPU_DEV, num_bin=B)
    assert b.dtype == torch.int32
    assert np.array_equal(th.codes_to_int(b).numpy(), codes)
    assert np.array_equal(th.codes_to_int(b, torch.int32).numpy(), codes)
    assert np.array_equal(pull_host(b), codes)


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("B", [1023, 20000, 70000])
def test_plain_k1_k3_k4_match_segment(B, snap):
    n, F, NL, Ks = 2048, 3, 5, 3
    codes, slot, gh = _mk(n, F, B, NL, seed=B, snap=snap)
    b16 = th.codes_to_device(codes, CPU_DEV)
    s, g = _torch(slot, gh)

    def check(got, want):
        if snap:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    assert b16.dtype == (torch.int32 if B > 65536 else torch.int16)
    hist, cnt = th.build_histogram_wave(b16, s, g, max_bin=B, num_slots=NL)
    sk = torch.where(s < Ks, s, torch.full_like(s, SENTINEL))
    hl, cl = th.build_histogram_wave_hl(b16, b16.t(), sk, g, max_bin=B,
                                        num_slots=Ks, out_slots=8)
    for k in range(NL):
        m = (slot == k).astype(np.float32)
        want = _segment(codes, gh[:, :2], m, B)
        check(hist[k].numpy(), want)
        assert cnt[k].item() == float((m * gh[:, 2]).sum())
        if k < Ks:
            check(hl[k].numpy(), want)
    assert not hl[Ks:].any() and not cl[Ks:].any()
    rows = b16.t().contiguous()
    mask = (slot == 1).astype(np.float32)
    g2, mt = _torch(gh[:, :2], mask)
    check(th.build_histogram_rows_pallas(rows, g2, mt, max_bin=B).numpy(),
          _segment(codes, gh[:, :2], mask, B))


@pytest.mark.parametrize("B", [1023, 20000, 70000])
def test_plain_k2_matches_segment_exactly(B):
    """K2's integer sums of round(gh / scale) are the segment sums of the
    integers, exactly."""
    n, F, NL = 2048, 3, 4
    codes, slot, _ = _mk(n, F, B, NL, seed=3)
    rng = np.random.RandomState(4)
    scales = np.array([0.0123, 0.0456], np.float32)
    gi = rng.randint(-2, 3, n).astype(np.float32)
    hi = rng.randint(0, 5, n).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    gh = np.stack([gi * scales[0] * mask, hi * scales[1] * mask, mask],
                  1).astype(np.float32)
    b16 = th.codes_to_device(codes, CPU_DEV)
    s, g, sc = _torch(slot, gh, scales)
    acc, cnt = th.build_histogram_wave_int(b16, s, g, sc, max_bin=B,
                                           num_slots=NL)
    ints = np.stack([gi * mask, hi * mask], 1)
    for k in range(NL):
        m = (slot == k).astype(np.float32)
        np.testing.assert_array_equal(acc[k].numpy(),
                                      _segment(codes, ints, m, B))
        assert cnt[k].item() == int((m * mask).sum())


# ------------------------------------------------------- training vs JAX
TRAIN_CASES = {
    "wave_511": {"max_bin": 511, "tpu_growth_strategy": "wave"},
    "wave_1023": {"max_bin": 1023, "tpu_growth_strategy": "wave"},
    "leafwise_1023": {"max_bin": 1023, "tpu_growth_strategy": "leafwise"},
    "leafwise_511": {"max_bin": 511, "tpu_growth_strategy": "leafwise",
                     "num_leaves": 15},
    "quantized_1023": {"max_bin": 1023, "tpu_growth_strategy": "wave",
                       "use_quantized_grad": True,
                       "quant_train_renew_leaf": True},
}


def _efb_data(n=4096, seed=0):
    """Two wide dense features beside three one-hot blocks (8, 12 and 5
    levels) that bundle."""
    rng = np.random.RandomState(seed)
    levels = (8, 12, 5)
    X = np.zeros((n, 2 + sum(levels)), np.float32)
    X[:, :2] = rng.randn(n, 2)
    logit = X[:, 0] - 0.7 * X[:, 1]
    off = 2
    for i, k in enumerate(levels):
        code = rng.randint(0, k, n)
        X[np.arange(n), off + code] = 1.0
        logit += np.random.RandomState(10 + i).randn(k)[code]
        off += k
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    wt = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, wt


_PAIRS = {}


def _pair(case):
    if case not in _PAIRS:
        if case == "efb_1023":
            X, y, wt = _efb_data()
            params = {**BASE, "max_bin": 1023, "tpu_growth_strategy": "wave"}
        else:
            X, y, wt = _data()
            params = {**BASE, **TRAIN_CASES[case]}
        bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt), 3)
        bt = tlgb.train({**params, **CPU},
                        tlgb.Dataset(X, label=y, weight=wt), 3)
        bj._gbdt._sync_model()
        _PAIRS[case] = (bj, bt, X, y, wt)
    return _PAIRS[case]


@pytest.mark.parametrize("case", list(TRAIN_CASES) + ["efb_1023"])
def test_train_matches_jax(case):
    bj, bt, X, y, wt = _pair(case)
    g = bt._gbdt
    assert g.binned_dev.dtype == torch.int16
    assert g.growth_strategy == (TRAIN_CASES.get(case, {}).get(
        "tpu_growth_strategy", "wave"))
    if case == "efb_1023":
        plan = g.bundle_plan
        assert plan is not None and plan.num_groups < len(plan.group_idx)
        # the wide features keep columns of their own
        assert (plan.group_num_bin > 256).sum() == 2
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


def test_narrow_data_keeps_uint8_codes():
    X, y, wt = _data(n=1024)
    bt = tlgb.train({**BASE, **CPU}, tlgb.Dataset(X, label=y, weight=wt), 1)
    assert bt._gbdt.binned_dev.dtype == torch.uint8


def test_valid_traversal_and_model_text_both_ways():
    """A valid set's wide codes route through the bin-space traversal as
    the raw rows route through the trees; the port's model text predicts
    in the JAX package as in the port, and the JAX model's in the port as
    in the JAX package."""
    bj, _, X, y, wt = _pair("wave_1023")
    Xv, yv, _ = _data(seed=5, n=2048)
    params = {**BASE, **CPU, "max_bin": 1023, "metric": "binary_logloss"}
    ds = tlgb.Dataset(X, label=y, weight=wt)
    bt = tlgb.train(params, ds, 4, valid_sets=[ds.create_valid(Xv,
                                                                label=yv)])
    assert bt._gbdt.valid_bins[0].dtype == torch.int16
    np.testing.assert_allclose(bt._gbdt.valid_scores[0][0],
                               bt.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-6)
    text = bt.model_to_string()
    np.testing.assert_allclose(jlgb.Booster(model_str=text).predict(Xv),
                               bt.predict(Xv), rtol=0, atol=1e-12)
    back = tlgb.Booster(model_str=bj.model_to_string(),
                        params={"device_type": "cpu"})
    np.testing.assert_allclose(back.predict(Xv), bj.predict(Xv), rtol=0,
                               atol=1e-12)


# max_bin 70,000 on 70,000 distinct values: one bin a row, int32 codes
HUGE = {"objective": "binary", "max_bin": 70000, "min_data_in_bin": 1,
        "bin_construct_sample_cnt": 70000, "num_leaves": 8,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_donate_buffers": False}
_HUGE = {}


def _huge_data(n=70000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 2)
    logit = 4 * (X[:, 0] - 0.5) - 3 * (X[:, 1] - 0.5) ** 2
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _huge_jax():
    """The JAX package's leaf-wise booster at 70,000 bins (its engine
    on the CPU at this width), trained once."""
    if "jax" not in _HUGE:
        X, y = _huge_data()
        bj = jlgb.train({**HUGE, "tpu_growth_strategy": "leafwise"},
                        jlgb.Dataset(X, label=y), 2)
        bj._gbdt._sync_model()
        _HUGE["jax"] = (bj, X, y)
    return _HUGE["jax"]


@pytest.mark.parametrize("strategy", ["leafwise", "wave"])
def test_more_than_65536_bins_match_jax(strategy):
    """Two trees at max_bin 70,000 on int32 device codes: the leaf-wise
    engine and the wave engine (which prunes to the leaf-wise trees)
    give the JAX package's leaf-wise trees under the tie rule, raw
    scores within 1e-5 (float32 leaf sums in two orders)."""
    bj, X, y = _huge_jax()
    bt = tlgb.train({**HUGE, **CPU, "tpu_growth_strategy": strategy},
                    tlgb.Dataset(X, label=y), 2)
    g = bt._gbdt
    assert g.binned_dev.dtype == torch.int32
    assert g.growth_strategy == strategy
    assert int(g.f_num_bin.max()) > 65536
    n_ties, whole = compare_training(bj, bt, X, y, None)
    assert whole, f"{n_ties} ties moved rows"
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-5)
