"""PyTorch port: the histogram kernels at the group-space shapes of EFB
(bundle codes of up to 256 bins over F' columns) against their plain
versions, and training on scipy CSR data on the card against the CPU's,
on both engines and quantized.  These tests skip without a CUDA device.
The file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_efb_cuda.py
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.ops import histogram as H

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

FG, B = 33, 256       # bundle columns and bins of a one-hot EFB run


def _codes(n, seed):
    """[FG, n] uint8 bundle codes over the whole [0, 256) range: most rows
    at code 0 (every member at its default), the rest spread."""
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(0, B, (FG, n), generator=g, dtype=torch.uint8)
    zero = torch.rand(FG, n, generator=g) < 0.5
    return torch.where(zero, torch.zeros_like(codes), codes)


def _gh(n, seed):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.stack([torch.randn(n, generator=g),
                        torch.rand(n, generator=g) * 0.25,
                        torch.ones(n)], 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 8, 128])
def test_wave_kernels_at_group_space_equal_plain(slots):
    """K1 (every slot count), K3 (the few-slot waves) and K2 (quantized)
    on 2^18 rows of bundle codes: bit for bit their plain versions, and
    each call launches its kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 1 << 18
    dev = torch.device("cuda")
    codes = _codes(n, slots).to(dev)
    gh = _gh(n, slots).to(dev)
    g = torch.Generator().manual_seed(slots + 7)
    slot = torch.randint(0, slots, (n,), generator=g, dtype=torch.int32)
    slot[torch.rand(n, generator=g) < 0.5] = 1 << 20
    slot = slot.to(dev)
    e = H.scale_exps(gh)
    before = H.build_histogram_wave.launches
    got = H.build_histogram_wave_fixed(codes, slot, gh, e, max_bin=B,
                                       num_slots=slots)
    assert H.build_histogram_wave.launches == before + 1
    want = H.build_histogram_wave_plain(codes, slot, gh, max_bin=B,
                                        num_slots=slots, exps=e, fixed=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if H.wave_hl_profitable(B, slots):
        Kb = H.wave_slot_pad(slots)
        before = H.build_histogram_wave_hl.launches
        hl = H.build_histogram_wave_hl_fixed(codes, codes.t(), slot, gh, e,
                                             max_bin=B, num_slots=slots,
                                             out_slots=Kb)
        assert H.build_histogram_wave_hl.launches == before + 1
        assert torch.equal(hl[0][:slots], want[0])
        assert torch.equal(hl[1][:slots], want[1])
        assert not hl[0][slots:].any()
    scales = torch.tensor([0.0123, 0.0456], device=dev)
    q = torch.round(gh[:, :2] / scales) * scales
    qgh = torch.cat([q, gh[:, 2:]], 1).contiguous()
    before = H.build_histogram_wave_int.launches
    got = H.build_histogram_wave_int(codes, slot, qgh, scales, max_bin=B,
                                     num_slots=slots)
    assert H.build_histogram_wave_int.launches == before + 1
    want = H.build_histogram_wave_int_plain(codes, slot, qgh, scales,
                                            max_bin=B, num_slots=slots,
                                            fixed=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4096, 1 << 18])
def test_rows_kernel_at_group_space_equals_plain(S):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rows = _codes(S, S % 97).t().contiguous().to(dev)
    gh = _gh(S, 3)[:, :2].contiguous().to(dev)
    mask = (torch.rand(S, generator=torch.Generator().manual_seed(S))
            < 0.5).to(torch.float32).to(dev)
    e = H.scale_exps(gh)
    before = H.build_histogram_rows_pallas.launches
    got = H.build_histogram_rows_fixed(rows, gh, mask, e, max_bin=B)
    assert H.build_histogram_rows_pallas.launches == before + 1
    assert torch.equal(got, H.build_histogram_rows_plain(
        rows, gh, mask, max_bin=B, exps=e, fixed=True))


def _onehot(n=65_536, seed=2):
    """28 dense columns and one-hot categoricals of 50 and 200 levels."""
    rng = np.random.RandomState(seed)
    levels = (50, 200)
    dense = rng.randn(n, 28).astype(np.float32)
    codes = [rng.randint(0, k, n) for k in levels]
    logit = dense[:, 0] - 0.5 * dense[:, 1] + sum(
        np.random.RandomState(9 + i).randn(k)[c] * 0.5
        for i, (k, c) in enumerate(zip(levels, codes)))
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    cols = [sps.csr_matrix(dense)]
    for k, c in zip(levels, codes):
        cols.append(sps.csr_matrix((np.ones(n, np.float32),
                                    (np.arange(n), c)), shape=(n, k)))
    return sps.hstack(cols, format="csr"), y


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [{"tpu_growth_strategy": "wave"},
                                   {"tpu_growth_strategy": "leafwise"},
                                   {"tpu_growth_strategy": "wave",
                                    "use_quantized_grad": True}],
                         ids=["wave", "leafwise", "quantized"])
def test_csr_training_on_card_equals_cpu(extra):
    """Three iterations at 65,536 rows, 255 leaves: the same bundle plan
    and trees on both devices, leaf values within rtol 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y = _onehot()
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbosity": -1, **extra}
    out = {}
    for dev in ("cuda", "cpu"):
        b = tlgb.train({**params, "device_type": dev},
                       tlgb.Dataset(X, label=y), 3)
        out[dev] = b._gbdt
    card, cpu = out["cuda"], out["cpu"]
    assert card.bundle_plan is not None
    assert card.bundle_plan.groups == cpu.bundle_plan.groups
    for a, c in zip(card.models_, cpu.models_):
        ni = a.num_leaves - 1
        assert a.num_leaves == c.num_leaves
        for k in ("split_feature", "threshold", "decision_type"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(c, k)[:ni])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4)
