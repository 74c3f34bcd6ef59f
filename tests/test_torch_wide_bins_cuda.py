"""PyTorch port: K1-K4 on 16-bit bin codes and in bin windows, against
their plain versions, on the card.  These tests skip without a CUDA
device.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_wide_bins_cuda.py
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as th

torch.set_num_threads(1)

SENTINEL = 10 ** 6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, F, B, slots, seed, dev, qbins=0):
    """16-bit codes in [0, B) (a few rows past B, which match nothing),
    slots with a sentinel share, gh with a count column; quantized gh on
    a grid of `qbins` levels when qbins > 0."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, B + 3, size=(F, n))
    binned = th.codes_to_device(codes, dev, num_bin=max(B + 3, 257))
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
@pytest.mark.parametrize("B", [1023, 32768])
def test_k1_k3_on_wide_codes(B):
    """K1 (partition) and K3 (streaming) on int16-stored codes, at 1023
    bins (one window) and 32,768 (several): bit for bit their plain
    versions and themselves on a repeat, each call one launch."""
    dev = _card()
    n, F = 1 << 14, 3
    binned, slot, gh = _inputs(n, F, B, 40, seed=B, dev=dev)
    assert binned.dtype == torch.int16
    e = th.scale_exps(gh)
    c1 = th.build_histogram_wave.launches
    k = th.build_histogram_wave_fixed(binned, slot, gh, e, max_bin=B,
                                      num_slots=40)
    k2 = th.build_histogram_wave_fixed(binned, slot, gh, e, max_bin=B,
                                       num_slots=40)
    assert th.build_histogram_wave.launches == c1 + 2
    p = th.build_histogram_wave_plain(binned, slot, gh, max_bin=B,
                                      num_slots=40, exps=e, fixed=True)
    assert _eq(k, p) and _eq(k, k2)
    Ks = 7 if B == 1023 else 1
    sk = torch.where(slot < Ks, slot, torch.full_like(slot, SENTINEL))
    c3 = th.build_histogram_wave_hl.launches
    kh = th.build_histogram_wave_hl_fixed(binned, binned.t(), sk, gh, e,
                                          max_bin=B, num_slots=Ks,
                                          out_slots=8)
    assert th.build_histogram_wave_hl.launches == c3 + 1
    ph = th.build_histogram_wave_hl_plain(binned, binned.t(), sk, gh,
                                          max_bin=B, num_slots=Ks,
                                          out_slots=8, exps=e, fixed=True)
    assert _eq(kh, ph)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1023, 32768])
@pytest.mark.parametrize("few", [True, False])
def test_k2_on_wide_codes(B, few):
    """K2's two routes on 16-bit codes: exact integer sums."""
    dev = _card()
    n, F, NL = 1 << 14, 3, 8
    binned, slot, gh, sc = _inputs(n, F, B, NL, seed=7, dev=dev, qbins=4)
    k = th._launch_wave_int(binned, slot, gh, sc, B, NL, False, few=few)
    p = th.build_histogram_wave_int_plain(binned, slot, gh, sc, max_bin=B,
                                          num_slots=NL, fixed=True)
    assert _eq(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1023, 1 << 14), (32768, 4096),
                                 (1023, 512)])
def test_k4_on_wide_codes(B, S):
    """K4 on row-major 16-bit codes, one block (512 rows: the owner
    stores) and many, windowed at 32,768 bins."""
    dev = _card()
    F = 5
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
    k2 = th.build_histogram_rows_fixed(rows, g2, mask, e, max_bin=B)
    assert torch.equal(k, k2)
