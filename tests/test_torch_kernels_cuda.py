"""PyTorch port: the K1-K4 CUDA kernels against their plain versions, on
the card.  These tests skip without a CUDA device.  The file imports
neither JAX nor the JAX package, so it also runs on a machine without
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as th

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

SENTINEL = 10 ** 6


def _inputs(n, F, B, slots, seed):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    slot = rng.randint(0, 2 * slots, size=n).astype(np.int32)
    slot = np.where(slot < slots, slot, SENTINEL).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = rng.rand(n).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    gh = np.stack([grad * mask, hess * mask, mask], 1).astype(np.float32)
    return binned, slot, gh


@pytest.mark.cuda
@pytest.mark.parametrize("NL,Ks", [(16, 1), (128, 8), (300, 4)])
def test_kernels_match_plain_and_repeat(NL, Ks):
    """K1/K3 agree bit for bit with their plain versions (both sum in
    64-bit fixed point) and with themselves on a repeat launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    binned, slot, gh = _inputs(8192, 7, 255, NL, seed=NL)
    b, s, g = (torch.from_numpy(binned).to(dev),
               torch.from_numpy(slot).to(dev), torch.from_numpy(gh).to(dev))
    launches = th.build_histogram_wave.launches
    k = th.build_histogram_wave(b, s, g, max_bin=255, num_slots=NL)
    k2 = th.build_histogram_wave(b, s, g, max_bin=255, num_slots=NL)
    assert th.build_histogram_wave.launches == launches + 2
    p = th.build_histogram_wave_plain(b, s, g, max_bin=255, num_slots=NL)
    assert torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    sk = torch.where(s < Ks, s, torch.full_like(s, SENTINEL))
    brm = b.t().contiguous()
    pad = th.wave_slot_pad(Ks)
    kh = th.build_histogram_wave_hl(b, brm, sk, g, max_bin=255,
                                    num_slots=Ks, out_slots=pad)
    ph = th.build_histogram_wave_hl_plain(b, brm, sk, g, max_bin=255,
                                          num_slots=Ks, out_slots=pad)
    assert torch.equal(kh[0], ph[0]) and torch.equal(kh[1], ph[1])


@pytest.mark.cuda
def test_kernel_wrappers_refuse_cpu_cuda_mix():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    binned, slot, gh = _inputs(1024, 3, 16, 8, seed=0)
    with pytest.raises(ValueError):
        th.build_histogram_wave(torch.from_numpy(binned).cuda(),
                                torch.from_numpy(slot),
                                torch.from_numpy(gh).cuda(), max_bin=16,
                                num_slots=8)


def _quantized(n, seed, qbins=4):
    rng = np.random.RandomState(seed)
    gscale, hscale = np.float32(0.0123), np.float32(0.0456)
    gi = rng.randint(-qbins // 2, qbins // 2 + 1, n)
    hi = rng.randint(0, qbins + 1, n)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    gh = np.stack([gi * gscale * mask, hi * hscale * mask, mask],
                  1).astype(np.float32)
    return gh, np.array([gscale, hscale], np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("NL", [16, 256])
def test_k2_matches_plain_and_repeats(NL):
    """K2 (quantized wave histograms) is bit-identical to its plain
    version, as float32 output and as integer sums, and on repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    binned, slot, _ = _inputs(8192, 7, 255, NL, seed=NL)
    gh, scales = _quantized(8192, seed=NL)
    b, s, g, sc = (torch.from_numpy(a).to(dev)
                   for a in (binned, slot, gh, scales))
    launches = th.build_histogram_wave_int.launches
    k = th.build_histogram_wave(b, s, g, max_bin=255, num_slots=NL,
                                quant_bins=4, quant_scales=sc)
    k2 = th.build_histogram_wave(b, s, g, max_bin=255, num_slots=NL,
                                 quant_bins=4, quant_scales=sc)
    ki = th.build_histogram_wave_int(b, s, g, sc, max_bin=255, num_slots=NL)
    assert th.build_histogram_wave_int.launches == launches + 3
    p = th.build_histogram_wave_int_plain(b, s, g, sc, max_bin=255,
                                          num_slots=NL)
    pi = th.build_histogram_wave_int_plain(b, s, g, sc, max_bin=255,
                                           num_slots=NL, fixed=True)
    for x, y in ((k, k2), (k, p), (ki, pi)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [4096, 65536])
def test_k4_matches_plain_and_repeats(S):
    """K4 (single-leaf rows histogram) is bit-identical to its plain
    version, as float32 output and as int64 sums on a given grid, and on
    repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    binned, _, gh = _inputs(S, 28, 255, 8, seed=S)
    rows = torch.from_numpy(np.ascontiguousarray(binned.T)).to(dev)
    g = torch.from_numpy(gh[:, :2].copy()).to(dev)
    m = torch.from_numpy(
        (np.random.RandomState(S).rand(S) < 0.5).astype(np.float32)).to(dev)
    launches = th.build_histogram_rows_pallas.launches
    k = th.build_histogram_rows_pallas(rows, g, m, max_bin=255)
    k2 = th.build_histogram_rows_pallas(rows, g, m, max_bin=255)
    e = th.scale_exps(g)
    ki = th.build_histogram_rows_fixed(rows, g, m, e, max_bin=255)
    assert th.build_histogram_rows_pallas.launches == launches + 3
    p = th.build_histogram_rows_plain(rows, g, m, max_bin=255)
    pi = th.build_histogram_rows_plain(rows, g, m, max_bin=255, exps=e,
                                       fixed=True)
    assert torch.equal(k, k2) and torch.equal(k, p) and torch.equal(ki, pi)


def _slots(case, n, NL, seed):
    """Slot vectors K1's partition must survive: leaf sizes like the main
    path's (slot s takes a share ~ 1 / (s + 1)), one slot holding 90% of
    the rows, every row on the sentinel."""
    rng = np.random.RandomState(seed)
    if case == "uneven":
        w = 1.0 / np.arange(1, NL + 1)
        slot = rng.choice(NL, size=n, p=w / w.sum())
    elif case == "one_slot_90":
        slot = np.where(rng.rand(n) < 0.9, 3, rng.randint(0, NL, size=n))
    else:
        slot = np.full(n, SENTINEL)
    slot = np.where(rng.rand(n) < 0.5, SENTINEL, slot)
    return slot.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,NL", [("uneven", 16384, 384),
                                       ("one_slot_90", 8704, 16),
                                       ("all_sentinel", 8192, 8),
                                       ("uneven", 8704, 128)])
def test_k1_partition_shapes(case, n, NL):
    """K1 on uneven slots, on n that is no multiple of its partition
    chunks (8,704 rows) and on an all-sentinel wave: the int64 sums equal
    the plain version's, repeat, and each call launches the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    binned, _, gh = _inputs(n, 28, 255, NL, seed=n + NL)
    b, g = torch.from_numpy(binned).to(dev), torch.from_numpy(gh).to(dev)
    s = torch.from_numpy(_slots(case, n, NL, seed=NL)).to(dev)
    e = th.scale_exps(g)
    launches = th.build_histogram_wave.launches
    k = th.build_histogram_wave_fixed(b, s, g, e, max_bin=255, num_slots=NL)
    k2 = th.build_histogram_wave_fixed(b, s, g, e, max_bin=255,
                                       num_slots=NL)
    assert th.build_histogram_wave.launches == launches + 2
    p = th.build_histogram_wave_plain(b, s, g, max_bin=255, num_slots=NL,
                                      exps=e, fixed=True)
    for x, y in ((k, k2), (k, p)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


@pytest.mark.cuda
@pytest.mark.parametrize("S,hot,full", [(512, False, False),
                                        (4096, True, False),
                                        (65536, True, False),
                                        (4096, True, True),
                                        (65536, True, True)])
def test_k4_segment_shapes(S, hot, full):
    """K4 on the one-tile segment and on segments whose rows all fall in
    one bin of every feature (the hot cell), with half the rows masked
    off or with every row in the mask (each add lands on the same F
    cells): bit-identical to the plain version and on repeats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    binned, _, gh = _inputs(S, 28, 255, 8, seed=S)
    rows = np.ascontiguousarray(binned.T)
    if hot:
        rows[:] = 17
    r = torch.from_numpy(rows).to(dev)
    g = torch.from_numpy(gh[:, :2].copy()).to(dev)
    m = np.random.RandomState(S).rand(S) < 0.5
    m = torch.from_numpy((m | full).astype(np.float32)).to(dev)
    e = th.scale_exps(g)
    launches = th.build_histogram_rows_pallas.launches
    k = th.build_histogram_rows_fixed(r, g, m, e, max_bin=255)
    k2 = th.build_histogram_rows_fixed(r, g, m, e, max_bin=255)
    assert th.build_histogram_rows_pallas.launches == launches + 2
    p = th.build_histogram_rows_plain(r, g, m, max_bin=255, exps=e,
                                      fixed=True)
    assert torch.equal(k, k2) and torch.equal(k, p)
