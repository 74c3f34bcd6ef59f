"""PyTorch port: wave histograms (K1/K3 plain versions and entry points)
against the JAX package.

The JAX side runs as the JAX package's own CPU tests reach these
kernels: through `_hist_wave_xla` (learner/wave.py:59, float32 at
Precision.HIGHEST) and `build_histogram(method="segment")`; the Pallas
kernels themselves need a TPU.  Inputs are made with numpy from a seed
and fed to both packages.  With gh snapped to the bf16 grid and to
multiples of 2^-6 (|gh| <= 4), every partial sum is exact in float32, so
the two must agree exactly; on unsnapped data they agree within rtol
1e-5 (float32 summation order).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

from lightgbm_tpu.learner.wave import _hist_wave_xla
from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu_torch.ops import histogram as th

SENTINEL = 10 ** 6


def _mk(n=2048, F=6, B=63, slots=8, computed=None, seed=0, snap=True):
    """binned [F, n] uint8, slot [n] int32 (rows outside the first
    `computed` slots carry the sentinel), gh [n, 3] float32."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    computed = slots if computed is None else computed
    slot = rng.randint(0, 2 * computed, size=n).astype(np.int32)
    slot = np.where(slot < computed, slot, SENTINEL).astype(np.int32)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) + 0.5).astype(np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    if snap:
        grad = np.clip(np.round(grad * 64) / 64, -3.96875, 3.96875)
        hess = np.round(hess * 64) / 64
        assert np.array_equal(
            grad.astype(ml_dtypes.bfloat16).astype(np.float32), grad)
    gh = np.stack([grad * mask, hess * mask, mask], 1).astype(np.float32)
    return binned, slot, gh


def _jax_wave(binned, slot, gh, B, NL):
    h, c = _hist_wave_xla(jnp.asarray(binned.astype(np.int32)),
                          jnp.asarray(slot), jnp.asarray(gh), max_bin=B,
                          num_slots=NL)
    return np.asarray(h), np.asarray(c)


def _port_wave(binned, slot, gh, B, NL):
    h, c = th.build_histogram_wave(torch.from_numpy(binned),
                                   torch.from_numpy(slot),
                                   torch.from_numpy(gh), max_bin=B,
                                   num_slots=NL)
    return h.numpy(), c.numpy()


@pytest.mark.parametrize("n,F,B,NL", [(512, 3, 16, 8), (2048, 6, 63, 8),
                                      (1536, 5, 255, 16)])
def test_wave_plain_exact_on_grid(n, F, B, NL):
    binned, slot, gh = _mk(n, F, B, NL, seed=n + B)
    hj, cj = _jax_wave(binned, slot, gh, B, NL)
    hp, cp = _port_wave(binned, slot, gh, B, NL)
    assert hp.shape == (NL, F, B, 2) and cp.shape == (NL,)
    np.testing.assert_array_equal(hp, hj)
    np.testing.assert_array_equal(cp, cj)


def test_wave_plain_close_off_grid():
    binned, slot, gh = _mk(4096, 6, 63, 8, seed=3, snap=False)
    hj, cj = _jax_wave(binned, slot, gh, 63, 8)
    hp, cp = _port_wave(binned, slot, gh, 63, 8)
    np.testing.assert_allclose(hp, hj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(cp, cj)


def test_wave_plain_sentinel_rows_match_nothing():
    """Rows on the sentinel slot (and on slots >= NL) add nothing."""
    binned, slot, gh = _mk(1024, 4, 32, 8, computed=4, seed=5)
    hp, cp = _port_wave(binned, slot, gh, 32, 8)
    assert np.all(hp[4:] == 0) and np.all(cp[4:] == 0)
    keep = slot < 4
    kept = np.zeros_like(gh)
    kept[keep] = gh[keep]
    hk, ck = _port_wave(binned, np.where(keep, slot, 0).astype(np.int32),
                        kept, 32, 8)
    np.testing.assert_array_equal(hp[:4], hk[:4])
    np.testing.assert_array_equal(cp[:4], ck[:4])


@pytest.mark.parametrize("s", [0, 3, 7])
def test_wave_plain_matches_segment_histogram(s):
    """Each slot's histogram is the segment-method histogram of the rows
    in that slot (build_histogram with the slot as the mask)."""
    binned, slot, gh = _mk(2048, 6, 63, 8, seed=11)
    hp, cp = _port_wave(binned, slot, gh, 63, 8)
    mask = (slot == s).astype(np.float32)
    seg = np.asarray(jh.build_histogram(
        jnp.asarray(binned.astype(np.int32)), jnp.asarray(gh[:, :2]),
        jnp.asarray(mask), max_bin=63, method="segment"))
    np.testing.assert_array_equal(hp[s], seg)
    assert cp[s] == float(np.sum(gh[:, 2] * mask))


@pytest.mark.parametrize("S,out_slots", [(1, 8), (2, 8), (4, 8), (8, 8),
                                         (3, 16)])
def test_hl_plain_zero_padding_and_parity(S, out_slots):
    binned, slot, gh = _mk(2048, 6, 63, out_slots, computed=S, seed=S)
    h, c = th.build_histogram_wave_hl(
        torch.from_numpy(binned), torch.from_numpy(binned.T.copy()),
        torch.from_numpy(slot), torch.from_numpy(gh), max_bin=63,
        num_slots=S, out_slots=out_slots)
    assert h.shape == (out_slots, 6, 63, 2) and c.shape == (out_slots,)
    assert torch.all(h[S:] == 0) and torch.all(c[S:] == 0)
    hj, cj = _jax_wave(binned, slot, gh, 63, out_slots)
    np.testing.assert_array_equal(h.numpy(), hj)
    np.testing.assert_array_equal(c.numpy(), cj)


def test_single_leaf_histogram_matches_jax_segment():
    binned, _, gh = _mk(2048, 6, 63, 8, seed=21, snap=False)
    mask = (np.random.RandomState(2).rand(2048) < 0.5).astype(np.float32)
    port = th.build_histogram(torch.from_numpy(binned),
                              torch.from_numpy(gh[:, :2]),
                              torch.from_numpy(mask), max_bin=63).numpy()
    ref = np.asarray(jh.build_histogram(
        jnp.asarray(binned.astype(np.int32)), jnp.asarray(gh[:, :2]),
        jnp.asarray(mask), max_bin=63, method="segment"))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["rows", "dtype", "slot_dtype", "shape",
                                 "hl_slots"])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad):
    binned, slot, gh = _mk(1024, 4, 32, 8, seed=1)
    b, s, g = (torch.from_numpy(binned), torch.from_numpy(slot),
               torch.from_numpy(gh))
    with pytest.raises((ValueError, TypeError)):
        if bad == "rows":
            th.build_histogram_wave(b[:, :1000].contiguous(), s[:1000],
                                    g[:1000], max_bin=32, num_slots=8)
        elif bad == "dtype":
            th.build_histogram_wave(b.to(torch.int32), s, g, max_bin=32,
                                    num_slots=8)
        elif bad == "slot_dtype":
            th.build_histogram_wave(b, s.to(torch.int64), g, max_bin=32,
                                    num_slots=8)
        elif bad == "shape":
            th.build_histogram_wave(b, s, g[:, :1].contiguous(), max_bin=32,
                                    num_slots=8)
        else:
            th.build_histogram_wave_hl(b, b.t().contiguous(), s, g,
                                       max_bin=32, num_slots=9, out_slots=8)


def test_cpu_dispatch_runs_plain_and_counts_no_launch():
    binned, slot, gh = _mk(512, 3, 16, 8, seed=2)
    k1, k3 = th.build_histogram_wave.launches, th.build_histogram_wave_hl.launches
    _port_wave(binned, slot, gh, 16, 8)
    th.build_histogram_wave_hl(torch.from_numpy(binned),
                               torch.from_numpy(binned.T.copy()),
                               torch.from_numpy(slot), torch.from_numpy(gh),
                               max_bin=16, num_slots=2, out_slots=8)
    assert th.build_histogram_wave.launches == k1
    assert th.build_histogram_wave_hl.launches == k3


@pytest.mark.parametrize("B", [15, 63, 255])
def test_dispatch_rules_match_jax(B):
    for S in range(1, 40):
        assert th.hl_split_of(B, S, 2) == jh.hl_split_of(B, S, 2)
        assert th.wave_hl_profitable(B, S) == jh.wave_hl_profitable(B, S)
        assert th.wave_slot_pad(S) == jh.wave_slot_pad(S)
    if B == 255:
        # the main path's computed-slot bounds are powers of two: the
        # first five waves of a tree (Ks = 1, 2, 4, 8) go to K3
        assert [S for S in (1, 2, 4, 8, 16, 32, 64, 128)
                if th.wave_hl_profitable(B, S)] == [1, 2, 4, 8]
        assert all(th.wave_hl_fits(B, S) for S in (1, 2, 4, 8))


# ---------------------------------------------------------------- K4 / K2
def _rows_case(S, F, B, seed, snap):
    binned, _, gh = _mk(S, F, B, 8, seed=seed, snap=snap)
    mask = (np.random.RandomState(seed + 1).rand(S) < 0.6).astype(np.float32)
    return np.ascontiguousarray(binned.T), gh[:, :2].copy(), mask


def _jax_segment(rows, gh, mask, B):
    """tools/kernel_checks.py check 4: K4's JAX plain reference."""
    return np.asarray(jh.build_histogram(
        jnp.asarray(rows.T.astype(np.int32)), jnp.asarray(gh),
        jnp.asarray(mask), max_bin=B, method="segment"))


@pytest.mark.parametrize("S,F,B", [(512, 3, 16), (2048, 6, 63),
                                   (1536, 5, 255)])
def test_rows_plain_exact_on_grid(S, F, B):
    """K4's plain version against build_histogram(method="segment") on
    rows.T: exact on the bf16 grid (every partial sum exact in
    float32)."""
    rows, gh, mask = _rows_case(S, F, B, seed=S + B, snap=True)
    got = th.build_histogram_rows_pallas(
        torch.from_numpy(rows), torch.from_numpy(gh),
        torch.from_numpy(mask), max_bin=B).numpy()
    assert got.shape == (F, B, 2)
    np.testing.assert_array_equal(got, _jax_segment(rows, gh, mask, B))


def test_rows_plain_close_off_grid():
    rows, gh, mask = _rows_case(4096, 6, 63, seed=9, snap=False)
    got = th.build_histogram_rows_pallas(
        torch.from_numpy(rows), torch.from_numpy(gh),
        torch.from_numpy(mask), max_bin=63).numpy()
    np.testing.assert_allclose(got, _jax_segment(rows, gh, mask, 63),
                               rtol=1e-5, atol=1e-6)


def test_rows_fixed_on_tree_grid_subtracts_exactly():
    """On one grid (the tree's exponents) the int64 sums of two disjoint
    masks add up to the sums of their union, so parent - child is
    exact; converted, each matches the float32 entry point's result to
    the grid's resolution."""
    rows, gh, mask = _rows_case(2048, 6, 63, seed=4, snap=False)
    r, g = torch.from_numpy(rows), torch.from_numpy(gh)
    m = torch.from_numpy(mask)
    e = th.scale_exps(g)
    whole = th.build_histogram_rows_fixed(r, g, torch.ones_like(m), e,
                                          max_bin=63)
    part = th.build_histogram_rows_fixed(r, g, m, e, max_bin=63)
    rest = th.build_histogram_rows_fixed(r, g, 1 - m, e, max_bin=63)
    assert whole.dtype == torch.int64
    assert torch.equal(whole - part, rest)
    np.testing.assert_allclose(
        th.from_fixed(part, th.fixed_unit(e)).numpy(),
        th.build_histogram_rows_pallas(r, g, m, max_bin=63).numpy(),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["rows", "dtype", "mask", "exps"])
def test_rows_wrapper_refuses_what_the_kernel_does_not_take(bad):
    rows, gh, mask = _rows_case(1024, 4, 32, seed=1, snap=True)
    r, g, m = (torch.from_numpy(rows), torch.from_numpy(gh),
               torch.from_numpy(mask))
    with pytest.raises((ValueError, TypeError)):
        if bad == "rows":
            th.build_histogram_rows_pallas(r[:1000], g[:1000], m[:1000],
                                           max_bin=32)
        elif bad == "dtype":
            th.build_histogram_rows_pallas(r.to(torch.int32), g, m,
                                           max_bin=32)
        elif bad == "mask":
            th.build_histogram_rows_pallas(r, g, m[:512], max_bin=32)
        else:
            th.build_histogram_rows_fixed(r, g, m, th.scale_exps(g)[:1],
                                          max_bin=32)


def test_fixed_wave_variants_convert_to_the_entry_points():
    """The engines' int64 variants of K1/K3, converted with `from_fixed`,
    give the float32 entry points' results bit for bit; on the CPU no
    kernel launch is counted."""
    binned, slot, gh = _mk(2048, 6, 63, 8, computed=4, seed=13, snap=False)
    b, s, g = (torch.from_numpy(binned), torch.from_numpy(slot),
               torch.from_numpy(gh))
    e = th.scale_exps(g)
    launches = (th.build_histogram_wave.launches,
                th.build_histogram_wave_hl.launches,
                th.build_histogram_wave_int.launches,
                th.build_histogram_rows_pallas.launches)
    acc, cnt = th.build_histogram_wave_fixed(b, s, g, e, max_bin=63,
                                             num_slots=8)
    h, c = th.build_histogram_wave(b, s, g, max_bin=63, num_slots=8)
    u = th.fixed_unit(e)
    assert torch.equal(th.from_fixed(acc, u[:2]), h)
    assert torch.equal(th.from_fixed(cnt[:, None], u[2:])[:, 0], c)
    acc, cnt = th.build_histogram_wave_hl_fixed(
        b, b.t().contiguous(), s, g, e, max_bin=63, num_slots=4,
        out_slots=8)
    h, c = th.build_histogram_wave_hl(b, b.t().contiguous(), s, g,
                                      max_bin=63, num_slots=4, out_slots=8)
    assert torch.equal(th.from_fixed(acc, u[:2]), h)
    assert launches == (th.build_histogram_wave.launches,
                        th.build_histogram_wave_hl.launches,
                        th.build_histogram_wave_int.launches,
                        th.build_histogram_rows_pallas.launches)
