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

import bisect

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
            th.build_histogram_wave(b.to(torch.int64), s, g, max_bin=32,
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
            th.build_histogram_rows_pallas(r.to(torch.int64), g, m,
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


# ------------------------------------------- K1's partition and K4's plan
def _slot_partition_plain(slot: torch.Tensor, num_slots: int):
    """The partition K1 makes on the card, in plain torch (bincount +
    stable sort): (perm, counts, starts) with perm [m] the computed rows
    (slot in [0, num_slots)) grouped by slot, counts [NL] int64 and
    starts [NL + 1] int64 the segment bounds.  Within a slot the rows
    stand in row order; the kernel's scatter keeps another fixed order
    inside each 128-row warp step, which the integer sums do not see."""
    s = slot.to(torch.int64)
    valid = (s >= 0) & (s < num_slots)
    counts = torch.bincount(s[valid], minlength=num_slots)
    key = torch.where(valid, s, num_slots)
    perm = torch.sort(key, stable=True).indices[:int(valid.sum())]
    starts = torch.zeros(num_slots + 1, dtype=torch.int64,
                         device=slot.device)
    starts[1:] = torch.cumsum(counts, 0)
    return perm, counts, starts


def _wave_part_items(counts, num_features: int, FG: int, R: int):
    """K1's work items in the kernel's order, decoded as
    `wave_part_hist_kernel` (wave_hist.cu) decodes them, from the plan's
    FG and R: item k * G + g is feature group g of chunk k, and chunk
    k is the (k - chunk[s])-th R-row piece of slot s's segment.  Returns
    (slot, f0, fg, a, b, owner) per item, rows [a, b) of the slot-grouped
    order; `owner` marks a slot of one chunk (its block stores)."""
    counts = [int(c) for c in counts]
    NL = len(counts)
    seg = [0] * (NL + 1)
    chunk = [0] * (NL + 1)
    for s, c in enumerate(counts):
        seg[s + 1] = seg[s] + c
        chunk[s + 1] = chunk[s] + -(-c // R)
    G = -(-num_features // FG)
    items = []
    for it in range(chunk[NL] * G):
        k, g = divmod(it, G)
        s = bisect.bisect_right(chunk, k) - 1
        a = seg[s] + (k - chunk[s]) * R
        b = min(seg[s + 1], a + R)
        f0 = g * FG
        items.append((s, f0, min(FG, num_features - f0), a, b,
                      chunk[s + 1] - chunk[s] == 1))
    return items


def _slot_case(case, n=4096, NL=16, seed=0):
    """Slot vectors the partition must survive: computed rows spread
    evenly, one slot holding 90% of the rows, most slots empty, every
    row on the sentinel (or below 0, which also matches nothing)."""
    rng = np.random.RandomState(seed)
    slot = rng.randint(0, 2 * NL, size=n)
    if case == "one_slot_90":
        slot = np.where(rng.rand(n) < 0.9, 3, slot)
    elif case == "empty_slots":
        slot = np.where(slot % 5 == 0, slot % 2 * 5, SENTINEL)
    elif case == "all_sentinel":
        slot = np.where(slot % 2 == 0, SENTINEL, -1)
    slot = np.where(slot < NL, slot, SENTINEL)
    return slot.astype(np.int32)


CASES = ["even", "one_slot_90", "empty_slots", "all_sentinel"]


@pytest.mark.parametrize("case", CASES)
def test_slot_partition_counts_match_jax(case):
    """The plain partition (bincount + stable sort) groups the computed
    rows by slot in row order; its per-slot counts are the JAX package's
    counts (`_hist_wave_xla` with an all-ones count column)."""
    n, NL, F, B = 4096, 16, 3, 16
    slot = _slot_case(case, n, NL, seed=5)
    binned, _, gh = _mk(n, F, B, NL, seed=6)
    gh[:, 2] = 1.0
    perm, counts, starts = _slot_partition_plain(torch.from_numpy(slot),
                                                   NL)
    _, cj = _jax_wave(binned, slot, gh, B, NL)
    np.testing.assert_array_equal(counts.numpy(), cj.astype(np.int64))
    assert int(starts[-1]) == perm.numel() == int(counts.sum())
    for s in range(NL):
        seg = perm[starts[s]:starts[s + 1]].numpy()
        assert np.all(slot[seg] == s) and np.all(np.diff(seg) > 0)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("F,B", [(28, 255), (5, 63), (40, 16)])
def test_wave_part_items_cover_each_cell_once(case, F, B):
    """K1's work items, cut from the plan's FG and R, cover every (slot,
    feature, computed row) exactly once, each within one slot and at
    most R rows, and the plan's tiles fit.  The kernel's own decoding is
    held bit for bit against the plain version on the card
    (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
    n, NL = 8192, 16
    slot = _slot_case(case, n, NL, seed=F + B)
    plan = th.wave_part_plan(n, F, B, 2, NL)
    assert plan.tile_bytes <= th.SMEM_LIMIT
    assert plan.part_smem <= th.SMEM_LIMIT
    perm, counts, starts = _slot_partition_plain(torch.from_numpy(slot),
                                                   NL)
    items = _wave_part_items(counts.tolist(), F, plan.FG, plan.R)
    cover = np.zeros((perm.numel(), F), np.int64)
    for s, f0, fg, a, b, owner in items:
        assert 0 < b - a <= plan.R and 1 <= fg <= plan.FG
        assert starts[s] <= a and b <= starts[s + 1]
        assert owner == (int(counts[s]) <= plan.R)
        cover[a:b, f0:f0 + fg] += 1
    assert np.all(cover == 1)
    if case == "all_sentinel":
        assert items == [] and perm.numel() == 0


@pytest.mark.parametrize("NL", [1, 8, 384, 7264, 58112])
def test_wave_part_plan_sizes(NL):
    """K1's plan at the main path's widths: 7-feature items (4 groups,
    28.5 KB tiles, several blocks per SM), the partition's per-warp slot
    counters in shared memory (fewer warps where many slots), and the
    scratch the C entry asks for."""
    n = 1 << 20
    plan = th.wave_part_plan(n, 28, 255, 2, NL)
    assert (plan.FG, plan.R, plan.U) == (7, 1024, n // th.UNIT_ROWS)
    assert plan.tile_bytes == 8 * (7 * 255 * 2 + 1) <= th.TILE_BYTES
    assert 1 <= plan.PW <= th.PART_WARPS
    assert plan.part_smem <= th.SMEM_LIMIT
    assert plan.scratch_bytes >= n * (32 + 32) + 4 * NL * plan.U
    with pytest.raises(ValueError):
        th.wave_part_plan(n, 28, 255, 2, th.SMEM_LIMIT // 4 + 1)


@pytest.mark.parametrize("S", [512, 4096, 65536, 1 << 20])
@pytest.mark.parametrize("F,B", [(28, 255), (3, 16), (50, 255)])
def test_rows_plan_covers_segment(S, F, B):
    """K4's grid covers every (feature, row) of the segment once, its
    tiles fit, and small segments spread over several blocks."""
    FG, R = th.rows_plan(S, F, B, 2)
    groups, chunks = -(-F // FG), -(-S // R)
    assert 8 * FG * B * 2 <= th.TILE_BYTES
    assert R % 512 == 0 and chunks * R >= S > (chunks - 1) * R
    assert groups * FG >= F > (groups - 1) * FG
    if (S, F, B) == (4096, 28, 255):
        assert groups * chunks >= 16
    if (F, B) == (28, 255):
        assert groups * chunks <= th.K4_BLOCKS


# ------------------------------------------ the streaming kernel's plan
def _few_cells(S, F, FG, B, C):
    """Global cell (slot, feature, bin, channel) of every tile cell of
    the streaming kernel (`wave_few_kernel` in wave_hist.cu), decoded as
    its flush decodes them: feature group g holds [S][fg][B][C] cells."""
    out = []
    for f0 in range(0, F, FG):
        fg = min(FG, F - f0)
        per_slot = fg * B * C
        for i in range(S * per_slot):
            s, rem = divmod(i, per_slot)
            fl, bc = divmod(rem, B * C)
            out.append(((s * F + f0 + fl) * B) * C + bc)
    return np.array(out)


@pytest.mark.parametrize("cell_bytes", [8, 4])
@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_few_plan_fits_and_shares_an_sm(S, cell_bytes):
    """K3's tile (8-byte cells) and K2's few-slot tile (4-byte cells) at
    the main path's widths: within the budget, equal feature groups that
    cover every (slot, feature, bin, channel) cell once, and at least two
    blocks per SM at 8 slots (a 227 KB tile held one)."""
    F, B, C = 28, 255, 2
    plan = th.wave_few_plan(F, B, C, S, cell_bytes)
    assert plan.tile_bytes <= th.FEW_TILE_BYTES
    assert plan.tile_bytes == cell_bytes * S * (plan.FG * B * C + 1)
    groups = -(-F // plan.FG)
    assert groups * plan.FG >= F > (groups - 1) * plan.FG
    assert plan.blocks_per_sm >= 2
    assert plan.blocks_per_sm * (plan.tile_bytes
                                 + th.BLOCK_RESERVED_SMEM) <= th.SM_SMEM
    cells = _few_cells(S, F, plan.FG, B, C)
    assert np.array_equal(np.sort(cells), np.arange(S * F * B * C))


def test_few_plan_refuses_what_does_not_fit():
    # 29 slots of one whole 255-bin feature exceed the tile: the plan cuts
    # the bins into two windows; only slots that not even a one-bin
    # window holds are refused
    plan = th.wave_few_plan(28, 255, 2, 29)
    assert (plan.FG, plan.Bw) == (1, 128)
    assert plan.tile_bytes == 8 * 29 * (128 * 2 + 1) <= th.FEW_TILE_BYTES
    with pytest.raises(ValueError):
        th.wave_few_plan(28, 255, 2, th.FEW_TILE_BYTES // 24 + 1)
    assert th.wave_few_plan(28, 255, 2, 28).FG == 1
    # 8 slots: 3 features a block (10 groups) in half an SM; a smaller
    # budget takes fewer
    assert th.wave_few_plan(28, 255, 2, 8).FG == 3
    assert th.wave_few_plan(28, 255, 2, 8, tile_budget=64 * 1024).FG == 2


def test_restated_hl_fits_keeps_the_dispatch():
    """The fits rule restated for the streaming kernel's tile accepts
    1/2/4/8 slots at B = 255 and every wave `wave_hl_profitable` marks
    at B <= 256, as the 227 KB rule it replaces did, so the main path
    launches K3 on the same waves."""
    assert all(th.wave_hl_fits(255, S) for S in (1, 2, 4, 8))
    for B in range(2, 257):
        for S in range(1, 40):
            if th.wave_hl_profitable(B, S):
                old = S * (B * 2 * 8 + 8) <= th.SMEM_LIMIT
                assert th.wave_hl_fits(B, S) and old, (B, S)
                th.wave_few_plan(28, B, 2, S)      # the plan fits too


def test_wave_wrappers_check_alignment():
    """The kernels load bins as 4-byte words and slot / gh as 16-byte
    vectors: a misaligned view is refused before any launch."""
    n, F = 1024, 3
    raw = torch.zeros(F * n + 16, dtype=torch.uint8)
    slot = torch.zeros(n + 4, dtype=torch.int32)
    gh = torch.zeros(3 * n + 4, dtype=torch.float32)
    ok = (raw[:F * n].view(F, n), slot[:n], gh[:3 * n].view(n, 3))
    th._check_aligned(*ok)
    for bad in ((raw[1:F * n + 1].view(F, n), ok[1], ok[2]),
                (ok[0], slot[1:n + 1], ok[2]),
                (ok[0], ok[1], gh[1:3 * n + 1].view(n, 3))):
        with pytest.raises(ValueError):
            th._check_aligned(*bad)


def test_hl_takes_a_row_major_view():
    """K3's wrapper checks binned_rm's shape, not its layout: the wave
    engine passes `binned_fm.t()`, a view, and gets the same result as
    with a contiguous copy."""
    binned, slot, gh = _mk(1024, 5, 63, 8, computed=4, seed=17)
    b, s, g = (torch.from_numpy(binned), torch.from_numpy(slot),
               torch.from_numpy(gh))
    e = th.scale_exps(g)
    view = th.build_histogram_wave_hl_fixed(b, b.t(), s, g, e, max_bin=63,
                                            num_slots=4, out_slots=8)
    copy = th.build_histogram_wave_hl_fixed(b, b.t().contiguous(), s, g, e,
                                            max_bin=63, num_slots=4,
                                            out_slots=8)
    assert torch.equal(view[0], copy[0]) and torch.equal(view[1], copy[1])
    with pytest.raises(ValueError):
        th.build_histogram_wave_hl_fixed(b, b, s, g, e, max_bin=63,
                                         num_slots=4, out_slots=8)
