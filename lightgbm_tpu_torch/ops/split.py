"""Best-split finding: the reference's sequential per-bin gain scan, batched
over leaves (PyTorch port of `lightgbm_tpu/ops/split.py`).

Replaces FeatureHistogram::FindBestThresholdSequentially
(ref: src/treelearner/feature_histogram.hpp:831-1057): both scan
directions are evaluated for all leaves, features and thresholds at once
with masked prefix sums, then argmaxes pick the winners.  The parity
notes of the JAX module hold here unchanged: counts are
RoundInt(hess * cnt_factor) (hpp:871-874); accumulators carry kEpsilon;
REVERSE keeps missing on the left, FORWARD on the right; MissingType::Zero
skips the default bin; ties keep the first-visited threshold (largest for
REVERSE, smallest for FORWARD) and the smaller feature index; and
`snap_over_empty` snaps a winner across a run of empty bins to the run's
canonical end, since a prefix sum may disagree in the last ulp between
two thresholds that induce the same partition.

Extra-trees (USE_RAND, hpp:899) keeps only each leaf's random threshold
`rand_bin` as a candidate, in both scan directions.

Categorical features (ref: feature_histogram.cpp:144
FindBestThresholdCategoricalInner) are scanned only over their gathered
rows: one-hot mode (one category left) up to `max_cat_to_onehot` bins,
else the sorted-subset mode (categories stably sorted by
grad / (hess + cat_smooth), prefixes taken from both ends under
`max_cat_threshold` and the `min_data_per_group` group counter, with
`cat_l2` added to lambda_l2).  Its prefix sums are float64 cumsums
rounded to float32, like the numerical scan's; the group counter, which
resets whenever a candidate reaches evaluation, is the one recurrence,
a loop of min(max_cat_threshold, B) steps over [2, L, F_cat].  The winner
carries its left set as a bitset of bins (`cat_bitset`, bin 0, the
NaN/other bin, never in it).

Basic monotone constraints (feature_histogram.hpp:758 GetSplitGains
USE_MC) clamp every candidate's outputs to the leaf's [cmin, cmax] once
the tree has a constraint and score 0 the splits of a monotone feature
that break its order; `monotone_penalty` scales monotone features' gains
by the leaf's depth (monotone_constraints.hpp:357).  The advanced mode
(monotone_constraints.hpp:858 AdvancedLeafConstraints) passes per-child,
per-threshold [L, F, B] bounds instead of the leaf's scalars.  Path
smoothing blends each output with its parent's (hpp:716).  CEGB
subtracts tradeoff * (penalty_split * leaf rows + the coupled penalty of
a feature no earlier split used + the lazy penalties of the leaf's rows
not yet fetched for the feature) (cost_effective_gradient_boosting.hpp:79
DeltaGain, :139 CalculateOndemandCosts).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

K_EPSILON = 1e-15  # ref: include/LightGBM/meta.h:54
K_MIN_SCORE = float("-inf")

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


class SplitParams(NamedTuple):
    """Split hyperparameters of the scan (ref: Config)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    # categorical split finding; has_categorical=False skips the branch.
    # cat_features: inner indices of the categorical features (the
    # categorical scan runs over these rows only; () scans every feature)
    has_categorical: bool = False
    cat_features: tuple = ()
    max_cat_to_onehot: int = 4
    # basic-mode monotone constraints (False skips all of it)
    has_monotone: bool = False
    monotone_penalty: float = 0.0
    # extra-trees: one random threshold per (leaf, feature) is the only
    # candidate; extra_seed seeds the engines' draws
    extra_trees: bool = False
    extra_seed: int = 6
    # cost-effective gradient boosting: gain penalty tradeoff *
    # (penalty_split * leaf rows + coupled[f] * not_yet_used[f])
    has_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    # lazy per-(row, feature) acquisition penalty (ref:
    # cost_effective_gradient_boosting.hpp:139 CalculateOndemandCosts):
    # the scan receives each feature's cost summed over the leaf's rows
    # not yet fetched
    has_cegb_lazy: bool = False
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: int = 100


def cat_bitset_words(max_bin: int) -> int:
    """int32 bitset words needed for a categorical split over max_bin bins."""
    return max(1, (max_bin + 31) // 32)


class SplitResult(NamedTuple):
    """SplitInfo per leaf (ref: src/treelearner/split_info.hpp:22); each
    field has the leaves' leading shape."""
    gain: torch.Tensor            # shifted gain (<=0 means no valid split)
    feature: torch.Tensor         # inner feature index (int32)
    threshold: torch.Tensor       # bin threshold (int32)
    default_left: torch.Tensor    # bool
    left_sum_gradient: torch.Tensor
    left_sum_hessian: torch.Tensor
    left_count: torch.Tensor      # int32
    left_output: torch.Tensor
    right_sum_gradient: torch.Tensor
    right_sum_hessian: torch.Tensor
    right_count: torch.Tensor     # int32
    right_output: torch.Tensor
    is_cat: torch.Tensor          # bool: categorical split (bitset routing)
    cat_bitset: torch.Tensor      # [..., W] int32 words: bins going left


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """ref: feature_histogram.hpp:710 ThresholdL1."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(sum_g, sum_h, count, parent_output, p: SplitParams):
    """ref: feature_histogram.hpp:716 CalculateSplittedLeafOutput."""
    ret = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2)
    if p.max_delta_step > 0:
        ret = torch.clamp(ret, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > K_EPSILON:
        ratio = count.to(ret.dtype) / p.path_smooth
        ret = ret * ratio / (ratio + 1.0) + parent_output / (ratio + 1.0)
    return ret


def leaf_gain_given_output(sum_g, sum_h, out, p: SplitParams):
    """ref: feature_histogram.hpp:820 GetLeafGainGivenOutput."""
    sg_l1 = threshold_l1(sum_g, p.lambda_l1)
    return -(2.0 * sg_l1 * out + (sum_h + p.lambda_l2) * out * out)


def leaf_gain(sum_g, sum_h, count, parent_output, p: SplitParams):
    """ref: feature_histogram.hpp:800 GetLeafGain."""
    if p.max_delta_step <= 0 and p.path_smooth <= K_EPSILON:
        sg_l1 = threshold_l1(sum_g, p.lambda_l1)
        return (sg_l1 * sg_l1) / (sum_h + p.lambda_l2)
    out = leaf_output(sum_g, sum_h, count, parent_output, p)
    return leaf_gain_given_output(sum_g, sum_h, out, p)


def monotone_gain_penalty(depth: torch.Tensor, penalty: float):
    """Gain multiplier of monotone features at a leaf's depth (ref:
    monotone_constraints.hpp:357 ComputeMonotoneSplitGainPenalty)."""
    d = depth.to(torch.float32)
    eps = 1e-15
    if penalty <= 1.0:
        inner = 1.0 - penalty / torch.exp2(d) + eps
    else:
        inner = 1.0 - torch.exp2(penalty - 1.0 - d) + eps
    return torch.where(d + 1.0 <= penalty, torch.full_like(d, eps), inner)


def _round_int(x: torch.Tensor) -> torch.Tensor:
    """ref: utils/common.h RoundInt: static_cast<int>(x + 0.5)."""
    return torch.floor(x + 0.5).to(torch.int32)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., i] at per-row index idx[...] (gather on the last axis)."""
    return torch.gather(a, -1, idx.unsqueeze(-1).to(torch.int64)).squeeze(-1)


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _cat_best_split(grad, hess, cnt_factor, num_bin, sum_g, sum_h, nd, po,
                    min_gain_shift, p: SplitParams, rand_u=None):
    """Per-(leaf, feature) best categorical split over the gathered
    categorical features (ref: feature_histogram.cpp:144-320).

    grad, hess: [L, Fc, B] raw histogram channels; num_bin [Fc]; the leaf
    quantities are [L, 1, 1].  Bin 0 (NaN/other) never enters a left set.
    Under extra-trees rand_u [L, Fc, 2] holds the two USE_RAND draws: the
    one-hot candidate bin (cpp:187) and the sorted-subset prefix length
    (cpp:268); the group counter still resets on skipped candidates.

    Returns (gain, left_g, left_h, left_c, use_onehot [Fc], onehot_bin,
    use_fwd, prefix_idx, used_bin, order [L, Fc, B]), per [L, Fc] unless
    stated."""
    L, Fc, B = grad.shape
    dev = grad.device
    f32, i32 = torch.float32, torch.int32
    bins = torch.arange(B, dtype=i32, device=dev)
    nb = num_bin.to(i32)
    pcat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)

    in_range = (bins >= 1) & (bins < nb[:, None])                 # [Fc, B]
    zf = grad.new_zeros(())
    grad = torch.where(in_range, grad, zf)
    hess = torch.where(in_range, hess, zf)
    cnt = torch.where(in_range, _round_int(hess * cnt_factor),
                      torch.zeros((), dtype=i32, device=dev))
    use_rand = p.extra_trees and rand_u is not None

    def split_gain(lg, lh, lc, rg, rh, rc, ok, pp):
        ok = (ok & (lc >= p.min_data_in_leaf)
              & (lh >= p.min_sum_hessian_in_leaf)
              & (rc >= p.min_data_in_leaf)
              & (rh >= p.min_sum_hessian_in_leaf))
        gain = (leaf_gain(lg, lh, lc.to(f32), po, pp)
                + leaf_gain(rg, rh, rc.to(f32), po, pp))
        return torch.where(ok & (gain > min_gain_shift), gain,
                           torch.full_like(gain, K_MIN_SCORE))

    # ---- one-hot mode: left = one category; cat_l2 does not apply
    # (feature_histogram.cpp:250 adds it in the sorted-subset branch) ----
    oh_ok = in_range
    if use_rand:
        span = torch.clamp(nb - 1, min=1).to(f32)
        oh_rand = 1 + _clip((rand_u[..., 0] * span).to(i32),
                            torch.zeros((), dtype=i32, device=dev),
                            torch.clamp(nb - 2, min=0))           # [L, Fc]
        oh_ok = oh_ok & (bins == oh_rand[..., None])
    oh_gain = split_gain(grad, hess + K_EPSILON, cnt,
                         sum_g - grad, sum_h - hess - K_EPSILON,
                         nd - cnt, oh_ok, p)
    oh_best = torch.argmax(oh_gain, dim=-1).to(i32)               # [L, Fc]
    oh_best_gain = _take(oh_gain, oh_best)

    # ---- sorted-subset mode: categories with enough data, stably
    # sorted by grad / (hess + cat_smooth) ----
    valid = in_range & (cnt >= p.cat_smooth)
    ratio = torch.where(valid, grad / (hess + p.cat_smooth),
                        torch.full_like(grad, float("inf")))
    order = torch.sort(ratio, dim=-1, stable=True).indices        # [L,Fc,B]
    sg_s = torch.gather(grad, -1, order)
    sh_s = torch.gather(hess, -1, order)
    sc_s = torch.gather(cnt, -1, order)
    used_bin = valid.sum(dim=-1, dtype=i32)                       # [L, Fc]
    max_num_cat = torch.clamp(torch.div(used_bin + 1, 2,
                                        rounding_mode="floor"),
                              max=p.max_cat_threshold)
    steps = min(p.max_cat_threshold, B)
    if use_rand:
        max_thr = torch.clamp(torch.minimum(max_num_cat, used_bin) - 1,
                              min=0).to(f32)
        sub_rand = _clip((rand_u[..., 1] * torch.clamp(max_thr, min=1.0))
                         .to(i32), torch.zeros((), dtype=i32, device=dev),
                         torch.clamp(max_thr.to(i32) - 1, min=0))

    # both directions at once, [2, L, Fc, steps]: FORWARD from the
    # smallest ratio, BACKWARD from the largest valid one
    pos = used_bin[..., None] - 1 - bins[None, None, :steps]
    idx = torch.clamp(pos, 0, B - 1).to(torch.int64)
    g_d = torch.stack([sg_s[..., :steps], torch.gather(sg_s, -1, idx)])
    h_d = torch.stack([sh_s[..., :steps], torch.gather(sh_s, -1, idx)])
    c_d = torch.stack([sc_s[..., :steps], torch.gather(sc_s, -1, idx)])
    f64 = torch.float64
    lg = torch.cumsum(g_d, dim=-1, dtype=f64).to(f32)
    lh = (torch.cumsum(h_d, dim=-1, dtype=f64) + K_EPSILON).to(f32)
    lc = torch.cumsum(c_d, dim=-1, dtype=i32)
    rc = nd - lc
    rh = sum_h - lh
    rg = sum_g - lg
    # the reference's break conditions shrink the right side, monotone in
    # the step, so masking equals breaking
    ar = torch.arange(steps, dtype=i32, device=dev)
    in_limit = ar < torch.minimum(used_bin, max_num_cat)[..., None]
    base = (in_limit & (lc >= p.min_data_in_leaf)
            & (lh >= p.min_sum_hessian_in_leaf)
            & (rc >= p.min_data_in_leaf) & (rc >= p.min_data_per_group)
            & (rh >= p.min_sum_hessian_in_leaf))
    # the group counter: rows since the last candidate that reached
    # evaluation (cpp:296-318), the scan's one true recurrence
    cum = torch.zeros(c_d.shape[:-1], dtype=i32, device=dev)
    elig = []
    for i in range(steps):
        cum.add_(c_d[..., i])
        e = base[..., i] & (cum >= p.min_data_per_group)
        cum.masked_fill_(e, 0)
        elig.append(e)
    eligible = torch.stack(elig, dim=-1)
    raw = (leaf_gain(lg, lh, lc.to(f32), po, pcat)
           + leaf_gain(rg, rh, rc.to(f32), po, pcat))
    gain_ok = eligible & (raw > min_gain_shift)
    if use_rand:
        gain_ok = gain_ok & (ar == sub_rand[..., None])
    gains = torch.where(gain_ok, raw, torch.full_like(raw, K_MIN_SCORE))
    best_i = torch.argmax(gains, dim=-1).to(i32)                  # [2,L,Fc]
    d_gain, d_lg = _take(gains, best_i), _take(lg, best_i)
    d_lh, d_lc = _take(lh, best_i), _take(lc, best_i)
    use_fw = d_gain[0] >= d_gain[1]

    def pick(a):
        return torch.where(use_fw, a[0], a[1])

    use_onehot = nb <= p.max_cat_to_onehot                        # [Fc]
    gain = torch.where(use_onehot, oh_best_gain, pick(d_gain))
    left_g = torch.where(use_onehot, _take(grad, oh_best), pick(d_lg))
    left_h = torch.where(use_onehot, _take(hess, oh_best) + K_EPSILON,
                         pick(d_lh))
    left_c = torch.where(use_onehot, _take(cnt, oh_best), pick(d_lc))
    return (gain, left_g, left_h, left_c, use_onehot, oh_best, use_fw,
            pick(best_i), used_bin, order)


def find_best_split(hist: torch.Tensor, num_bin: torch.Tensor,
                    missing_type: torch.Tensor, default_bin: torch.Tensor,
                    feature_penalty: torch.Tensor, col_mask: torch.Tensor,
                    sum_gradient: torch.Tensor, sum_hessian: torch.Tensor,
                    num_data: torch.Tensor, parent_output: torch.Tensor,
                    params: SplitParams,
                    rand_bin: torch.Tensor = None,
                    is_cat_feature: torch.Tensor = None,
                    rand_cat_u: torch.Tensor = None,
                    monotone: torch.Tensor = None,
                    constraint_min: torch.Tensor = None,
                    constraint_max: torch.Tensor = None,
                    mono_penalty: torch.Tensor = None,
                    cegb_coupled: torch.Tensor = None,
                    cegb_used: torch.Tensor = None,
                    constraint_min_left: torch.Tensor = None,
                    constraint_max_left: torch.Tensor = None,
                    constraint_min_right: torch.Tensor = None,
                    constraint_max_right: torch.Tensor = None,
                    cegb_lazy_cost: torch.Tensor = None,
                    return_feature_gains: bool = False) -> SplitResult:
    """Scan all (feature, threshold, direction) candidates of every leaf;
    return each leaf's best.

    Args:
      hist: [L, F, B, 2] (sum_gradient, sum_hessian) per bin.
      num_bin/missing_type/default_bin: [F] int32 per-feature metadata.
      feature_penalty: [F] gain multiplier (feature_contri).
      col_mask: [F] bool feature sampling mask, or [L, F] per leaf.
      sum_gradient/sum_hessian: [L] leaf totals (hessian WITHOUT the
        +2eps, added here, ref: feature_histogram.hpp:169).
      num_data: [L] int32 row count per leaf.
      parent_output: [L] leaf's current output.
      rand_bin: [L, F] int32 extra-trees thresholds (ref:
        feature_histogram.hpp:204 USE_RAND), or None.
      is_cat_feature: [F] bool (with params.has_categorical).
      rand_cat_u: [L, F, 2] categorical USE_RAND uniforms, or None.
      monotone, constraint_min/max, mono_penalty: [F] int32 -1/0/+1 and
        the leaves' [L] bounds and depth multipliers (has_monotone).
      cegb_coupled, cegb_used: [F] coupled penalties and the features an
        earlier split used (has_cegb).
      constraint_{min,max}_{left,right}: [L, F, B] per-child bounds of a
        split at each threshold (advanced monotone mode), or None.
      cegb_lazy_cost: [L, F] lazy penalties summed over each leaf's rows
        not yet fetched (has_cegb_lazy), or None.
      return_feature_gains: return the [L, F] per-feature shifted best
        gains instead (after the column mask, the CEGB shift and the
        monotone penalty, before the argmax): the voting learner's local
        vote ranks features by them, and a feature-parallel rank's
        gains over its column block are these gains' columns.
    """
    L, F, B, _ = hist.shape
    dev = hist.device
    f32, i32 = torch.float32, torch.int32
    p = params
    sum_g = sum_gradient.to(f32)[:, None, None]                  # [L,1,1]
    sum_h = sum_hessian.to(f32)[:, None, None] + 2 * K_EPSILON
    nd = num_data.to(i32)[:, None, None]
    n_leaf = nd.to(f32)
    cnt_factor = n_leaf / sum_h
    po = parent_output.to(f32)[:, None, None]

    bins = torch.arange(B, dtype=i32, device=dev)[None, :]      # [1, B]
    nb = num_bin.to(i32)[:, None]
    mt = missing_type.to(i32)[:, None]
    db = default_bin.to(i32)[:, None]
    na_extra = (mt == MISSING_NAN).to(i32)                        # [F, 1]

    in_range = bins < nb
    is_na_bin = (mt == MISSING_NAN) & (bins == nb - 1)
    is_def_bin = (mt == MISSING_ZERO) & (bins == db)
    acc = in_range & ~is_na_bin & ~is_def_bin                     # [F, B]
    zero = hist.new_zeros(())
    grad = torch.where(acc, hist[..., 0], zero)                   # [L,F,B]
    hess = torch.where(acc, hist[..., 1], zero)
    cnt = torch.where(acc, _round_int(hist[..., 1] * cnt_factor),
                      torch.zeros((), dtype=i32, device=dev))

    # prefix sums accumulate in float64 and round to float32, so the CPU
    # and CUDA scans (which add in different orders) agree
    pg = torch.cumsum(grad, dim=-1, dtype=torch.float64).to(f32)
    ph = torch.cumsum(hess, dim=-1, dtype=torch.float64).to(f32)
    pc = torch.cumsum(cnt, dim=-1, dtype=i32)
    tg, th, tc = pg[..., -1:], ph[..., -1:], pc[..., -1:]

    min_gain_shift = (leaf_gain(sum_g, sum_h, n_leaf, po, p)
                      + p.min_gain_to_split)
    if p.has_monotone:
        mc = monotone.to(i32)[None, :, None]                     # [1,F,1]
        cmin = constraint_min.to(f32)[:, None, None]
        cmax = constraint_max.to(f32)[:, None, None]
        adv = constraint_min_left is not None
        # the advanced mode's per-child [L, F, B] bounds, else the leaf's
        if adv:
            cmin_l, cmax_l = constraint_min_left, constraint_max_left
            cmin_r, cmax_r = constraint_min_right, constraint_max_right
        else:
            cmin_l = cmin_r = cmin
            cmax_l = cmax_r = cmax

    def eval_candidates(left_g, left_h_raw, left_c, tau_ok):
        left_h = left_h_raw + K_EPSILON
        right_g = sum_g - left_g
        right_h = sum_h - left_h
        right_c = nd - left_c
        ok = (tau_ok
              & (left_c >= p.min_data_in_leaf)
              & (left_h >= p.min_sum_hessian_in_leaf)
              & (right_c >= p.min_data_in_leaf)
              & (right_h >= p.min_sum_hessian_in_leaf))
        gain = (leaf_gain(left_g, left_h, left_c.to(f32), po, p)
                + leaf_gain(right_g, right_h, right_c.to(f32), po, p))
        if p.has_monotone:
            # outputs clamped to the leaf's [cmin, cmax] for every
            # feature; a monotone feature's split that breaks its order
            # scores 0 (feature_histogram.hpp:758-797 USE_MC)
            lout = _clip(leaf_output(left_g, left_h, left_c.to(f32), po, p),
                         cmin_l, cmax_l)
            rout = _clip(leaf_output(right_g, right_h, right_c.to(f32), po,
                                     p), cmin_r, cmax_r)
            bad = ((mc > 0) & (lout > rout)) | ((mc < 0) & (lout < rout))
            gain_mc = (leaf_gain_given_output(left_g, left_h, lout, p)
                       + leaf_gain_given_output(right_g, right_h, rout, p))
            gain = torch.where(bad & (mc != 0), torch.zeros_like(gain_mc),
                               gain_mc)
        ok = ok & (gain > min_gain_shift)
        return torch.where(ok, gain, torch.full_like(gain, K_MIN_SCORE))

    # canonical tie-break across empty-bin runs (see module docstring)
    nonempty = (grad != 0.0) | (hess != 0.0) | (cnt != 0)
    last_ne = torch.cummax(
        torch.where(nonempty, bins.expand_as(cnt), torch.full_like(cnt, -1)),
        dim=-1).values

    def snap_over_empty(best_idx, gain_3d, up):
        t0 = best_idx.unsqueeze(-1)                                 # [L,F,1]
        valid = gain_3d > K_MIN_SCORE
        bb = bins.expand_as(cnt)
        if up:
            run = valid & (bb >= t0) & (last_ne <= t0)
            return torch.where(run, bb, t0).amax(dim=-1)
        lo = torch.gather(last_ne, -1, t0.to(torch.int64))
        run = valid & (bb <= t0) & (bb >= lo)
        return torch.where(run, bb, t0).amin(dim=-1)

    # REVERSE: left = bins <= tau (+NaN, +zero bin when default_left)
    rev_tau_ok = (bins <= nb - 2 - na_extra) & in_range
    rev_tau_ok &= ~((mt == MISSING_ZERO) & (bins == db - 1))
    if rand_bin is not None:
        # only the leaf's random threshold is a candidate (hpp:899
        # `t - 1 + offset != rand_threshold -> continue`)
        is_rand = bins == rand_bin.to(i32)[..., None]            # [L,F,B]
        rev_tau_ok = rev_tau_ok & is_rand
    rev_left_g = sum_g - (tg - pg)
    rev_left_h_raw = sum_h - (th - ph) - 2 * K_EPSILON
    rev_left_c = nd - (tc - pc)
    rev_gain = eval_candidates(rev_left_g, rev_left_h_raw, rev_left_c,
                               rev_tau_ok)
    rev_best_idx = (B - 1 - torch.argmax(torch.flip(rev_gain, dims=[-1]),
                                         dim=-1)).to(i32)
    rev_best_idx = snap_over_empty(rev_best_idx, rev_gain, up=True)
    rev_best_gain = _take(rev_gain, rev_best_idx)

    # FORWARD: left = inclusive prefix at tau; missing goes right
    fwd_tau_ok = (bins <= nb - 2) & in_range & (mt != MISSING_NONE)
    fwd_tau_ok &= ~((mt == MISSING_ZERO) & (bins == db))
    if rand_bin is not None:
        fwd_tau_ok = fwd_tau_ok & is_rand
    fwd_gain = eval_candidates(pg, ph, pc, fwd_tau_ok)
    fwd_best_idx = torch.argmax(fwd_gain, dim=-1).to(i32)
    fwd_best_idx = snap_over_empty(fwd_best_idx, fwd_gain, up=False)
    fwd_best_gain = _take(fwd_gain, fwd_best_idx)

    # forward replaces reverse only on strictly larger gain (hpp:1031)
    use_fwd = fwd_best_gain > rev_best_gain                         # [L, F]
    best_gain_f = torch.where(use_fwd, fwd_best_gain, rev_best_gain)
    best_thr_f = torch.where(use_fwd, fwd_best_idx, rev_best_idx)
    lg = torch.where(use_fwd, _take(pg, fwd_best_idx),
                     _take(rev_left_g, rev_best_idx))
    lh_raw = torch.where(use_fwd, _take(ph, fwd_best_idx),
                         _take(rev_left_h_raw, rev_best_idx))
    lc = torch.where(use_fwd, _take(pc, fwd_best_idx),
                     _take(rev_left_c, rev_best_idx))
    default_left_f = ~use_fwd

    W = cat_bitset_words(B)
    if p.has_categorical:
        # the categorical scan runs over the categorical rows only; its
        # results replace their numerical ones (is_cat_feature guards a
        # numerical feature listed in cat_features)
        cat_idx = p.cat_features if p.cat_features else tuple(range(F))
        Fc = len(cat_idx)
        ci = torch.tensor(cat_idx, dtype=torch.int64, device=dev)
        (cgain, clg, clh, clc, c_onehot, c_ohbin, c_fwd, c_plen, c_ub,
         c_order) = _cat_best_split(
            hist[:, ci, :, 0], hist[:, ci, :, 1], cnt_factor, num_bin[ci],
            sum_g, sum_h, nd, po, min_gain_shift, p,
            rand_u=None if rand_cat_u is None else rand_cat_u[:, ci])
        catset = (torch.zeros(F, dtype=torch.bool, device=dev)
                  .index_fill_(0, ci, True) & is_cat_feature.to(torch.bool))

        def put(full, part):
            return torch.where(catset, full.index_copy(1, ci, part), full)

        best_gain_f = put(best_gain_f, cgain)
        lg = put(lg, clg)
        lh_raw = put(lh_raw, clh - K_EPSILON)
        lc = put(lc, clc)
        default_left_f = default_left_f & ~catset
        pos_of_f = torch.zeros(F, dtype=torch.int64, device=dev).index_copy_(
            0, ci, torch.arange(Fc, dtype=torch.int64, device=dev))

    # feature penalty + column sampling, then the best feature (gain tie
    # -> smaller index, SplitInfo::operator>)
    mgs = min_gain_shift[:, :, 0]                                   # [L, 1]
    shifted = (best_gain_f - mgs) * feature_penalty.to(f32)[None, :]
    if p.has_cegb:
        # ref: serial_tree_learner.cpp:983 new_split.gain -= DeltaGain
        delta = p.cegb_tradeoff * (p.cegb_penalty_split * nd[:, :, 0].to(f32))
        if cegb_coupled is not None:
            used = cegb_used if cegb_used.dim() == 2 else cegb_used[None, :]
            delta = delta + p.cegb_tradeoff * torch.where(
                used, torch.zeros((), dtype=f32, device=dev),
                cegb_coupled.to(f32)[None, :])
        if p.has_cegb_lazy and cegb_lazy_cost is not None:
            # DeltaGain's CalculateOndemandCosts term (hpp:91)
            delta = delta + p.cegb_tradeoff * cegb_lazy_cost.to(f32)
        shifted = shifted - delta
    if p.has_monotone and p.monotone_penalty > 0:
        # depth penalty on monotone features (serial_tree_learner.cpp:987)
        shifted = torch.where(monotone[None, :] != 0,
                              shifted * mono_penalty.to(f32)[:, None],
                              shifted)
    cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
    shifted = torch.where(cm & (best_gain_f > K_MIN_SCORE),
                          shifted, torch.full_like(shifted, K_MIN_SCORE))
    if return_feature_gains:
        # per-feature shifted best gains (ref: voting_parallel_tree_
        # learner.cpp:151 GlobalVoting ranks features by their local best
        # split gains)
        return shifted
    best_f = torch.argmax(shifted, dim=-1).to(i32)                  # [L]

    g_ = _take(shifted, best_f)
    lg_, lc_ = _take(lg, best_f), _take(lc, best_f)
    lh_ = _take(lh_raw, best_f) + K_EPSILON
    sg, sh = sum_g[:, 0, 0], sum_h[:, 0, 0]
    rg_, rc_ = sg - lg_, nd[:, 0, 0] - lc_
    rh_ = sh - lh_
    po1 = po[:, 0, 0]
    thr_out = _take(best_thr_f, best_f)
    thr_num = thr_out          # the numerical threshold, before cat zeroing
    if p.has_categorical:
        won_cat = catset[best_f.to(torch.int64)]                    # [L]
        rows = torch.arange(L, device=dev)
        cpos = pos_of_f[best_f.to(torch.int64)]
        # lambda_l2 + cat_l2 for sorted-subset winners only (cpp:250)
        pcat = p._replace(lambda_l2=p.lambda_l2 + p.cat_l2)
        won_subset = won_cat & ~c_onehot[cpos]
        left_out = torch.where(
            won_subset, leaf_output(lg_, lh_, lc_.to(f32), po1, pcat),
            leaf_output(lg_, lh_, lc_.to(f32), po1, p))
        right_out = torch.where(
            won_subset, leaf_output(rg_, rh_, rc_.to(f32), po1, pcat),
            leaf_output(rg_, rh_, rc_.to(f32), po1, p))
        # the winning left set as a bitset of bins (ref: split_info.hpp
        # cat_threshold, in bins on the device)
        sorted_w = c_order[rows, cpos]                              # [L, B]
        ub = c_ub[rows, cpos][:, None]
        plen = c_plen[rows, cpos][:, None] + 1
        posb = torch.arange(B, dtype=i32, device=dev)[None, :]
        in_set_sorted = torch.where(c_fwd[rows, cpos][:, None], posb < plen,
                                    (posb >= ub - plen) & (posb < ub))
        member = torch.zeros((L, B), dtype=torch.bool, device=dev).scatter_(
            1, sorted_w, in_set_sorted)
        member = torch.where(c_onehot[cpos][:, None],
                             posb == c_ohbin[rows, cpos][:, None], member)
        member = member & won_cat[:, None]
        padded = torch.zeros((L, W * 32), dtype=torch.int64, device=dev)
        padded[:, :B] = member.to(torch.int64)
        shifts = torch.arange(32, dtype=torch.int64, device=dev)
        words = (padded.view(L, W, 32) << shifts).sum(dim=-1)
        cat_bitset = torch.where(words >= 2 ** 31, words - 2 ** 32,
                                 words).to(i32)
        is_cat_out = won_cat
        thr_out = torch.where(won_cat, torch.zeros_like(thr_out), thr_out)
    else:
        left_out = leaf_output(lg_, lh_, lc_.to(f32), po1, p)
        right_out = leaf_output(rg_, rh_, rc_.to(f32), po1, p)
        cat_bitset = torch.zeros((L, W), dtype=i32, device=dev)
        is_cat_out = torch.zeros(L, dtype=torch.bool, device=dev)
    if p.has_monotone:
        # the leaf's [min, max] clamps the winner's stored outputs too
        # (CalculateSplittedLeafOutput USE_MC, feature_histogram.hpp:740);
        # the advanced mode clamps with its bounds at the winning
        # (feature, threshold), a categorical winner with the leaf's
        lo, hi = constraint_min.to(f32), constraint_max.to(f32)
        if adv:
            at = (best_f.to(torch.int64)[:, None],
                  thr_num.to(torch.int64)[:, None])

            def won(bound, scalar):
                b = torch.gather(bound, 1, at[0][:, :, None].expand(
                    -1, 1, B))[:, 0]                                # [L, B]
                return torch.where(is_cat_out, scalar,
                                   torch.gather(b, 1, at[1])[:, 0])
            left_out = _clip(left_out, won(cmin_l, lo), won(cmax_l, hi))
            right_out = _clip(right_out, won(cmin_r, lo), won(cmax_r, hi))
        else:
            left_out = _clip(left_out, lo, hi)
            right_out = _clip(right_out, lo, hi)
    return SplitResult(
        gain=g_, feature=best_f, threshold=thr_out,
        default_left=_take(default_left_f, best_f),
        left_sum_gradient=lg_, left_sum_hessian=lh_ - K_EPSILON,
        left_count=lc_, left_output=left_out,
        right_sum_gradient=rg_, right_sum_hessian=rh_ - K_EPSILON,
        right_count=rc_, right_output=right_out,
        is_cat=is_cat_out, cat_bitset=cat_bitset)
