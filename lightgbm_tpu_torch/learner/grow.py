"""Leaf-wise (best-first) tree growth, and the types it shares with the
wave engine (PyTorch port of `lightgbm_tpu/learner/grow.py`, ref:
src/treelearner/serial_tree_learner.cpp:179-240).

`grow_tree_impl` splits one leaf at a time, the leaf of largest pending
gain (serial_tree_learner.cpp:219 ArgMax), until num_leaves.  The JAX
engine runs the loop as a `lax.fori_loop` inside one jit; here it is a
host loop of torch ops with one host read per split (the chosen leaf,
its split and its row segment).

* Root: one histogram of every row and one scan.
* Partitioned engine (`0 < compact_min < n` and num_leaves > 2): a row
  permutation keeps each leaf's rows in one contiguous segment
  (DataPartition, ref: data_partition.hpp:21).  A split gathers its
  leaf's segment, rounded up to the K4 kernel's 512-row tile (the JAX
  engine rounds up a pow2 bucket ladder instead; masked-out rows add
  nothing, so the trees agree), partitions it in place (stable, left
  rows first), recolors the right rows, and builds the smaller child's
  histogram from the segment's rows.
* Masked engine (otherwise): every split rescans all rows with the
  leaf's membership mask.
* Histogram stack (`use_hist_stack`): the larger child is parent -
  smaller (ref: feature_histogram.hpp Subtract).  The stack holds K4's
  64-bit fixed-point sums on one grid per tree (`scale_exps` of the
  tree's gh), so the subtraction is exact; without the stack both
  children are rebuilt.

Every histogram goes through `build_histogram_rows_fixed` (K4 on the
card).  Extra-trees thresholds and `feature_fraction_bynode` column
subsets are the JAX engine's threefry draws, one per leaf scan, keyed by
the scan's tag (0 for the root, 2i+1 and 2i+2 for the children of split
i) under a key folded with the booster's `extra_tag`; the tree's draws
are made at once.  Categorical splits route rows by their bin bitset
(ref: tree.h:372 CategoricalDecision); basic monotone constraints bound
both children of a monotone split at the midpoint of their outputs
(monotone_constraints.hpp:489 BasicLeafConstraints::Update); CEGB marks
each split's feature used before the children's scans and refunds the
coupled penalty to other leaves' pending splits on that feature
(cost_effective_gradient_boosting.hpp UpdateLeafBestSplits).

EFB: with bundles `binned` holds [F', n] bundle codes; histograms are
built, stacked and subtracted in group space ([F', group_max_bin]) and
converted to per-feature histograms for the scan
(`bundle_hist_to_features`); the partition decodes the split feature's
bin from its bundle column.  Forced splits run first, one split per
step in the parse-time BFS numbering (the first that cannot apply ends
the forcing, and best-gain growth takes its place); interaction
constraints narrow each leaf's column mask to what its branch allows.

Intermediate monotone mode (`monotone_intermediate`; ref:
monotone_constraints.hpp:516 IntermediateLeafConstraints), the JAX
engine's redesign of the reference's recursive crawl: each leaf keeps its
bin-space rectangle, every leaf's [cmin, cmax] comes from the [L, L, F]
contiguity relation of the rectangles in one pass after every split, and
every alive leaf's pending split is rescanned from the histogram stack
in one batched scan.  The advanced mode (`monotone_advanced`;
monotone_constraints.hpp:858 AdvancedLeafConstraints) gives that scan
per-child, per-threshold [L, F, B] bounds instead of the leaf's scalars,
made with scatter-min/max and cumulative min/max along the bins.  Lazy
CEGB (cost_effective_gradient_boosting.hpp:139) charges each scan the
lazy penalties of its leaf's bagged-in rows not yet fetched for a
feature; a split marks the split leaf's rows fetched for its feature
before the children's scans, in an [F, n] state the booster carries from
tree to tree.

Parallel learners (parallel/): under data-parallel training (`net`)
every histogram, count and sum is all-reduced over the ranks' rows.  The
feature-parallel learner (`block`) keeps every row: K4 histograms the
rank's block of columns, the stack holds the block, and each scan
all-gathers the ranks' per-leaf best splits.  The voting-parallel
learner (`voting`, the JAX engine's `best_of` under `params.voting`)
builds every scanned leaf's histogram itself: the ranks vote on its
top-k features and reduce only their histograms
(parallel/voting.py); the root histogram is never reduced whole, and
both children are rebuilt (no stack), since a parent and its children
elect different features.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.histogram import (ROW_TILE, build_histogram_rows_fixed,
                             codes_to_int, fixed_unit, from_fixed,
                             scale_exps)
from ..observability.costmodel import (global_cost_model, rows_hist_bytes,
                                       rows_hist_ops)
from ..ops.split import (K_MIN_SCORE, MISSING_NAN, MISSING_ZERO,
                         SplitParams, SplitResult, cat_bitset_words,
                         find_best_split, leaf_gain, leaf_output,
                         monotone_gain_penalty)
from ..parallel.data_parallel import exact_sum
from ..parallel.voting import voting_hist_elect
from ..utils import random as jrandom
from ..utils.timer import global_timer


class FeatureMeta(NamedTuple):
    """Per-feature bin metadata on the device (ref: FeatureMetainfo,
    feature_histogram.hpp:40)."""
    num_bin: torch.Tensor        # [F] int32
    missing_type: torch.Tensor   # [F] int32
    default_bin: torch.Tensor    # [F] int32
    penalty: torch.Tensor        # [F] float32 (feature_contri)
    is_cat: torch.Tensor = None  # [F] bool (categorical features)
    monotone: torch.Tensor = None     # [F] int32 -1/0/+1
    cegb_coupled: torch.Tensor = None  # [F] float32 coupled penalties
    cegb_lazy: torch.Tensor = None     # [F] float32 lazy per-row penalties
    # EFB (ref: feature_group.h): feature -> bundle column, code offset,
    # default (zero) bin, membership of a bundle of more than one
    group: torch.Tensor = None      # [F] int32 bundle column
    offset: torch.Tensor = None     # [F] int32 code offset (0 singleton)
    zero_bin: torch.Tensor = None   # [F] int32 default bin
    in_bundle: torch.Tensor = None  # [F] bool


class GrowParams(NamedTuple):
    """Growth hyperparameters of the wave and leaf-wise engines."""
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    split: SplitParams = SplitParams()
    # wave engine: once the leaf budget binds, spend at most half of it
    # per wave (best-gain-first)
    wave_tail_halving: bool = False
    # overgrow past num_leaves with the level-batched ladder, then prune
    # back to num_leaves in the leaf-wise best-gain pop order (ref:
    # serial_tree_learner.cpp:219 ArgMax leaf order)
    wave_prune: bool = False
    wave_prune_overshoot: float = 1.5
    # prune mode: leaves of the overgrow budget reserved for narrow
    # best-gain-only "spike" waves after the ladder (0 disables)
    wave_spike_reserve: int = 0
    wave_spike_k: int = 8
    # leaf-wise engine: the partitioned engine (each split reads only the
    # split leaf's contiguous row segment) runs when 0 < compact_min < n
    # and num_leaves > 2; else the masked engine rescans every row
    compact_min: int = 4096
    # leaf-wise engine: keep the per-leaf histogram stack and complete
    # the larger child by subtraction; False rebuilds both children
    use_hist_stack: bool = True
    # quantized training: num_grad_quant_bins when the K2 gate holds
    # (the wave engine then sums quantized integers; 0 disables)
    quant_bins: int = 0
    # per-node column sampling (ref: col_sampler.hpp fraction_bynode_):
    # each leaf scan draws an exactly-k feature subset of this fraction
    feature_fraction_bynode: float = 1.0
    bynode_seed: int = 2
    # EFB: binned holds [F', n] bundle codes; histograms are built in
    # group space (group_max_bin bins) and converted to per-feature
    # histograms where the scan reads them (bundle_hist_to_features)
    has_bundles: bool = False
    group_max_bin: int = 0
    # forced splits (ref: serial_tree_learner.cpp:614 ForceSplits): BFS
    # ordered (leaf, inner feature, threshold bin) tuples applied before
    # best-gain growth; they need use_hist_stack
    forced_splits: tuple = ()
    # interaction constraints (ref: col_sampler.hpp:91 GetByNode): tuples
    # of inner feature indices; a leaf may split on its branch's features
    # and on the features of every set that holds its whole branch
    interaction_sets: tuple = ()
    # leaf-wise engine: monotone_constraints_method=intermediate (leaf
    # rectangles, every leaf's bounds recomputed and every pending split
    # rescanned after each split; needs use_hist_stack, no extra-trees or
    # bynode draws) and advanced (per-threshold bounds; needs
    # monotone_intermediate)
    monotone_intermediate: bool = False
    monotone_advanced: bool = False


class TreeArrays(NamedTuple):
    """Grown tree as parallel arrays (mirrors Tree, ref: tree.h:25)."""
    num_leaves: int               # realized leaf count (host int)
    split_feature: torch.Tensor   # [L-1] int32 (inner feature index)
    threshold_bin: torch.Tensor   # [L-1] int32
    default_left: torch.Tensor    # [L-1] bool
    split_gain: torch.Tensor      # [L-1] float32
    left_child: torch.Tensor      # [L-1] int32 (~leaf encoding)
    right_child: torch.Tensor     # [L-1] int32
    internal_value: torch.Tensor  # [L-1] float32
    internal_weight: torch.Tensor  # [L-1] float32
    internal_count: torch.Tensor  # [L-1] int32
    leaf_value: torch.Tensor      # [L] float32
    leaf_weight: torch.Tensor     # [L] float32
    leaf_count: torch.Tensor      # [L] int32
    leaf_parent: torch.Tensor     # [L] int32
    leaf_depth: torch.Tensor      # [L] int32
    split_is_cat: torch.Tensor = None  # [L-1] bool (categorical split)
    cat_bitset: torch.Tensor = None    # [L-1, W] int32 bins-left bitsets


def bundle_hist_to_features(hist_g, sum_g, sum_h, meta: FeatureMeta,
                            B: int, hist_B: int, has_bundles: bool):
    """Group-space histogram [..., F', hist_B, C] -> per-feature histogram
    [..., F, B, C] under EFB (ref: dataset.h:759 FixHistogram): each
    member's code range is sliced out of its bundle column, and a bundle
    member's default bin, which no row's code names, is the leaf total
    less the member's other bins.  With `sum_g` and `sum_h` None (the
    engines' integer sums) the leaf total is the bundle column's own
    total, every row of the leaf lying in one of its bins, so the default
    bin is exact; given the leaf sums, as the JAX function takes them, it
    is their difference.  No-op without bundles."""
    if not has_bundles:
        return hist_g
    i64 = torch.int64
    dev = hist_g.device
    lead = hist_g.shape[:-3]
    Fg, C = hist_g.shape[-3], hist_g.shape[-1]
    F = meta.num_bin.shape[0]
    bins = torch.arange(B, dtype=i64, device=dev)
    nb, zb = meta.num_bin.to(i64), meta.zero_bin.to(i64)
    cols = meta.offset.to(i64)[:, None] + bins[None, :]             # [F, B]
    valid = (bins[None, :] < nb[:, None]) & (cols < hist_B)
    flat = meta.group.to(i64)[:, None] * hist_B + cols.clamp(max=hist_B - 1)
    hf = hist_g.reshape(*lead, Fg * hist_B, C).index_select(
        -2, flat.reshape(-1)).reshape(*lead, F, B, C)
    hf = torch.where(valid[..., None], hf, torch.zeros((), dtype=hf.dtype,
                                                       device=dev))
    is_zb = (bins[None, :] == zb[:, None])[..., None]              # [F, B, 1]
    at_zb = torch.where(is_zb, hf, torch.zeros((), dtype=hf.dtype,
                                               device=dev)).sum(-2)
    rest = hf.sum(-2) - at_zb                               # [..., F, C]
    if sum_g is None:
        total = hist_g.sum(-2).index_select(-2, meta.group.to(i64))
    else:
        total = torch.stack([sum_g, sum_h], -1)[..., None, :]
    new_zb = torch.where(meta.in_bundle[:, None], total - rest, at_zb)
    return torch.where(is_zb, new_zb[..., None, :], hf)


def gather_forced_split(hist, ffeat: int, fthr: int, sum_g, sum_h_raw,
                        nleaf, meta: FeatureMeta, B: int,
                        sp: SplitParams) -> SplitResult:
    """SplitResult of a forced (feature, threshold) split of one leaf,
    gathered from its per-feature histogram [F, B, 2] (ref:
    feature_histogram GatherInfoForThreshold; serial_tree_learner.cpp:614
    ForceSplits; the JAX engines' `gather_forced_split`).  Missing values
    go right (default_left is False, as the partition applies it); its
    gain is K_MIN_SCORE when a child would be empty.  Both engines use
    it."""
    f32 = torch.float32
    dev = hist.device
    sum_h = sum_h_raw + 2e-15
    cnt_factor = nleaf / sum_h
    bins = torch.arange(B, dtype=torch.int32, device=dev)
    nb = meta.num_bin[ffeat]
    is_na = (meta.missing_type[ffeat] == MISSING_NAN) & (bins == nb - 1)
    # MISSING_ZERO rows (the default bin) go right, as the partition
    # routes them under default_left=False
    is_zero = ((meta.missing_type[ffeat] == MISSING_ZERO)
               & (bins == meta.default_bin[ffeat]))
    take = (bins <= fthr) & (bins < nb) & ~is_na & ~is_zero
    hf = hist[ffeat]
    zero = torch.zeros((), dtype=f32, device=dev)
    lg = torch.where(take, hf[:, 0], zero).sum()
    lh_raw = torch.where(take, hf[:, 1], zero).sum()
    lh = lh_raw + 1e-15
    lc = torch.round(lh_raw * cnt_factor).to(torch.int32)
    rg = sum_g - lg
    rh = sum_h - lh
    rc = torch.round(nleaf).to(torch.int32) - lc
    po = zero
    gain = (leaf_gain(lg, lh, lc.to(f32), po, sp)
            + leaf_gain(rg, rh, rc.to(f32), po, sp))
    valid = (lc > 0) & (rc > 0)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)
    return SplitResult(
        gain=torch.where(valid, gain, torch.full_like(gain, K_MIN_SCORE)),
        feature=i32(ffeat), threshold=i32(fthr),
        default_left=torch.tensor(False, device=dev),
        left_sum_gradient=lg, left_sum_hessian=lh - 1e-15, left_count=lc,
        left_output=leaf_output(lg, lh, lc.to(f32), po, sp),
        right_sum_gradient=rg, right_sum_hessian=rh - 1e-15, right_count=rc,
        right_output=leaf_output(rg, rh, rc.to(f32), po, sp),
        is_cat=torch.tensor(False, device=dev),
        cat_bitset=torch.zeros(cat_bitset_words(B), dtype=torch.int32,
                               device=dev))


def interaction_masks(sets, num_features: int, device) -> torch.Tensor:
    """[S, F] bool: the features of each interaction set."""
    m = torch.zeros((len(sets), num_features), dtype=torch.bool)
    for i, fs in enumerate(sets):
        m[i, list(fs)] = True
    return m.to(device)


def allowed_features(branch: torch.Tensor,
                     set_masks: torch.Tensor) -> torch.Tensor:
    """[..., F] branch features -> [..., F] the features a leaf may split
    on (ref: col_sampler.hpp:91 GetByNode): those of its branch and of
    every interaction set that holds the whole branch."""
    fits = ~(branch[..., None, :] & ~set_masks).any(-1)       # [..., S]
    return branch | (fits[..., None] & set_masks).any(-2)


def monotone_bounds(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                    out: torch.Tensor, monotone: torch.Tensor,
                    max_bin: int = None):
    """Every leaf's monotone bounds from the bin-space rectangles of the A
    alive leaves (the JAX engine's intermediate and advanced modes,
    grow.py:895-1062; ref: monotone_constraints.hpp:516
    IntermediateLeafConstraints, :858 AdvancedLeafConstraints).

    leaf_lo, leaf_hi: [A, F] int32 rectangle bounds (hi exclusive); out:
    [A] leaf outputs; monotone: [F] -1/0/+1.  Leaf j bounds leaf i when
    their rectangles overlap along every feature but one monotone feature
    f, along which j lies on i's increasing side (an upper bound) or its
    decreasing side (a lower bound).  Returns (cmin [A], cmax [A]), and
    with `max_bin` B also the advanced mode's bounds (lL, uL, lR, uR)
    [A, F, B] of the left and right child of a split of leaf i on
    feature f at each threshold bin: a child's rectangle differs from
    i's only along f, so each neighbour's bound holds on a prefix or a
    suffix of thresholds, gathered by scatter-min/max at the interval's
    end and completed by a cumulative min/max along the bins."""
    A, F = leaf_lo.shape
    dev = leaf_lo.device
    f32, i32 = torch.float32, torch.int32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    ov = ((leaf_lo[:, None, :] < leaf_hi[None, :, :])
          & (leaf_lo[None, :, :] < leaf_hi[:, None, :]))        # [A, A, F]
    nov = (~ov).to(i32)
    n_false = nov.sum(2, dtype=i32)
    contig0 = (n_false[:, :, None] - nov) == 0   # overlap but along f
    below = leaf_hi[:, None, :] <= leaf_lo[None, :, :]          # i below j
    below_t = below.transpose(0, 1)
    inc = (monotone > 0)[None, None, :]
    dec = (monotone < 0)[None, None, :]
    other = ~torch.eye(A, dtype=torch.bool, device=dev)[:, :, None]
    valid = other & contig0
    outj = out.to(f32)[None, :, None].expand(A, A, F)
    upper = valid & ((below & inc) | (below_t & dec))
    lower = valid & ((below_t & inc) | (below & dec))
    cmax = torch.where(upper, outj, inf).amin(dim=(1, 2))
    cmin = torch.where(lower, outj, -inf).amax(dim=(1, 2))
    if max_bin is None:
        return cmin, cmax
    B = max_bin
    sA = (below & inc) | (below_t & dec)     # j bounds i above via f'
    sB = (below_t & inc) | (below & dec)     # ... below
    contig1 = (n_false[:, :, None] - nov) == 1
    qual_a = contig1 & ((sA.sum(2, dtype=i32)[:, :, None] - sA.to(i32)) >= 1)
    qual_b = contig1 & ((sB.sum(2, dtype=i32)[:, :, None] - sB.to(i32)) >= 1)
    lo_j, hi_j = leaf_lo[None, :, :], leaf_hi[None, :, :]
    ovf = leaf_lo[:, None, :] < hi_j          # the left child overlaps j
    ovf_r = lo_j < leaf_hi[:, None, :]        # the right child overlaps j
    base = ((torch.arange(A, device=dev)[:, None, None] * F
             + torch.arange(F, device=dev)[None, None, :]) * (B + 1))

    def scatter(gate, pos, fill, how):
        """[A, F, B] min (or max) of out_j at bin pos over the j with gate
        (the JAX `.at[i, f, pos].min`; pos B is a dump column)."""
        pos = pos.expand(A, A, F)
        p = torch.where(gate & (pos >= 0), pos.to(torch.int64), B)
        vals = torch.where(gate, outj, fill)
        res = torch.full((A * F * (B + 1),), float(fill), dtype=f32,
                         device=dev).scatter_reduce_(
            0, (base + p).reshape(-1), vals.reshape(-1), how)
        return res.view(A, F, B + 1)[:, :, :B]

    def smin(gate, pos):
        return scatter(gate, pos, inf, "amin")

    def smax(gate, pos):
        return scatter(gate, pos, -inf, "amax")

    def cummin_f(a):
        return torch.cummin(a, 2).values

    def cummax_f(a):
        return torch.cummax(a, 2).values

    def cummin_r(a):
        return torch.flip(torch.cummin(torch.flip(a, [2]), 2).values, [2])

    def cummax_r(a):
        return torch.flip(torch.cummax(torch.flip(a, [2]), 2).values, [2])

    def cst(gate):
        return torch.where(gate, outj, inf).amin(1)[:, :, None]

    def cst_max(gate):
        return torch.where(gate, outj, -inf).amax(1)[:, :, None]

    # upper bounds of the left child [lo_i, t + 1) along f: f' = f
    # increasing, t < lo_j (a suffix min); f' = f decreasing, j below i
    # (every t); f' != f, the child overlaps j along f: t >= lo_j (a
    # prefix min).  The right child [t + 1, hi_i) and the lower bounds
    # mirror them.
    uL = torch.minimum(cummin_r(smin(valid & inc, lo_j - 1)),
                       cst(valid & dec & below_t))
    uL = torch.minimum(uL, cummin_f(smin(other & qual_a & ovf, lo_j)))
    uR = torch.minimum(cst(valid & inc & below),
                       cummin_f(smin(valid & dec, hi_j - 1)))
    uR = torch.minimum(uR, cummin_r(smin(other & qual_a & ovf_r, hi_j - 2)))
    lL = torch.maximum(cummax_r(smax(valid & dec, lo_j - 1)),
                       cst_max(valid & inc & below_t))
    lL = torch.maximum(lL, cummax_f(smax(other & qual_b & ovf, lo_j)))
    lR = torch.maximum(cst_max(valid & dec & below),
                       cummax_f(smax(valid & inc, hi_j - 1)))
    lR = torch.maximum(lR, cummax_r(smax(other & qual_b & ovf_r, hi_j - 2)))
    return cmin, cmax, (lL, uL, lR, uR)


class ScanDraws:
    """The JAX engines' per-scan random draws (ref:
    feature_histogram.hpp:204 USE_RAND thresholds; col_sampler.hpp
    GetByNode subsets): for a scan tag, `rand_bins(tag)` gives `shape`
    thresholds, `rand_cat_u(tag)` the categorical draws [*shape, 2] and
    `bynode(tag)` `shape` exactly-k column masks, bit for bit the JAX
    package's `_rand_bins`, `_rand_cat_us` and `_bynode_mask(s)`; a 1-D
    tensor of tags gives [T, *shape] in one pass.  Each key is
    PRNGKey(seed), folded with `extra_tag` when the booster passes one.
    None for an option that is off."""

    def __init__(self, params: GrowParams, meta: FeatureMeta, shape,
                 extra_tag, device):
        self.shape = tuple(shape)
        self.num_bin = meta.num_bin
        sp = params.split

        def key_of(seed):
            key = jrandom.PRNGKey(seed, device=device)
            return key if extra_tag is None else jrandom.fold_in(
                key, int(extra_tag))
        self.extra_key = key_of(sp.extra_seed) if sp.extra_trees else None
        # the categorical USE_RAND draws: a stream of their own under the
        # extra-trees key (the JAX engines' `_rand_cat_us`)
        self.cat_key = (jrandom.fold_in(self.extra_key, 0x5EED)
                        if sp.extra_trees and sp.has_categorical else None)
        self.bynode_key = None
        if params.feature_fraction_bynode < 1.0:
            F = meta.num_bin.shape[0]
            self.bynode_key = key_of(params.bynode_seed)
            self.bynode_k = max(1, int(round(
                params.feature_fraction_bynode * F)))

    @property
    def active(self) -> bool:
        return self.extra_key is not None or self.bynode_key is not None

    def rand_bins(self, tags):
        """Random thresholds in [0, num_bin - 3] (2-bin features take 0)."""
        if self.extra_key is None:
            return None
        u = jrandom.uniform(jrandom.fold_in(self.extra_key, tags),
                            self.shape)
        nb = self.num_bin.to(torch.int32)
        span = torch.clamp(nb - 2, min=1).to(torch.float32)
        return torch.minimum(torch.clamp((u * span).to(torch.int32), min=0),
                             torch.clamp(nb - 3, min=0))

    def rand_cat_u(self, tags):
        """[*shape, 2] uniforms: the one-hot candidate bin and the
        sorted-subset prefix length of each categorical scan
        (feature_histogram.cpp:187,268)."""
        if self.cat_key is None:
            return None
        return jrandom.uniform(jrandom.fold_in(self.cat_key, tags),
                               self.shape + (2,))

    def bynode(self, tags):
        if self.bynode_key is None:
            return None
        u = jrandom.uniform(jrandom.fold_in(self.bynode_key, tags),
                            self.shape)
        return jrandom.topk_mask(u, self.bynode_k)


def grow_tree_impl(binned: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, row_mask: torch.Tensor,
                   col_mask: torch.Tensor, meta: FeatureMeta,
                   params: GrowParams, binned_rm: torch.Tensor = None,
                   extra_tag: int = None, cegb_used: torch.Tensor = None,
                   lazy_used: torch.Tensor = None, net=None,
                   grid_rows: int = None, block=None, voting=None):
    """Grow one leaf-wise tree.

    Args:
      binned: [F', n] feature-major bin codes (n a multiple of 512), uint8,
        16-bit (int16 storage) or int32 (ops/histogram.py code_dtype): one
        row per feature, or per bundle column under EFB.
      grad, hess, row_mask: [n] float32 (row_mask: bagging x padding).
      col_mask: [F] bool.  meta, params: as the wave engine's.
      binned_rm: optional [n, F'] row-major copy (made here when None).
      extra_tag: folds the extra-trees and bynode keys (the booster's
        absolute iteration x classes + class).
      cegb_used: [F] bool, the features earlier trees used (CEGB).
      lazy_used: [F, n] bool, the rows whose value of each feature earlier
        splits fetched (lazy CEGB; zeros when None); updated in place.
      net, grid_rows: a data-parallel rank's Network
        (parallel/data_parallel.py) and the row count the serial run
        pads to: the grid is the serial run's, and every K4 histogram,
        row count, root sum and lazy-CEGB count is all-reduced (the
        JAX package's GSPMD psums of the masked engine).  The partition
        stays shard-local.
      block: a feature-parallel rank's ColumnBlock: `binned_rm` holds
        its block's columns, every histogram is the block's and every
        scan merges the ranks' best splits (parallel/data_parallel.py).
      voting: a VotingSpec (parallel/voting.py) with `net`: every scan
        votes on its leaf's features and reduces only the elected
        histograms; needs use_hist_stack off and no EFB.

    Returns (TreeArrays with node arrays [max(L-1, 1)] and leaf arrays
    [L], leaf_id [n] int32), and lazy_used after them under lazy CEGB.
    """
    Fg, n = binned.shape
    F = meta.num_bin.shape[0]
    dev = binned.device
    L = params.num_leaves
    B = params.max_bin
    bundles = params.has_bundles
    hist_B = params.group_max_bin if bundles else B
    sp = params.split
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    # the columns this rank histograms (a feature-parallel rank's block)
    hmeta = meta if block is None else block.meta
    if binned_rm is None:
        binned_rm = (binned if block is None
                     else binned[block.start:block.stop]).t().contiguous()
    Fh = binned_rm.shape[1]
    if voting is not None and (params.use_hist_stack or bundles
                               or params.forced_splits):
        raise ValueError("the voting learner rebuilds every scanned "
                         "leaf's histogram: no histogram stack, EFB or "
                         "forced splits")
    forced = tuple(params.forced_splits)[:max(L - 1, 0)]
    KF = len(forced)

    row_mask = row_mask.to(f32)
    grad = grad.to(f32) * row_mask
    hess = hess.to(f32) * row_mask
    gh = torch.stack([grad, hess], dim=1).contiguous()
    # the tree's fixed-point grid (the serial run's under data-parallel)
    exps = scale_exps(gh, grid_rows, net)
    unit = fixed_unit(exps)
    ones = torch.ones(n, dtype=f32, device=dev)
    nb_h = meta.num_bin.cpu().numpy()
    mt_h = meta.missing_type.cpu().numpy()
    db_h = meta.default_bin.cpu().numpy()
    if bundles:
        grp_h = meta.group.cpu().numpy()
        off_h = meta.offset.cpu().numpy()
        zb_h = meta.zero_bin.cpu().numpy()
    W = cat_bitset_words(B)
    if sp.has_monotone:
        mono_h = meta.monotone.cpu().numpy()
        leaf_cmin = torch.full((L,), float("-inf"), dtype=f32, device=dev)
        leaf_cmax = torch.full((L,), float("inf"), dtype=f32, device=dev)
    use_inter = params.monotone_intermediate and sp.has_monotone
    use_adv = use_inter and params.monotone_advanced
    if use_inter and (not params.use_hist_stack or sp.extra_trees
                      or params.feature_fraction_bynode < 1.0):
        raise ValueError("the intermediate monotone mode needs the "
                         "histogram stack and fixed per-leaf scans (no "
                         "extra_trees or bynode sampling)")
    if use_inter:
        # leaf rectangles in bin space (the root covers every bin), and
        # the bounds of the last rescan
        leaf_lo = torch.zeros((L, F), dtype=i32, device=dev)
        leaf_hi = meta.num_bin.to(i32)[None, :].repeat(L, 1)
        inter_prev = []
    use_lazy = sp.has_cegb_lazy
    if use_lazy:
        if use_inter:
            raise ValueError("cegb_penalty_feature_lazy does not compose "
                             "with the intermediate monotone mode")
        if lazy_used is None:
            lazy_used = torch.zeros((F, n), dtype=torch.bool, device=dev)
    if sp.has_cegb:
        # features used so far (the booster's, then this tree's splits)
        used_h = (np.zeros(F, bool) if cegb_used is None
                  else cegb_used.cpu().numpy().astype(bool))
        used_dev = torch.from_numpy(used_h.copy()).to(dev)
    use_interaction = bool(params.interaction_sets)
    if use_interaction:
        set_masks = interaction_masks(params.interaction_sets, F, dev)
        leaf_branch = torch.zeros((L, F), dtype=torch.bool, device=dev)

    def account_rows(rows, values):
        if global_cost_model.enabled:
            S, Fh = rows.shape
            Ch = values.shape[1]
            global_cost_model.account(
                "grow_tree[histogram]", rows_hist_ops(S, Fh, Ch),
                rows_hist_bytes(S, Fh, hist_B, Ch, rows.element_size()))

    def all_reduce(t):
        return t if net is None else net.all_reduce_sum_(t)

    def hist_of_rows(rows, gh_sub, member_mask):
        """Group-space histogram of rows [S, F'] (int64, all-reduced; a
        feature-parallel rank's block columns)."""
        if Fh == 0:
            # a feature-parallel rank without columns
            return torch.zeros((0, hist_B, 2), dtype=i64, device=dev)
        account_rows(rows, gh_sub)
        with global_timer.device_scope("Tree::histogram", dev):
            h = build_histogram_rows_fixed(rows, gh_sub, member_mask,
                                           exps, max_bin=hist_B)
        return all_reduce(h)

    def hist_of(member_mask):
        """Group-space histogram of every row under a membership mask."""
        return hist_of_rows(binned_rm, gh, member_mask)

    def feature_hists(hists):
        """int64 group-space histograms -> float32 per-feature ones."""
        return from_fixed(bundle_hist_to_features(
            hists, None, None, hmeta, B, hist_B, bundles), unit)

    # every scan's draws at once: tag 0 is the root's; the children of
    # forced step k take 2k+1 and 2k+2, those of best-gain split i
    # 2(i+KF)+1 and 2(i+KF)+2 (the JAX engine's rand_tag)
    draws = ScanDraws(params, meta, (F,), extra_tag, dev)
    tags = torch.arange(2 * (L + KF) - 1, dtype=i64, device=dev)
    rand_all, bym_all = draws.rand_bins(tags), draws.bynode(tags)
    rcu_all = draws.rand_cat_u(tags)

    def best_of(hists, sum_g, sum_h, cnt, parent_out, tag0, cmin=None,
                cmax=None, depth=None, branch=None, lazy_masks=None,
                adv=None, member_masks=None) -> SplitResult:
        """Scan k leaves' int64 group-space histograms [k, F', B', 2]; the
        leaves' scan tags are tag0, tag0 + 1, ...; cmin/cmax/depth: the
        leaves' [k] monotone bounds and depths; branch: their [k, F]
        branch features (interaction constraints); lazy_masks: their
        [k, n] bagged-in rows (lazy CEGB); adv: the advanced mode's
        (lL, uL, lR, uR) [k, F, B] bounds.  Under voting `hists` is None
        and member_masks [k, n] holds the leaves' rows: each leaf's
        histogram is its vote's."""
        k = sum_g.shape[0]
        cm = (col_mask if bym_all is None
              else col_mask[None, :] & bym_all[tag0:tag0 + k])
        if use_interaction:
            cm = cm & allowed_features(branch, set_masks)
        if voting is not None:
            cms = cm if cm.dim() == 2 else cm[None, :].expand(k, -1)
            hists, elected = voting_hist_elect(
                binned_rm, gh, member_masks, cms, parent_out, meta, voting,
                sp, hist_B, exps, num_data=cnt)
            cm = cms & elected
        kw = {}
        if rand_all is not None:
            kw["rand_bin"] = rand_all[tag0:tag0 + k]
        if rcu_all is not None:
            kw["rand_cat_u"] = rcu_all[tag0:tag0 + k]
        if sp.has_categorical:
            kw["is_cat_feature"] = meta.is_cat
        if sp.has_monotone:
            kw.update(monotone=meta.monotone, constraint_min=cmin,
                      constraint_max=cmax,
                      mono_penalty=monotone_gain_penalty(
                          depth, sp.monotone_penalty))
        if adv is not None:
            kw.update(constraint_min_left=adv[0], constraint_max_left=adv[1],
                      constraint_min_right=adv[2],
                      constraint_max_right=adv[3])
        if sp.has_cegb:
            kw.update(cegb_coupled=meta.cegb_coupled, cegb_used=used_dev)
        if use_lazy:
            # each feature's lazy penalty times the leaf's rows not yet
            # fetched for it: 0/1 counts below 2^24, exact in float32
            # whatever the order of the sums
            unused = ((~lazy_used).to(f32) @ lazy_masks.t()).t()     # [k, F]
            if net is not None:
                unused = all_reduce(unused.to(i64)).to(f32)
            kw["cegb_lazy_cost"] = meta.cegb_lazy[None, :] * unused
        with global_timer.device_scope("Tree::split_find", dev):
            if block is not None:
                return block.best_split(feature_hists(hists), cm, sum_g,
                                        sum_h, cnt, parent_out, sp, **kw)
            return find_best_split(
                feature_hists(hists), meta.num_bin, meta.missing_type,
                meta.default_bin, meta.penalty, cm, sum_g, sum_h, cnt,
                parent_out, sp, **kw)

    def go_left_of(codes, feat, dleft, thr, isc, bitset):
        """ref: dense_bin.hpp:346-366 SplitInner, in bin space; a
        categorical split sends the bins of its bitset left (tree.h:372
        CategoricalDecision; bin 0, NaN/other, is never in it).  Under EFB
        `codes` are the bundle column's: a code outside the feature's
        range means its default bin."""
        fbins = codes
        if bundles and off_h[feat] > 0:
            local = codes - int(off_h[feat])
            fbins = torch.where((local >= 0) & (local < int(nb_h[feat])),
                                local, int(zb_h[feat]))
        if isc:
            word = bitset[torch.clamp(fbins // 32, max=W - 1).to(i64)]
            return ((word >> (fbins % 32)) & 1) > 0
        mt = int(mt_h[feat])
        if mt == MISSING_NAN:
            missing = fbins == int(nb_h[feat]) - 1
        elif mt == MISSING_ZERO:
            missing = fbins == int(db_h[feat])
        else:
            return fbins <= thr
        return torch.where(missing, bool(dleft), fbins <= thr)

    def col_of(feat):
        return int(grp_h[feat]) if bundles else feat

    # ---- root (ref: serial_tree_learner BeforeTrain) ----
    # leaf totals: exact limb sums, the same bits on CPU and CUDA and
    # however the rows are sharded
    sum_g0 = exact_sum(grad, net=net)[0].to(f32)
    sum_h0 = exact_sum(hess, net=net)[0].to(f32)
    cnt0 = all_reduce(row_mask.sum(dtype=i64)).to(i32)
    # (the voting learner's root histogram is its vote's, never reduced
    # whole)
    root_hist = None if voting is not None else hist_of(ones)
    inf1 = torch.full((1,), float("inf"), dtype=f32, device=dev)
    root_best = best_of(None if root_hist is None else root_hist[None],
                        sum_g0[None], sum_h0[None],
                        cnt0[None], torch.zeros(1, dtype=f32, device=dev), 0,
                        -inf1, inf1, torch.zeros(1, dtype=i32, device=dev),
                        branch=(leaf_branch[:1] if use_interaction
                                else None),
                        lazy_masks=row_mask[None] if use_lazy else None,
                        member_masks=row_mask[None])

    ni = max(L - 1, 1)
    # host-side structure (decided by host ints); float fields on device
    split_feature = np.zeros(ni, np.int32)
    threshold_bin = np.zeros(ni, np.int32)
    default_left = np.zeros(ni, bool)
    left_child = np.zeros(ni, np.int32)
    right_child = np.zeros(ni, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_depth = np.zeros(L, np.int32)
    split_is_cat = np.zeros(ni, bool)
    cat_bitset = torch.zeros((ni, W), dtype=i32, device=dev)
    node_f = {k: torch.zeros(ni, dtype=dt, device=dev) for k, dt in (
        ("split_gain", f32), ("internal_value", f32),
        ("internal_weight", f32), ("internal_count", i32))}
    leaf_f = {k: torch.zeros(L, dtype=dt, device=dev) for k, dt in (
        ("leaf_value", f32), ("leaf_weight", f32), ("leaf_count", i32))}
    leaf_f["leaf_weight"][0] = sum_h0
    leaf_f["leaf_count"][0] = cnt0
    depth_dev = torch.zeros(L, dtype=i32, device=dev)
    # the leaves' gradient and hessian sums, kept up to date only when
    # forced splits are given (their gather reads them) or the
    # intermediate mode rescans every leaf
    leaf_sum_g = torch.zeros(L, dtype=f32, device=dev)
    leaf_sum_h = torch.zeros(L, dtype=f32, device=dev)
    leaf_sum_g[0], leaf_sum_h[0] = sum_g0, sum_h0

    # best pending split per leaf (ref: best_split_per_leaf_)
    pend = {k: torch.zeros((L,) + v.shape[1:], dtype=v.dtype, device=dev)
            for k, v in root_best._asdict().items()}
    pend["gain"].fill_(K_MIN_SCORE)
    idx0 = torch.zeros(1, dtype=i64, device=dev)
    for k, v in root_best._asdict().items():
        pend[k].index_copy_(0, idx0, v)

    use_stack = params.use_hist_stack
    if use_stack:
        hist_stack = torch.zeros((L, Fh, hist_B, 2), dtype=i64, device=dev)
        hist_stack[0] = root_hist
    use_partition = 0 < params.compact_min < n and L > 2
    leaf_id = torch.zeros(n + 1, dtype=i64, device=dev)   # [n] is a dump
    if use_partition:
        order = torch.arange(n, dtype=i64, device=dev)
        leaf_start = torch.zeros(L, dtype=i64, device=dev)
        leaf_seg = torch.zeros(L, dtype=i64, device=dev)
        leaf_seg[0] = n

    def partition_and_hist(best, new, feat, thr, dleft, isc, bitset, start,
                           seg):
        """Partitioned engine (ref: DataPartition::Split + the
        partitioned histogram scan, dense_bin.hpp:99)."""
        S = (seg + ROW_TILE - 1) // ROW_TILE * ROW_TILE
        with global_timer.device_scope("Tree::partition", dev):
            idxs = order[start:start + seg].clone()   # order is rewritten
            if S > seg:
                idxs = torch.cat([idxs, idxs.new_zeros(S - seg)])
            valid = torch.arange(S, device=dev) < seg
            gl = go_left_of(codes_to_int(binned[col_of(feat)][idxs], i32),
                            feat, dleft, thr, isc, bitset)
            lm = gl & valid
            rm = ~gl & valid
            rmask = row_mask[idxs]
            c = all_reduce(torch.stack([(lm * rmask).sum(dtype=i64),
                                        (rm * rmask).sum(dtype=i64)]))
            cnt_l, cnt_r = c.to(i32)
            smaller_is_left = cnt_l <= cnt_r
            # stable in-place partition of the segment: left rows first
            cl_seg = lm.sum(dtype=i64)
            pos = torch.where(
                lm, torch.cumsum(lm, 0, dtype=i64) - 1,
                torch.where(rm, cl_seg + torch.cumsum(rm, 0, dtype=i64) - 1,
                            torch.full_like(idxs, S)))
            buf = idxs.new_zeros(S + 1).index_copy_(0, pos, idxs)
            order[start:start + seg] = buf[:seg]
            leaf_id.index_fill_(0, torch.where(rm, idxs, n), new)
            leaf_start[new] = start + cl_seg
            leaf_seg[best] = cl_seg
            leaf_seg[new] = seg - cl_seg
        small_hist = None
        if use_stack:
            small_m = torch.where(smaller_is_left, lm, rm).to(f32)
            small_hist = hist_of_rows(binned_rm[idxs], gh[idxs], small_m)
        return small_hist, cnt_l, cnt_r, smaller_is_left

    def mask_and_hist(best, new, feat, thr, dleft, isc, bitset):
        """Masked engine: recolor by scanning all rows."""
        with global_timer.device_scope("Tree::partition", dev):
            gl = go_left_of(codes_to_int(binned[col_of(feat)], i32), feat,
                            dleft, thr, isc, bitset)
            in_leaf = leaf_id[:n] == best
            leaf_id[:n] = torch.where(in_leaf & ~gl, new, leaf_id[:n])
            lmaskf = (in_leaf & gl).to(f32) * row_mask
            rmaskf = (in_leaf & ~gl).to(f32) * row_mask
            c = all_reduce(torch.stack([lmaskf.sum(dtype=i64),
                                        rmaskf.sum(dtype=i64)]))
            cnt_l, cnt_r = c.to(i32)
            smaller_is_left = cnt_l <= cnt_r
        small_hist = None
        if use_stack:
            small_hist = hist_of(torch.where(smaller_is_left, lmaskf,
                                             rmaskf))
        return small_hist, cnt_l, cnt_r, smaller_is_left

    state = {"num_leaves": 1}

    def step(tag_base: int, forced_leaf: int = None) -> bool:
        """One split: of the leaf of largest pending gain, or of
        `forced_leaf` whatever its rank (a forced split, which still
        keeps max_depth, the leaf budget and non-empty children).
        Returns whether it split."""
        NL = state["num_leaves"]
        if NL >= L:
            return False
        # leaf selection (ref: serial_tree_learner.cpp:219 ArgMax over
        # leaves); max_depth gates the children's depth
        sel = pend["gain"]
        if params.max_depth > 0:
            sel = torch.where(depth_dev < params.max_depth, sel,
                              torch.full_like(sel, K_MIN_SCORE))
        if forced_leaf is None:
            bl = torch.argmax(sel)
            ok = sel[bl] > 0.0
        else:
            bl = torch.tensor(forced_leaf, dtype=i64, device=dev)
            ok = sel[bl] > K_MIN_SCORE
        head = [bl, ok.to(i64), pend["feature"][bl].to(i64),
                pend["threshold"][bl].to(i64),
                pend["default_left"][bl].to(i64),
                pend["is_cat"][bl].to(i64)]
        if use_partition:
            head += [leaf_start[bl], leaf_seg[bl]]
        head = torch.stack(head).tolist()                 # the host read
        best, proceed, feat, thr, dleft, isc = head[:6]
        if not proceed:
            return False
        node, new = NL - 1, NL
        bitset = pend["cat_bitset"][best].clone() if isc else None
        if use_partition:
            small_hist, cnt_l, cnt_r, sil = partition_and_hist(
                best, new, feat, thr, dleft, isc, bitset, head[6], head[7])
        else:
            small_hist, cnt_l, cnt_r, sil = mask_and_hist(
                best, new, feat, thr, dleft, isc, bitset)

        # tree arrays (ref: tree.cpp Tree::Split)
        parent = leaf_parent[best]
        if parent >= 0:
            if left_child[parent] == ~best:
                left_child[parent] = node
            else:
                right_child[parent] = node
        depth = leaf_depth[best] + 1
        split_feature[node], threshold_bin[node] = feat, thr
        default_left[node] = bool(dleft)
        if isc:
            split_is_cat[node] = True
            cat_bitset[node] = bitset
        left_child[node], right_child[node] = ~best, ~new
        leaf_parent[best] = leaf_parent[new] = node
        leaf_depth[best] = leaf_depth[new] = depth
        depth_dev[best] = depth
        depth_dev[new] = depth
        pb = {k: v[best] for k, v in pend.items()}
        node_f["split_gain"][node] = pb["gain"]
        node_f["internal_value"][node] = leaf_f["leaf_value"][best]
        node_f["internal_weight"][node] = (pb["left_sum_hessian"]
                                           + pb["right_sum_hessian"])
        node_f["internal_count"][node] = cnt_l + cnt_r
        for k, lv, rv in (("leaf_value", "left_output", "right_output"),
                          ("leaf_weight", "left_sum_hessian",
                           "right_sum_hessian")):
            leaf_f[k][best] = pb[lv]
            leaf_f[k][new] = pb[rv]
        leaf_f["leaf_count"][best] = cnt_l
        leaf_f["leaf_count"][new] = cnt_r
        if forced or use_inter:
            leaf_sum_g[best], leaf_sum_g[new] = (pb["left_sum_gradient"],
                                                 pb["right_sum_gradient"])
            leaf_sum_h[best], leaf_sum_h[new] = (pb["left_sum_hessian"],
                                                 pb["right_sum_hessian"])

        # child histograms: the smaller fresh, the larger by exact
        # subtraction (ref: serial_tree_learner.cpp histogram subtraction)
        if use_stack:
            large_hist = hist_stack[best] - small_hist
            hist_l = torch.where(sil, small_hist, large_hist)
            hist_r = torch.where(sil, large_hist, small_hist)
            hist_stack[best] = hist_l
            hist_stack[new] = hist_r
        else:
            lid = leaf_id[:n]
            masks = torch.stack([(lid == best).to(f32) * row_mask,
                                 (lid == new).to(f32) * row_mask])
            hist_l = hist_r = None
            if voting is None:
                hist_l, hist_r = hist_of(masks[0]), hist_of(masks[1])
        # basic monotone propagation (monotone_constraints.hpp:489
        # BasicLeafConstraints::Update): the new leaf clones the parent's
        # bounds; a numerical split on a monotone feature bounds both
        # children at the midpoint of their outputs
        kw = {}
        if sp.has_monotone and not use_inter:
            p_min, p_max = leaf_cmin[best].clone(), leaf_cmax[best].clone()
            l_min, l_max, r_min, r_max = p_min, p_max, p_min, p_max
            mc = int(mono_h[feat])
            if mc != 0 and not isc:
                mid = (pb["left_output"] + pb["right_output"]) / 2.0
                if mc > 0:
                    l_max = torch.minimum(p_max, mid)
                    r_min = torch.maximum(p_min, mid)
                else:
                    l_min = torch.maximum(p_min, mid)
                    r_max = torch.minimum(p_max, mid)
            leaf_cmin[best], leaf_cmin[new] = l_min, r_min
            leaf_cmax[best], leaf_cmax[new] = l_max, r_max
            kw = dict(cmin=torch.stack([l_min, r_min]),
                      cmax=torch.stack([l_max, r_max]),
                      depth=depth_dev[[best, new]])
        newly_used = sp.has_cegb and not used_h[feat]
        if newly_used:
            # the coupled penalty is paid once: other leaves' pending
            # splits on this feature get it back
            used_h[feat] = True
            used_dev[feat] = True
            refund = sp.cegb_tradeoff * meta.cegb_coupled[feat]
            pend["gain"] = pend["gain"] + torch.where(
                (pend["feature"] == feat) & (pend["gain"] > K_MIN_SCORE),
                refund, torch.zeros((), dtype=f32, device=dev))
        if use_interaction:
            # the children's branch adds the split feature (ref:
            # col_sampler.hpp per-branch used features)
            child = leaf_branch[best].clone()
            child[feat] = True
            leaf_branch[best] = child
            leaf_branch[new] = child
            kw["branch"] = torch.stack([child, child])
        if use_lazy:
            # the split leaf's bagged-in rows are fetched for its feature
            # before the children's scans (ref: cost_effective_gradient_
            # boosting.hpp:125-135 UpdateLeafBestSplits)
            lid = leaf_id[:n]
            kw["lazy_masks"] = torch.stack([(lid == best).to(f32) * row_mask,
                                            (lid == new).to(f32) * row_mask])
            lazy_used[feat] |= kw["lazy_masks"].sum(0) > 0
        state["num_leaves"] = NL + 1
        if use_inter:
            # the children split the parent's rectangle at the threshold
            # (a categorical split narrows nothing); then every alive
            # leaf's bounds are recomputed, and its pending split with
            # them (the JAX engine rescans every leaf; a leaf whose scan
            # inputs did not change gives the same split, so only the
            # children and the leaves whose bounds moved are rescanned,
            # or every leaf when CEGB's used features changed)
            leaf_lo[new] = leaf_lo[best]
            leaf_hi[new] = leaf_hi[best]
            if not isc:
                leaf_lo[new, feat] = thr + 1
                leaf_hi[best, feat] = thr + 1
            A = NL + 1
            with global_timer.device_scope("Tree::monotone_rescan", dev):
                bounds = monotone_bounds(leaf_lo[:A], leaf_hi[:A],
                                         leaf_f["leaf_value"][:A],
                                         meta.monotone,
                                         B if use_adv else None)
                cur = (bounds[0], bounds[1], *(bounds[2] if use_adv
                                               else ()))
                moved = torch.zeros(A, dtype=torch.bool, device=dev)
                if newly_used or not inter_prev:
                    moved.fill_(True)
                else:
                    for c, p in zip(cur, inter_prev):
                        moved[:A - 1] |= (c[:A - 1] != p).reshape(
                            A - 1, -1).any(1)
                    moved[best] = moved[new] = True
                inter_prev[:] = cur
                idx = moved.nonzero()[:, 0]
                res = best_of(
                    hist_stack[idx], leaf_sum_g[idx], leaf_sum_h[idx],
                    leaf_f["leaf_count"][idx], leaf_f["leaf_value"][idx], 0,
                    cmin=bounds[0][idx], cmax=bounds[1][idx],
                    depth=depth_dev[idx],
                    branch=leaf_branch[idx] if use_interaction else None,
                    adv=(tuple(b[idx] for b in bounds[2]) if use_adv
                         else None))
            for k, v in res._asdict().items():
                pend[k].index_copy_(0, idx, v)
            return True
        if voting is not None:
            kw["member_masks"] = masks
        res = best_of(
            None if hist_l is None else torch.stack([hist_l, hist_r]),
            torch.stack([pb["left_sum_gradient"], pb["right_sum_gradient"]]),
            torch.stack([pb["left_sum_hessian"], pb["right_sum_hessian"]]),
            torch.stack([cnt_l, cnt_r]),
            torch.stack([pb["left_output"], pb["right_output"]]),
            2 * tag_base + 1, **kw)
        idx = torch.tensor([best, new], dtype=i64, device=dev)
        for k, v in res._asdict().items():
            pend[k].index_copy_(0, idx, v)
        return True

    # forced prologue (ref: serial_tree_learner.cpp:614 ForceSplits): one
    # forced split per step in the parse-time BFS numbering, gathered from
    # the leaf's histogram; the first that cannot apply ends the forcing
    # (its leaf numbers would be stale), and a skipped step leaves the
    # pending splits as they were
    for k, (fleaf, ffeat, fthr) in enumerate(forced):
        saved = {key: v.clone() for key, v in pend.items()}

        def gather(f, m):
            return gather_forced_split(
                feature_hists(hist_stack[fleaf][None])[0], f, fthr,
                leaf_sum_g[fleaf], leaf_sum_h[fleaf],
                leaf_f["leaf_count"][fleaf].to(f32), m, B, sp)
        if block is None:
            res = gather(ffeat, meta)
        else:
            # feature-parallel: the rank that holds the feature gathers it
            li = block.local_index(ffeat)
            res = block.merge_one(None if li is None else gather(li, hmeta),
                                  ffeat, W, dev)
        fidx = torch.tensor([fleaf], dtype=i64, device=dev)
        for key, v in res._asdict().items():
            pend[key].index_copy_(0, fidx, v[None])
        if not step(k, forced_leaf=fleaf):
            pend = saved
            break
    for i in range(L - 1):
        if not step(i + KF):
            break

    def dev_of(a):
        return torch.from_numpy(a).to(dev)

    tree = TreeArrays(
        num_leaves=state["num_leaves"],
        split_feature=dev_of(split_feature),
        threshold_bin=dev_of(threshold_bin),
        default_left=dev_of(default_left),
        left_child=dev_of(left_child), right_child=dev_of(right_child),
        leaf_parent=dev_of(leaf_parent), leaf_depth=dev_of(leaf_depth),
        split_is_cat=dev_of(split_is_cat), cat_bitset=cat_bitset,
        **node_f, **leaf_f)
    if use_lazy:
        return tree, leaf_id[:n].to(i32), lazy_used
    return tree, leaf_id[:n].to(i32)
