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
are made at once.  Voting, monotone, CEGB, forced splits and interaction
constraints are not ported (GBDT.init refuses them).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.histogram import (ROW_TILE, build_histogram_rows_fixed,
                             fixed_unit, from_fixed, scale_exps)
from ..ops.split import (K_MIN_SCORE, MISSING_NAN, MISSING_ZERO,
                         SplitParams, SplitResult, find_best_split)
from ..utils import random as jrandom
from ..utils.timer import global_timer


class FeatureMeta(NamedTuple):
    """Per-feature bin metadata on the device (ref: FeatureMetainfo,
    feature_histogram.hpp:40)."""
    num_bin: torch.Tensor        # [F] int32
    missing_type: torch.Tensor   # [F] int32
    default_bin: torch.Tensor    # [F] int32
    penalty: torch.Tensor        # [F] float32 (feature_contri)


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


def bundle_hist_to_features(hist_g, sum_g, sum_h, meta: FeatureMeta,
                            B: int, hist_B: int, has_bundles: bool):
    """Group-space histogram -> per-feature histogram.  Without bundles
    (the only case this slice of the port builds; EFB comes later) the
    histogram is already per feature."""
    if has_bundles:
        raise NotImplementedError(
            "EFB bundles are not ported yet (ROADMAP Queue 1 item 5)")
    return hist_g


class ScanDraws:
    """The JAX engines' per-scan random draws (ref:
    feature_histogram.hpp:204 USE_RAND thresholds; col_sampler.hpp
    GetByNode subsets): for a scan tag, `rand_bins(tag)` gives `shape`
    thresholds and `bynode(tag)` `shape` exactly-k column masks, bit for
    bit the JAX package's `_rand_bins` and `_bynode_mask(s)`; a 1-D
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
                   extra_tag: int = None):
    """Grow one leaf-wise tree.

    Args:
      binned: [F, n] uint8 feature-major bin codes (n a multiple of 512).
      grad, hess, row_mask: [n] float32 (row_mask: bagging x padding).
      col_mask: [F] bool.  meta, params: as the wave engine's.
      binned_rm: optional [n, F] row-major copy (made here when None).
      extra_tag: folds the extra-trees and bynode keys (the booster's
        absolute iteration x classes + class).

    Returns (TreeArrays with node arrays [max(L-1, 1)] and leaf arrays
    [L], leaf_id [n] int32).
    """
    F, n = binned.shape
    dev = binned.device
    L = params.num_leaves
    B = params.max_bin
    sp = params.split
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    if binned_rm is None:
        binned_rm = binned.t().contiguous()

    row_mask = row_mask.to(f32)
    grad = grad.to(f32) * row_mask
    hess = hess.to(f32) * row_mask
    gh = torch.stack([grad, hess], dim=1).contiguous()
    exps = scale_exps(gh)                     # the tree's fixed-point grid
    unit = fixed_unit(exps)
    ones = torch.ones(n, dtype=f32, device=dev)
    nb_h = meta.num_bin.cpu().numpy()
    mt_h = meta.missing_type.cpu().numpy()
    db_h = meta.default_bin.cpu().numpy()

    def hist_of(member_mask):
        """Histogram of every row under a membership mask (int64)."""
        with global_timer.device_scope("Tree::histogram", dev):
            return build_histogram_rows_fixed(binned_rm, gh, member_mask,
                                              exps, max_bin=B)

    def hist_of_rows(rows, gh_sub, member_mask):
        """Histogram of gathered rows [S, F] (int64)."""
        with global_timer.device_scope("Tree::histogram", dev):
            return build_histogram_rows_fixed(rows, gh_sub, member_mask,
                                              exps, max_bin=B)

    # every scan's draws at once: tag 0 is the root's, 2i+1 and 2i+2 the
    # children's of split i (the JAX engine's rand_tag)
    draws = ScanDraws(params, meta, (F,), extra_tag, dev)
    tags = torch.arange(2 * L - 1, dtype=i64, device=dev)
    rand_all, bym_all = draws.rand_bins(tags), draws.bynode(tags)

    def best_of(hists, sum_g, sum_h, cnt, parent_out, tag0) -> SplitResult:
        """Scan k leaves' int64 histograms [k, F, B, 2]; the leaves' scan
        tags are tag0, tag0 + 1, ..."""
        k = hists.shape[0]
        cm = (col_mask if bym_all is None
              else col_mask[None, :] & bym_all[tag0:tag0 + k])
        rb = None if rand_all is None else rand_all[tag0:tag0 + k]
        with global_timer.device_scope("Tree::split_find", dev):
            return find_best_split(
                from_fixed(hists, unit), meta.num_bin, meta.missing_type,
                meta.default_bin, meta.penalty, cm, sum_g, sum_h, cnt,
                parent_out, sp, rand_bin=rb)

    def go_left_of(fbins, feat, dleft, thr):
        """ref: dense_bin.hpp:346-366 SplitInner, in bin space."""
        mt = int(mt_h[feat])
        if mt == MISSING_NAN:
            missing = fbins == int(nb_h[feat]) - 1
        elif mt == MISSING_ZERO:
            missing = fbins == int(db_h[feat])
        else:
            return fbins <= thr
        return torch.where(missing, bool(dleft), fbins <= thr)

    # ---- root (ref: serial_tree_learner BeforeTrain) ----
    # leaf totals summed in float64 so CPU and CUDA agree
    sum_g0 = grad.sum(dtype=torch.float64).to(f32)
    sum_h0 = hess.sum(dtype=torch.float64).to(f32)
    cnt0 = row_mask.sum(dtype=torch.float64).to(i32)
    root_hist = hist_of(ones)
    root_best = best_of(root_hist[None], sum_g0[None], sum_h0[None],
                        cnt0[None], torch.zeros(1, dtype=f32, device=dev), 0)

    ni = max(L - 1, 1)
    # host-side structure (decided by host ints); float fields on device
    split_feature = np.zeros(ni, np.int32)
    threshold_bin = np.zeros(ni, np.int32)
    default_left = np.zeros(ni, bool)
    left_child = np.zeros(ni, np.int32)
    right_child = np.zeros(ni, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_depth = np.zeros(L, np.int32)
    node_f = {k: torch.zeros(ni, dtype=dt, device=dev) for k, dt in (
        ("split_gain", f32), ("internal_value", f32),
        ("internal_weight", f32), ("internal_count", i32))}
    leaf_f = {k: torch.zeros(L, dtype=dt, device=dev) for k, dt in (
        ("leaf_value", f32), ("leaf_weight", f32), ("leaf_count", i32))}
    leaf_f["leaf_weight"][0] = sum_h0
    leaf_f["leaf_count"][0] = cnt0
    depth_dev = torch.zeros(L, dtype=i32, device=dev)

    # best pending split per leaf (ref: best_split_per_leaf_)
    pend = {k: torch.zeros(L, dtype=v.dtype, device=dev)
            for k, v in root_best._asdict().items()}
    pend["gain"].fill_(K_MIN_SCORE)
    idx0 = torch.zeros(1, dtype=i64, device=dev)
    for k, v in root_best._asdict().items():
        pend[k].index_copy_(0, idx0, v)

    use_stack = params.use_hist_stack
    if use_stack:
        hist_stack = torch.zeros((L, F, B, 2), dtype=i64, device=dev)
        hist_stack[0] = root_hist
    use_partition = 0 < params.compact_min < n and L > 2
    leaf_id = torch.zeros(n + 1, dtype=i64, device=dev)   # [n] is a dump
    if use_partition:
        order = torch.arange(n, dtype=i64, device=dev)
        leaf_start = torch.zeros(L, dtype=i64, device=dev)
        leaf_seg = torch.zeros(L, dtype=i64, device=dev)
        leaf_seg[0] = n

    def partition_and_hist(best, new, feat, thr, dleft, start, seg):
        """Partitioned engine (ref: DataPartition::Split + the
        partitioned histogram scan, dense_bin.hpp:99)."""
        S = (seg + ROW_TILE - 1) // ROW_TILE * ROW_TILE
        with global_timer.device_scope("Tree::partition", dev):
            idxs = order[start:start + seg].clone()   # order is rewritten
            if S > seg:
                idxs = torch.cat([idxs, idxs.new_zeros(S - seg)])
            valid = torch.arange(S, device=dev) < seg
            rows = binned_rm[idxs]                            # [S, F]
            gl = go_left_of(rows[:, feat].to(i32), feat, dleft, thr)
            lm = gl & valid
            rm = ~gl & valid
            rmask = row_mask[idxs]
            cnt_l = (lm * rmask).sum(dtype=torch.float64).to(i32)
            cnt_r = (rm * rmask).sum(dtype=torch.float64).to(i32)
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
            small_hist = hist_of_rows(rows, gh[idxs], small_m)
        return small_hist, cnt_l, cnt_r, smaller_is_left

    def mask_and_hist(best, new, feat, thr, dleft):
        """Masked engine: recolor by scanning all rows."""
        with global_timer.device_scope("Tree::partition", dev):
            gl = go_left_of(binned[feat].to(i32), feat, dleft, thr)
            in_leaf = leaf_id[:n] == best
            leaf_id[:n] = torch.where(in_leaf & ~gl, new, leaf_id[:n])
            lmaskf = (in_leaf & gl).to(f32) * row_mask
            rmaskf = (in_leaf & ~gl).to(f32) * row_mask
            cnt_l = lmaskf.sum(dtype=torch.float64).to(i32)
            cnt_r = rmaskf.sum(dtype=torch.float64).to(i32)
            smaller_is_left = cnt_l <= cnt_r
        small_hist = None
        if use_stack:
            small_hist = hist_of(torch.where(smaller_is_left, lmaskf,
                                             rmaskf))
        return small_hist, cnt_l, cnt_r, smaller_is_left

    num_leaves = 1
    for i in range(L - 1):
        # leaf selection (ref: serial_tree_learner.cpp:219 ArgMax over
        # leaves); max_depth gates the children's depth
        sel = pend["gain"]
        if params.max_depth > 0:
            sel = torch.where(depth_dev < params.max_depth, sel,
                              torch.full_like(sel, K_MIN_SCORE))
        bl = torch.argmax(sel)
        head = [bl, (sel[bl] > 0.0).to(i64), pend["feature"][bl].to(i64),
                pend["threshold"][bl].to(i64),
                pend["default_left"][bl].to(i64)]
        if use_partition:
            head += [leaf_start[bl], leaf_seg[bl]]
        head = torch.stack(head).tolist()                 # the host read
        best, proceed, feat, thr, dleft = head[:5]
        if not proceed:
            break
        node, new = i, i + 1
        if use_partition:
            small_hist, cnt_l, cnt_r, sil = partition_and_hist(
                best, new, feat, thr, dleft, head[5], head[6])
        else:
            small_hist, cnt_l, cnt_r, sil = mask_and_hist(
                best, new, feat, thr, dleft)

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
            hist_l = hist_of((lid == best).to(f32) * row_mask)
            hist_r = hist_of((lid == new).to(f32) * row_mask)
        res = best_of(
            torch.stack([hist_l, hist_r]),
            torch.stack([pb["left_sum_gradient"], pb["right_sum_gradient"]]),
            torch.stack([pb["left_sum_hessian"], pb["right_sum_hessian"]]),
            torch.stack([cnt_l, cnt_r]),
            torch.stack([pb["left_output"], pb["right_output"]]), 2 * i + 1)
        idx = torch.tensor([best, new], dtype=i64, device=dev)
        for k, v in res._asdict().items():
            pend[k].index_copy_(0, idx, v)
        num_leaves += 1

    def dev_of(a):
        return torch.from_numpy(a).to(dev)

    tree = TreeArrays(
        num_leaves=num_leaves,
        split_feature=dev_of(split_feature),
        threshold_bin=dev_of(threshold_bin),
        default_left=dev_of(default_left),
        left_child=dev_of(left_child), right_child=dev_of(right_child),
        leaf_parent=dev_of(leaf_parent), leaf_depth=dev_of(leaf_depth),
        **node_f, **leaf_f)
    return tree, leaf_id[:n].to(i32)
