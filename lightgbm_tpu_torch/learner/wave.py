"""Wave (level-batched best-first) tree growth (PyTorch port of
`lightgbm_tpu/learner/wave.py`).

Each wave splits every positive-gain leaf within the leaf budget
(best-gain-first, like the reference's leaf order), so a tree takes about
log2(num_leaves) waves of vectorized work:

  1. one multi-leaf histogram pass over all rows for the smaller child of
     every split of the previous wave (ops/histogram.py: the K1 kernel, or
     the few-slot K3 kernel when `wave_hl_profitable` marks the wave, or
     the quantized K2 kernel under `use_quantized_grad`); the larger
     sibling is parent - smaller (ref: serial_tree_learner.cpp:334,
     feature_histogram.hpp Subtract).  The cache holds the kernels'
     integer sums (64-bit fixed point on one grid per tree, or K2's
     quantized integers), so the subtraction is exact and a bin empty in
     the larger child is exactly 0; the scan converts to float32;
  2. one gain scan over every leaf (ops/split.py, ref:
     feature_histogram.hpp:192 FindBestThreshold, batched over leaves), or
     only over the leaves the previous wave created when that bound is
     small (the incremental rescan).  Extra-trees thresholds (and their
     categorical draws) and bynode column subsets are drawn once per
     wave as [Lp, F] under the tag num_leaves (the JAX engine's
     `_rand_bins`/`_rand_cat_us`/`_bynode_masks`), row l for leaf l; a
     fresh draw changes every leaf's scan, so these modes always scan
     every leaf, as the JAX engine does;
  3. one recolor pass: each row looks up its leaf's split in a packed
     per-leaf table (ref: dense_bin.hpp:346 SplitInner on all splitting
     leaves at once), which also assigns the next wave's computed slots.
     With categorical features the table carries each split's is_cat
     flag and bitset words (a torch gather: no 16-bit split of the words
     as the JAX engine's bf16 matmul needs).

Basic monotone constraints keep each leaf's [cmin, cmax] and update
them per wave (both children of a monotone numerical split bounded at
the midpoint of their outputs); CEGB marks every feature a wave split on
as used after the wave, so leaves of one wave that split on a new
feature each pay its coupled penalty (the JAX engine's wave-batching
deviation from the reference's per-split accounting, kept here).  Both
rescan every leaf each wave, since their scan inputs change globally.

The JAX engine unrolls the waves inside one jit under `lax.cond`; here
they run as a host loop of torch ops with one host sync per wave (the
wave's split count).  Per-slot arrays keep one extra "dump" row (index
`Lp`, or `ni` for node arrays) that absorbs the writes the JAX engine
drops with `mode="drop"`.

EFB: with bundles `binned` holds [F', n] bundle codes; the kernels build
group-space histograms ([F', group_max_bin]), the cache holds and
subtracts them, and the scan converts them to per-feature histograms
(`bundle_hist_to_features`, exact on the integer sums); the recolor
decodes each row's split feature from (bundle column, code offset,
default bin) columns of its table.  Interaction constraints narrow
every leaf's column mask to what its branch allows, so those waves scan
every leaf.  Forced splits run as a prologue of one-split waves
(`forced_split`), each gathered from the leaf's cached histogram; the
ladder's slot bounds then start from KF + 1 leaves.

Overgrow-and-prune (`wave_prune`, the default; off under monotone
constraints, CEGB and forced splits, whose gains depend on the order of
the splits or which the replay could drop):
the ladder grows to
Lg = ceil(1.5 L) leaves, then `_prune_to_leafwise` replays the reference's
strict leaf-wise pop order (serial_tree_learner.cpp:219) over the
overgrown gains on the host — the tree is a few hundred nodes — and the
rows are remapped on the device.  Leaf counts are exact partition counts
(ref: DataPartition cnt_leaf_data).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..ops.histogram import (build_histogram_wave_fixed,
                             build_histogram_wave_hl_fixed,
                             build_histogram_wave_int, codes_to_int,
                             dequantize,
                             fixed_unit, from_fixed, scale_exps,
                             wave_hl_fits,
                             wave_hl_profitable, wave_slot_pad)
from ..ops.split import (K_MIN_SCORE, MISSING_NAN, MISSING_ZERO, SplitResult,
                         cat_bitset_words, find_best_split,
                         monotone_gain_penalty)
from ..utils.timer import global_timer
from .grow import (FeatureMeta, GrowParams, ScanDraws, TreeArrays,
                   allowed_features, bundle_hist_to_features,
                   gather_forced_split, interaction_masks)

# bytes of int64 per-feature histogram sums one scan call converts
SCAN_CHUNK_BYTES = 512 << 20

_NODE_FIELDS = ("split_feature", "threshold_bin", "default_left",
                "split_gain", "left_child", "right_child", "internal_value",
                "internal_weight", "internal_count", "split_is_cat")
_LEAF_FIELDS = ("leaf_value", "leaf_weight", "leaf_count", "leaf_parent",
                "leaf_depth")


def _to_host(arrays: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Device 1-D tensors -> numpy in ONE transfer (int32 bit pattern)."""
    names = list(arrays)
    parts, dtypes = [], []
    for k in names:
        a = arrays[k]
        dtypes.append(a.dtype)
        if a.dtype == torch.bool:
            a = a.to(torch.int32)
        parts.append(a.contiguous().view(torch.int32))
    flat = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for k, p, dt in zip(names, parts, dtypes):
        seg = flat[off:off + p.numel()]
        off += p.numel()
        if dt == torch.float32:
            seg = seg.view(np.float32)
        elif dt == torch.bool:
            seg = seg != 0
        out[k] = seg.copy()
    return out


def _prune_to_leafwise(t: Dict[str, np.ndarray], num_leaves: int, L: int,
                       Lp: int, ni: int):
    """Prune the overgrown tree back to L leaves in the reference's strict
    leaf-wise order (serial_tree_learner.cpp:219 ArgMax over leaf gains):
    simulate the best-gain pop sequence over the overgrown tree's split
    gains, keep the popped splits, renumber nodes/leaves by pop order, and
    map each overgrown leaf slot to its nearest kept ancestor's side.
    Host numpy port of the JAX engine's `_prune_to_leafwise`; returns
    (pruned node/leaf arrays, lid_map [Lp])."""
    nodes = np.arange(ni, dtype=np.int32)
    created = nodes < num_leaves - 1
    lc, rc = t["left_child"], t["right_child"]
    par = np.full(ni, -1, np.int32)
    ml = created & (lc >= 0)
    par[lc[ml]] = nodes[ml]
    mr = created & (rc >= 0)
    par[rc[mr]] = nodes[mr]
    gains = np.where(created, t["split_gain"], np.float32(K_MIN_SCORE))

    nf = max(L - 1, 1)
    kept = np.zeros(ni, bool)
    avail = created & (par == -1)              # the root node
    new_id = np.zeros(ni, np.int32)
    pop = np.zeros(nf, np.int32)
    lid_of = np.zeros(ni, np.int32)            # leaf id a node splits
    dep_of = np.zeros(ni, np.int32)            # depth of that leaf
    nl_l = np.zeros(ni, np.int32)              # left/right child leaf ids
    nl_r = np.zeros(ni, np.int32)              # assigned at pop
    cnt = 0
    for _ in range(nf):
        score = np.where(avail & ~kept & (gains > 0.0), gains,
                         np.float32(K_MIN_SCORE))
        j = int(np.argmax(score))
        if not score[j] > K_MIN_SCORE:
            break
        kept[j] = True
        new_id[j] = cnt
        pop[cnt] = j
        ll = lid_of[j]
        nl_l[j] = ll
        nl_r[j] = cnt + 1
        dl = dep_of[j] + 1
        if lc[j] >= 0:
            lid_of[lc[j]], dep_of[lc[j]], avail[lc[j]] = ll, dl, True
        if rc[j] >= 0:
            lid_of[rc[j]], dep_of[rc[j]], avail[rc[j]] = cnt + 1, dl, True
        cnt += 1
    n_kept = cnt

    tf = np.arange(nf, dtype=np.int32)
    valid_t = tf < n_kept
    old = np.where(valid_t, pop, 0)

    def gat(a, fill=0):
        return np.where(valid_t, a[old], fill).astype(a.dtype)

    olc, orc = lc[old], rc[old]
    olci, orci = np.clip(olc, 0, ni - 1), np.clip(orc, 0, ni - 1)
    lk = (olc >= 0) & kept[olci]
    rk = (orc >= 0) & kept[orci]
    onl_l, onl_r = nl_l[old], nl_r[old]
    left_f = np.where(valid_t, np.where(lk, new_id[olci], ~onl_l), 0)
    right_f = np.where(valid_t, np.where(rk, new_id[orci], ~onl_r), 0)

    def side_leaf(oc, is_leaf_here, nl):
        oci = np.clip(oc, 0, ni - 1)
        osl = np.clip(~oc, 0, Lp - 1)
        lid = np.where(valid_t & is_leaf_here, nl, Lp)
        val = np.where(oc >= 0, t["internal_value"][oci], t["leaf_value"][osl])
        wgt = np.where(oc >= 0, t["internal_weight"][oci],
                       t["leaf_weight"][osl])
        cntv = np.where(oc >= 0, t["internal_count"][oci],
                        t["leaf_count"][osl])
        return lid, val, wgt, cntv

    lid_l, val_l, wgt_l, cnt_l = side_leaf(olc, ~lk, onl_l)
    lid_r, val_r, wgt_r, cnt_r = side_leaf(orc, ~rk, onl_r)
    dep1 = dep_of[old] + 1

    def scat(init, vl, vr):
        m = lid_l < Lp
        init[lid_l[m]] = vl[m]
        m = lid_r < Lp
        init[lid_r[m]] = vr[m]
        return init

    out = {}
    if n_kept == 0:                            # no kept split: one leaf
        for k, fill in (("leaf_value", 0.0), ("leaf_weight", 0.0),
                        ("leaf_count", 0)):
            a = np.zeros(Lp, t[k].dtype)
            a[0] = t[k][0]
            out[k] = a
        out["leaf_parent"] = np.full(Lp, -1, np.int32)
        out["leaf_depth"] = np.zeros(Lp, np.int32)
    else:
        out["leaf_value"] = scat(np.zeros(Lp, np.float32), val_l, val_r)
        out["leaf_weight"] = scat(np.zeros(Lp, np.float32), wgt_l, wgt_r)
        out["leaf_count"] = scat(np.zeros(Lp, np.int32), cnt_l, cnt_r)
        out["leaf_parent"] = scat(np.full(Lp, -1, np.int32), tf, tf)
        out["leaf_depth"] = scat(np.zeros(Lp, np.int32), dep1, dep1)
    out["split_feature"] = gat(t["split_feature"])
    out["threshold_bin"] = gat(t["threshold_bin"])
    out["default_left"] = gat(t["default_left"], False)
    out["split_gain"] = gat(t["split_gain"], 0.0)
    out["left_child"] = left_f.astype(np.int32)
    out["right_child"] = right_f.astype(np.int32)
    out["internal_value"] = gat(t["internal_value"], 0.0)
    out["internal_weight"] = gat(t["internal_weight"], 0.0)
    out["internal_count"] = gat(t["internal_count"])
    out["split_is_cat"] = gat(t["split_is_cat"], False)
    out["cat_bitset"] = np.where(valid_t[:, None], t["cat_bitset"][old],
                                 0).astype(np.int32)

    # overgrown leaf slot -> nearest kept ancestor's side leaf: walk up
    # until the current node is kept (or the root is passed)
    s_ids = np.arange(Lp, dtype=np.int32)
    node = t["leaf_parent"].copy()
    side = np.where(rc[np.clip(node, 0, ni - 1)] == ~s_ids, 1, 0)
    while True:
        nodei = np.clip(node, 0, ni - 1)
        done = (node < 0) | kept[nodei]
        if done.all():
            break
        pnode = par[nodei]
        pside = np.where(rc[np.clip(pnode, 0, ni - 1)] == node, 1, 0)
        node = np.where(done, node, pnode)
        side = np.where(done, side, pside)
    nwi = np.clip(node, 0, ni - 1)
    lid_map = np.where(node >= 0,
                       np.where(side == 1, nl_r[nwi], nl_l[nwi]), 0)
    return n_kept + 1, out, lid_map.astype(np.int64)


class _Best:
    """Per-leaf best splits (SplitResult fields as [Lp + 1] tensors)."""

    def __init__(self, Lp: int, W: int, device):
        f32, i32 = torch.float32, torch.int32
        z = lambda dt: torch.zeros(Lp + 1, dtype=dt, device=device)
        self.fields = dict(
            gain=torch.full((Lp + 1,), K_MIN_SCORE, device=device),
            feature=z(i32), threshold=z(i32), default_left=z(torch.bool),
            left_sum_gradient=z(f32), left_sum_hessian=z(f32),
            left_count=z(i32), left_output=z(f32),
            right_sum_gradient=z(f32), right_sum_hessian=z(f32),
            right_count=z(i32), right_output=z(f32),
            is_cat=z(torch.bool),
            cat_bitset=torch.zeros((Lp + 1, W), dtype=i32, device=device))

    def store(self, idx: torch.Tensor, res: SplitResult) -> None:
        for k, v in res._asdict().items():
            self.fields[k].index_copy_(0, idx, v)

    def view(self, NLp: int) -> SplitResult:
        return SplitResult(**{k: v[:NLp] for k, v in self.fields.items()})


def grow_tree_wave_impl(binned: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, row_mask: torch.Tensor,
                        col_mask: torch.Tensor, meta: FeatureMeta,
                        params: GrowParams,
                        quant_scales: torch.Tensor = None,
                        extra_tag: int = None,
                        cegb_used: torch.Tensor = None):
    """Grow one tree by waves.

    Args:
      binned: [F', n] feature-major bin codes (n a multiple of 512), uint8
        or 16-bit (int16 storage, ops/histogram.py code_dtype): one row
        per feature, or per bundle column under EFB.
      grad, hess, row_mask: [n] float32.  col_mask: [F] bool.
      quant_scales: [2] float32 (gradient, hessian) scales of quantized
        gradients; with params.quant_bins > 0 every wave's histograms go
        to K2 (ref: dense_bin.hpp:174 ConstructHistogramIntInner).
      extra_tag: folds the extra-trees and bynode keys (the booster's
        absolute iteration x classes + class).
      cegb_used: [F] bool, the features earlier trees used (CEGB).

    Returns (TreeArrays with node arrays [max(L-1, 1)] and leaf arrays
    [L], leaf_id [n] int32).
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
    forced = tuple(params.forced_splits)
    use_interaction = bool(params.interaction_sets)

    row_mask = row_mask.to(f32)
    grad = grad.to(f32) * row_mask
    hess = hess.to(f32) * row_mask
    # 2 histogram channels; the trailing column is the count mask
    gh = torch.stack([grad, hess, row_mask], dim=1).contiguous()
    use_int = params.quant_bins > 0 and quant_scales is not None
    # the tree's fixed-point grid (every histogram of the tree lies on it)
    # and the conversion the scan applies to the cached integer sums:
    # group-space sums become per-feature ones before they are scaled
    def to_features(acc):
        return bundle_hist_to_features(acc.reshape(-1, Fg, hist_B, 2), None,
                                       None, meta, B, hist_B, bundles)

    if use_int:
        quant_scales = quant_scales.to(dev, torch.float32)

        def deq_h(acc):
            return dequantize(to_features(acc), quant_scales)

        def deq_c(cnt):
            return cnt.to(f32)
    else:
        exps = scale_exps(gh)
        unit = fixed_unit(exps)

        def deq_h(acc):
            return from_fixed(to_features(acc), unit[:2])

        def deq_c(cnt):
            return from_fixed(cnt[:, None], unit[2:])[:, 0]

    # leaf totals summed in float64 so CPU and CUDA agree
    sum_g0 = grad.sum(dtype=torch.float64).to(f32)
    sum_h0 = hess.sum(dtype=torch.float64).to(f32)
    cnt0 = row_mask.sum(dtype=torch.float64).to(i32)

    # forced splits turn prune off: the replay ranks by gain and could
    # drop a forced node, which the reference keeps whatever its gain
    prune = (params.wave_prune and L > 2 and not sp.has_monotone
             and not sp.has_cegb and not forced)
    Lg = (min(max(L, int(math.ceil(L * params.wave_prune_overshoot))),
              4 * L) if prune else L)
    spike_k = int(params.wave_spike_k or 8)
    spike_waves = (int(params.wave_spike_reserve) // spike_k
                   if prune and L >= 8 * spike_k else 0)
    reserve = min(spike_waves * spike_k, max(Lg - L, 0))
    spike_waves = reserve // spike_k
    Lg_main = Lg - spike_waves * spike_k

    ni = max(Lg - 1, 1)
    Lp = wave_slot_pad(Lg)
    Dh = Fg * hist_B * 2
    W = cat_bitset_words(B)

    def zeros(size, dt):
        return torch.zeros(size, dtype=dt, device=dev)

    node = {k: zeros(ni + 1, dt) for k, dt in (
        ("split_feature", i32), ("threshold_bin", i32),
        ("default_left", torch.bool), ("split_gain", f32),
        ("left_child", i32), ("right_child", i32),
        ("internal_value", f32), ("internal_weight", f32),
        ("internal_count", i32), ("split_is_cat", torch.bool))}
    node["cat_bitset"] = zeros((ni + 1, W), i32)
    leaf = {k: zeros(Lp + 1, dt) for k, dt in (
        ("leaf_value", f32), ("leaf_weight", f32), ("leaf_count", i32),
        ("leaf_depth", i32))}
    leaf["leaf_parent"] = torch.full((Lp + 1,), -1, dtype=i32, device=dev)
    leaf["leaf_weight"][0] = sum_h0
    leaf["leaf_count"][0] = cnt0
    leaf_sum_g = zeros(Lp + 1, f32)
    leaf_sum_g[0] = sum_g0
    leaf_sum_h = zeros(Lp + 1, f32)
    leaf_sum_h[0] = sum_h0
    leaf_out = zeros(Lp + 1, f32)
    if sp.has_monotone:
        leaf_cmin = torch.full((Lp + 1,), float("-inf"), device=dev)
        leaf_cmax = torch.full((Lp + 1,), float("inf"), device=dev)
    if sp.has_cegb:
        used_vec = (zeros(F, torch.bool) if cegb_used is None
                    else cegb_used.to(dev, torch.bool).clone())
    if use_interaction:
        set_masks = interaction_masks(params.interaction_sets, F, dev)
        # each leaf's branch features (the dump row Lp included)
        leaf_branch = zeros((Lp + 1, F), torch.bool)
    # per-leaf histogram cache of integer sums, completed by exact sibling
    # subtraction (the HistogramPool analogue, feature_histogram.hpp:1367)
    cache_h = zeros((Lp + 1, Dh), i64)
    cache_c = zeros(Lp + 1, i64)
    # pending-split tables of the previous wave (by the slot that split):
    # new right slot, pair rank (= computed slot of the smaller child),
    # smaller-is-left flag
    pend = dict(sel=zeros(Lp, torch.bool), new=zeros(Lp, i32),
                rank=zeros(Lp, i32), sl=zeros(Lp, torch.bool))
    best_state = _Best(Lp, W, dev)
    leaf_id = zeros(n, i64)
    kslot = zeros(n, i32)
    state = dict(NL=1, cont=L > 1, kslot=kslot, leaf_id=leaf_id)
    slots_lp = torch.arange(Lp, dtype=i64, device=dev)

    def wave_hists(Kb: int, first: bool, Ks):
        """Refresh the cache for the leaves the previous wave created:
        one histogram pass computes the smaller child of each pending
        split (compact slot = pair rank); the larger is parent - smaller.
        Rows outside a computed leaf carry the sentinel slot Lp."""
        with global_timer.device_scope("Tree::histogram", dev):
            if use_int:
                H, cnt = build_histogram_wave_int(
                    binned, state["kslot"], gh, quant_scales,
                    max_bin=hist_B, num_slots=Kb)
            elif (Ks is not None and wave_hl_profitable(hist_B, Ks)
                    and wave_hl_fits(hist_B, Ks)):
                # K3 reads the feature-major bins; the JAX signature's
                # row-major argument is checked for its shape only
                H, cnt = build_histogram_wave_hl_fixed(
                    binned, binned.t(), state["kslot"], gh, exps,
                    max_bin=hist_B, num_slots=Ks, out_slots=Kb)
            else:
                H, cnt = build_histogram_wave_fixed(
                    binned, state["kslot"], gh, exps, max_bin=hist_B,
                    num_slots=Kb)
        Hf = H.reshape(Kb, Dh)
        if first:
            cache_h[0] = Hf[0]
            cache_c[0] = cnt[0]
            return
        # rank -> (parent slot, right slot, smaller-left) tables; the
        # extra entry Kb is the dump for slots without a pending split
        ok = pend["sel"] & (pend["rank"] < Kb)
        rdrop = torch.where(ok, pend["rank"].to(i64), Kb)
        p_of = zeros(Kb + 1, i64).scatter_(0, rdrop, slots_lp)[:Kb]
        q_of = zeros(Kb + 1, i64).scatter_(
            0, rdrop, pend["new"].to(i64))[:Kb]
        sl_of = zeros(Kb + 1, torch.bool).scatter_(0, rdrop, pend["sl"])[:Kb]
        valid = zeros(Kb + 1, torch.bool).scatter_(0, rdrop, ok)[:Kb]
        pv = torch.where(valid, p_of, Lp)
        qv = torch.where(valid, q_of, Lp)
        parent_h = cache_h[pv]
        other_h = parent_h - Hf
        slb = sl_of[:, None]
        cache_h.index_copy_(0, pv, torch.where(slb, Hf, other_h))
        cache_h.index_copy_(0, qv, torch.where(slb, other_h, Hf))
        parent_c = cache_c[pv]
        other_c = parent_c - cnt
        cache_c.index_copy_(0, pv, torch.where(sl_of, cnt, other_c))
        cache_c.index_copy_(0, qv, torch.where(sl_of, other_c, cnt))

    draws = ScanDraws(params, meta, (Lp, F), extra_tag, dev)

    # leaves a scan converts to per-feature histograms at once: their int64
    # sums fill at most SCAN_CHUNK_BYTES (wide EFB data, where F * B is
    # large, scans in several chunks of leaves; a leaf's result does not
    # depend on the others)
    scan_leaves = max(1, SCAN_CHUNK_BYTES // (F * B * 2 * 8))

    def scan(idx: torch.Tensor, rb=None, bym=None, rcu=None) -> SplitResult:
        """Scan the leaves `idx`; rb/bym/rcu are the wave's [Lp, F] draws,
        row l for leaf l (bym: the bynode subsets and what each leaf's
        branch allows under interaction constraints)."""
        if idx.shape[0] <= scan_leaves:
            return scan_chunk(idx, rb, bym, rcu)
        parts = [scan_chunk(idx[i:i + scan_leaves], rb, bym, rcu)
                 for i in range(0, idx.shape[0], scan_leaves)]
        return SplitResult(*(torch.cat(f) for f in zip(*parts)))

    def scan_chunk(idx, rb, bym, rcu) -> SplitResult:
        cm = col_mask if bym is None else col_mask[None, :] & bym[idx]
        kw = {}
        if rb is not None:
            kw["rand_bin"] = rb[idx]
        if rcu is not None:
            kw["rand_cat_u"] = rcu[idx]
        if sp.has_categorical:
            kw["is_cat_feature"] = meta.is_cat
        if sp.has_monotone:
            kw.update(monotone=meta.monotone, constraint_min=leaf_cmin[idx],
                      constraint_max=leaf_cmax[idx],
                      mono_penalty=monotone_gain_penalty(
                          leaf["leaf_depth"][idx], sp.monotone_penalty))
        if sp.has_cegb:
            kw.update(cegb_coupled=meta.cegb_coupled, cegb_used=used_vec)
        with global_timer.device_scope("Tree::split_find", dev):
            hists = deq_h(cache_h[idx])
            return find_best_split(
                hists, meta.num_bin, meta.missing_type, meta.default_bin,
                meta.penalty, cm, leaf_sum_g[idx], leaf_sum_h[idx],
                torch.round(deq_c(cache_c[idx])).to(i32), leaf_out[idx], sp,
                **kw)

    def forced_entry(fleaf: int, ffeat: int, fthr: int) -> SplitResult:
        """The forced split of leaf `fleaf`, gathered from its cached
        histogram (grow.gather_forced_split, shared with the leaf-wise
        engine)."""
        hist = deq_h(cache_h[fleaf:fleaf + 1])[0]
        return gather_forced_split(hist, ffeat, fthr, leaf_sum_g[fleaf],
                                   leaf_sum_h[fleaf],
                                   deq_c(cache_c[fleaf:fleaf + 1])[0], meta,
                                   B, sp)

    def wave_body(NLp: int, Kb: int, first: bool = False, Ks=None,
                  lg_cap=None, budget_cap=None, forced_split=None):
        """One wave with a slot bound NLp >= current num_leaves and a
        computed-slot bound Kb >= splits of the previous wave (Ks: the
        true, unpadded bound, which routes few-slot waves to K3).  A
        forced wave (`forced_split` = (leaf, feature, threshold bin))
        splits that leaf alone, whatever its gain's rank or sign, where
        both children are non-empty and max_depth and the leaf budget
        allow it."""
        NL = state["NL"]
        wave_hists(Kb, first, Ks)
        counts = torch.round(deq_c(cache_c[:NLp])).to(i32)
        ar = torch.arange(NLp, dtype=i64, device=dev)
        active = ar < NL
        # a leaf's best split changes only when the leaf is created, so
        # the scan may cover just the <= 2*Kb leaves of the previous wave
        # when that bound is a small fraction of NLp; a wave's fresh draws
        # and the branches' interaction masks change every leaf's scan
        rb = bym = rcu = None
        if draws.active:
            rb, bym, rcu = (draws.rand_bins(NL), draws.bynode(NL),
                            draws.rand_cat_u(NL))
        if use_interaction:
            allow = allowed_features(leaf_branch[:Lp], set_masks)
            bym = allow if bym is None else bym & allow
        if (draws.active or use_interaction or first or 4 * Kb > NLp
                or sp.has_monotone or sp.has_cegb):
            best_state.store(ar, scan(ar, rb, bym, rcu))
        else:
            order = torch.sort(-pend["sel"].to(i32), stable=True).indices
            psl = order[:Kb]
            valid_p = pend["sel"][psl]
            parents = torch.where(valid_p, psl, Lp)
            news = torch.where(valid_p, pend["new"][psl].to(i64), Lp)
            changed = torch.cat([parents, news])
            best_state.store(changed, scan(changed.clamp(0, Lp - 1)))
        best = best_state.view(NLp)

        if forced_split is not None:
            # forced wave (ref: serial_tree_learner.cpp:614 ForceSplits):
            # the leaf's entry is the forced split, the stored scan kept
            fleaf, ffeat, fthr = forced_split
            fentry = forced_entry(fleaf, ffeat, fthr)
            best = SplitResult(**{k: v.clone()
                                  for k, v in best._asdict().items()})
            for k, v in fentry._asdict().items():
                getattr(best, k)[fleaf] = v
            split_sel = (ar == fleaf) & (fentry.gain > K_MIN_SCORE)
            if not fleaf < NL < L:
                split_sel = torch.zeros_like(split_sel)
            if params.max_depth > 0:
                split_sel = split_sel & (leaf["leaf_depth"][fleaf]
                                         < params.max_depth)
            rank_of = torch.zeros(NLp, dtype=i64, device=dev)
        else:
            # select splitting leaves: positive gain, active, depth ok,
            # best-gain-first within the remaining leaf budget
            gain = torch.where(active, best.gain,
                               torch.full_like(best.gain, K_MIN_SCORE))
            if params.max_depth > 0:
                gain = torch.where(
                    leaf["leaf_depth"][:NLp] < params.max_depth, gain,
                    torch.full_like(gain, K_MIN_SCORE))
            want = gain > 0.0
            budget = (Lg if lg_cap is None else lg_cap) - NL
            if budget_cap is not None:
                budget = min(budget, budget_cap)
            if params.wave_tail_halving and budget < NL:
                budget = max((budget + 1) // 2, 1)
            order = torch.sort(-gain, stable=True).indices
            rank_of = torch.empty(NLp, dtype=i64, device=dev).scatter_(
                0, order, ar)
            split_sel = want & (rank_of < budget)

        # node/new-leaf numbering by gain rank (leaf-wise split order)
        node_of = torch.where(split_sel, NL - 1 + rank_of, 0)
        newleaf_of = torch.where(split_sel, NL + rank_of, 0)

        # tree arrays (ref: tree.cpp Tree::Split).  Parent child pointers
        # that reference a splitting leaf now point at its new node.
        arn = torch.arange(ni + 1, dtype=i64, device=dev)

        def fix_child(child):
            ll = torch.where(child < 0, ~child, 0).to(i64)
            idx = ll.clamp(0, NLp - 1)
            hit = (child < 0) & (arn < NL - 1) & split_sel[idx]
            return torch.where(hit, node_of[idx].to(i32), child)

        node["left_child"] = fix_child(node["left_child"])
        node["right_child"] = fix_child(node["right_child"])
        drop = torch.where(split_sel, node_of, ni)
        leaf_vals_old = leaf["leaf_value"][:NLp].clone()
        for k, v in (("left_child", (~ar).to(i32)),
                     ("right_child", (~newleaf_of).to(i32)),
                     ("split_feature", best.feature),
                     ("threshold_bin", best.threshold),
                     ("default_left", best.default_left),
                     ("split_gain", best.gain),
                     ("internal_value", leaf_vals_old),
                     ("internal_weight",
                      best.left_sum_hessian + best.right_sum_hessian),
                     ("internal_count", counts),
                     ("split_is_cat", best.is_cat),
                     ("cat_bitset", best.cat_bitset)):
            node[k].index_copy_(0, drop, v)

        # leaf records: the old slot becomes the left child, the new slot
        # the right one
        ldrop = torch.where(split_sel, ar, Lp)
        rdrop = torch.where(split_sel, newleaf_of, Lp)
        depth1 = leaf["leaf_depth"][:NLp] + 1
        sl_nodes = node_of.to(i32)

        def lset(arr, lvals, rvals):
            arr.index_copy_(0, ldrop, lvals)
            arr.index_copy_(0, rdrop, rvals)

        lset(leaf["leaf_value"], best.left_output, best.right_output)
        lset(leaf["leaf_weight"], best.left_sum_hessian,
             best.right_sum_hessian)
        # the scan's approximate counts; exact ones are restored from the
        # count channel at finalization
        lset(leaf["leaf_count"], best.left_count, best.right_count)
        lset(leaf["leaf_parent"], sl_nodes, sl_nodes)
        lset(leaf["leaf_depth"], depth1, depth1)
        lset(leaf_sum_g, best.left_sum_gradient, best.right_sum_gradient)
        lset(leaf_sum_h, best.left_sum_hessian, best.right_sum_hessian)
        lset(leaf_out, best.left_output, best.right_output)
        if use_interaction:
            # the children's branch adds the split feature (ref:
            # col_sampler.hpp per-branch used features)
            fb = ((torch.arange(F, device=dev)[None, :]
                   == best.feature.to(i64)[:, None]) & split_sel[:, None])
            newb = leaf_branch[:NLp] | fb
            lset(leaf_branch, newb, newb)
        if sp.has_monotone:
            # basic-mode propagation (BasicLeafConstraints::Update):
            # children of a monotone numerical split bounded at the
            # midpoint of their outputs
            p_min, p_max = leaf_cmin[:NLp].clone(), leaf_cmax[:NLp].clone()
            mc_w = meta.monotone[best.feature.to(i64)]
            mid = (best.left_output + best.right_output) / 2.0
            apply = split_sel & (mc_w != 0) & ~best.is_cat
            pos, neg = apply & (mc_w > 0), apply & (mc_w < 0)
            lset(leaf_cmin, torch.where(neg, torch.maximum(p_min, mid), p_min),
                 torch.where(pos, torch.maximum(p_min, mid), p_min))
            lset(leaf_cmax, torch.where(pos, torch.minimum(p_max, mid), p_max),
                 torch.where(neg, torch.minimum(p_max, mid), p_max))

        # recolor rows through one packed per-leaf table gather; the
        # smaller side of each pair (by the scan's counts) is the next
        # wave's computed slot
        small_left = best.left_count <= best.right_count
        feat = best.feature.to(i64)
        cols = [split_sel.to(i32), best.feature, best.threshold,
                best.default_left.to(i32), newleaf_of.to(i32),
                meta.missing_type[feat], meta.default_bin[feat],
                meta.num_bin[feat], rank_of.to(i32), small_left.to(i32)]
        if bundles:
            # the split feature's bundle column, code offset, default bin
            cols += [meta.group[feat], meta.offset[feat], meta.zero_bin[feat]]
        nbase = len(cols)
        table = torch.stack(cols, dim=1)
        if sp.has_categorical:
            table = torch.cat([table, best.is_cat.to(i32)[:, None],
                               best.cat_bitset], dim=1)
        with global_timer.device_scope("Tree::partition", dev):
            lid = state["leaf_id"]
            prow = table[lid]                            # [n, columns]
            sel_r = prow[:, 0] > 0
            col_r = prow[:, 10] if bundles else prow[:, 1]
            fbin = codes_to_int(torch.gather(binned, 0,
                                             col_r.to(i64)[None, :])[0], i32)
            mt_r, db_r, nb_r = prow[:, 5], prow[:, 6], prow[:, 7]
            if bundles:
                # a code outside the feature's range: its default bin
                local = fbin - prow[:, 11]
                fbin = torch.where((local >= 0) & (local < nb_r), local,
                                   prow[:, 12])
            is_missing = (((mt_r == MISSING_NAN) & (fbin == nb_r - 1))
                          | ((mt_r == MISSING_ZERO) & (fbin == db_r)))
            go_left = torch.where(is_missing, prow[:, 3] > 0,
                                  fbin <= prow[:, 2])
            if sp.has_categorical:
                word = torch.gather(
                    prow[:, nbase + 1:], 1,
                    torch.clamp(fbin // 32, max=W - 1).to(i64)[:, None])[:, 0]
                cat_left = ((word >> (fbin % 32)) & 1) > 0
                go_left = torch.where(prow[:, nbase] > 0, cat_left, go_left)
            state["leaf_id"] = torch.where(sel_r & ~go_left,
                                           prow[:, 4].to(i64), lid)
            state["kslot"] = torch.where(
                sel_r & (go_left == (prow[:, 9] > 0)), prow[:, 8],
                torch.full_like(prow[:, 8], Lp)).contiguous()

        if sp.has_cegb:
            # every feature of this wave's splits becomes used (the JAX
            # engine's per-wave accounting, see the module docstring)
            hit = zeros(F + 1, torch.bool).index_fill_(
                0, torch.where(split_sel, best.feature.to(i64), F), True)
            used_vec.logical_or_(hit[:F])
        pend["sel"] = zeros(Lp, torch.bool)
        pend["sel"][:NLp] = split_sel
        pend["new"] = zeros(Lp, i32)
        pend["new"][:NLp] = newleaf_of.to(i32)
        pend["rank"] = zeros(Lp, i32)
        pend["rank"][:NLp] = rank_of.to(i32)
        pend["sl"] = zeros(Lp, torch.bool)
        pend["sl"][:NLp] = small_left
        n_split = int(split_sel.sum())                # the wave's host sync
        state["NL"] = NL + n_split
        state["cont"] = n_split > 0 and state["NL"] < (
            Lg if lg_cap is None else lg_cap)

    # forced prologue (ref: serial_tree_learner.cpp:614 ForceSplits): one
    # forced split per wave in the parse-time BFS numbering; the first
    # that cannot apply ends the forcing, and its leaf returns to
    # best-gain growth
    KF = min(len(forced), max(L - 1, 0))
    for k in range(KF):
        nl_before = state["NL"]
        wave_body(wave_slot_pad(k + 2), wave_slot_pad(1), first=(k == 0),
                  Ks=1, forced_split=forced[k])
        if state["NL"] == nl_before:
            break
    if KF:
        state["cont"] = L > 1 and state["NL"] < Lg_main
    num_waves = max(1, math.ceil(math.log2(Lg_main))) if Lg_main > 1 else 0
    for k in range(num_waves):
        # entering ladder wave k the tree has grown from at most KF + 1
        # leaves (the forced prologue) through k doubling waves, so
        # NL <= (KF + 1) 2^k; the computed slots are the previous wave's
        # splits (the last forced wave's one for the first).  The bounds
        # must be multiplicative in KF + 1: an additive bound undersizes
        # Ks, and K3 zero-pads real children past out_slots
        NLp = wave_slot_pad(min((KF + 1) << k, Lg_main))
        Ks = (1 if k == 0 and KF
              else min((KF + 1) << max(k - 1, 0), Lg_main))
        if state["cont"]:
            wave_body(NLp, wave_slot_pad(Ks), first=(k == 0 and not KF),
                      Ks=Ks, lg_cap=Lg_main)
    if num_waves > 0:
        # growth slower than doubling needs more rounds than the ladder:
        # keep waving at the full slot bound until nothing splits
        while state["cont"]:
            wave_body(wave_slot_pad(Lg_main),
                      wave_slot_pad(max(Lg_main // 2, 1)), lg_cap=Lg_main)
    for s_i in range(spike_waves):
        # narrow deepening into the top-gain frontier (<= spike_k splits)
        KsS = min(spike_k if s_i > 0 else max(Lg_main // 2, 1), Lg)
        if state["NL"] < Lg:
            wave_body(wave_slot_pad(Lg), wave_slot_pad(KsS),
                      Ks=(KsS if KsS <= 16 else None), budget_cap=spike_k)

    leaf_id = state["leaf_id"]
    nf = max(L - 1, 1)
    if prune and num_waves > 0:
        host = _to_host({**{k: node[k][:ni] for k in _NODE_FIELDS},
                         **{k: leaf[k][:Lp] for k in _LEAF_FIELDS},
                         "cat_bitset": node["cat_bitset"][:ni].reshape(-1)})
        host["cat_bitset"] = host["cat_bitset"].reshape(ni, W)
        nl_final, pruned, lid_map = _prune_to_leafwise(
            host, state["NL"], L, Lp, ni)
        lid_map = torch.from_numpy(lid_map).to(dev)
        # exact final counts: per-old-slot masked counts scattered through
        # the slot -> leaf table (integer sums, exact in float32)
        cnt_slot = zeros(Lp, f32).index_add_(0, leaf_id, row_mask)
        exact = zeros(Lp, f32).index_add_(0, lid_map, cnt_slot).to(i32)
        leaf_id = lid_map[leaf_id]
        out = {k: torch.from_numpy(v).to(dev) for k, v in pruned.items()}
        out["leaf_count"] = exact
    else:
        nl_final = state["NL"]
        out = {k: node[k][:nf] for k in _NODE_FIELDS}
        out["cat_bitset"] = node["cat_bitset"][:nf]
        out.update({k: leaf[k][:Lp] for k in _LEAF_FIELDS})
        if num_waves > 0:
            out["leaf_count"] = zeros(Lp, f32).index_add_(
                0, leaf_id, row_mask).to(i32)
    for k in _LEAF_FIELDS:
        out[k] = out[k][:L]
    return TreeArrays(num_leaves=nl_final, **out), leaf_id.to(i32)
