"""Tensor traversal of a packed ensemble: all [rows x trees] at once
(PyTorch port of `lightgbm_tpu/inference/traverse.py`).

Every tree is evaluated for every row in lock-step, `max_depth` steps of

    node = where(x[:, feat[node]] <= thr[node], left[node], right[node])

with the reference's missing-value and categorical-bitset semantics
folded into the `where` (ref: tree.h:335 NumericalDecision, :372
CategoricalDecision; native/predict.c get_leaf_node is the host mirror
of exactly this decision).  Rows that reach a leaf early park on the
negative `~leaf` child pointer and stop moving; after max_depth steps
every lane holds a leaf.  Leaf values are gathered and summed per class
in float32, in tree order, so the card and the CPU give the same bits.

The per-node arrays are the ones `DevicePredictor` puts on the device:
gather indices (`split_feature`, `cat_start`) as int64, the bitset words
as int64 holding the uint32 values (torch's uint32 shifts are patchy on
CUDA; `(w >> s) & 1` is bit `s` either way).  Each step is a few dozen
elementwise torch launches over [B, T] tensors; `has_cat` (known from
the pack on the host) skips the categorical decision when no node is
categorical.
"""

from __future__ import annotations

import torch

from ..io.binning import MISSING_NAN, MISSING_ZERO
from .pack import CAT_MAX_F32, ZERO_THRESHOLD_F32


def ensemble_leaf_ids(x, split_feature, threshold, missing_type,
                      default_left, is_cat, left, right, cat_start,
                      cat_nwords, cat_words, depth: int,
                      has_cat: bool = True):
    """x [B, F] float32, per-node arrays [T, NI] -> leaf ids [B, T] int32.

    Bit-identical to the host routing for float32 inputs: thresholds are
    pre-floored to float32 (pack.py), so every comparison agrees with the
    float64 host comparison on float32 values.
    """
    T, NI = split_feature.shape
    dev = x.device
    base = (torch.arange(T, dtype=torch.int64, device=dev) * NI)[None, :]
    sf = split_feature.reshape(-1)
    th = threshold.reshape(-1)
    mt = missing_type.reshape(-1)
    dl = default_left.reshape(-1)
    ic = is_cat.reshape(-1)
    lc = left.reshape(-1)
    rc = right.reshape(-1)
    cs = cat_start.reshape(-1)
    cn = cat_nwords.reshape(-1)
    nwords_total = cat_words.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    node = torch.zeros((x.shape[0], T), dtype=torch.int32, device=dev)
    for _ in range(depth):
        g = node.clamp(min=0).to(torch.int64) + base     # flat node index
        v = torch.gather(x, 1, sf[g])
        nan = torch.isnan(v)
        m = mt[g]
        # numerical decision (tree.h:335): NaN under non-NaN missing
        # handling is treated as 0.0 before the zero test
        fz = torch.where(nan & (m != MISSING_NAN), zero, v)
        is_zero = fz.abs() <= ZERO_THRESHOLD_F32
        take_default = (((m == MISSING_ZERO) & is_zero)
                        | ((m == MISSING_NAN) & nan))
        go_left = torch.where(take_default, dl[g], fz <= th[g])
        if has_cat:
            # categorical decision (tree.h:372): NaN / negative / huge go
            # right; v truncates toward zero ((-1, 0) -> category 0)
            ok = (~nan) & (v > -1.0) & (v < CAT_MAX_F32)
            vi = torch.where(ok, v, zero).to(torch.int64)
            word = vi >> 5
            inset = ok & (word < cn[g])
            widx = (cs[g] + word).clamp(0, nwords_total - 1)
            bit = (cat_words[widx] >> (vi & 31)) & 1
            go_left = torch.where(ic[g], inset & (bit > 0), go_left)
        nxt = torch.where(go_left, lc[g], rc[g])
        # parked lanes (already on a leaf) keep their ~leaf pointer
        node = torch.where(node >= 0, nxt, node)
    return torch.bitwise_not(node)


def _leaf_values(leaf, leaf_value):
    """Leaf ids [B, T] + values [T, NL] -> per-tree contributions [B, T]."""
    T, NL = leaf_value.shape
    base = torch.arange(T, dtype=torch.int64, device=leaf.device) * NL
    return leaf_value.reshape(-1)[leaf.to(torch.int64) + base[None, :]]


def class_scores(leaf, leaf_value, num_class: int, average: bool):
    """Leaf ids [B, T] + values [T, NL] -> raw scores [B, K] (tree t
    belongs to class t % K; ref: predict.c lgbt_predict_batch), summed in
    float32 in tree order."""
    vals = _leaf_values(leaf, leaf_value)            # [B, T]
    B = vals.shape[0]
    K = max(num_class, 1)
    iters = leaf_value.shape[0] // K
    vals = vals.reshape(B, iters, K)
    scores = torch.zeros((B, K), dtype=torch.float32, device=leaf.device)
    for i in range(iters):
        scores = scores + vals[:, i]
    if average and iters > 0:
        scores = scores / iters                      # gbdt_prediction.cpp:57
    return scores


def class_scores_early_stop(leaf, leaf_value, num_class: int, freq: int,
                            margin: float):
    """Raw scores with prediction early stopping as a masked accumulation
    over iterations (ref: prediction_early_stop.cpp; gbdt.py
    _predict_raw_impl is the host mirror).

    The traversal already settled every (row, tree) leaf, but early
    stopping CHANGES THE ANSWER: a row whose margin clears the threshold
    at a round check keeps its partial sum and ignores all later trees.
    So the accumulation replays the host's sequential semantics: before
    adding iteration i (i > 0, i % freq == 0) the margin of the running
    float32 sum is tested (binary: 2|score|,
    CreateBinaryPredictionEarlyStopInstance; multiclass: top1 - top2,
    CreateMulticlassPredictionEarlyStopInstance) against the float32
    `margin`, and rows past it stop accumulating via a per-row done mask.
    """
    vals = _leaf_values(leaf, leaf_value)            # [B, T]
    B = vals.shape[0]
    K = max(num_class, 1)
    iters = leaf_value.shape[0] // K
    vals = vals.reshape(B, iters, K)
    dev = leaf.device
    acc = torch.zeros((B, K), dtype=torch.float32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    thr = torch.tensor(margin, dtype=torch.float32, device=dev)
    for i in range(iters):
        if i > 0 and i % freq == 0:
            if K == 1:
                m = 2.0 * acc[:, 0].abs()
            else:
                top2 = torch.topk(acc, 2, dim=1).values
                m = top2[:, 0] - top2[:, 1]
            done = done | (m > thr)
        acc = acc + torch.where(done[:, None], zero, vals[:, i])
    return acc
