"""Flatten a trained tree ensemble into dense device arrays (the PyTorch
port's copy of `lightgbm_tpu/inference/pack.py`).

The serving-side twin of the training pack (boosting/gbdt.py _pack_tree):
Hummingbird (Nakandala et al., OSDI 2020) and RAPIDS FIL both showed that
tree-ensemble inference maps onto dense tensor ops once every tree is laid
out as flat node arrays — the traversal becomes a per-(row, tree) gather
chain instead of pointer chasing (ref: src/application/predictor.hpp keeps
the same flat layout for the host OpenMP predictor, native/predict.c here).

Layout: T trees are padded to a shared internal-node stride NI and leaf
stride NL, so node `i` of tree `t` lives at flat index `t * NI + i` in
every per-node array.  Child pointers keep the reference's `~leaf`
encoding (negative = bitwise-complemented leaf index, ref: tree.h:25).
Categorical splits index a single shared uint32 bitset table through
per-node (start, nwords) spans.

Exactness: thresholds are float64 in the model but the
device compares in float32.  `bounds_to_f32_floor` (io/device_bin.py)
rounds each threshold DOWN to the nearest float32, which preserves
`v <= threshold` EXACTLY for every float32 `v` — so float32 inputs take
bit-identical routing to the float64 host predictor.  The same floor is
applied to the 1e-35 zero threshold of the missing-value rule.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from ..io.binning import K_ZERO_THRESHOLD
from ..io.device_bin import bounds_to_f32_floor
from ..models.tree import K_CATEGORICAL_MASK, K_DEFAULT_LEFT_MASK

# float32 floor of the host's float64 zero threshold (meta.h:56): for a
# float32 |v|, `|v| <= 1e-35` in float64 iff `|v| <= ZERO_F32` in float32
ZERO_THRESHOLD_F32 = float(bounds_to_f32_floor(
    np.asarray([K_ZERO_THRESHOLD]))[0])

# categorical values at or past 2^31 cannot index an int32 bitset word;
# the host predictor routes them right too (the bitset is always shorter)
CAT_MAX_F32 = 2147483648.0


class PackedEnsemble(NamedTuple):
    """Host-side flat arrays; DevicePredictor puts them on the device once."""
    split_feature: np.ndarray   # [T, NI] int32, ORIGINAL feature index
    threshold: np.ndarray       # [T, NI] float32 (floored from float64)
    missing_type: np.ndarray    # [T, NI] int32 (MISSING_NONE/ZERO/NAN)
    default_left: np.ndarray    # [T, NI] bool
    is_cat: np.ndarray          # [T, NI] bool
    left: np.ndarray            # [T, NI] int32 (~leaf encoding)
    right: np.ndarray           # [T, NI] int32
    leaf_value: np.ndarray      # [T, NL] float32 (shrinkage applied)
    cat_start: np.ndarray       # [T, NI] int32 into cat_words
    cat_nwords: np.ndarray      # [T, NI] int32
    cat_words: np.ndarray       # [W] uint32 shared bitset table
    num_trees: int
    node_stride: int            # NI
    leaf_stride: int            # NL
    max_depth: int              # traversal iterations to settle every row
    max_feature: int            # highest original feature index referenced


def _tree_depth(tree) -> int:
    """Longest root->leaf path length (decisions taken).  Walked from the
    child arrays instead of leaf_depth because text-loaded models
    (Tree.from_string) do not carry leaf_depth."""
    nl = tree.num_leaves
    if nl <= 1:
        return 1
    depth = 1
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        for child in (int(tree.left_child[node]), int(tree.right_child[node])):
            if child >= 0:
                stack.append((child, d + 1))
    return depth


def _host_fallback(reason: str):
    """One host-fallback decision of the inference layer, named by its
    fallback KEY (the keys are listed in the README's port section).
    Returns None."""
    return None


def pack_ensemble(trees: List) -> Optional[PackedEnsemble]:
    """Pack a model slice; None when the slice cannot be served on device
    (linear-tree leaf models need per-leaf feature ridge evaluations)."""
    if any(getattr(t, "is_linear", False) for t in trees):
        return _host_fallback("linear-tree")
    T = len(trees)
    ni = max([max(t.num_leaves - 1, 1) for t in trees] or [1])
    nl = max([max(t.num_leaves, 1) for t in trees] or [1])
    sf = np.zeros((T, ni), np.int32)
    th = np.zeros((T, ni), np.float32)
    mt = np.zeros((T, ni), np.int32)
    dl = np.zeros((T, ni), bool)
    ic = np.zeros((T, ni), bool)
    lc = np.full((T, ni), -1, np.int32)   # ~0: route everything to leaf 0
    rc = np.full((T, ni), -1, np.int32)
    lv = np.zeros((T, nl), np.float32)
    cs = np.zeros((T, ni), np.int32)
    cn = np.zeros((T, ni), np.int32)
    words: List[np.ndarray] = []
    n_words = 0
    depth = 1
    for t, tree in enumerate(trees):
        n = max(tree.num_leaves - 1, 0)
        lv[t, :tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        if n == 0:
            continue  # stump: the prefilled ~0 children route to leaf 0
        dt = np.asarray(tree.decision_type[:n])
        sf[t, :n] = tree.split_feature[:n]
        th[t, :n] = bounds_to_f32_floor(tree.threshold[:n])
        mt[t, :n] = (dt.astype(np.int32) >> 2) & 3
        dl[t, :n] = (dt & K_DEFAULT_LEFT_MASK) != 0
        cat = (dt & K_CATEGORICAL_MASK) != 0
        ic[t, :n] = cat
        lc[t, :n] = tree.left_child[:n]
        rc[t, :n] = tree.right_child[:n]
        if cat.any():
            bounds = np.asarray(tree.cat_boundaries, np.int64)
            tw = np.asarray(tree.cat_threshold, np.uint32)
            for i in np.nonzero(cat)[0]:
                cat_idx = int(tree.threshold[i])  # threshold = cat set index
                start, end = int(bounds[cat_idx]), int(bounds[cat_idx + 1])
                cs[t, i] = n_words + start
                cn[t, i] = end - start
            words.append(tw)
            n_words += len(tw)
        depth = max(depth, _tree_depth(tree))
    cat_words = (np.concatenate(words).astype(np.uint32) if words
                 else np.zeros(1, np.uint32))
    return PackedEnsemble(
        split_feature=sf, threshold=th, missing_type=mt, default_left=dl,
        is_cat=ic, left=lc, right=rc, leaf_value=lv, cat_start=cs,
        cat_nwords=cn, cat_words=cat_words, num_trees=T, node_stride=ni,
        leaf_stride=nl, max_depth=depth,
        max_feature=int(sf.max()) if T else 0)
