"""GBDT boosting loop (PyTorch port of `lightgbm_tpu/boosting/gbdt.py`,
ref: src/boosting/gbdt.cpp, gbdt.h:37).

Binned data, scores and gradients live on the booster's device (the card
unless `device_type=cpu`).  Each iteration computes the objective's
gradients (quantized when `use_quantized_grad`), grows one tree per class
on the wave or the leaf-wise engine, updates the scores, and pulls the
tree to the host as a `Tree` in one flat transfer (like CUDATree::ToHost,
ref: src/io/cuda/cuda_tree.cpp) for model text and prediction.
Prediction runs on the card by default (`device_predict=auto` on a
card booster): the ensemble is packed once and traversed as tensors
(`inference/`); the host paths are the native OpenMP predictor and the
Python loop over the host trees.

Row sampling (`GBDT::bagging`) follows the JAX booster: bagging and
balanced bagging draw a host mask from NumPy's `RandomState(bagging_seed)`
every `bagging_freq` iterations and put it on the device; GOSS keeps the
top rows by |g·h| and samples the rest with the threefry stream keyed by
the absolute iteration, rescaling them.  The mask (padding folded in) is
the growth engines' row mask.  `feature_fraction` draws a per-tree column
mask from `RandomState(feature_fraction_seed)`; extra-trees and
`feature_fraction_bynode` draw per leaf scan inside the engines, their
keys folded with the absolute iteration.  `continue_from` adopts an
earlier model's trees and seeds the scores with its predictions;
`rollback_one_iter` drops the last iteration's trees.

Training metrics are evaluated on the booster's device, one packed
transfer per tick (`ops/metrics.py` DeviceEval).  Validation sets keep
float64 scores on the host, advanced per finished tree by the leaf ids of
a bin-space traversal of their bin codes, which are put on the device
once (`leaf_index_bin_space`); the host `Metric` classes evaluate them.

The split scan carries categorical features, basic monotone constraints,
path smoothing and CEGB's split and coupled penalties; a booster-level
vector of the features earlier trees used carries CEGB's coupled
penalty from tree to tree.

The port covers binary logloss on dense data with the wave and
leaf-wise engines and quantized gradients.  Every parameter whose
behaviour it does not carry raises NotImplementedError naming the
ROADMAP item that brings it, so the port never quietly trains a
different model.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..inference import DevicePredictor
from ..io.binning import BIN_CATEGORICAL, MISSING_NAN, MISSING_ZERO
from ..io.dataset import Dataset
from ..learner import (FeatureMeta, GrowParams, grow_tree_impl,
                       grow_tree_wave_impl)
from ..metric import Metric
from ..models.tree import K_CATEGORICAL_MASK, Tree, _to_bitset
from ..native import PackedPredictor, SingleRowFastPredictor, predictor_lib
from ..objective import ObjectiveFunction
from ..ops.histogram import wave_part_plan, wave_slot_pad
from ..ops.split import SplitParams, cat_bitset_words, leaf_output
from ..utils import log
from ..utils import random as jrandom
from ..utils.device import resolve_device
from ..utils.timer import global_timer

K_EPSILON = 1e-15
_PAD = 1024  # row padding multiple (a multiple of the kernels' row tile)


def check_slice(config: Config) -> None:
    """Refuse every option this slice of the port does not carry."""
    c = config

    def refuse(what: str, item: str) -> None:
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP Queue 1 item {item}); "
            "the PyTorch port trains binary logloss on the wave and "
            "leaf-wise engines")

    if c.objective != "binary":
        refuse(f"objective={c.objective!r}", "14")
    if c.boosting != "gbdt":
        refuse(f"boosting={c.boosting!r}", "14")
    if any(int(m) != 0 for m in (c.monotone_constraints or [])):
        method = c.monotone_constraints_method
        if method not in ("basic", "intermediate", "advanced"):
            log.fatal(f"Unknown monotone_constraints_method {method!r}")
        if method != "basic":
            refuse(f"monotone_constraints_method={method}", "13")
    if c.interaction_constraints:
        refuse("interaction constraints", "5")
    if c.forcedsplits_filename:
        refuse("forced splits", "5")
    if c.cegb_penalty_feature_lazy:
        refuse("cegb_penalty_feature_lazy", "13")
    if c.linear_tree:
        refuse("linear trees", "14")
    if c.tpu_growth_strategy not in ("auto", "wave", "leafwise"):
        raise ValueError(f"Unknown tpu_growth_strategy "
                         f"{c.tpu_growth_strategy!r}; expected auto, wave, "
                         "or leafwise")
    if c.tree_learner not in ("serial",):
        refuse(f"tree_learner={c.tree_learner!r}", "15")


def discretize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                         num_bins: int, const_hess: bool,
                         key: Optional[torch.Tensor] = None):
    """Quantize one class's gradients (ref: gradient_discretizer.cpp:120-160
    DiscretizeGradients; port of the JAX booster's `_disc`, gbdt.py:841).

    grad and hess are snapped to the grids gscale = max|grad| / (bins/2)
    and hscale = max|hess| / bins (max|hess| under a constant hessian,
    where every hessian becomes one step).  With a `key` (stochastic
    rounding) the noise is `uniform(split(key))`, the JAX stream bit for
    bit; without one it is 0.5.  Integers come from truncation toward
    zero, with the noise signed by the gradient's sign (round away from
    zero), as static_cast<int8_t> does in the reference.

    Returns (grad on the grid, hess on the grid, scales [2] float32).
    """
    qhalf = max(num_bins // 2, 1)
    gscale = torch.clamp(grad.abs().max(), min=1e-35) / qhalf
    hmax = torch.clamp(hess.abs().max(), min=1e-35)
    hscale = hmax if const_hess else hmax / num_bins
    if key is not None:
        kg, kh = jrandom.split(key)
        rg = jrandom.uniform(kg, grad.shape, device=grad.device)
        rh = jrandom.uniform(kh, hess.shape, device=hess.device)
    else:
        rg = rh = 0.5
    gi = torch.trunc(grad / gscale + torch.sign(grad) * rg)
    hi = (torch.ones_like(hess) if const_hess
          else torch.trunc(hess / hscale + rh))
    return gi * gscale, hi * hscale, torch.stack([gscale, hscale])


def goss_sample(grad: torch.Tensor, hess: torch.Tensor,
                pad_mask: torch.Tensor, key: torch.Tensor, top_k: int,
                other_k: int):
    """Gradient one-side sampling (ref: goss.hpp:118-165; port of the JAX
    booster's `_goss_sample`, gbdt.py:53): keep the top_k rows by
    Σ_k |g·h|, keep each other row with probability other_k / rest and
    scale its gradients by rest / other_k.  Every step is float32, as in
    the JAX package, so the same float32 inputs give the same rows and
    the same bits.  grad, hess: [K, n]; returns (keep mask [n] float32,
    grad, hess)."""
    imp = (grad * hess).abs().sum(0) * pad_mask
    thr = torch.topk(imp, top_k).values[-1]
    real = pad_mask > 0
    is_top = (imp >= thr) & real
    rest = pad_mask.sum() - is_top.to(torch.float32).sum()
    prob = other_k / torch.clamp(rest, min=1.0)
    u = jrandom.uniform(key, imp.shape, device=imp.device)
    sampled = (u < prob) & ~is_top & real
    scale = torch.where(sampled, rest / other_k,
                        torch.ones((), dtype=torch.float32,
                                   device=imp.device))
    keep = (is_top | sampled).to(grad.dtype)
    return keep, grad * scale[None, :], hess * scale[None, :]


def renew_leaf_values(leaf_value: torch.Tensor, leaf_id: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      mask: torch.Tensor, params: SplitParams):
    """Leaf outputs recomputed from the float gradients after quantized
    growth (ref: gradient_discretizer.cpp RenewIntGradTreeOutput; port of
    the JAX booster's `_renew`, gbdt.py:870).  Leaf sums are taken in
    float64, so CPU and CUDA agree.  Leaves with no hessian keep their
    value."""
    L = leaf_value.shape[0]
    ids = leaf_id.to(torch.int64).clamp(0, L - 1)
    f64 = torch.float64

    def leaf_sum(v):
        return torch.zeros(L, dtype=f64, device=v.device).index_add_(
            0, ids, (v * mask).to(f64)).to(torch.float32)

    sg, sh = leaf_sum(grad), leaf_sum(hess)
    out = leaf_output(sg, sh, torch.zeros_like(sg), 0.0, params)
    return torch.where(sh > 0, out, leaf_value)


def tree_depth(tree: Tree) -> int:
    """Depth of the deepest leaf, from the child arrays (the number of
    steps a traversal from the root takes)."""
    ni = tree.num_leaves - 1
    depth, stack = 0, [(0, 0)] if ni > 0 else []
    while stack:
        node, d = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                stack.append((int(child), d + 1))
            else:
                depth = max(depth, d + 1)
    return depth


def leaf_index_bin_space(tree: Tree, binned: torch.Tensor,
                         missing_type: np.ndarray, num_bin: np.ndarray,
                         default_bin: np.ndarray) -> torch.Tensor:
    """Leaf index of every row of `binned` [F_used, n] (bin codes on the
    device) for a host tree trained on the same bin mappers: the
    bin-space traversal of the JAX package (boosting/gbdt.py:104
    leaf_index_bin_space; ref: dense_bin.hpp:346-366 SplitInner and
    tree.h:372 CategoricalDecision), `tree_depth` steps of elementwise
    torch with no host synchronization.  The feature metadata are the
    host arrays of the used features; each node's row of one table
    carries its feature's offset into `binned`, threshold, default
    direction, the bin code that means missing (-1 for none), its
    children, whether it is categorical, and, for a categorical node,
    its bins-left bitset (`cat_threshold_inner`, zero-padded to the
    widest node's words): a bin goes left when its bit is set.  A step
    gathers one row per data row."""
    n = binned.shape[1]
    dev = binned.device
    nl = tree.num_leaves
    if nl <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    ni = nl - 1
    sf = tree.split_feature_inner[:ni].astype(np.int64)
    mt = missing_type[sf]
    miss = np.where(mt == MISSING_NAN, num_bin[sf] - 1,
                    np.where(mt == MISSING_ZERO, default_bin[sf], -1))
    is_cat = (tree.decision_type[:ni] & K_CATEGORICAL_MASK) > 0
    cols = [sf * n, tree.threshold_in_bin[:ni],
            (tree.decision_type[:ni] & 2) > 0, miss, tree.left_child[:ni],
            tree.right_child[:ni], is_cat]
    W = 0
    if is_cat.any():
        cb = np.asarray(tree.cat_boundaries_inner, np.int64)
        ct = np.asarray(tree.cat_threshold_inner, np.int64)
        W = int(np.diff(cb).max())
        words = np.zeros((ni, W), np.int64)
        for nd in np.nonzero(is_cat)[0]:
            ci = int(tree.threshold_in_bin[nd])
            seg = ct[cb[ci]:cb[ci + 1]]
            words[nd, :len(seg)] = seg
        cols += list(words.T)
    table = torch.from_numpy(np.stack(cols, 1).astype(np.int64)).to(dev)
    rows = torch.arange(n, device=dev)
    flat = binned.reshape(-1)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree_depth(tree)):
        t = table[node.clamp(min=0)]
        b = flat[t[:, 0] + rows]
        go_left = torch.where(b == t[:, 3], t[:, 2] > 0, b <= t[:, 1])
        if W:
            bl = b.to(torch.int64)
            wi = bl // 32
            word = torch.gather(t[:, 7:], 1, wi.clamp(max=W - 1)[:, None])
            cat_left = (wi < W) & (((word[:, 0] >> (bl % 32)) & 1) > 0)
            go_left = torch.where(t[:, 6] > 0, cat_left, go_left)
        node = torch.where(node >= 0,
                           torch.where(go_left, t[:, 4], t[:, 5]), node)
    return (~node).to(torch.int32)


def wave_fits(num_features: int, max_bin: int, num_leaves: int) -> bool:
    """The wave kernels' shared-memory tiles hold one slot's histograms of
    one feature and the partition holds the slot counters (the analogue
    of the JAX package's VMEM gate `wave_pallas_vmem_ok`).  K1's 8-byte
    cells are the widest, so its plan decides for K2 too."""
    if num_features < 1:
        return False
    try:
        wave_part_plan(1, num_features, max_bin, 2, wave_slot_pad(num_leaves))
    except ValueError:
        return False
    return True


class GBDT:
    """ref: src/boosting/gbdt.cpp GBDT."""

    def __init__(self):
        self.models_: List[Tree] = []
        self.iter_ = 0
        # iterations of an init model (continue_from); with iter_ it keys
        # the threefry streams (quantization, GOSS, extra-trees, bynode)
        self.num_init_iteration_ = 0
        self.config: Optional[Config] = None
        self.train_data: Optional[Dataset] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.num_tree_per_iteration = 1
        self.average_output_ = False
        # the torch device of training and prediction: set by init, or by
        # Booster for a loaded model
        self.device: Optional[torch.device] = None
        # prediction caches (native pack, DevicePredictor), keyed by the
        # model slice, len(models_) and the in-place mutation count
        self._model_mutations = 0
        self._packed_pred = None
        self._device_pred = None
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[Dataset] = []
        self.valid_metrics: List[List[Metric]] = []
        # float64 [K, n] host scores of each valid set, and its bin codes
        # on the booster's device
        self.valid_scores: List[np.ndarray] = []
        self.valid_bins: List[torch.Tensor] = []
        self._device_eval = None    # ops.metrics.DeviceEval, built lazily
        self._grad_ok = None        # device flag: every gradient finite
        self._finite_cache = None   # (grads_finite, scores_finite) of iter

    # ------------------------------------------------------------------ init
    def init(self, config: Config, train_data: Dataset,
             objective: Optional[ObjectiveFunction],
             metrics: Sequence[Metric] = ()) -> None:
        check_slice(config)
        self.device = resolve_device(config.device_type)
        dev = self.device
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.train_metrics = list(metrics)
        self.shrinkage_rate = config.learning_rate
        self.num_tree_per_iteration = (objective.num_model_per_iteration()
                                       if objective is not None
                                       else config.num_class)
        self.num_data = n = train_data.num_data
        self.n_pad = (n + _PAD - 1) // _PAD * _PAD

        binned = train_data.binned
        on_device = isinstance(binned, torch.Tensor)
        if config.enable_bundle and train_data.num_features > 1:
            # EFB is a device-layout optimization the port does not carry
            # yet: refuse data it would bundle rather than train unbundled.
            # Device-binned data plans from the host bins of the
            # construction sample, never from a pull of the whole matrix.
            from ..io.bundle import plan_bundles
            plan_src = train_data.efb_sample_bins() if on_device else binned
            if plan_src is None:
                plan_src = train_data.binned_host()
            plan = plan_bundles(plan_src, train_data.bin_mappers,
                                train_data.used_features,
                                max_conflict_rate=config.max_conflict_rate)
            if plan.effective:
                raise NotImplementedError(
                    "these features would be bundled (EFB), which is not "
                    "ported yet (ROADMAP Queue 1 item 5); pass "
                    "enable_bundle=false to train without bundling")
        if train_data.max_num_bin > 256:
            raise NotImplementedError(
                "more than 256 bins per feature (max_bin > 256) is not "
                "ported yet (ROADMAP Queue 1 item 2): the histogram kernels "
                "take uint8 bin codes")
        if on_device:
            # device bins (io/device_bin.py, or an earlier booster's
            # padded copy) are padded on the device: no host round trip
            self.binned_dev = torch.zeros((binned.shape[0], self.n_pad),
                                          dtype=torch.uint8, device=dev)
            self.binned_dev[:, :n] = binned[:, :n]
        else:
            host = np.zeros((binned.shape[0], self.n_pad), np.uint8)
            host[:, :n] = binned
            self.binned_dev = torch.from_numpy(host).to(dev)
        # the dataset's device-bins slot now holds the padded device copy
        train_data.binned = self.binned_dev
        pad = np.zeros(self.n_pad, np.float32)
        pad[:n] = 1.0
        self.pad_mask = torch.from_numpy(pad).to(dev)
        # row and column sampling streams (the JAX booster's, gbdt.py:898):
        # the bag mask holds the padding's zeros and starts as all rows
        self._rng_bag = np.random.RandomState(config.bagging_seed)
        self._rng_feat = np.random.RandomState(config.feature_fraction_seed)
        self._bag_mask_host = pad
        self.bag_mask = self.pad_mask

        mt, nb, db, cat = [], [], [], []
        for f in train_data.used_features:
            m = train_data.bin_mappers[f]
            mt.append(m.missing_type)
            nb.append(m.num_bin)
            db.append(m.default_bin)
            cat.append(m.bin_type == BIN_CATEGORICAL)
        self.f_missing_type = np.array(mt, np.int32)
        self.f_num_bin = np.array(nb, np.int32)
        self.f_default_bin = np.array(db, np.int32)
        self.f_is_cat = np.array(cat, bool)
        penalty = np.ones(len(nb), np.float32)
        if config.feature_contri:
            for i, f in enumerate(train_data.used_features):
                if f < len(config.feature_contri):
                    penalty[i] = config.feature_contri[f]
        # monotone constraints and coupled CEGB penalties are indexed by
        # real feature; the scan takes them per used feature
        mono = np.zeros(len(nb), np.int32)
        mc_list = list(config.monotone_constraints or [])
        for i, f in enumerate(train_data.used_features):
            if f < len(mc_list):
                mono[i] = int(mc_list[f])
        has_mono = bool(np.any(mono != 0))
        coupled = np.zeros(len(nb), np.float32)
        if config.cegb_penalty_feature_coupled:
            cp = list(config.cegb_penalty_feature_coupled)
            if len(cp) != train_data.num_total_features:
                log.fatal("cegb_penalty_feature_coupled should be the same "
                          "size as feature number.")
            for i, f in enumerate(train_data.used_features):
                coupled[i] = cp[f]
        # ref: cost_effective_gradient_boosting.hpp IsEnable
        has_cegb = (config.cegb_tradeoff < 1.0
                    or config.cegb_penalty_split > 0.0
                    or bool(config.cegb_penalty_feature_coupled))
        # the features any tree has split on, carried from tree to tree
        self.cegb_used = (torch.zeros(len(nb), dtype=torch.bool, device=dev)
                          if has_cegb else None)
        self.meta = FeatureMeta(
            num_bin=torch.from_numpy(self.f_num_bin).to(dev),
            missing_type=torch.from_numpy(self.f_missing_type).to(dev),
            default_bin=torch.from_numpy(self.f_default_bin).to(dev),
            penalty=torch.from_numpy(penalty).to(dev),
            is_cat=torch.from_numpy(self.f_is_cat).to(dev),
            monotone=torch.from_numpy(mono).to(dev),
            cegb_coupled=torch.from_numpy(coupled).to(dev))
        max_b = int(self.f_num_bin.max()) if len(nb) else 1
        # histogram stack memory guard (HistogramPool analogue): the
        # leaf-wise engine's int64 stack against histogram_pool_size MB
        stack_bytes = config.num_leaves * len(nb) * max_b * 2 * 8
        budget = (config.histogram_pool_size * 1024 * 1024
                  if config.histogram_pool_size > 0 else 512 * 1024 * 1024)
        # quantized histograms (K2) hold exact int32 sums: the grid must
        # fit int8 and n * bins must fit int32; outside the gate the wave
        # engine takes K1 on the dequantized values, as in the JAX package
        quant_bins = (config.num_grad_quant_bins
                      if (config.use_quantized_grad
                          and config.num_grad_quant_bins <= 126
                          and self.n_pad * config.num_grad_quant_bins
                          < 2 ** 31) else 0)
        self.grow_params = GrowParams(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            max_bin=max_b,
            split=SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                min_data_in_leaf=config.min_data_in_leaf,
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                min_gain_to_split=config.min_gain_to_split,
                max_delta_step=config.max_delta_step,
                path_smooth=config.path_smooth,
                has_categorical=bool(self.f_is_cat.any()),
                cat_features=tuple(np.nonzero(self.f_is_cat)[0].tolist()),
                max_cat_to_onehot=config.max_cat_to_onehot,
                max_cat_threshold=config.max_cat_threshold,
                cat_l2=config.cat_l2, cat_smooth=config.cat_smooth,
                min_data_per_group=config.min_data_per_group,
                has_monotone=has_mono,
                monotone_penalty=config.monotone_penalty,
                extra_trees=config.extra_trees,
                extra_seed=config.extra_seed,
                has_cegb=has_cegb,
                cegb_tradeoff=config.cegb_tradeoff,
                cegb_penalty_split=config.cegb_penalty_split),
            wave_tail_halving=config.wave_tail_halving,
            wave_prune=config.wave_prune,
            wave_prune_overshoot=config.wave_prune_overshoot,
            wave_spike_reserve=config.wave_spike_reserve,
            wave_spike_k=config.wave_spike_k,
            use_hist_stack=stack_bytes <= budget,
            quant_bins=quant_bins,
            feature_fraction_bynode=config.feature_fraction_bynode,
            bynode_seed=config.feature_fraction_seed + 1)
        # growth engine (gbdt.py:582-636 of the JAX package): wave when at
        # least 8 leaves and the wave kernels' tile fits, else leaf-wise
        strategy = config.tpu_growth_strategy
        if strategy == "auto":
            strategy = ("wave" if config.num_leaves >= 8
                        and wave_fits(len(nb), max_b, config.num_leaves)
                        else "leafwise")
        self.growth_strategy = strategy
        # only the leaf-wise engine's K4 reads a row-major copy
        self.binned_rm_dev = (self.binned_dev.t().contiguous()
                              if strategy == "leafwise" else None)
        self.col_mask = torch.ones(len(nb), dtype=torch.bool, device=dev)

        self.use_quant = config.use_quantized_grad
        if self.use_quant:
            self._quant_const_hess = bool(
                objective is not None
                and getattr(objective, "is_constant_hessian", False)
                and train_data.metadata.weight is None)
            self._quant_key = jrandom.PRNGKey(config.seed + 5, device=dev)
            self._renew_params = SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                max_delta_step=config.max_delta_step)

        K = self.num_tree_per_iteration
        self.scores = torch.zeros((K, self.n_pad), dtype=torch.float32,
                                  device=dev)
        md = train_data.metadata
        self.has_init_score = md.init_score is not None
        if self.has_init_score:
            init = np.asarray(md.init_score, np.float64).reshape(K, n)
            sc = np.zeros((K, self.n_pad), np.float32)
            sc[:, :n] = init
            self.scores = torch.from_numpy(sc).to(dev)
        self.class_need_train = [True] * K
        if objective is not None:
            objective.init(md, n)
            lab = np.zeros(self.n_pad, np.float32)
            lab[:n] = objective.label
            self.label_dev = torch.from_numpy(lab).to(dev)
            self.weight_dev = None
            if md.weight is not None:
                w = np.zeros(self.n_pad, np.float32)
                w[:n] = md.weight
                self.weight_dev = torch.from_numpy(w).to(dev)
            if getattr(objective, "need_train", True) is False:
                self.class_need_train = [False] * K
        for m in self.train_metrics:
            m.init(md, n)

    def add_valid_data(self, valid_data: Dataset,
                       metrics: Sequence[Metric]) -> None:
        """A validation set (ref: gbdt.cpp AddValidDataset): float64 host
        scores from its init_score, its bin codes on the device once."""
        self.valid_sets.append(valid_data)
        ms = list(metrics)
        for m in ms:
            m.init(valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(ms)
        K = self.num_tree_per_iteration
        sc = np.zeros((K, valid_data.num_data), np.float64)
        md = valid_data.metadata
        if md.init_score is not None:
            init = np.asarray(md.init_score, np.float64)
            sc += (np.tile(init, (K, 1)) if init.ndim == 1 and K > 1
                   else init.reshape(K, -1))
        self.valid_scores.append(sc)
        binned = valid_data.binned
        if isinstance(binned, torch.Tensor):
            vb = binned[:, :valid_data.num_data].to(self.device)
        else:
            vb = torch.from_numpy(np.asarray(binned, np.uint8)).to(
                self.device)
        self.valid_bins.append(vb.contiguous())

    # ---------------------------------------------------- continued training
    def _reconstruct_raw(self, ds: Dataset, bins: torch.Tensor) -> np.ndarray:
        """Raw feature matrix of `ds` for prediction: its kept raw data, else
        each bin's representative value (gbdt.py:905 `_raw_or_reconstruct`
        of the JAX package): exact for trees trained on the same bin
        mappers, whose numerical thresholds are bin upper bounds.  `bins`
        are the set's [F_used, num_data] codes on the device."""
        if ds.raw_data is not None:
            return ds.raw_data
        codes = bins[:, :ds.num_data].cpu().numpy()
        X = np.zeros((ds.num_data, ds.num_total_features))
        for i, f in enumerate(ds.used_features):
            m = ds.bin_mappers[f]
            lut = np.array([m.bin_to_value(b) for b in range(m.num_bin)])
            # missing bins reconstruct to what default_left routes
            if m.missing_type == MISSING_NAN:
                lut[m.num_bin - 1] = np.nan
            elif m.missing_type == MISSING_ZERO:
                lut[m.default_bin] = 0.0
            X[:, f] = lut[np.clip(codes[i], 0, m.num_bin - 1)]
        return X

    def _reconstruct_bin_space(self, tree: Tree) -> None:
        """Bin-space routing fields (split_feature_inner, threshold_in_bin)
        of a tree read from model text, against this run's bin mappers
        (gbdt.py:1583 of the JAX package): the real threshold is the
        upper bound of its bin, so a search recovers the bin."""
        if getattr(tree, "_bin_space_valid", True):
            return
        tree._bin_space_valid = True
        ni = tree.num_leaves - 1
        if ni <= 0:
            return
        ds = self.train_data
        inner_of = {f: i for i, f in enumerate(ds.used_features)}
        cat_mask = (tree.decision_type[:ni] & K_CATEGORICAL_MASK) > 0
        per_ci_bins = {}
        for nd in range(ni):
            f = int(tree.split_feature[nd])
            if f in inner_of:
                tree.split_feature_inner[nd] = inner_of[f]
            mapper = ds.bin_mappers[f]
            if cat_mask[nd]:
                # the model's bitset holds category values; the bin-space
                # one holds this run's bins of those values (gbdt.py
                # :1610-1636 of the JAX package)
                ci = int(tree.threshold[nd])
                tree.threshold_in_bin[nd] = ci
                lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
                cats = [32 * w + j
                        for w, word in enumerate(tree.cat_threshold[lo:hi])
                        for j in range(32) if (word >> j) & 1]
                c2b = getattr(mapper, "categorical_2_bin", {})
                per_ci_bins[ci] = _to_bitset(
                    [c2b[c] for c in cats if c in c2b])
                continue
            ub = np.asarray(mapper.bin_upper_bound, np.float64)
            b = int(np.searchsorted(ub, float(tree.threshold[nd]),
                                    side="left"))
            tree.threshold_in_bin[nd] = min(b, max(mapper.num_bin - 1, 0))
        if tree.num_cat > 0:
            ct_inner, cb_inner = [], [0]
            for ci in range(tree.num_cat):
                ct_inner.extend(per_ci_bins.get(ci, []))
                cb_inner.append(len(ct_inner))
            tree.cat_threshold_inner = ct_inner
            tree.cat_boundaries_inner = cb_inner

    def continue_from(self, prev: "GBDT", train_raw=None,
                      valid_raws=None) -> None:
        """Continued training (gbdt.py:925 of the JAX package; ref:
        application.cpp:94-97, gbdt.h:70 MergeFrom): adopt prev's trees,
        seed the training and valid scores with its raw predictions, and
        count its iterations into the absolute iteration."""
        K = self.num_tree_per_iteration
        if prev.num_tree_per_iteration != K:
            log.fatal("Cannot continue training: the initial model has "
                      f"{prev.num_tree_per_iteration} trees per iteration, "
                      f"this one needs {K}")
        if prev.average_output_ != self.average_output_:
            log.fatal("Cannot continue training across averaging modes "
                      "(rf vs gbdt/dart): tree outputs would be combined "
                      "with the wrong weights")
        self.models_ = [copy.deepcopy(t) for t in prev.models_]
        for t in self.models_:
            self._reconstruct_bin_space(t)
        self.num_init_iteration_ = len(self.models_) // max(K, 1)
        self.iter_ = 0
        self._bump_model_mutations()
        n = self.num_data
        X = (train_raw if train_raw is not None
             else self._reconstruct_raw(self.train_data, self.binned_dev))
        raw = prev.predict_raw(np.asarray(X, np.float64))
        raw = raw[:, None] if raw.ndim == 1 else raw             # [n, K]
        sc = np.zeros((K, self.n_pad), np.float32)
        sc[:, :n] = raw.T.astype(np.float32)
        self.scores = self.scores + torch.from_numpy(sc).to(self.device)
        for vi, vds in enumerate(self.valid_sets):
            vX = (valid_raws[vi] if valid_raws is not None
                  and valid_raws[vi] is not None
                  else self._reconstruct_raw(vds, self.valid_bins[vi]))
            vraw = prev.predict_raw(np.asarray(vX, np.float64))
            vraw = vraw[:, None] if vraw.ndim == 1 else vraw
            self.valid_scores[vi] += vraw.T

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees (ref: gbdt.cpp:443
        RollbackOneIter; the JAX booster's, gbdt.py:2308, which keeps the
        training and valid scores as they are) and the prediction caches
        built from them."""
        K = self.num_tree_per_iteration
        if len(self.models_) >= K:
            del self.models_[-K:]
            self.iter_ -= 1
            self._bump_model_mutations()

    # ------------------------------------------------------------ gradients
    def _boost_from_average(self, class_id: int) -> float:
        """ref: gbdt.cpp:313 BoostFromAverage."""
        cfg, obj = self.config, self.objective
        if self.models_ or self.has_init_score or obj is None:
            return 0.0
        if cfg.boost_from_average or self.train_data.num_features == 0:
            init = obj.boost_from_score(class_id)
            if abs(init) > K_EPSILON:
                self.scores[class_id] += init
                for sc in self.valid_scores:
                    sc[class_id] += init
                log.info(f"Start training from score {init:.6f}")
                return init
        return 0.0

    def _compute_gradients(self):
        """Per-class gradients [K, n_pad] (ref: gbdt.cpp:220 Boosting)."""
        g, h = self.objective.get_gradients(self.scores[0], self.label_dev,
                                            self.weight_dev)
        return g[None, :], h[None, :]

    def _update_bagging(self, grad, hess):
        """Row sampling for this iteration (the JAX booster's
        `_update_bagging`, gbdt.py:1115; ref: bagging.hpp, goss.hpp).
        Returns (row mask [n_pad] on the device, grad, hess).  The streams
        are keyed by the absolute iteration, so continued training
        advances GOSS's; the NumPy bagging stream restarts from its seed
        in each booster, as in the JAX package."""
        cfg = self.config
        n = self.num_data
        abs_iter = self.num_init_iteration_ + self.iter_
        if cfg.data_sample_strategy == "goss":
            # no sampling for the first 1/learning_rate iterations
            if abs_iter < int(1.0 / max(cfg.learning_rate, 1e-10)):
                return self.bag_mask, grad, hess
            key = jrandom.PRNGKey(cfg.bagging_seed + abs_iter,
                                  device=self.device)
            return goss_sample(grad, hess, self.pad_mask, key,
                               max(1, int(n * cfg.top_rate)),
                               max(1, int(n * cfg.other_rate)))
        if (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
                and abs_iter % cfg.bagging_freq == 0):
            mask = np.zeros(self.n_pad, np.float32)
            pos_frac, neg_frac = (cfg.pos_bagging_fraction,
                                  cfg.neg_bagging_fraction)
            if ((pos_frac < 1.0 or neg_frac < 1.0)
                    and self.objective is not None
                    and self.objective.name == "binary"):
                # balanced bagging (ref: bagging.hpp balanced_bagging_)
                lab = np.asarray(self.train_data.metadata.label) > 0
                for cls_mask, frac in ((lab, pos_frac), (~lab, neg_frac)):
                    cls_idx = np.nonzero(cls_mask)[0]
                    take = int(len(cls_idx) * frac)
                    mask[self._rng_bag.choice(cls_idx, take,
                                              replace=False)] = 1.0
            else:
                cnt = int(n * cfg.bagging_fraction)
                mask[self._rng_bag.choice(n, cnt, replace=False)] = 1.0
            self._bag_mask_host = mask
            self.bag_mask = torch.from_numpy(mask).to(self.device)
        return self.bag_mask, grad, hess

    def _col_mask(self) -> torch.Tensor:
        """Per-tree feature_fraction mask [F_used] (gbdt.py:1157 of the JAX
        package; ref: col_sampler.hpp ResetByTree)."""
        cfg = self.config
        if cfg.feature_fraction >= 1.0:
            return self.col_mask
        F = self.train_data.num_features
        cnt = max(1, int(round(F * cfg.feature_fraction)))
        mask = np.zeros(F, bool)
        mask[self._rng_feat.choice(F, cnt, replace=False)] = True
        return torch.from_numpy(mask).to(self.device)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; returns True when training should stop
        (ref: gbdt.cpp:338 TrainOneIter)."""
        K = self.num_tree_per_iteration
        # the sentinel flags fetched for the previous iteration are stale
        self._finite_cache = None
        init_scores = [0.0] * K
        if gradients is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            with global_timer.scope("GBDT::gradients"):
                grad, hess = self._compute_gradients()
                grad, hess = global_timer.block((grad, hess))
            if self.config.nonfinite_check_freq > 0:
                # device flag, accumulated with no host synchronization;
                # the engine's sentinel fetches it (gradients_finite)
                ok = torch.isfinite(grad).all() & torch.isfinite(hess).all()
                self._grad_ok = (ok if self._grad_ok is None
                                 else self._grad_ok & ok)
        else:
            grad = self._pad_rows(gradients, K)
            hess = self._pad_rows(hessians, K)
        with global_timer.scope("GBDT::bagging"):
            bag_mask, grad, hess = self._update_bagging(grad, hess)
            global_timer.block(bag_mask)
        for k in range(K):
            tree = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                g_k, h_k, qscales = grad[k], hess[k], None
                if self.use_quant:
                    # per-tree discretization keyed by absolute iteration
                    # (the JAX booster's key, gbdt.py:1216-1230)
                    with global_timer.scope("GBDT::discretize"):
                        key = None
                        if self.config.stochastic_rounding:
                            key = jrandom.fold_in(
                                self._quant_key,
                                (self.num_init_iteration_ + self.iter_) * K
                                + k)
                        g_k, h_k, qscales = discretize_gradients(
                            g_k, h_k, self.config.num_grad_quant_bins,
                            self._quant_const_hess, key)
                # the per-scan draws' keys advance with the absolute
                # iteration (gbdt.py:1242-1248 of the JAX package)
                extra_tag = None
                if (self.config.extra_trees
                        or self.config.feature_fraction_bynode < 1.0):
                    extra_tag = (self.num_init_iteration_ + self.iter_) * K + k
                with global_timer.scope("GBDT::col_sampling"):
                    col_mask = self._col_mask()
                with global_timer.scope("GBDT::grow_tree"):
                    if self.growth_strategy == "wave":
                        arrays, leaf_id = grow_tree_wave_impl(
                            self.binned_dev, g_k, h_k, bag_mask, col_mask,
                            self.meta, self.grow_params,
                            quant_scales=(qscales
                                          if self.grow_params.quant_bins > 0
                                          else None),
                            extra_tag=extra_tag, cegb_used=self.cegb_used)
                    else:
                        arrays, leaf_id = grow_tree_impl(
                            self.binned_dev, g_k, h_k, bag_mask, col_mask,
                            self.meta, self.grow_params,
                            binned_rm=self.binned_rm_dev,
                            extra_tag=extra_tag, cegb_used=self.cegb_used)
                    global_timer.block(leaf_id)
                if self.cegb_used is not None:
                    # the tree's split features become used (gbdt.py:1270
                    # of the JAX package)
                    self.cegb_used[arrays.split_feature[
                        :arrays.num_leaves - 1].to(torch.int64)] = True
                if self.use_quant and self.config.quant_train_renew_leaf:
                    # leaf outputs from the float gradients (gbdt.py:1494),
                    # summed over the bagging mask (the whole data under
                    # GOSS, whose rescaled gradients they are)
                    arrays = arrays._replace(leaf_value=renew_leaf_values(
                        arrays.leaf_value, leaf_id, grad[k], hess[k],
                        self.bag_mask, self._renew_params))
                with global_timer.scope("GBDT::finalize_tree"):
                    tree = self._finalize_tree(arrays, leaf_id, k,
                                               init_scores[k])
            if tree is None:
                # no split: the reference's stop (gbdt.cpp:338-418); the
                # first iteration keeps a constant stump
                log.warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                if not self.models_:
                    self.models_.append(self._make_const_stump(k))
                return True
            self.models_.append(tree)
        self.iter_ += 1
        return False

    def _pad_rows(self, values, K: int) -> torch.Tensor:
        a = np.asarray(values, np.float32).reshape(K, -1)
        out = np.zeros((K, self.n_pad), np.float32)
        out[:, :a.shape[1]] = a
        return torch.from_numpy(out).to(self.device)

    def _make_const_stump(self, k: int) -> Tree:
        """One-leaf tree for a class with no first-iteration split
        (ref: gbdt.cpp:372-391)."""
        tree = Tree(2)
        tree.num_leaves = 1
        init = 0.0
        if (self.objective is not None
                and not self.config.boost_from_average
                and not self.has_init_score):
            init = self.objective.boost_from_score(k)
            self.scores[k] += init
            for sc in self.valid_scores:
                sc[k] += init
        tree.leaf_value[0] = init
        tree.shrinkage = 1.0
        return tree

    # ------------------------------------------------------------ tree pull
    def _pack_tree(self, t) -> torch.Tensor:
        """The whole tree as ONE flat float32 buffer (int arrays ride
        along bit-exactly), so the host pulls it in one transfer."""
        def bits(a):
            return a.to(torch.int32).view(torch.float32)
        num = torch.tensor([t.num_leaves], dtype=torch.int32,
                           device=t.leaf_value.device)
        return torch.cat([
            bits(num), bits(t.split_feature), bits(t.threshold_bin),
            bits(t.default_left), t.split_gain, bits(t.left_child),
            bits(t.right_child), t.internal_value, t.internal_weight,
            bits(t.internal_count), t.leaf_value, t.leaf_weight,
            bits(t.leaf_count), bits(t.leaf_parent), bits(t.leaf_depth),
            bits(t.split_is_cat), bits(t.cat_bitset.reshape(-1))])

    def _packed_to_tree(self, flat: np.ndarray) -> Optional[Tree]:
        """Decode the packed flat tree buffer into a host Tree (None when
        the tree grew no split)."""
        ints = flat.view(np.int32)
        L = self.config.num_leaves
        ni = max(L - 1, 1)
        W = cat_bitset_words(self.grow_params.max_bin)
        parts = []
        off = 1
        for size, is_int in ((ni, True), (ni, True), (ni, True),
                             (ni, False), (ni, True), (ni, True),
                             (ni, False), (ni, False), (ni, True),
                             (L, False), (L, False), (L, True),
                             (L, True), (L, True), (ni, True),
                             (ni * W, True)):
            parts.append(ints[off:off + size] if is_int
                         else flat[off:off + size])
            off += size
        (split_feature, threshold_bin, default_left, split_gain,
         left_child, right_child, internal_value, internal_weight,
         internal_count, leaf_value, leaf_weight, leaf_count,
         leaf_parent, leaf_depth, split_is_cat, cat_bits) = parts
        cat_bits = cat_bits.reshape(ni, W).astype(np.uint32)
        num_leaves = int(ints[0])
        if num_leaves <= 1:
            return None
        ds = self.train_data
        tree = Tree(max(L, 2))
        tree.num_leaves = num_leaves
        ni = num_leaves - 1
        sf_inner = split_feature[:ni]
        thr_bin = threshold_bin[:ni]
        dleft = default_left[:ni] != 0
        tree.split_feature_inner[:ni] = sf_inner
        tree.split_feature[:ni] = np.array(
            [ds.used_features[f] for f in sf_inner], np.int32)
        tree.threshold_in_bin[:ni] = thr_bin
        for i in range(ni):
            mapper = ds.bin_mappers[tree.split_feature[i]]
            if split_is_cat[i]:
                # the bins-left bitset becomes the category set (gbdt.py
                # :1418-1437 of the JAX package)
                words = cat_bits[i]
                bins_left = [b for b in range(mapper.num_bin)
                             if (words[b // 32] >> (b % 32)) & 1]
                cats_left = [mapper.bin_2_categorical[b] for b in bins_left
                             if mapper.bin_2_categorical[b] >= 0]
                tree.register_cat_split(i, bins_left, cats_left,
                                        mapper.missing_type)
                continue
            tree.threshold[i] = mapper.bin_to_value(int(thr_bin[i]))
            dt = 0
            if dleft[i]:
                dt |= 2
            dt |= (mapper.missing_type & 3) << 2
            tree.decision_type[i] = dt
        tree.split_gain[:ni] = split_gain[:ni]
        tree.left_child[:ni] = left_child[:ni]
        tree.right_child[:ni] = right_child[:ni]
        tree.internal_value[:ni] = internal_value[:ni]
        tree.internal_weight[:ni] = internal_weight[:ni]
        tree.internal_count[:ni] = internal_count[:ni]
        nl = num_leaves
        tree.leaf_value[:nl] = leaf_value[:nl]
        tree.leaf_weight[:nl] = leaf_weight[:nl]
        tree.leaf_count[:nl] = leaf_count[:nl]
        tree.leaf_parent[:nl] = leaf_parent[:nl]
        tree.leaf_depth[:nl] = leaf_depth[:nl]
        return tree

    def _finalize_tree(self, arrays, leaf_id, class_id: int,
                       init_score: float) -> Optional[Tree]:
        """Shrink, update the scores on the device and pull the tree
        (ref: gbdt.cpp:395-407)."""
        lv = arrays.leaf_value
        delta = (lv * self.shrinkage_rate)[
            leaf_id.to(torch.int64).clamp(0, lv.shape[0] - 1)]
        self.scores[class_id] += delta * self.pad_mask
        tree = self._packed_to_tree(self._pack_tree(arrays).cpu().numpy())
        if tree is None:
            return None
        tree.apply_shrinkage(self.shrinkage_rate)
        # valid scores on the host, before the init score joins the
        # first tree's leaves (gbdt.py:1543 of the JAX package)
        for vi in range(len(self.valid_sets)):
            self._add_valid_tree_score(vi, tree, class_id)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        return tree

    def _tree_leaf_ids(self, tree: Tree, vi: int) -> np.ndarray:
        """Leaf index of every row of valid set `vi` (the traversal runs
        on the booster's device; one transfer of the ids)."""
        ids = leaf_index_bin_space(tree, self.valid_bins[vi],
                                   self.f_missing_type, self.f_num_bin,
                                   self.f_default_bin)
        return ids.cpu().numpy()

    def _add_valid_tree_score(self, vi: int, tree: Tree,
                              class_id: int) -> None:
        """valid score += the tree's leaf outputs, in float64 on the host
        (gbdt.py:1673-1681 of the JAX package)."""
        vids = self._tree_leaf_ids(tree, vi)
        self.valid_scores[vi][class_id] += tree.leaf_value[vids]

    # ------------------------------------------------------------ eval
    def _ensure_finite_flags(self):
        """(gradients_finite, scores_finite) for the current iteration:
        from the eval tick's packed transfer when one ran, else one
        dedicated transfer of a [2] vector."""
        if self._finite_cache is None:
            flag = (self._grad_ok if self._grad_ok is not None
                    else torch.tensor(True, device=self.device))
            flags = torch.stack([
                flag.to(torch.float32),
                torch.isfinite(self.scores).all().to(torch.float32)])
            flags = flags.cpu().numpy()
            self._finite_cache = (bool(flags[0] > 0), bool(flags[1] > 0))
        return self._finite_cache

    def gradients_finite(self) -> bool:
        """Every gradient since training began was finite (the engine's
        sentinel)."""
        return self._ensure_finite_flags()[0]

    def scores_finite(self) -> bool:
        """Every training score is finite (the engine's sentinel)."""
        return self._ensure_finite_flags()[1]

    def eval_train(self):
        """Training metrics: one device tick (ops/metrics.py DeviceEval),
        or the host Metric classes on the pulled scores when the metric
        set has no full device form or `device_eval=false`."""
        de = self._device_eval
        if de is None:
            from ..ops.metrics import DeviceEval
            de = self._device_eval = DeviceEval(self)
        if de.ok:
            if not de._plans:
                return []
            out, grads_ok, scores_ok = de.run(self.scores, self._grad_ok)
            # the sentinel flags rode the packed transfer
            self._finite_cache = (grads_ok, scores_ok)
            return out
        score = self.scores[:, :self.num_data].cpu().numpy().astype(
            np.float64)
        return self._eval(score, self.train_metrics)

    def eval_valid(self, idx: int):
        return self._eval(self.valid_scores[idx], self.valid_metrics[idx])

    def _eval(self, score, metrics):
        out = []
        sc = score[0] if score.shape[0] == 1 else score
        for m in metrics:
            out.extend(m.eval(sc, self.objective))
        return out

    # ------------------------------------------------------------ predict
    def _bump_model_mutations(self) -> None:
        """Invalidate the packed/device predictor caches after a change of
        the trees that `len(models_)` cannot see: a rollback followed by
        new trees, adopted trees, and later in-place mutations (DART
        re-weighting, refit, set_leaf_output: ROADMAP item 14).  Serving
        a model mid-mutation must repack, never reuse stale leaf
        values."""
        self._model_mutations += 1

    def _slice_end(self, start_iteration: int, num_iteration: int) -> int:
        K = self.num_tree_per_iteration
        total_iters = len(self.models_) // max(K, 1)
        if num_iteration is None or num_iteration < 0:
            num_iteration = total_iters - start_iteration
        return min(start_iteration + num_iteration, total_iters)

    def _packed_for(self, start_iteration: int, end: int, K: int):
        """Cached native PackedPredictor for a model slice, invalidated by
        growth (len) and in-place mutation (_model_mutations)."""
        if predictor_lib() is None:
            return None
        key = (start_iteration, end, len(self.models_),
               self._model_mutations)
        cached = self._packed_pred
        if cached is None or cached[0] != key:
            cached = (key, PackedPredictor(
                self.models_[start_iteration * K:end * K]))
            self._packed_pred = cached
        packed = cached[1]
        return packed if packed.ok else None

    def make_single_row_fast(self, num_features: int,
                             start_iteration: int = 0,
                             num_iteration: int = -1,
                             raw_score: bool = False):
        """Cached single-row fast predictor (ref: c_api.h:1350
        LGBM_BoosterPredictForMatSingleRowFastInit): pack once, reuse
        buffers per call.  None when the native predictor is unavailable
        (linear trees / no compiler)."""
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        packed = self._packed_for(start_iteration, end, K)
        if packed is None:
            return None
        conv = None
        if not raw_score and self.objective is not None:
            conv = self.objective.convert_output_host
        sp = SingleRowFastPredictor(packed, num_features, K,
                                    self.average_output_, convert=conv)
        return sp if sp.ok else None

    def _host_fallback(self, reason: str):
        """One host-fallback decision of the device-predict router, named
        by its KEY (the README's port section lists every key).  Returns
        None for the caller."""
        log.debug(f"device_predict: host fallback ({reason})")
        return None

    def _device_predictor(self, X, start_iteration: int,
                          num_iteration: int):
        """Route decision for device prediction.  Returns
        (DevicePredictor, float32 matrix) ready to serve, or None when
        the host paths must: device_predict=false, auto on a booster
        whose device is not the card, float64 data that is NOT
        losslessly float32-representable (the bit-exact routing argument
        needs float32 inputs; lossless float64 is downcast and served),
        non-float input, linear-tree models and empty slices.  With
        `true` the traversal runs on the booster's device, the CPU
        included."""
        cfg = self.config
        mode = cfg.device_predict if cfg is not None else "false"
        if mode == "false":
            return None
        arr = X if isinstance(X, np.ndarray) else np.asarray(X)
        if arr.dtype == np.float32:
            X32 = arr
        elif arr.dtype == np.float64:
            # one downcast and one compare pass: equal after the round
            # trip (NaN kept as missing) means the float32 traversal
            # routes bit-identically to the float64 host path
            X32 = arr.astype(np.float32)
            if not bool(np.all((X32 == arr) | np.isnan(arr))):
                return self._host_fallback("float64-lossy")
        else:
            return self._host_fallback("non-float-input")
        dev = (self.device if self.device is not None
               else resolve_device(cfg.device_type))
        if mode == "auto" and dev.type != "cuda":
            return None
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        if end <= start_iteration:
            return self._host_fallback("empty-slice")
        dp = self._device_pred_for(start_iteration, end, K, dev)
        # dp.ok is False exactly when the slice cannot pack: linear trees
        # (inference/pack.py) are the one reachable case here
        return (dp, X32) if dp.ok else self._host_fallback("linear-tree")

    def _device_pred_for(self, start_iteration: int, end: int, K: int,
                         device: torch.device):
        """Cached DevicePredictor per model slice, invalidated by growth
        (len) and in-place mutation, mirroring _packed_for."""
        key = (start_iteration, end, len(self.models_),
               self._model_mutations, device)
        cached = self._device_pred
        if cached is None or cached[0] != key:
            obj = self.objective
            cached = (key, DevicePredictor(
                self.models_[start_iteration * K:end * K], num_class=K,
                average=self.average_output_,
                convert=obj.convert_output if obj is not None else None,
                min_bucket=self.config.device_predict_min_bucket,
                device=device))
            self._device_pred = cached
        return cached[1]

    def _device_predict_run(self, dp, X, mode: str,
                            early_stop=None) -> np.ndarray:
        """One device predict dispatch under the `GBDT::predict_device`
        timer scope.  `early_stop=(freq, margin)` runs the device masked
        accumulation (parity with the host early-stop path)."""
        with global_timer.scope("GBDT::predict_device"):
            if mode == "leaf":
                return dp.predict_leaf(X)
            if mode == "raw":
                return dp.predict_raw(X, early_stop=early_stop)
            return dp.predict(X, early_stop=early_stop)

    def _es_tuple(self, pred_early_stop, freq, margin):
        """(freq, margin) when prediction early stopping engages: the
        same gate as the host path's use_es (off under output averaging,
        ref: gbdt_prediction.cpp)."""
        if pred_early_stop and not self.average_output_ and freq > 0:
            return (int(freq), float(margin))
        return None

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1, pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw scores [n] or [n, K] (ref: gbdt_prediction.cpp PredictRaw;
        early stopping per prediction_early_stop.cpp: rows whose margin
        exceeds the threshold every round_period iterations keep their
        partial sum; binary margin = 2|score|, multiclass = top1-top2)."""
        hit = self._device_predictor(X, start_iteration, num_iteration)
        if hit is not None:
            es = self._es_tuple(pred_early_stop, pred_early_stop_freq,
                                pred_early_stop_margin)
            return self._device_predict_run(hit[0], hit[1], "raw", es)
        with global_timer.scope("GBDT::predict"):
            return self._predict_raw_impl(
                X, start_iteration, num_iteration, pred_early_stop,
                pred_early_stop_freq, pred_early_stop_margin)

    def _predict_raw_impl(self, X, start_iteration, num_iteration,
                          pred_early_stop, pred_early_stop_freq,
                          pred_early_stop_margin) -> np.ndarray:
        """The host paths: the native batch predictor (OpenMP over rows),
        else the Python loop over the host trees, which also carries
        early stopping."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        use_es = pred_early_stop and not self.average_output_
        if not use_es and end > start_iteration:
            # the flattened pack is cached per model slice and
            # invalidated by growth and in-place mutation
            packed = self._packed_for(start_iteration, end, K)
            if packed is not None:
                res = packed.predict(X, K, self.average_output_)
                if res is not None:
                    return res[:, 0] if K == 1 else res
        out = np.zeros((K, n))
        active_idx = np.arange(n) if use_es else None
        Xa = X
        for i, it in enumerate(range(start_iteration, end)):
            if use_es and i > 0 and i % pred_early_stop_freq == 0:
                sub = out[:, active_idx]
                if K == 1:
                    margin = 2.0 * np.abs(sub[0])
                else:
                    top2 = np.partition(sub, K - 2, axis=0)[K - 2:]
                    margin = top2[1] - top2[0]
                keep = margin <= pred_early_stop_margin
                active_idx = active_idx[keep]
                if len(active_idx) == 0:
                    break
                # the point of early stopping is SKIPPING work: later
                # trees only traverse the still-active rows
                Xa = X[active_idx]
            for k in range(K):
                pred = self.models_[it * K + k].predict(Xa)
                if use_es:
                    out[k][active_idx] += pred
                else:
                    out[k] += pred
        if self.average_output_ and end > start_iteration:
            out /= end - start_iteration  # ref: gbdt_prediction.cpp:57
        return out[0] if K == 1 else out.T

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False, **pred_kwargs) -> np.ndarray:
        if pred_leaf:
            return self.predict_leaf_index(X, start_iteration, num_iteration)
        if not raw_score and self.objective is not None:
            hit = self._device_predictor(X, start_iteration, num_iteration)
            if hit is not None:
                es = self._es_tuple(
                    pred_kwargs.get("pred_early_stop", False),
                    pred_kwargs.get("pred_early_stop_freq", 10),
                    pred_kwargs.get("pred_early_stop_margin", 10.0))
                # convert_output runs on the device after the sums
                return self._device_predict_run(hit[0], hit[1], "convert",
                                                es)
        raw = self.predict_raw(X, start_iteration, num_iteration,
                               **pred_kwargs)
        if raw_score or self.objective is None:
            return raw
        # host path: the scores are already NumPy; the objective's host
        # converter avoids a round trip through the device
        conv = self.objective.convert_output_host
        if raw.ndim == 2:
            return np.asarray(conv(raw.T)).T
        return np.asarray(conv(raw))

    def predict_leaf_index(self, X: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """Leaf ids [n, trees] (ref: tree.h:422 GetLeaf)."""
        hit = self._device_predictor(X, start_iteration, num_iteration)
        if hit is not None:
            return self._device_predict_run(hit[0], hit[1], "leaf")
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        if end > start_iteration:
            # the native traversal as in predict, returning leaf ids;
            # shares predict_raw's packed-model cache
            packed = self._packed_for(start_iteration, end, K)
            if packed is not None:
                res = packed.predict_leaf(X)
                if res is not None:
                    return res
        cols = []
        for it in range(start_iteration, end):
            for k in range(K):
                cols.append(self.models_[it * K + k].get_leaf_index(X))
        return (np.stack(cols, axis=1) if cols
                else np.zeros((X.shape[0], 0), np.int32))

    # --------------------------------------------------------------- model
    @property
    def num_trees(self) -> int:
        return len(self.models_)

    def current_iteration(self) -> int:
        return len(self.models_) // max(self.num_tree_per_iteration, 1)

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        F = self.train_data.num_total_features if self.train_data else (
            max(int(t.split_feature[:t.num_leaves - 1].max(initial=0))
                for t in self.models_) + 1 if self.models_ else 0)
        out = np.zeros(F)
        for t in self.models_:
            if importance_type == "split":
                out += t.feature_importance_split(F)
            else:
                out += t.feature_importance_gain(F)
        return out
