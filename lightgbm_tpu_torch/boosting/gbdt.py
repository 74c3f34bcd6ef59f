"""GBDT boosting loop (PyTorch port of `lightgbm_tpu/boosting/gbdt.py`,
ref: src/boosting/gbdt.cpp, gbdt.h:37).

Binned data, scores and gradients live on the booster's device (the card
unless `device_type=cpu`).  Each iteration computes the objective's
gradients (quantized when `use_quantized_grad`), grows one tree per class
on the wave or the leaf-wise engine, updates the scores, and pulls the
tree to the host as a `Tree` in one flat transfer (like CUDATree::ToHost,
ref: src/io/cuda/cuda_tree.cpp) for model text and prediction.
Prediction in this port runs the host trees.

The port covers binary logloss on dense numerical data with the wave
and leaf-wise engines and quantized gradients.  Every parameter whose
behaviour it does not carry raises NotImplementedError naming the
ROADMAP item that brings it, so the port never quietly trains a
different model.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.dataset import Dataset
from ..learner import (FeatureMeta, GrowParams, grow_tree_impl,
                       grow_tree_wave_impl)
from ..models.tree import Tree
from ..objective import ObjectiveFunction
from ..ops.histogram import wave_part_plan, wave_slot_pad, wave_tile
from ..ops.split import SplitParams, leaf_output
from ..utils import log
from ..utils import random as jrandom
from ..utils.timer import global_timer

K_EPSILON = 1e-15
_PAD = 1024  # row padding multiple (a multiple of the kernels' row tile)


def resolve_device(device_type: str) -> torch.device:
    """`device_type` -> torch device.  The port runs on the card unless
    the caller asks for the CPU; it never falls back silently."""
    dt = str(device_type).strip().lower()
    if dt in ("cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_type={device_type!r} needs a CUDA device and torch "
                "sees none; pass device_type='cpu' to train on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if dt == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device_type={device_type!r}: the PyTorch port runs "
                     "on 'cuda' (default) or 'cpu'")


def check_slice(config: Config, train_data: Optional[Dataset]) -> None:
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
    if c.data_sample_strategy == "goss":
        refuse("GOSS sampling", "14")
    if c.bagging_freq > 0 and (c.bagging_fraction < 1.0
                               or c.pos_bagging_fraction < 1.0
                               or c.neg_bagging_fraction < 1.0):
        refuse("bagging", "6")
    if c.feature_fraction < 1.0:
        refuse("feature_fraction < 1", "6")
    if c.feature_fraction_bynode < 1.0:
        refuse("feature_fraction_bynode < 1", "11")
    if c.extra_trees:
        refuse("extra_trees", "11")
    if any(int(m) != 0 for m in (c.monotone_constraints or [])):
        refuse("monotone constraints", "3")
    if c.interaction_constraints:
        refuse("interaction constraints", "5")
    if c.forcedsplits_filename:
        refuse("forced splits", "5")
    if (c.cegb_tradeoff < 1.0 or c.cegb_penalty_split > 0.0
            or c.cegb_penalty_feature_coupled
            or c.cegb_penalty_feature_lazy):
        refuse("cost-effective gradient boosting", "13")
    if c.path_smooth > K_EPSILON:
        refuse("path_smooth", "3")
    if c.linear_tree:
        refuse("linear trees", "14")
    if c.tpu_growth_strategy not in ("auto", "wave", "leafwise"):
        raise ValueError(f"Unknown tpu_growth_strategy "
                         f"{c.tpu_growth_strategy!r}; expected auto, wave, "
                         "or leafwise")
    if c.tree_learner not in ("serial",):
        refuse(f"tree_learner={c.tree_learner!r}", "15")
    if train_data is not None:
        if any(train_data.bin_mappers[f].bin_type == BIN_CATEGORICAL
               for f in train_data.used_features):
            refuse("categorical features", "3")


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


def wave_fits(num_features: int, max_bin: int, num_leaves: int) -> bool:
    """The wave kernels' shared-memory tiles hold one slot's histograms of
    one feature and K1's partition holds the slot counters (the analogue
    of the JAX package's VMEM gate `wave_pallas_vmem_ok`)."""
    NL = wave_slot_pad(num_leaves)
    try:
        wave_tile(num_features, max_bin, NL, 2)
        wave_part_plan(1, num_features, max_bin, 2, NL)
    except ValueError:
        return False
    return True


class GBDT:
    """ref: src/boosting/gbdt.cpp GBDT."""

    def __init__(self):
        self.models_: List[Tree] = []
        self.iter_ = 0
        # iterations of a loaded init model (continued training is not
        # ported, so 0); keys the quantization stream like the JAX booster
        self.num_init_iteration_ = 0
        self.config: Optional[Config] = None
        self.train_data: Optional[Dataset] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.num_tree_per_iteration = 1

    # ------------------------------------------------------------------ init
    def init(self, config: Config, train_data: Dataset,
             objective: Optional[ObjectiveFunction]) -> None:
        check_slice(config, train_data)
        self.device = resolve_device(config.device_type)
        dev = self.device
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.shrinkage_rate = config.learning_rate
        self.num_tree_per_iteration = (objective.num_model_per_iteration()
                                       if objective is not None
                                       else config.num_class)
        self.num_data = n = train_data.num_data
        self.n_pad = (n + _PAD - 1) // _PAD * _PAD

        binned = train_data.binned_host()
        if config.enable_bundle and train_data.num_features > 1:
            # EFB is a device-layout optimization the port does not carry
            # yet: refuse data it would bundle rather than train unbundled
            from ..io.bundle import plan_bundles
            plan = plan_bundles(binned, train_data.bin_mappers,
                                train_data.used_features,
                                max_conflict_rate=config.max_conflict_rate)
            if plan.effective:
                raise NotImplementedError(
                    "these features would be bundled (EFB), which is not "
                    "ported yet (ROADMAP Queue 1 item 5); pass "
                    "enable_bundle=false to train without bundling")
        if train_data.max_num_bin > 256:
            raise NotImplementedError("max_bin > 256: the wave kernels take "
                                      "uint8 bin codes")
        host = np.zeros((binned.shape[0], self.n_pad), np.uint8)
        host[:, :n] = binned
        self.binned_dev = torch.from_numpy(host).to(dev)
        self.binned_rm_dev = self.binned_dev.t().contiguous()
        # the dataset's device-bins slot now holds the padded device copy
        train_data.binned = self.binned_dev
        pad = np.zeros(self.n_pad, np.float32)
        pad[:n] = 1.0
        self.pad_mask = torch.from_numpy(pad).to(dev)

        mt, nb, db = [], [], []
        for f in train_data.used_features:
            m = train_data.bin_mappers[f]
            mt.append(m.missing_type)
            nb.append(m.num_bin)
            db.append(m.default_bin)
        self.f_missing_type = np.array(mt, np.int32)
        self.f_num_bin = np.array(nb, np.int32)
        self.f_default_bin = np.array(db, np.int32)
        penalty = np.ones(len(nb), np.float32)
        if config.feature_contri:
            for i, f in enumerate(train_data.used_features):
                if f < len(config.feature_contri):
                    penalty[i] = config.feature_contri[f]
        self.meta = FeatureMeta(
            num_bin=torch.from_numpy(self.f_num_bin).to(dev),
            missing_type=torch.from_numpy(self.f_missing_type).to(dev),
            default_bin=torch.from_numpy(self.f_default_bin).to(dev),
            penalty=torch.from_numpy(penalty).to(dev))
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
                max_delta_step=config.max_delta_step),
            wave_tail_halving=config.wave_tail_halving,
            wave_prune=config.wave_prune,
            wave_prune_overshoot=config.wave_prune_overshoot,
            wave_spike_reserve=config.wave_spike_reserve,
            wave_spike_k=config.wave_spike_k,
            use_hist_stack=stack_bytes <= budget,
            quant_bins=quant_bins)
        # growth engine (gbdt.py:582-636 of the JAX package): wave when at
        # least 8 leaves and the wave kernels' tile fits, else leaf-wise
        strategy = config.tpu_growth_strategy
        if strategy == "auto":
            strategy = ("wave" if config.num_leaves >= 8
                        and wave_fits(len(nb), max_b, config.num_leaves)
                        else "leafwise")
        self.growth_strategy = strategy
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
                log.info(f"Start training from score {init:.6f}")
                return init
        return 0.0

    def _compute_gradients(self):
        """Per-class gradients [K, n_pad] (ref: gbdt.cpp:220 Boosting)."""
        g, h = self.objective.get_gradients(self.scores[0], self.label_dev,
                                            self.weight_dev)
        return g[None, :], h[None, :]

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; returns True when training should stop
        (ref: gbdt.cpp:338 TrainOneIter)."""
        K = self.num_tree_per_iteration
        init_scores = [0.0] * K
        if gradients is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            with global_timer.scope("GBDT::gradients"):
                grad, hess = self._compute_gradients()
                grad, hess = global_timer.block((grad, hess))
        else:
            grad = self._pad_rows(gradients, K)
            hess = self._pad_rows(hessians, K)
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
                with global_timer.scope("GBDT::grow_tree"):
                    if self.growth_strategy == "wave":
                        arrays, leaf_id = grow_tree_wave_impl(
                            self.binned_dev, g_k, h_k, self.pad_mask,
                            self.col_mask, self.meta, self.grow_params,
                            binned_rm=self.binned_rm_dev,
                            quant_scales=(qscales
                                          if self.grow_params.quant_bins > 0
                                          else None))
                    else:
                        arrays, leaf_id = grow_tree_impl(
                            self.binned_dev, g_k, h_k, self.pad_mask,
                            self.col_mask, self.meta, self.grow_params,
                            binned_rm=self.binned_rm_dev)
                    global_timer.block(leaf_id)
                if self.use_quant and self.config.quant_train_renew_leaf:
                    # leaf outputs from the float gradients (gbdt.py:1494)
                    arrays = arrays._replace(leaf_value=renew_leaf_values(
                        arrays.leaf_value, leaf_id, grad[k], hess[k],
                        self.pad_mask, self._renew_params))
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
            bits(t.leaf_count), bits(t.leaf_parent), bits(t.leaf_depth)])

    def _packed_to_tree(self, flat: np.ndarray) -> Optional[Tree]:
        """Decode the packed flat tree buffer into a host Tree (None when
        the tree grew no split)."""
        ints = flat.view(np.int32)
        L = self.config.num_leaves
        ni = max(L - 1, 1)
        parts = []
        off = 1
        for size, is_int in ((ni, True), (ni, True), (ni, True),
                             (ni, False), (ni, True), (ni, True),
                             (ni, False), (ni, False), (ni, True),
                             (L, False), (L, False), (L, True),
                             (L, True), (L, True)):
            parts.append(ints[off:off + size] if is_int
                         else flat[off:off + size])
            off += size
        (split_feature, threshold_bin, default_left, split_gain,
         left_child, right_child, internal_value, internal_weight,
         internal_count, leaf_value, leaf_weight, leaf_count,
         leaf_parent, leaf_depth) = parts
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
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        return tree

    # ------------------------------------------------------------ predict
    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw scores [n] or [n, K] through the host trees (ref:
        gbdt_prediction.cpp PredictRaw)."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        K = self.num_tree_per_iteration
        total_iters = len(self.models_) // K
        if num_iteration < 0:
            num_iteration = total_iters - start_iteration
        end = min(start_iteration + num_iteration, total_iters)
        out = np.zeros((K, n))
        with global_timer.scope("GBDT::predict"):
            for it in range(start_iteration, end):
                for k in range(K):
                    out[k] += self.models_[it * K + k].predict(X)
        return out[0] if K == 1 else out.T

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        raw = self.predict_raw(X, start_iteration, num_iteration)
        if raw_score or self.objective is None:
            return raw
        conv = self.objective.convert_output_host
        if raw.ndim == 2:
            return np.asarray(conv(raw.T)).T
        return np.asarray(conv(raw))

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
