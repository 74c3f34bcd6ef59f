"""Objective functions as elementwise torch maps (PyTorch port of
`lightgbm_tpu/objective.py`; ref: regression_objective.hpp,
binary_objective.hpp, multiclass_objective.hpp, xentropy_objective.hpp).

Each objective is a pair of maps score -> (grad, hess) and score ->
prediction on tensors, plus a host-side boost_from_score (ref:
ObjectiveFunction::BoostFromScore) and, for L1, quantile and MAPE, a
per-leaf output renewal (ref: RenewTreeOutput) that runs on the scores'
device.  Gradients are evaluated in float64 and rounded to float32 once:
the CPU and CUDA exp differ in the last float32 bit, float64 hides that,
so both devices grow the same trees.  Multiclass scores are [K, n] and
softmax runs over the class axis.

The ranking objectives (lambdarank, rank_xendcg) are in `ranking.py`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Config
from .utils import log

_F64 = torch.float64


def _weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                         alpha: float) -> float:
    """ref: regression_objective.hpp:25-90 PercentileFun/WeightedPercentileFun
    (the plain version of `percentile_by_leaf`)."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values, kind="stable")
    v = values[order]
    if weights is None:
        if alpha <= 1.0 / (len(v) + 1):
            return float(v[0])
        if alpha >= len(v) / (len(v) + 1.0):
            return float(v[-1])
        position = alpha * (len(v) + 1)
        idx = int(np.floor(position)) - 1
        frac = position - idx - 1
        return float(v[idx] + frac * (v[idx + 1] - v[idx]))
    w = weights[order].astype(np.float64)
    wsum = w.sum()
    threshold = wsum * alpha
    cum = np.cumsum(w) - w / 2.0
    idx = int(np.searchsorted(cum, threshold, side="right")) - 1
    if idx < 0:
        return float(v[0])
    if idx >= len(v) - 1:
        return float(v[-1])
    frac = (threshold - cum[idx]) / max(cum[idx + 1] - cum[idx], 1e-300)
    return float(v[idx] + frac * (v[idx + 1] - v[idx]))


def percentile_by_leaf(leaf_id: torch.Tensor, values: torch.Tensor,
                       weights: Optional[torch.Tensor], alpha: float,
                       num_leaves: int) -> torch.Tensor:
    """`_weighted_percentile` of `values` within each leaf, on the values'
    device with no host synchronization: float64 [num_leaves], 0 for a
    leaf with no row.  Rows with a negative leaf id (out of the bag) take
    no part.

    One stable sort by (leaf, value): a stable sort by value, then a
    stable sort by leaf, so equal values keep their row order as NumPy's
    stable argsort keeps it (-0.0 is made +0.0 first, since the two
    compare equal there).  Segment bounds come from the per-leaf counts;
    each segment's interpolation is gathered at its bounds.  Unweighted,
    the interpolation runs in the values' dtype, as the NumPy version's
    float32 scalars do; weighted, in float64, its cumulative weights a
    cumulative sum over the sorted rows less each segment's base."""
    dev = values.device
    L = num_leaves
    key = torch.where(leaf_id >= 0, leaf_id.to(torch.int64),
                      torch.full_like(leaf_id, L, dtype=torch.int64))
    vals = values + 0.0
    order = torch.sort(vals, stable=True).indices
    order = order[torch.sort(key[order], stable=True).indices]
    lk = key[order]
    v = vals[order]
    if v.shape[0] == 0:
        return torch.zeros(L, dtype=_F64, device=dev)
    counts = torch.bincount(lk, minlength=L + 1)[:L]
    ends = torch.cumsum(counts, 0)
    starts = ends - counts
    n_seg = counts.to(_F64)
    last = torch.clamp(ends - 1, min=0)
    first = torch.clamp(starts, max=v.shape[0] - 1)
    v_first, v_last = v[first], v[last]
    if weights is None:
        position = alpha * (n_seg + 1.0)
        idx = torch.floor(position).to(torch.int64) - 1
        frac = (position - idx.to(_F64) - 1.0).to(v.dtype)
        lo = torch.clamp(starts + idx, 0, v.shape[0] - 1)
        hi = torch.clamp(lo + 1, max=v.shape[0] - 1)
        mid = v[lo] + frac * (v[hi] - v[lo])
        out = torch.where(alpha <= 1.0 / (n_seg + 1.0), v_first,
                          torch.where(alpha >= n_seg / (n_seg + 1.0),
                                      v_last, mid)).to(_F64)
    else:
        w = weights[order].to(_F64)
        csum = torch.cumsum(w, 0)
        base = torch.where(starts > 0, csum[torch.clamp(starts - 1, min=0)],
                           torch.zeros((), dtype=_F64, device=dev))
        wsum = csum[last] - base
        threshold = wsum * alpha
        in_seg = lk < L
        seg = torch.clamp(lk, max=L - 1)
        cum = csum - base[seg] - w / 2.0
        # searchsorted(cum, threshold, side="right") within the segment:
        # cum does not decrease there, so it is the count of cum <= thr
        le = (in_seg & (cum <= threshold[seg])).to(_F64)
        cnt = torch.zeros(L, dtype=_F64, device=dev).index_add_(0, seg, le)
        idx = cnt.to(torch.int64) - 1
        lo = torch.clamp(starts + idx, 0, v.shape[0] - 1)
        hi = torch.clamp(lo + 1, max=v.shape[0] - 1)
        frac = ((threshold - cum[lo])
                / torch.clamp(cum[hi] - cum[lo], min=1e-300))
        # the step v[hi] - v[lo] in the values' dtype, as NumPy takes it
        mid = v[lo].to(_F64) + frac * (v[hi] - v[lo]).to(_F64)
        out = torch.where(idx < 0, v_first.to(_F64),
                          torch.where(idx >= counts - 1, v_last.to(_F64),
                                      mid))
    return torch.where(counts > 0, out, torch.zeros_like(out))


class ObjectiveFunction:
    """Base (ref: include/LightGBM/objective_function.h)."""

    name = "custom"
    num_model_per_iteration_ = 1
    is_constant_hessian = False
    need_renew_tree_output = False

    def __init__(self, config: Config):
        self.config = config
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None

    def init(self, metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label, dtype=np.float32)
        self.weight = (None if metadata.weight is None
                       else np.asarray(metadata.weight, dtype=np.float32))
        self.num_data = num_data
        self._dev_cache = {}

    def num_model_per_iteration(self) -> int:
        return self.num_model_per_iteration_

    # -- device-side ops ----------------------------------------------------
    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor]):
        """score -> (grad, hess), float32 tensors on score's device."""
        raise NotImplementedError

    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        """Raw score -> prediction space (ref: ObjectiveFunction::ConvertOutput)."""
        return score

    def convert_output_host(self, score: np.ndarray) -> np.ndarray:
        """NumPy mirror of convert_output for host prediction."""
        return score

    # -- host-side ----------------------------------------------------------
    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def renew_tree_output(self, leaf_id: torch.Tensor, score: torch.Tensor,
                          num_leaves: int) -> Optional[torch.Tensor]:
        """Per-leaf output renewal (ref: RenewTreeOutput): leaf_id [n]
        (negative: out of the bag) and score [n] on one device give the
        new outputs, float64 [num_leaves] there, or None."""
        return None

    def _device(self, name: str, device: torch.device):
        """The host array `self.<name>` on `device`, copied once."""
        arr = getattr(self, name)
        if arr is None:
            return None
        key = (name, device)
        if key not in self._dev_cache:
            self._dev_cache[key] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(device)
        return self._dev_cache[key]

    def _renew_percentile(self, leaf_id, score, num_leaves, alpha,
                          weight_name):
        """Per-leaf weighted percentile of the residuals label - score
        (ref: regression_objective.hpp:243-287); the residual takes the
        dtype the reference's NumPy subtraction gives it."""
        dev = score.device
        label = self._device("label", dev)
        resid = label - score
        w = self._device(weight_name, dev)
        return percentile_by_leaf(leaf_id.to(dev), resid, w, alpha,
                                  num_leaves)

    @staticmethod
    def _finish(grad, hess, weight):
        """float64 grad and hess, times the row weight, rounded to
        float32 once."""
        if weight is not None:
            w = weight.to(_F64)
            grad = grad * w
            hess = hess * w
        return grad.to(torch.float32), hess.to(torch.float32)


# ------------------------------------------------------------------ regression
class RegressionL2(ObjectiveFunction):
    """ref: regression_objective.hpp:93 RegressionL2loss."""
    name = "regression"
    # when unweighted; fair, poisson, gamma and tweedie inherit the flag
    # as in the JAX package, whose quantized training reads it (ROADMAP
    # "Divergences of the reference")
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = config.reg_sqrt

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt:
            self.raw_label = self.label
            self.label = (np.sign(self.label) *
                          np.sqrt(np.abs(self.label))).astype(np.float32)

    def get_gradients(self, score, label, weight):
        s = score.to(_F64)
        return self._finish(s - label.to(_F64), torch.ones_like(s), weight)

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score

    def convert_output_host(self, score):
        if self.sqrt:
            return np.sign(score) * score * score
        return score

    def boost_from_score(self, class_id: int = 0) -> float:
        if self.weight is None:
            return float(np.mean(self.label))
        return float(np.sum(self.label * self.weight) / np.sum(self.weight))


class RegressionL1(RegressionL2):
    """ref: regression_objective.hpp:206 RegressionL1loss."""
    name = "regression_l1"
    need_renew_tree_output = True
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False

    def get_gradients(self, score, label, weight):
        s = score.to(_F64)
        return self._finish(torch.sign(s - label.to(_F64)),
                            torch.ones_like(s), weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self.label, self.weight, 0.5)

    def renew_tree_output(self, leaf_id, score, num_leaves):
        """Per-leaf weighted median of residuals (ref: hpp:243-287)."""
        return self._renew_percentile(leaf_id, score, num_leaves, 0.5,
                                      "weight")


class RegressionHuber(RegressionL2):
    """ref: regression_objective.hpp:292 RegressionHuberLoss."""
    name = "huber"
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = config.alpha

    def get_gradients(self, score, label, weight):
        s = score.to(_F64)
        diff = s - label.to(_F64)
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return self._finish(grad, torch.ones_like(s), weight)


class RegressionFair(RegressionL2):
    """ref: regression_objective.hpp:350 RegressionFairLoss."""
    name = "fair"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.c = config.fair_c

    def get_gradients(self, score, label, weight):
        x = score.to(_F64) - label.to(_F64)
        c = self.c
        grad = c * x / (torch.abs(x) + c)
        hess = c * c / (torch.abs(x) + c) ** 2
        return self._finish(grad, hess, weight)


class RegressionPoisson(RegressionL2):
    """ref: regression_objective.hpp:397 RegressionPoissonLoss
    (score is log-rate; grad = exp(f) - y, hess = exp(f) * exp(max_delta_step))."""
    name = "poisson"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.max_delta_step = config.poisson_max_delta_step

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if (self.label < 0).any():
            log.fatal("[poisson]: at least one target label is negative")

    def get_gradients(self, score, label, weight):
        exp_score = torch.exp(score.to(_F64))
        grad = exp_score - label.to(_F64)
        hess = exp_score * float(np.exp(self.max_delta_step))
        return self._finish(grad, hess, weight)

    def convert_output(self, score):
        return torch.exp(score)

    def convert_output_host(self, score):
        return np.exp(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(super().boost_from_score(), 1e-20)))


class RegressionQuantile(RegressionL2):
    """ref: regression_objective.hpp:480 RegressionQuantileloss."""
    name = "quantile"
    need_renew_tree_output = True
    is_constant_hessian = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.sqrt = False
        self.alpha = config.alpha

    def get_gradients(self, score, label, weight):
        s = score.to(_F64)
        delta = s - label.to(_F64)
        one = torch.ones_like(s)
        grad = torch.where(delta >= 0, one * (1.0 - self.alpha),
                           one * -self.alpha)
        return self._finish(grad, one, weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self.label, self.weight, self.alpha)

    def renew_tree_output(self, leaf_id, score, num_leaves):
        return self._renew_percentile(leaf_id, score, num_leaves,
                                      self.alpha, "weight")


class RegressionMAPE(RegressionL1):
    """ref: regression_objective.hpp:578 RegressionMAPELOSS."""
    name = "mape"
    need_renew_tree_output = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.label_weight = (1.0 / np.maximum(1.0, np.abs(self.label))
                             ).astype(np.float32)
        if self.weight is not None:
            self.label_weight = self.label_weight * self.weight

    def get_gradients(self, score, label, weight):
        lab = label.to(_F64)
        lw = 1.0 / torch.clamp(torch.abs(lab), min=1.0)
        if weight is not None:
            lw = lw * weight.to(_F64)
        grad = torch.sign(score.to(_F64) - lab) * lw
        hess = (torch.ones_like(lab) if weight is None
                else weight.to(_F64))
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self, class_id: int = 0) -> float:
        return _weighted_percentile(self.label, self.label_weight, 0.5)

    def renew_tree_output(self, leaf_id, score, num_leaves):
        return self._renew_percentile(leaf_id, score, num_leaves, 0.5,
                                      "label_weight")


class RegressionGamma(RegressionPoisson):
    """ref: regression_objective.hpp:679 RegressionGammaLoss."""
    name = "gamma"

    def get_gradients(self, score, label, weight):
        lab = label.to(_F64)
        exp_neg = torch.exp(-score.to(_F64))
        return self._finish(1.0 - lab * exp_neg, lab * exp_neg, weight)


class RegressionTweedie(RegressionPoisson):
    """ref: regression_objective.hpp:717 RegressionTweedieLoss."""
    name = "tweedie"

    def __init__(self, config: Config):
        super().__init__(config)
        self.rho = config.tweedie_variance_power

    def get_gradients(self, score, label, weight):
        rho = self.rho
        s, lab = score.to(_F64), label.to(_F64)
        e1 = torch.exp((1.0 - rho) * s)
        e2 = torch.exp((2.0 - rho) * s)
        grad = -lab * e1 + e2
        hess = -lab * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._finish(grad, hess, weight)


# ---------------------------------------------------------------------- binary
def _label_is_class(k: int):
    """is_pos of class k for one-vs-all: the label truncated to an int
    equals k, on NumPy arrays and tensors."""
    def is_pos(label):
        if isinstance(label, np.ndarray):
            return label.astype(np.int32) == k
        return label.to(torch.int32) == k
    return is_pos


class BinaryLogloss(ObjectiveFunction):
    """ref: binary_objective.hpp:20 BinaryLogloss."""
    name = "binary"

    def __init__(self, config: Config, is_pos=None):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.is_unbalance = config.is_unbalance
        self.scale_pos_weight = config.scale_pos_weight
        self.is_pos = is_pos or (lambda label: label > 0)
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid parameter {self.sigmoid} should be greater than zero")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        pos = self.is_pos(self.label)
        cnt_pos, cnt_neg = int(pos.sum()), int((~pos).sum())
        w_pos, w_neg = 1.0, 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= self.scale_pos_weight
        self.w_pos, self.w_neg = w_pos, w_neg
        self.cnt_pos, self.cnt_neg = cnt_pos, cnt_neg
        self.need_train = not (cnt_neg == 0 or cnt_pos == 0)
        if not self.need_train:
            log.warning("Contains only one class")

    def get_gradients(self, score, label, weight):
        pos = self.is_pos(label)
        one = torch.ones_like(score, dtype=_F64)
        lv = torch.where(pos, one, -one)
        lw = torch.where(pos, one * self.w_pos, one * self.w_neg)
        response = -lv * self.sigmoid / (
            1.0 + torch.exp(lv * self.sigmoid * score.to(_F64)))
        abs_resp = torch.abs(response)
        grad = (response * lw).to(torch.float32)
        hess = (abs_resp * (self.sigmoid - abs_resp) * lw).to(torch.float32)
        return self._apply_weight(grad, hess, weight)

    @staticmethod
    def _apply_weight(grad, hess, weight):
        if weight is not None:
            grad = grad * weight
            hess = hess * weight
        return grad, hess

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * score))

    def convert_output_host(self, score):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * score))

    def boost_from_score(self, class_id: int = 0) -> float:
        """ref: binary_objective.hpp:139-160."""
        if self.weight is not None:
            suml = float(np.sum(self.is_pos(self.label) * self.weight))
            sumw = float(np.sum(self.weight))
        else:
            suml = float(self.cnt_pos)
            sumw = float(self.num_data)
        pavg = min(max(suml / max(sumw, 1e-300), 1e-10), 1.0 - 1e-10)
        init = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        log.info(f"[{self.name}:BoostFromScore]: pavg={pavg:.6f} -> initscore={init:.6f}")
        return init


# ------------------------------------------------------------------ multiclass
class MulticlassSoftmax(ObjectiveFunction):
    """ref: multiclass_objective.hpp:20 MulticlassSoftmax."""
    name = "multiclass"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration_ = config.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        li = self.label.astype(np.int32)
        if (li < 0).any() or (li >= self.num_class).any():
            log.fatal(f"Label must be in [0, {self.num_class})")
        self.label_int = li
        probs = np.zeros(self.num_class)
        w = self.weight if self.weight is not None else np.ones(num_data)
        np.add.at(probs, li, w)
        self.class_init_probs = probs / w.sum()
        self.factor = self.num_class / (self.num_class - 1.0)

    def get_gradients(self, score, label, weight):
        """score: [K, n]; returns grad/hess [K, n]."""
        p = torch.softmax(score.to(_F64), dim=0)
        classes = torch.arange(self.num_class, device=score.device)
        onehot = (label.to(torch.int32)[None, :] == classes[:, None])
        grad = p - onehot.to(_F64)
        hess = self.factor * p * (1.0 - p)
        return self._finish(grad, hess,
                            None if weight is None else weight[None, :])

    def convert_output(self, score):
        return torch.softmax(score, dim=0)

    def convert_output_host(self, score):
        e = np.exp(score - np.max(score, axis=0, keepdims=True))
        return e / np.sum(e, axis=0, keepdims=True)

    def boost_from_score(self, class_id: int = 0) -> float:
        p = self.class_init_probs[class_id]
        return float(np.log(p)) if p > 0 else -np.inf


class MulticlassOVA(ObjectiveFunction):
    """ref: multiclass_objective.hpp:130 MulticlassOVA (per-class binary)."""
    name = "multiclassova"

    def __init__(self, config: Config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration_ = config.num_class
        self.binary = [BinaryLogloss(config, is_pos=_label_is_class(k))
                       for k in range(config.num_class)]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        for b in self.binary:
            b.init(metadata, num_data)

    def get_gradients(self, score, label, weight):
        gh = [self.binary[k].get_gradients(score[k], label, weight)
              for k in range(self.num_class)]
        return (torch.stack([g for g, _ in gh]),
                torch.stack([h for _, h in gh]))

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-self.binary[0].sigmoid * score))

    def convert_output_host(self, score):
        return 1.0 / (1.0 + np.exp(-self.binary[0].sigmoid * score))

    def boost_from_score(self, class_id: int = 0) -> float:
        return self.binary[class_id].boost_from_score()


# --------------------------------------------------------------- cross-entropy
class CrossEntropy(ObjectiveFunction):
    """Label in [0,1] (ref: xentropy_objective.hpp:29 CrossEntropy)."""
    name = "cross_entropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if (self.label < 0).any() or (self.label > 1).any():
            log.fatal("[cross_entropy]: label must be in [0, 1]")

    def get_gradients(self, score, label, weight):
        p = 1.0 / (1.0 + torch.exp(-score.to(_F64)))
        return self._finish(p - label.to(_F64), p * (1.0 - p), weight)

    def convert_output(self, score):
        return 1.0 / (1.0 + torch.exp(-score))

    def convert_output_host(self, score):
        return 1.0 / (1.0 + np.exp(-score))

    def boost_from_score(self, class_id: int = 0) -> float:
        w = self.weight if self.weight is not None else np.ones_like(self.label)
        pavg = float(np.sum(self.label * w) / np.sum(w))
        pavg = min(max(pavg, 1e-10), 1.0 - 1e-10)
        return float(np.log(pavg / (1.0 - pavg)))


class CrossEntropyLambda(ObjectiveFunction):
    """ref: xentropy_objective.hpp:162 CrossEntropyLambda (weights enter via
    log1p link)."""
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if (self.label < 0).any() or (self.label > 1).any():
            log.fatal("[cross_entropy_lambda]: label must be in [0, 1]")

    def get_gradients(self, score, label, weight):
        s, y = score.to(_F64), label.to(_F64)
        if weight is None:
            z = 1.0 / (1.0 + torch.exp(-s))
            return self._finish(z - y, z * (1.0 - z), None)
        # weighted case (ref: xentropy_objective.hpp:234-250)
        w = weight.to(_F64)
        epf = torch.exp(s)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d2 = c - 1.0
        b = (c / (d2 * d2)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        # a row of weight 0 (the padding rows among them) gives 0/0 above;
        # it contributes nothing (ROADMAP "Divergences of the reference")
        keep = w > 0
        return self._finish(torch.where(keep, grad, 0.0),
                            torch.where(keep, hess, 0.0), None)

    def convert_output(self, score):
        return torch.log1p(torch.exp(score))

    def convert_output_host(self, score):
        return np.log1p(np.exp(score))

    def boost_from_score(self, class_id: int = 0) -> float:
        w = self.weight if self.weight is not None else np.ones_like(self.label)
        pavg = float(np.sum(self.label * w) / np.sum(w))
        pavg = min(max(pavg, 1e-10), 1.0 - 1e-10)
        return float(np.log(pavg / (1.0 - pavg)))


# --------------------------------------------------------------------- factory
_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
}

RANKING = ("lambdarank", "rank_xendcg")


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """ref: src/objective/objective_function.cpp:20 CreateObjectiveFunction."""
    name = config.objective
    if name in ("custom", "", "none"):
        return None
    if name in RANKING:
        from .ranking import create_ranking_objective
        return create_ranking_objective(name, config)
    if name not in _REGISTRY:
        log.fatal(f"Unknown objective type name: {name}")
    return _REGISTRY[name](config)
