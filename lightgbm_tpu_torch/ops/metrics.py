"""Training metrics on the booster's device (PyTorch port of
`lightgbm_tpu/ops/metrics.py`).

An eval tick computes every configured training metric over the device
score buffer and returns ONE packed float32 vector,
`[metric values..., gradients_finite, scores_finite]`, so each tick
costs exactly one device->host transfer, which also carries the flags
of the engine's non-finite sentinel.

The formulas are the host classes' in `metric.py` (which mirror
src/metric/*_metric.hpp), evaluated in float64 on the device.  AUC and
average precision use the EXACT sorted forms (stable descending sort,
equal-score blocks grouped, ref: binary_metric.hpp:159).  Sums must not
depend on the order in which threads add: the JAX package sums tie
groups with a scatter-add, which on CUDA is an unordered float atomic,
so its bits would change from run to run and an AUC tie at the
early-stopping margin could decide differently.  Here the scores are
already sorted, so every group sum is read from a cumulative sum at the
group's bounds, and the cumulative sums run on 64-bit fixed-point
integers (exact, so the same bits whatever order the scan adds in).
The remaining reductions are `torch.sum`, which adds in a fixed order.
Every tick gives the same bits on the same scores.

Coverage: a metric set is evaluated on the device only when EVERY
configured metric has a device form; otherwise, or with
`device_eval=false`, the booster takes the host path for all of them
(mixed evaluation would bring the score fetch back).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..observability.costmodel import eval_cost, global_cost_model
from ..utils import log

_F64 = torch.float64


def _fixed_cumsum(values: torch.Tensor, total: torch.Tensor):
    """Inclusive cumulative sums of non-negative float64 `values`, exact
    in 64-bit fixed point: each value is rounded to the grid 2^-s with
    2^s = 2^61 / 2^ceil(log2 total), so no partial sum overflows, and
    summed as int64.  Returns (cumsum as float64, the grid's scale)."""
    e = torch.ceil(torch.log2(torch.clamp(total, min=1e-300)))
    scale = torch.pow(torch.full_like(total, 2.0), 61.0 - e)
    fixed = torch.round(values * scale).to(torch.int64)
    return torch.cumsum(fixed, 0).to(_F64) / scale, scale


def _tie_bounds(s: torch.Tensor):
    """For scores sorted in descending order: per element the index of
    the first and of the last element of its tie group.  NaN != NaN, so
    NaN scores (sorted last) form singleton groups, as in the host
    class's np.diff boundaries."""
    n = s.shape[0]
    idx = torch.arange(n, device=s.device)
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    last = torch.ones(n, dtype=torch.bool, device=s.device)
    last[:-1] = first[1:]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rev_end = torch.where(last, idx, n - 1).flip(0)
    end = torch.cummin(rev_end, 0).values.flip(0)
    return start, end


def device_exact_auc(score, label, weight):
    """Exact weighted rank-sum AUC (ref: binary_metric.hpp:159
    AUCMetric): stable sort by descending score; an equal-score block
    gives its positives half credit against its negatives, as the host
    class does.  The positives above each block and in it are read from
    one fixed-point cumulative sum at the block's bounds."""
    order = torch.argsort(-score, stable=True)
    lab = label[order] > 0
    ws = weight[order].to(_F64)
    pos_w = torch.where(lab, ws, 0.0)
    neg_w = torch.where(lab, 0.0, ws)
    tp, tn = pos_w.sum(), neg_w.sum()
    cp, _ = _fixed_cumsum(pos_w, tp)
    start, end = _tie_bounds(score[order])
    cp_before = torch.cat([cp.new_zeros(1), cp[:-1]])
    pos_above = cp_before[start]
    grp_pos = cp[end] - pos_above
    accum = torch.sum(neg_w * (pos_above + 0.5 * grp_pos))
    return torch.where((tp == 0) | (tn == 0), torch.ones_like(tp),
                       accum / torch.clamp(tp * tn, min=1e-30))


def device_exact_average_precision(score, label, weight):
    """Exact weighted average precision (ref: binary_metric.hpp
    AveragePrecisionMetric): stable descending sort, cumulative tp/fp
    in fixed point, the host class's formula."""
    order = torch.argsort(-score, stable=True)
    lab = label[order] > 0
    ws = weight[order].to(_F64)
    delta_tp = torch.where(lab, ws, 0.0)
    tp, _ = _fixed_cumsum(delta_tp, ws.sum())
    fp, _ = _fixed_cumsum(torch.where(lab, 0.0, ws), ws.sum())
    prec = tp / torch.clamp(tp + fp, min=1e-20)
    total_pos = delta_tp.sum()
    ap = torch.sum(prec * delta_tp) / torch.clamp(total_pos, min=1e-30)
    return torch.where(total_pos == 0, torch.ones_like(ap), ap)


def _binary_pointwise(name: str, config):
    """Torch pointwise loss over CONVERTED single-class scores, or None:
    `metric.device_pointwise_loss` plus the cross-entropy family (the
    caller handles cross_entropy_lambda, which takes the unmasked
    weight)."""
    from ..metric import device_pointwise_loss
    eps15 = 1e-15
    if name == "cross_entropy":
        return device_pointwise_loss("xentropy", config)
    if name == "kullback_leibler":
        def _kl(p, y):
            p = torch.clamp(p, eps15, 1 - eps15)
            y = torch.clamp(y, eps15, 1 - eps15)
            return (y * torch.log(y / p)
                    + (1 - y) * torch.log((1 - y) / (1 - p)))
        return _kl
    return device_pointwise_loss(name, config)


# metric name -> reduction kind for the single-class plans
_KIND_SQRT = "sqrt"        # weighted avg then sqrt (rmse)
_KIND_AVG = "avg"          # weighted avg (pointwise / sum_weights)
_KIND_MEAN = "mean"        # plain mean over rows (cross_entropy_lambda)
_KIND_AUC = "auc"
_KIND_AP = "average_precision"
_KIND_RANK = ("ndcg", "map")   # per-query plans (sharded eval only)


def build_plans(metrics, config, objective, num_class: int):
    """[(name, kind, loss_fn_or_None)] when EVERY metric has a device
    form, else None.  `metrics` are host Metric instances (their .name
    is the canonical metric name)."""
    plans: List[Tuple[str, str, object]] = []
    for m in metrics:
        name = m.name
        if num_class > 1:
            if name in ("multi_logloss", "multi_error"):
                plans.append((name, name, None))
                continue
            return None
        if name == "auc":
            plans.append((name, _KIND_AUC, None))
            continue
        if name == "average_precision":
            plans.append((name, _KIND_AP, None))
            continue
        if name == "cross_entropy_lambda":
            plans.append((name, _KIND_MEAN, None))
            continue
        fn = _binary_pointwise(name, config)
        if fn is None:
            return None
        plans.append((name, _KIND_SQRT if name == "rmse" else _KIND_AVG,
                      fn))
    return plans


def make_tick_fn(plans, obj, K: int, top_k: int):
    """The packed eval tick: (scores [K, n] float32, label [n], weight
    [n] | None, pad_mask [n], grad_ok bool scalar) -> float32 vector
    [metric values..., gradients_finite, scores_finite], computed in
    float64 on the scores' device with no host synchronization."""

    def _tick(scores, label, weight, pad_mask, grad_ok):
        pm = pad_mask.to(_F64)
        w = pm if weight is None else weight.to(_F64) * pm
        den = torch.sum(w)
        lab = label.to(_F64)
        outs = []
        if K > 1:
            sc = scores.to(_F64)
            prob = obj.convert_output(sc) if obj is not None else sc
            lab_oh = (lab[None, :]
                      == torch.arange(K, dtype=_F64,
                                      device=sc.device)[:, None])
            p_lab = torch.sum(torch.where(lab_oh, prob, 0.0), dim=0)
            for _name, kind, _fn in plans:
                if kind == "multi_logloss":
                    pt = -torch.log(torch.clamp(p_lab, 1e-15, 1.0))
                else:  # multi_error: ties count AGAINST the row
                    # (ref: multiclass_metric.hpp:142 LossOnPoint)
                    num_ge = torch.sum(prob >= p_lab[None, :], dim=0)
                    pt = (num_ge > top_k).to(_F64)
                outs.append(torch.sum(pt * w) / den)
        else:
            sc = scores[0]
            sc64 = sc.to(_F64)
            conv = obj.convert_output(sc64) if obj is not None else sc64
            for _name, kind, fn in plans:
                if kind == _KIND_AUC:
                    # raw scores, like the host class (AUC is rank-based;
                    # the conversion is monotone)
                    outs.append(device_exact_auc(sc, label, w))
                elif kind == _KIND_AP:
                    outs.append(device_exact_average_precision(sc, label, w))
                elif kind == _KIND_MEAN:
                    # cross_entropy_lambda: z from the UNmasked weight,
                    # plain mean (xentropy_metric.hpp)
                    wz = 1.0 if weight is None else weight.to(_F64)
                    z = torch.clamp(1.0 - torch.exp(-wz * conv),
                                    1e-15, 1 - 1e-15)
                    pt = -(lab * torch.log(z)
                           + (1.0 - lab) * torch.log(1.0 - z))
                    outs.append(torch.sum(pt * pm) / torch.sum(pm))
                else:
                    v = torch.sum(fn(conv, lab) * w) / den
                    outs.append(torch.sqrt(v) if kind == _KIND_SQRT else v)
        # the non-finite sentinel's flags ride the same transfer
        outs.append(grad_ok.to(_F64))
        outs.append(torch.isfinite(scores).all().to(_F64))
        return torch.stack(outs).to(torch.float32)

    return _tick


class DeviceEval:
    """One-transfer-per-tick metric evaluator bound to a GBDT's training
    buffers.  `ok` is False when the configuration has no full device
    form (the booster then takes the host path); `fetches` counts
    device->host transfers (one per tick)."""

    def __init__(self, gbdt):
        self.ok = False
        self.fetches = 0
        cfg = gbdt.config
        obj = gbdt.objective
        if str(getattr(cfg, "device_eval", "auto")) == "false":
            return
        if obj is not None and getattr(obj, "run_on_host", False):
            return
        K = gbdt.num_tree_per_iteration
        plans = build_plans(gbdt.train_metrics, cfg, obj, K)
        if plans is None:
            if gbdt.train_metrics:
                log.debug("device_eval: falling back to host metrics "
                          "(a configured metric has no device form)")
            return
        dev = gbdt.device
        md = gbdt.train_data.metadata
        n_pad = gbdt.n_pad
        label = np.zeros(n_pad, np.float32)
        label[:gbdt.num_data] = np.asarray(md.label, np.float32)
        self._label_dev = torch.from_numpy(label).to(dev)
        self._weight_dev = None
        if md.weight is not None:
            w = np.zeros(n_pad, np.float32)
            w[:gbdt.num_data] = np.asarray(md.weight, np.float32)
            self._weight_dev = torch.from_numpy(w).to(dev)
        self._plans = plans
        self._cost = eval_cost(len(plans), K, n_pad, md.weight is not None)
        self._fn = make_tick_fn(plans, obj, K, int(cfg.multi_error_top_k))
        self._pad_mask = gbdt.pad_mask
        self._true_flag = torch.tensor(True, device=dev)
        self.ok = True

    def run(self, scores, grad_ok) -> Tuple[List[Tuple[str, float]],
                                            bool, bool]:
        """Evaluate one tick: returns ([(metric, value)], grads_finite,
        scores_finite) with exactly one device->host transfer."""
        flag = self._true_flag if grad_ok is None else grad_ok
        vec = self._fn(scores, self._label_dev, self._weight_dev,
                       self._pad_mask, flag).cpu().numpy()
        self.fetches += 1
        if global_cost_model.enabled:
            global_cost_model.account("device_eval", *self._cost)
        out = [(name, float(v))
               for (name, _kind, _fn), v in zip(self._plans, vec)]
        return out, bool(vec[-2] > 0), bool(vec[-1] > 0)


class ShardedEval:
    """Training metrics under data-parallel training (the torch form of
    the JAX booster's `_eval_train_sharded`, gbdt.py:1705): every metric
    is a set of sums over this rank's rows, reduced exactly over the
    ranks (`exact_sum`; maxima for the score range), so every rank
    reads the same scalars.  AUC and average precision use the binned
    forms (`metric.device_binned_auc`, 16,384 bins), multiclass
    `multi_logloss`/`multi_error` and `auc_mu` (`device_auc_mu`) their
    sums; a metric with no sharded form is skipped with a warning, as in
    the JAX package.  Labels are the metadata's (original label space).
    The finite flags are all-reduced with the same tick."""

    def __init__(self, gbdt):
        from ..metric import device_pointwise_loss
        self.ok = True
        self.fetches = 0
        self._gbdt = gbdt
        self._net = gbdt.net
        cfg = gbdt.config
        K = gbdt.num_tree_per_iteration
        plans = []
        for m in gbdt.train_metrics:
            name = m.name
            if K > 1:
                if name in ("multi_logloss", "multi_error"):
                    plans.append((name, name, None))
                elif name == "auc_mu":
                    plans.append((name, "auc_mu",
                                  np.asarray(m.class_weights)))
                else:
                    log.warning(f"train metric {name} has no sharded "
                                "device form; skipped under data-parallel "
                                "training")
                continue
            if name in (_KIND_AUC, _KIND_AP):
                plans.append((name, name, None))
                continue
            if name in _KIND_RANK:
                plans.append((name, name, self._rank_plan(m, gbdt)))
                continue
            fn = device_pointwise_loss(name, cfg)
            if fn is None:
                log.warning(f"train metric {name} has no sharded device "
                            "form; skipped under data-parallel training")
                continue
            plans.append((name, _KIND_SQRT if name == "rmse" else _KIND_AVG,
                          fn))
        self._plans = plans
        md = gbdt.train_data.metadata
        dev = gbdt.device
        self._label = torch.from_numpy(gbdt._local_rows(
            np.asarray(md.label, np.float32))).to(dev)
        self._weight = (None if md.weight is None else torch.from_numpy(
            gbdt._local_rows(np.asarray(md.weight, np.float32))).to(dev))
        self._top_k = int(cfg.multi_error_top_k)

    @staticmethod
    def _rank_plan(metric, gbdt):
        """(eval_fn, eval_at, query count) of NDCG or MAP over the
        queries whose first row this rank holds."""
        from ..metric import map_device_plan, ndcg_device_plan
        sh = gbdt.shard
        qb = np.asarray(metric.query_boundaries, np.int64)
        starts = qb[:-1]
        own = np.nonzero((starts >= sh.start) & (starts < sh.stop))[0]
        build = ndcg_device_plan if metric.name == "ndcg" else map_device_plan
        _, fn = build(metric, sh.grid_rows, gbdt.device, queries=own)
        return fn, list(metric.eval_at), len(qb) - 1

    def run(self, scores, grad_ok) -> Tuple[List[Tuple[str, float]],
                                            bool, bool]:
        from ..metric import (device_auc_mu, device_binned_auc,
                              device_binned_average_precision)
        from ..parallel.data_parallel import exact_sum
        g, net = self._gbdt, self._net
        obj = g.objective
        pm = g.pad_mask
        w = pm if self._weight is None else self._weight * pm
        lab = self._label

        def mean(v):
            num = exact_sum(v * w, net=net)[0]
            return num / exact_sum(w, net=net)[0]

        vals = []
        if g.num_tree_per_iteration > 1:
            sc = scores.to(_F64)
            prob = obj.convert_output(sc) if obj is not None else sc
            K = prob.shape[0]
            lab_oh = (lab.to(_F64)[None, :] == torch.arange(
                K, dtype=_F64, device=sc.device)[:, None])
            p_lab = torch.sum(torch.where(lab_oh, prob, 0.0), dim=0)
            for _name, kind, extra in self._plans:
                if kind == "multi_logloss":
                    vals.append(mean(-torch.log(torch.clamp(p_lab, 1e-15,
                                                            1.0))))
                elif kind == "auc_mu":
                    # pairwise projections of the raw scores
                    vals.append(device_auc_mu(scores, lab, w, extra,
                                              net=net))
                else:   # multi_error: ties count AGAINST the row
                    num_ge = torch.sum(prob >= p_lab[None, :], dim=0)
                    vals.append(mean((num_ge > self._top_k).to(_F64)))
        else:
            sc = scores[0]
            conv = obj.convert_output(sc) if obj is not None else sc
            every = None
            for _name, kind, fn in self._plans:
                if kind in _KIND_RANK:
                    # rank metrics read the raw scores of whole queries
                    if every is None:
                        sh = g.shard
                        every = sc.new_zeros(sh.grid_rows)
                        every[:sh.num_rows] = net.all_gather_rows(
                            sc[:sh.count], sh.sizes)
                    eval_fn, ks, nq = fn
                    per_q = eval_fn(every)
                    seg = torch.arange(len(ks), device=sc.device).repeat(
                        per_q.shape[0])
                    vals.extend(exact_sum(per_q.reshape(-1), seg, len(ks),
                                          net) / nq)
                elif kind == _KIND_AUC:
                    vals.append(device_binned_auc(conv, lab, w, net=net))
                elif kind == _KIND_AP:
                    vals.append(device_binned_average_precision(
                        conv, lab, w, net=net))
                else:
                    v = mean(fn(conv.to(_F64), lab.to(_F64)))
                    vals.append(torch.sqrt(v) if kind == _KIND_SQRT else v)
        flag = (torch.tensor(True, device=scores.device) if grad_ok is None
                else grad_ok)
        flags = torch.stack([flag.to(_F64),
                             torch.isfinite(scores).all().to(_F64)])
        net.all_reduce_min_(flags)
        vec = torch.stack([torch.as_tensor(v, dtype=_F64,
                                           device=scores.device)
                           for v in vals] + list(flags)).cpu().numpy()
        self.fetches += 1
        names = []
        for name, kind, fn in self._plans:
            names.extend([f"{name}@{k}" for k in fn[1]]
                         if kind in _KIND_RANK else [name])
        out = [(name, float(v)) for name, v in zip(names, vec)]
        return out, bool(vec[-2] > 0), bool(vec[-1] > 0)
