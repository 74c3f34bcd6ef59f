"""Evaluation metrics (PyTorch port of `lightgbm_tpu/metric.py`; ref:
src/metric/: regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp, rank_metric.hpp, map_metric.hpp,
xentropy_metric.hpp, dcg_calculator.cpp; factory src/metric/metric.cpp:19).

The `Metric` classes are the JAX package's float64 NumPy code, copied:
they evaluate host-resident scores (validation sets, the host fallback of
the training metrics) and give the JAX package's numbers bit for bit on
the same arrays.  `device_pointwise_loss` is the torch form of the
pointwise losses that `ops/metrics.py` evaluates on the booster's device.
`bucket_queries` groups queries by padded length for the ranking
objectives' device programs (`ranking.py`).  `device_binned_auc`,
`device_binned_average_precision` and `device_auc_mu` are the binned
forms of the sharded train eval under data-parallel training
(ops/metrics.py ShardedEval): every term is a sum over rows, reduced
exactly over the ranks.  `ndcg_device_plan` and `map_device_plan` are
its per-query forms of NDCG@k and MAP@k: each rank evaluates the
queries it owns over every row's scores, and the per-query values are
summed exactly over the ranks (a serial booster evaluates ranking
metrics by the host classes, as the JAX package does).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .config import Config
from .utils import log


class Metric:
    """Base (ref: include/LightGBM/metric.h)."""

    name: str = ""
    is_higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (None if metadata.weight is None
                       else np.asarray(metadata.weight, dtype=np.float64))
        self.sum_weights = (float(num_data) if self.weight is None
                            else float(self.weight.sum()))
        self.query_boundaries = metadata.query_boundaries

    def eval(self, score: np.ndarray, objective=None) -> List[Tuple[str, float]]:
        raise NotImplementedError

    def _convert(self, score, objective):
        # host metrics evaluate host-resident scores (valid sets, loaded
        # boosters): convert on the host too, in float64, with no round
        # trip through the device
        if objective is not None:
            return np.asarray(objective.convert_output_host(score))
        return score

    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is None:
            return float(pointwise.sum() / self.sum_weights)
        return float((pointwise * self.weight).sum() / self.sum_weights)


# ------------------------------------------------------------------ regression
class _PointwiseRegression(Metric):
    def loss(self, label, score):
        raise NotImplementedError

    def eval(self, score, objective=None):
        conv = self._convert(score, objective)
        return [(self.name, self._avg(self.loss(self.label, conv)))]


class L2Metric(_PointwiseRegression):
    name = "l2"
    def loss(self, label, score):
        return (score - label) ** 2


class RMSEMetric(_PointwiseRegression):
    name = "rmse"
    def eval(self, score, objective=None):
        conv = self._convert(score, objective)
        return [(self.name, float(np.sqrt(self._avg((conv - self.label) ** 2))))]


class L1Metric(_PointwiseRegression):
    name = "l1"
    def loss(self, label, score):
        return np.abs(score - label)


class QuantileMetric(_PointwiseRegression):
    name = "quantile"
    def loss(self, label, score):
        alpha = self.config.alpha
        delta = label - score
        return np.where(delta < 0, (alpha - 1.0) * delta, alpha * delta)


class HuberMetric(_PointwiseRegression):
    name = "huber"
    def loss(self, label, score):
        a = self.config.alpha
        diff = np.abs(score - label)
        return np.where(diff <= a, 0.5 * diff * diff, a * (diff - 0.5 * a))


class FairMetric(_PointwiseRegression):
    name = "fair"
    def loss(self, label, score):
        c = self.config.fair_c
        x = np.abs(score - label)
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegression):
    name = "poisson"
    def loss(self, label, score):
        eps = 1e-10
        s = np.maximum(score, eps)
        return s - label * np.log(s)


class MAPEMetric(_PointwiseRegression):
    name = "mape"
    def loss(self, label, score):
        return np.abs((label - score) / np.maximum(1.0, np.abs(label)))


class GammaMetric(_PointwiseRegression):
    """Gamma negative log-likelihood, psi=1 (ref: regression_metric.hpp GammaMetric)."""
    name = "gamma"
    def loss(self, label, score):
        eps = 1e-10
        s = np.maximum(score, eps)
        return np.maximum(label, eps) / s + np.log(s)


class GammaDevianceMetric(_PointwiseRegression):
    name = "gamma_deviance"
    def loss(self, label, score):
        eps = 1e-10
        frac = label / np.maximum(score, eps)
        return 2.0 * (-np.log(np.maximum(frac, eps)) + frac - 1.0)


class TweedieMetric(_PointwiseRegression):
    name = "tweedie"
    def loss(self, label, score):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        s = np.maximum(score, eps)
        a = label * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


# ---------------------------------------------------------------------- binary
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"
    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        eps = 1e-15
        prob = np.clip(prob, eps, 1 - eps)
        is_pos = self.label > 0
        pt = np.where(is_pos, -np.log(prob), -np.log(1.0 - prob))
        return [(self.name, self._avg(pt))]


class BinaryErrorMetric(Metric):
    name = "binary_error"
    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        pred_pos = prob > 0.5
        is_pos = self.label > 0
        return [(self.name, self._avg((pred_pos != is_pos).astype(np.float64)))]


class AUCMetric(Metric):
    """ref: binary_metric.hpp:159 AUCMetric (weighted rank-sum form).

    Without weights every block sum is an integer and every term of the
    accumulation a multiple of 0.5, all exact in float64 (below 2^52),
    so the blocks are summed at once by NumPy and give the block loop's
    bits; with weights the loop keeps its order."""
    name = "auc"
    is_higher_better = True

    def eval(self, score, objective=None):
        order = np.argsort(-score, kind="stable")
        s = score[order]
        lab = self.label[order] > 0
        if self.weight is None:
            return [(self.name, self._eval_unweighted(s, lab))]
        w = (np.ones(len(s)) if self.weight is None else self.weight[order])
        # group ties: process equal-score blocks together
        boundaries = np.nonzero(np.diff(s))[0] + 1
        idx = np.concatenate([[0], boundaries, [len(s)]])
        sum_pos = 0.0
        accum = 0.0
        cur_neg = 0.0
        for a, b in zip(idx[:-1], idx[1:]):
            blk_pos = float((w[a:b] * lab[a:b]).sum())
            blk_neg = float((w[a:b] * ~lab[a:b]).sum())
            accum += blk_neg * (sum_pos + blk_pos * 0.5)
            sum_pos += blk_pos
            cur_neg += blk_neg
        if sum_pos == 0 or cur_neg == 0:
            return [(self.name, 1.0)]
        return [(self.name, accum / (sum_pos * cur_neg))]

    @staticmethod
    def _eval_unweighted(s, lab) -> float:
        boundaries = np.nonzero(np.diff(s))[0] + 1
        idx = np.concatenate([[0], boundaries, [len(s)]])
        cpos = np.concatenate([[0], np.cumsum(lab, dtype=np.int64)])
        pos_before = cpos[idx[:-1]]
        blk_pos = cpos[idx[1:]] - pos_before
        blk_neg = np.diff(idx) - blk_pos
        accum = float(np.sum(blk_neg * (pos_before + blk_pos * 0.5)))
        sum_pos, cur_neg = float(cpos[-1]), float(len(s) - cpos[-1])
        if sum_pos == 0 or cur_neg == 0:
            return 1.0
        return accum / (sum_pos * cur_neg)


class AveragePrecisionMetric(Metric):
    """ref: binary_metric.hpp AveragePrecisionMetric."""
    name = "average_precision"
    is_higher_better = True

    def eval(self, score, objective=None):
        order = np.argsort(-score, kind="stable")
        lab = self.label[order] > 0
        w = (np.ones(len(order)) if self.weight is None else self.weight[order])
        tp = np.cumsum(w * lab)
        fp = np.cumsum(w * ~lab)
        precision = tp / np.maximum(tp + fp, 1e-20)
        delta_tp = w * lab
        total_pos = tp[-1]
        if total_pos == 0:
            return [(self.name, 1.0)]
        return [(self.name, float((precision * delta_tp).sum() / total_pos))]


# ------------------------------------------------------------------ multiclass
class MultiLoglossMetric(Metric):
    name = "multi_logloss"
    def eval(self, score, objective=None):
        # score [K, n] raw -> softmax
        prob = self._convert(score, objective)
        if prob.ndim == 1:
            k = self.config.num_class
            prob = prob.reshape(k, -1)
        li = self.label.astype(np.int64)
        p = np.clip(prob[li, np.arange(prob.shape[1])], 1e-15, 1.0)
        return [(self.name, self._avg(-np.log(p)))]


class MultiErrorMetric(Metric):
    name = "multi_error"
    def eval(self, score, objective=None):
        prob = self._convert(score, objective)
        if prob.ndim == 1:
            k = self.config.num_class
            prob = prob.reshape(k, -1)
        top_k = self.config.multi_error_top_k
        li = self.label.astype(np.int64)
        true_p = prob[li, np.arange(prob.shape[1])]
        # error if true-class prob is not within top_k; ties count AGAINST
        # the row (ref: multiclass_metric.hpp:142 LossOnPoint counts
        # num_larger with >= including the class itself, error when
        # num_larger > top_k)
        num_ge = (prob >= true_p[None, :]).sum(axis=0)
        err = (num_ge > top_k).astype(np.float64)
        return [(self.name, self._avg(err))]


class AucMuMetric(Metric):
    """AUC-mu multiclass ranking metric (ref: multiclass_metric.hpp:183
    AucMuMetric; Kleiman & Page, ICML'19).  For every class pair (i, j)
    the rows of the two classes are projected on the separating direction
    v = W[i] - W[j] (W the auc_mu weight matrix, default all-ones with
    zero diagonal, config.cpp:220) and a pairwise AUC S[i][j] is
    accumulated with the reference's tie handling: rows within kEpsilon
    (1e-15, meta.h:54) of the last j-class distance contribute 0.5 per
    tied j row.  Result = 2 * sum_{i<j} S[i][j]/(n_i*n_j) / (K*(K-1))."""
    name = "auc_mu"
    is_higher_better = True
    _EPS = 1e-15

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        K = self.config.num_class
        w = list(self.config.auc_mu_weights or [])
        if w:
            if len(w) != K * K:
                log.fatal(f"auc_mu_weights must have {K * K} elements, "
                          f"but found {len(w)}")
            W = np.asarray(w, np.float64).reshape(K, K)
            if np.abs(np.diag(W)).max() > 1e-35:
                log.info("AUC-mu matrix must have zeros on diagonal. "
                         "Overwriting.")
            np.fill_diagonal(W, 0.0)
        else:
            W = np.ones((K, K), np.float64)
            np.fill_diagonal(W, 0.0)
        self.class_weights = W
        li = self.label.astype(np.int64)
        self.class_idx = [np.nonzero(li == k)[0] for k in range(K)]
        self.class_sizes = np.array([len(ix) for ix in self.class_idx])
        if self.weight is not None:
            self.class_data_weights = np.array(
                [float(self.weight[ix].sum()) for ix in self.class_idx])

    def _pair_auc(self, score, i, j):
        """S[i][j] of the reference's Eval loop, vectorized."""
        idx = np.concatenate([self.class_idx[i], self.class_idx[j]])
        if len(self.class_idx[i]) == 0 or len(self.class_idx[j]) == 0:
            return 0.0
        v = self.class_weights[i] - self.class_weights[j]      # curr_v
        t1 = v[i] - v[j]
        dist = t1 * (v @ score[:, idx])                        # [n_i+n_j]
        lab = np.concatenate([np.full(len(self.class_idx[i]), i),
                              np.full(len(self.class_idx[j]), j)])
        w = (np.ones(len(idx)) if self.weight is None
             else self.weight[idx])
        # sort by distance; exact ties put class j first (the reference
        # comparator orders near-ties by label descending; exact-tie
        # grouping below covers the epsilon credit)
        order = np.lexsort((-lab, dist))
        dist, lab, w = dist[order], lab[order], w[order]
        is_j = lab == j
        wj = np.where(is_j, w, 0.0)
        cum_wj = np.cumsum(wj)                 # num_j including position
        # j-distance groups: a new group starts when the j row's distance
        # moves >= eps from the previous j row's (the reference chains
        # from the group-start distance; consecutive chaining is
        # equivalent except for pathological sub-eps ladders)
        jpos = np.nonzero(is_j)[0]
        if len(jpos) == 0:
            return 0.0
        jd = dist[jpos]
        new_grp = np.empty(len(jpos), bool)
        new_grp[0] = True
        new_grp[1:] = np.abs(np.diff(jd)) >= self._EPS
        grp_of_j = np.cumsum(new_grp) - 1
        starts = np.nonzero(new_grp)[0]
        grp_start_dist = jd[starts]
        grp_start_cumwj_before = cum_wj[jpos[starts]] - wj[jpos[starts]]
        # per row: index of the last j row at/before it
        last_j = np.searchsorted(jpos, np.arange(len(dist)), "right") - 1
        ipos = np.nonzero(~is_j)[0]
        li_ = last_j[ipos]
        has_j = li_ >= 0
        g = grp_of_j[np.maximum(li_, 0)]
        num_j_before = np.where(has_j, cum_wj[np.maximum(jpos[np.maximum(
            li_, 0)], 0)], 0.0) * has_j
        tie = has_j & (np.abs(dist[ipos] - grp_start_dist[g]) < self._EPS)
        num_cur_j = np.where(tie, num_j_before
                             - grp_start_cumwj_before[g], 0.0)
        contrib = w[ipos] * (num_j_before - 0.5 * num_cur_j)
        return float(contrib.sum())

    def eval(self, score, objective=None):
        K = self.config.num_class
        if score.ndim == 1:
            score = score.reshape(K, -1)
        score = np.asarray(score, np.float64)
        ans = 0.0
        for i in range(K):
            for j in range(i + 1, K):
                s = self._pair_auc(score, i, j)
                if self.weight is None:
                    den = (self.class_sizes[i] * self.class_sizes[j])
                else:
                    den = (self.class_data_weights[i]
                           * self.class_data_weights[j])
                if den > 0:
                    ans += s / den
        return [(self.name, 2.0 * ans / (K * (K - 1)))]


# --------------------------------------------------------------------- ranking
DEFAULT_LABEL_GAIN_SIZE = 31


def bucket_queries(query_boundaries, n_pad: int):
    """Group queries by pow2-padded length (at least 8) for the
    per-query tensor programs of the ranking objectives: a list of
    dicts {qs: [query ids], m: padded length, idx: [Qb, m] int32 global
    row indices (padding -> n_pad - 1), val: [Qb, m] bool}, the JAX
    package's buckets (`lightgbm_tpu/metric.py` bucket_queries), in
    ascending m."""
    qb = np.asarray(query_boundaries)
    lens = np.diff(qb).astype(np.int64)
    groups = {}
    for q, ln in enumerate(lens):
        m = max(8, 1 << int(ln - 1).bit_length())
        groups.setdefault(m, []).append(q)
    out = []
    for m, qs in sorted(groups.items()):
        Qb = len(qs)
        idx = np.full((Qb, m), n_pad - 1, np.int32)
        val = np.zeros((Qb, m), bool)
        for r, q in enumerate(qs):
            a, b = int(qb[q]), int(qb[q + 1])
            idx[r, :b - a] = np.arange(a, b)
            val[r, :b - a] = True
        out.append({"qs": qs, "m": m, "idx": idx, "val": val})
    return out


def _plan_buckets(query_boundaries, n_pad: int, queries, device):
    """`bucket_queries` limited to the query ids `queries` (every query
    when None), with idx and val on `device`: [(bucket, its query ids)]
    of the non-empty buckets."""
    import torch
    out = []
    for b in bucket_queries(query_boundaries, n_pad):
        qs = np.asarray(b["qs"], np.int64)
        keep = (np.ones(len(qs), bool) if queries is None
                else np.isin(qs, queries))
        if not keep.any():
            continue
        out.append(({"m": b["m"],
                     "idx": torch.from_numpy(
                         b["idx"][keep].astype(np.int64)).to(device),
                     "val": torch.from_numpy(b["val"][keep]).to(device)},
                    qs[keep]))
    return out


def ndcg_device_plan(metric: "NDCGMetric", n_pad: int, device="cpu",
                     queries=None):
    """Device plan of NDCG@k over per-query tensor programs (the torch
    form of the JAX package's `ndcg_device_plan`, metric.py:747; ref:
    rank_metric.hpp:20): per bucket of pow2-padded queries a stable
    sort of the scores, the DCG of the sorted gains at each k and the
    ideal DCG precomputed on the host (labels are static), all float64.
    `queries`: the query ids to evaluate (every query when None).
    Returns (number of planned queries, eval_fn): eval_fn(score
    [n_pad]) -> [planned queries, len(eval_at)] float64, each query's
    NDCG@k (1 where its ideal DCG is 0); the JAX plan's value is their
    mean over every query."""
    import torch
    gains = np.asarray(metric.label_gain, np.float64)
    lab_all = metric.label.astype(np.int64)
    qb = metric.query_boundaries
    ks = list(metric.eval_at)
    plan = []
    nq = 0
    for b, qs in _plan_buckets(qb, n_pad, queries, device):
        m = b["m"]
        g = np.zeros((len(qs), m))
        idcg = np.zeros((len(qs), len(ks)))
        disc = 1.0 / np.log2(np.arange(m) + 2.0)
        for r, q in enumerate(qs):
            a, e = int(qb[q]), int(qb[q + 1])
            gq = gains[lab_all[a:e]]
            ideal = np.sort(gq)[::-1]
            g[r, :e - a] = gq
            for ki, k in enumerate(ks):
                kk = min(k, e - a)
                idcg[r, ki] = (ideal[:kk] * disc[:kk]).sum()
        plan.append({**b, "g": torch.from_numpy(g).to(device),
                     "idcg": torch.from_numpy(idcg).to(device),
                     "disc": torch.from_numpy(disc).to(device)})
        nq += len(qs)

    def eval_fn(score):
        outs = []
        for bk in plan:
            m = bk["m"]
            scb = score.to(torch.float64)[bk["idx"]]
            key = torch.where(bk["val"], scb, -torch.inf)
            order = torch.argsort(-key, dim=1, stable=True)
            g_sorted = torch.gather(bk["g"], 1, order)
            cols = []
            for ki, k in enumerate(ks):
                kk = min(k, m)
                dcg = (g_sorted[:, :kk] * bk["disc"][None, :kk]).sum(1)
                idcg = bk["idcg"][:, ki]
                cols.append(torch.where(
                    idcg > 0, dcg / torch.clamp(idcg, min=1e-30), 1.0))
            outs.append(torch.stack(cols, 1))
        if not outs:
            return torch.zeros((0, len(ks)), dtype=torch.float64,
                               device=score.device)
        return torch.cat(outs, 0)

    return nq, eval_fn


def map_device_plan(metric: "MapMetric", n_pad: int, device="cpu",
                    queries=None):
    """Device plan of MAP@k (the torch form of the JAX package's
    `map_device_plan`, metric.py:668; ref: map_metric.hpp:17): per
    bucket a stable sort of the scores, the precision at each relevant
    position from a cumulative sum of the sorted relevance, and the
    per-query denominators min(positives, k) precomputed on the host.
    Returns (number of planned queries, eval_fn) as `ndcg_device_plan`
    does: eval_fn(score) -> [planned queries, len(eval_at)] float64
    (1 where a query's denominator is 0)."""
    import torch
    lab_all = metric.label
    qb = metric.query_boundaries
    ks = list(metric.eval_at)
    plan = []
    nq = 0
    for b, qs in _plan_buckets(qb, n_pad, queries, device):
        m = b["m"]
        rel = np.zeros((len(qs), m))
        denom = np.zeros((len(qs), len(ks)))
        for r, q in enumerate(qs):
            a, e = int(qb[q]), int(qb[q + 1])
            rq = lab_all[a:e] > 0
            rel[r, :e - a] = rq
            npos = int(rq.sum())
            for ki, k in enumerate(ks):
                denom[r, ki] = min(npos, min(k, e - a))
        plan.append({**b, "rel": torch.from_numpy(rel).to(device),
                     "denom": torch.from_numpy(denom).to(device)})
        nq += len(qs)

    def eval_fn(score):
        outs = []
        for bk in plan:
            m = bk["m"]
            scb = score.to(torch.float64)[bk["idx"]]
            key = torch.where(bk["val"], scb, -torch.inf)
            order = torch.argsort(-key, dim=1, stable=True)
            rel_sorted = torch.gather(bk["rel"], 1, order)
            cum = torch.cumsum(rel_sorted, 1)
            pos = torch.arange(1, m + 1, dtype=torch.float64,
                               device=score.device)
            prec_at_hit = torch.where(rel_sorted > 0, cum / pos[None, :],
                                      0.0)
            cols = []
            for ki, k in enumerate(ks):
                kk = min(k, m)
                s = prec_at_hit[:, :kk].sum(1)
                d = bk["denom"][:, ki]
                cols.append(torch.where(d > 0, s / torch.clamp(d, min=1.0),
                                        1.0))
            outs.append(torch.stack(cols, 1))
        if not outs:
            return torch.zeros((0, len(ks)), dtype=torch.float64,
                               device=score.device)
        return torch.cat(outs, 0)

    return nq, eval_fn


def default_label_gain() -> List[float]:
    return [float((1 << i) - 1) for i in range(DEFAULT_LABEL_GAIN_SIZE)]


class NDCGMetric(Metric):
    """NDCG@k (ref: rank_metric.hpp:20, dcg_calculator.cpp)."""
    name = "ndcg"
    is_higher_better = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]
        self.label_gain = list(config.label_gain) or default_label_gain()

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal("The NDCG metric requires query information")

    def eval(self, score, objective=None):
        qb = self.query_boundaries
        gains = np.asarray(self.label_gain)
        results = {k: [] for k in self.eval_at}
        for qi in range(len(qb) - 1):
            a, b = int(qb[qi]), int(qb[qi + 1])
            lab = self.label[a:b].astype(np.int64)
            sc = score[a:b]
            g = gains[lab]
            order = np.argsort(-sc, kind="stable")
            ideal = np.sort(g)[::-1]
            discounts = 1.0 / np.log2(np.arange(len(lab)) + 2.0)
            for k in self.eval_at:
                kk = min(k, len(lab))
                idcg = float((ideal[:kk] * discounts[:kk]).sum())
                if idcg > 0:
                    dcg = float((g[order][:kk] * discounts[:kk]).sum())
                    results[k].append(dcg / idcg)
                else:
                    results[k].append(1.0)
        return [(f"ndcg@{k}", float(np.mean(results[k]))) for k in self.eval_at]


class MapMetric(Metric):
    """MAP@k (ref: map_metric.hpp:17)."""
    name = "map"
    is_higher_better = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.eval_at = list(config.eval_at) or [1, 2, 3, 4, 5]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            log.fatal("The MAP metric requires query information")

    def eval(self, score, objective=None):
        qb = self.query_boundaries
        results = {k: [] for k in self.eval_at}
        for qi in range(len(qb) - 1):
            a, b = int(qb[qi]), int(qb[qi + 1])
            rel = (self.label[a:b] > 0)[np.argsort(-score[a:b], kind="stable")]
            npos = int(rel.sum())
            cum = np.cumsum(rel)
            prec_at_hit = np.where(rel, cum / (np.arange(len(rel)) + 1.0), 0.0)
            for k in self.eval_at:
                kk = min(k, len(rel))
                denom = min(npos, kk)
                if denom > 0:
                    results[k].append(float(prec_at_hit[:kk].sum()) / denom)
                else:
                    results[k].append(1.0)
        return [(f"map@{k}", float(np.mean(results[k]))) for k in self.eval_at]


# ---------------------------------------------------------------- cross-entropy
class CrossEntropyMetric(Metric):
    name = "cross_entropy"
    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = self.label
        pt = -y * np.log(p) - (1 - y) * np.log(1 - p)
        return [(self.name, self._avg(pt))]


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"
    def eval(self, score, objective=None):
        hhat = self._convert(score, objective)  # log1p(exp(score))
        y = self.label
        w = self.weight if self.weight is not None else 1.0
        z = 1.0 - np.exp(-w * hhat)
        z = np.clip(z, 1e-15, 1 - 1e-15)
        pt = -y * np.log(z) - (1 - y) * np.log(1 - z)
        return [(self.name, float(np.mean(pt)))]


class KLDivergenceMetric(Metric):
    name = "kullback_leibler"
    def eval(self, score, objective=None):
        p = np.clip(self._convert(score, objective), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        pt = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        return [(self.name, self._avg(pt))]


# --------------------------------------------------------------------- factory
_METRIC_ALIASES = {
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "l2_root": "rmse", "root_mean_squared_error": "rmse", "rmse": "rmse",
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "quantile": "quantile", "huber": "huber", "fair": "fair", "poisson": "poisson",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc", "average_precision": "average_precision",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multi_error": "multi_error", "auc_mu": "auc_mu",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "map": "map", "mean_average_precision": "map",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kullback_leibler", "kldiv": "kullback_leibler",
}

_METRIC_CLASSES = {
    "l2": L2Metric, "rmse": RMSEMetric, "l1": L1Metric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "ndcg": NDCGMetric, "map": MapMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KLDivergenceMetric,
}

# objective -> default metric (ref: config.cpp Config::GetMetricType)
_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "quantile": "quantile", "mape": "mape",
    "gamma": "gamma", "tweedie": "tweedie", "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy", "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metrics(config: Config, for_objective: Optional[str] = None) -> List[Metric]:
    """ref: src/metric/metric.cpp:19 Metric::CreateMetric + config metric parsing."""
    names = [str(m).strip().lower() for m in (config.metric or [])]
    if not names:
        obj = for_objective or config.objective
        if obj in _DEFAULT_FOR_OBJECTIVE:
            names = [_DEFAULT_FOR_OBJECTIVE[obj]]
    out: List[Metric] = []
    seen = set()
    for nm in names:
        if nm in ("", "na", "null", "none", "custom"):
            continue
        canon = _METRIC_ALIASES.get(nm)
        if canon is None:
            log.warning(f"Unknown metric: {nm}")
            continue
        if canon in seen:
            continue
        seen.add(canon)
        out.append(_METRIC_CLASSES[canon](config))
    return out


# ------------------------------------------------------------- device eval
def device_pointwise_loss(name: str, config: Config):
    """Torch pointwise loss over CONVERTED scores for the device eval tick
    (ops/metrics.py): fn(converted_score, label) -> loss tensor, or None
    when the metric has no device form.  The formulas are the host
    classes' above (which mirror src/metric/*_metric.hpp)."""
    import torch
    eps10, eps15 = 1e-10, 1e-15
    alpha, fair_c = config.alpha, config.fair_c
    rho = config.tweedie_variance_power

    def clip_pos(s):
        return torch.clamp(s, min=eps10)

    fns = {
        "l2": lambda s, y: (s - y) ** 2,
        "rmse": lambda s, y: (s - y) ** 2,          # sqrt after averaging
        "l1": lambda s, y: torch.abs(s - y),
        "quantile": lambda s, y: torch.where(
            (y - s) < 0, (alpha - 1.0) * (y - s), alpha * (y - s)),
        "huber": lambda s, y: torch.where(
            torch.abs(s - y) <= alpha, 0.5 * (s - y) ** 2,
            alpha * (torch.abs(s - y) - 0.5 * alpha)),
        "fair": lambda s, y: (fair_c * torch.abs(s - y) - fair_c ** 2
                              * torch.log1p(torch.abs(s - y) / fair_c)),
        "poisson": lambda s, y: clip_pos(s) - y * torch.log(clip_pos(s)),
        "mape": lambda s, y: torch.abs(
            (y - s) / torch.clamp(torch.abs(y), min=1.0)),
        "gamma": lambda s, y: (torch.clamp(y, min=eps10) / clip_pos(s)
                               + torch.log(clip_pos(s))),
        "gamma_deviance": lambda s, y: 2.0 * (
            -torch.log(torch.clamp(y / clip_pos(s), min=eps10))
            + y / clip_pos(s) - 1.0),
        "tweedie": lambda s, y: (
            -y * clip_pos(s) ** (1.0 - rho) / (1.0 - rho)
            + clip_pos(s) ** (2.0 - rho) / (2.0 - rho)),
        "binary_logloss": lambda s, y: torch.where(
            y > 0, -torch.log(torch.clamp(s, eps15, 1 - eps15)),
            -torch.log(1.0 - torch.clamp(s, eps15, 1 - eps15))),
        "binary_error": lambda s, y: ((s > 0.5) != (y > 0)).to(s.dtype),
        "xentropy": lambda s, y: -(y * torch.log(torch.clamp(s, eps15, 1.0))
                                   + (1.0 - y) * torch.log(
                                       torch.clamp(1.0 - s, eps15, 1.0))),
    }
    return fns.get(name)


# ------------------------------------------------- sharded (binned) forms
def _binned_hists(prob, label, w, num_bins: int, net=None):
    """(positive, negative) weight histograms [num_bins] float64 over
    the score bins of `prob` min-max normalized over the rows of
    positive weight (the JAX package's binning, in float32), summed
    exactly over the rows and the ranks of `net`."""
    import torch
    from .parallel.data_parallel import exact_sum
    prob = prob.to(torch.float32)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=prob.device)
    mm = torch.stack([torch.where(w > 0, -prob, -inf).max(),
                      torch.where(w > 0, prob, -inf).max()])
    if net is not None:
        net.all_reduce_max_(mm)
    lo, hi = -mm[0], mm[1]
    span = torch.clamp(hi - lo, min=1e-30)
    unit = torch.clamp((prob - lo) / span, 0.0, 1.0)
    b = torch.clamp((unit * num_bins).to(torch.int64), 0, num_bins - 1)
    ids = torch.where(label > 0, b, b + num_bins)
    h = exact_sum(w.to(torch.float32), ids, 2 * num_bins, net)
    return h[:num_bins], h[num_bins:]


def device_binned_auc(prob, label, w, num_bins: int = 16384, net=None):
    """Weighted AUC from a global score-bin histogram (the JAX package's
    `device_binned_auc`, metric.py:590): resolution 1/num_bins of score
    space, ties within a bin get half credit (binary_metric.hpp:159).
    Every rank of `net` reads the same value."""
    import torch
    pos_h, neg_h = _binned_hists(prob, label, w, num_bins, net)
    pos_above = torch.flip(torch.cumsum(torch.flip(pos_h, [0]), 0),
                           [0]) - pos_h
    accum = torch.sum(neg_h * (pos_above + 0.5 * pos_h))
    tp, tn = pos_h.sum(), neg_h.sum()
    return torch.where((tp == 0) | (tn == 0), torch.ones_like(tp),
                       accum / torch.clamp(tp * tn, min=1e-30))


def device_binned_average_precision(prob, label, w, num_bins: int = 16384,
                                    net=None):
    """Weighted average precision from the same histogram (the JAX
    package's `device_binned_average_precision`, metric.py:620)."""
    import torch
    pos_h, neg_h = _binned_hists(prob, label, w, num_bins, net)
    tp = torch.flip(torch.cumsum(torch.flip(pos_h, [0]), 0), [0])
    fp = torch.flip(torch.cumsum(torch.flip(neg_h, [0]), 0), [0])
    prec = tp / torch.clamp(tp + fp, min=1e-20)
    total = pos_h.sum()
    ap = torch.sum(prec * pos_h) / torch.clamp(total, min=1e-30)
    return torch.where(total == 0, torch.ones_like(ap), ap)


def device_auc_mu(score, label, w, class_weights: np.ndarray,
                  num_bins: int = 4096, net=None):
    """auc_mu over sharded rows (the JAX package's `device_auc_mu`,
    metric.py:645): each class pair's rows are projected on
    v = W[i] - W[j], then a binned two-class AUC runs per pair."""
    import torch
    K = score.shape[0]
    Wm = np.asarray(class_weights, np.float32)
    total = 0.0
    for i in range(K):
        for j in range(i + 1, K):
            v = torch.from_numpy(Wm[i] - Wm[j]).to(score.device)
            t1 = float(Wm[i, i] - Wm[j, i] - (Wm[i, j] - Wm[j, j]))
            dist = t1 * (v @ score.to(torch.float32))
            in_pair = (label == i) | (label == j)
            wp = torch.where(in_pair, w, torch.zeros_like(w))
            total = total + device_binned_auc(dist, (label == i), wp,
                                              num_bins=num_bins, net=net)
    return 2.0 * total / (K * (K - 1))
