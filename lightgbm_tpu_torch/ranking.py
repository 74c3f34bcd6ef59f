"""Ranking objectives: LambdaRank-NDCG and RankXENDCG (PyTorch port of
`lightgbm_tpu/ranking.py`; ref: src/objective/rank_objective.hpp
RankingObjective:28, LambdarankNDCG:131, RankXENDCG:362, and the CUDA
twin src/objective/cuda/cuda_rank_objective.cu).

Gradients run on the scores' device.  Queries are grouped by their
pow2-padded length (`metric.bucket_queries`, the JAX package's buckets)
and each bucket is one masked tensor program over [Qb, m] blocks:
LambdaRank's pairwise lambdas over [Qb, T, m] (T = min(truncation, m - 1)
sorted positions against every document, the exact sigmoid), XENDCG's
masked softmax and its three correction passes.  A bucket is processed in
chunks of whole queries so that one [Qc, T, m] float64 temporary stays
under `PAIR_BUDGET` elements; queries are independent and every sum runs
inside one query, so the bits do not depend on the chunking.  Every step
is float64 and the results are rounded once to float32, as in the other
objectives, so the CPU and the card agree and the port follows the JAX
package's float64 host loop (`get_gradients_host`, kept here as the
plain version).  Each row's result is written back through the bucket's
valid positions only: the padding index `n_pad - 1` is a real row when
n is a multiple of the booster's row padding.

Position bias (ref: rank_objective.hpp:43-60,290) is device state: the
scores are offset by the per-position biases before the objective, and
a Newton step updates them from the weighted float64 lambdas and
hessians.  Its per-position sums are read from cumulative sums of the
rows sorted by position once, at fixed segment bounds, in 64-bit fixed
point (no float atomics), so the same inputs give the same bias bits.

Under a learner that shards the rows (`tree_learner=data`, `voting`), a
rank owns rows [start, stop) of the serial order and queries straddle
those bounds.  `get_gradients(..., shard=)` all-gathers the float32
scores (4 B a row an iteration), keeps the serial program's chunks that
hold a query meeting the rank's rows (the same [Qc, m] blocks as the
serial run, so the same bits whatever a device's reductions do with
the block's shape) and keeps its own rows' values.  Position bias adds
only the rank's own rows into the int64 segment sums and all-reduces
them; the grid's exponent comes from an exact sum of |v| (`exact_sum`),
the same bits serially and however the rows are split.

XENDCG draws its per-query uniforms as the JAX package's device program
does: `uniform(fold_in(fold_in(PRNGKey(objective_seed), it), q), (m,))`
(`utils/random.py`), where `it` counts this objective's gradient calls
(a continued booster starts again at 0, as in the JAX package).  With
position bias it draws as the JAX package's host loop does, per-query
NumPy `RandomState(objective_seed + q)` streams, on the host, put on the
device once per iteration.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import Config
from .metric import bucket_queries, default_label_gain
from .objective import ObjectiveFunction
from .parallel.data_parallel import exact_sum
from .utils import log
from .utils import random as jrandom

K_EPSILON = 1e-15
_F64 = torch.float64
# float64 elements of one [Qc, T, m] pairwise temporary (LambdaRank) or
# of one [Qc, m] block (XENDCG, whose threefry draws hold several int64
# words per element): 32 MiB each
PAIR_BUDGET = 1 << 22


def _discounts(n: int) -> np.ndarray:
    return 1.0 / np.log2(np.arange(n) + 2.0)


class RankingObjective(ObjectiveFunction):
    """Common per-query driver (ref: rank_objective.hpp:28)."""

    # training metrics take the host classes, as in the JAX package
    # (ops/metrics.py DeviceEval); a row-sharded run evaluates NDCG and
    # MAP by their device plans (ShardedEval)
    run_on_host = True
    # the booster passes its RowShard: the gradients read whole queries
    takes_shard = True

    def __init__(self, config: Config):
        super().__init__(config)
        self.seed = config.objective_seed
        self.learning_rate = config.learning_rate
        self.position_bias_regularization = (
            config.lambdarank_position_bias_regularization)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            log.fatal("Ranking tasks require query information")
        self.query_boundaries = np.asarray(metadata.query_boundaries)
        self.num_queries = len(self.query_boundaries) - 1
        self.positions = (None if getattr(metadata, "position", None) is None
                          else np.asarray(metadata.position, np.int64))
        if self.positions is not None:
            self.num_position_ids = int(self.positions.max()) + 1
        self._prog = None
        self._biases_dev = None
        self._biases_host = (None if self.positions is None
                             else np.zeros(self.num_position_ids))

    @property
    def pos_biases(self) -> Optional[np.ndarray]:
        """The learned per-position offsets, float64 (pulled from the
        device state when the device program runs)."""
        if self._biases_dev is not None:
            return self._biases_dev.cpu().numpy().astype(np.float64)
        return self._biases_host

    # -------------------------------------------------- plain (host) version
    def get_gradients_host(self, score: np.ndarray):
        """score [n] -> (grad, hess) float32 by the JAX package's float64
        host loop (ref: RankingObjective::GetGradients); the plain version
        of `get_gradients`, with its own position-bias state."""
        n = len(score)
        lambdas = np.zeros(n, dtype=np.float64)
        hessians = np.zeros(n, dtype=np.float64)
        if self.positions is not None:
            score = score + self._biases_host[self.positions]
        for q in range(self.num_queries):
            a, b = (int(self.query_boundaries[q]),
                    int(self.query_boundaries[q + 1]))
            lambdas[a:b], hessians[a:b] = self._one_query(
                q, self.label[a:b], score[a:b])
        if self.weight is not None:
            lambdas *= self.weight
            hessians *= self.weight
        if self.positions is not None:
            P = self.num_position_ids
            fd = -np.bincount(self.positions, weights=lambdas, minlength=P)
            sd = -np.bincount(self.positions, weights=hessians, minlength=P)
            cnt = np.bincount(self.positions, minlength=P)
            reg = self.position_bias_regularization
            fd -= self._biases_host * reg * cnt
            sd -= reg * cnt
            self._biases_host = self._biases_host + (
                self.learning_rate * fd / (np.abs(sd) + 0.001))
        return lambdas.astype(np.float32), hessians.astype(np.float32)

    def _one_query(self, qid, label, score):
        raise NotImplementedError

    # ------------------------------------------------------ device program
    def _query_range(self, shard) -> tuple:
        """The queries [q_lo, q_hi) that meet a shard's rows (every query
        without one)."""
        if shard is None:
            return 0, self.num_queries
        if shard.count == 0:
            return 0, 0
        qb = self.query_boundaries
        return (int(np.searchsorted(qb, shard.start, side="right")) - 1,
                int(np.searchsorted(qb, shard.stop, side="left")))

    def _build(self, n_pad: int, dev: torch.device, shard=None) -> dict:
        """Device tensors of the buckets, each split into chunks of whole
        queries: per chunk the [Qc, m] row indices, labels and valid
        mask, the flat valid positions of the block and their rows.
        With a `shard`, only the serial chunks that hold a query meeting
        its rows, and the position-bias segments over its own rows."""
        qb = self.query_boundaries
        lab_all = self.label.astype(np.int64)
        q_lo, q_hi = self._query_range(shard)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        chunks = []
        for b in bucket_queries(qb, n_pad):
            m = b["m"]
            per_query = self._chunk_elems(m)
            qc = max(1, PAIR_BUDGET // per_query)
            lab = np.zeros(b["idx"].shape, np.int64)
            for r, q in enumerate(b["qs"]):
                a, e = int(qb[q]), int(qb[q + 1])
                lab[r, :e - a] = lab_all[a:e]
            qs = np.asarray(b["qs"], np.int64)
            for lo in range(0, len(qs), qc):
                sl = slice(lo, lo + qc)
                # a bucket lists its queries in ascending order
                if qs[sl][-1] < q_lo or qs[sl][0] >= q_hi:
                    continue
                idx, val = b["idx"][sl].astype(np.int64), b["val"][sl]
                flat = np.flatnonzero(val.reshape(-1))
                chunks.append(dict(
                    m=m, qid=put(qs[sl]), idx=put(idx),
                    lab=put(lab[sl]), val=put(val), flat=put(flat),
                    rows=put(idx.reshape(-1)[flat]),
                    **self._chunk_extra(qs[sl], put)))
        rows = None if shard is None else (shard.start, shard.stop)
        prog = dict(n_pad=n_pad, dev=dev, chunks=chunks, rows=rows)
        if self.positions is not None:
            P = self.num_position_ids
            # the segments sum the rows this rank owns (all, serially)
            own = (self.positions if shard is None
                   else self.positions[shard.start:shard.stop])
            order = np.argsort(own, kind="stable")
            cnt_own = np.bincount(own, minlength=P)
            ends = np.cumsum(cnt_own)
            cnt = np.bincount(self.positions, minlength=P)
            pos = np.zeros(n_pad, np.int64)
            pos[:self.num_data] = self.positions
            prog.update(
                pos=torch.from_numpy(pos).to(dev),
                pos_order=torch.from_numpy(order).to(dev),
                pos_start=torch.from_numpy(ends - cnt_own).to(dev),
                pos_end=torch.from_numpy(ends).to(dev),
                pos_cnt=torch.from_numpy(cnt.astype(np.float64)).to(dev))
            self._biases_dev = torch.from_numpy(
                np.asarray(self._biases_host, np.float64)).to(dev)
        return prog

    def _chunk_elems(self, m: int) -> int:
        return m

    def _chunk_extra(self, qs, put) -> dict:
        return {}

    def _program(self, score: torch.Tensor, shard=None) -> dict:
        """The program over `score` [n_pad] of every row (of a shard's
        queries), built once."""
        prog = self._prog
        rows = None if shard is None else (shard.start, shard.stop)
        if (prog is None or prog["n_pad"] != score.shape[0]
                or prog["dev"] != score.device or prog["rows"] != rows):
            if self.positions is not None and self._biases_dev is not None:
                self._biases_host = self.pos_biases
            self._prog = prog = self._build(score.shape[0], score.device,
                                            shard)
        return prog

    @staticmethod
    def _segment_sums(v: torch.Tensor, prog: dict, net=None) -> torch.Tensor:
        """Per-position sums of the rows' float64 values `v` [..., rows]
        (the weighted lambdas and hessians of the rows the program's
        segments cover), each leading index alone: the rows sorted by
        position once, each value
        rounded to the grid 2^-s with 2^s = 2^61 / 2^ceil(log2 Σ|v|)
        (no partial sum overflows int64; Σ|v| an exact limb sum over
        every row, `exact_sum`, so its bits do not depend on the order
        of the rows or their split over the ranks of `net`), one int64
        cumulative sum, and each segment's integer difference at its
        fixed bounds, all-reduced over `net`: exact sums of the grid
        values, whatever order the scan adds in.  Returns [..., P]."""
        lead = v.shape[:-1]
        vs = v.reshape(-1, v.shape[-1])[:, prog["pos_order"]]
        R = vs.shape[0]
        seg = torch.arange(R, device=vs.device).repeat_interleave(
            vs.shape[1])
        total = exact_sum(vs.abs().reshape(-1), seg, R, net).clamp(
            min=2.0 ** -900)
        scale = torch.pow(torch.full_like(total, 2.0),
                          61.0 - torch.ceil(torch.log2(total)))[:, None]
        cs = torch.cumsum(torch.round(vs * scale).to(torch.int64), 1)
        cs = torch.cat([cs.new_zeros(R, 1), cs], 1)
        sums = cs[:, prog["pos_end"]] - cs[:, prog["pos_start"]]
        if net is not None:
            net.all_reduce_sum_(sums)
        return (sums.to(_F64) / scale).reshape(lead + sums.shape[1:])

    def get_gradients(self, score: torch.Tensor, label=None,
                      weight: Optional[torch.Tensor] = None, shard=None):
        """score [n_pad] (float32, the booster's device) -> (grad, hess)
        float32 [n_pad], zero on the padding rows.  The labels are the
        objective's own (put on the device with the buckets).  With a
        RowShard `shard`, `score` and `weight` hold the rank's rows and
        so do the results: the scores of every row are all-gathered
        and the serial program's chunks that meet the rank's queries
        run on them."""
        net = None
        if shard is None:
            full = score
        else:
            net = shard.net
            full = score.new_zeros(shard.grid_rows)
            full[:shard.num_rows] = net.all_gather_rows(
                score[:shard.count], shard.sizes)
        prog = self._program(full, shard)
        sc = full.to(_F64)
        if self.positions is not None:
            sc = sc + self._biases_dev[prog["pos"]]      # hpp:68
        g = torch.zeros_like(sc)
        h = torch.zeros_like(sc)
        u_rows = self._iteration_draws(prog)
        for ch in prog["chunks"]:
            lam, hes = self._block(sc[ch["idx"]], ch, prog, u_rows)
            g[ch["rows"]] = lam.reshape(-1)[ch["flat"]]
            h[ch["rows"]] = hes.reshape(-1)[ch["flat"]]
        if shard is not None:
            # the rank's rows, padded as its scores are
            gl = torch.zeros_like(score, dtype=_F64)
            hl = torch.zeros_like(gl)
            gl[:shard.count] = g[shard.start:shard.stop]
            hl[:shard.count] = h[shard.start:shard.stop]
            g, h = gl, hl
        if weight is not None:
            w = weight.to(_F64)
            g = g * w
            h = h * w
        if self.positions is not None:
            # Newton step on the per-position utility derivatives, from
            # the weighted lambdas (ref: rank_objective.hpp:290
            # UpdatePositionBiasFactors)
            cnt = prog["pos_cnt"]
            reg = self.position_bias_regularization
            sums = self._segment_sums(torch.stack([g, h]), prog, net)
            fd = -sums[0] - self._biases_dev * reg * cnt
            sd = -sums[1] - reg * cnt
            self._biases_dev = self._biases_dev + (
                self.learning_rate * fd / (torch.abs(sd) + 0.001))
        return g.to(torch.float32), h.to(torch.float32)

    def _iteration_draws(self, prog: dict) -> Optional[torch.Tensor]:
        return None

    def _block(self, sc_b, ch, prog, u_rows):
        raise NotImplementedError


class LambdarankNDCG(RankingObjective):
    """ref: rank_objective.hpp:131 LambdarankNDCG; the JAX package's
    bucketed device program (ranking.py:155-312) in float64."""
    name = "lambdarank"

    def __init__(self, config: Config):
        super().__init__(config)
        self.sigmoid = config.sigmoid
        self.norm = config.lambdarank_norm
        self.truncation_level = config.lambdarank_truncation_level
        self.label_gain = np.asarray(list(config.label_gain) or
                                     default_label_gain())
        if self.sigmoid <= 0:
            log.fatal(f"Sigmoid param {self.sigmoid} should be greater "
                      "than zero")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if ((self.label >= len(self.label_gain)).any()
                or (self.label < 0).any()):
            log.fatal("Label exceeds label_gain size in lambdarank")
        # inverse max DCG at the truncation level per query (ref:
        # hpp:160-170)
        self.inverse_max_dcgs = np.zeros(self.num_queries)
        disc = _discounts(self.truncation_level)
        for q in range(self.num_queries):
            a, b = (int(self.query_boundaries[q]),
                    int(self.query_boundaries[q + 1]))
            g = np.sort(self.label_gain[self.label[a:b].astype(np.int64)])[::-1]
            k = min(self.truncation_level, b - a)
            max_dcg = float((g[:k] * disc[:k]).sum())
            self.inverse_max_dcgs[q] = 1.0 / max_dcg if max_dcg > 0 else 0.0

    def _trunc(self, m: int) -> int:
        return max(1, min(self.truncation_level, m - 1))

    def _chunk_elems(self, m: int) -> int:
        return self._trunc(m) * m

    def _chunk_extra(self, qs, put) -> dict:
        return {"imd": put(self.inverse_max_dcgs[qs])}

    def _build(self, n_pad, dev, shard=None):
        prog = super()._build(n_pad, dev, shard)
        # gains and discounts from NumPy, the plain version's values
        prog["gain"] = torch.from_numpy(
            self.label_gain.astype(np.float64)).to(dev)
        ms = sorted({ch["m"] for ch in prog["chunks"]})
        prog["disc"] = {m: torch.from_numpy(_discounts(m)).to(dev)
                        for m in ms}
        return prog

    def _block(self, sc_b, ch, prog, u_rows):
        """[Qc, m] padded query block -> (lambdas, hessians) float64 in
        the block's document positions (`_one_query`, vectorized)."""
        m, val, lab = ch["m"], ch["val"], ch["lab"]
        Tm = self._trunc(m)
        sig = self.sigmoid
        key = torch.where(val, sc_b, -torch.inf)
        order = torch.argsort(-key, dim=1, stable=True)
        ss = torch.gather(sc_b, 1, order)
        sl = torch.gather(lab, 1, order)
        sv = torch.gather(val, 1, order)
        ssz = torch.where(sv, ss, 0.0)
        cnt = sv.sum(1)
        gains = prog["gain"][sl]
        disc = prog["disc"][m]
        best = ssz[:, 0]
        worst = torch.gather(ssz, 1, (cnt - 1).clamp(min=0)[:, None])[:, 0]
        gi, gj = gains[:, :Tm, None], gains[:, None, :]
        si, sj = ssz[:, :Tm, None], ssz[:, None, :]
        di, dj = disc[None, :Tm, None], disc[None, None, :]
        li, lj = sl[:, :Tm, None], sl[:, None, :]
        ar = torch.arange(m, device=sc_b.device)
        pair_ok = ((ar[None, None, :] > ar[None, :Tm, None]) & (li != lj)
                   & sv[:, :Tm, None] & sv[:, None, :])
        delta = (gi - gj).abs() * (di - dj).abs() * ch["imd"][:, None, None]
        if self.norm:
            delta = torch.where((best != worst)[:, None, None],
                                delta / (0.01 + (si - sj).abs()), delta)
        i_is_high = li > lj
        d_s = torch.where(i_is_high, si - sj, sj - si)
        p = 1.0 / (1.0 + torch.exp(sig * d_s))
        del d_s
        p_lambda = torch.where(pair_ok, -sig * delta * p, 0.0)
        p_hess = torch.where(pair_ok, p * (1.0 - p) * (sig * sig) * delta,
                             0.0)
        del p, delta, pair_ok
        signed = torch.where(i_is_high, p_lambda, -p_lambda)
        lam_s = torch.zeros_like(sc_b)
        lam_s[:, :Tm] = signed.sum(2)
        lam_s = lam_s - signed.sum(1)
        del signed
        hes_s = torch.zeros_like(sc_b)
        hes_s[:, :Tm] = p_hess.sum(2)
        hes_s = hes_s + p_hess.sum(1)
        if self.norm:
            sum_lam = -2.0 * p_lambda.sum((1, 2))
            nf = torch.where(sum_lam > 0,
                             torch.log2(1.0 + sum_lam)
                             / sum_lam.clamp(min=K_EPSILON), 1.0)
            lam_s = lam_s * nf[:, None]
            hes_s = hes_s * nf[:, None]
        lam = torch.empty_like(lam_s).scatter_(1, order, lam_s)
        hes = torch.empty_like(hes_s).scatter_(1, order, hes_s)
        return lam, hes

    def _one_query(self, qid, label, score):
        cnt = len(label)
        lambdas = np.zeros(cnt)
        hessians = np.zeros(cnt)
        if cnt <= 1 or self.inverse_max_dcgs[qid] == 0.0:
            return lambdas, hessians
        inv_max_dcg = self.inverse_max_dcgs[qid]
        order = np.argsort(-score, kind="stable")
        sl = label[order].astype(np.int64)
        ss = score[order].astype(np.float64)
        best_score, worst_score = ss[0], ss[-1]
        gains = self.label_gain[sl]
        disc = _discounts(cnt)
        T = min(self.truncation_level, cnt - 1)
        gi, gj = gains[:T, None], gains[None, :]
        si, sj = ss[:T, None], ss[None, :]
        di, dj = disc[:T, None], disc[None, :]
        li, lj = sl[:T, None], sl[None, :]
        valid = (np.arange(cnt)[None, :] > np.arange(T)[:, None]) & (li != lj)
        delta_ndcg = np.abs(gi - gj) * np.abs(di - dj) * inv_max_dcg
        if self.norm and best_score != worst_score:
            delta_ndcg = delta_ndcg / (0.01 + np.abs(si - sj))
        i_is_high = li > lj
        d_s = np.where(i_is_high, si - sj, sj - si)
        p = 1.0 / (1.0 + np.exp(self.sigmoid * d_s))
        p_lambda = np.where(valid, -self.sigmoid * delta_ndcg * p, 0.0)
        p_hess = np.where(valid, p * (1.0 - p) * self.sigmoid * self.sigmoid
                          * delta_ndcg, 0.0)
        sign_i = np.where(i_is_high, 1.0, -1.0)
        lam_sorted = np.zeros(cnt)
        hes_sorted = np.zeros(cnt)
        lam_sorted[:T] += (p_lambda * sign_i).sum(axis=1)
        np.add.at(lam_sorted, np.broadcast_to(np.arange(cnt)[None, :],
                                              p_lambda.shape).ravel(),
                  (-p_lambda * sign_i).ravel())
        hes_sorted[:T] += p_hess.sum(axis=1)
        np.add.at(hes_sorted, np.broadcast_to(np.arange(cnt)[None, :],
                                              p_hess.shape).ravel(),
                  p_hess.ravel())
        sum_lambdas = -2.0 * p_lambda.sum()
        if self.norm and sum_lambdas > 0:
            nf = np.log2(1 + sum_lambdas) / sum_lambdas
            lam_sorted *= nf
            hes_sorted *= nf
        lambdas[order] = lam_sorted
        hessians[order] = hes_sorted
        return lambdas, hessians


class RankXENDCG(RankingObjective):
    """ref: rank_objective.hpp:362 RankXENDCG; the JAX package's bucketed
    device program (ranking.py:393-474) in float64, and its host loop's
    per-query NumPy streams under position bias (:387-391, :476-499)."""
    name = "rank_xendcg"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.rands = [np.random.RandomState(self.seed + q)
                      for q in range(self.num_queries)]
        # gradient calls since the device program was built (the uniform
        # stream's `it`)
        self._xe_iter = 0

    def _build(self, n_pad, dev, shard=None):
        prog = super()._build(n_pad, dev, shard)
        prog["key"] = jrandom.PRNGKey(self.seed, device=dev)
        self._xe_iter = 0
        return prog

    def _iteration_draws(self, prog):
        """Position bias: this iteration's per-query NumPy draws, [n_pad]
        float64 on the device (None on the threefry path)."""
        if self.positions is None:
            return None
        qb = self.query_boundaries
        u = np.zeros(prog["n_pad"])
        for q in range(self.num_queries):
            a, b = int(qb[q]), int(qb[q + 1])
            if b - a > 1:
                u[a:b] = self.rands[q].random_sample(b - a)
        return torch.from_numpy(u).to(prog["dev"])

    def _block(self, sc_b, ch, prog, u_rows):
        """[Qc, m] padded query block -> (lambdas, hessians) float64
        (`_one_query`, vectorized; zeros for a query of one document)."""
        val = ch["val"]
        if u_rows is None:
            key_it = jrandom.fold_in(prog["key"], self._xe_iter)
            u = jrandom.uniform(jrandom.fold_in(key_it, ch["qid"]),
                                (ch["m"],)).to(_F64)
        else:
            u = u_rows[ch["idx"]]
        scm = torch.where(val, sc_b, -torch.inf)
        mx = scm.max(1, keepdim=True).values
        e = torch.where(val, torch.exp(sc_b - mx), 0.0)
        rho = e / e.sum(1, keepdim=True).clamp(min=K_EPSILON)
        params = torch.where(val, torch.exp2(ch["lab"].to(_F64)) - u, 0.0)
        inv_den = 1.0 / params.sum(1, keepdim=True).clamp(min=K_EPSILON)
        # guards only 1 - rho == 0 (the host loop would divide by 0)
        one_m = (1.0 - rho).clamp(min=1e-300)
        l1 = torch.where(val, -params * inv_den + rho, 0.0)
        lambdas = l1
        p1 = l1 / one_m
        l2 = torch.where(val, rho * (p1.sum(1, keepdim=True) - p1), 0.0)
        lambdas = lambdas + l2
        p2 = l2 / one_m
        lambdas = lambdas + torch.where(
            val, rho * (p2.sum(1, keepdim=True) - p2), 0.0)
        keep = (val.sum(1) > 1)[:, None] & val
        return (torch.where(keep, lambdas, 0.0),
                torch.where(keep, rho * (1.0 - rho), 0.0))

    def get_gradients(self, score, label=None, weight=None, shard=None):
        out = super().get_gradients(score, label, weight, shard)
        if self.positions is None:
            self._xe_iter += 1
        return out

    def _one_query(self, qid, label, score):
        cnt = len(label)
        if cnt <= 1:
            return np.zeros(cnt), np.zeros(cnt)
        sc = score.astype(np.float64)
        e = np.exp(sc - sc.max())
        rho = e / e.sum()
        params = np.power(2.0, label.astype(np.int64)) - \
            self.rands[qid].random_sample(cnt)
        inv_denominator = 1.0 / max(K_EPSILON, params.sum())
        l1 = -params * inv_denominator + rho
        lambdas = l1.copy()
        params = l1 / (1.0 - rho)
        sum_l1 = params.sum()
        l2 = rho * (sum_l1 - params)
        lambdas += l2
        params = l2 / (1.0 - rho)
        sum_l2 = params.sum()
        lambdas += rho * (sum_l2 - params)
        hessians = rho * (1.0 - rho)
        return lambdas, hessians


def create_ranking_objective(name: str, config: Config) -> RankingObjective:
    if name == "lambdarank":
        return LambdarankNDCG(config)
    if name == "rank_xendcg":
        return RankXENDCG(config)
    log.fatal(f"Unknown ranking objective: {name}")
