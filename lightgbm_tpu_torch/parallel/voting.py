"""Voting-parallel (PV-Tree) tree learner over torch.distributed
(PyTorch port of `lightgbm_tpu/parallel/voting.py`; ref:
src/treelearner/voting_parallel_tree_learner.cpp:151-181 GlobalVoting,
:184 CopyLocalHistogram, :296 FindBestSplitsFromHistograms):

  reference (socket collectives)            this port (one process per rank)
  ----------------------------------------- -------------------------------
  rows pre-partitioned per machine          rank r holds rows rows_of(N, k, r)
  local histograms per worker               K4 over the rank's rows of the
                                              leaf, int64 on the serial
                                              run's fixed-point grid
  local best split per feature with         find_best_split(...,
    min_data/min_hessian scaled by 1/M        return_feature_gains=True) on
    (voting_parallel_tree_learner.cpp:62)     the local sums, scaled params
  each worker proposes its top-k features   top-k of the count-weighted
    by gain*count/mean_count (:165)           local gains (the leaf's count
                                              over every rank: the engine's,
                                              else an integer all-reduce)
  Allgather proposals; global election =    all_reduce_max_ of the [F]
    top-k features by max weighted gain       proposal vectors, then top-k
    (GlobalVoting :151)                       (ties: the lower feature)
  ReduceScatter ONLY the elected            all_reduce_sum_ of the elected
    features' histograms (:184)               [k, B, 2] int64 histograms
  best split among elected features,        the engine's scan with
    SyncUpGlobalBestSplit (:296)              col_mask &= elected, the same
                                              on every rank

The point of PV-Tree is traffic: a scan's reduction carries
k*B*2*8 + F*4 bytes (and 8 for the count where the caller does not know
it) instead of the whole F*B*2*8-byte histogram.  The
elected histograms are the ranks' integer sums on the serial grid, so
they equal the serial run's histograms of those features exactly, and a
vote that elects every feature a serial scan would split on (`top_k` >=
F) grows the serial trees.

Approximation note (as in the reference): the election ranks features
by unconstrained local gains; monotone, CEGB and extra-trees apply in the
exact scan over the elected features.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.histogram import build_histogram_rows_fixed, fixed_unit, from_fixed
from ..ops.split import K_MIN_SCORE, SplitParams, find_best_split
from .data_parallel import Network, exact_sum


class VotingSpec(NamedTuple):
    """A voting-parallel run's configuration."""
    net: Network
    top_k: int          # ref: config.h top_k (default 20), at most F
    num_machines: int   # the world M


def local_split_params(sp: SplitParams, num_machines: int) -> SplitParams:
    """The reference scales the per-leaf minima by 1/M for the local scans
    (ref: voting_parallel_tree_learner.cpp:62-63).  The election ranks
    features by plain unconstrained gains: monotone, CEGB and
    extra-trees need per-leaf state the vote does not carry, and they
    apply exactly in the scan over the elected features."""
    return sp._replace(
        min_data_in_leaf=max(1, sp.min_data_in_leaf // num_machines),
        min_sum_hessian_in_leaf=sp.min_sum_hessian_in_leaf / num_machines,
        extra_trees=False, has_monotone=False, has_cegb=False,
        has_cegb_lazy=False)


def elect(weighted: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest values, ties to the lower index (the
    order of `lax.top_k`); the same on every rank given the same
    vector."""
    return torch.sort(-weighted, stable=True).indices[:k]


def voting_hist_elect(rows: torch.Tensor, gh: torch.Tensor,
                      member_mask: torch.Tensor, col_mask: torch.Tensor,
                      parent_output: torch.Tensor, meta, spec: VotingSpec,
                      sp: SplitParams, max_bin: int, exps: torch.Tensor,
                      num_data: torch.Tensor = None):
    """The voted histograms of one leaf, or of k leaves at once (one
    collective of each kind for all of them).

    Args:
      rows: [n, F] row-major bin codes of this rank's rows.
      gh: [n, 2] float32 gradients and hessians (the row mask folded in).
      member_mask: [n] float32, the leaf's rows on this rank ([k, n] for
        k leaves).
      col_mask: [F] bool, the features the leaf may split on ([k, F]).
      parent_output: 0-d float32, the leaf's output ([k]).
      exps: [2] int32, the tree's fixed-point grid (`scale_exps` over
        the serial run's rows).
      num_data: the leaf's row count over every rank ([k]), where the
        caller has it (the leaf-wise engine's all-reduced counts); else
        it is all-reduced here.

    Returns (int64 [F, B, 2] histogram ([k, F, B, 2]), exact on the
    serial grid for the elected features and zero elsewhere, [F] bool
    elected mask ([k, F])).
    """
    one = member_mask.dim() == 1
    masks = member_mask[None] if one else member_mask
    k_leaves = masks.shape[0]
    cms = col_mask if col_mask.dim() == 2 else col_mask[None].expand(
        k_leaves, -1)
    net = spec.net
    M = spec.num_machines
    f32, i64 = torch.float32, torch.int64
    # 1-2. each leaf's local histogram (K4) and sums, not reduced
    h_loc = torch.stack([build_histogram_rows_fixed(
        rows, gh, m.contiguous(), exps, max_bin=max_bin) for m in masks])
    v = gh[None] * masks[:, :, None]                          # [k, n, 2]
    sums = torch.stack([torch.stack([exact_sum(v[j, :, c])[0]
                                     for c in range(2)])
                        for j in range(k_leaves)]).to(f32)    # [k, 2]
    cnt_l = masks.sum(1, dtype=i64)                           # [k]
    # 3. the local scans with the minima divided by M
    is_cat = (meta.is_cat if meta.is_cat is not None
              else torch.zeros_like(meta.num_bin, dtype=torch.bool))
    gains = find_best_split(
        from_fixed(h_loc, fixed_unit(exps)), meta.num_bin,
        meta.missing_type, meta.default_bin, meta.penalty, cms,
        sums[:, 0], sums[:, 1], cnt_l.to(torch.int32),
        parent_output.reshape(k_leaves).to(f32), local_split_params(sp, M),
        is_cat_feature=is_cat, return_feature_gains=True)      # [k, F]
    # 4. count-weighted gains (ref: GlobalVoting :165 gain * count/mean)
    cnt_g = (net.all_reduce_sum_(cnt_l.clone()) if num_data is None
             else num_data.reshape(k_leaves).to(i64))
    w = cnt_l.to(f32) / torch.clamp(cnt_g.to(f32) / M, min=1.0)
    weighted = torch.where(gains > K_MIN_SCORE, gains * w[:, None],
                           torch.full_like(gains, K_MIN_SCORE))
    # 5. this rank's proposal: its top-k features of each leaf
    k = spec.top_k
    kth = torch.stack([weighted[j, elect(weighted[j], k)[-1]]
                       for j in range(k_leaves)])
    prop = torch.where(weighted >= kth[:, None], weighted,
                       torch.full_like(weighted, K_MIN_SCORE))
    # 6. the election: each feature's largest proposed gain over the ranks
    # (GlobalVoting keeps the top-k by the largest weighted gain any
    # worker reported; it never tallies votes), then its top-k
    glob = net.all_reduce_max_(prop.contiguous())
    tops = []
    for j in range(k_leaves):
        top = elect(glob[j], k)
        tops.append(top[glob[j, top] > K_MIN_SCORE])
    # 7. reduce only the elected features' histograms, every leaf's in
    # one call (every rank holds the same election, so every rank skips
    # an empty one alike)
    F = h_loc.shape[1]
    flat = torch.cat([t + j * F for j, t in enumerate(tops)])
    hist = torch.zeros_like(h_loc)
    elected = torch.zeros((k_leaves, F), dtype=torch.bool,
                          device=h_loc.device)
    if flat.numel():
        hist.view(k_leaves * F, *h_loc.shape[2:]).index_copy_(
            0, flat, net.all_reduce_sum_(h_loc.reshape(
                k_leaves * F, *h_loc.shape[2:]).index_select(
                    0, flat).contiguous()))
        elected.view(-1).index_fill_(0, flat, True)
    if one:
        return hist[0], elected[0]
    return hist, elected
