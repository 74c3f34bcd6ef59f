"""Data-parallel GBDT over torch.distributed (PyTorch port of
`lightgbm_tpu/parallel/data_parallel.py`; ref: SURVEY.md §2.3 #3).

Mapping from the reference's DataParallelTreeLearner
(ref: src/treelearner/data_parallel_tree_learner.cpp):

  reference (socket collectives)              this port (one process per rank)
  ------------------------------------------- -------------------------------
  rows pre-partitioned per machine            rank r holds rows rows_of(N, k, r)
                                                on its device (parallel/elastic.py)
  local histograms then Network::ReduceScatter  each rank's Hopper kernels on its
    + HistogramSumReducer (:284)                rows, then an all-reduce of the
                                                int64 fixed-point sums
  SyncUpGlobalBestSplit allreduce of           the split scan runs on every rank
    serialized SplitInfo (:441)                 over the same reduced histograms:
                                                no sync needed
  root sums Allreduce in BeforeTrain (:167)    exact limb sums (`exact_sum`)
  global_data_count_in_leaf_ tracking (:450)   int64 counts all-reduced

The JAX package psums float32 histograms inside one SPMD program; here
every reduced quantity is an integer (the kernels' 64-bit fixed-point
sums on the serial run's grid, K2's quantized sums, row counts) or a
maximum, so a sharded run grows the serial run's trees bit for bit.

One process per card is how torch shards: a rank's device is
`cuda:(local_rank % device_count)`, or the CPU under device_type=cpu.
The backend follows one rule for the whole cluster: NCCL where every
rank has a card of its own, gloo on the CPU or where ranks share one
card (`backend_for` answers for one host, `distributed.cluster_backend`
for all of them).  gloo takes CUDA tensors for all_reduce; its all_gather goes
through an explicit host copy.

`Network` is one rank's handle on the group: the reductions the engines
call, each under the `Network::allreduce` timer scope, counting calls,
bytes and seconds.

The learner table `DATA_LEARNERS` (ref: tree_learner.cpp:15
CreateTreeLearner) names the axis each parallel learner shards: `data`
and `voting` shard the rows (`RowShard`; voting reduces only the
histograms of the features its ranks elect, parallel/voting.py),
`feature` shards the device columns (`ColumnBlock`): every rank keeps
every row, histograms and scans its block of columns, and the ranks
all-gather each scan's per-leaf best split (ref:
feature_parallel_tree_learner.cpp:30-70).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from ..utils.timer import global_timer
from .elastic import rows_of

# tree_learner -> the axis its ranks shard inside a process group
DATA_LEARNERS = {"data": "rows", "voting": "rows", "feature": "columns"}


def backend_for(device_type: str, local_ranks: int) -> str:
    """The process group's backend: "nccl" when the ranks train on the
    card and every local rank has a card of its own, else "gloo" (the
    CPU, or several ranks sharing one card, which NCCL refuses)."""
    dt = str(device_type).strip().lower()
    if dt in ("cuda", "gpu") and torch.cuda.is_available():
        if local_ranks <= torch.cuda.device_count():
            return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of a rank: `cuda:(local_rank % device_count)`, or the
    CPU under device_type=cpu.  Call before any tensor is made; it sets
    the current CUDA device."""
    dt = str(device_type).strip().lower()
    if dt == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device_type={device_type!r} needs a CUDA device and torch "
            "sees none; pass device_type='cpu' to run on the CPU")
    idx = int(local_rank) % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


class Network:
    """One rank's handle on a torch.distributed group (the reference's
    `Network` class, ref: network.h:89).  `calls`, `bytes` and
    `seconds` accumulate over every collective; the seconds are host
    wall time after the device finished the collective's inputs."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def stats(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds, "backend": self.backend,
                "world": self.world}

    def _run(self, t: torch.Tensor, fn):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        with global_timer.scope("Network::allreduce"):
            out = fn()
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        return out

    def _all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        # at world 1 only NCCL runs the call (the card's one-rank check)
        if self.world > 1 or self.backend == "nccl":
            self._run(t, lambda: self._dist.all_reduce(t, op=op,
                                                       group=self.group))
        return t

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum over the ranks.  Integer tensors are exact
        whatever the order of the additions."""
        return self._all_reduce(t, self._dist.ReduceOp.SUM)

    def all_reduce_max_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place maximum over the ranks (exact)."""
        return self._all_reduce(t, self._dist.ReduceOp.MAX)

    def all_reduce_min_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place minimum over the ranks (exact)."""
        return self._all_reduce(t, self._dist.ReduceOp.MIN)

    def barrier(self) -> None:
        """Wait for every rank (not counted among the collectives)."""
        if self.world > 1:
            self._dist.barrier(group=self.group)

    def all_gather_rows(self, t: torch.Tensor,
                        sizes: Sequence[int]) -> torch.Tensor:
        """Concatenate every rank's `t [..., sizes[rank]]` along the last
        axis, in rank order.  The pieces are padded to the largest size
        for the collective (gloo's all_gather through a host copy)."""
        if self.world == 1:
            return t
        m = max(sizes)
        pad = t.new_zeros(t.shape[:-1] + (m,))
        pad[..., :t.shape[-1]] = t
        src = pad.cpu() if self.backend == "gloo" else pad.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        self._run(src, lambda: self._dist.all_gather(parts, src,
                                                     group=self.group))
        out = torch.cat([p[..., :s] for p, s in zip(parts, sizes)], -1)
        return out.to(t.device)


_network: Optional[Network] = None


def current_network() -> Optional[Network]:
    """The Network of the default process group, or None when no group
    is initialized (a single process trains serially).  One Network per
    group, so its counters span every run the group trains."""
    global _network
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _network is None:
        _network = Network()
        log.info(f"Data-parallel network: rank {_network.rank}/"
                 f"{_network.world} over {_network.backend}")
    return _network


def forget_network() -> None:
    """Drop the cached Network (with the process group it serves)."""
    global _network
    _network = None


class RowShard:
    """The training rows one rank owns and how they map onto the serial
    run's: rows [start, stop) of the global `rows_of` split, padded on
    the device to `n_pad` (its own multiple of `pad`), and `grid_rows`,
    the row count the serial run pads to (the fixed-point grid's row
    count and the shape of the serial run's random streams)."""

    def __init__(self, net: Network, num_rows: int, pad: int):
        self.net = net
        self.num_rows = int(num_rows)
        self.start, self.stop = rows_of(num_rows, net.world, net.rank)
        self.sizes: List[int] = [b - a for a, b in (
            rows_of(num_rows, net.world, r) for r in range(net.world))]
        self.n_pad = max(pad, -(-self.count // pad) * pad)
        self.grid_rows = -(-self.num_rows // pad) * pad
        # the serial run pads too: its padding rows (the same values on
        # every rank) join the maxima it takes over every row
        self.serial_pads = self.grid_rows > self.num_rows

    @property
    def count(self) -> int:
        return self.stop - self.start

    def local(self, a):
        """A host array over the global rows (last axis) -> this rank's
        rows, zero-padded to n_pad."""
        a = np.asarray(a)
        out = np.zeros(a.shape[:-1] + (self.n_pad,), a.dtype)
        out[..., :self.count] = a[..., self.start:self.stop]
        return out

    def serial_rows(self, t: torch.Tensor) -> torch.Tensor:
        """`t [n_pad]` limited to the rows whose values the serial run's
        maxima read: the real rows, and the padding when the serial run
        has padding too."""
        return t if self.serial_pads else t[:self.count]

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        return self.net.all_reduce_max_(t)

    def uniform(self, key, device) -> torch.Tensor:
        """This rank's rows of the serial run's threefry uniforms
        (`utils/random.py uniform` over [grid_rows]), padded to n_pad;
        each rank draws the whole stream and keeps its slice."""
        from ..utils import random as jrandom
        u = jrandom.uniform(key, (self.grid_rows,), device=device)
        out = torch.zeros(self.n_pad, dtype=u.dtype, device=device)
        out[:self.count] = u[self.start:self.stop]
        return out


# ------------------------------------------------------------ exact sums
_LIMB_BITS = 31
_LIMBS = 3


def exact_sum(values: torch.Tensor, segments: torch.Tensor = None,
              num_segments: int = 1,
              net: Optional[Network] = None) -> torch.Tensor:
    """Sum of float32 `values` (per segment id in `segments`, else of
    all), float64 [num_segments], the same bits whatever the order of
    the rows and however they are split over ranks.  Each value is cut
    into three 31-bit integer limbs below 2^E, where 2^E bounds every
    rank's max |value| (an exact all-reduced maximum): the limbs'
    int64 sums are exact, all-reduced when `net` is given, and
    recombined once.  Parts of a value below 2^(E-93) are dropped (the
    same on every rank).  At most 2^32 rows."""
    v = values.to(torch.float64)
    dev = v.device
    amax = (v.abs().max() if v.numel() else v.new_zeros(())).reshape(1)
    if net is not None:
        net.all_reduce_max_(amax)
    _, e = torch.frexp(amax)
    e = e.to(torch.int64)
    ids = None if segments is None else segments.to(torch.int64)
    acc = torch.zeros((_LIMBS, num_segments), dtype=torch.int64, device=dev)
    rest = v
    grids = []
    for k in range(1, _LIMBS + 1):
        g = torch.ldexp(torch.ones(1, dtype=torch.float64, device=dev),
                        e - _LIMB_BITS * k)
        q = torch.trunc(rest / g)
        rest = rest - q * g
        if ids is None:
            acc[k - 1] = q.to(torch.int64).sum()
        else:
            acc[k - 1].index_add_(0, ids, q.to(torch.int64))
        grids.append(g)
    if net is not None:
        net.all_reduce_sum_(acc)
    out = acc[0].to(torch.float64) * grids[0]
    for k in range(1, _LIMBS):
        out = out + acc[k].to(torch.float64) * grids[k]
    return out


# ------------------------------------------------------- feature-parallel
# SplitResult fields in the packed record a feature-parallel rank
# all-gathers (the cat bitset words follow them)
_RECORD = ("gain", "feature", "threshold", "default_left",
           "left_sum_gradient", "left_sum_hessian", "left_count",
           "left_output", "right_sum_gradient", "right_sum_hessian",
           "right_count", "right_output", "is_cat")
# find_best_split keyword arguments with a feature axis: last, or the
# one before the last
_F_LAST = ("rand_bin", "is_cat_feature", "monotone", "cegb_coupled",
           "cegb_used", "cegb_lazy_cost")
_F_SECOND = ("rand_cat_u", "constraint_min_left", "constraint_max_left",
             "constraint_min_right", "constraint_max_right")


class ColumnBlock:
    """The device columns one feature-parallel rank histograms and scans
    (ref: feature_parallel_tree_learner.cpp:30 BeforeTrain, which
    balances feature subsets over the machines): columns [start, stop)
    of the `rows_of` split of the F' device columns (bundle columns
    under EFB), and `features`, the features whose column lies in the
    block.  Blocks may be unequal, and a rank holds none when the world
    outnumbers the columns.

    `best_split` runs the split scan over the block's features and
    merges every rank's per-leaf best with one all-gather: the largest
    gain, and on a tie the lowest feature index, which is the serial
    scan's first maximum (`torch.argmax`).  A feature's gains do not
    depend on the other features of the scan, so the merged split is
    the serial run's bit for bit."""

    def __init__(self, net: Network, meta, num_columns: int):
        self.net = net
        self.start, self.stop = rows_of(num_columns, net.world, net.rank)
        F = int(meta.num_bin.shape[0])
        self.num_features = F
        col = (np.arange(F) if meta.group is None
               else meta.group.cpu().numpy().astype(np.int64))
        feats = np.nonzero((col >= self.start) & (col < self.stop))[0]
        self.features = feats
        dev = meta.num_bin.device
        self._idx = torch.from_numpy(feats.astype(np.int64)).to(dev)
        self._local = {int(f): i for i, f in enumerate(feats)}
        self.meta = meta._replace(**{
            k: (None if v is None else v.index_select(0, self._idx))
            for k, v in meta._asdict().items()})
        if meta.group is not None:
            self.meta = self.meta._replace(group=self.meta.group - self.start)

    def local_index(self, feature: int) -> Optional[int]:
        """The block's index of a global feature, None where another
        rank holds it."""
        return self._local.get(int(feature))

    def split_params(self, sp):
        """SplitParams of the block's scan: the categorical features'
        block indices (none: the categorical branch is skipped, which
        changes no numerical feature's record)."""
        if not sp.has_categorical:
            return sp
        cats = sp.cat_features or tuple(range(self.num_features))
        local = tuple(self._local[f] for f in cats if f in self._local)
        if not local:
            return sp._replace(has_categorical=False, cat_features=())
        return sp._replace(cat_features=local)

    def _slice(self, t: torch.Tensor, axis: int) -> torch.Tensor:
        return t.index_select(axis, self._idx)

    def best_split(self, hist, col_mask, sum_gradient, sum_hessian,
                   num_data, parent_output, params, **kw):
        """`find_best_split` over the block: `hist` [L, F_blk, B, 2] holds
        the block's per-feature histograms, every other argument is the
        serial scan's (over all F features) and is sliced here.
        Returns the merged SplitResult [L], global feature indices."""
        from ..ops.split import cat_bitset_words, find_best_split
        if not len(self.features):
            return self.merge(self.sentinel(
                sum_gradient.shape[0], cat_bitset_words(hist.shape[-2]),
                sum_gradient.device))
        for k in _F_LAST:
            if kw.get(k) is not None:
                kw[k] = self._slice(kw[k], kw[k].dim() - 1)
        for k in _F_SECOND:
            if kw.get(k) is not None:
                kw[k] = self._slice(kw[k], kw[k].dim() - 2)
        m = self.meta
        res = find_best_split(
            hist, m.num_bin, m.missing_type, m.default_bin, m.penalty,
            self._slice(col_mask, col_mask.dim() - 1), sum_gradient,
            sum_hessian, num_data, parent_output, self.split_params(params),
            **kw)
        res = res._replace(feature=self._idx[res.feature.to(
            torch.int64)].to(torch.int32))
        return self.merge(res)

    def sentinel(self, L: int, W: int, device):
        """The record of a rank with no candidate: gain K_MIN_SCORE and
        a feature index above every real one, so it never wins."""
        from ..ops.split import K_MIN_SCORE, SplitResult
        f32, i32 = torch.float32, torch.int32
        z = {k: torch.zeros(L, dtype=f32, device=device) for k in _RECORD}
        z["gain"] = torch.full((L,), K_MIN_SCORE, device=device)
        for k in ("feature", "threshold", "left_count", "right_count"):
            z[k] = torch.zeros(L, dtype=i32, device=device)
        z["feature"].fill_(self.num_features)
        for k in ("default_left", "is_cat"):
            z[k] = torch.zeros(L, dtype=torch.bool, device=device)
        return SplitResult(cat_bitset=torch.zeros((L, W), dtype=i32,
                                                  device=device), **z)

    def merge(self, res):
        """Every rank's per-leaf best -> the global best, the same on
        every rank: one all-gather of the packed records."""
        from ..ops.split import SplitResult
        if self.net.world == 1:
            return res
        i32 = torch.int32
        L, W = res.cat_bitset.shape
        cols = []
        for k in _RECORD:
            v = getattr(res, k)
            cols.append(v.contiguous().view(i32) if v.dtype == torch.float32
                        else v.to(i32))
        rec = torch.cat([torch.stack(cols, 1), res.cat_bitset.to(i32)], 1)
        R = rec.shape[1]
        flat = rec.reshape(-1)
        every = self.net.all_gather_rows(
            flat, [flat.numel()] * self.net.world).view(self.net.world, L, R)
        gain = every[:, :, 0].view(torch.float32)
        feat = every[:, :, 1]
        top = gain.max(0).values
        cand = torch.where(gain == top[None, :], feat,
                           torch.full_like(feat, 2 ** 31 - 1))
        won = cand.argmin(0)
        pick = every[won, torch.arange(L, device=won.device)]      # [L, R]
        out = {}
        for i, k in enumerate(_RECORD):
            ref = getattr(res, k)
            v = pick[:, i].contiguous()
            out[k] = (v.view(torch.float32) if ref.dtype == torch.float32
                      else v.to(ref.dtype))
        return SplitResult(cat_bitset=pick[:, len(_RECORD):].contiguous(),
                           **out)

    def merge_one(self, res, feature: int, W: int, device):
        """One forced split's record (0-d fields, [W] bitset) from the rank
        that holds `feature` (`res` None on the others)."""
        from ..ops.split import SplitResult
        if res is None:
            one = self.sentinel(1, W, device)
        else:
            one = SplitResult(**{k: v.reshape((1,) + tuple(v.shape))
                                 for k, v in res._asdict().items()})
            one = one._replace(feature=torch.full(
                (1,), int(feature), dtype=torch.int32, device=device))
        out = self.merge(one)
        return SplitResult(**{k: v[0] for k, v in out._asdict().items()})
