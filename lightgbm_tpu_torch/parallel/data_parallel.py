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
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from ..utils.timer import global_timer
from .elastic import rows_of

DATA_LEARNERS = ("data",)


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
