"""Deterministic row resharding (PyTorch port of
`lightgbm_tpu/parallel/elastic.py`, pure Python).

`rows_of` is also the data-parallel row split: rank r of a world of k
owns rows `rows_of(num_rows, k, r)` of the training set
(parallel/data_parallel.py).  When the distributed supervisor shrinks a
cluster around a permanently lost rank (`distributed.train_distributed`
with `reliability/elastic.py`'s policy), every surviving rank must agree
— without any communication — on how the training rows map onto the
new, smaller world.  The reference engine cannot do this at all:
its `Network::Init` ring is sized once and a lost machine ends the run.

`reshard_plan` is that agreement: a pure function of
`(old_n, new_n, num_rows)` only, so every rank (and the supervising
parent) computes the identical plan from the checkpoint's recorded row
count.  Rows are balanced-contiguous partitioned exactly like
`np.array_split`: shard `i` of `k` owns `rows_of(num_rows, k, i)`, the
block layout of the JAX package's 1-D row sharding, so the plan
doubles as documentation of which host held which rows before and after
the shrink.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple


def rows_of(num_rows: int, world: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of the contiguous row block shard `rank` of `world`
    owns — balanced like np.array_split: the first `num_rows % world`
    shards get one extra row."""
    if world <= 0:
        raise ValueError(f"world size must be positive, got {world}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside world of {world}")
    q, r = divmod(int(num_rows), world)
    start = rank * q + min(rank, r)
    return start, start + q + (1 if rank < r else 0)


class ShardSegment(NamedTuple):
    """One contiguous run of rows moving (old_rank -> new_rank)."""
    new_rank: int
    old_rank: int
    start: int   # global row index, inclusive
    stop: int    # global row index, exclusive


class ReshardPlan(NamedTuple):
    old_n: int
    new_n: int
    num_rows: int
    segments: Tuple[ShardSegment, ...]

    def sources_of(self, new_rank: int) -> List[ShardSegment]:
        return [s for s in self.segments if s.new_rank == new_rank]

    def moved_rows(self) -> int:
        """Rows whose owner changed — the D2D/DCN traffic a live
        reshard would pay (informational; the local launcher reloads
        from host arrays instead)."""
        return sum(s.stop - s.start for s in self.segments
                   if s.old_rank != s.new_rank)

    def summary(self) -> dict:
        """Compact JSON-able form for the `elastic_shrink` event."""
        return {"old_n": self.old_n, "new_n": self.new_n,
                "num_rows": self.num_rows,
                "moved_rows": self.moved_rows(),
                "segments": len(self.segments)}


def reshard_plan(old_n: int, new_n: int, num_rows: int) -> ReshardPlan:
    """Deterministic mapping of row ownership from an `old_n`-rank mesh
    onto a `new_n`-rank mesh.

    Pure arithmetic — no RNG, no clock, no environment — so any two
    processes given the same three integers produce byte-identical
    plans.  Segments are emitted in
    (new_rank, start) order; together they cover [0, num_rows) exactly
    once.
    """
    if old_n <= 0 or new_n <= 0:
        raise ValueError(f"world sizes must be positive "
                         f"(old={old_n}, new={new_n})")
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0, got {num_rows}")
    segments: List[ShardSegment] = []
    for nr in range(new_n):
        n_start, n_stop = rows_of(num_rows, new_n, nr)
        for orank in range(old_n):
            o_start, o_stop = rows_of(num_rows, old_n, orank)
            lo, hi = max(n_start, o_start), min(n_stop, o_stop)
            if lo < hi:
                segments.append(ShardSegment(nr, orank, lo, hi))
    return ReshardPlan(int(old_n), int(new_n), int(num_rows),
                       tuple(segments))
