"""Elastic shrink-to-fit policy for the distributed supervisor (PyTorch
port of `lightgbm_tpu/reliability/elastic.py`, pure Python: the port
keeps its own copy).

The reference engine's `Network::Init` sizes a socket ring once: lose a
machine and the run is over.  Relaunching the whole cluster at the
original world size still loops forever when a rank is PERMANENTLY gone
— a dead host, a revoked reservation, a tombstoned worker.
`ElasticPolicy` closes that gap: it watches the per-attempt failure
reports and decides when a rank should stop being waited for and the
cluster should shrink around it.

A rank is classified permanently lost when

* it exited with `WORKER_LOST_EXIT_CODE` (it tombstoned itself — the
  drillable `worker_lost@N` fault), or
* the SAME rank has failed on consecutive relaunch attempts (dead PID
  or stale heartbeat alike) spanning at least `rank_grace_s` seconds —
  a transient crash recovers on the first relaunch; one that keeps
  recurring on one rank past the grace window is a host problem, not a
  software race.

Preemption (`kind == "preempt"`) never counts toward permanence: a
preempted host is expected back, so the policy answers "retry".

The decision is advisory — `distributed._train_distributed_in` owns the
relaunch loop and composes this with the degradation ladder
(reliability/guard.py; shrink first, then walk knobs: a shrink changes
the collective topology, which invalidates any hang evidence gathered on
the old one).  The relaunched ranks resume from the checkpoint, whose
state is the serial run's, and each re-derives its rows from the
checkpoint's row count (`plan_for_shrink`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .supervisor import SuperviseResult

# actions, in the order _train_distributed_in consults them
RETRY = "retry"        # relaunch at the current world size
SHRINK = "shrink"      # relaunch at a smaller world size
GIVE_UP = "give_up"    # permanent loss below the min-machines floor


@dataclass
class ElasticDecision:
    action: str
    num_machines: int              # world size for the next attempt
    lost_ranks: List[int] = field(default_factory=list)
    reason: str = ""


@dataclass
class _Streak:
    count: int
    first_ts: float


class ElasticPolicy:
    """Tracks per-rank failure streaks across relaunch attempts and
    turns them into shrink decisions.  Pure bookkeeping — no I/O — so
    it is drillable without processes (tests/test_torch_elastic.py)."""

    def __init__(self, num_machines: int, min_machines: int = 1,
                 rank_grace_s: float = 60.0, clock=time.monotonic):
        self.num_machines = int(num_machines)
        self.min_machines = max(int(min_machines), 1)
        self.rank_grace_s = float(rank_grace_s)
        self._clock = clock
        self._streaks: Dict[int, _Streak] = {}
        self.shrinks = 0

    # ------------------------------------------------------------ policy
    def _permanent(self, result: SuperviseResult) -> List[int]:
        now = self._clock()
        failed = {f.rank: f for f in result.failures}
        # a rank that did NOT fail this attempt has proven itself alive:
        # its streak resets (alternating-rank crashes are a cluster
        # problem, not a single lost host)
        for rank in list(self._streaks):
            if rank not in failed:
                del self._streaks[rank]
        lost: List[int] = []
        for rank, f in failed.items():
            if f.kind == "preempt":
                self._streaks.pop(rank, None)
                continue
            if f.kind == "lost":
                lost.append(rank)
                continue
            streak = self._streaks.get(rank)
            if streak is None:
                self._streaks[rank] = _Streak(1, now)
                continue
            streak.count += 1
            if streak.count >= 2 and now - streak.first_ts \
                    >= self.rank_grace_s:
                lost.append(rank)
        return sorted(lost)

    def observe(self, result: SuperviseResult) -> ElasticDecision:
        """Digest one failed attempt's SuperviseResult into the next
        attempt's topology.  Call once per failed attempt."""
        lost = self._permanent(result)
        if not lost:
            return ElasticDecision(RETRY, self.num_machines,
                                   reason="no rank classified "
                                          "permanently lost")
        new_n = self.num_machines - len(lost)
        if new_n < self.min_machines:
            return ElasticDecision(
                GIVE_UP, self.num_machines, lost_ranks=lost,
                reason=f"rank(s) {lost} permanently lost but shrinking to "
                       f"{new_n} would cross elastic_min_machines="
                       f"{self.min_machines}")
        old_n = self.num_machines
        self.num_machines = new_n
        self.shrinks += 1
        for rank in lost:
            self._streaks.pop(rank, None)
        # rank indices renumber with the new world size: old streak
        # anchors would blame the wrong hosts
        self._streaks.clear()
        return ElasticDecision(
            SHRINK, new_n, lost_ranks=lost,
            reason=f"rank(s) {lost} permanently lost; shrinking "
                   f"{old_n} -> {new_n}")


def plan_for_shrink(old_n: int, new_n: int,
                    num_rows: Optional[int]):
    """The deterministic row plan the `elastic_shrink` event records —
    every rank (and the parent) derives the identical plan from the
    checkpoint's row count; None when the row count is unknown (no
    checkpoint yet: the relaunch rebins from scratch anyway)."""
    if not num_rows:
        return None
    from ..parallel import reshard_plan
    return reshard_plan(old_n, new_n, int(num_rows))
