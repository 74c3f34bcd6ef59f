"""Fault tolerance for long training runs (PyTorch port of
`lightgbm_tpu/reliability/`):

* checkpoint/resume — `CheckpointManager` writes atomic, rotated
  checkpoints (model text + exact trainer state) so a job killed at
  iteration k restarts from k, not from zero (`checkpoint.py`); the
  layout is the JAX package's, so either package resumes the other's.
* fault injection — env-driven crash/NaN/hang/write-failure hooks so the
  recovery paths are testable without real hardware faults
  (`faults.py`, `LGBM_TPU_FAULT=worker_crash@3,...`).
* stall watchdog + degradation ladder — `guard.py` turns live-but-hung
  runs into a structured stall diagnosis and a distinct exit code, and
  with `auto_degrade=true` relaunches from checkpoint with the next
  risky knob disabled.

* supervision — `supervisor.py` watches the ranks that
  `distributed.train_distributed` spawns: the first failed rank, a
  stale heartbeat or the deadline kills the cluster.

* elastic recovery — `elastic.py`'s `ElasticPolicy` turns a rank lost
  for good into a smaller world for the next attempt, which resumes from
  the group's checkpoints (`train_distributed`'s relaunch loop).
"""

from __future__ import annotations

from ..utils.log import LightGBMError


class NonFiniteError(LightGBMError):
    """Raised when NaN/Inf gradients or eval scores are detected: boosting
    on non-finite values silently produces garbage trees, so training
    fails fast (or rolls back to the last checkpoint when one exists)."""


from . import faults  # noqa: E402
from .checkpoint import Checkpoint, CheckpointManager  # noqa: E402
from .elastic import (GIVE_UP, RETRY, SHRINK, ElasticDecision,  # noqa: E402
                      ElasticPolicy, plan_for_shrink)
from .faults import WORKER_LOST_EXIT_CODE  # noqa: E402
from .guard import (DEGRADE_LADDER, STALL_EXIT_CODE,  # noqa: E402
                    RunGuard, classify_returncode)

__all__ = ["Checkpoint", "CheckpointManager", "NonFiniteError", "faults",
           "RunGuard", "STALL_EXIT_CODE", "DEGRADE_LADDER",
           "classify_returncode", "WORKER_LOST_EXIT_CODE",
           "ElasticPolicy", "ElasticDecision", "RETRY", "SHRINK", "GIVE_UP",
           "plan_for_shrink"]
