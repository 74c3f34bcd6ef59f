"""Fault tolerance for training runs (PyTorch port of the part of
`lightgbm_tpu/reliability/` that the training loop uses): the error the
non-finite sentinel raises.  Checkpoints, rollback, supervision and the
stall watchdog come with ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

from ..utils.log import LightGBMError


class NonFiniteError(LightGBMError):
    """Raised when NaN/Inf gradients or eval scores are detected: boosting
    on non-finite values silently produces garbage trees, so training
    fails fast."""


__all__ = ["NonFiniteError"]
