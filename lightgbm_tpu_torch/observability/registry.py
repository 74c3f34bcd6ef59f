"""Process-wide metrics registry: counters and gauges, rank-tagged
(PyTorch port of `lightgbm_tpu/observability/registry.py`).

The training loop, the reliability planes and the memory sampler all
increment into one registry; the per-iteration JSONL event
(observability/events.py) snapshots it so a run's structured log carries
the cumulative counter state next to each iteration's phase timings.
Counter updates are a dict add behind a lock, cheap enough to stay on
unconditionally.  `LatencyWindow` is the serving daemon's and the
router's rolling tail-latency view.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional, Tuple, Union

Number = Union[int, float]


def process_rank() -> int:
    """This process's rank: `torch.distributed.get_rank()` when a process
    group is initialized, else 0."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - a rank probe must never raise
        pass
    return 0


class MetricsRegistry:
    """Counters (monotonic) and gauges (last-write-wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Number] = {}
        self._gauges: Dict[str, Number] = {}

    def inc(self, name: str, value: Number = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: Number) -> None:
        with self._lock:
            self._gauges[name] = value

    def counter(self, name: str) -> Number:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str, default: Number = None) -> Number:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> Dict[str, Dict[str, Number]]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    def snapshot_nolock(self) -> Dict[str, Dict[str, Number]]:
        """Signal-path snapshot: the SIGUSR2 flight dump and the stall
        watchdog's exit read through here, where taking `_lock` could
        deadlock on the very thread the handler interrupted.  A dict
        copy racing a writer can raise RuntimeError; retry, then settle
        for empty: a partial snapshot beats a wedged handler."""
        for _ in range(4):
            try:
                return {"counters": dict(self._counters),
                        "gauges": dict(self._gauges)}
            except RuntimeError:
                continue
        return {"counters": {}, "gauges": {}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


# the process-wide registry every subsystem increments into
global_registry = MetricsRegistry()


class LatencyWindow:
    """Bounded ring of recent latency samples with percentile readout.

    The serving daemon records one sample per request (submit ->
    response, ms) and `stats()` reads p50/p99 over the most recent
    `capacity` samples: a rolling tail-latency view that costs O(1) per
    request and never grows (a long-lived daemon must not hoard
    per-request history; a bench computes its EXACT percentiles from
    its own client-side lists instead)."""

    def __init__(self, capacity: int = 8192):
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=max(int(capacity), 16))
        self._count = 0

    def record(self, value_ms: float) -> None:
        with self._lock:
            self._buf.append(float(value_ms))
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentiles(self, qs: Tuple[float, ...] = (50.0, 99.0)
                    ) -> Tuple[Optional[float], ...]:
        """Percentiles (ms) over the retained window; Nones when empty."""
        with self._lock:
            data = list(self._buf)
        if not data:
            return tuple(None for _ in qs)
        import numpy as np
        arr = np.asarray(data, np.float64)
        return tuple(float(np.percentile(arr, q)) for q in qs)

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._count = 0
