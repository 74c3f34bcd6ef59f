"""Named timing scopes aggregated in a global timer (PyTorch port).

Same API as the JAX package's `utils/timer.py` (the reference's TIMETAG
instrumentation, ref: include/LightGBM/utils/common.h:973-1010, enabled
by the LIGHTGBM_TPU_TIMETAG env var):

* `scope(name)` — host-side phases; wall clock accumulates per call.
  Callers of device work `block()` the phase's outputs inside the scope
  so the phase is charged for what it launched.
* `device_scope(name)` — device phases (histogram build, split find,
  partition).  Wraps the launched work in
  `torch.profiler.record_function` so profiler timelines carry the name,
  and, when timing is on and the work runs on a CUDA device, brackets it
  with `torch.cuda.Event`s whose elapsed time accumulates as
  `<name>::device` (read at `items()`/`snapshot()`, which synchronize).

`block(x)` synchronizes the current CUDA stream when timing is on and
credits the wait to `<scope>::device`; it is the identity when timing
is off, so the production loop stays asynchronous.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch


class Timer:
    """Aggregates wall-clock per named scope (ref: common.h:973 Timer)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._acc: Dict[str, float] = defaultdict(float)
        self._cnt: Dict[str, int] = defaultdict(int)
        self._events: List[Tuple[str, object, object]] = []
        self._alock = threading.Lock()
        self._tls = threading.local()

    def _scope_stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextmanager
    def scope(self, name: str):
        """RAII scope (ref: common.h:1000 FunctionTimer)."""
        if not self.enabled:
            yield
            return
        stack = self._scope_stack()
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            stack.pop()
            dt = time.perf_counter() - t0
            with self._alock:
                self._acc[name] += dt
                self._cnt[name] += 1

    @contextmanager
    def device_scope(self, name: str, device=None):
        """Profiler-named region for device work; with timing on and a
        CUDA `device`, CUDA events time the launched work."""
        with torch.profiler.record_function(name):
            timed = (self.enabled and device is not None
                     and torch.device(device).type == "cuda")
            if not timed:
                with self.scope(name):
                    yield
                return
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with self.scope(name):
                yield
            end.record()
            with self._alock:
                self._events.append((name + "::device", start, end))

    def _collect_events(self) -> None:
        with self._alock:
            events, self._events = self._events, []
        for name, start, end in events:
            end.synchronize()
            with self._alock:
                self._acc[name] += start.elapsed_time(end) / 1000.0
                self._cnt[name] += 1

    def block(self, x):
        """Synchronize the current CUDA stream (of the device that `x`,
        or its first tensor, lies on; else of the current device) when
        timing is on and credit the wait to `<enclosing scope>::device`;
        identity when timing is off."""
        if not self.enabled or x is None or not torch.cuda.is_available():
            return x
        first = x[0] if isinstance(x, (tuple, list)) and x else x
        dev = (first.device if isinstance(first, torch.Tensor)
               and first.device.type == "cuda" else None)
        t0 = time.perf_counter()
        torch.cuda.current_stream(dev).synchronize()
        stack = self._scope_stack()
        if stack:
            dt = time.perf_counter() - t0
            with self._alock:
                self._acc[stack[-1] + "::device"] += dt
                self._cnt[stack[-1] + "::device"] += 1
        return x

    def items(self) -> Tuple[Tuple[str, float, int], ...]:
        self._collect_events()
        with self._alock:
            acc = dict(self._acc)
            cnt = dict(self._cnt)
        return tuple((k, acc[k], cnt[k])
                     for k in sorted(acc, key=acc.get, reverse=True))

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """Point-in-time copy {name: (seconds, calls)}."""
        self._collect_events()
        with self._alock:
            return {k: (self._acc[k], self._cnt[k]) for k in self._acc}

    def reset(self) -> None:
        with self._alock:
            self._acc.clear()
            self._cnt.clear()
            self._events.clear()

    def print(self) -> None:
        """ref: Timer::Print at process exit."""
        items = self.items()
        if not items:
            return
        from . import log
        log.info("LightGBM-TPU (torch) timers:")
        for name, sec, cnt in items:
            log.info(f"  {name}: {sec * 1000:.3f} ms ({cnt} calls)")


global_timer = Timer(
    enabled=bool(os.environ.get("LIGHTGBM_TPU_TIMETAG", "")))
if global_timer.enabled:
    atexit.register(global_timer.print)
