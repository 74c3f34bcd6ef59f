"""Model registry: background load + bucket-ladder warmup + atomic hot swap
(PyTorch port of `lightgbm_tpu/serving/registry.py`).

The reference serves through one long-lived `Predictor` per model
(ref: src/application/predictor.hpp — parse once, reuse buffers per
call); the daemon generalizes that to MANY models behind one device.
Each registered model becomes an immutable `ModelEntry`: the Booster is
loaded and packed (inference/pack.py), the pack is put on the daemon's
device and the whole bucket ladder is run once in every servable mode
(DevicePredictor.warmup) on a BACKGROUND thread, then the name -> entry
binding swaps atomically under the registry lock.  The serving path
therefore never pays a load, a pack, or a bucket's first run:

* hot swap — re-registering a name builds the new version completely
  off the serving path; requests keep landing on the old entry until
  the one-pointer swap, and requests already holding the old entry
  (acquired at submit) finish on it — no request ever sees a half
  -loaded model or a torn mix of two versions;
* eviction — an entry is freed (device buffers and program ledger
  dropped, `serve_evict` event) only when it is BOTH retired (swapped
  out or unregistered) and idle (per-entry refcount at zero);
* failed loads — a load/warmup error parks on the LoadHandle and emits
  `serve_load_failed`; the previous version keeps serving.

`serve_recompiles` distinguishes the programs warmup ran (expected,
counted per entry at ready time) from programs first run by live
traffic (a bucket warmup missed, gated on zero): it sums `traces -
warmup_traces` over live and retired entries.  Eager torch compiles
nothing, so a "trace" here is a distinct (mode, bucket, width) program
first dispatched (DevicePredictor.total_traces), where the JAX package
counts jit traces.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

from ..observability import emit_event
from ..observability.registry import global_registry
from ..utils import log
from ..utils.device import resolve_device


class ModelEntry:
    """One immutable packed model version with device-buffer refcounting.

    Requests `acquire()` the entry at submit time and `release()` it
    after their response is set; `retire()` marks it evicted.  The
    device buffers are freed exactly once, when retired AND idle."""

    def __init__(self, name: str, version: int, predictor, num_features: int,
                 num_class: int, source: str = ""):
        self.name = name
        self.version = version
        self.predictor = predictor
        self.num_features = int(num_features)
        self.num_class = int(num_class)
        self.source = source
        self.warmup_traces = 0
        self._lock = threading.Lock()
        self._refs = 0
        self._retired = False
        self.released = False

    def acquire(self) -> "ModelEntry":
        with self._lock:
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            free = self._retired and self._refs <= 0 and not self.released
            if free:
                self.released = True
        if free:
            self._free()

    def retire(self) -> None:
        with self._lock:
            self._retired = True
            free = self._refs <= 0 and not self.released
            if free:
                self.released = True
        if free:
            self._free()

    def _free(self) -> None:
        self.predictor.release_device()
        emit_event("serve_evict", model=self.name, version=self.version)

    def traces(self) -> int:
        return self.predictor.total_traces()

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._refs


class LoadHandle:
    """Future for one background register(): `wait()` blocks until the
    load+warmup finished; `entry` / `error` carry the outcome."""

    def __init__(self, name: str):
        self.name = name
        self._done = threading.Event()
        self.entry: Optional[ModelEntry] = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> "LoadHandle":
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"Model {self.name!r} load did not finish in {timeout}s")
        if self.error is not None:
            raise RuntimeError(
                f"Model {self.name!r} failed to load: {self.error}"
            ) from self.error
        return self

    def done(self) -> bool:
        return self._done.is_set()

    def _finish(self, entry=None, error=None) -> None:
        self.entry = entry
        self.error = error
        self._done.set()


class ModelRegistry:
    """name -> ModelEntry map with background loading and hot swap."""

    def __init__(self, min_bucket: int = 4096, warmup_rows: int = 65536,
                 warmup: bool = True,
                 early_stop: Optional[Tuple[int, float]] = None,
                 device_type: str = "cuda"):
        self._lock = threading.RLock()
        self._models: Dict[str, ModelEntry] = {}
        self._versions: Dict[str, int] = {}
        self._pending: Dict[str, LoadHandle] = {}
        self._retired_extra_traces = 0
        self._min_bucket = int(min_bucket)
        self._warmup_rows = int(warmup_rows)
        self._warmup = bool(warmup)
        self._early_stop = early_stop
        # resolved once: the card unless the caller asks for the CPU,
        # and no fallback (resolve_device raises without a card)
        self.device = resolve_device(device_type)

    # ------------------------------------------------------------ register
    def register(self, name: str, model_file: Optional[str] = None,
                 model_str: Optional[str] = None, booster=None,
                 block: bool = False,
                 timeout: Optional[float] = None) -> LoadHandle:
        """Load/repack a model and swap it in under `name`.  Exactly one
        of model_file / model_str / booster; the load, pack and warmup
        run on a background thread and the swap is atomic — `block=True`
        waits for readiness (and raises on a failed load)."""
        if sum(x is not None for x in (model_file, model_str, booster)) != 1:
            raise ValueError("register() needs exactly one of model_file, "
                             "model_str or booster")
        handle = LoadHandle(name)
        with self._lock:
            # concurrent registers of one name swap in COMPLETION order:
            # whichever load lands last serves (each swap is still
            # atomic and torn-free); serialize registers per name if
            # strict submission order matters
            self._pending[name] = handle
        t = threading.Thread(
            target=self._load_and_swap,
            args=(handle, name, model_file, model_str, booster),
            name=f"lgbm-serve-load-{name}", daemon=True)
        t.start()
        if block:
            handle.wait(timeout)
        return handle

    def _load_and_swap(self, handle: LoadHandle, name: str,
                       model_file, model_str, booster) -> None:
        try:
            entry = self._build_entry(name, model_file, model_str, booster)
        except BaseException as e:  # noqa: BLE001 - surfaced on the handle
            log.warning(f"Serving model {name!r} failed to load: {e}")
            emit_event("serve_load_failed", model=name, error=str(e))
            global_registry.inc("serve_load_failures")
            handle._finish(error=e)
            return
        with self._lock:
            old = self._models.get(name)
            self._models[name] = entry
            if self._pending.get(name) is handle:
                del self._pending[name]
            if old is not None:
                # fold the retiree's serving-path traces into the
                # recompile ledger before its counters are dropped
                self._retired_extra_traces += max(
                    old.traces() - old.warmup_traces, 0)
        emit_event("serve_swap", model=name, version=entry.version,
                   previous=(old.version if old is not None else None),
                   warmup_traces=entry.warmup_traces)
        global_registry.inc("serve_swaps")
        if old is not None:
            old.retire()  # frees when the last in-flight request releases
        handle._finish(entry=entry)

    def _build_entry(self, name: str, model_file, model_str,
                     booster) -> ModelEntry:
        from ..basic import Booster
        from ..inference import DevicePredictor
        source = model_file or ("<string>" if model_str else "<booster>")
        # the loaded booster predicts where the daemon serves
        params = {"device_type": self.device.type}
        if model_file is not None:
            if not os.path.exists(model_file):
                raise FileNotFoundError(model_file)
            booster = Booster(model_file=model_file, params=params)
        elif model_str is not None:
            booster = Booster(model_str=model_str, params=params)
        g = booster._gbdt
        K = max(g.num_tree_per_iteration, 1)
        obj = g.objective
        dp = DevicePredictor(
            list(g.models_), num_class=K, average=g.average_output_,
            convert=(obj.convert_output if obj is not None else None),
            min_bucket=self._min_bucket, device=self.device)
        if not dp.ok:
            raise ValueError(
                "model is not device-servable (linear-tree leaves or an "
                "empty ensemble); Booster.predict serves it on the host")
        num_features = int(booster.num_feature())
        if self._warmup:
            # every servable mode runs up front: a mode first hit by
            # live traffic would count as a serving-path recompile
            modes = (("convert", "raw", "leaf") if obj is not None
                     else ("raw", "leaf"))
            dp.warmup(num_features, self._warmup_rows, modes=modes,
                      early_stop=self._early_stop)
        with self._lock:
            version = self._versions.get(name, 0) + 1
            self._versions[name] = version
        entry = ModelEntry(name, version, dp, num_features, K, source)
        entry.warmup_traces = dp.total_traces()
        return entry

    # ------------------------------------------------------------- access
    def get(self, name: str) -> ModelEntry:
        """Acquire the current entry for `name` (caller must release)."""
        with self._lock:
            e = self._models.get(name)
            if e is None:
                raise KeyError(f"No model {name!r} is registered "
                               f"(serving: {sorted(self._models)})")
            return e.acquire()

    def wait_ready(self, name: str, timeout: Optional[float] = None) -> None:
        """Block until a pending load for `name` lands (no-op when the
        name is already live with no load in flight)."""
        with self._lock:
            handle = self._pending.get(name)
        if handle is not None:
            handle.wait(timeout)

    def unregister(self, name: str) -> bool:
        with self._lock:
            e = self._models.pop(name, None)
            if e is not None:
                self._retired_extra_traces += max(
                    e.traces() - e.warmup_traces, 0)
        if e is None:
            return False
        e.retire()
        return True

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def versions(self) -> Dict[str, int]:
        with self._lock:
            return {n: e.version for n, e in self._models.items()}

    def ready(self) -> bool:
        """Readiness for the fleet health probe: at least one model is
        live and every live entry finished its warmup ledger (warmup
        disabled counts as complete — the operator opted into cold
        first runs).  A pending load blocks readiness only for a name
        with NO live entry yet (cold start): a hot-swap publish keeps
        the old version serving while the new one warms, so the
        replica stays routable through the roll.  A replica is routed
        to only when this is True, so live traffic never pays a load
        or a bucket's first run."""
        with self._lock:
            if not self._models:
                return False
            if any(name not in self._models for name in self._pending):
                return False
            return all((not self._warmup) or e.warmup_traces > 0
                       for e in self._models.values())

    def serve_recompiles(self) -> int:
        """Programs first run OUTSIDE warmup: 0 in a healthy steady
        state (every request size pads into a warmed bucket)."""
        with self._lock:
            entries = list(self._models.values())
            extra = self._retired_extra_traces
        return extra + sum(max(e.traces() - e.warmup_traces, 0)
                           for e in entries)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            models = {n: {"version": e.version, "in_flight": e.in_flight,
                          "num_features": e.num_features,
                          "warmup_traces": e.warmup_traces,
                          "traces": e.traces()}
                      for n, e in self._models.items()}
        return {"models": models, "serve_recompiles": self.serve_recompiles()}

    def close(self) -> None:
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e.retire()
