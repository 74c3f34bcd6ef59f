"""DevicePredictor: batch inference over a packed ensemble on the card
(PyTorch port of `lightgbm_tpu/inference/predictor.py`).

The model slice is packed once (pack.py) and put on the device once;
every predict call copies the rows in, runs the tensor traversal
(traverse.py) and copies the answer out.

Batches are padded up to a small geometric ladder of bucket sizes
(min_bucket * 2^k), as in the JAX package, where each bucket is one
compiled program.  Eager torch compiles nothing; the ladder keeps the
shapes a serving loop sends to a few sizes, so the caching allocator
reuses the same blocks from call to call.  Only the request's rows
cross to the device; the padding rows are zeroed there.

`DevicePredictor.dispatches` counts dispatches by device type
("cuda", "cpu"), so a caller can show that a predict ran on the card;
the serving dispatcher thread and callers' threads advance it under a
lock.

Where the JAX package counts traced signatures per bucket entry, the
port counts the distinct (mode, bucket, width) programs first
dispatched (`num_traces`, `total_traces`): the serving registry's
`serve_recompiles` then means buckets first run by live traffic after
warmup.  With the cost model on (param `roofline`), every dispatch but
warmup's adds its analytic flops and bytes (costmodel.traverse_cost)
and its wall seconds to the registry's `device_predict_*` counters, and
`last_dispatch_info()` carries the newest one for the serving trace.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..observability.costmodel import global_cost_model, traverse_cost
from ..observability.registry import global_registry
from ..utils import log
from ..utils.device import resolve_device
from ..utils.timer import global_timer
from .pack import PackedEnsemble, pack_ensemble
from .traverse import (class_scores, class_scores_early_stop,
                       ensemble_leaf_ids)


def build_program(depth: int, num_class: int, average: bool, convert,
                  mode: str, es_freq: int = 0, has_cat: bool = True):
    """The dispatch DevicePredictor runs: (x [B, F] f32, [margin if
    es_freq > 0,] *device pack arrays) -> scores [B, K] or leaf ids
    [B, T].  `convert` maps raw scores to predictions in the objectives'
    [K, n] layout."""
    K = num_class

    def finish(scores):
        if mode == "convert" and convert is not None:
            scores = convert(scores.T).T
        return scores

    if es_freq > 0:
        def run_es(x, margin, sf, th, mt, dl, ic, lc, rc, lv, cs, cn, cw):
            leaf = ensemble_leaf_ids(x, sf, th, mt, dl, ic, lc, rc,
                                     cs, cn, cw, depth, has_cat)
            return finish(class_scores_early_stop(leaf, lv, K, es_freq,
                                                  margin))
        return run_es

    def run(x, sf, th, mt, dl, ic, lc, rc, lv, cs, cn, cw):
        leaf = ensemble_leaf_ids(x, sf, th, mt, dl, ic, lc, rc,
                                 cs, cn, cw, depth, has_cat)
        if mode == "leaf":
            return leaf
        return finish(class_scores(leaf, lv, K, average))

    return run


class DevicePredictor:
    """Ensemble predictor for one model slice on one torch device.

    Parameters
    ----------
    trees : the model slice (host Tree objects, shrinkage applied)
    num_class : K; tree t scores class t % K
    average : RF output averaging (divide class sums by trees-per-class)
    convert : optional score -> prediction map on tensors ([K, n]
        layout), applied on the device (objective.convert_output)
    min_bucket : smallest padded batch; buckets double from here
    device : the torch device (or `device_type` string) that holds the
        pack and runs the traversal; the card unless the caller asks for
        the CPU
    """

    dispatches: Counter = Counter()
    _dispatches_lock = threading.Lock()

    def __init__(self, trees: List, num_class: int = 1,
                 average: bool = False, convert=None,
                 min_bucket: int = 4096, device="cuda"):
        self.pack: Optional[PackedEnsemble] = pack_ensemble(trees)
        self.ok = self.pack is not None and self.pack.num_trees > 0
        self.num_class = max(int(num_class), 1)
        self.average = bool(average)
        self.device = (device if isinstance(device, torch.device)
                       else resolve_device(device))
        self._convert = convert
        self._min_bucket = max(int(min_bucket), 8)
        self._has_cat = bool(self.ok and self.pack.is_cat.any())
        self._dev = None      # device copies of the pack arrays
        # (mode, bucket, F) programs dispatched so far: the port's
        # counterpart of the JAX package's traced bucket entries
        self._programs = set()
        # the newest accounted dispatch's cost (flops / bytes / wall
        # seconds / bucket), stamped on the serving dispatch span; the
        # serving dispatcher writes it, any thread reads it
        self._dispatch_lock = threading.Lock()
        self._last_dispatch = None
        self._pack_bytes = (sum(int(a.nbytes) for a in self.pack[:11])
                            if self.pack is not None else 0)

    # ------------------------------------------------------------- device
    def _device_arrays(self):
        """Put the pack on the device once: 11 small transfers at first
        use, none after.  Gather indices and bitset words go as int64."""
        if self._dev is None:
            p = self.pack
            i64 = np.int64
            arrs = (p.split_feature.astype(i64), p.threshold,
                    p.missing_type, p.default_left, p.is_cat, p.left,
                    p.right, p.leaf_value, p.cat_start.astype(i64),
                    p.cat_nwords, p.cat_words.astype(i64))
            self._dev = tuple(torch.from_numpy(np.ascontiguousarray(a))
                              .to(self.device) for a in arrs)
        return self._dev

    def bucket_rows(self, n: int) -> int:
        """Smallest ladder size >= n."""
        b = self._min_bucket
        while b < n:
            b *= 2
        return b

    @classmethod
    def dispatch_counts(cls) -> dict:
        """A copy of `dispatches`, read under its lock."""
        with cls._dispatches_lock:
            return dict(cls.dispatches)

    def num_traces(self, mode: str = "raw") -> int:
        """Distinct (bucket, width) programs dispatched in `mode`."""
        with self._dispatch_lock:
            return sum(1 for m, _, _ in self._programs if m == mode)

    def total_traces(self) -> int:
        """Distinct (mode, bucket, width) programs dispatched: the
        serving registry's `serve_recompiles` reads it before and after
        the warmup ladder."""
        with self._dispatch_lock:
            return len(self._programs)

    def release_device(self) -> None:
        """Drop the device copies of the pack and the program ledger, so
        an evicted serving model frees its buffers; the next predict
        puts the pack back."""
        self._dev = None
        with self._dispatch_lock:
            self._programs = set()

    # ------------------------------------------------------------ predict
    def _run(self, X: np.ndarray, mode: str,
             early_stop: Optional[Tuple[int, float]] = None,
             account: bool = True):
        """One padded-bucket dispatch; returns (host result [n, ...],
        bucket).  With the cost model on and `account` (false for
        warmup), the dispatch's analytic flops/bytes and wall seconds
        accumulate into the registry (`device_predict_flops` / `_bytes`
        / `_s` / `_dispatches`), flop and second measured at the same
        site."""
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        n, F = X.shape
        if self.pack.max_feature >= F:
            log.fatal(f"The model references feature index "
                      f"{self.pack.max_feature} but the data has only "
                      f"{F} columns")
        es_freq = 0
        extra = ()
        if early_stop is not None and mode != "leaf" and not self.average:
            # early stopping with output averaging is a no-op on the host
            # too (gbdt.py use_es); the margin is compared in float32
            es_freq = max(int(early_stop[0]), 0)
            if es_freq > 0:
                extra = (float(np.float32(early_stop[1])),)
        bucket = self.bucket_rows(n)
        fn = build_program(self.pack.max_depth, self.num_class,
                           self.average, self._convert, mode, es_freq,
                           self._has_cat)
        mode_key = f"{mode}+es{es_freq}" if es_freq > 0 else mode
        with self._dispatch_lock:
            self._programs.add((mode_key, bucket, F))
        t0 = (time.perf_counter()
              if account and global_cost_model.enabled else None)
        with global_timer.scope("DevicePredictor::dispatch"):
            xd = torch.empty((bucket, F), dtype=torch.float32,
                             device=self.device)
            xd[:n].copy_(torch.from_numpy(X))
            xd[n:] = 0.0
            out = fn(xd, *extra, *self._device_arrays())
            with DevicePredictor._dispatches_lock:
                DevicePredictor.dispatches[self.device.type] += 1
            host = global_timer.block(out)[:n].cpu().numpy()
        if t0 is not None:
            # the copy to the host settled the device, so the wall time
            # covers pad + H2D + traversal + D2H of exactly this dispatch
            dt = time.perf_counter() - t0
            p = self.pack
            flops, nbytes = traverse_cost(
                bucket, F, p.num_trees, p.max_depth,
                p.num_trees if mode == "leaf" else self.num_class,
                self._pack_bytes, sums=mode != "leaf")
            global_cost_model.account(
                f"device_predict[{mode_key}@{bucket}]", flops, nbytes)
            global_registry.inc("device_predict_flops", flops)
            global_registry.inc("device_predict_bytes", nbytes)
            global_registry.inc("device_predict_s", dt)
            global_registry.inc("device_predict_dispatches")
            with self._dispatch_lock:
                self._last_dispatch = {
                    "flops": flops, "bytes": nbytes,
                    "dispatch_s": round(dt, 6), "bucket": int(bucket)}
        return host, bucket

    def last_dispatch_info(self):
        """The newest accounted dispatch's cost (`{flops, bytes,
        dispatch_s, bucket}`), or None before any accounted dispatch or
        with the cost model off: the serving trace's dispatch-span
        attributes."""
        with self._dispatch_lock:
            info = self._last_dispatch
            return dict(info) if info is not None else None

    def warmup(self, num_features: int, max_rows: int,
               modes=("convert", "raw"),
               early_stop: Optional[Tuple[int, float]] = None) -> int:
        """Run every bucket of the ladder up through the one covering
        `max_rows` once per mode, so the caching allocator holds their
        blocks before the first real request (the serving registry runs
        this before a model entry goes live).  Warmup dispatches stay out
        of the cost ledger.  Returns the number of distinct programs
        dispatched so far."""
        if not self.ok:
            return 0
        b = self._min_bucket
        while True:
            x = np.zeros((b, num_features), np.float32)
            for mode in modes:
                self._run(x, mode, early_stop=early_stop, account=False)
            if b >= max_rows:
                break
            b *= 2
        return self.total_traces()

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """[n, T] int32 leaf indices, bit-identical to the native
        predictor's routing for float32 inputs."""
        return self._run(X, "leaf")[0]

    def predict_raw(self, X: np.ndarray,
                    early_stop: Optional[Tuple[int, float]] = None
                    ) -> np.ndarray:
        """Raw scores [n] (K == 1) or [n, K]: float32 sums of the leaf
        values in tree order (routing exact).  `early_stop=(freq,
        margin)` runs the masked accumulation (traverse.py)."""
        out, _ = self._run(X, "raw", early_stop=early_stop)
        return out[:, 0] if self.num_class == 1 else out

    def predict(self, X: np.ndarray,
                early_stop: Optional[Tuple[int, float]] = None
                ) -> np.ndarray:
        """Converted predictions with the objective's convert_output on
        the device (raw scores when no converter was given)."""
        mode = "convert" if self._convert is not None else "raw"
        out, _ = self._run(X, mode, early_stop=early_stop)
        return out[:, 0] if self.num_class == 1 else out
