"""Analytic cost accounting: measured per-phase MFU and roofline
classification (PyTorch port of `lightgbm_tpu/observability/costmodel.py`).

The JAX package asks the compiler: XLA's lowered module carries its own
cost analysis (flops and bytes accessed) for every jitted entry.  Eager
torch has no lowered module, so each call site of the port reports an
analytic `(flops, bytes)` per call instead, computed on the host from
the shapes it launches (`account`):

* `grow_tree`: every histogram pass of the engines (K1-K4), counted by
  the same byte formula as the bound column of `chip_smoke.py`
  (`wave_hist_bytes`, `rows_hist_bytes`): each input read once, each
  output written once; its flops one add per row read, feature and
  channel (plus the count), the most a pass can do;
* `gradients`: the objective's pass over the scores, labels and weights
  (`gradients_cost`);
* `device_eval`: the packed metric tick (`eval_cost`);
* `device_predict`: one DevicePredictor dispatch at its bucket
  (`traverse_cost`): the rows and the pack read once, the output written
  once, one compare per tree and level and one add per tree.

These are the least bytes the work must move, so `bw_util` (bytes over
seconds over the peak rate) is at most 1 on a right count: a value above
it is a wrong count, not a fast card.

Combined with the per-phase `::device` times (a device scope's CUDA
events, as `Tree::histogram::device` for `grow_tree`, or the settle wait
that `Timer.block` credits to `<scope>::device`) and a per-backend peak
table, the per-iteration event and the serving stats gain measured MFU,
arithmetic intensity (flops/byte), and a roofline classification: an
entry whose intensity sits below the ridge point (peak_flops /
peak_bytes_per_s) is memory-bound, one above it compute-bound.

Zero steady-state cost when disabled (one attribute check per call
site); when enabled, a dict add behind a lock per call.  `engine.train`
enables it for metrics runs and the serving daemon for its lifetime
(param `roofline`).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

from ..utils import log

# Per-backend (peak_flops_per_s, peak_hbm_bytes_per_s).  The gpu row is
# the H100 SXM's published peaks at 700 W: 67 TFLOP/s in float32 outside
# the tensor cores (the histogram and traversal work is CUDA-core work)
# and 3.35 TB/s of HBM3.  The cpu row is a nominal figure so the roofline
# CLASSIFICATION still works off the card.  Override with
# LGBM_TPU_PEAK_FLOPS / LGBM_TPU_PEAK_BYTES_PER_S for other parts.
PEAK_TABLE: Dict[str, Tuple[float, float]] = {
    "gpu": (67e12, 3.35e12),
    "cpu": (1e11, 2e10),
}
# torch device types -> PEAK_TABLE rows
_BACKEND_OF = {"cuda": "gpu", "gpu": "gpu", "cpu": "cpu"}


def backend_peaks(backend: Optional[str] = None) -> Tuple[float, float]:
    """(peak_flops_per_s, peak_bytes_per_s) for `backend` (a PEAK_TABLE
    row or a torch device type; default: "gpu" when torch sees a CUDA
    device, else "cpu")."""
    if backend is None:
        try:
            import torch
            backend = "gpu" if torch.cuda.is_available() else "cpu"
        except Exception:  # noqa: BLE001 - peaks must never raise
            backend = "cpu"
    row = _BACKEND_OF.get(str(backend), str(backend))
    flops, bw = PEAK_TABLE.get(row, PEAK_TABLE["cpu"])
    env_f = os.environ.get("LGBM_TPU_PEAK_FLOPS")
    env_b = os.environ.get("LGBM_TPU_PEAK_BYTES_PER_S")
    try:
        if env_f:
            flops = float(env_f)
        if env_b:
            bw = float(env_b)
    except ValueError:
        log.warning("Ignoring malformed LGBM_TPU_PEAK_FLOPS / "
                    "LGBM_TPU_PEAK_BYTES_PER_S override")
    return flops, bw


# ------------------------------------------------------ analytic counts
def wave_hist_bytes(binned_bytes: int, n: int, num_slots: int,
                    num_features: int, max_bin: int, C: int) -> int:
    """K1-K3 (one wave pass): the codes, the [n] slots and the [n, C+1]
    float32 accumulands read once, the [slots, F, B, C] float32
    histograms and the [slots] counts written once."""
    return (int(binned_bytes) + 4 * n + 4 * (C + 1) * n
            + num_slots * num_features * max_bin * C * 4 + num_slots * 4)


def wave_hist_ops(rows_in_slots: int, num_features: int, C: int) -> int:
    """One add per computed row, feature and channel, plus the count."""
    return int(rows_in_slots) * (num_features * C + 1)


def rows_hist_bytes(S: int, num_features: int, max_bin: int, C: int,
                    code_bytes: int = 1) -> int:
    """K4: the [S, F] codes, [S, C] float32 values and [S] mask read
    once, the [F, B, C] float32 histograms written once."""
    return (S * num_features * code_bytes + 4 * C * S + 4 * S
            + num_features * max_bin * C * 4)


def rows_hist_ops(rows_in_mask: int, num_features: int, C: int) -> int:
    """One add per masked row, feature and channel."""
    return int(rows_in_mask) * num_features * C


def bound_ms(nbytes: float, ops: float,
             backend: str = "gpu") -> Tuple[float, str]:
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the float32
    peak.  A fixed yardstick: it reads the PEAK_TABLE row itself, with
    no environment override (those move only the runtime roofline)."""
    peak_flops, peak_bw = PEAK_TABLE[_BACKEND_OF.get(backend, backend)]
    t_bytes = nbytes / peak_bw * 1e3
    t_ops = ops / peak_flops * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# flops per row of the pointwise objectives' gradient pass and of one
# device metric: a handful of float ops each (a sigmoid or a difference,
# a product by the weight); analytic constants, not measured
GRAD_FLOPS_PER_ROW = 8
EVAL_FLOPS_PER_ROW = 8


def gradients_cost(num_class: int, n: int, weighted: bool
                   ) -> Tuple[float, float]:
    """(flops, bytes) of one gradient pass: the [K, n] float32 scores,
    the labels (and weights) read once, grad and hess written once."""
    per_row = 4 * num_class + 4 + (4 if weighted else 0) + 8 * num_class
    return (float(GRAD_FLOPS_PER_ROW * num_class * n), float(per_row * n))


def eval_cost(num_metrics: int, num_class: int, n: int, weighted: bool
              ) -> Tuple[float, float]:
    """(flops, bytes) of one packed metric tick: scores, labels (and
    weights) read once, one float per metric back."""
    nbytes = (4 * num_class + 4 + (4 if weighted else 0)) * n
    return (float(EVAL_FLOPS_PER_ROW * max(num_metrics, 1) * num_class * n),
            float(nbytes + 4 * (num_metrics + 2)))


def traverse_cost(bucket: int, num_features: int, num_trees: int,
                  depth: int, out_cols: int, pack_bytes: int,
                  sums: bool = True) -> Tuple[float, float]:
    """(flops, bytes) of one DevicePredictor dispatch: the [bucket, F]
    float32 rows and the pack read once, [bucket, out_cols] 4-byte
    results written once; one compare per row, tree and level, and one
    add per row and tree when the leaf values are summed."""
    flops = bucket * num_trees * (max(depth, 1) + (1 if sums else 0))
    nbytes = 4 * bucket * num_features + pack_bytes + 4 * bucket * out_cols
    return float(flops), float(nbytes)


def group_of(name: str) -> str:
    """Accounting group of an entry name: the bucket-ladder entries
    (`device_predict[convert@4096]`) fold into one `device_predict`
    group; everything else groups by its own name."""
    return name.split("[", 1)[0]


# entry group -> the timer scope whose ::device split times that group's
# work (the JAX package's GROUP_PHASES, but for grow_tree).  The port's
# grow_tree group counts the histogram passes alone, and they run under
# the nested `Tree::histogram` device scope, whose ::device split is the
# CUDA-event time of the passes; `GBDT::grow_tree::device` is only the
# settle wait at the tree's end, so it would credit every pass to a few
# microseconds (a bw_util far above 1)
GROUP_PHASES: Dict[str, str] = {
    "grow_tree": "Tree::histogram",
    "gradients": "GBDT::gradients",
    "device_eval": "GBDT::eval",
    "device_predict": "DevicePredictor::dispatch",
}


def roofline(flops: float, bytes_accessed: float, seconds: float,
             backend: Optional[str] = None) -> Dict[str, Any]:
    """Measured utilization + roofline classification for `flops` /
    `bytes_accessed` of work that took `seconds` of device time."""
    peak_flops, peak_bw = backend_peaks(backend)
    out: Dict[str, Any] = {
        "flops": flops, "bytes": bytes_accessed,
        "peak_flops_per_s": peak_flops, "peak_bytes_per_s": peak_bw,
    }
    ridge = peak_flops / max(peak_bw, 1.0)
    ai = flops / bytes_accessed if bytes_accessed > 0 else None
    out["arithmetic_intensity"] = ai
    out["ridge_intensity"] = ridge
    # which roof binds this work: below the ridge the memory system caps
    # achievable flops/s no matter how good the kernel is
    out["bound"] = ("unknown" if ai is None
                    else "compute" if ai >= ridge else "hbm")
    if seconds and seconds > 0:
        out["mfu"] = flops / seconds / peak_flops
        out["achieved_flops_per_s"] = flops / seconds
        out["achieved_bytes_per_s"] = bytes_accessed / seconds
        out["bw_util"] = bytes_accessed / seconds / peak_bw
    else:
        out["mfu"] = None
    return out


class CostModel:
    """Cumulative analytic-cost ledger over the accounted call sites.

    `account()` is called by each call site on every call (only when
    `enabled`) with that call's (flops, bytes); it accumulates into the
    entry's group.  `snapshot()` is the timer-snapshot analogue:
    per-iteration deltas come from diffing two snapshots (callback
    record_metrics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        # name -> newest accounted (flops, bytes) per call
        self._latest: Dict[str, Tuple[float, float]] = {}
        # group -> [flops, bytes, calls, unharvested_calls]
        self._totals: Dict[str, list] = {}

    def account(self, name: str, flops: float, bytes_accessed: float
                ) -> None:
        """One call of the entry `name` that did `flops` of work over
        `bytes_accessed` bytes."""
        group = group_of(name)
        with self._lock:
            self._latest[name] = (float(flops), float(bytes_accessed))
            tot = self._totals.setdefault(group, [0.0, 0.0, 0, 0])
            tot[0] += float(flops)
            tot[1] += float(bytes_accessed)
            tot[2] += 1

    # ------------------------------------------------------------- readout
    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Point-in-time cumulative totals {group: {flops, bytes, calls,
        unharvested}} (the JAX keys; `unharvested` stays 0: every call
        site counts analytically)."""
        with self._lock:
            return {g: {"flops": t[0], "bytes": t[1], "calls": t[2],
                        "unharvested": t[3]}
                    for g, t in self._totals.items()}

    def per_call(self, name: str) -> Optional[Tuple[float, float]]:
        """The newest accounted (flops, bytes) per call of `name`, or
        None."""
        with self._lock:
            return self._latest.get(name)

    def reset(self) -> None:
        with self._lock:
            self._latest.clear()
            self._totals.clear()

    # ---------------------------------------------------------- aggregates
    def phase_roofline(self, prev: Dict[str, Dict[str, float]],
                       cur: Dict[str, Dict[str, float]],
                       phases: Dict[str, float],
                       backend: Optional[str] = None
                       ) -> Dict[str, Dict[str, Any]]:
        """Per-group roofline over one window: `prev`/`cur` are
        snapshot() results bracketing it, `phases` the timer's seconds
        deltas for the same window.  Device time prefers the
        `<scope>::device` split (the settle wait) and falls back to the
        host scope total."""
        out: Dict[str, Dict[str, Any]] = {}
        for group, tot in cur.items():
            was = prev.get(group, {"flops": 0.0, "bytes": 0.0, "calls": 0})
            calls = int(tot["calls"] - was["calls"])
            if calls <= 0:
                continue
            flops = tot["flops"] - was["flops"]
            bytes_accessed = tot["bytes"] - was["bytes"]
            scope = GROUP_PHASES.get(group)
            dev_s = None
            if scope is not None:
                dev_s = phases.get(scope + "::device",
                                   phases.get(scope))
            entry = roofline(flops, bytes_accessed, dev_s or 0.0,
                             backend=backend)
            entry["calls"] = calls
            entry["device_s"] = dev_s
            # the per-backend constants stay out of the per-iteration
            # event (PEAK_TABLE carries them)
            for k in ("peak_flops_per_s", "peak_bytes_per_s",
                      "achieved_flops_per_s", "achieved_bytes_per_s"):
                entry.pop(k, None)
            out[group] = entry
        return out


# the process-wide ledger every call site reports into
global_cost_model = CostModel()


def enable_cost_model(on: bool = True) -> bool:
    """Flip the process-wide cost model; returns the PREVIOUS state so
    scoped enablers (engine.train) can restore it."""
    prev = global_cost_model.enabled
    global_cost_model.enabled = bool(on)
    return prev
