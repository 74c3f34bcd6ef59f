"""Training callbacks (PyTorch port of `lightgbm_tpu/callback.py`; ref:
python-package/lightgbm/callback.py), with the JAX package's host-plane
callbacks: `checkpoint` (atomic, rotated, resumable checkpoints) and
`record_metrics` (the per-iteration JSONL event).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from .utils import log


class EarlyStopException(Exception):
    """ref: callback.py EarlyStopException."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


@dataclass
class CallbackEnv:
    """ref: callback.py CallbackEnv namedtuple."""
    model: Any
    params: Dict[str, Any]
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: List = field(default_factory=list)


def log_evaluation(period: int = 1, show_stdv: bool = True):
    """ref: callback.py log_evaluation."""
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(
                f"{name}'s {metric}: {value:g}"
                for name, metric, value, _ in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]):
    """ref: callback.py record_evaluation."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _callback(env: CallbackEnv) -> None:
        if env.iteration == env.begin_iteration:
            eval_result.clear()
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, {}).setdefault(metric, []).append(value)
    _callback.order = 20
    return _callback


def reset_parameter(**kwargs):
    """Per-iteration parameter schedules (ref: callback.py reset_parameter).
    Currently supports learning_rate (list or callable)."""
    def _callback(env: CallbackEnv) -> None:
        for key, value in kwargs.items():
            if callable(value):
                new_val = value(env.iteration - env.begin_iteration)
            else:
                new_val = value[env.iteration - env.begin_iteration]
            if key in ("learning_rate", "shrinkage_rate", "eta"):
                env.model._gbdt.shrinkage_rate = float(new_val)
            else:
                log.warning(f"reset_parameter: unsupported parameter {key}")
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def checkpoint(checkpoint_dir: str, frequency: int = 1, keep_last: int = 3,
               manager=None):
    """Periodic checkpoint callback (the JAX package's `checkpoint`):
    every `frequency` iterations (and at the final iteration) write an
    atomic, rotated checkpoint of the model plus the exact trainer
    state, resumable through `train(checkpoint_dir=...)` by either
    package.  A failed write warns and training continues: losing one
    checkpoint must not kill a long run.  Inside a process group every
    rank takes part (a rank of a row-sharded learner gathers the serial
    state), rank 0 writes, and every rank waits for the write
    (`CheckpointManager.save_in_group`)."""
    from .observability import process_rank
    from .reliability.checkpoint import CheckpointManager
    mgr = manager if manager is not None else CheckpointManager(
        checkpoint_dir, keep_last=keep_last)

    def _callback(env: CallbackEnv) -> None:
        if frequency <= 0:
            return
        it = env.iteration + 1
        if it % frequency != 0 and it != env.end_iteration:
            return
        gbdt = getattr(env.model, "_gbdt", None)
        net = (gbdt.group_network() if hasattr(gbdt, "group_network")
               else None)
        if net is None and process_rank() != 0:
            return
        if mgr.params_hash is None:
            from .reliability.checkpoint import hash_params
            mgr.params_hash = hash_params(env.params)
        from .observability import emit_event, global_registry

        def _on_done(ok, err, ck):
            # shared accounting for both write modes: in async mode this
            # fires from the writer thread once the files land (or fail)
            if ok:
                global_registry.inc("checkpoint_writes")
                emit_event("checkpoint", iteration=it, path=ck.model_path)
            else:
                global_registry.inc("checkpoint_failures")
                emit_event("checkpoint_write_failed", iteration=it,
                           error=str(err))
                log.warning(f"Checkpoint write failed at iteration {it}: "
                            f"{err}; training continues (the previous "
                            "checkpoint is intact)")
        if net is not None:
            mgr.save_in_group(env.model, it, net, on_done=_on_done)
            return
        mgr.save(env.model, it, on_done=_on_done)
    _callback.order = 40
    return _callback


def record_metrics(metrics_dir: str = None, logger=None):
    """Structured telemetry callback (the JAX package's `record_metrics`):
    appends ONE JSONL `iteration` event per boosting iteration to
    `<metrics_dir>/events-rank<r>.jsonl` with the JAX event's fields:
    iteration wall-clock, the per-phase timer breakdown (delta of
    `global_timer` since the previous iteration, `<scope>::device` the
    CUDA-event device time), train/valid eval results, the grown trees'
    leaves and depth, and the cumulative counter/gauge snapshot
    (checkpoint writes, injected faults, rollbacks, trees grown, device
    memory).  Every record also goes to the always-on flight recorder.

    `train(metrics_dir=...)` installs it and turns the timer on; pass it
    explicitly (with a shared EventLogger) to co-locate events from
    custom callbacks.  With the cost model enabled (param `roofline`, on
    during metrics runs) the event also carries `roofline`: per group
    (`grow_tree`, `gradients`, `device_eval`, as in the JAX event) the
    measured MFU, arithmetic intensity and a compute- vs memory-bound
    classification, from the analytic flop/byte deltas over the same
    window as the phase timings (observability/costmodel.py)."""
    import time as _time

    import numpy as np

    from .observability import EventLogger, global_registry
    from .observability.costmodel import global_cost_model
    from .observability.flightrec import flight_recorder
    from .utils.timer import global_timer

    if metrics_dir is None and logger is None:
        raise ValueError("record_metrics needs metrics_dir or a logger")
    state: Dict[str, Any] = {"t": _time.perf_counter(),
                             "snap": global_timer.snapshot(),
                             "cost": global_cost_model.snapshot()}

    def _callback(env: CallbackEnv) -> None:
        lg = state.get("logger")
        if lg is None:
            lg = logger if logger is not None else EventLogger(metrics_dir)
            state["logger"] = lg
        gbdt = env.model._gbdt
        now = _time.perf_counter()
        snap = global_timer.snapshot()
        prev = state["snap"]
        phases = {}
        phase_secs = {}
        for name, (sec, _cnt) in snap.items():
            d = sec - prev.get(name, (0.0, 0))[0]
            if d > 0:
                phase_secs[name] = d
                phases[name] = round(d, 6)
        state["snap"] = snap
        time_s = now - state["t"]
        state["t"] = now

        # per-phase roofline: analytic flop/byte deltas over this
        # iteration's window, against the phase's ::device time
        roofline = None
        if global_cost_model.enabled:
            cost = global_cost_model.snapshot()
            roofline = global_cost_model.phase_roofline(
                state["cost"], cost, phase_secs,
                backend=gbdt.device.type) or None
            state["cost"] = cost

        train_evals, valid_evals = {}, {}
        for name, metric, value, _hb in env.evaluation_result_list:
            if name == "training":
                train_evals[metric] = value
            else:
                valid_evals[f"{name} {metric}"] = value
        K = gbdt.num_tree_per_iteration
        trees = []
        for t in gbdt.models_[-K:] if len(gbdt.models_) >= K else []:
            nl = int(getattr(t, "num_leaves", 1))
            depth = (int(np.max(t.leaf_depth[:nl]))
                     if nl > 1 and hasattr(t, "leaf_depth") else 0)
            trees.append({"leaves": nl, "depth": depth})
        reg = global_registry.snapshot()
        fields = dict(iteration=env.iteration + 1,
                      time_s=round(time_s, 6), phases=phases,
                      train=train_evals, valid=valid_evals, trees=trees,
                      counters=reg["counters"], gauges=reg["gauges"])
        if roofline:
            fields["roofline"] = roofline
        lg.emit("iteration", **fields)
        # the bounded in-process tail a stall/crash/SIGUSR2 dump reads
        device_ms = sum(v for k, v in phase_secs.items()
                        if k.endswith("::device")) * 1000.0
        flight_recorder.record_iteration(
            iteration=env.iteration + 1, time_s=round(time_s, 6),
            phase_ms={k: round(v * 1000.0, 3)
                      for k, v in phase_secs.items()},
            device_ms=round(device_ms, 3),
            device_bytes=reg["gauges"].get("device_bytes_in_use"),
            rows_per_s=(round(gbdt.num_data / time_s, 1)
                        if time_s > 0 else None))
    _callback.order = 50
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0):
    """ref: callback.py early_stopping / _EarlyStoppingCallback."""
    state: Dict[str, Any] = {}

    def _is_improved(score, best, higher_better):
        if higher_better:
            return score > best + min_delta
        return score < best - min_delta

    def _callback(env: CallbackEnv) -> None:
        if state.get("disabled"):
            return
        if not env.evaluation_result_list:
            # warn ONCE and disable: repeating this every iteration was
            # pure log spam, and no validation set can appear mid-run
            log.warning("Early stopping requires at least one validation "
                        "set; disabling early stopping")
            state["disabled"] = True
            return
        if not state:
            state["best_score"] = {}
            state["best_iter"] = {}
            state["best_list"] = {}
        first_metric = env.evaluation_result_list[0][1].split(" ")[-1]
        for name, metric, value, higher_better in env.evaluation_result_list:
            if name == "training":
                continue
            if first_metric_only and metric.split(" ")[-1] != first_metric:
                continue
            key = f"{name} {metric}"
            if key not in state["best_score"] or _is_improved(
                    value, state["best_score"][key], higher_better):
                state["best_score"][key] = value
                state["best_iter"][key] = env.iteration
                state["best_list"][key] = list(env.evaluation_result_list)
            elif env.iteration - state["best_iter"][key] >= stopping_rounds:
                if verbose:
                    log.info(f"Early stopping, best iteration is:\n"
                             f"[{state['best_iter'][key] + 1}]")
                raise EarlyStopException(state["best_iter"][key],
                                         state["best_list"][key])
    _callback.order = 30
    return _callback
