"""Training callbacks (PyTorch port of `lightgbm_tpu/callback.py`; ref:
python-package/lightgbm/callback.py).

`checkpoint` and `record_metrics` belong to the host planes (checkpoint
capture of device state, the event log), which come with ROADMAP
Queue 1 item 16; calling them raises NotImplementedError.
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
    """Periodic checkpoints: not ported yet (ROADMAP Queue 1 item 16)."""
    raise NotImplementedError("the checkpoint callback is not ported yet "
                              "(ROADMAP Queue 1 item 16)")


def record_metrics(metrics_dir: str = None, logger=None):
    """Structured telemetry events: not ported yet (ROADMAP Queue 1 item
    16)."""
    raise NotImplementedError("the record_metrics callback is not ported "
                              "yet (ROADMAP Queue 1 item 16)")


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
