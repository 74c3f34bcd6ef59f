"""Training entry points: `train` and `cv` (PyTorch port of
`lightgbm_tpu/engine.py`; ref: python-package/lightgbm/engine.py).

`train` takes validation sets, `feval`, a custom objective (`fobj`) and
callbacks, with early stopping and the non-finite sentinel, and
continues an `init_model` (a Booster, a model file or model text).  Its
host planes are the JAX package's: checkpoints with resume and one NaN
rollback, preemption checkpoints on SIGTERM, the stall watchdog with its
degradation ladder, the JSONL event log, the flight recorder, a
torch.profiler trace and the Prometheus listener.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, checkpoint,
                       early_stopping, log_evaluation, record_evaluation,
                       record_metrics)
from .config import Config
from .parallel.data_parallel import DATA_LEARNERS
from .reliability import CheckpointManager, NonFiniteError
from .utils import log
from .utils.timer import global_timer


def _check_finite(booster: Booster, evals, iteration: int,
                  check_scores: bool) -> None:
    """Non-finite sentinel: NaN gradients or eval scores mean every later
    tree is garbage, so training fails fast.  The gradient and score
    flags ride the eval tick's packed transfer when the training metrics
    run on the device; otherwise one [2]-vector transfer fetches them."""
    for name, metric, value, _ in evals:
        if value != value:  # NaN
            raise NonFiniteError(
                f"Evaluation metric {name} {metric} is NaN at iteration "
                f"{iteration + 1}. The model scores are corrupt — check the "
                "objective/labels for invalid values. Set "
                "nonfinite_check_freq=0 to disable this sentinel.")
    if check_scores:
        if not booster._gbdt.gradients_finite():
            raise NonFiniteError(
                f"Non-finite gradients detected at (or before) iteration "
                f"{iteration + 1}: the split scan masks NaN gains to zero, "
                "so every tree since the corruption is garbage. Check the "
                "objective/labels for invalid values. Set "
                "nonfinite_check_freq=0 to disable this sentinel.")
        if not booster._gbdt.scores_finite():
            raise NonFiniteError(
                f"Non-finite training scores detected at iteration "
                f"{iteration + 1}: the gradients or tree outputs contain "
                "NaN/Inf. Check the objective, labels and learning_rate. "
                "Set nonfinite_check_freq=0 to disable this sentinel.")


def _init_booster(init_model, device_type: str) -> Booster:
    """The model to continue: a Booster as it is, else model text (a
    string holding a newline) or the path of a model file, loaded on the
    training device (ref: engine.py init_model -> _InnerPredictor)."""
    if isinstance(init_model, Booster):
        return init_model
    if isinstance(init_model, (str, bytes, os.PathLike)):
        params = {"device_type": device_type}
        if isinstance(init_model, str) and "\n" in init_model:
            return Booster(model_str=init_model, params=params)
        return Booster(model_file=os.fspath(init_model), params=params)
    log.fatal(f"Unknown init_model type: {type(init_model)}")


def _raw_of(ds: Dataset):
    """A Dataset's raw matrix when it was kept (free_raw_data=False)."""
    d = getattr(ds, "data", None)
    if d is None or isinstance(d, (str, bytes)):
        return None
    return d.values if hasattr(d, "values") else np.asarray(d)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          feval=None, init_model=None, keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None, fobj=None,
          checkpoint_dir: Optional[str] = None,
          checkpoint_freq: Optional[int] = None,
          resume: Optional[bool] = None,
          metrics_dir: Optional[str] = None) -> Booster:
    """Train a booster for `num_boost_round` iterations, or until no leaf
    can split or early stopping fires (ref: engine.py:66 train; the JAX
    package's engine.py:55-470).  With `init_model` the booster starts
    from that model's trees and scores; `keep_training_booster` is
    accepted as the JAX package accepts it (the returned booster can
    always train on).

    Reliability: `checkpoint_dir` writes atomic checkpoints every
    `checkpoint_freq` iterations; with `resume` (default True) a run
    restarted with the same directory continues from the newest verified
    checkpoint, of either package, reproducing the uninterrupted run
    byte for byte; a NaN sentinel trip rolls back once to the last good
    checkpoint.  Observability: `metrics_dir` appends a JSONL event per
    iteration to `<metrics_dir>/events-rank<r>.jsonl`, arms the flight
    recorder (SIGUSR2 dumps it) and, with `stall_floor_s > 0`, the stall
    watchdog; `profile_dir` writes a torch.profiler Chrome trace;
    `metrics_port` serves `GET /metrics`.  All of them can also be
    given as params."""
    params = dict(params or {})
    cfg = Config(params)
    # an explicitly passed num_iterations (or alias) wins over the default
    if "num_iterations" in cfg.raw_params:
        num_boost_round = cfg.num_iterations
    if checkpoint_dir is None:
        checkpoint_dir = cfg.checkpoint_dir or None
    if checkpoint_freq is None:
        checkpoint_freq = cfg.checkpoint_freq
    if resume is None:
        resume = cfg.resume
    if metrics_dir is None:
        metrics_dir = cfg.metrics_dir or None
    # inside a process group every rank takes part in each checkpoint
    # (rank 0 writes the serial run's state, callback.checkpoint)
    in_group = False
    if cfg.tree_learner in DATA_LEARNERS:
        from .parallel import current_network
        in_group = current_network() is not None

    from .observability import process_rank
    rank = process_rank()
    # ---- degradation ladder: a previous attempt that hung left a
    # stall-rank<r>.json in metrics_dir; this restart consumes it,
    # disables the next risky knob and resumes from the checkpoint
    degrade_info = {"applied": [], "new": [], "stall": None}
    if cfg.auto_degrade:
        from .reliability.guard import apply_auto_degrade
        degrade_info = apply_auto_degrade(cfg, params, metrics_dir,
                                          rank=rank)
    # one bounded writer thread drains event appends and checkpoint
    # serialization (`async_host_io=false`: synchronous, the same bytes)
    writer = None
    if cfg.async_host_io and (checkpoint_dir or metrics_dir):
        from .observability import AsyncWriter
        writer = AsyncWriter()
    ckpt_mgr = (CheckpointManager(checkpoint_dir,
                                  keep_last=cfg.checkpoint_keep,
                                  params=params, writer=writer)
                if checkpoint_dir else None)
    if writer is not None or metrics_dir or ckpt_mgr is not None:
        # SIGTERM flushes the queued events and checkpoints before the
        # process dies; with a checkpoint dir the handler first saves a
        # checkpoint on demand (a preemption notice)
        from .observability import install_sigterm_flush
        install_sigterm_flush()
    # ---- preemption checkpoint on demand: `_progress` is the handler's
    # view of the run; mid-update, model text, scores and iteration are
    # no consistent triple, so the save waits for the iteration boundary
    _progress: Dict[str, Any] = {"booster": None, "iteration": 0,
                                 "in_update": False,
                                 "preempt_pending": False}
    if ckpt_mgr is not None and cfg.preempt_ckpt_grace_s > 0 and in_group:
        # a group's checkpoint is a collective: one rank's SIGTERM cannot
        # take it alone (the supervisor relaunches from the last one)
        log.info("preemption checkpoints are off inside a process group")
    elif ckpt_mgr is not None and cfg.preempt_ckpt_grace_s > 0:
        from .observability import set_preemption_hook

        def _preempt_save():
            if _progress["in_update"]:
                _progress["preempt_pending"] = True
                return False
            booster = _progress["booster"]
            it = int(_progress["iteration"])
            if booster is None or it <= 0:
                return True
            from .observability import emit_event, global_registry
            t0 = time.monotonic()
            saved = False
            try:
                saved = ckpt_mgr.save_now(
                    booster, it, grace_s=cfg.preempt_ckpt_grace_s) is not None
            except OSError as e:
                log.warning(f"Preemption checkpoint at iteration {it} "
                            f"failed: {e}")
            if saved:
                global_registry.inc("preempt_ckpt_saved")
            emit_event("preempt", iteration=it, saved=saved,
                       elapsed_s=round(time.monotonic() - t0, 3),
                       grace_s=cfg.preempt_ckpt_grace_s)
            return True

        set_preemption_hook(_preempt_save)

    # ---- observability
    event_logger = None
    timer_was_enabled = global_timer.enabled
    cost_was_enabled = None
    metrics_srv = None
    if metrics_dir:
        from .observability import EventLogger, set_event_logger
        from .observability.flightrec import flight_recorder
        from .reliability.faults import register_flight_dump_signal
        event_logger = EventLogger(metrics_dir,
                                   rotate_mb=cfg.metrics_rotate_mb,
                                   writer=writer)
        set_event_logger(event_logger)
        # the per-iteration phase breakdown diffs global_timer snapshots:
        # a metrics run always times (restored afterwards)
        global_timer.enabled = True
        if cfg.roofline:
            # per-phase measured MFU and roofline classification in the
            # iteration events (observability/costmodel.py; restored
            # afterwards)
            from .observability import enable_cost_model
            cost_was_enabled = enable_cost_model(True)
        # flight recorder bound + SIGUSR2 on-demand dump
        flight_recorder.resize(cfg.flight_recorder_size)
        register_flight_dump_signal(metrics_dir, rank=rank)
        event_logger.emit("train_start", num_boost_round=num_boost_round,
                          params=cfg.changed_params())
        if degrade_info["new"]:
            event_logger.emit("degrade", knobs=degrade_info["new"],
                              active=degrade_info["applied"],
                              stall_iteration=(degrade_info["stall"] or {})
                              .get("last_iteration"))
    if cfg.metrics_port >= 0:
        from .observability import start_metrics_http
        metrics_srv = start_metrics_http(cfg.metrics_port)
    profiler = _start_profiler(cfg.profile_dir or None)

    start_iteration = 0
    resume_ckpt = None
    if ckpt_mgr is not None and resume:
        ck = ckpt_mgr.resumable(params)
        if ck is not None:
            if init_model is not None:
                log.warning("Both init_model and a resumable checkpoint "
                            "were given; the checkpoint wins")
            init_model = ck.model_path
            start_iteration = min(ck.iteration, num_boost_round)
            resume_ckpt = ck
            log.info(f"Resuming from checkpoint at iteration {ck.iteration} "
                     f"({ck.model_path})")

    def _build_booster() -> Booster:
        booster = Booster(params=params, train_set=train_set)
        booster._train_in_valid = False
        valid_wrappers = []
        for i, vs in enumerate(valid_sets or []):
            if vs is train_set:
                booster._train_in_valid = True
                continue
            name = (valid_names[i] if valid_names and i < len(valid_names)
                    else f"valid_{i}")
            booster.add_valid(vs, name)
            valid_wrappers.append(vs)
        if init_model is not None:
            # continued training: the returned booster holds old + new
            # trees; a checkpoint resume then restores the exact score
            # buffer and sampling streams (byte-identical final model)
            prev = _init_booster(init_model, cfg.device_type)
            with global_timer.scope("GBDT::continue_from"):
                booster._gbdt.continue_from(
                    prev._gbdt, train_raw=_raw_of(train_set),
                    valid_raws=[_raw_of(vs) for vs in valid_wrappers])
            if resume_ckpt is not None:
                booster._gbdt.restore_train_state(resume_ckpt.load_state())
        return booster

    # ---- stall watchdog: on when there is a directory for its diagnosis
    run_guard = None
    if cfg.stall_floor_s > 0 and metrics_dir:
        from .reliability.guard import RunGuard
        run_guard = RunGuard(
            metrics_dir, rank=rank, stall_floor_s=cfg.stall_floor_s,
            stall_factor=cfg.stall_factor,
            knobs={"tpu_donate_buffers": cfg.tpu_donate_buffers,
                   "async_host_io": cfg.async_host_io,
                   "compile_cache_dir": cfg.compile_cache_dir,
                   "device_eval": cfg.device_eval,
                   "auto_degrade": cfg.auto_degrade,
                   "degraded_knobs": list(degrade_info["applied"])},
            writer=writer)
        run_guard.start()

    rollbacks = 0
    try:
        while True:
            booster = _build_booster()
            _progress["booster"] = booster
            _progress["iteration"] = start_iteration
            gbdt = booster._gbdt
            if run_guard is not None:
                run_guard.device = gbdt.device
                run_guard.update_knobs(growth_strategy=gbdt.growth_strategy,
                                       device=str(gbdt.device))
            callbacks_before, callbacks_after = _sorted_callbacks(
                cfg, callbacks, valid_sets, checkpoint_dir, checkpoint_freq,
                ckpt_mgr, event_logger)
            booster.best_iteration = -1
            train_has_metric = (bool(cfg.is_provide_training_metric)
                                or booster._train_in_valid)
            sentinel_freq = max(int(cfg.nonfinite_check_freq), 0)
            try:
                for i in range(start_iteration, num_boost_round):
                    env = CallbackEnv(model=booster, params=params,
                                      iteration=i,
                                      begin_iteration=start_iteration,
                                      end_iteration=num_boost_round,
                                      evaluation_result_list=[])
                    for cb in callbacks_before:
                        cb(env)
                    _progress["in_update"] = True
                    with global_timer.scope("GBDT::train_one_iter"):
                        stopped = booster.update(fobj=fobj)
                    # the model and scores now describe iteration i + 1:
                    # publish that before clearing in_update
                    _progress["iteration"] = i + 1
                    _progress["in_update"] = False
                    if _progress["preempt_pending"]:
                        # a SIGTERM arrived mid-update: save at this
                        # boundary, then finish the termination
                        _progress["preempt_pending"] = False
                        _preempt_save()
                        from .observability.hostio import finish_preemption
                        finish_preemption()
                    if stopped:
                        if sentinel_freq > 0:
                            # non-finite gradients split nothing, so the
                            # port stops where the JAX package (whose
                            # stop check lags) trains on: a stop right
                            # after corruption is the sentinel's to raise
                            _check_finite(booster, [], i, check_scores=True)
                        break
                    evals = []
                    with global_timer.scope("GBDT::eval"):
                        if train_has_metric:
                            evals.extend(booster.eval_train(feval))
                        evals.extend(booster.eval_valid(feval))
                    if sentinel_freq > 0:
                        if (i + 1) % sentinel_freq == 0:
                            # the device-memory gauges ride the sentinel
                            # tick into the next iteration event
                            from .observability import update_memory_gauges
                            update_memory_gauges(gbdt.device)
                        # always check right before a checkpoint write, so
                        # a checkpoint never captures a corrupt model
                        will_ckpt = (ckpt_mgr is not None and checkpoint_freq
                                     and checkpoint_freq > 0
                                     and ((i + 1) % checkpoint_freq == 0
                                          or i + 1 == num_boost_round))
                        _check_finite(
                            booster, evals, i,
                            check_scores=((i + 1) % sentinel_freq == 0
                                          or will_ckpt))
                    env.evaluation_result_list = evals
                    for cb in callbacks_after:
                        cb(env)
                    if run_guard is not None:
                        run_guard.tick(i + 1)
            except EarlyStopException as e:
                booster.best_iteration = e.best_iteration + 1
                for name, metric, value, _ in e.best_score:
                    booster.best_score.setdefault(name, {})[metric] = value
            except NonFiniteError as e:
                if writer is not None:
                    # land an in-flight checkpoint before choosing where
                    # to roll back to
                    writer.flush()
                ck = (ckpt_mgr.resumable(params) if ckpt_mgr is not None
                      else None)
                if ck is None or rollbacks >= 1:
                    raise
                # roll back once: rebuild from the last good checkpoint
                # and re-run the lost iterations (a transient fault does
                # not recur; a persistent one raises on the second)
                rollbacks += 1
                from .observability import emit_event, global_registry
                global_registry.inc("rollback_retries")
                emit_event("rollback_retry", from_iteration=ck.iteration,
                           error=str(e))
                log.warning(f"{e}\nRolling back to the checkpoint at "
                            f"iteration {ck.iteration} and retrying once")
                init_model = ck.model_path
                start_iteration = min(ck.iteration, num_boost_round)
                resume_ckpt = ck
                continue
            break

        if booster.best_iteration < 0:
            for name, metric, value, _ in booster.eval_valid(feval):
                booster.best_score.setdefault(name, {})[metric] = value
        if event_logger is not None:
            if writer is not None:
                # land in-flight checkpoints (and their events) first so
                # train_end stays the log's last record
                writer.flush()
            from .observability import global_registry
            event_logger.emit(
                "train_end", total_iterations=booster.current_iteration(),
                best_iteration=booster.best_iteration,
                counters=global_registry.snapshot()["counters"])
        return booster
    finally:
        if sys.exc_info()[0] is not None and metrics_dir:
            # crashing: dump the flight recorder next to the logs
            from .observability.flightrec import dump_flight_record
            dump_flight_record(metrics_dir, rank=rank, reason="crash")
        if ckpt_mgr is not None and cfg.preempt_ckpt_grace_s > 0:
            from .observability import clear_preemption_hook
            clear_preemption_hook()
        if run_guard is not None:
            run_guard.stop()
        global_timer.enabled = timer_was_enabled
        if cost_was_enabled is not None:
            from .observability import enable_cost_model
            enable_cost_model(cost_was_enabled)
        if metrics_srv is not None:
            metrics_srv.shutdown()
        _stop_profiler(profiler, cfg.profile_dir or None, rank)
        if writer is not None:
            # drain queued events and checkpoints on train end AND on
            # error (a crashed run's log stays complete)
            writer.close()
        if event_logger is not None:
            from .observability import set_event_logger
            set_event_logger(None)
            event_logger.close()


def _sorted_callbacks(cfg, callbacks, valid_sets, checkpoint_dir,
                      checkpoint_freq, ckpt_mgr, event_logger):
    """The user's callbacks plus the ones the params ask for (early
    stopping, evaluation logging, checkpoints, the event log), split
    into before- and after-iteration lists in `order`."""
    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0 and valid_sets:
        callbacks.append(early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    if cfg.verbosity >= 1 and cfg.metric_freq > 0:
        callbacks.append(log_evaluation(cfg.metric_freq))
    if ckpt_mgr is not None and checkpoint_freq and checkpoint_freq > 0:
        callbacks.append(checkpoint(checkpoint_dir, frequency=checkpoint_freq,
                                    manager=ckpt_mgr))
    if event_logger is not None:
        callbacks.append(record_metrics(logger=event_logger))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    return before, after


def _start_profiler(profile_dir: Optional[str]):
    """A torch.profiler profile (CPU, and CUDA activity when a card is
    present) over the training run, or None.  A profiler that fails to
    start warns and training goes on."""
    if not profile_dir:
        return None
    try:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        log.info(f"torch.profiler started; the Chrome trace will be "
                 f"written to {profile_dir}")
        return prof
    except Exception as e:  # noqa: BLE001 - profiling must never block training
        log.warning(f"Could not start the torch profiler for "
                    f"{profile_dir}: {e}")
        return None


def _stop_profiler(prof, profile_dir: Optional[str], rank: int) -> None:
    """Stop the profiler and write `<profile_dir>/trace-rank<r>.json`."""
    if prof is None:
        return
    try:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace-rank{rank}.json")
        prof.export_chrome_trace(path)
        log.info(f"torch.profiler trace written to {path}")
    except Exception as e:  # noqa: BLE001
        log.warning(f"torch.profiler trace could not be written: {e}")


class CVBooster:
    """The per-fold boosters of `cv`; a method call runs on each and
    returns the per-fold results (ref: python-package engine.py
    CVBooster).  Serializes as JSON of model texts + best_iteration.
    Loaded boosters predict where `params` say (the card by default),
    as `Booster(model_str=..., params=...)` does."""

    def __init__(self, model_file=None, params=None):
        self.boosters: List[Booster] = []
        self.best_iteration = -1
        self._params = dict(params or {})
        if model_file is not None:
            with open(model_file) as f:
                self._load(json.loads(f.read()))

    def _load(self, payload: Dict[str, Any]) -> None:
        self.best_iteration = payload["best_iteration"]
        self.boosters = [Booster(model_str=s, params=self._params)
                         for s in payload["boosters"]]

    def model_from_string(self, model_str: str) -> "CVBooster":
        self._load(json.loads(model_str))
        return self

    def model_to_string(self, num_iteration=None, start_iteration=0,
                        importance_type="split") -> str:
        return json.dumps({
            "boosters": [b.model_to_string(num_iteration=num_iteration,
                                           start_iteration=start_iteration,
                                           importance_type=importance_type)
                         for b in self.boosters],
            "best_iteration": self.best_iteration})

    def save_model(self, filename, num_iteration=None, start_iteration=0,
                   importance_type="split") -> "CVBooster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration,
                                         importance_type))
        return self

    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("boosters", "best_iteration"):
            raise AttributeError(name)

        def per_fold(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs)
                    for b in self.boosters]
        return per_fold


def make_folds(label: np.ndarray, query_boundaries, nfold: int,
               stratified: bool, shuffle: bool, objective: str,
               seed: int):
    """`cv`'s (train indices, test indices) per fold (ref: engine.py
    _make_n_folds, the JAX package's rule): whole queries per fold for
    ranking data, else stratified by label for classification, else
    contiguous blocks of the (shuffled) rows."""
    n = len(label)
    rng = np.random.RandomState(seed)
    if query_boundaries is not None:
        qb = np.asarray(query_boundaries)
        nq = len(qb) - 1
        if nq < nfold:
            log.fatal(f"cv with ranking data needs >= nfold queries "
                      f"(got {nq} queries, nfold={nfold})")
        q_perm = np.arange(nq)
        if shuffle:
            rng.shuffle(q_perm)
        fold_of_q = np.empty(nq, np.int64)
        fold_of_q[q_perm] = np.arange(nq) % nfold
        row_fold = np.repeat(fold_of_q, np.diff(qb))
        return [(np.nonzero(row_fold != k)[0], np.nonzero(row_fold == k)[0])
                for k in range(nfold)]
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    if stratified and objective in ("binary", "multiclass", "multiclassova"):
        idx = idx[np.argsort(label[idx], kind="stable")]
        fold_of = np.arange(n) % nfold
        return [(idx[fold_of != k], idx[fold_of == k]) for k in range(nfold)]
    return [(np.concatenate([idx[:a], idx[b:]]), idx[a:b])
            for a, b in ((k * n // nfold, (k + 1) * n // nfold)
                         for k in range(nfold))]


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, feval=None, init_model=None,
       callbacks: Optional[List[Callable]] = None, seed: int = 0,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """K-fold cross-validation (ref: engine.py:580 cv): one `train` per
    fold with the fold's test rows as its validation set; returns the
    per-round mean and standard deviation of each metric over the
    folds."""
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    cfg = Config(params)
    if "num_iterations" in cfg.raw_params:
        num_boost_round = cfg.num_iterations
    core = train_set._core_or_construct()
    if folds is None:
        folds = make_folds(np.asarray(core.metadata.label),
                           core.metadata.query_boundaries, nfold,
                           stratified, shuffle, cfg.objective, seed)

    boosters = []
    histories: List[Dict[str, List[float]]] = []
    for train_idx, test_idx in folds:
        tr = train_set.subset(np.sort(train_idx))
        va = train_set.subset(np.sort(test_idx))
        hist: Dict[str, Dict[str, List[float]]] = {}
        cbs = list(callbacks or []) + [record_evaluation(hist)]
        bst = train(params, tr, num_boost_round, valid_sets=[va],
                    valid_names=["valid"], feval=feval,
                    init_model=init_model, callbacks=cbs)
        boosters.append(bst)
        histories.append(hist.get("valid", {}))

    out: Dict[str, Any] = {}
    for metric in (histories[0].keys() if histories else []):
        rounds = min(len(h.get(metric, [])) for h in histories)
        vals = np.asarray([h.get(metric, [])[:rounds] for h in histories],
                          dtype=np.float64)
        out[f"valid {metric}-mean"] = vals.mean(axis=0).tolist()
        out[f"valid {metric}-stdv"] = vals.std(axis=0).tolist()
    if return_cvbooster:
        cvb = CVBooster(params=params)
        cvb.boosters = boosters
        cvb.best_iteration = max((b.best_iteration for b in boosters),
                                 default=-1)
        out["cvbooster"] = cvb
    return out
