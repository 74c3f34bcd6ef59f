"""Training entry points: `train` and `cv` (PyTorch port of
`lightgbm_tpu/engine.py`; ref: python-package/lightgbm/engine.py).

`train` takes validation sets, `feval`, a custom objective (`fobj`) and
callbacks, with early stopping and the non-finite sentinel, and
continues an `init_model` (a Booster, a model file or model text).  What
stays refused names the ROADMAP Queue 1 item that brings it: the host
planes (`checkpoint_dir`, `metrics_dir`, `profile_dir`, `metrics_port`,
item 16).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation)
from .config import Config
from .reliability import NonFiniteError
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


def _refuse_unported(cfg: Config, checkpoint_dir, metrics_dir) -> None:
    for what, on in (("checkpoint_dir", checkpoint_dir or cfg.checkpoint_dir),
                     ("metrics_dir", metrics_dir or cfg.metrics_dir),
                     ("profile_dir", cfg.profile_dir),
                     ("metrics_port", cfg.metrics_port >= 0)):
        if on:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                      "Queue 1 item 16)")


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
          metrics_dir: Optional[str] = None) -> Booster:
    """Train a booster for `num_boost_round` iterations, or until no leaf
    can split or early stopping fires (ref: engine.py:66 train).  With
    `init_model` the booster starts from that model's trees and scores;
    `keep_training_booster` is accepted as the JAX package accepts it (the
    returned booster can always train on)."""
    params = dict(params or {})
    cfg = Config(params)
    # an explicitly passed num_iterations (or alias) wins over the default
    if "num_iterations" in cfg.raw_params:
        num_boost_round = cfg.num_iterations
    _refuse_unported(cfg, checkpoint_dir, metrics_dir)

    booster = Booster(params=params, train_set=train_set)
    train_in_valid = False
    valid_wrappers = []
    for i, vs in enumerate(valid_sets or []):
        if vs is train_set:
            train_in_valid = True
            continue
        name = (valid_names[i] if valid_names and i < len(valid_names)
                else f"valid_{i}")
        booster.add_valid(vs, name)
        valid_wrappers.append(vs)
    if init_model is not None:
        # continued training: the returned booster holds old + new trees
        prev = _init_booster(init_model, cfg.device_type)
        with global_timer.scope("GBDT::continue_from"):
            booster._gbdt.continue_from(
                prev._gbdt, train_raw=_raw_of(train_set),
                valid_raws=[_raw_of(vs) for vs in valid_wrappers])

    callbacks = list(callbacks or [])
    if cfg.early_stopping_round > 0 and valid_sets:
        callbacks.append(early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            verbose=cfg.verbosity >= 1,
            min_delta=cfg.early_stopping_min_delta))
    if cfg.verbosity >= 1 and cfg.metric_freq > 0:
        callbacks.append(log_evaluation(cfg.metric_freq))
    callbacks_before = sorted(
        (cb for cb in callbacks if getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))
    callbacks_after = sorted(
        (cb for cb in callbacks
         if not getattr(cb, "before_iteration", False)),
        key=lambda cb: getattr(cb, "order", 0))

    train_has_metric = bool(cfg.is_provide_training_metric) or train_in_valid
    sentinel_freq = max(int(cfg.nonfinite_check_freq), 0)
    try:
        for i in range(num_boost_round):
            env = CallbackEnv(model=booster, params=params, iteration=i,
                              begin_iteration=0,
                              end_iteration=num_boost_round,
                              evaluation_result_list=[])
            for cb in callbacks_before:
                cb(env)
            with global_timer.scope("GBDT::train_one_iter"):
                if booster.update(fobj=fobj):
                    break
            evals = []
            with global_timer.scope("GBDT::eval"):
                if train_has_metric:
                    evals.extend(booster.eval_train(feval))
                evals.extend(booster.eval_valid(feval))
            if sentinel_freq > 0:
                _check_finite(booster, evals, i,
                              check_scores=(i + 1) % sentinel_freq == 0)
            env.evaluation_result_list = evals
            for cb in callbacks_after:
                cb(env)
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
        for name, metric, value, _ in e.best_score:
            booster.best_score.setdefault(name, {})[metric] = value
    if booster.best_iteration < 0:
        for name, metric, value, _ in booster.eval_valid(feval):
            booster.best_score.setdefault(name, {})[metric] = value
    return booster


class CVBooster:
    """The per-fold boosters of `cv`; a method call runs on each and
    returns the per-fold results (ref: python-package engine.py
    CVBooster).  Serializes as JSON of model texts + best_iteration."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

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
        cvb = CVBooster()
        cvb.boosters = boosters
        cvb.best_iteration = max((b.best_iteration for b in boosters),
                                 default=-1)
        out["cvbooster"] = cvb
    return out
