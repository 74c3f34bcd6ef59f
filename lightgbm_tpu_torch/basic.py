"""User-facing Dataset and Booster (PyTorch port of the slice of
`lightgbm_tpu/basic.py` the main path uses; ref:
python-package/lightgbm/basic.py)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .boosting import GBDT
from .boosting.model_io import (load_model_from_file, load_model_from_string,
                                save_model_to_file, save_model_to_string)
from .config import Config
from .io.dataset import Dataset as _CoreDataset
from .objective import create_objective
from .utils import log
from .utils.device import resolve_device


def _coerce_matrix(data) -> np.ndarray:
    """pandas / array-like -> float ndarray (float32 passes through)."""
    if hasattr(data, "values"):          # pandas
        data = data.values
    data = np.asarray(data)
    if data.dtype == np.float32:
        return data
    return np.asarray(data, dtype=np.float64)


class Dataset:
    """Lazily-constructed training dataset (ref: basic.py:1555 Dataset)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, init_score=None, feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._core: Optional[_CoreDataset] = None

    def construct(self) -> "Dataset":
        if self._core is not None:
            return self
        if isinstance(self.data, (str, bytes)):
            raise NotImplementedError("loading a Dataset from a file is not "
                                      "ported yet (ROADMAP Queue 1 item 1)")
        cfg = Config(self.params)
        if self.feature_name == "auto" and hasattr(self.data, "columns"):
            self.feature_name = list(map(str, self.data.columns))
        cat = []
        if self.categorical_feature not in ("auto", None):
            cat = [int(c) for c in self.categorical_feature]
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        data = _coerce_matrix(self.data)
        ref_core = (self.reference._core_or_construct()
                    if self.reference is not None else None)
        if ref_core is not None:
            self._core = ref_core.create_valid(
                data, label=self.label, weight=self.weight,
                init_score=self.init_score)
        else:
            self._core = _CoreDataset.construct_from_arrays(
                data, label=self.label, weight=self.weight,
                init_score=self.init_score, max_bin=cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                min_data_in_leaf=cfg.min_data_in_leaf,
                bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
                categorical_feature=cat, feature_names=names,
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                feature_pre_filter=cfg.feature_pre_filter,
                seed=cfg.data_random_seed,
                max_bin_by_feature=cfg.max_bin_by_feature or None,
                forcedbins_filename=cfg.forcedbins_filename,
                device_type=cfg.device_type)
        if self.free_raw_data:
            self.data = None
        return self

    def _core_or_construct(self) -> _CoreDataset:
        self.construct()
        return self._core

    def create_valid(self, data, label=None, weight=None,
                     init_score=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       init_score=init_score, params=self.params)


class Booster:
    """ref: basic.py:2800 Booster (direct engine here)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self._train_set = train_set
        if train_set is not None:
            cfg = Config(self.params)
            train_set.params = {**self.params, **train_set.params}
            core = train_set._core_or_construct()
            self._gbdt = GBDT()
            self._gbdt.init(cfg, core, create_objective(cfg))
        elif model_file is not None or model_str is not None:
            self._gbdt = (load_model_from_file(model_file)
                          if model_file is not None
                          else load_model_from_string(model_str))
            # the model text gives every setting but where to predict:
            # device_type and device_predict come from `params`, with the
            # training defaults (cuda, auto)
            prev_verbosity = log.get_verbosity()
            cfg = Config(self.params)
            if "verbosity" not in cfg.raw_params:
                # Config sets the process-wide log level as a side effect
                log.set_verbosity(prev_verbosity)
            self._gbdt.config.device_type = cfg.device_type
            self._gbdt.config.device_predict = cfg.device_predict
            self._gbdt.device = resolve_device(cfg.device_type)
        else:
            log.fatal("Booster needs train_set, model_file or model_str")

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True if stopped."""
        if train_set is not None:
            log.fatal("Resetting training data is not yet supported")
        if fobj is not None:
            raise NotImplementedError("custom objectives are not ported yet "
                                      "(ROADMAP Queue 1 item 14)")
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def predict(self, data, start_iteration: int = 0, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Predictions, leaf ids (`pred_leaf`) or early-stopped scores.
        On a card booster with `device_predict=auto` (the default) they
        are computed on the card; float32 input passes through unchanged,
        which is what the device routing needs to be exact."""
        if pred_contrib:
            raise NotImplementedError("pred_contrib (TreeSHAP) is not "
                                      "ported yet (ROADMAP Queue 1 item 14)")
        if num_iteration is None or (num_iteration == -1
                                     and self.best_iteration > 0):
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        return self._gbdt.predict(
            _coerce_matrix(data), raw_score=raw_score,
            start_iteration=start_iteration, num_iteration=num_iteration,
            pred_leaf=pred_leaf, pred_early_stop=pred_early_stop,
            pred_early_stop_freq=pred_early_stop_freq,
            pred_early_stop_margin=pred_early_stop_margin)

    def model_to_string(self, num_iteration: int = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        return save_model_to_string(self._gbdt, num_iteration,
                                    start_iteration, importance_type)

    def save_model(self, filename: str, num_iteration: int = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        save_model_to_file(self._gbdt, filename, num_iteration,
                           start_iteration, importance_type)
        return self

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)
