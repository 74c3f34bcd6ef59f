"""User-facing Dataset and Booster (PyTorch port of the slice of
`lightgbm_tpu/basic.py` the main path uses; ref:
python-package/lightgbm/basic.py)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .boosting import create_boosting
from .boosting.model_io import (load_model_from_file, load_model_from_string,
                                save_model_to_file, save_model_to_string)
from .config import Config
from .io.dataset import Dataset as _CoreDataset
from .io.dataset import Metadata
from .io.sparse import construct_from_sparse, is_scipy_sparse
from .metric import _METRIC_CLASSES, create_metrics
from .objective import create_objective
from .reliability import NonFiniteError
from .utils import log
from .utils.device import resolve_device


# bytes of float64 one row chunk of a sparse matrix to predict may take
# when densified (ref: the CSR predictor paths of c_api.cpp go by rows)
SPARSE_CHUNK_BYTES = 64 << 20


def _coerce_matrix(data) -> np.ndarray:
    """pandas / scipy-sparse / array-like -> float ndarray (float32 passes
    through).  `Dataset` sends scipy input to `io/sparse.py` and
    `Booster.predict` densifies it in row chunks, so a whole sparse
    matrix is densified here only where the JAX package's
    `_coerce_matrix` does it too (linear trees, refit, eval)."""
    if hasattr(data, "values"):          # pandas
        data = data.values
    if is_scipy_sparse(data):            # scipy CSR/CSC/COO
        data = data.toarray()
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
        self.used_indices: Optional[np.ndarray] = None
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
        ref_core = (self.reference._core_or_construct()
                    if self.reference is not None else None)
        if is_scipy_sparse(self.data) and not cfg.linear_tree:
            # scipy CSR/CSC/COO go CSC-direct to EFB bundle codes: the
            # dense [n, F] matrix is never made (io/sparse.py); a valid
            # set against a sparse reference reuses its plan
            self._core = construct_from_sparse(
                self.data, label=self.label, weight=self.weight,
                init_score=self.init_score, max_bin=cfg.max_bin,
                min_data_in_bin=cfg.min_data_in_bin,
                min_data_in_leaf=cfg.min_data_in_leaf,
                bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
                categorical_feature=cat, feature_names=names,
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                feature_pre_filter=cfg.feature_pre_filter,
                seed=cfg.data_random_seed,
                max_conflict_rate=cfg.max_conflict_rate,
                enable_bundle=cfg.enable_bundle,
                max_bin_by_feature=cfg.max_bin_by_feature or None,
                forcedbins_filename=cfg.forcedbins_filename,
                reference=ref_core, device_type=cfg.device_type)
            if self.free_raw_data:
                self.data = None
            return self
        data = _coerce_matrix(self.data)
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

    def subset(self, used_indices: Sequence[int], params=None) -> "Dataset":
        """The rows `used_indices` of this Dataset, on its bin mappers
        (ref: basic.py Dataset.subset; `cv` builds its folds with it)."""
        idx = np.asarray(used_indices, dtype=np.int64)
        core = self._core_or_construct().copy_subrow(idx)
        out = Dataset.__new__(Dataset)
        out.__dict__.update(self.__dict__)
        out.params = dict(params if params is not None else self.params)
        out._core = core
        out.used_indices = idx
        return out

    def get_label(self):
        return (self._core.metadata.label if self._core is not None
                else self.label)

    def get_weight(self):
        return (self._core.metadata.weight if self._core is not None
                else self.weight)


class Booster:
    """ref: basic.py:2800 Booster (direct engine here)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
        self.name_valid_sets: List[str] = []
        self._valid_wrappers: List[Dataset] = []
        if train_set is not None:
            cfg = Config(self.params)
            train_set.params = {**self.params, **train_set.params}
            core = train_set._core_or_construct()
            self._gbdt = create_boosting(cfg.boosting)
            self._gbdt.init(cfg, core, create_objective(cfg),
                            create_metrics(cfg))
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

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Add a validation set, binned on the training set's mappers
        (ref: basic.py Booster.add_valid)."""
        data.reference = data.reference or self._train_set
        data.params = {**self.params, **data.params}
        core = data._core_or_construct()
        self._gbdt.add_valid_data(core, create_metrics(self._gbdt.config))
        self.name_valid_sets.append(name)
        self._valid_wrappers.append(data)
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Update parameters mid-training (ref: basic.py reset_parameter;
        the reset_parameter callback's learning-rate schedules): the
        learning rate, the split parameters and max_depth."""
        g = self._gbdt
        for k, v in params.items():
            if hasattr(g.config, k):
                setattr(g.config, k, v)
        if "learning_rate" in params:
            g.shrinkage_rate = float(params["learning_rate"])
        gp = getattr(g, "grow_params", None)
        if gp is not None:
            hit = set(gp.split._fields) & set(params)
            if hit:
                gp = gp._replace(split=gp.split._replace(
                    **{k: params[k] for k in hit}))
            if "max_depth" in params:
                gp = gp._replace(max_depth=int(params["max_depth"]))
            g.grow_params = gp
        self.params.update(params)
        return self

    def eval(self, data: Dataset, name: str, feval=None):
        """Metrics of this booster on `data` (ref: basic.py Booster.eval).
        On a trained booster `data` joins the validation sets, its scores
        replayed from the trees so far; a loaded booster predicts the
        Dataset's raw data."""
        g = self._gbdt
        if g.train_data is None:
            if data.data is None:
                raise ValueError("Booster.eval of a loaded model needs the "
                                 "Dataset's raw data (free_raw_data=False)")
            X = _coerce_matrix(data.data)
            md = Metadata(X.shape[0])
            md.set_label(data.label)
            md.set_weight(data.weight)
            raw = g.predict_raw(X)
            score = raw.T if raw.ndim == 2 else raw[None, :]
            metrics = create_metrics(g.config)
            for m in metrics:
                m.init(md, X.shape[0])
            out = self._format_eval(name, g._eval(score, metrics), None,
                                    None)
            if feval is not None:
                out.extend(self._feval_results(
                    name, feval, score[0] if len(score) == 1 else score,
                    data))
            return out
        if name not in self.name_valid_sets:
            self.add_valid(data, name)
            vi = len(self.name_valid_sets) - 1
            K = g.num_tree_per_iteration
            for i, tree in enumerate(g.models_):
                g._add_valid_tree_score(vi, tree, i % K)
        return [e for e in self.eval_valid(feval) if e[0] == name]

    def eval_train(self, feval=None):
        return self._format_eval("training", self._gbdt.eval_train(),
                                 feval, None)

    def eval_valid(self, feval=None):
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._format_eval(name, self._gbdt.eval_valid(i),
                                         feval, i))
        return out

    def _format_eval(self, name, results, feval, valid_idx):
        """[(data name, metric name, value, is_higher_better)], the
        built-in metrics first, then feval's (ref: basic.py
        __inner_eval; feval gets the valid set's Dataset)."""
        out = []
        for metric_name, val in results:
            cls = _METRIC_CLASSES.get(metric_name.split("@")[0])
            out.append((name, metric_name, val,
                        bool(cls and cls.is_higher_better)))
        if feval is not None:
            if valid_idx is None:
                score, dset = self._inner_predict_train(), self._train_set
            else:
                sc = self._gbdt.valid_scores[valid_idx]
                score = sc[0] if sc.shape[0] == 1 else sc
                dset = self._valid_wrappers[valid_idx]
            out.extend(self._feval_results(name, feval, score, dset))
        return out

    @staticmethod
    def _feval_results(name, feval, score, dset):
        res = feval(score, dset)
        if not res:
            return []
        if not isinstance(res[0], (list, tuple)):
            res = [res]
        return [(name, metric_name, val, hib)
                for metric_name, val, hib in res]

    def _inner_predict_train(self) -> np.ndarray:
        g = self._gbdt
        sc = g.scores[:, :g.num_data].cpu().numpy()
        return sc[0] if sc.shape[0] == 1 else sc

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; returns True if stopped.  A custom
        objective `fobj(score, train_set) -> (grad, hess)` gets the
        training scores as [n] or, for K classes, [n, K], and may return
        [n, K] or class-major [K * n] gradients (ref: basic.py
        Booster.update -> LGBM_BoosterUpdateOneIterCustom)."""
        if train_set is not None:
            log.fatal("Resetting training data is not yet supported")
        if fobj is not None:
            g = self._gbdt
            K, n = g.num_tree_per_iteration, g.num_data
            g.pre_gradient_hook()
            score = self._inner_predict_train()
            grad, hess = fobj(score if K == 1 else score.T, self._train_set)
            grad = np.asarray(grad, np.float32)
            hess = np.asarray(hess, np.float32)
            if not (np.all(np.isfinite(grad)) and np.all(np.isfinite(hess))):
                raise NonFiniteError(
                    "Custom objective returned NaN/Inf gradients at "
                    f"iteration {g.current_iteration()}: boosting "
                    "on non-finite values produces garbage trees. Check the "
                    "objective for division by zero / log of non-positive "
                    "values.")
            if K > 1:
                grad = (grad.T.reshape(K, n) if grad.ndim == 2
                        else grad.reshape(K, n))
                hess = (hess.T.reshape(K, n) if hess.ndim == 2
                        else hess.reshape(K, n))
            return g.train_one_iter(grad, hess)
        return self._gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees (ref: basic.py
        rollback_one_iter; the JAX package's keeps the scores)."""
        self._gbdt.rollback_one_iter()
        return self

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return self._gbdt.num_trees

    def predict(self, data, start_iteration: int = 0, num_iteration: int = -1,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0,
                single_row_fast: bool = False) -> np.ndarray:
        """Predictions, leaf ids (`pred_leaf`) or early-stopped scores.
        On a card booster with `device_predict=auto` (the default) they
        are computed on the card; float32 input passes through unchanged,
        which is what the device routing needs to be exact.  scipy
        sparse input is densified in row chunks of about 64 MB, never as
        a whole.  `single_row_fast` serves one row through the cached
        native single-row predictor (ref: c_api.h:1350
        LGBM_BoosterPredictForMatSingleRowFastInit)."""
        if pred_contrib:
            raise NotImplementedError("pred_contrib (TreeSHAP) is not "
                                      "ported yet (ROADMAP Queue 1 item 14)")
        if num_iteration is None or (num_iteration == -1
                                     and self.best_iteration > 0):
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        es = dict(pred_early_stop=pred_early_stop,
                  pred_early_stop_freq=pred_early_stop_freq,
                  pred_early_stop_margin=pred_early_stop_margin)
        sparse = is_scipy_sparse(data)
        if single_row_fast and not pred_leaf and not sparse:
            row = np.asarray(data, np.float64)
            if row.ndim == 1:
                row = row[None, :]
            # the model may read any original feature index: a narrower
            # row would read past the C buffer, so it takes the batch
            # path, which checks it
            if row.shape[0] == 1 and row.shape[1] >= self.num_feature():
                fast = self._single_row_fast_for(
                    row.shape[1], start_iteration, num_iteration, raw_score)
                if fast is not None:
                    out = fast.predict(row[0])
                    # the batch path's shapes: [1], or [1, K] multiclass
                    return out[None, :] if len(out) > 1 else out[:1]
        if sparse and data.shape[0] > 0:
            csr = data.tocsr()
            chunk = max(1, SPARSE_CHUNK_BYTES // max(8 * data.shape[1], 1))
            return np.concatenate([
                self._gbdt.predict(
                    _coerce_matrix(csr[i:i + chunk]), raw_score=raw_score,
                    start_iteration=start_iteration,
                    num_iteration=num_iteration, pred_leaf=pred_leaf, **es)
                for i in range(0, data.shape[0], chunk)], axis=0)
        return self._gbdt.predict(
            _coerce_matrix(data), raw_score=raw_score,
            start_iteration=start_iteration, num_iteration=num_iteration,
            pred_leaf=pred_leaf, **es)

    def num_feature(self) -> int:
        """Features the model was trained on (ref: basic.py
        Booster.num_feature)."""
        g = self._gbdt
        if g.train_data is not None:
            return g.train_data.num_total_features
        return g._loaded_max_feature_idx + 1

    def _single_row_fast_for(self, num_features, start_iteration,
                             num_iteration, raw_score):
        """Cached fast single-row predictors by (row width, slice, raw),
        dropped when the model changes: more trees or an in-place
        mutation (ref: the FastConfig handle of c_api.h:1350)."""
        g = self._gbdt
        model_key = (len(g.models_), g._model_mutations)
        cache = getattr(self, "_srf_cache", None)
        if cache is None or cache["model_key"] != model_key:
            cache = self._srf_cache = {"model_key": model_key}
        key = (num_features, start_iteration, num_iteration, raw_score)
        if key not in cache:
            cache[key] = g.make_single_row_fast(
                num_features, start_iteration=start_iteration,
                num_iteration=num_iteration, raw_score=raw_score)
        return cache[key]

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
