"""scikit-learn estimator API (the PyTorch port's copy of
`lightgbm_tpu/sklearn.py`; ref: python-package/lightgbm/sklearn.py:
LGBMModel/LGBMRegressor/LGBMClassifier/LGBMRanker).

The estimators train and predict through the port's `train` and
`Booster`, so they run on the card unless `device_type="cpu"` is passed
(as an estimator keyword, like any LightGBM parameter).  Without
scikit-learn they keep their API on `object` bases.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train as train_api
from .utils import log

try:
    from sklearn.base import BaseEstimator as _SKBase
    from sklearn.base import ClassifierMixin as _SKClassifier
    from sklearn.base import RegressorMixin as _SKRegressor
    _HAS_SKLEARN = True
except ImportError:  # the estimators keep their API without sklearn
    _SKBase = object

    # stand-ins for the mixins: `object` itself ahead of LGBMModel in the
    # bases would have no consistent method resolution order
    class _SKClassifier:
        pass

    class _SKRegressor:
        pass
    _HAS_SKLEARN = False


class LGBMModel(_SKBase):
    """Base estimator (ref: sklearn.py LGBMModel)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None, importance_type: str = "split",
                 **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None

    # ------------------------------------------------------------ sklearn API
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = (super().get_params(deep=deep) if _HAS_SKLEARN
                  else {k: getattr(self, k) for k in (
                      "boosting_type", "num_leaves", "max_depth",
                      "learning_rate", "n_estimators", "subsample_for_bin",
                      "objective", "class_weight", "min_split_gain",
                      "min_child_weight", "min_child_samples", "subsample",
                      "subsample_freq", "colsample_bytree", "reg_alpha",
                      "reg_lambda", "random_state", "n_jobs",
                      "importance_type")})
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self.__init__.__code__.co_varnames:
                self._other_params[k] = v
        return self

    # --------------------------------------------------------------- mapping
    def _lgb_params(self) -> Dict[str, Any]:
        """Translate sklearn names to native params (ref: sklearn.py
        LGBMModel._process_params alias mapping)."""
        params = dict(
            boosting=self.boosting_type,
            num_leaves=self.num_leaves,
            max_depth=self.max_depth,
            learning_rate=self.learning_rate,
            bin_construct_sample_cnt=self.subsample_for_bin,
            min_gain_to_split=self.min_split_gain,
            min_sum_hessian_in_leaf=self.min_child_weight,
            min_data_in_leaf=self.min_child_samples,
            bagging_fraction=self.subsample,
            bagging_freq=(self.subsample_freq if self.subsample < 1.0
                          and self.subsample_freq > 0
                          else (1 if self.subsample < 1.0 else 0)),
            feature_fraction=self.colsample_bytree,
            lambda_l1=self.reg_alpha,
            lambda_l2=self.reg_lambda,
            verbosity=-1,
        )
        if self.objective is not None:
            params["objective"] = self.objective
        if self.random_state is not None:
            params["seed"] = int(self.random_state) if not hasattr(
                self.random_state, "randint") else int(
                self.random_state.randint(0, 2 ** 31))
        params.update(self._other_params)
        params.pop("n_estimators", None)
        return params

    # ------------------------------------------------------------------- fit
    def _fit(self, X, y, sample_weight=None, group=None, eval_set=None,
             eval_names=None, eval_sample_weight=None, eval_group=None,
             callbacks: Optional[List[Callable]] = None,
             categorical_feature="auto", init_score=None,
             eval_init_score=None, eval_metric=None,
             feature_name="auto") -> "LGBMModel":
        if hasattr(X, "columns"):
            self._feature_names_in = list(map(str, X.columns))
            if feature_name == "auto":
                feature_name = self._feature_names_in
        else:
            self._feature_names_in = None
        X = X.values if hasattr(X, "values") else np.asarray(X)
        y = np.asarray(y, dtype=np.float64).ravel()
        params = self._lgb_params()
        feval = None
        if eval_metric is not None:
            # ref: sklearn.py fit: string metrics merge with the params
            # metric; callables become custom feval functions
            ems = (eval_metric if isinstance(eval_metric, (list, tuple))
                   else [eval_metric])
            names = [m for m in ems if isinstance(m, str)]
            fevals = [m for m in ems if callable(m)]
            if names:
                base = params.get("metric", [])
                if isinstance(base, str):
                    base = [b for b in base.split(",") if b]
                params["metric"] = list(base) + [m for m in names
                                                 if m not in base]
            if fevals:
                if len(fevals) == 1:
                    feval = fevals[0]
                else:
                    def feval(preds, ds, _fs=tuple(fevals)):
                        out = []
                        for f in _fs:
                            r = f(preds, ds)
                            out.extend(r if isinstance(r, list) else [r])
                        return out
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets, valid_names = [], []
        if eval_set:
            for i, (vX, vy) in enumerate(eval_set):
                vX = vX.values if hasattr(vX, "values") else np.asarray(vX)
                vw = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                vg = eval_group[i] if eval_group is not None else None
                vi = (eval_init_score[i]
                      if eval_init_score is not None else None)
                vy_arr = np.asarray(vy, np.float64).ravel()
                # identical ndarray OR the same view (same start address,
                # shape, and strides — shares_memory alone also matches
                # overlapping/rearranged views, which are NOT the train set)
                same_data = vX is X or (
                    vX.shape == X.shape
                    and vX.strides == X.strides
                    and vX.__array_interface__["data"][0]
                    == X.__array_interface__["data"][0])
                if (same_data and np.array_equal(vy_arr, y)
                        and vw is None and vi is None and vg is None):
                    # the eval set IS the train set (data, labels, and no
                    # overriding weight/init/group)
                    valid_sets.append(train_set)
                else:
                    valid_sets.append(Dataset(
                        vX, label=vy_arr,
                        weight=vw, group=vg, init_score=vi,
                        reference=train_set))
                valid_names.append(eval_names[i] if eval_names else
                                   f"valid_{i}")
        self._evals_result = {}
        cbs = list(callbacks or [])
        if valid_sets:
            from .callback import record_evaluation
            cbs.append(record_evaluation(self._evals_result))
        self._Booster = train_api(params, train_set,
                                  num_boost_round=self.n_estimators,
                                  valid_sets=valid_sets or None,
                                  valid_names=valid_names or None,
                                  feval=feval, callbacks=cbs or None)
        self._n_features = X.shape[1]
        self.fitted_ = True
        return self

    fit = _fit

    # --------------------------------------------------------------- predict
    def _check_fitted(self):
        if self._Booster is None:
            raise ValueError(
                "Estimator not fitted; call fit before predict")

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        self._check_fitted()
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    # ------------------------------------------------------------ attributes
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    n_features_in_ = n_features_

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._Booster.best_iteration

    @property
    def best_score_(self):
        self._check_fitted()
        return self._Booster.best_score

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def evals_result_(self):
        self._check_fitted()
        return self._evals_result

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()

    @property
    def feature_names_in_(self):
        """sklearn-style input feature names (pandas columns)."""
        self._check_fitted()
        if self._feature_names_in is None:
            raise AttributeError(
                "feature_names_in_ is defined only when X has column names")
        return np.asarray(self._feature_names_in, dtype=object)

    @property
    def n_estimators_(self) -> int:
        """Actual number of fitted iterations (<= n_estimators when early
        stopping fires; ref: sklearn.py n_estimators_)."""
        self._check_fitted()
        bi = self._Booster.best_iteration
        return bi if bi > 0 else self._Booster.current_iteration()

    n_iter_ = n_estimators_

    @property
    def objective_(self) -> str:
        self._check_fitted()
        return self.objective


class LGBMRegressor(_SKRegressor, LGBMModel):
    """ref: sklearn.py LGBMRegressor."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, callbacks=None,
            feature_name="auto", categorical_feature="auto"):
        if self.objective is None:
            self.objective = "regression"
        return self._fit(X, y, sample_weight=sample_weight,
                         init_score=init_score, eval_set=eval_set,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_init_score=eval_init_score,
                         eval_metric=eval_metric, callbacks=callbacks,
                         feature_name=feature_name,
                         categorical_feature=categorical_feature)


class LGBMClassifier(_SKClassifier, LGBMModel):
    """ref: sklearn.py LGBMClassifier."""

    def fit(self, X, y, sample_weight=None, init_score=None, eval_set=None,
            eval_names=None, eval_sample_weight=None, eval_init_score=None,
            eval_metric=None, callbacks=None,
            feature_name="auto", categorical_feature="auto"):
        y = np.asarray(y).ravel()
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        if self.objective is None:
            self.objective = ("binary" if self.n_classes_ <= 2
                              else "multiclass")
        if self.n_classes_ > 2:
            self._other_params.setdefault("num_class", self.n_classes_)
        enc_eval = None
        if eval_set:
            enc_eval = []
            lut = {c: i for i, c in enumerate(self.classes_)}
            for vX, vy in eval_set:
                vy = np.asarray([lut[v] for v in np.asarray(vy).ravel()])
                enc_eval.append((vX, vy))
        return self._fit(X, y_enc.astype(np.float64),
                         sample_weight=sample_weight,
                         init_score=init_score, eval_set=enc_eval,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_init_score=eval_init_score,
                         eval_metric=eval_metric, callbacks=callbacks,
                         feature_name=feature_name,
                         categorical_feature=categorical_feature)

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: int = -1, **kwargs) -> np.ndarray:
        self._check_fitted()
        result = self._Booster.predict(X, raw_score=raw_score,
                                       num_iteration=num_iteration)
        if result.ndim == 1:  # binary: [P(y=0), P(y=1)]
            return np.vstack([1.0 - result, result]).T
        return result

    def predict(self, X, raw_score: bool = False, num_iteration: int = -1,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        if raw_score or pred_leaf or pred_contrib:
            return super().predict(X, raw_score=raw_score,
                                   num_iteration=num_iteration,
                                   pred_leaf=pred_leaf,
                                   pred_contrib=pred_contrib)
        proba = self.predict_proba(X, num_iteration=num_iteration)
        return self.classes_[np.argmax(proba, axis=1)]


class LGBMRanker(LGBMModel):
    """ref: sklearn.py LGBMRanker (lambdarank by default; `group` and
    `eval_group` are query sizes)."""

    def fit(self, X, y, group, sample_weight=None, init_score=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            eval_at=(1, 2, 3, 4, 5), callbacks=None,
            feature_name="auto", categorical_feature="auto"):
        if self.objective is None:
            self.objective = "lambdarank"
        self._other_params.setdefault(
            "eval_at", ",".join(str(a) for a in eval_at))
        return self._fit(X, y, sample_weight=sample_weight, group=group,
                         init_score=init_score, eval_set=eval_set,
                         eval_names=eval_names,
                         eval_sample_weight=eval_sample_weight,
                         eval_init_score=eval_init_score,
                         eval_group=eval_group, eval_metric=eval_metric,
                         callbacks=callbacks, feature_name=feature_name,
                         categorical_feature=categorical_feature)
