"""User-facing Dataset and Booster (PyTorch port of
`lightgbm_tpu/basic.py`; ref: python-package/lightgbm/basic.py)."""

from __future__ import annotations

import abc
import os
from typing import Any, Dict, List, Optional
from typing import Sequence as _TSeq

import numpy as np

from .boosting import create_boosting
from .boosting.model_io import (load_model_from_file, load_model_from_string,
                                save_model_to_file, save_model_to_string)
from .config import Config
from .io.dataset import Dataset as _CoreDataset
from .io.dataset import Metadata, load_dataset_from_file
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


class Sequence(abc.ABC):
    """Batched random-access input for Dataset construction (ref:
    python-package basic.py Sequence): `len(seq)`, integer and slice
    indexing, and an optional `batch_size`.  A Dataset takes a Sequence
    (or a list of them, concatenated by rows) and reads it in batches;
    under `two_round` it reads them twice and the whole float matrix
    never exists."""

    batch_size = 4096

    @abc.abstractmethod
    def __getitem__(self, idx):
        raise NotImplementedError

    @abc.abstractmethod
    def __len__(self) -> int:
        raise NotImplementedError


def _sequence_batches(seqs):
    """(rows [c, F] float64, None) batches of Sequences, in order."""
    for seq in seqs:
        n = len(seq)
        bs = max(1, int(getattr(seq, "batch_size", 4096) or 4096))
        for lo in range(0, n, bs):
            chunk = np.asarray(seq[lo:min(lo + bs, n)], dtype=np.float64)
            yield chunk.reshape(chunk.shape[0], -1), None


def _as_sequences(data):
    """The Sequences `data` is (one, or a non-empty list), else None."""
    if isinstance(data, Sequence):
        return [data]
    if (isinstance(data, list) and data
            and all(isinstance(s, Sequence) for s in data)):
        return data
    return None


class Dataset:
    """Lazily-constructed training dataset (ref: basic.py:1555 Dataset):
    from an array, a pandas frame, a scipy sparse matrix, a Sequence (or
    a list of them), or the path of a text or binary file.  `group`
    (query sizes) and `position` reach the ranking objectives."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self.position = position
        self.used_indices: Optional[np.ndarray] = None
        self._core: Optional[_CoreDataset] = None

    def construct(self) -> "Dataset":
        if self._core is not None:
            return self
        cfg = Config(self.params)
        ref_core = (self.reference._core_or_construct()
                    if self.reference is not None else None)
        if isinstance(self.data, (str, bytes, os.PathLike)):
            # a text file with its side files, or a binary file (the
            # path is kept: there is no raw matrix to free)
            self._core = load_dataset_from_file(os.fsdecode(self.data), cfg,
                                                reference=ref_core)
            md = self._core.metadata
            for value, setter in ((self.label, md.set_label),
                                  (self.weight, md.set_weight),
                                  (self.group, md.set_group),
                                  (self.init_score, md.set_init_score),
                                  (self.position, md.set_position)):
                if value is not None:
                    setter(value)
            return self
        data = self.data
        seqs = _as_sequences(data)
        if seqs is not None and cfg.two_round:
            return self._construct_from_sequences(seqs, cfg, ref_core)
        if seqs is not None:
            parts = [rows for rows, _ in _sequence_batches(seqs)]
            if not parts:
                log.fatal("Cannot construct a Dataset from empty Sequence "
                          "input")
            data = np.concatenate(parts, axis=0)
        if self.feature_name == "auto" and hasattr(data, "columns"):
            self.feature_name = list(map(str, data.columns))
        cat = self._categorical_indices()
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        if is_scipy_sparse(data) and not cfg.linear_tree:
            # scipy CSR/CSC/COO go CSC-direct to EFB bundle codes: the
            # dense [n, F] matrix is never made (io/sparse.py); a valid
            # set against a sparse reference reuses its plan
            self._core = construct_from_sparse(
                data, label=self.label, weight=self.weight,
                group=self.group, init_score=self.init_score,
                max_bin=cfg.max_bin,
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
        else:
            data = _coerce_matrix(data)
            if ref_core is not None:
                self._core = ref_core.create_valid(
                    data, label=self.label, weight=self.weight,
                    group=self.group, init_score=self.init_score,
                    keep_raw_data=cfg.linear_tree)
            else:
                self._core = _CoreDataset.construct_from_arrays(
                    data, label=self.label, weight=self.weight,
                    group=self.group, init_score=self.init_score,
                    max_bin=cfg.max_bin,
                    min_data_in_bin=cfg.min_data_in_bin,
                    min_data_in_leaf=cfg.min_data_in_leaf,
                    bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
                    categorical_feature=cat, feature_names=names,
                    use_missing=cfg.use_missing,
                    zero_as_missing=cfg.zero_as_missing,
                    feature_pre_filter=cfg.feature_pre_filter,
                    seed=cfg.data_random_seed,
                    keep_raw_data=cfg.linear_tree,
                    max_bin_by_feature=cfg.max_bin_by_feature or None,
                    forcedbins_filename=cfg.forcedbins_filename,
                    device_type=cfg.device_type)
        if self.position is not None:
            self._core.metadata.set_position(self.position)
        if self.free_raw_data:
            self.data = None
        return self

    def _categorical_indices(self) -> List[int]:
        """categorical_feature as column indices (names resolve against
        feature_name)."""
        cat = []
        if self.categorical_feature not in ("auto", None):
            for c in self.categorical_feature:
                if isinstance(c, str) and self.feature_name != "auto":
                    cat.append(list(self.feature_name).index(c))
                else:
                    cat.append(int(c))
        return cat

    def _construct_from_sequences(self, seqs, cfg, ref_core) -> "Dataset":
        """Two-round Sequence ingestion: the batches are read twice and
        binned straight into codes (`construct_from_stream`; ref: the
        streaming push of c_api.h:177-323 LGBM_DatasetPushRows)."""
        if cfg.linear_tree:
            # linear leaves need the raw values two_round does not hold
            log.fatal("Cannot use two_round loading with linear tree")
        names = (None if self.feature_name == "auto"
                 else list(self.feature_name))
        self._core = _CoreDataset.construct_from_stream(
            lambda: _sequence_batches(seqs), weight=self.weight,
            group=self.group, max_bin=cfg.max_bin,
            min_data_in_bin=cfg.min_data_in_bin,
            min_data_in_leaf=cfg.min_data_in_leaf,
            bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
            categorical_feature=self._categorical_indices(),
            feature_names=names, use_missing=cfg.use_missing,
            zero_as_missing=cfg.zero_as_missing,
            feature_pre_filter=cfg.feature_pre_filter,
            seed=cfg.data_random_seed,
            max_bin_by_feature=cfg.max_bin_by_feature or None,
            forcedbins_filename=cfg.forcedbins_filename,
            reference=ref_core, device_type=cfg.device_type)
        md = self._core.metadata
        for value, setter in ((self.label, md.set_label),
                              (self.init_score, md.set_init_score),
                              (self.position, md.set_position)):
            if value is not None:
                setter(value)
        if self.free_raw_data:
            self.data = None
        return self

    def _core_or_construct(self) -> _CoreDataset:
        self.construct()
        return self._core

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def subset(self, used_indices: _TSeq[int], params=None) -> "Dataset":
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

    def save_binary(self, filename: str) -> "Dataset":
        """The binned Dataset as a binary file that `Dataset(filename)`
        loads (ref: basic.py save_binary; the JAX package's `.npz`
        layout: NumPy appends `.npz` to the name)."""
        self._core_or_construct().save_binary(os.fsdecode(filename))
        return self

    # ------------------------------------------------------------------
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._core is not None:
            self._core.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._core is not None:
            self._core.metadata.set_weight(weight)
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._core is not None:
            self._core.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._core is not None:
            self._core.metadata.set_init_score(init_score)
        return self

    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._core is not None and position is not None:
            self._core.metadata.set_position(position)
        return self

    def get_label(self):
        return (self._core.metadata.label if self._core is not None
                else self.label)

    def get_weight(self):
        return (self._core.metadata.weight if self._core is not None
                else self.weight)

    def get_group(self):
        """Query sizes (ref: basic.py get_group)."""
        if (self._core is not None
                and self._core.metadata.query_boundaries is not None):
            return np.diff(self._core.metadata.query_boundaries)
        return self.group

    def get_init_score(self):
        return (self._core.metadata.init_score
                if self._core is not None else self.init_score)

    def get_position(self):
        return (self._core.metadata.position
                if self._core is not None else self.position)

    def get_data(self):
        """Raw data (ref: basic.py get_data; raises after the raw data was
        freed, with the reference's error).  A subset gives its own
        rows."""
        if self._core is not None and self.data is None:
            log.fatal("Cannot call `get_data` after freed raw data, set "
                      "free_raw_data=False when construct Dataset to avoid "
                      "this.")
        if self.used_indices is not None and self.data is not None:
            return _coerce_matrix(self.data)[self.used_indices]
        return self.data

    def _fields(self):
        return {"label": (self.get_label, self.set_label),
                "weight": (self.get_weight, self.set_weight),
                "group": (self.get_group, self.set_group),
                "init_score": (self.get_init_score, self.set_init_score),
                "position": (self.get_position, self.set_position)}

    def get_field(self, field_name: str):
        """ref: basic.py get_field / LGBM_DatasetGetField."""
        if field_name not in self._fields():
            log.fatal(f"Unknown field name: {field_name}")
        return self._fields()[field_name][0]()

    def set_field(self, field_name: str, data) -> "Dataset":
        """ref: basic.py set_field / LGBM_DatasetSetField."""
        if field_name not in self._fields():
            log.fatal(f"Unknown field name: {field_name}")
        return self._fields()[field_name][1](data)

    def get_feature_name(self) -> List[str]:
        return self.feature_names()

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name != "auto":
            names = list(feature_name)
            if (self._core is not None
                    and len(names) != self._core.num_total_features):
                log.fatal("Length of feature_name error")
            self.feature_name = names
            if self._core is not None:
                self._core.feature_names = list(map(str, names))
        return self

    def _check_mutable(self, what: str) -> None:
        """A change that re-bins: refused on a subset, and once the raw
        data was freed (ref: basic.py set_categorical_feature,
        set_reference)."""
        if self.used_indices is not None:
            log.fatal("Cannot modify a Dataset returned by subset(); "
                      "apply the change to the parent Dataset instead")
        if self._core is not None and self.data is None:
            log.fatal(f"Cannot set {what} after freed raw data, set "
                      "free_raw_data=False when construct Dataset to "
                      "avoid this.")

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """ref: basic.py set_categorical_feature: re-bins while the raw
        data is kept."""
        if self.categorical_feature == categorical_feature:
            return self
        self._check_mutable("categorical feature")
        if self._core is not None:
            log.warning("categorical_feature in Dataset is overridden.\n"
                        f"New categorical_feature is {categorical_feature}")
            self._core = None
        self.categorical_feature = categorical_feature
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """ref: basic.py set_reference: re-bins against the new
        reference while the raw data is kept."""
        if reference is self.reference:
            return self
        self._check_mutable("reference")
        self._core = None
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100):
        """The set of Datasets reachable through reference links; a cycle
        ends the walk (ref: basic.py get_ref_chain)."""
        head = self
        ref_chain = set()
        while len(ref_chain) < ref_limit and isinstance(head, Dataset):
            ref_chain.add(head)
            if head.reference is None or head.reference in ref_chain:
                break
            head = head.reference
        return ref_chain

    def feature_num_bin(self, feature) -> int:
        """Number of bins of a feature, by index or name (ref: basic.py
        feature_num_bin / LGBM_DatasetGetFeatureNumBin)."""
        core = self._core_or_construct()
        if isinstance(feature, str):
            feature = core.feature_names.index(feature)
        return int(core.bin_mappers[feature].num_bin)

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Column-concatenate another Dataset's features into this one
        (ref: basic.py add_features_from / LGBM_DatasetAddFeaturesFrom).
        Both must still hold raw data; scipy input is densified, as in
        the JAX package, and the merged Dataset re-bins."""
        if self.used_indices is not None or other.used_indices is not None:
            log.fatal("Cannot add features to/from a Dataset returned by "
                      "subset()")
        for ds, tag in ((self, "self"), (other, "other")):
            if ds.data is None:
                log.fatal(f"Cannot add features from {tag} with freed raw "
                          "data (set free_raw_data=False)")
        a = _coerce_matrix(self.data)
        b = _coerce_matrix(other.data)
        if a.shape[0] != b.shape[0]:
            log.fatal("Cannot add features from a Dataset with a different "
                      "row count")
        self.data = np.hstack([a, b])
        if self.feature_name != "auto" and other.feature_name != "auto":
            self.feature_name = (list(self.feature_name)
                                 + list(other.feature_name))
        else:
            self.feature_name = "auto"

        def _cats(ds, offset):
            cf = ds.categorical_feature
            if cf in ("auto", None):
                return []
            out = []
            for c in cf:
                if isinstance(c, str):
                    if ds.feature_name == "auto":
                        log.fatal("Cannot merge a name-based "
                                  "categorical_feature without feature "
                                  "names")
                    c = list(ds.feature_name).index(c)
                out.append(int(c) + offset)
            return out
        if not (self.categorical_feature in ("auto", None)
                and other.categorical_feature in ("auto", None)):
            self.categorical_feature = (_cats(self, 0)
                                        + _cats(other, a.shape[1]))
        self.reference = None  # widened columns cannot share old mappers
        self._core = None      # re-bin on the next construct
        return self

    def num_data(self) -> int:
        return self._core_or_construct().num_data

    def num_feature(self) -> int:
        return self._core_or_construct().num_total_features

    def feature_names(self) -> List[str]:
        return self._core_or_construct().feature_names


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
            self._gbdt = self._load_gbdt(model_file, model_str)
        else:
            log.fatal("Booster needs train_set, model_file or model_str")

    def _load_gbdt(self, model_file: Optional[str] = None,
                   model_str: Optional[str] = None):
        """A predictor-mode GBDT from model text.  The text gives every
        setting but where to predict: device_type and device_predict come
        from `self.params`, with the training defaults (cuda, auto), so
        a loaded model never lands on the CPU unasked."""
        g = (load_model_from_file(model_file) if model_file is not None
             else load_model_from_string(model_str))
        prev_verbosity = log.get_verbosity()
        cfg = Config(self.params)
        if "verbosity" not in cfg.raw_params:
            # Config sets the process-wide log level as a side effect
            log.set_verbosity(prev_verbosity)
        g.config.device_type = cfg.device_type
        g.config.device_predict = cfg.device_predict
        g.device = resolve_device(cfg.device_type)
        return g

    def __getstate__(self):
        """Pickle through the model text (ref: basic.py
        Booster.__getstate__): the live GBDT holds tensors, objective
        closures and native predictor handles."""
        state = self.__dict__.copy()
        for key in ("_train_set", "_valid_wrappers", "_srf_cache"):
            state.pop(key, None)
        g = state.pop("_gbdt", None)
        state["_model_str"] = (save_model_to_string(g)
                               if g is not None else None)
        return state

    def __setstate__(self, state):
        """Restore in predictor mode, on the device that the pickled
        `params` name (the card by default): no training or valid
        sets."""
        state = dict(state)
        model_str = state.pop("_model_str", None)
        self.__dict__.update(state)
        self._train_set = None
        self.name_valid_sets = []
        self._valid_wrappers = []
        self._gbdt = (self._load_gbdt(model_str=model_str)
                      if model_str is not None else None)

    def model_from_string(self, model_str: str) -> "Booster":
        """Replace this booster's model (ref: basic.py model_from_string),
        on the device that `params` name."""
        self._gbdt = self._load_gbdt(model_str=model_str)
        self._train_set = None
        self.name_valid_sets = []
        self._valid_wrappers = []
        self.best_iteration = -1
        self.best_score = {}
        return self

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
        sc = g.train_scores().cpu().numpy()
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
        """Predictions, leaf ids (`pred_leaf`), early-stopped scores or
        SHAP contributions (`pred_contrib`, on the host).
        On a card booster with `device_predict=auto` (the default) they
        are computed on the card; float32 input passes through unchanged,
        which is what the device routing needs to be exact.  scipy
        sparse input is densified in row chunks of about 64 MB, never as
        a whole.  `single_row_fast` serves one row through the cached
        native single-row predictor (ref: c_api.h:1350
        LGBM_BoosterPredictForMatSingleRowFastInit)."""
        if num_iteration is None or (num_iteration == -1
                                     and self.best_iteration > 0):
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        es = dict(pred_early_stop=pred_early_stop,
                  pred_early_stop_freq=pred_early_stop_freq,
                  pred_early_stop_margin=pred_early_stop_margin)
        sparse = is_scipy_sparse(data)
        if pred_contrib:
            return self._predict_contrib(data, sparse, start_iteration,
                                         num_iteration)
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

    def _predict_contrib(self, data, sparse: bool, start_iteration: int,
                         num_iteration: int):
        """SHAP contributions on the host (TreeSHAP): dense input gives
        [n, K·(F + 1)]; scipy sparse input gives CSR, made in row chunks
        of about 64 MB of dense features (ref: the Python package returns
        sparse contributions for sparse input; basic.py:903-936 of the JAX
        package)."""
        g = self._gbdt
        if not sparse:
            return g.predict_contrib(_coerce_matrix(data), start_iteration,
                                     num_iteration)
        from scipy import sparse as sps
        if data.shape[0] == 0:
            return sps.csr_matrix(
                (0, (data.shape[1] + 1) * g.num_tree_per_iteration))
        csr = data.tocsr()
        chunk = max(1, SPARSE_CHUNK_BYTES // max(8 * data.shape[1], 1))
        return sps.vstack([sps.csr_matrix(g.predict_contrib(
            _coerce_matrix(csr[i:i + chunk]), start_iteration,
            num_iteration)) for i in range(0, data.shape[0], chunk)],
            format="csr")

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

    def feature_importance(self, importance_type: str = "split",
                           iteration=None) -> np.ndarray:
        """Split counts or gains per feature.  `iteration` is taken and
        ignored, as the JAX package does (ROADMAP "Divergences")."""
        return self._gbdt.feature_importance(importance_type)

    def feature_name(self) -> List[str]:
        g = self._gbdt
        if g.train_data is not None:
            return g.train_data.feature_names
        return g._loaded_feature_names

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    # ------------------------------------------------- the model's trees
    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        """ref: basic.py get_leaf_output / LGBM_BoosterGetLeafValue."""
        return float(self._gbdt.models_[tree_id].leaf_value[leaf_id])

    def set_leaf_output(self, tree_id: int, leaf_id: int,
                        value: float) -> "Booster":
        """ref: basic.py set_leaf_output / LGBM_BoosterSetLeafValue.  The
        packed and device predictors are rebuilt at the next predict."""
        g = self._gbdt
        g.models_[tree_id].set_leaf_output(leaf_id, float(value))
        g._bump_model_mutations()
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Shuffle the order of the iterations [start, end) with
        RandomState(seed) (ref: gbdt.h:114 ShuffleModels)."""
        g = self._gbdt
        K = g.num_tree_per_iteration
        total = len(g.models_) // max(K, 1)
        end = total if end_iteration < 0 else min(end_iteration, total)
        idx = np.arange(start_iteration, end)
        np.random.RandomState(g.config.seed).shuffle(idx)
        blocks = [g.models_[i * K:(i + 1) * K] for i in range(total)]
        reordered = (blocks[:start_iteration] + [blocks[i] for i in idx]
                     + blocks[end:])
        g.models_ = [t for b in reordered for t in b]
        g._bump_model_mutations()
        return self

    def get_split_value_histogram(self, feature, bins=None,
                                  xgboost_style: bool = False):
        """Histogram of a feature's numerical split thresholds over the
        model (ref: basic.py get_split_value_histogram)."""
        if isinstance(feature, str):
            feature = self.feature_name().index(feature)
        values = []
        for tree in self._gbdt.models_:
            for i in range(max(tree.num_leaves - 1, 0)):
                if (tree.split_feature[i] == feature
                        and tree.decision_type[i] & 1 == 0):
                    values.append(float(tree.threshold[i]))
        values = np.asarray(values, np.float64)
        n_unique = len(np.unique(values))
        if bins is None or (isinstance(bins, int)
                            and bins > max(n_unique, 1)):
            bins = max(n_unique, 1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            return ret[ret[:, 1] > 0]
        return hist, bin_edges

    def lower_bound(self) -> float:
        """Least possible raw prediction (ref: gbdt.h
        GetLowerBoundValue)."""
        return float(sum(t.leaf_value[:t.num_leaves].min()
                         for t in self._gbdt.models_))

    def upper_bound(self) -> float:
        """Greatest possible raw prediction (ref: gbdt.h
        GetUpperBoundValue)."""
        return float(sum(t.leaf_value[:t.num_leaves].max()
                         for t in self._gbdt.models_))

    def dump_model(self, num_iteration: int = None,
                   start_iteration: int = 0) -> dict:
        """JSON model dump (ref: basic.py dump_model; gbdt_model_text.cpp
        DumpModel).  As in the JAX package, a booster loaded from text
        has no training data here, so its dump says max_feature_idx 0
        and no feature names (ROADMAP "Divergences")."""
        g = self._gbdt
        K = g.num_tree_per_iteration
        total_iters = len(g.models_) // max(K, 1)
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else -1)
        if num_iteration < 0:
            num_iteration = total_iters - start_iteration
        end = min(start_iteration + num_iteration, total_iters)
        ds = g.train_data
        return {
            "name": "tree",
            "version": "v4",
            "num_class": g.config.num_class,
            "num_tree_per_iteration": K,
            "label_index": 0,
            "max_feature_idx": (ds.num_total_features - 1
                                if ds is not None else 0),
            "objective": g.config.objective,
            "feature_names": (ds.feature_names if ds is not None else []),
            "tree_info": [g.models_[it * K + k].to_json(it * K + k)
                          for it in range(start_iteration, end)
                          for k in range(K)],
        }

    def trees_to_dataframe(self):
        """The trees' nodes as a pandas DataFrame (ref: basic.py
        trees_to_dataframe)."""
        import pandas as pd
        g = self._gbdt
        names = (g.train_data.feature_names if g.train_data is not None
                 else None)
        rows = []
        for ti, tree in enumerate(g.models_):
            nl = tree.num_leaves
            for i in range(max(nl - 1, 0)):
                f = int(tree.split_feature[i])
                is_cat = bool(tree.decision_type[i] & 1)
                rows.append(dict(
                    tree_index=ti, node_depth=None,
                    node_index=f"{ti}-S{i}",
                    split_feature=(names[f] if names and f < len(names)
                                   else f"Column_{f}"),
                    split_gain=float(tree.split_gain[i]),
                    threshold=("||".join(str(c)
                                         for c in tree._cats_of_node(i))
                               if is_cat else float(tree.threshold[i])),
                    decision_type="==" if is_cat else "<=",
                    left_child=int(tree.left_child[i]),
                    right_child=int(tree.right_child[i]),
                    value=float(tree.internal_value[i]),
                    weight=float(tree.internal_weight[i]),
                    count=int(tree.internal_count[i])))
            for leaf in range(nl):
                rows.append(dict(
                    tree_index=ti, node_depth=int(tree.leaf_depth[leaf]),
                    node_index=f"{ti}-L{leaf}", split_feature=None,
                    split_gain=None, threshold=None, decision_type=None,
                    left_child=None, right_child=None,
                    value=float(tree.leaf_value[leaf]),
                    weight=float(tree.leaf_weight[leaf]),
                    count=int(tree.leaf_count[leaf])))
        return pd.DataFrame(rows)

    def model_to_if_else(self) -> str:
        """Standalone C++ if-else predictor source (ref:
        gbdt_model_text.cpp SaveModelToIfElse)."""
        trees = self._gbdt.models_
        out = ["#include <cmath>", "", "namespace lightgbm_tpu {", ""]
        for i, tree in enumerate(trees):
            out.append(f"double PredictTree{i}(const double* row) {{")

            def emit(node, indent):
                pad = "  " * indent
                if node < 0:
                    out.append(f"{pad}return {tree.leaf_value[~node]!r};")
                    return
                f = int(tree.split_feature[node])
                thr = float(tree.threshold[node])
                dt = int(tree.decision_type[node])
                default_left = str(bool(dt & 2)).lower()
                miss = "std::isnan(row[%d])" % f
                if dt & 1:  # categorical membership
                    cat = int(tree.threshold[node])
                    s, e = (tree.cat_boundaries[cat],
                            tree.cat_boundaries[cat + 1])
                    words = ",".join(str(int(w))
                                     for w in tree.cat_threshold[s:e])
                    cond = (f"[&]{{ if ({miss} || row[{f}] < 0) return false;"
                            f" unsigned v = (unsigned)row[{f}];"
                            f" unsigned bits[] = {{{words}}};"
                            f" return v/32 < {e - s}u &&"
                            f" ((bits[v/32] >> (v%32)) & 1u); }}()")
                else:
                    base = f"row[{f}] <= {thr!r}"
                    mt = (dt >> 2) & 3
                    if mt == 2:  # nan
                        cond = f"({miss} ? {default_left} : ({base}))"
                    elif mt == 1:  # zero
                        cond = (f"((std::fabs(row[{f}]) <= 1e-35)"
                                f" ? {default_left} : ({base}))")
                    else:
                        cond = base
                out.append(f"{pad}if ({cond}) {{")
                emit(int(tree.left_child[node]), indent + 1)
                out.append(f"{pad}}} else {{")
                emit(int(tree.right_child[node]), indent + 1)
                out.append(f"{pad}}}")

            if tree.num_leaves <= 1:
                out.append(f"  return {tree.leaf_value[0]!r};")
            else:
                emit(0, 1)
            out.extend(["}", ""])
        out.append("double Predict(const double* row) {")
        out.append("  double sum = 0.0;")
        for i in range(len(trees)):
            out.append(f"  sum += PredictTree{i}(row);")
        if self._gbdt.average_output_ and trees:
            out.append(f"  sum /= {len(trees)}.0;")
        out.extend(["  return sum;", "}", "", "}  // namespace lightgbm_tpu"])
        return "\n".join(out)

    # ---------------------------------------------------------- bookkeeping
    def free_dataset(self) -> "Booster":
        """Drop the training Dataset (ref: basic.py free_dataset)."""
        self._train_set = None
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def refit(self, data, label, weight=None, **kwargs) -> "Booster":
        """Refit the leaf values of the existing trees to new data, in
        place, and return this booster (ref: basic.py Booster.refit ->
        LGBM_BoosterRefit; gbdt.cpp:252 RefitTree)."""
        self._gbdt.refit(_coerce_matrix(data),
                         np.asarray(label, np.float64), weight=weight)
        return self

    def free_network(self) -> "Booster":
        """No socket network to tear down: the collectives ride the
        torch.distributed process group, which `join_cluster` forms and
        the process owns (ref: basic.py free_network; the JAX package's
        Booster.free_network)."""
        self.network = False
        return self

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120,
                    num_machines: int = 1) -> "Booster":
        """Accepted for API compatibility, as in the JAX package: a
        cluster is joined through `distributed.join_cluster` (or the
        CLI's `machines=`) before training with tree_learner=data (ref:
        basic.py set_network)."""
        log.warning("set_network changes nothing in the PyTorch port: "
                    "join the cluster with lightgbm_tpu_torch.distributed."
                    "join_cluster + tree_learner=data")
        self.network = True
        return self
