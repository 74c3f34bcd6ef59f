"""Dataset: binned feature tensors + Metadata (PyTorch port of
`lightgbm_tpu/io/dataset.py`).

All used features are binned into one dense feature-major matrix
`binned [F_used, n]` (ref: include/LightGBM/dataset.h:486,
src/io/dataset_loader.cpp:593 ConstructFromSampleData): on the host, or,
for float32 data of at least 2^20 rows on a dataset whose `device_type`
is the card, on the card (`io/device_bin.py`, bit-identical), where the
slot holds a uint8 `torch.Tensor`.  When a booster takes the dataset
over, the slot holds its padded device copy `[F_used, n_pad]`, and
`binned_host()` recovers the `[F_used, n]` host view.  Trivial features
are dropped at construction and restored at model-output time via
`used_feature_map` (ref: dataset.h:556-647).

Dense in-memory arrays are binned here; scipy sparse matrices go
straight to EFB bundle codes (`io/sparse.py`), and such a dataset holds
`[F', n]` bundle codes with the `pre_bundled_plan` that decodes them.
Text files (CSV, TSV, LibSVM; `io/parser.py`) load through
`load_dataset_from_file` with their `.weight` and `.query` side files,
whole or streamed twice (`two_round`, `construct_from_stream`: the raw
float matrix never exists); `save_binary` / `load_binary` write and read
the JAX package's `.npz` layout, so either package loads the other's
file.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils import log
from ..utils.timer import global_timer
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper
from .bundle import decode_bundle_column
from .device_bin import bin_matrix_device, device_binnable, pull_host


class Metadata:
    """Labels / weights / init scores / query boundaries / positions
    (ref: include/LightGBM/dataset.h:47-399, src/io/metadata.cpp)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: np.ndarray = np.zeros(num_data, dtype=np.float32)
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # int32 [num_queries+1]
        self.position: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log.fatal(f"Length of label ({len(label)}) != num_data ({self.num_data})")
        self.label = label

    def set_weight(self, weight: Optional[Sequence[float]]) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            log.fatal(f"Length of weight ({len(weight)}) != num_data ({self.num_data})")
        self.weight = weight

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        if init_score is None:
            self.init_score = None
            return
        init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)
        self.init_score = init_score

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """`group` is sizes per query (LightGBM convention); converts to boundaries."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        if group.sum() != self.num_data:
            log.fatal(f"Sum of query counts ({group.sum()}) != num_data ({self.num_data})")
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int32)

    def set_position(self, position: Optional[Sequence[int]]) -> None:
        self.position = None if position is None else np.asarray(position, dtype=np.int32)

    @property
    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1


def get_forced_bins(path: str, num_total_features: int,
                    categorical_features=()) -> List[List[float]]:
    """forcedbins_filename JSON -> per-feature forced bin upper bounds
    (ref: dataset_loader.cpp:1493 GetForcedBins): a list of
    {"feature": i, "bin_upper_bound": [...]} records; missing file warns
    and is ignored, categorical features warn and are skipped,
    consecutive duplicates are removed."""
    forced: List[List[float]] = [[] for _ in range(num_total_features)]
    if not path:
        return forced
    try:
        with open(path) as f:
            arr = json.load(f)
    except OSError:
        log.warning(f"Could not open {path}. Will ignore.")
        return forced
    cat = set(categorical_features or ())
    for rec in arr:
        fnum = int(rec["feature"])
        if fnum >= num_total_features or fnum < 0:
            log.fatal(f"forced bins feature index {fnum} out of range")
        if fnum in cat:
            log.warning(f"Feature {fnum} is categorical. Will ignore "
                        "forced bins for this feature.")
            continue
        forced[fnum].extend(float(v) for v in rec["bin_upper_bound"])
    for i in range(num_total_features):
        deduped: List[float] = []
        for v in forced[i]:
            if not deduped or deduped[-1] != v:
                deduped.append(v)
        forced[i] = deduped
    return forced


class Dataset:
    """Binned training data (ref: include/LightGBM/dataset.h:486 `class Dataset`)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.bin_mappers: List[BinMapper] = []          # per original feature
        self.used_feature_map: List[int] = []            # original -> inner (-1 trivial)
        self.used_features: List[int] = []               # inner -> original
        # [F_used, n] host bin codes, or uint8 torch.Tensor codes on the
        # device: [F_used, n] from the device second pass, [F_used, n_pad]
        # once a booster took the dataset over
        self.binned = None
        self.metadata: Optional[Metadata] = None
        self.max_bin: int = 255
        self.raw_data: Optional[np.ndarray] = None
        # where the second pass may bin (io/device_bin.py gate)
        self.device_type: str = "cuda"
        # float32 bin-construction sample rows, kept when `binned` lives
        # on the device: EFB planning bins them lazily on the host
        # (efb_sample_bins) instead of pulling the whole matrix
        self._efb_sample_raw: Optional[np.ndarray] = None
        self._efb_sample_bins: Optional[np.ndarray] = None
        # sparse ingestion (io/sparse.py): `binned` holds [F', n] EFB
        # bundle codes, and this BundlePlan decodes them
        self.pre_bundled_plan = None

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        return len(self.used_features)

    def num_bin(self, inner_feature: int) -> int:
        return self.bin_mappers[self.used_features[inner_feature]].num_bin

    @property
    def max_num_bin(self) -> int:
        if not self.used_features:
            return 1
        return max(self.bin_mappers[f].num_bin for f in self.used_features)

    def inner_feature_index(self, original: int) -> int:
        return self.used_feature_map[original]

    def binned_host(self) -> np.ndarray:
        """Host view [F_used, n] of the bin matrix (pulled once when the
        slot holds device bins or the booster's padded device copy)."""
        if isinstance(self.binned, torch.Tensor):
            self.binned = pull_host(self.binned[:, :self.num_data])
        return self.binned

    def efb_sample_bins(self) -> Optional[np.ndarray]:
        """Host [F_used, S] bin codes of the bin-construction sample (the
        EFB planning input of device-binned datasets); binned lazily and
        cached."""
        if self._efb_sample_bins is None and self._efb_sample_raw is not None:
            self._efb_sample_bins = np.stack([
                self.bin_mappers[f].values_to_bins(
                    np.asarray(self._efb_sample_raw[:, i], np.float64))
                for i, f in enumerate(self.used_features)])
        return self._efb_sample_bins

    def feature_bins(self, inner: int) -> np.ndarray:
        """Bin codes [n] of used feature `inner`; on a sparse-ingested
        dataset the member's code range is sliced out of its bundle
        column and every other code is the default bin (the host mirror
        of Dataset::FixHistogram's member recovery)."""
        plan = self.pre_bundled_plan
        if plan is None:
            return self.binned_host()[inner]
        return decode_bundle_column(
            self.binned_host()[int(plan.group_idx[inner])].astype(np.int32),
            plan, inner, self.bin_mappers[self.used_features[inner]].num_bin)

    # ------------------------------------------------------------------
    @classmethod
    def construct_from_arrays(
            cls,
            data: np.ndarray,
            label: Optional[Sequence[float]] = None,
            weight: Optional[Sequence[float]] = None,
            group: Optional[Sequence[int]] = None,
            init_score: Optional[Sequence[float]] = None,
            max_bin: int = 255,
            min_data_in_bin: int = 3,
            min_data_in_leaf: int = 20,
            bin_construct_sample_cnt: int = 200000,
            categorical_feature: Optional[Sequence[int]] = None,
            feature_names: Optional[Sequence[str]] = None,
            use_missing: bool = True,
            zero_as_missing: bool = False,
            feature_pre_filter: bool = True,
            seed: int = 1,
            keep_raw_data: bool = False,
            reference: Optional["Dataset"] = None,
            max_bin_by_feature: Optional[Sequence[int]] = None,
            forcedbins_filename: str = "",
            device_type: str = "cuda") -> "Dataset":
        """Build a Dataset from a dense float matrix
        (ref: dataset_loader.cpp:593 ConstructFromSampleData + :1263 ExtractFeatures).

        When `reference` is given, reuse its bin mappers (validation-set path,
        ref: basic.py create_valid / LoadFromFileAlignWithOtherDataset).
        `device_type` is where the second pass may bin (see the module
        docstring).
        """
        # keep the caller's dtype: values_to_bins converts per column
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        if data.ndim != 2:
            log.fatal("Training data must be 2-dimensional")
        n, num_features = data.shape
        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_features
        ds.max_bin = max_bin
        ds.device_type = device_type
        if feature_names is not None:
            ds.feature_names = [str(s) for s in feature_names]
        else:
            ds.feature_names = [f"Column_{i}" for i in range(num_features)]

        if reference is not None:
            if reference.num_total_features != num_features:
                log.fatal("Validation data feature count mismatch with reference Dataset")
            ds.bin_mappers = reference.bin_mappers
            ds.used_feature_map = reference.used_feature_map
            ds.used_features = reference.used_features
            ds.feature_names = reference.feature_names
            ds.max_bin = reference.max_bin
        else:
            # sample rows for bin finding (ref: config `bin_construct_sample_cnt`)
            if n > bin_construct_sample_cnt:
                rng = np.random.RandomState(seed)
                sample_idx = np.sort(rng.choice(n, bin_construct_sample_cnt, replace=False))
                sample = data[sample_idx]
            else:
                sample = data
            ds._build_mappers(
                sample, len(sample), max_bin=max_bin,
                min_data_in_bin=min_data_in_bin,
                min_data_in_leaf=min_data_in_leaf,
                categorical_feature=categorical_feature,
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                feature_pre_filter=feature_pre_filter,
                max_bin_by_feature=max_bin_by_feature,
                forcedbins_filename=forcedbins_filename)

        # bin every used feature (ref: ExtractFeaturesFromMemory PushOneRow):
        # float32 large-n numerical data on a card dataset bucketizes on
        # the device (io/device_bin.py, exact), otherwise the host
        # searchsorted loop runs per feature
        with global_timer.scope("Dataset::binning"):
            if device_binnable(ds.bin_mappers, ds.used_features, data.dtype,
                               n, device_type):
                ds.binned = global_timer.block(bin_matrix_device(
                    data, ds.bin_mappers, ds.used_features, device_type))
                if reference is None:
                    # keep the (already sampled) bin-finding rows: EFB
                    # planning bins them lazily (efb_sample_bins)
                    ds._efb_sample_raw = np.ascontiguousarray(
                        sample[:, ds.used_features]
                        if sample.shape[1] != len(ds.used_features)
                        else sample)
            else:
                narrow = all(ds.bin_mappers[f].num_bin <= 256
                             for f in ds.used_features)
                binned = np.empty((len(ds.used_features), n),
                                  dtype=np.uint8 if narrow else np.int32)
                for inner, f in enumerate(ds.used_features):
                    binned[inner] = ds.bin_mappers[f].values_to_bins(
                        data[:, f])
                ds.binned = binned

        md = Metadata(n)
        if label is not None:
            md.set_label(label)
        md.set_weight(weight)
        md.set_group(group)
        md.set_init_score(init_score)
        ds.metadata = md
        if keep_raw_data:
            # linear-tree solves expect float64 raw values regardless of
            # the input dtype
            ds.raw_data = np.asarray(data, np.float64)
        return ds

    # ------------------------------------------------------------------
    def _build_mappers(self, sample, total_sample_cnt, *, max_bin,
                       min_data_in_bin, min_data_in_leaf,
                       categorical_feature, use_missing, zero_as_missing,
                       feature_pre_filter, max_bin_by_feature,
                       forcedbins_filename):
        """BinMappers + used-feature map from a sample matrix (ref:
        dataset_loader.cpp:593 ConstructFromSampleData)."""
        from .binning import prep_find_bin_values
        num_features = self.num_total_features
        cat_set = set(categorical_feature or [])
        forced_bins = get_forced_bins(forcedbins_filename, num_features,
                                      cat_set)
        self.bin_mappers = []
        with global_timer.scope("Dataset::find_bin"):
            for f in range(num_features):
                # reference samples *non-zero* values; zeros are implied
                # counts
                vals = prep_find_bin_values(sample[:, f])
                mapper = BinMapper()
                fmax_bin = (int(max_bin_by_feature[f])
                            if max_bin_by_feature else max_bin)
                mapper.find_bin(
                    vals, total_sample_cnt, fmax_bin,
                    min_data_in_bin=min_data_in_bin,
                    min_split_data=min_data_in_leaf,
                    pre_filter=feature_pre_filter,
                    bin_type=(BIN_CATEGORICAL if f in cat_set
                              else BIN_NUMERICAL),
                    use_missing=use_missing,
                    zero_as_missing=zero_as_missing,
                    forced_upper_bounds=forced_bins[f])
                self.bin_mappers.append(mapper)
        self.used_feature_map = []
        self.used_features = []
        for f, m in enumerate(self.bin_mappers):
            if m.is_trivial:
                self.used_feature_map.append(-1)
            else:
                self.used_feature_map.append(len(self.used_features))
                self.used_features.append(f)

    @classmethod
    def construct_from_stream(
            cls, stream_factory, weight=None, group=None,
            max_bin: int = 255, min_data_in_bin: int = 3,
            min_data_in_leaf: int = 20,
            bin_construct_sample_cnt: int = 200000,
            categorical_feature=None, feature_names=None,
            use_missing: bool = True, zero_as_missing: bool = False,
            feature_pre_filter: bool = True, seed: int = 1,
            max_bin_by_feature=None,
            forcedbins_filename: str = "",
            reference: Optional["Dataset"] = None,
            device_type: str = "cuda") -> "Dataset":
        """Two-round construction (ref: config.h `two_round`;
        dataset_loader.cpp:1022 SampleTextDataFromFile + :1100
        ExtractFeaturesFromFile): the JAX package's streaming loader.

        `stream_factory()` returns a fresh iterator of (feats [c, F],
        labels [c] or None) chunks each time it is called; a chunk may be
        narrower than later ones (LibSVM reveals its widest feature
        late) and is zero-padded.  Pass 1 counts the rows and draws the
        bin-finding sample by reservoir sampling from
        `RandomState(seed)`, the JAX package's draws, so the bins are
        its bins; pass 2 streams again and bins each chunk into the
        [F_used, n] code matrix on the host.  Peak memory is one chunk,
        the sample and the codes.
        """
        rng = np.random.RandomState(seed)
        # with a reference the mappers are reused: pass 1 only counts
        # rows and collects labels
        cap = (1 if reference is not None
               else max(1, int(bin_construct_sample_cnt)))
        sample_buf = None
        filled = 0
        n = 0
        labels_parts = []
        for feats, labels in stream_factory():
            feats = np.asarray(feats, np.float64)
            c = feats.shape[0]
            if labels is not None:
                labels_parts.append(np.asarray(labels, np.float32))
            if sample_buf is None:
                sample_buf = np.zeros((cap, feats.shape[1]), np.float64)
            elif feats.shape[1] > sample_buf.shape[1]:
                sample_buf = np.pad(
                    sample_buf,
                    ((0, 0), (0, feats.shape[1] - sample_buf.shape[1])))
            elif feats.shape[1] < sample_buf.shape[1]:
                feats = np.pad(
                    feats,
                    ((0, 0), (0, sample_buf.shape[1] - feats.shape[1])))
            take = min(cap - filled, c)
            if take > 0:
                sample_buf[filled:filled + take] = feats[:take]
                filled += take
            if take < c:
                # Vitter's algorithm R, the draws batched per chunk
                seen = n + take + np.arange(1, c - take + 1)
                js = (rng.random_sample(c - take) * seen).astype(np.int64)
                for i in np.nonzero(js < cap)[0]:
                    sample_buf[js[i]] = feats[take + i]
            n += c
        if n == 0:
            log.fatal("Empty data stream")
        sample = sample_buf[:filled]
        if reference is not None:
            # narrower than the training data is legal for LibSVM
            # (trailing all-zero features) and zero-pads below
            if sample.shape[1] > reference.num_total_features:
                log.fatal("Validation data feature count mismatch with "
                          "reference Dataset")
            num_features = reference.num_total_features
        else:
            num_features = sample.shape[1]

        ds = cls()
        ds.num_data = n
        ds.num_total_features = num_features
        ds.max_bin = max_bin
        ds.device_type = device_type
        ds.feature_names = ([str(s) for s in feature_names]
                            if feature_names is not None else
                            [f"Column_{i}" for i in range(num_features)])
        if reference is not None:
            ds.bin_mappers = reference.bin_mappers
            ds.used_feature_map = reference.used_feature_map
            ds.used_features = reference.used_features
            ds.feature_names = reference.feature_names
            ds.max_bin = reference.max_bin
        else:
            ds._build_mappers(
                sample, len(sample), max_bin=max_bin,
                min_data_in_bin=min_data_in_bin,
                min_data_in_leaf=min_data_in_leaf,
                categorical_feature=categorical_feature,
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                feature_pre_filter=feature_pre_filter,
                max_bin_by_feature=max_bin_by_feature,
                forcedbins_filename=forcedbins_filename)
        del sample

        narrow = all(m.num_bin <= 256 for m in ds.bin_mappers)
        binned = np.empty((len(ds.used_features), n),
                          dtype=np.uint8 if narrow else np.int32)
        off = 0
        with global_timer.scope("Dataset::binning"):
            for feats, _ in stream_factory():
                feats = np.asarray(feats, np.float64)
                c = feats.shape[0]
                if off + c > n:
                    log.fatal("Stream yielded more rows on pass 2 than "
                              "pass 1")
                if feats.shape[1] < num_features:   # LibSVM implicit zeros
                    feats = np.pad(
                        feats, ((0, 0), (0, num_features - feats.shape[1])))
                for inner, f in enumerate(ds.used_features):
                    binned[inner, off:off + c] = \
                        ds.bin_mappers[f].values_to_bins(feats[:, f])
                off += c
        if off != n:
            log.fatal(f"Stream yielded {off} rows on pass 2, {n} on pass 1")
        ds.binned = binned

        md = Metadata(n)
        if labels_parts:
            md.set_label(np.concatenate(labels_parts))
        md.set_weight(weight)
        md.set_group(group)
        ds.metadata = md
        return ds

    def copy_subrow(self, used_indices: np.ndarray) -> "Dataset":
        """Row-subset copy on the same bin mappers (ref: dataset.h:660
        CopySubrow; `cv`'s folds)."""
        used_indices = np.asarray(used_indices, dtype=np.int64)
        sub = Dataset()
        sub.num_data = len(used_indices)
        sub.num_total_features = self.num_total_features
        sub.feature_names = self.feature_names
        sub.bin_mappers = self.bin_mappers
        sub.used_feature_map = self.used_feature_map
        sub.used_features = self.used_features
        sub.max_bin = self.max_bin
        sub.device_type = self.device_type
        sub.binned = self.binned_host()[:, used_indices]
        sub.pre_bundled_plan = self.pre_bundled_plan
        md = Metadata(sub.num_data)
        src = self.metadata
        md.set_label(src.label[used_indices])
        if src.weight is not None:
            md.set_weight(src.weight[used_indices])
        if src.init_score is not None:
            if len(src.init_score) == self.num_data:
                md.set_init_score(src.init_score[used_indices])
            else:  # num_data * num_class layout (ref: metadata.cpp)
                num_class = len(src.init_score) // self.num_data
                stacked = src.init_score.reshape(num_class, self.num_data)
                md.set_init_score(stacked[:, used_indices].reshape(-1))
        if src.query_boundaries is not None:
            # query boundaries from the selected rows' query ids (ref:
            # metadata.cpp Metadata::Init(metadata, used_indices))
            qid = np.searchsorted(src.query_boundaries, used_indices,
                                  side="right") - 1
            counts = np.bincount(qid, minlength=src.num_queries)
            counts = counts[counts > 0]
            md.query_boundaries = np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int32)
        if src.position is not None:
            md.set_position(src.position[used_indices])
        sub.metadata = md
        if self.raw_data is not None:
            sub.raw_data = self.raw_data[used_indices]
        return sub

    # ------------------------------------------------------------------
    def create_valid(self, data: np.ndarray, label=None, weight=None, group=None,
                     init_score=None, keep_raw_data: bool = False) -> "Dataset":
        return Dataset.construct_from_arrays(
            data, label=label, weight=weight, group=group, init_score=init_score,
            reference=self, keep_raw_data=keep_raw_data,
            device_type=self.device_type)

    # ------------------------------------------------------------------
    def feature_infos(self) -> List[str]:
        return [m.feature_info_str() for m in self.bin_mappers]

    def save_binary(self, path: str) -> None:
        """Binary dataset file (ref: dataset.h:691 SaveBinaryFile): the
        JAX package's compressed `.npz` layout (NumPy appends `.npz` to a
        path without it)."""
        md = self.metadata
        plan = self.pre_bundled_plan
        np.savez_compressed(
            path,
            binned=self.binned_host(),
            label=md.label,
            weight=md.weight if md.weight is not None else np.array([]),
            init_score=(md.init_score if md.init_score is not None
                        else np.array([])),
            query_boundaries=(md.query_boundaries
                              if md.query_boundaries is not None
                              else np.array([], dtype=np.int32)),
            meta_json=np.frombuffer(json.dumps({
                "num_data": self.num_data,
                "num_total_features": self.num_total_features,
                "feature_names": self.feature_names,
                "used_features": self.used_features,
                "used_feature_map": self.used_feature_map,
                "max_bin": self.max_bin,
                "bin_mappers": [m.to_dict() for m in self.bin_mappers],
                "bundle_plan": (None if plan is None else {
                    "groups": [list(map(int, g)) for g in plan.groups],
                    "group_idx": plan.group_idx.tolist(),
                    "offsets": plan.offsets.tolist(),
                    "zero_bin": plan.zero_bin.tolist(),
                    "in_bundle": plan.in_bundle.astype(int).tolist(),
                    "group_num_bin": plan.group_num_bin.tolist(),
                }),
            }).encode(), dtype=np.uint8))

    @classmethod
    def load_binary(cls, path: str, device_type: str = "cuda") -> "Dataset":
        """(ref: dataset_loader.cpp:417 LoadFromBinFile)."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta_json"]).decode())
            ds = cls()
            ds.num_data = meta["num_data"]
            ds.num_total_features = meta["num_total_features"]
            ds.feature_names = meta["feature_names"]
            ds.used_features = meta["used_features"]
            ds.used_feature_map = meta["used_feature_map"]
            ds.max_bin = meta["max_bin"]
            ds.device_type = device_type
            ds.bin_mappers = [BinMapper.from_dict(d)
                              for d in meta["bin_mappers"]]
            ds.binned = z["binned"]
            bp = meta.get("bundle_plan")
            if bp is not None:
                from .bundle import BundlePlan
                ds.pre_bundled_plan = BundlePlan(
                    [list(g) for g in bp["groups"]],
                    np.asarray(bp["group_idx"], np.int32),
                    np.asarray(bp["offsets"], np.int32),
                    np.asarray(bp["zero_bin"], np.int32),
                    np.asarray(bp["in_bundle"], bool),
                    np.asarray(bp["group_num_bin"], np.int32))
            md = Metadata(ds.num_data)
            md.set_label(z["label"])
            if len(z["weight"]):
                md.set_weight(z["weight"])
            if len(z["init_score"]):
                md.set_init_score(z["init_score"])
            if len(z["query_boundaries"]):
                md.query_boundaries = z["query_boundaries"].astype(np.int32)
        ds.metadata = md
        return ds


def _read_side_files(path: str):
    """.weight / .query side files (ref: metadata.cpp LoadWeights /
    LoadQueryBoundaries)."""
    weight = group = None
    try:
        with open(path + ".weight") as f:
            weight = np.array([float(x) for x in f.read().split()],
                              dtype=np.float32)
    except FileNotFoundError:
        pass
    try:
        with open(path + ".query") as f:
            group = np.array([int(x) for x in f.read().split()],
                             dtype=np.int64)
    except FileNotFoundError:
        pass
    return weight, group


def _parse_categorical(cfg, names) -> List[int]:
    """categorical_feature tokens -> column indices; `name:` tokens
    resolve against the header's names (ref: dataset_loader.cpp:35
    SetHeader)."""
    cat_features: List[int] = []
    if cfg.categorical_feature:
        for tok in str(cfg.categorical_feature).split(","):
            tok = tok.strip()
            if tok.startswith("name:"):
                if names and tok[5:] in names:
                    cat_features.append(names.index(tok[5:]))
                else:
                    log.warning(f"categorical_feature {tok!r} not found "
                                "in header names; ignored")
            elif tok:
                cat_features.append(int(tok))
    return cat_features


def _load_two_round(path: str, cfg, reference: Optional[Dataset] = None
                    ) -> Dataset:
    """two_round=true file loading (ref: config.h two_round;
    dataset_loader.cpp:1022 SampleTextDataFromFile + :1100
    ExtractFeaturesFromFile): the file is streamed twice and the raw
    float matrix never exists."""
    from .parser import _header_names_of, _label_index, parse_file_stream
    if cfg.linear_tree:
        # the reference rejects the combination (config.cpp: "Cannot use
        # two_round loading with linear tree")
        log.fatal("Cannot use two_round loading with linear tree")
    names = None
    if cfg.header:
        with open(path) as f:
            header_names = _header_names_of(f.readline().rstrip("\n\r"))
        li = _label_index(cfg.label_column, header_names)
        names = [h for i, h in enumerate(header_names) if i != li]

    def stream():
        return parse_file_stream(path, has_header=cfg.header,
                                 label_column=cfg.label_column,
                                 chunk_rows=16384)

    weight, group = _read_side_files(path)
    return Dataset.construct_from_stream(
        stream, weight=weight, group=group,
        max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
        min_data_in_leaf=cfg.min_data_in_leaf,
        bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
        categorical_feature=_parse_categorical(cfg, names),
        feature_names=names, use_missing=cfg.use_missing,
        zero_as_missing=cfg.zero_as_missing,
        feature_pre_filter=cfg.feature_pre_filter,
        seed=cfg.data_random_seed,
        max_bin_by_feature=cfg.max_bin_by_feature or None,
        forcedbins_filename=cfg.forcedbins_filename,
        reference=reference, device_type=cfg.device_type)


def load_dataset_from_file(path: str,
                           config_params: Optional[Dict[str, Any]] = None,
                           reference: Optional[Dataset] = None) -> Dataset:
    """File -> Dataset (ref: dataset_loader.cpp LoadFromFile): a binary
    file (`.bin` / `.bin.npz`), else a text file parsed whole or, under
    `two_round`, streamed twice, with its side files."""
    from ..config import Config
    from .parser import parse_file
    cfg = (config_params if isinstance(config_params, Config)
           else Config(config_params or {}))
    if path.endswith(".bin.npz") or path.endswith(".bin"):
        try:
            return Dataset.load_binary(path, device_type=cfg.device_type)
        except (FileNotFoundError, OSError, KeyError, ValueError):
            pass
    if cfg.two_round:
        return _load_two_round(path, cfg, reference=reference)
    feats, labels, names = parse_file(path, has_header=cfg.header,
                                      label_column=cfg.label_column)
    weight, group = _read_side_files(path)
    if reference is not None:
        return reference.create_valid(feats, label=labels, weight=weight,
                                      group=group,
                                      keep_raw_data=cfg.linear_tree)
    return Dataset.construct_from_arrays(
        feats, label=labels, weight=weight, group=group,
        max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
        min_data_in_leaf=cfg.min_data_in_leaf,
        forcedbins_filename=cfg.forcedbins_filename,
        bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
        categorical_feature=_parse_categorical(cfg, names),
        feature_names=names, use_missing=cfg.use_missing,
        zero_as_missing=cfg.zero_as_missing,
        feature_pre_filter=cfg.feature_pre_filter,
        seed=cfg.data_random_seed, keep_raw_data=cfg.linear_tree,
        device_type=cfg.device_type)
