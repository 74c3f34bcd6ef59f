"""Sparse (scipy CSR/CSC/COO) ingestion without densification (PyTorch
port of `lightgbm_tpu/io/sparse.py`; numpy and scipy only).

Replaces the reference's sparse bin storage
(ref: src/io/sparse_bin.hpp:1, multi_val_sparse_bin.hpp:1, and the
density heuristics in Dataset::GetShareStates, src/io/dataset.cpp).
The reference keeps per-feature delta-encoded sparse bins and a
multi-val row-wise bin for histogramming; the histogram kernels want
dense equal-shape columns, so the sparse path goes straight from CSC
columns to EFB bundle codes (io/bundle.py):

  CSC nonzeros -> per-feature bin mappers (zeros implied by count)
              -> nonzero bin codes (O(nnz))
              -> conflict-bounded greedy bundle plan (sampled rows)
              -> [num_bundles, n] dense uint8 bundle-code matrix

Host memory stays O(nnz + n * num_bundles + sample): the [n, F] dense
matrix is never materialized.  A 1M x 5000 matrix at 0.5% density lands
in a few dozen bundle columns (tens of MB on the card) instead of a
40 GB dense float64 intermediate.

The resulting Dataset carries `pre_bundled_plan`; `GBDT.init` uses it
directly instead of re-planning EFB from dense binned columns.

Validation sets against a sparse-trained reference reuse the reference's
plan, so valid rows where two bundle members conflict keep the LAST
member's code — the same by-design approximation EFB applies to training
rows (bounded there by max_conflict_rate; ref: FeatureGroup PushData).
A densified valid set keeps exact per-feature bins instead, so its
metric traces can differ in the 3rd decimal on conflicted rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..utils import log
from .binning import BIN_CATEGORICAL, BIN_NUMERICAL, BinMapper, \
    prep_find_bin_values
from .bundle import _SAMPLE, plan_bundles_from_masks
from .dataset import Dataset, Metadata, get_forced_bins


def is_scipy_sparse(data) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def construct_from_sparse(
        data,
        label=None, weight=None, group=None, init_score=None,
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
        max_conflict_rate: float = 0.0,
        enable_bundle: bool = True,
        max_bin_by_feature: Optional[Sequence[int]] = None,
        forcedbins_filename: str = "",
        reference: Optional[Dataset] = None,
        device_type: str = "cuda") -> Dataset:
    """Build a Dataset from a scipy sparse matrix, CSC-direct-to-bundles.

    Bin boundaries are IDENTICAL to the dense path's for the same data:
    the same row sample is drawn (same seed), and find_bin receives the
    same values (stored entries minus zeros, NaNs appended — exactly
    what prep_find_bin_values extracts from a dense column).
    `device_type` is the dataset's device (the bins stay on the host).
    """
    csc = data.tocsc()
    n, num_features = csc.shape
    ds = Dataset()
    ds.device_type = device_type
    ds.num_data = n
    ds.num_total_features = num_features
    ds.max_bin = max_bin
    if feature_names is not None:
        ds.feature_names = [str(s) for s in feature_names]
    else:
        ds.feature_names = [f"Column_{i}" for i in range(num_features)]

    ref_plan = None
    if reference is not None:
        if reference.num_total_features != num_features:
            log.fatal("Validation data feature count mismatch with "
                      "reference Dataset")
        ds.bin_mappers = reference.bin_mappers
        ds.used_feature_map = reference.used_feature_map
        ds.used_features = reference.used_features
        ds.feature_names = reference.feature_names
        ds.max_bin = reference.max_bin
        ref_plan = reference.pre_bundled_plan
    else:
        # row sample for bin finding (ref: bin_construct_sample_cnt);
        # CSR row slicing is O(nnz of the rows), then one CSC conversion
        # of the (small) sample
        if n > bin_construct_sample_cnt:
            rng = np.random.RandomState(seed)
            sample_idx = np.sort(rng.choice(n, bin_construct_sample_cnt,
                                            replace=False))
            sample_csc = data.tocsr()[sample_idx].tocsc()
        else:
            sample_csc = csc
        total_sample_cnt = sample_csc.shape[0]
        cat_set = set(categorical_feature or [])
        forced_bins = get_forced_bins(forcedbins_filename, num_features,
                                      cat_set)
        ds.bin_mappers = []
        for f in range(num_features):
            col_vals = sample_csc.data[
                sample_csc.indptr[f]:sample_csc.indptr[f + 1]]
            vals = prep_find_bin_values(col_vals)
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
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                forced_upper_bounds=forced_bins[f])
            ds.bin_mappers.append(mapper)
        ds.used_feature_map = []
        ds.used_features = []
        for f, m in enumerate(ds.bin_mappers):
            if m.is_trivial:
                ds.used_feature_map.append(-1)
            else:
                ds.used_feature_map.append(len(ds.used_features))
                ds.used_features.append(f)

    # --- nonzero bin codes per used feature (O(nnz), no dense bins).
    # TWO distinct "default" notions: the FILL bin (what an absent/zero
    # entry bins to, values_to_bins(0.0) for both types) and the bundle
    # PLAN default (bundle.py _default_bins: fill bin for numerical, the
    # NaN/other bin 0 for categorical).  When they differ (a categorical
    # whose category 0 is a real bin), the column is NOT sparse in bundle
    # terms — its implied rows are non-default — and is materialized
    # per-column so the plan and codes match the dense path exactly. ---
    nz_rows: List[np.ndarray] = []
    nz_bins: List[np.ndarray] = []
    zero_bin = np.zeros(len(ds.used_features), np.int32)
    nbins = np.zeros(len(ds.used_features), np.int32)
    for inner, f in enumerate(ds.used_features):
        m = ds.bin_mappers[f]
        s, e = csc.indptr[f], csc.indptr[f + 1]
        rows = np.asarray(csc.indices[s:e])
        bins = m.values_to_bins(np.asarray(csc.data[s:e], np.float64))
        fill = int(m.values_to_bins(np.zeros(1))[0])
        pzb = fill if m.bin_type == BIN_NUMERICAL else 0
        zero_bin[inner] = pzb
        nbins[inner] = m.num_bin
        if fill == pzb:
            keep = bins != pzb   # entries binning to the default act absent
            nz_rows.append(rows[keep])
            nz_bins.append(bins[keep].astype(np.int32))
        else:
            col = np.full(n, fill, np.int32)
            col[rows] = bins
            nzr = np.nonzero(col != pzb)[0]
            nz_rows.append(nzr)
            nz_bins.append(col[nzr])

    # --- conflict-bounded greedy bundling over a row sample (mirrors
    # io/bundle.py plan_bundles; ref: dataset.cpp FindGroups).  A
    # validation set against a sparse-trained reference reuses the
    # reference's plan so both sides decode identically; against a
    # dense-trained reference it emits plain per-feature bins. ---
    F = len(ds.used_features)
    if (reference is not None and ref_plan is None) or not enable_bundle:
        dtype = np.uint8 if max(
            (ds.bin_mappers[f].num_bin for f in ds.used_features),
            default=1) <= 256 else np.int32
        out = np.empty((F, n), dtype)
        for inner in range(F):
            col = np.full(n, zero_bin[inner], np.int32)
            col[nz_rows[inner]] = nz_bins[inner]
            out[inner] = col.astype(dtype)
        ds.binned = out
        md = Metadata(n)
        if label is not None:
            md.set_label(label)
        md.set_weight(weight)
        md.set_group(group)
        md.set_init_score(init_score)
        ds.metadata = md
        return ds
    if n <= _SAMPLE:
        in_sample = None
        sample_size = n
    else:
        srng = np.random.RandomState(3)
        srows = srng.choice(n, _SAMPLE, False)
        in_sample = np.full(n, -1, np.int64)
        in_sample[srows] = np.arange(_SAMPLE)
        sample_size = _SAMPLE

    _mask_cache = {}

    def sample_mask(inner):
        got = _mask_cache.get(inner)
        if got is not None:
            return got
        mask = np.zeros(sample_size, bool)
        r = nz_rows[inner]
        if in_sample is None:
            mask[r] = True
        else:
            pos = in_sample[r]
            mask[pos[pos >= 0]] = True
        _mask_cache[inner] = mask
        return mask

    if ref_plan is not None:
        # validation set against a sparse-trained reference: decode with
        # the SAME plan so train and valid bundle columns align
        plan = ref_plan
    else:
        # the shared greedy planner core over the SAME row sample the
        # dense path uses, so the plan is identical to plan_bundles on
        # the densified matrix

        class _LazyMasks:
            def __getitem__(self, f):
                return sample_mask(f)

        plan = plan_bundles_from_masks(_LazyMasks(), nbins, zero_bin,
                                       sample_size, max_conflict_rate)

    # --- bundle-code matrix [num_bundles, n]: the ONLY dense object ---
    dtype = np.uint8 if int(plan.group_num_bin.max(initial=1)) <= 256 \
        else np.int32
    out = np.zeros((plan.num_groups, n), dtype)
    for gi, members in enumerate(plan.groups):
        if len(members) == 1:
            f0 = members[0]
            col = np.full(n, plan.zero_bin[f0], np.int32)
            col[nz_rows[f0]] = nz_bins[f0]
            out[gi] = col.astype(dtype)
            continue
        col = np.zeros(n, np.int32)       # 0 = all members at default
        for f0 in members:                # later members win conflicts
            col[nz_rows[f0]] = plan.offsets[f0] + nz_bins[f0]
        out[gi] = col.astype(dtype)

    ds.binned = out
    ds.pre_bundled_plan = plan
    log.info(f"Sparse ingestion: {num_features} features "
             f"({csc.nnz} nonzeros) -> {plan.num_groups} bundle columns "
             f"without densification")

    md = Metadata(n)
    if label is not None:
        md.set_label(label)
    md.set_weight(weight)
    md.set_group(group)
    md.set_init_score(init_score)
    ds.metadata = md
    return ds
