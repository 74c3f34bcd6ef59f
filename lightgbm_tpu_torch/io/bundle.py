"""Exclusive Feature Bundling (EFB).

TPU-native analogue of the reference's FeatureGroup construction
(ref: include/LightGBM/feature_group.h:25; greedy bundling in
src/io/dataset.cpp FastFeatureBundling/FindGroups): sparse features that
are (almost) never simultaneously non-default share one device column,
shrinking the histogram pass's F axis — the "long axis" scaler for
wide-sparse data (SURVEY §5).

Encoding: bundle code 0 = every member at its default (zero) bin;
member i's bin b is encoded as offset_i + b, with disjoint
[offset_i, offset_i + num_bin_i) ranges (offset_0 = 1).  Conflicting
rows (two members non-default, allowed up to max_conflict_rate) keep the
LAST member's code, like the reference's ordered PushData.  The
histogram built over bundle columns is converted back to per-feature
histograms by slicing each member's range and recovering the default
bin by subtraction from the leaf totals — the reference's
Dataset::FixHistogram (dataset.h:759).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .binning import BIN_NUMERICAL

MAX_BUNDLE_BINS = 256       # uint8 device codes; also the EFB win window:
                            # bundling pays when member bins sum small
                            # (one-hot histogram volume = total bins x n)
_SAMPLE = 50_000            # rows sampled for conflict counting


class BundlePlan:
    """Static bundling description (host side)."""

    def __init__(self, groups: List[List[int]], group_idx: np.ndarray,
                 offsets: np.ndarray, zero_bin: np.ndarray,
                 in_bundle: np.ndarray, group_num_bin: np.ndarray):
        self.groups = groups              # bundle -> inner feature list
        self.group_idx = group_idx        # [F] feature -> bundle column
        self.offsets = offsets            # [F] code offset (0 = singleton)
        self.zero_bin = zero_bin          # [F] the default (zero) bin
        self.in_bundle = in_bundle        # [F] bool: part of a >1 bundle
        self.group_num_bin = group_num_bin  # [F'] bins per bundle column

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def effective(self) -> bool:
        return bool(self.in_bundle.any())


def _default_bins(mappers, used_features) -> np.ndarray:
    """The 'default' bin per feature: the bin holding value 0.0
    (ref: most_freq_bin semantics for sparse data)."""
    zb = np.zeros(len(used_features), np.int32)
    for i, f in enumerate(used_features):
        m = mappers[f]
        if m.bin_type == BIN_NUMERICAL:
            zb[i] = m.value_to_bin(0.0)
        else:
            zb[i] = 0  # categorical: the NaN/other bin
    return zb


def plan_bundles_from_masks(nz, nbins: np.ndarray, zb: np.ndarray,
                            sample_size: int,
                            max_conflict_rate: float) -> BundlePlan:
    """Greedy conflict-bounded bundling core (ref: dataset.cpp
    FindGroups): features ordered by non-default count descending; each
    joins the first bundle whose accumulated conflicts stay under the
    cap.  `nz` is the [F, S] non-default mask over the row sample (any
    indexable of bool vectors); shared by the dense and the
    CSC-direct-sparse planners so their plans cannot diverge."""
    F = len(nbins)
    nz_cnt = np.array([int(nz[f].sum()) for f in range(F)], np.int64)
    cap = max_conflict_rate * sample_size

    order = np.argsort(-nz_cnt)
    groups: List[List[int]] = []
    group_nz: List[np.ndarray] = []
    group_conflicts: List[int] = []
    group_bins: List[int] = []
    for f in order:
        f = int(f)
        placed = False
        for gi in range(len(groups)):
            if group_bins[gi] + nbins[f] > MAX_BUNDLE_BINS:
                continue
            conflicts = int((group_nz[gi] & nz[f]).sum())
            if group_conflicts[gi] + conflicts <= cap:
                groups[gi].append(f)
                group_nz[gi] |= nz[f]
                group_conflicts[gi] += conflicts
                group_bins[gi] += int(nbins[f])
                placed = True
                break
        if not placed:
            groups.append([f])
            group_nz.append(np.array(nz[f], copy=True))
            group_conflicts.append(0)
            group_bins.append(1 + int(nbins[f]))

    group_idx = np.zeros(F, np.int32)
    offsets = np.zeros(F, np.int32)
    in_bundle = np.zeros(F, bool)
    group_num_bin = np.zeros(len(groups), np.int32)
    for gi, members in enumerate(groups):
        if len(members) == 1:
            f = members[0]
            group_idx[f] = gi
            offsets[f] = 0
            group_num_bin[gi] = nbins[f]
            continue
        off = 1
        for f in members:
            group_idx[f] = gi
            offsets[f] = off
            in_bundle[f] = True
            off += int(nbins[f])
        group_num_bin[gi] = off
    return BundlePlan(groups, group_idx, offsets, zb, in_bundle,
                      group_num_bin)


def plan_bundles(binned: np.ndarray, mappers, used_features,
                 max_conflict_rate: float = 0.0,
                 rng: Optional[np.random.RandomState] = None) -> BundlePlan:
    """Dense-binned front end of the planner."""
    F, n = binned.shape
    zb = _default_bins(mappers, used_features)
    sample = (np.arange(n) if n <= _SAMPLE else
              (rng or np.random.RandomState(3)).choice(n, _SAMPLE, False))
    # device-binned datasets (io/device_bin.py): gather the row sample on
    # device, pull only the [F, S] slice
    sub = np.asarray(binned[:, sample])
    nz = sub != zb[:, None]                       # [F, S] non-default mask
    nbins = np.array([mappers[f].num_bin for f in used_features], np.int32)
    return plan_bundles_from_masks(nz, nbins, zb, len(sample),
                                   max_conflict_rate)


def build_bundled(binned: np.ndarray, plan: BundlePlan) -> np.ndarray:
    """[F, n] feature bins -> [F', n] bundle codes: uint8 while every
    bundle column has at most 256 bins, else int32 (a feature of more
    than MAX_BUNDLE_BINS bins keeps a column of its own; `GBDT.init` puts
    such codes on the device as 16-bit codes), as the JAX package's
    `build_bundled` does."""
    F, n = binned.shape
    wide = int(plan.group_num_bin.max(initial=1)) > 256
    out = np.zeros((plan.num_groups, n), np.int32 if wide else np.uint8)
    for gi, members in enumerate(plan.groups):
        if len(members) == 1:
            out[gi] = binned[members[0]]
            continue
        col = np.zeros(n, np.int32)
        for f in members:                # later members win conflicts
            nzm = binned[f] != plan.zero_bin[f]
            col[nzm] = plan.offsets[f] + binned[f][nzm]
        out[gi] = col
    return out


def decode_bundle_column(codes: np.ndarray, plan: BundlePlan, inner: int,
                         num_bin: int) -> np.ndarray:
    """Bins [n] of feature `inner` from its bundle column's codes: the
    member's range, shifted down by its offset; any code outside it
    means the feature's default bin."""
    off = int(plan.offsets[inner])
    if off == 0:                         # singleton bundle: codes are bins
        return codes
    local = codes.astype(np.int32) - off
    return np.where((local >= 0) & (local < num_bin), local,
                    int(plan.zero_bin[inner]))
