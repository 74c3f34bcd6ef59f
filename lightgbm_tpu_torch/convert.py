"""Carry state across from the JAX package, through numpy and strings.

The JAX package is never imported here: callers hand over what it
exports (model text, bin-mapper dicts), so the two packages can be put
on identical trees and bins.
"""

from __future__ import annotations

from typing import Iterable, List, Mapping

import numpy as np

from .basic import Booster
from .io.binning import BinMapper
from .io.dataset import Dataset as _CoreDataset, Metadata


def booster_from_jax(model_str: str, params=None) -> Booster:
    """A port Booster from the JAX package's LightGBM v4 model text.
    `params` says where it predicts (`device_type`, `device_predict`);
    every other setting comes from the text."""
    return Booster(params=params, model_str=model_str)


def bin_mappers_from_jax(mappers: Iterable[Mapping]) -> List[BinMapper]:
    """Port bin mappers from the JAX Dataset's mappers, each given as its
    `to_dict()` (lists or numpy arrays)."""
    out = []
    for d in mappers:
        d = {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
             for k, v in d.items()}
        out.append(BinMapper.from_dict(d))
    return out


def dataset_with_bin_mappers(data: np.ndarray, label,
                             mappers: List[BinMapper],
                             feature_names=None) -> _CoreDataset:
    """A port core Dataset binned with the given mappers (the JAX
    dataset's, through `bin_mappers_from_jax`)."""
    data = np.asarray(data)
    ref = _CoreDataset()
    ref.num_total_features = data.shape[1]
    ref.bin_mappers = list(mappers)
    ref.used_feature_map, ref.used_features = [], []
    for f, m in enumerate(ref.bin_mappers):
        if m.is_trivial:
            ref.used_feature_map.append(-1)
        else:
            ref.used_feature_map.append(len(ref.used_features))
            ref.used_features.append(f)
    ref.feature_names = ([str(s) for s in feature_names]
                         if feature_names is not None else
                         [f"Column_{i}" for i in range(data.shape[1])])
    ref.metadata = Metadata(0)
    return _CoreDataset.construct_from_arrays(data, label=label,
                                              reference=ref)
