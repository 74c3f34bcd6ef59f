"""Distributed binning for multi-host data loading (PyTorch port of
`lightgbm_tpu/parallel/binning.py`, NumPy only).

The reference shards bin-FINDING across ranks and allgathers the bin
mappers (ref: dataset_loader.cpp:1070 ConstructBinMappersFromTextData:
rank k finds bins for its feature block, then Network::Allgather merges
the serialized mappers).  The natural equivalent here is
sample-replicated binning: each host samples its local row shard, the small samples are allgathered
(bin_construct_sample_cnt rows total), and every host computes IDENTICAL
mappers deterministically from the merged sample — no mapper
serialization, and cross-rank determinism holds by construction (the
property the reference's SyncUpGlobalBestSplit relies on downstream).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..io.binning import (BIN_NUMERICAL, BinMapper,
                          prep_find_bin_values)


def sample_rows(X_local: np.ndarray, sample_cnt: int,
                seed: int = 1) -> np.ndarray:
    """Per-host row sample (ref: dataset_loader.cpp:1022
    SampleTextDataFromFile)."""
    n = X_local.shape[0]
    if n <= sample_cnt:
        return np.asarray(X_local)
    rng = np.random.RandomState(seed)
    return np.asarray(X_local)[rng.choice(n, sample_cnt, replace=False)]


def merged_bin_mappers(local_samples: Sequence[np.ndarray],
                       max_bin: int = 255, min_data_in_bin: int = 3,
                       bin_types: Sequence[int] = None,
                       **find_kwargs) -> List[BinMapper]:
    """Bin mappers every rank agrees on, from the allgathered per-host
    samples.  `local_samples` stands in for the result of an all_gather
    over hosts (in-process here; `Network.all_gather_rows` of
    parallel/data_parallel.py in a real multi-host job).  `bin_types` gives each
    feature's BIN_NUMERICAL/BIN_CATEGORICAL type (numerical default)."""
    merged = np.concatenate([np.asarray(s, np.float64)
                             for s in local_samples], axis=0)
    total = merged.shape[0]
    mappers = []
    for f in range(merged.shape[1]):
        col = merged[:, f]
        btype = (bin_types[f] if bin_types is not None else BIN_NUMERICAL)
        vals = (prep_find_bin_values(col) if btype == BIN_NUMERICAL
                else col)
        m = BinMapper()
        m.find_bin(vals, total, max_bin,
                   min_data_in_bin=min_data_in_bin,
                   bin_type=btype, **find_kwargs)
        mappers.append(m)
    return mappers
