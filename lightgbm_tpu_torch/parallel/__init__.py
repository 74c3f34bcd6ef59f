"""Distributed training over torch.distributed (PyTorch port of
`lightgbm_tpu/parallel/`).

The port's replacement for src/network/ (socket/MPI collectives, ref:
network.h:89-275) and the data-parallel tree learner (ref:
data_parallel_tree_learner.cpp): one process per rank, each holding its
rows on its device, all-reducing the engines' integer histograms
(`data_parallel.py`); the feature-parallel learner (`ColumnBlock`: each
rank histograms and scans its block of columns, the ranks all-gather the
best splits) and the voting-parallel one (`voting.py`: PV-Tree, only the
elected features' histograms reduced); and the row plan of an elastic
shrink (`elastic.py`, which `distributed.train_distributed` reads when it
relaunches a cluster around a lost rank).
"""

from .binning import merged_bin_mappers, sample_rows
from .data_parallel import (DATA_LEARNERS, ColumnBlock, Network, RowShard,
                            backend_for, current_network, exact_sum,
                            rank_device)
from .elastic import ReshardPlan, ShardSegment, reshard_plan, rows_of
from .voting import VotingSpec, local_split_params, voting_hist_elect

__all__ = [
    "merged_bin_mappers", "sample_rows", "DATA_LEARNERS", "ColumnBlock",
    "Network", "RowShard", "backend_for", "current_network", "exact_sum",
    "rank_device", "ReshardPlan", "ShardSegment", "reshard_plan", "rows_of",
    "VotingSpec", "local_split_params", "voting_hist_elect"]
