"""Distributed training over torch.distributed (PyTorch port of
`lightgbm_tpu/parallel/`).

The port's replacement for src/network/ (socket/MPI collectives, ref:
network.h:89-275) and the data-parallel tree learner (ref:
data_parallel_tree_learner.cpp): one process per rank, each holding its
rows on its device, all-reducing the engines' integer histograms
(`data_parallel.py`).  The feature- and voting-parallel learners and the
elastic shrink wait for ROADMAP Queue 1 item 15.
"""

from .binning import merged_bin_mappers, sample_rows
from .data_parallel import (DATA_LEARNERS, Network, RowShard, backend_for,
                            current_network, exact_sum, rank_device)
from .elastic import ReshardPlan, ShardSegment, reshard_plan, rows_of

__all__ = [
    "merged_bin_mappers", "sample_rows", "DATA_LEARNERS", "Network",
    "RowShard", "backend_for", "current_network", "exact_sum",
    "rank_device", "ReshardPlan", "ShardSegment", "reshard_plan", "rows_of"]
