"""Online continual learning: the closed train->serve loop (PyTorch
port of `lightgbm_tpu/online/`, the same names and files; docs/Online.md).

A `ChunkSource` sequences arriving row chunks with monotone generation
ids; the `OnlineTrainer` consumes them — boosting additional trees via
init_model continuation or refitting leaf values on the fresh chunk —
checkpoints every generation through the CheckpointManager (byte-exact
SIGTERM/crash resume; the directory layout is the JAX package's, so
either package resumes the other's), and publishes each generation
atomically into serving (local ModelRegistry hot swap, in-process
Router rolling/canary rollout, or `op=publish` over the wire) while the
previous generation keeps serving.  The freshness plane measures
`model_freshness_lag_s` (chunk arrival -> first request served by a
model that saw it) against the `online_max_lag_s` SLO.

Each generation's `train()`, refit and the serving daemon run on the
device named by `device_type`: the card unless the caller asks for the
CPU.  `python -m lightgbm_tpu_torch train-and-serve` is the CLI front
end.
"""

from .chunks import (Chunk, ChunkSource, DirectoryChunkSource,
                     MemoryChunkSource, write_chunk)
from .trainer import (LocalPublisher, OnlineTrainer, PublishError,
                      RouterPublisher, WirePublisher)

__all__ = [
    "Chunk", "ChunkSource", "DirectoryChunkSource", "MemoryChunkSource",
    "write_chunk",
    "LocalPublisher", "OnlineTrainer", "PublishError", "RouterPublisher",
    "WirePublisher",
]
