"""PyTorch/CUDA port of lightgbm_tpu (LightGBM-compatible GBDT).

`train(params, Dataset(X, label=y), num_boost_round=N)` grows trees on the
wave engine with hand-written Hopper histogram kernels, and
`Booster.predict` scores rows with a tensor traversal of the ensemble.
Both run on the card unless `device_type="cpu"` is asked for.  This package imports
torch and numpy, never JAX or the JAX package.
"""

from .basic import Booster, Dataset
from .config import Config
from .engine import train

__version__ = "0.1.0"

__all__ = ["Booster", "Config", "Dataset", "train"]
