"""PyTorch/CUDA port of lightgbm_tpu (LightGBM-compatible GBDT).

`train(params, Dataset(X, label=y), num_boost_round=N, valid_sets=[...],
callbacks=[early_stopping(k), log_evaluation()])` grows trees on the
wave engine with hand-written Hopper histogram kernels, evaluates the
training metrics on the card and the validation sets on float64 host
scores, and `Booster.predict` scores rows with a tensor traversal of the
ensemble.  Everything runs on the card unless `device_type="cpu"` is
asked for.  This package imports torch and numpy, never JAX or the JAX
package.
"""

from .basic import Booster, Dataset
from .callback import (EarlyStopException, checkpoint, early_stopping,
                       log_evaluation, record_evaluation, record_metrics,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .reliability import NonFiniteError
from .utils.log import LightGBMError

__version__ = "0.1.0"

__all__ = ["Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "LightGBMError", "NonFiniteError",
           "checkpoint", "cv", "early_stopping", "log_evaluation",
           "record_evaluation", "record_metrics", "reset_parameter",
           "train"]
