"""PyTorch/CUDA port of lightgbm_tpu (LightGBM-compatible GBDT).

`train(params, Dataset(X, label=y), num_boost_round=N, valid_sets=[...],
callbacks=[early_stopping(k), log_evaluation()])` grows trees on the
wave engine with hand-written Hopper histogram kernels, evaluates the
training metrics on the card and the validation sets on float64 host
scores, and `Booster.predict` scores rows with a tensor traversal of the
ensemble.  The scikit-learn estimators (`LGBMClassifier`, ...) and the
plotting helpers sit on the same `train` and `Booster`.  Everything runs
on the card unless `device_type="cpu"` is asked for.  This package
imports torch and numpy, never JAX or the JAX package; scikit-learn,
pandas, matplotlib and graphviz are imported only where they are used.
"""

from .basic import Booster, Dataset, Sequence
from .callback import (EarlyStopException, checkpoint, early_stopping,
                       log_evaluation, record_evaluation, record_metrics,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .reliability import NonFiniteError
from .utils.log import LightGBMError, register_callback, register_logger

__version__ = "0.1.0"

# the estimators' module imports scikit-learn when it is installed, so it
# loads on first use of one of these names
_SKLEARN_NAMES = ("LGBMClassifier", "LGBMModel", "LGBMRanker",
                  "LGBMRegressor")


def __getattr__(name):
    if name in _SKLEARN_NAMES:
        from . import sklearn
        return getattr(sklearn, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Booster", "CVBooster", "Config", "Dataset",
           "EarlyStopException", "LGBMClassifier", "LGBMModel",
           "LGBMRanker", "LGBMRegressor", "LightGBMError", "NonFiniteError",
           "Sequence", "checkpoint", "create_tree_digraph", "cv", "early_stopping",
           "log_evaluation", "plot_importance", "plot_metric",
           "plot_split_value_histogram", "plot_tree", "record_evaluation",
           "record_metrics", "register_callback", "register_logger",
           "reset_parameter", "train"]
