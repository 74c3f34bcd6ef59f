"""Batch inference on the card (PyTorch port of `lightgbm_tpu/inference/`).

A trained ensemble is packed into flat per-node arrays (pack.py) and
evaluated by a tensor traversal over all [rows x trees] at once
(traverse.py), with request batches padded to a bucket ladder
(predictor.py).  `GBDT.predict` routes here behind the `device_predict`
parameter; for float32 inputs the routing (leaf ids) is bit-identical to
the host predictors, because thresholds are floored to float32.
"""

from .pack import PackedEnsemble, pack_ensemble
from .predictor import DevicePredictor

__all__ = ["DevicePredictor", "PackedEnsemble", "pack_ensemble"]
