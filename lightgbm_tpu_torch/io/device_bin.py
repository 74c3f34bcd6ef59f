"""Device-side second-pass binning: value -> bin for the whole matrix on
the card (PyTorch port of `lightgbm_tpu/io/device_bin.py`).

The reference extracts features into bins with a parallel C++ pass over
all rows (ref: src/io/dataset_loader.cpp:246,327 ExtractFeaturesFromMemory
under OpenMP); the host pass here is one NumPy `searchsorted` per
feature.  The device pass streams the raw float32 matrix to the card in
row chunks and bucketizes every feature of a chunk in one batched
`torch.searchsorted` against the per-feature bound rows, writing the
uint8 bin matrix on the device.

Exactness: for float32 inputs the comparison `bound < v` in float64 is
EXACTLY equivalent to `floor32(bound) < v` in float32, where floor32
rounds the float64 bound DOWN to the nearest float32 (any float32
v <= bound is also <= floor32(bound), and bound < v implies
floor32(bound) <= bound < v).  `searchsorted(side="left")` over the
ascending floored bounds counts the bounds `< v`, so the device pass
reproduces the host `np.searchsorted(bounds, v, 'left')` bin codes bit
for bit; it is only offered for float32 data (float64 inputs keep the
host pass, whose comparisons need the full mantissa).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .binning import BIN_CATEGORICAL, MISSING_NAN


def bounds_to_f32_floor(bounds64: np.ndarray) -> np.ndarray:
    """Round float64 bin bounds DOWN to float32 (see module docstring)."""
    b64 = np.asarray(bounds64, np.float64)
    b32 = b64.astype(np.float32)
    over = b32.astype(np.float64) > b64
    if over.any():
        b32[over] = np.nextafter(b32[over], np.float32(-np.inf))
    return b32


def device_binnable(mappers, used_features, data_dtype, num_data: int,
                    device_type: str = "cuda",
                    min_rows: int = 1 << 20) -> bool:
    """Gate for the device second pass: float32 data, large n, numerical
    features only, uint8-range bins, and a dataset whose device is the
    card."""
    if data_dtype != np.float32 or num_data < min_rows:
        return False
    for f in used_features:
        m = mappers[f]
        if m.bin_type == BIN_CATEGORICAL or m.num_bin > 256:
            return False
    return str(device_type).strip().lower() in ("cuda", "gpu")


def bin_matrix_device(data: np.ndarray, mappers, used_features,
                      device_type: str = "cuda",
                      chunk: int = 1 << 18) -> torch.Tensor:
    """Bin `data[:, used_features]` on `device_type`; returns a uint8
    tensor [F_used, n] on that device: the bin matrix never visits the
    host (callers needing host bins go through Dataset.binned_host()).
    The caller must have passed the `device_binnable` gate (float32
    numerical data) except for `num_data` and the device, which guard
    profitability, not correctness (the tests run this on the CPU).

    Per chunk of rows: NaN becomes 0.0 unless the feature's missing type
    is NaN, the floored bounds are searched, and NaN under missing type
    NaN takes the last bin.  `chunk` bounds the int32 search result
    ([F_used, chunk]); the batched search needs no `[chunk, F, bins]`
    compare tensor.
    """
    dev = resolve_device(device_type)
    n = data.shape[0]
    Fu = len(used_features)
    n_bounds = []
    for f in used_features:
        m = mappers[f]
        n_search = m.num_bin - (1 if m.missing_type == MISSING_NAN else 0)
        n_bounds.append(m.bin_upper_bound[:n_search - 1]
                        if n_search > 0 else np.empty(0))
    Bm = max(1, max((len(b) for b in n_bounds), default=1))
    bounds = np.full((Fu, Bm), np.inf, np.float32)
    nan_zero = np.empty(Fu, bool)
    nan_bin = np.empty(Fu, np.int32)
    for i, f in enumerate(used_features):
        m = mappers[f]
        bounds[i, :len(n_bounds[i])] = bounds_to_f32_floor(n_bounds[i])
        nan_zero[i] = m.missing_type != MISSING_NAN
        nan_bin[i] = m.num_bin - 1
    x = data if data.shape[1] == Fu else data[:, used_features]
    x = np.ascontiguousarray(x, np.float32)
    bounds_d = torch.from_numpy(bounds).to(dev)
    nan_zero_d = torch.from_numpy(nan_zero).to(dev)[:, None]
    nan_bin_d = torch.from_numpy(nan_bin).to(dev)[:, None]
    out = torch.empty((Fu, n), dtype=torch.uint8, device=dev)
    for s in range(0, n, chunk):
        xc = torch.from_numpy(x[s:s + chunk]).to(dev).t()   # [Fu, c]
        nan = torch.isnan(xc)
        xz = torch.where(nan, torch.zeros((), device=dev), xc).contiguous()
        cnt = torch.searchsorted(bounds_d, xz, side="left", out_int32=True)
        cnt = torch.where(nan & ~nan_zero_d, nan_bin_d, cnt)
        out[:, s:s + chunk] = cnt.to(torch.uint8)
    return out


def pull_host(binned: torch.Tensor) -> np.ndarray:
    """Device [F, n] -> host np.ndarray (16-bit codes, stored as int16,
    come back as their uint16 values; uint8 and int32 as they are)."""
    out = binned.cpu().numpy()
    return out.view(np.uint16) if out.dtype == np.int16 else out
