"""PyTorch port: device binning (`io/device_bin.py`) against the JAX
package's and against the host bins, on the CPU.

The same bin mappers (built by both packages from one float64 matrix,
and checked equal) bin a float32 evaluation matrix that holds NaN, ±0,
±inf, denormals, ties, and every finite bound with its float32
neighbours.  The port's device pass, the JAX package's and the host
`values_to_bins` must give the same codes, exactly, under each missing
type.  Then the Dataset and GBDT.init wiring: a device-binned dataset
trains the same trees as a host-binned one.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu.io.dataset import Dataset as JDataset
from lightgbm_tpu.io.device_bin import (bin_matrix_device as jbin_matrix,
                                        bounds_to_f32_floor as jfloor)
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.io import dataset as tdataset
from lightgbm_tpu_torch.io.dataset import Dataset as TDataset
from lightgbm_tpu_torch.io.device_bin import (bin_matrix_device,
                                              bounds_to_f32_floor,
                                              device_binnable)

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 6000, 6


def _fit_matrix(seed=5):
    rng = np.random.RandomState(seed)
    X = np.empty((N, F), np.float32)
    X[:, 0] = rng.randn(N)
    X[:, 1] = np.abs(rng.randn(N)) ** 1.5
    X[:, 2] = rng.rand(N)
    X[:, 3] = rng.randint(0, 10, N)          # coarse ints -> heavy ties
    X[:, 4] = rng.randn(N)
    X[rng.rand(N) < 0.1, 4] = np.nan         # NaN missing
    X[:, 5] = rng.randn(N) * 1e-3
    X[rng.rand(N) < 0.3, 5] = 0.0            # zero-heavy
    return X


def _eval_matrix(X, mappers, used):
    """X plus rows that put every finite float64 bound of every feature,
    its float32 floor and that floor's float32 neighbours, ±0, ±inf,
    NaN and denormals in each column."""
    extra = []
    for i, f in enumerate(used):
        ub = np.asarray(mappers[f].bin_upper_bound, np.float64)
        ub = ub[np.isfinite(ub)]
        b32 = bounds_to_f32_floor(ub)
        vals = np.concatenate([
            ub.astype(np.float32), b32,
            np.nextafter(b32, np.float32(np.inf)),
            np.nextafter(b32, np.float32(-np.inf)),
            np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                      1e-36, -1e-36, 3e38, -3e38], np.float32)])
        block = X[:len(vals)].copy()
        block[:, f] = vals
        extra.append(block)
    return np.ascontiguousarray(np.concatenate([X] + extra), np.float32)


@pytest.mark.parametrize("missing", ["nan", "zero", "none"])
def test_device_bins_match_jax_and_host(missing):
    X = _fit_matrix()
    kw = {"nan": {}, "zero": {"zero_as_missing": True},
          "none": {"use_missing": False}}[missing]
    X64 = X.astype(np.float64)
    if missing == "zero":
        X64 = np.nan_to_num(X64)
    dj = JDataset.construct_from_arrays(X64, label=np.zeros(N), **kw)
    dt = TDataset.construct_from_arrays(X64, label=np.zeros(N),
                                        device_type="cpu", **kw)
    # repr: the NaN bound of a NaN-missing mapper compares unequal
    assert (repr([m.to_dict() for m in dj.bin_mappers])
            == repr([m.to_dict() for m in dt.bin_mappers]))
    want = {"nan": 2, "zero": 1, "none": 0}[missing]
    assert any(dt.bin_mappers[f].missing_type == want
               for f in dt.used_features)
    used = dt.used_features
    Xe = _eval_matrix(X, dt.bin_mappers, used)
    host = np.stack([dt.bin_mappers[f].values_to_bins(
        Xe[:, f].astype(np.float64)) for f in used])
    port = bin_matrix_device(Xe, dt.bin_mappers, used, "cpu", chunk=4096)
    assert port.dtype == torch.uint8 and port.device.type == "cpu"
    assert port.shape == (len(used), Xe.shape[0])
    jax_bins = np.asarray(jbin_matrix(Xe, dj.bin_mappers, used,
                                      chunk=4096))
    np.testing.assert_array_equal(port.numpy().astype(np.int32), host)
    np.testing.assert_array_equal(port.numpy(), jax_bins)


def test_bounds_floor_matches_jax():
    rng = np.random.RandomState(3)
    b = np.concatenate([rng.randn(500) * 10 ** rng.uniform(-40, 38, 500),
                        [0.0, -0.0, 1e-35, -1e-35, np.inf, -np.inf, 0.1,
                         np.float64(np.float32(0.1))]])
    np.testing.assert_array_equal(bounds_to_f32_floor(b), jfloor(b))
    f32 = bounds_to_f32_floor(b)
    fin = np.isfinite(b)
    assert (f32[fin].astype(np.float64) <= b[fin]).all()


def test_device_binnable_gate():
    X = np.random.RandomState(0).randn(2000, 3)
    ds = TDataset.construct_from_arrays(X, label=np.zeros(2000),
                                        device_type="cpu")
    m, u = ds.bin_mappers, ds.used_features
    assert device_binnable(m, u, np.float32, 1 << 20, "cuda")
    # float64 data keeps the host pass (its comparisons need the mantissa)
    assert not device_binnable(m, u, np.float64, 1 << 22, "cuda")
    # small n stays on the host
    assert not device_binnable(m, u, np.float32, 2000, "cuda")
    # a CPU dataset never takes the device pass
    assert not device_binnable(m, u, np.float32, 1 << 22, "cpu")
    Xc = X.copy()
    Xc[:, 0] = np.abs(np.round(Xc[:, 0] * 3))
    dc = TDataset.construct_from_arrays(Xc, label=np.zeros(2000),
                                        categorical_feature=[0],
                                        device_type="cpu")
    assert not device_binnable(dc.bin_mappers, dc.used_features,
                               np.float32, 1 << 22, "cuda")


def test_large_float32_on_cuda_dataset_needs_the_card(monkeypatch):
    """A card dataset whose data passes the gate bins on the card: with
    no card it raises instead of binning on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((1 << 20, 1), np.float32)
    X[::3, 0] = 1.0
    with pytest.raises(RuntimeError, match="CUDA"):
        TDataset.construct_from_arrays(X, label=np.zeros(1 << 20))


PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_growth_strategy": "wave", "device_type": "cpu"}


def test_device_binned_dataset_trains_the_same_trees(monkeypatch):
    """Dataset -> device second pass -> GBDT.init pads the device bins on
    the device and plans EFB from the sample rows: the trees equal those
    of the host-binned dataset."""
    X = _fit_matrix(seed=8)
    X = np.nan_to_num(X[:4096])
    rng = np.random.RandomState(2)
    y = (X[:, 0] + X[:, 2] + rng.randn(4096) * 0.3 > 0.5).astype(np.float32)
    host = tlgb.train(PARAMS, tlgb.Dataset(X, label=y), num_boost_round=3)
    monkeypatch.setattr(tdataset, "device_binnable",
                        lambda *a, **k: True)
    ds = tlgb.Dataset(X, label=y, params=PARAMS)
    core = ds.construct()._core
    assert isinstance(core.binned, torch.Tensor)
    assert core._efb_sample_raw is not None
    dev = tlgb.train(PARAMS, ds, num_boost_round=3)
    g = dev._gbdt
    assert core._efb_sample_bins is not None     # EFB planned from them
    assert core.binned is g.binned_dev           # padded in place, no pull
    np.testing.assert_array_equal(core.binned_host(),
                                  host._gbdt.train_data.binned_host())
    assert dev.model_to_string() == host.model_to_string()
