"""PyTorch port: the user surface on the card (chip_smoke.py's `surface`
phase at 65,536 rows).  These tests skip without a CUDA device.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_surface_cuda.py

Every predict here goes through the card's traversal and must advance
its dispatch count.  A raw score is held to 2·T·2^-24·Σ_t|leaf value|
of another float32 sum of the same leaves (the README's bound).
"""

import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.inference import DevicePredictor

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 65_536, 28
PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 255,
          "verbosity": -1}
DELTA = 1.0


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    y = (rng.rand(n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def booster():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y = _data()
    return tlgb.train(PARAMS, tlgb.Dataset(X, label=y), 8), X, y


def _on_card(fn):
    before = DevicePredictor.dispatches["cuda"]
    out = fn()
    assert DevicePredictor.dispatches["cuda"] == before + 1
    return out


def _bound(b, leaf):
    sum_abs = np.zeros(leaf.shape[0])
    for t, tree in enumerate(b._gbdt.models_):
        sum_abs += np.abs(tree.leaf_value[leaf[:, t]])
    return 2.0 * leaf.shape[1] * 2.0 ** -24 * sum_abs


@pytest.mark.cuda
def test_pickle_round_trip_on_the_card(booster):
    b, X, _ = booster
    raw = _on_card(lambda: b.predict(X, raw_score=True))
    restored = pickle.loads(pickle.dumps(b))
    assert restored._gbdt.device.type == "cuda"
    assert restored._gbdt.config.device_predict == "auto"
    assert restored.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(
        _on_card(lambda: restored.predict(X, raw_score=True)), raw)


@pytest.mark.cuda
def test_set_leaf_output_reaches_the_card(booster):
    b, X, _ = booster
    raw = _on_card(lambda: b.predict(X, raw_score=True))
    leaf = b.predict(X, pred_leaf=True)
    target = int(np.bincount(leaf[:, 0]).argmax())
    in_leaf = leaf[:, 0] == target
    v = b.get_leaf_output(0, target)
    bound = _bound(b, leaf)
    b.set_leaf_output(0, target, v + DELTA)
    try:
        moved = _on_card(lambda: b.predict(X, raw_score=True))
        bound = bound + _bound(b, leaf)
    finally:
        b.set_leaf_output(0, target, v)
    np.testing.assert_array_equal(moved[~in_leaf], raw[~in_leaf])
    err = np.abs(moved[in_leaf].astype(np.float64) - raw[in_leaf] - DELTA)
    assert (err <= bound[in_leaf]).all()
    np.testing.assert_array_equal(
        _on_card(lambda: b.predict(X, raw_score=True)), raw)


@pytest.mark.cuda
def test_shuffle_models_reaches_the_card(booster):
    b, X, _ = booster
    raw = _on_card(lambda: b.predict(X, raw_score=True))
    bound = _bound(b, b.predict(X, pred_leaf=True))
    text = b.model_to_string()
    copy = pickle.loads(pickle.dumps(b))
    copy.shuffle_models()
    assert copy.model_to_string() != text
    shuffled = _on_card(lambda: copy.predict(X, raw_score=True))
    assert (np.abs(shuffled.astype(np.float64) - raw) <= bound).all()
    copy.model_from_string(text)
    np.testing.assert_array_equal(
        _on_card(lambda: copy.predict(X, raw_score=True)), raw)


@pytest.mark.cuda
def test_estimator_on_the_card(booster):
    b, X, y = booster
    clf = tlgb.LGBMClassifier(n_estimators=8, num_leaves=63, max_bin=255)
    clf.fit(X, y)
    assert clf.booster_._gbdt.device.type == "cuda"
    est, ref = clf.booster_.model_to_string(), b.model_to_string()
    cut = "end of trees"
    assert est[est.index("Tree=0"):est.index(cut)] == \
        ref[ref.index("Tree=0"):ref.index(cut)]
    proba = _on_card(lambda: clf.predict_proba(X))
    restored = pickle.loads(pickle.dumps(clf))
    np.testing.assert_array_equal(
        _on_card(lambda: restored.predict_proba(X)), proba)
