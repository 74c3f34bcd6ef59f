"""PyTorch port: batch prediction against the JAX package, on the CPU.

Models are trained by the JAX package (<= 10 trees, <= 31 leaves, <=
2,000 rows) and carried across by model text.  The JAX side runs its
DevicePredictor (`device_predict=true`, on the CPU) and its native
predictor.  What must hold:
  * the packed ensemble: every array equal to the JAX package's;
  * leaf ids: bit-identical to the JAX DevicePredictor and to both
    native predictors on float32 inputs (NaN, ±0, denormals, every
    threshold and its float32 neighbours, negative and huge
    categories) and on lossless float64 (served); lossy float64 takes
    the host path;
  * raw scores: within `2·T·2^-24·Σ_t|leaf value|` of the float64 host
    sum of each row (float32 leaf values, float32 sums); early stopping
    bit-identical to the JAX DevicePredictor's (same float32 sums in the
    same order, so the same done masks);
  * routing: `auto` on the CPU takes the host path, `true` the torch
    traversal; the bucket ladder and the native predictor's output equal
    the JAX package's.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
from lightgbm_tpu.inference import DevicePredictor as JDevicePredictor
from lightgbm_tpu.inference import pack_ensemble as jpack_ensemble
from lightgbm_tpu.native import PackedPredictor as JPackedPredictor
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.boosting.model_io import load_model_from_string
from lightgbm_tpu_torch.inference import DevicePredictor, pack_ensemble
from lightgbm_tpu_torch.io.device_bin import bounds_to_f32_floor
from lightgbm_tpu_torch.native import (PackedPredictor, predict_batch_native,
                                       predictor_lib)

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _mk_xy(n, seed=0, cats=True):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n) < 0.15, 0] = np.nan            # NaN missing
    X[:, 4] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 4])  # zeros
    if cats:
        X[:, 5] = rng.randint(0, 12, n)          # categorical
    y = ((np.nan_to_num(X[:, 0]) + X[:, 1] > 0)
         | (X[:, 5] % 4 == 1)).astype(np.float32)
    return X, y


def _train_jax(params, X, y, rounds=6, **dskw):
    p = dict(objective="binary", num_leaves=15, verbosity=-1, metric="none",
             min_data_in_leaf=5, device_predict="false")
    p.update(params)
    bst = jlgb.train(p, jlgb.Dataset(X, label=y, **dskw),
                     num_boost_round=rounds)
    bst._gbdt._sync_model()
    return bst


class Model:
    """One JAX-trained model and its text, loaded in both packages."""

    def __init__(self, bst, X):
        self.X = X
        self.text = bst.model_to_string()
        self.jax = jlgb.Booster(model_str=self.text)
        self.port = tlgb.Booster(model_str=self.text,
                                 params={**CPU, "device_predict": "true"})

    @property
    def jtrees(self):
        return self.jax._gbdt.models_

    @property
    def ttrees(self):
        return self.port._gbdt.models_


@pytest.fixture(scope="module")
def binary_cat():
    X, y = _mk_xy(1500)
    return Model(_train_jax({}, X, y, categorical_feature=[5]), X)


@pytest.fixture(scope="module")
def zero_missing():
    X, y = _mk_xy(1000, seed=11, cats=False)
    X = np.nan_to_num(X)
    return Model(_train_jax({"zero_as_missing": True, "use_missing": True},
                            X, y), X)


@pytest.fixture(scope="module")
def multiclass():
    X, _ = _mk_xy(1200, seed=3, cats=False)
    y = np.random.RandomState(5).randint(0, 3, 1200).astype(np.float32)
    return Model(_train_jax({"objective": "multiclass", "num_class": 3,
                             "num_leaves": 8}, X, y, rounds=3), X)


@pytest.fixture(scope="module")
def rf():
    X, y = _mk_xy(1200, seed=21, cats=False)
    return Model(_train_jax({"boosting": "rf", "bagging_fraction": 0.7,
                             "bagging_freq": 1}, X, y, rounds=5), X)


@pytest.fixture
def model(request):
    return request.getfixturevalue(request.param)


def _test_points(trees, seed=9):
    """Adversarial float32 rows: NaN, ±0, denormals, values below the zero
    threshold, huge values, negative / fractional / huge categories, and
    every numerical threshold of the model with its float32 floor and
    that floor's two float32 neighbours."""
    X, _ = _mk_xy(300, seed=seed)
    X[:7, 5] = [-3, -0.5, 0, 31, 64, 1e7, 2.5e9]
    X[7, 2], X[8, 2] = np.float32(1e30), -np.float32(1e30)
    X[9, 4], X[10, 4], X[11, 4] = 1e-36, -0.0, 0.0
    X[12, 3], X[13, 3] = 1e-40, -1e-40                 # denormals
    X[14, 1], X[15, 1] = np.inf, -np.inf
    rows = []
    for t in trees:
        ni = t.num_leaves - 1
        for i in range(ni):
            if t.decision_type[i] & 1:                  # categorical
                continue
            f = int(t.split_feature[i])
            thr = np.asarray([t.threshold[i]])
            b32 = bounds_to_f32_floor(thr)
            for v in (thr.astype(np.float32), b32,
                      np.nextafter(b32, np.float32(np.inf)),
                      np.nextafter(b32, np.float32(-np.inf))):
                r = X[len(rows) % len(X)].copy()
                r[f] = v[0]
                rows.append(r)
    return np.ascontiguousarray(np.concatenate([X, np.stack(rows)]),
                                np.float32)


def _port_dp(m):
    g = m.port._gbdt
    obj = g.objective
    return DevicePredictor(m.ttrees, num_class=g.num_tree_per_iteration,
                           average=g.average_output_,
                           convert=obj.convert_output if obj else None,
                           min_bucket=256, device="cpu")


def _jax_dp(m):
    g = m.jax._gbdt
    obj = g.objective
    return JDevicePredictor(m.jtrees, num_class=g.num_tree_per_iteration,
                            average=g.average_output_,
                            convert=obj.convert_output if obj else None,
                            min_bucket=256)


def _score_bound(trees, leaf, K):
    """Per row and class: 2·T·2^-24·Σ_t|leaf value| over the row's trees
    of that class."""
    T = len(trees)
    absv = np.stack([np.abs(t.leaf_value[leaf[:, i]])
                     for i, t in enumerate(trees)], axis=1)
    per_class = absv.reshape(len(leaf), T // K, K).sum(axis=1)
    return 2.0 * T * 2.0 ** -24 * per_class


# ----------------------------------------------------------------- pack
@pytest.mark.parametrize("model", ["binary_cat", "zero_missing",
                                   "multiclass"], indirect=True)
def test_pack_matches_jax(model):
    tp, jp = pack_ensemble(model.ttrees), jpack_ensemble(model.jtrees)
    for name in tp._fields:
        a, b = getattr(tp, name), getattr(jp, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def test_pack_holds_categorical_and_missing_nodes(binary_cat, zero_missing):
    tp = pack_ensemble(binary_cat.ttrees)
    assert tp.is_cat.any() and (tp.missing_type == 2).any()
    assert (pack_ensemble(zero_missing.ttrees).missing_type == 1).any()


# ------------------------------------------------------------- leaf ids
@pytest.mark.parametrize("model", ["binary_cat", "zero_missing",
                                   "multiclass", "rf"], indirect=True)
def test_leaf_ids_match_jax_and_native(model):
    Xt = _test_points(model.ttrees)
    leaf = _port_dp(model).predict_leaf(Xt)
    assert leaf.dtype == np.int32 and leaf.shape == (len(Xt),
                                                     len(model.ttrees))
    np.testing.assert_array_equal(leaf, _jax_dp(model).predict_leaf(Xt))
    X64 = Xt.astype(np.float64)
    np.testing.assert_array_equal(
        leaf, PackedPredictor(model.ttrees).predict_leaf(X64))
    np.testing.assert_array_equal(
        leaf, JPackedPredictor(model.jtrees).predict_leaf(X64))


def test_float64_inputs_route_by_losslessness(binary_cat, monkeypatch):
    """Lossless float64 is downcast and served by the traversal; lossy
    float64 takes the host path (`float64-lossy`)."""
    g = binary_cat.port._gbdt
    reasons = []
    monkeypatch.setattr(GBDT, "_host_fallback",
                        lambda self, r: reasons.append(r))
    X64 = _test_points(binary_cat.ttrees).astype(np.float64)
    dp, X32 = g._device_predictor(X64, 0, -1)
    assert X32.dtype == np.float32
    before = DevicePredictor.dispatches["cpu"]
    np.testing.assert_array_equal(
        binary_cat.port.predict(X64, pred_leaf=True),
        JPackedPredictor(binary_cat.jtrees).predict_leaf(X64))
    assert DevicePredictor.dispatches["cpu"] == before + 1
    X64[0, 1] = 0.1                  # not representable in float32
    assert g._device_predictor(X64, 0, -1) is None
    np.testing.assert_array_equal(
        binary_cat.port.predict(X64, raw_score=True),
        JPackedPredictor(binary_cat.jtrees).predict(X64, 1, False)[:, 0])
    assert DevicePredictor.dispatches["cpu"] == before + 1
    assert reasons == ["float64-lossy"] * 2


# --------------------------------------------------------------- scores
@pytest.mark.parametrize("model", ["binary_cat", "multiclass", "rf"],
                         indirect=True)
def test_raw_scores_within_bound(model):
    Xt = _test_points(model.ttrees)
    K = model.port._gbdt.num_tree_per_iteration
    dp = _port_dp(model)
    raw = dp.predict_raw(Xt).reshape(len(Xt), K)
    host = model.jax._gbdt._predict_raw_impl(
        Xt.astype(np.float64), 0, -1, False, 10, 10.0).reshape(len(Xt), K)
    bound = _score_bound(model.ttrees, dp.predict_leaf(Xt), K)
    if model.port._gbdt.average_output_:
        bound = bound / (len(model.ttrees) // K)
    assert (np.abs(raw - host) <= bound).all()
    jraw = _jax_dp(model).predict_raw(Xt).reshape(len(Xt), K)
    assert (np.abs(raw - jraw) <= 2 * bound).all()


def test_converted_scores_within_bound(binary_cat):
    Xt = _test_points(binary_cat.ttrees)
    dp = _port_dp(binary_cat)
    pred = dp.predict(Xt)
    host = binary_cat.jax.predict(Xt.astype(np.float64))
    bound = _score_bound(binary_cat.ttrees, dp.predict_leaf(Xt), 1)[:, 0]
    # the sigmoid's slope is at most 1/4; float32 rounds the result
    assert (np.abs(pred - host) <= bound / 4 + 2.0 ** -23).all()
    assert ((pred >= 0) & (pred <= 1)).all()


@pytest.mark.parametrize("model,freq,margin", [
    ("binary_cat", 2, 0.2), ("binary_cat", 3, 1.5),
    ("multiclass", 1, 0.02)], indirect=["model"])
def test_early_stop_matches_jax_exactly(model, freq, margin):
    """The masked accumulation adds the same float32 leaf values in the
    same order as JAX's scan, so scores and done masks are identical."""
    Xt = _test_points(model.ttrees)
    es = _port_dp(model).predict_raw(Xt, early_stop=(freq, margin))
    np.testing.assert_array_equal(
        es, _jax_dp(model).predict_raw(Xt, early_stop=(freq, margin)))
    plain = _port_dp(model).predict_raw(Xt)
    assert not np.allclose(es, plain)            # some rows stopped
    # and the Booster route reaches the same masked accumulation
    np.testing.assert_array_equal(
        es, model.port.predict(Xt, raw_score=True, pred_early_stop=True,
                               pred_early_stop_freq=freq,
                               pred_early_stop_margin=margin))


def test_early_stop_huge_margin_stops_nobody(binary_cat):
    Xt = _test_points(binary_cat.ttrees)
    dp = _port_dp(binary_cat)
    np.testing.assert_array_equal(dp.predict_raw(Xt, early_stop=(2, 1e9)),
                                  dp.predict_raw(Xt))


# -------------------------------------------------------------- routing
def test_auto_on_cpu_takes_the_host_path(binary_cat):
    b = tlgb.Booster(model_str=binary_cat.text, params=CPU)
    Xt = _test_points(binary_cat.ttrees)
    before = dict(DevicePredictor.dispatches)
    raw = b.predict(Xt, raw_score=True)
    leaf = b.predict(Xt, pred_leaf=True)
    assert dict(DevicePredictor.dispatches) == before
    X64 = Xt.astype(np.float64)
    np.testing.assert_array_equal(
        raw, JPackedPredictor(binary_cat.jtrees).predict(X64, 1, False)[:, 0])
    np.testing.assert_array_equal(
        leaf, JPackedPredictor(binary_cat.jtrees).predict_leaf(X64))


def test_true_on_cpu_takes_the_traversal(binary_cat):
    """The slice end to end: Booster.predict with device_predict=true on
    the CPU gives the JAX Booster's device leaf ids and scores."""
    Xt = _test_points(binary_cat.ttrees)
    before = DevicePredictor.dispatches["cpu"]
    leaf = binary_cat.port.predict(Xt, pred_leaf=True)
    pred = binary_cat.port.predict(Xt)
    raw = binary_cat.port.predict(Xt, raw_score=True)
    assert DevicePredictor.dispatches["cpu"] == before + 3
    jb = jlgb.Booster(model_str=binary_cat.text)
    jb._gbdt.config.device_predict = "true"
    np.testing.assert_array_equal(leaf, jb.predict(Xt, pred_leaf=True))
    bound = _score_bound(binary_cat.ttrees, leaf, 1)[:, 0]
    assert (np.abs(raw - jb.predict(Xt, raw_score=True)) <= 2 * bound).all()
    assert (np.abs(pred - jb.predict(Xt)) <= bound / 2 + 2.0 ** -23).all()


def test_loaded_booster_defaults_to_the_card(binary_cat, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlgb.Booster(model_str=binary_cat.text)
    b = tlgb.Booster(model_str=binary_cat.text, params=CPU)
    assert b._gbdt.config.device_type == "cpu"
    assert b._gbdt.config.device_predict == "auto"
    assert b._gbdt.config.objective == "binary"   # the rest from the text


def test_device_predictor_defaults_to_the_card(binary_cat, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePredictor(binary_cat.ttrees)


def test_pred_contrib_names_its_item(binary_cat):
    """Contributions are ported (this test named their refusal before):
    the port's equal the JAX package's TreeSHAP of the same trees (its
    native library, its scratch sized for the leaf depths a loaded tree
    lacks), and each row sums to the float64 host raw score."""
    from lightgbm_tpu.native import tree_shap
    X = binary_cat.X[:64]
    got = binary_cat.port.predict(X, pred_contrib=True)
    want = np.zeros((64, X.shape[1] + 1))
    Xd = np.asarray(X, np.float64)
    for t in binary_cat.jtrees:
        t.leaf_depth[:t.num_leaves] = t.num_leaves    # its scratch's size
        tree_shap(t, Xd, want)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    host = binary_cat.port._gbdt._predict_raw_impl(Xd, 0, -1, False, 10,
                                                   10.0)
    np.testing.assert_allclose(got.sum(1), host, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("min_bucket", [256, 4096, 5])
def test_bucket_ladder_matches_jax(binary_cat, min_bucket):
    tdp = DevicePredictor(binary_cat.ttrees, min_bucket=min_bucket,
                          device="cpu")
    jdp = JDevicePredictor(binary_cat.jtrees, min_bucket=min_bucket)
    for n in (1, 7, 8, 255, 256, 257, 1000, 4096, 4097, 100_000,
              1_000_000):
        assert tdp.bucket_rows(n) == jdp.bucket_rows(n)


def test_warmup_and_release_device(binary_cat):
    dp = _port_dp(binary_cat)
    before = DevicePredictor.dispatches["cpu"]
    assert dp.warmup(6, 600) == 3 * 2           # buckets 256, 512, 1024
    assert DevicePredictor.dispatches["cpu"] == before + 6
    Xt = binary_cat.X[:50]
    a = dp.predict(Xt)
    dp.release_device()
    assert dp._dev is None
    np.testing.assert_array_equal(dp.predict(Xt), a)


def test_fallback_keys(binary_cat, monkeypatch):
    reasons = []
    monkeypatch.setattr(GBDT, "_host_fallback",
                        lambda self, r: reasons.append(r))
    g = binary_cat.port._gbdt
    X = binary_cat.X[:20]
    assert g._device_predictor(X, 100, -1) is None       # empty slice
    X64 = X.astype(np.float64)
    X64[0, 1] = 1 / 3
    assert g._device_predictor(X64, 0, -1) is None
    assert g._device_predictor(np.nan_to_num(X).astype(np.int32), 0,
                               -1) is None
    assert reasons == ["empty-slice", "float64-lossy", "non-float-input"]


def test_linear_tree_takes_the_host_path(monkeypatch):
    X, y = _mk_xy(600, seed=31, cats=False)
    X = np.nan_to_num(X)
    bst = _train_jax({"linear_tree": True, "objective": "regression"}, X,
                     y, rounds=2)
    text = bst.model_to_string()
    b = tlgb.Booster(model_str=text,
                     params={**CPU, "device_predict": "true"})
    assert pack_ensemble(b._gbdt.models_) is None
    reasons = []
    monkeypatch.setattr(GBDT, "_host_fallback",
                        lambda self, r: reasons.append(r))
    before = dict(DevicePredictor.dispatches)
    np.testing.assert_allclose(b.predict(X[:64]), bst.predict(X[:64]),
                               rtol=0, atol=1e-12)
    assert reasons == ["linear-tree"]
    assert dict(DevicePredictor.dispatches) == before


# --------------------------------------------------------------- native
def test_native_predictor_builds():
    assert predictor_lib() is not None


@pytest.mark.parametrize("model", ["binary_cat", "multiclass", "rf"],
                         indirect=True)
def test_native_equals_jax_native(model):
    X64 = _test_points(model.ttrees).astype(np.float64)
    g = model.port._gbdt
    K, avg = g.num_tree_per_iteration, g.average_output_
    native = PackedPredictor(model.ttrees).predict(X64, K, avg)
    np.testing.assert_array_equal(
        native, JPackedPredictor(model.jtrees).predict(X64, K, avg))
    np.testing.assert_array_equal(
        native, predict_batch_native(model.ttrees, X64, K, avg))
    host = tlgb.Booster(model_str=model.text, params={
        **CPU, "device_predict": "false"})._gbdt
    jg = model.jax._gbdt
    iters = len(model.ttrees) // K
    for start, num in ((0, -1), (1, -1), (0, 2), (1, 1), (iters - 1, 5)):
        np.testing.assert_array_equal(
            host.predict_raw(X64, start, num),
            jg.predict_raw(X64, start, num), err_msg=f"{start}, {num}")
        np.testing.assert_array_equal(
            host.predict_leaf_index(X64, start, num),
            jg.predict_leaf_index(X64, start, num))


def test_native_cache_follows_growth_and_mutation():
    X, y = _mk_xy(2000, seed=4, cats=False)
    X = np.nan_to_num(X)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "tpu_growth_strategy": "wave", **CPU}
    b = tlgb.train(params, tlgb.Dataset(X, label=y), num_boost_round=3)
    g = b._gbdt
    X64 = X.astype(np.float64)
    three = g.predict_raw(X64)
    b.update()
    four = g.predict_raw(X64)
    assert not np.array_equal(three, four)
    jb = jlgb.Booster(model_str=b.model_to_string())
    np.testing.assert_array_equal(four, jb._gbdt.predict_raw(X64))
    # an in-place leaf change needs the mutation count to repack
    g.models_[0].leaf_value[0] += 1.0
    g._bump_model_mutations()
    leaf0 = g.predict_leaf_index(X64)[:, 0] == 0
    np.testing.assert_allclose(g.predict_raw(X64) - four, leaf0 * 1.0,
                               rtol=0, atol=1e-12)
    g.config.device_predict = "true"
    dev = g.predict_raw(X)
    assert (np.abs(dev - g._predict_raw_impl(X64, 0, -1, False, 10, 10.0))
            < 1e-5).all()


def test_single_row_fast_equals_batch(binary_cat):
    g = binary_cat.port._gbdt
    X64 = _test_points(binary_cat.ttrees).astype(np.float64)
    sp = g.make_single_row_fast(X64.shape[1])
    batch = g._predict_raw_impl(X64, 0, -1, False, 10, 10.0)
    conv = g.objective.convert_output_host(batch)
    for r in (0, 5, 17, len(X64) - 1):
        np.testing.assert_array_equal(sp.predict(X64[r]), conv[r:r + 1])


# ----------------------------------------------------- module level (K>1)
def test_multiclass_module_level_from_text(multiclass):
    """Trees parsed from JAX text at module level (a loaded multiclass
    Booster needs item 14's objectives): K = 3 leaf ids and raw scores."""
    trees = load_model_from_string(multiclass.text).models_
    Xt = multiclass.X[:300]
    dp = DevicePredictor(trees, num_class=3, min_bucket=256, device="cpu")
    leaf = dp.predict_leaf(Xt)
    np.testing.assert_array_equal(leaf, _jax_dp(multiclass).predict_leaf(Xt))
    raw = dp.predict_raw(Xt)
    assert raw.shape == (300, 3)
    host = JPackedPredictor(multiclass.jtrees).predict(
        Xt.astype(np.float64), 3, False)
    assert (np.abs(raw - host) <= _score_bound(trees, leaf, 3)).all()

