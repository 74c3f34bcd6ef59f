"""PyTorch port: the `Booster`, `Dataset` and `CVBooster` surface and the
plotting helpers, against the JAX package's, on the CPU.

The cases of `tests/test_api_surface.py` and `tests/test_plotting_api.py`
rewritten against the port (`Sequence` input and files:
tests/test_torch_file_io.py).  Tolerances:
- a model loaded from the same model text in both packages holds the
  same trees, so everything read from them (dumps, data frames, C++
  source, bounds, histograms, shuffled text, digraphs) is equal exactly;
- trees trained by both packages (`tpu_growth_strategy=wave` in both,
  the setup of `tests/test_torch_train.py`: 4,096 x 8, 31 leaves, 63
  bins) share their structure exactly and their leaf values within
  1e-5 (ROADMAP "Divergences": float32 leaf values stray from the exact
  sums);
- a pickled, copied or reloaded port booster predicts bit for bit as
  the live one;
- Dataset fields, bin counts and bins are equal exactly.
"""

import copy
import pickle

import matplotlib
matplotlib.use("Agg")

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu.engine as jengine
import lightgbm_tpu_torch.engine as tengine
from lightgbm_tpu_torch.inference import DevicePredictor
from lightgbm_tpu_torch.utils import log as tlog

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 4096, 8
PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_growth_strategy": "wave"}
CPU = {"device_type": "cpu"}
SMALL = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
         "min_data_in_leaf": 5, **CPU}
LEAF_ATOL = 1e-5

# methods of the JAX package's Booster and Dataset that later items
# bring, each with the item its refusal names
LEFT_TO_ITEMS = {("Booster", "refit"): "item 14",
                 ("Booster", "set_network"): "item 15",
                 ("Booster", "free_network"): "item 15"}


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    logit = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _small(n=600, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.75).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def trained():
    """The same 5 trees grown by both packages, and the JAX model's
    text."""
    X, y = _data()
    bj = jlgb.train(PARAMS, jlgb.Dataset(X, label=y), num_boost_round=5)
    bt = tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y),
                    num_boost_round=5)
    bj._gbdt._sync_model()
    return bj, bt, X, y, bj.model_to_string()


@pytest.fixture(scope="module")
def small_booster():
    X, y = _small()
    return tlgb.train(SMALL, tlgb.Dataset(X, label=y), num_boost_round=4), X


def _loaded(text):
    """The same model text loaded into both packages."""
    return (jlgb.Booster(model_str=text),
            tlgb.Booster(model_str=text, params=CPU))


def _multiclass_text():
    rng = np.random.RandomState(3)
    X = rng.randn(900, 4)
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5).astype(int)
    b = tlgb.train({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "verbosity": -1, **CPU},
                   tlgb.Dataset(X, label=y), num_boost_round=4)
    return b.model_to_string(), X


# ------------------------------------------------------------- pickling
def test_pickle_round_trip_predicts_bit_for_bit(small_booster):
    """Queue 3's fault: `pickle.dumps` of a port Booster raised on the
    binary objective's lambda.  It now goes through the model text, as
    the JAX package does, and restores in predictor mode on the device
    its params name."""
    b, X = small_booster
    restored = pickle.loads(pickle.dumps(b))
    assert restored.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(restored.predict(X), b.predict(X))
    np.testing.assert_array_equal(restored.predict(X, pred_leaf=True),
                                  b.predict(X, pred_leaf=True))
    assert restored._gbdt.device.type == "cpu"
    assert restored.params == b.params
    assert restored.best_iteration == b.best_iteration
    copied = copy.deepcopy(b)
    np.testing.assert_array_equal(copied.predict(X), b.predict(X))


def test_pickle_keeps_best_iteration_and_device_predict():
    X, y = _small()
    X = X.astype(np.float32)      # the torch traversal takes float32 rows
    params = {**SMALL, "device_predict": "true", "metric": "auc"}
    b = tlgb.train(params, tlgb.Dataset(X[:400], label=y[:400]), 30,
                   valid_sets=[tlgb.Dataset(X[400:], label=y[400:])],
                   callbacks=[tlgb.early_stopping(2, verbose=False)])
    restored = pickle.loads(pickle.dumps(b))
    assert 0 < restored.best_iteration == b.best_iteration < 30
    assert restored.best_score == b.best_score
    assert restored._gbdt.config.device_predict == "true"
    before = DevicePredictor.dispatches["cpu"]
    np.testing.assert_array_equal(restored.predict(X), b.predict(X))
    assert DevicePredictor.dispatches["cpu"] == before + 2


def test_unpickled_booster_defaults_to_the_card(small_booster, monkeypatch):
    """Pickled params without a device restore on the card, and raise
    where there is none: never a quiet landing on the CPU."""
    b, _ = small_booster
    state = b.__getstate__()
    state["params"] = {k: v for k, v in state["params"].items()
                       if k != "device_type"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlgb.Booster.__new__(tlgb.Booster).__setstate__(state)


def test_pickled_booster_eval_valid_safe():
    """eval_valid on an unpickled booster has no ghost valid sets."""
    X, y = _small()
    b = tlgb.train(SMALL, tlgb.Dataset(X[:400], label=y[:400]), 3,
                   valid_sets=[tlgb.Dataset(X[400:], label=y[400:])],
                   valid_names=["v"])
    b2 = pickle.loads(pickle.dumps(b))
    assert b2.eval_valid() == []
    res = b2.eval(tlgb.Dataset(X, label=y, free_raw_data=False), "new")
    assert res and res[0][0] == "new" and np.isfinite(res[0][2])


# ----------------------------------------------------------- CVBooster
def test_cvbooster_delegation_and_round_trips(tmp_path):
    X, y = _small()
    res = tlgb.cv(SMALL, tlgb.Dataset(X, label=y), num_boost_round=4,
                  nfold=3, return_cvbooster=True)
    cvb = res["cvbooster"]
    assert isinstance(cvb, tlgb.CVBooster) and len(cvb.boosters) == 3
    preds = cvb.predict(X)
    assert len(preds) == 3 and all(p.shape == (len(X),) for p in preds)
    f = tmp_path / "cvb.json"
    cvb.save_model(str(f))
    from_file = tlgb.CVBooster(model_file=str(f), params=CPU)
    from_text = tlgb.CVBooster(params=CPU).model_from_string(
        cvb.model_to_string())
    for other in (from_file, from_text, pickle.loads(pickle.dumps(cvb)),
                  copy.deepcopy(cvb)):
        assert other.best_iteration == cvb.best_iteration
        for p, q in zip(preds, other.predict(X)):
            np.testing.assert_array_equal(p, q)
    # the JAX package loads the same file to the same predictions
    for p, q in zip(preds, jlgb.CVBooster(model_file=str(f)).predict(X)):
        np.testing.assert_allclose(p, q, rtol=0, atol=1e-12)
    # a CVBooster that `cv` made loads where its training ran
    assert cvb.model_from_string(cvb.model_to_string()) is cvb
    for p, q in zip(preds, cvb.predict(X)):
        np.testing.assert_array_equal(p, q)


def _folds_of(engine, pkg, ds, params, nfold, monkeypatch):
    """The (train rows, test rows) of each fold that `cv` trains on, read
    from a stand-in for `train`."""
    seen = []

    def fake_train(params, tr, num_boost_round, valid_sets=None, **kw):
        seen.append((np.asarray(tr.used_indices).tolist(),
                     np.asarray(valid_sets[0].used_indices).tolist()))
    monkeypatch.setattr(engine, "train", fake_train)
    pkg.cv(params, ds, num_boost_round=1, nfold=nfold, seed=5)
    return seen


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["query_folds", "stratified"])
def test_cv_folds_equal_jax(grouped, monkeypatch):
    """With `group` every fold holds whole queries; folds equal the JAX
    package's, row for row."""
    X, y = _small(n=500)
    group = np.random.RandomState(2).multinomial(
        500 - 25, np.ones(25) / 25) + 1 if grouped else None
    jf = _folds_of(jengine, jlgb, jlgb.Dataset(X, label=y, group=group),
                   {"objective": "binary", "verbosity": -1}, 4, monkeypatch)
    tf = _folds_of(tengine, tlgb, tlgb.Dataset(X, label=y, group=group),
                   SMALL, 4, monkeypatch)
    assert tf == jf and len(tf) == 4
    if grouped:
        qid = np.repeat(np.arange(len(group)), group)
        for train_rows, test_rows in tf:
            assert not set(qid[train_rows]) & set(qid[test_rows])


# ------------------------------------------------------------- exports
def test_reference_exports_present():
    """Everything the reference exports (minus the Dask estimators)
    exists in the port."""
    for name in ["Dataset", "Booster", "CVBooster", "register_logger",
                 "register_callback", "train", "cv", "LGBMModel",
                 "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
                 "log_evaluation", "record_evaluation", "reset_parameter",
                 "early_stopping", "EarlyStopException", "plot_importance",
                 "plot_split_value_histogram", "plot_metric", "plot_tree",
                 "create_tree_digraph", "Sequence"]:
        assert hasattr(tlgb, name), name
        assert name in tlgb.__all__, name


@pytest.mark.parametrize("cls", ["Booster", "Dataset"])
def test_every_jax_method_exists(cls):
    """Every public method of the JAX package's class is in the port;
    those that later items bring refuse with the item's name."""
    jcls, tcls = getattr(jlgb, cls), getattr(tlgb, cls)
    names = [n for n in dir(jcls) if not n.startswith("_")
             and callable(getattr(jcls, n))]
    assert len(names) >= 25
    for name in names:
        assert callable(getattr(tcls, name, None)), name
    X, y = _small(n=200)
    obj = (tlgb.train(SMALL, tlgb.Dataset(X, label=y), 1)
           if cls == "Booster" else tlgb.Dataset(X, label=y))
    args = {"refit": (X, y), "set_network": (["host:1"],)}
    for (c, name), item in LEFT_TO_ITEMS.items():
        if c == cls:
            with pytest.raises(NotImplementedError, match=item):
                getattr(obj, name)(*args.get(name, ()))


def test_register_logger_routes_messages():
    records = []

    class MyLogger:
        def info(self, msg):
            records.append(("info", msg))

        def warning(self, msg):
            records.append(("warning", msg))

    tlgb.register_logger(MyLogger())
    old_level = tlog.get_verbosity()
    tlog.set_verbosity(1)
    try:
        tlog.info("hello %d", 7)
        tlog.warning("watch out")
        assert ("info", "[LightGBM-TPU] [Info] hello 7") in records
        assert ("warning", "[LightGBM-TPU] [Warning] watch out") in records
        with pytest.raises(TypeError):
            tlgb.register_logger(object())
        tlog._LogState.logger = None
        lines = []
        tlgb.register_callback(lines.append)
        tlog.warning("to the callback")
        assert lines == ["[LightGBM-TPU] [Warning] to the callback\n"]
    finally:
        tlog._LogState.logger = None
        tlgb.register_callback(None)
        tlog.set_verbosity(old_level)


# ------------------------------------------------------------- Dataset
def _fields(n):
    rng = np.random.RandomState(4)
    group = np.array([n // 4, n // 4, n // 2])
    return (rng.rand(n).astype(np.float32) + 0.5, group, rng.randn(n),
            rng.randint(0, 5, n))


def test_dataset_positional_order_and_fields_equal_jax():
    """`Dataset(X, y, None, w, g, init)` puts each argument where the
    reference does; every field getter equals the JAX package's."""
    X, y = _small(n=400)
    w, group, init, pos = _fields(400)
    dsets = [pkg.Dataset(X, y, None, w, group, init, "auto", "auto",
                         None, False, pos) for pkg in (jlgb, tlgb)]
    for ds in dsets:
        assert ds.group is group and ds.init_score is init
        np.testing.assert_array_equal(ds.get_group(), group)
        ds.construct()
    dj, dt = dsets
    for field in ("label", "weight", "group", "init_score", "position"):
        np.testing.assert_array_equal(dt.get_field(field),
                                      dj.get_field(field), err_msg=field)
    for getter in ("get_label", "get_weight", "get_group", "get_init_score",
                   "get_position", "get_feature_name", "feature_names",
                   "num_data", "num_feature"):
        np.testing.assert_array_equal(getattr(dt, getter)(),
                                      getattr(dj, getter)(), err_msg=getter)
    assert dt.get_data() is X
    assert ([dt.feature_num_bin(f) for f in range(4)]
            == [dj.feature_num_bin(f) for f in range(4)])
    assert dt.feature_num_bin("Column_1") == dj.feature_num_bin(1)
    np.testing.assert_array_equal(dt._core.binned_host(),
                                  np.asarray(dj._core.binned_host()))
    # setters reach the constructed metadata
    w2 = np.full(400, 2.0, np.float32)
    for ds in dsets:
        ds.set_field("weight", w2).set_label(1 - y).set_init_score(None)
        ds.set_group([200, 200]).set_position(pos[::-1].copy())
    for field in ("label", "weight", "group", "position"):
        np.testing.assert_array_equal(dt.get_field(field),
                                      dj.get_field(field), err_msg=field)
    assert dt.get_init_score() is None and dj.get_init_score() is None
    with pytest.raises(tlgb.LightGBMError, match="Unknown field"):
        dt.get_field("nope")
    # the query boundaries reach subsets and valid sets
    sub = dt.subset(np.arange(150, 300))
    np.testing.assert_array_equal(sub.construct().get_group(), [50, 100])
    valid = dt.create_valid(X[:100], label=y[:100], group=[60, 40])
    np.testing.assert_array_equal(valid.construct().get_group(), [60, 40])


def test_categorical_feature_by_name_equals_jax():
    X, y = _small(n=300)
    X[:, 2] = np.floor(X[:, 2] * 6)
    kw = dict(label=y, feature_name=["a", "b", "c", "d"],
              categorical_feature=["c"])
    cores = [pkg.Dataset(X, **kw).construct()._core for pkg in (jlgb, tlgb)]
    assert ([m.to_dict() for m in cores[1].bin_mappers]
            == [m.to_dict() for m in cores[0].bin_mappers])
    assert cores[1].bin_mappers[2].bin_type != cores[1].bin_mappers[1].bin_type


def test_dataset_feature_names_and_reference():
    X, y = _small(n=300)
    ds = tlgb.Dataset(X, label=y, free_raw_data=False)
    ds.set_feature_name(["a", "b", "c", "d"])
    assert ds.construct().feature_names() == ["a", "b", "c", "d"]
    with pytest.raises(tlgb.LightGBMError, match="feature_name"):
        ds.set_feature_name(["a"])
    chain = ds.create_valid(X, label=y).get_ref_chain()
    assert ds in chain and len(chain) == 2
    # set_reference and set_categorical_feature re-bin while raw data
    # is kept, and refuse once it was freed
    other = tlgb.Dataset(X * 2, label=y, free_raw_data=False)
    v = tlgb.Dataset(X, label=y, reference=ds, free_raw_data=False)
    v.construct()
    v.set_reference(other)
    assert v._core is None and v.reference is other
    v.set_categorical_feature([3])
    assert v.categorical_feature == [3]
    freed = tlgb.Dataset(X, label=y)
    freed.construct()
    for call in (lambda: freed.set_reference(ds),
                 lambda: freed.set_categorical_feature([0])):
        with pytest.raises(tlgb.LightGBMError, match="freed raw data"):
            call()


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csr"])
def test_add_features_from_equals_jax(sparse):
    """The merged Dataset bins as the JAX package's and trains as the
    Dataset of all columns; scipy input is densified in both."""
    X, y = _small(n=400)
    X[X < 0.3] = 0.0
    parts = [X[:, :2], X[:, 2:]]
    if sparse:
        parts = [sps.csr_matrix(p) for p in parts]
    merged = []
    for pkg in (jlgb, tlgb):
        d1 = pkg.Dataset(parts[0], label=y, free_raw_data=False,
                         feature_name=["a", "b"])
        d2 = pkg.Dataset(parts[1], label=y, free_raw_data=False,
                         feature_name=["c", "d"])
        merged.append(d1.add_features_from(d2))
    dj, dt = merged
    assert not sps.issparse(dt.data)
    np.testing.assert_array_equal(dt.data, dj.data)
    assert dt.num_feature() == dj.num_feature() == 4
    assert dt.feature_names() == dj.feature_names() == ["a", "b", "c", "d"]
    np.testing.assert_array_equal(dt._core.binned_host(),
                                  np.asarray(dj._core.binned_host()))
    b = tlgb.train(SMALL, dt, num_boost_round=3)
    b_full = tlgb.train(SMALL, tlgb.Dataset(X, label=y), num_boost_round=3)
    np.testing.assert_array_equal(b.predict(X), b_full.predict(X))


def test_get_data_subset_and_freed():
    X, y = _small(n=200)
    ds = tlgb.Dataset(X, label=y, free_raw_data=False)
    sub = ds.subset([3, 5, 7])
    np.testing.assert_array_equal(sub.get_data(), X[[3, 5, 7]])
    ds2 = tlgb.Dataset(X, label=y)
    ds2.construct()
    with pytest.raises(tlgb.LightGBMError, match="free_raw_data=False"):
        ds2.get_data()


def test_ref_chain_cycle_terminates():
    X, y = _small(n=100)
    a = tlgb.Dataset(X, label=y)
    b = tlgb.Dataset(X, label=y)
    a.reference = b
    b.reference = a
    assert a.get_ref_chain() == {a, b}


def test_subset_mutators_rejected():
    X, y = _small(n=200)
    ds = tlgb.Dataset(X, label=y, free_raw_data=False)
    sub = ds.subset([1, 2, 3])
    with pytest.raises(tlgb.LightGBMError, match="subset"):
        sub.set_categorical_feature([0])
    with pytest.raises(tlgb.LightGBMError, match="subset"):
        sub.add_features_from(tlgb.Dataset(X[:3], free_raw_data=False))


# ------------------------------------- Booster: text-loaded, exact vs JAX
def test_loaded_model_reads_equal_jax(trained):
    _, _, X, _, text = trained
    bj, bt = _loaded(text)
    assert bt.dump_model() == bj.dump_model()
    assert bt.dump_model()["feature_names"] == []     # as in JAX
    assert bt.trees_to_dataframe().equals(bj.trees_to_dataframe())
    assert bt.model_to_if_else() == bj.model_to_if_else()
    assert bt.lower_bound() == bj.lower_bound()
    assert bt.upper_bound() == bj.upper_bound()
    assert bt.feature_name() == bj.feature_name()
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == 1
    for feature in (0, 2, "Column_5"):
        for ht, hj in zip(bt.get_split_value_histogram(feature),
                          bj.get_split_value_histogram(feature)):
            np.testing.assert_array_equal(ht, hj)
        np.testing.assert_array_equal(
            bt.get_split_value_histogram(feature, bins=4,
                                         xgboost_style=True),
            bj.get_split_value_histogram(feature, bins=4,
                                         xgboost_style=True))
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(
            bt.feature_importance(kind, iteration=2),
            bj.feature_importance(kind, iteration=2))
    assert bt.get_leaf_output(3, 5) == bj.get_leaf_output(3, 5)
    # the digraph's source
    assert (tlgb.create_tree_digraph(bt, tree_index=1).source
            == jlgb.create_tree_digraph(bj, tree_index=1).source)
    X64 = X.astype(np.float64)
    np.testing.assert_allclose(bt.predict(X64, raw_score=True),
                               bj.predict(X64, raw_score=True), rtol=0,
                               atol=1e-12)
    # a changed leaf predicts as the JAX package's changed leaf
    for b in (bj, bt):
        b.set_leaf_output(2, 1, b.get_leaf_output(2, 1) - 0.25)
    np.testing.assert_allclose(bt.predict(X64, raw_score=True),
                               bj.predict(X64, raw_score=True), rtol=0,
                               atol=1e-12)
    for b in (bj, bt):
        b.free_dataset().set_train_data_name("t")
        assert b._train_set is None and b._train_data_name == "t"


@pytest.mark.parametrize("case", ["binary", "multiclass"])
def test_shuffle_models_equals_jax(trained, case):
    """The same RandomState(seed) order, in whole iterations of K trees;
    predictions keep their value."""
    text, X = ((trained[4], trained[2]) if case == "binary"
               else _multiclass_text())
    bj, bt = _loaded(text)
    before = bt.predict(X, raw_score=True)
    bj.shuffle_models(start_iteration=1)
    bt.shuffle_models(start_iteration=1)
    # up to the parameters block, which the port writes back as loaded
    # (ROADMAP "Divergences")
    cut = "\nparameters:"
    tt, tj = bt.model_to_string(), bj.model_to_string()
    assert tt[:tt.index(cut)] == tj[:tj.index(cut)] != text[:text.index(cut)]
    assert tt[tt.index(cut):] == text[text.index(cut):]
    np.testing.assert_allclose(bt.predict(X, raw_score=True), before,
                               rtol=0, atol=1e-12)
    if case == "multiclass":
        assert bt.num_model_per_iteration() == 3


def test_model_from_string_resets_state(trained):
    _, bt, X, y, text = trained
    b2 = tlgb.train({**SMALL, "objective": "binary"},
                    tlgb.Dataset(X, label=y), num_boost_round=2,
                    valid_sets=[tlgb.Dataset(X, label=y)],
                    valid_names=["v"])
    b2.model_from_string(text)
    assert b2.name_valid_sets == [] and b2.eval_valid() == []
    assert b2.num_trees() == 5 and b2._gbdt.device.type == "cpu"
    assert b2.model_to_string() == tlgb.Booster(
        model_str=text, params=CPU).model_to_string()


# -------------------------------------- Booster: trained, against JAX
def test_trained_dump_and_frame_match_jax(trained):
    bj, bt, _, _, _ = trained
    dj, dt = bj.dump_model(), bt.dump_model()
    for key in ("name", "version", "num_class", "num_tree_per_iteration",
                "max_feature_idx", "objective", "feature_names"):
        assert dt[key] == dj[key], key
    assert len(dt["tree_info"]) == 5

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            elif k in ("leaf_value", "internal_value"):
                assert abs(a[k] - b[k]) <= LEAF_ATOL, k
            elif k not in ("split_gain", "leaf_weight", "internal_weight",
                           "shrinkage"):
                assert a[k] == b[k], k
    for a, b in zip(dt["tree_info"], dj["tree_info"]):
        walk(a, b)
    ft, fj = bt.trees_to_dataframe(), bj.trees_to_dataframe()
    for col in ("tree_index", "node_depth", "node_index", "split_feature",
                "decision_type", "left_child", "right_child", "count"):
        assert ft[col].equals(fj[col]), col
    np.testing.assert_allclose(ft["value"], fj["value"], rtol=0,
                               atol=LEAF_ATOL)
    assert bt.feature_name() == bj.feature_name()
    hist_t, edges_t = bt.get_split_value_histogram(0)
    hist_j, edges_j = bj.get_split_value_histogram(0)
    np.testing.assert_array_equal(hist_t, hist_j)
    np.testing.assert_array_equal(edges_t, edges_j)
    assert abs(bt.lower_bound() - bj.lower_bound()) <= 5 * LEAF_ATOL
    assert abs(bt.upper_bound() - bj.upper_bound()) <= 5 * LEAF_ATOL


@pytest.mark.parametrize("route", ["device_predict", "native", "single_row"])
def test_leaf_output_and_shuffle_reach_every_predictor(route):
    """set_leaf_output and shuffle_models invalidate the cached
    predictors (the torch traversal, the native packed predictor and the
    fast single-row one): the next predict serves the new leaves."""
    X, y = _small(n=500)
    X = X.astype(np.float32)
    dp = "true" if route == "device_predict" else "false"
    b = tlgb.train({**SMALL, "device_predict": dp},
                   tlgb.Dataset(X, label=y), num_boost_round=3)

    def raw():
        if route == "single_row":
            return np.concatenate([b.predict(X[i:i + 1], raw_score=True,
                                             single_row_fast=True)
                                   for i in range(40)])
        return b.predict(X, raw_score=True)
    rows = 40 if route == "single_row" else len(X)
    before = raw()
    leaf = b.predict(X[:rows], pred_leaf=True)[:, 0]
    target = int(leaf[0])
    v = b.get_leaf_output(0, target)
    b.set_leaf_output(0, target, v + 1.0)
    assert b.get_leaf_output(0, target) == v + 1.0
    moved = raw()
    np.testing.assert_allclose(moved[leaf == target] - before[leaf == target],
                               1.0, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(moved[leaf != target],
                                  before[leaf != target])
    b.set_leaf_output(0, target, v)
    np.testing.assert_array_equal(raw(), before)
    order = [t.leaf_value.copy() for t in b._gbdt.models_]
    b.shuffle_models()
    assert any(not np.array_equal(a, t.leaf_value)
               for a, t in zip(order, b._gbdt.models_))
    np.testing.assert_allclose(raw(), before, rtol=0, atol=1e-6)


def test_booster_bookkeeping(trained):
    _, bt, X, y, _ = trained
    b = copy.deepcopy(bt)
    b.set_train_data_name("train_set")
    assert b._train_data_name == "train_set"
    ds = tlgb.Dataset(X, label=y)
    b2 = tlgb.Booster(params={**PARAMS, **CPU}, train_set=ds)
    assert b2.free_dataset() is b2 and b2._train_set is None
    assert b2.num_model_per_iteration() == 1
    np.testing.assert_array_equal(bt.feature_importance("split", 3),
                                  bt.feature_importance("split"))


# ------------------------------------------------------------ plotting
def test_plot_importance(trained):
    bj, bt, _, _, _ = trained
    ax = tlgb.plot_importance(bt)
    labels = [t.get_text() for t in ax.get_yticklabels()]
    axj = jlgb.plot_importance(bj)
    assert labels == [t.get_text() for t in axj.get_yticklabels()]
    assert tlgb.plot_importance(bt, importance_type="gain",
                                max_num_features=3) is not None


def test_plot_metric():
    X, y = _small()
    hist = {}
    tlgb.train({**SMALL, "metric": "auc"},
               tlgb.Dataset(X[:400], label=y[:400]), num_boost_round=5,
               valid_sets=[tlgb.Dataset(X[400:], label=y[400:])],
               valid_names=["valid"], callbacks=[tlgb.record_evaluation(hist)])
    ax = tlgb.plot_metric(hist, metric="auc")
    assert ax.get_title() == "Metric during training"
    np.testing.assert_array_equal(ax.get_lines()[0].get_ydata(),
                                  hist["valid"]["auc"])
    with pytest.raises(tlgb.LightGBMError):
        tlgb.plot_metric({})


def test_plot_split_value_histogram(trained):
    _, bt, _, _, _ = trained
    ax = tlgb.plot_split_value_histogram(bt, 0)
    assert ax.get_title().endswith("index 0")
    with pytest.raises(tlgb.LightGBMError, match="not used"):
        tlgb.plot_split_value_histogram(bt, 99)


# ---------------------------------- the cases of test_plotting_api.py
@pytest.fixture(scope="module")
def regression():
    rng = np.random.RandomState(0)
    X = rng.randn(1000, 4)
    y = X[:, 0] * 2 + X[:, 1] + 0.1 * rng.randn(1000)
    return tlgb.train({"objective": "regression", "num_leaves": 7,
                       "verbosity": -1, **CPU},
                      tlgb.Dataset(X, label=y), num_boost_round=5), X, y


def test_bounds_and_shuffle(regression):
    b, X, _ = regression
    b = copy.deepcopy(b)
    raw = b.predict(X, raw_score=True)
    assert b.lower_bound() <= raw.min() and raw.max() <= b.upper_bound()
    before = b.predict(X)
    b.shuffle_models()
    np.testing.assert_allclose(b.predict(X), before, rtol=1e-12)


def test_eval_arbitrary_and_loaded(tmp_path, regression):
    b, X, y = regression
    res = b.eval(tlgb.Dataset(X, label=y), "holdout")
    assert res and res[0][0] == "holdout" and np.isfinite(res[0][2])
    path = str(tmp_path / "m.txt")
    b.save_model(path)
    loaded = tlgb.Booster(model_file=path, params=CPU)
    res_l = loaded.eval(tlgb.Dataset(X, label=y, free_raw_data=False),
                        "holdout")
    assert abs(res_l[0][2] - res[0][2]) < 1e-5


def test_reset_parameter_callback():
    rng = np.random.RandomState(2)
    X = rng.randn(800, 3)
    b = tlgb.train({"objective": "regression", "num_leaves": 7,
                    "verbosity": -1, "learning_rate": 0.5, **CPU},
                   tlgb.Dataset(X, label=X[:, 0]), num_boost_round=6,
                   callbacks=[tlgb.reset_parameter(
                       learning_rate=lambda it: 0.5 * (0.5 ** it))])
    shr = [t.shrinkage for t in b._gbdt.models_ if t.num_leaves > 1]
    assert shr[0] > shr[-1]
