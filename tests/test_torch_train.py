"""PyTorch port: `train` against the JAX package's, end to end on the CPU.

Both packages train binary logloss on the wave engine
(`tpu_growth_strategy=wave`; on the CPU the JAX package would otherwise
pick its leaf-wise engine) with n=4096, F=8, num_leaves=31, max_bin=63,
5 iterations, the port on `device_type="cpu"`.  Per tree: the same
split features, thresholds, decision types and leaf counts; leaf values
and predictions within 1e-5.  Model text crosses both ways.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import convert

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N, F = 4096, 8
PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_growth_strategy": "wave"}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    w = np.random.RandomState(7).randn(F)
    logit = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    y = (rng.rand(N) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def boosters():
    X, y = _data()
    bj = jlgb.train(PARAMS, jlgb.Dataset(X, label=y), num_boost_round=5)
    bt = tlgb.train({**PARAMS, "device_type": "cpu"},
                    tlgb.Dataset(X, label=y), num_boost_round=5)
    bj._gbdt._sync_model()
    return bj, bt, X


def test_same_trees(boosters):
    bj, bt, _ = boosters
    tj, tt = bj._gbdt.models_, bt._gbdt.models_
    assert len(tj) == len(tt) == 5
    for i, (a, b) in enumerate(zip(tj, tt)):
        assert a.num_leaves == b.num_leaves == 31, i
        ni = a.num_leaves - 1
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni],
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_array_equal(a.leaf_count[:ni + 1],
                                      b.leaf_count[:ni + 1])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   b.leaf_value[:ni + 1], rtol=0, atol=1e-5)


def test_same_predictions(boosters):
    bj, bt, X = boosters
    Xte, _ = _data(1)
    for data in (X, Xte):
        np.testing.assert_allclose(bt.predict(data), bj.predict(data),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(bt.predict(data, raw_score=True),
                                   bj.predict(data, raw_score=True),
                                   rtol=0, atol=1e-5)


def test_same_bin_mappers():
    X, y = _data()
    dj = jlgb.Dataset(X, label=y, params=PARAMS).construct()._core
    dt = tlgb.Dataset(X, label=y, params=PARAMS).construct()._core
    assert [m.to_dict() for m in dj.bin_mappers] == \
        [m.to_dict() for m in dt.bin_mappers]
    np.testing.assert_array_equal(np.asarray(dj.binned_host()),
                                  dt.binned_host())
    mappers = convert.bin_mappers_from_jax(
        [m.to_dict() for m in dj.bin_mappers])
    ds = convert.dataset_with_bin_mappers(X, y, mappers)
    np.testing.assert_array_equal(np.asarray(dj.binned_host()),
                                  ds.binned_host())


def test_booster_from_jax_predicts_as_jax(boosters):
    bj, _, X = boosters
    port = convert.booster_from_jax(bj.model_to_string(),
                                    params={"device_type": "cpu"})
    assert port.num_trees() == 5
    np.testing.assert_allclose(port.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)


def test_port_model_text_loads_in_jax(boosters):
    _, bt, X = boosters
    text = bt.model_to_string()
    assert text.startswith("tree\nversion=v4")
    bj2 = jlgb.Booster(model_str=text)
    np.testing.assert_allclose(bj2.predict(X), bt.predict(X), rtol=0,
                               atol=1e-12)
    # and back: the port reloads its own text to the same predictions
    np.testing.assert_allclose(
        tlgb.Booster(model_str=text,
                     params={"device_type": "cpu"}).predict(X),
        bt.predict(X), rtol=0, atol=0)


# the ids keep the positions of the cases they replaced, and the names of
# extra0, extra7 and extra8 (linear trees, ported since).  More than 256
# bins, the intermediate, advanced and lazy CEGB options, linear trees
# and the tree learners are ported since too: each case pairs an option
# with the feature or voting learner, which without a process group
# trains on one device, and the case holds that it grows the serial
# run's trees (the options themselves are held against the JAX package
# elsewhere)
@pytest.mark.parametrize("extra", [
    pytest.param({"max_bin": 511, "tree_learner": "feature"},
                 id="extra0-item 14"),
    pytest.param({"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0],
                  "monotone_constraints_method": "intermediate",
                  "tree_learner": "voting"}, id="extra1-item 13"),
    pytest.param({"monotone_constraints": [1, 0, 0, 0, 0, 0, 0, 0],
                  "monotone_constraints_method": "advanced",
                  "tree_learner": "feature"}, id="extra3-item 13"),
    pytest.param({"cegb_penalty_feature_lazy": [1.0] * 8,
                  "tree_learner": "voting"}, id="extra5-item 13"),
    pytest.param({"tree_learner": "voting"}, id="extra6-item 15"),
    pytest.param({"tree_learner": "feature"}, id="extra7-item 14"),
    pytest.param({"linear_tree": True, "tree_learner": "feature"},
                 id="extra8-item 14"),
    pytest.param({"max_bin": 300, "tree_learner": "voting"},
                 id="extra9-item 2")])
def test_unported_options_refuse(extra):
    X, y = _data()
    params = {**PARAMS, "device_type": "cpu", **extra}
    kw = {"params": {"linear_tree": True}} if extra.get("linear_tree") else {}
    got = tlgb.train(params, tlgb.Dataset(X[:1024], label=y[:1024], **kw),
                     num_boost_round=2)
    assert got._gbdt.block is None and got._gbdt.voting is None
    want = tlgb.train({**params, "tree_learner": "serial"},
                      tlgb.Dataset(X[:1024], label=y[:1024], **kw),
                      num_boost_round=2)
    assert (got.model_to_string().split("\nparameters:")[0]
            == want.model_to_string().split("\nparameters:")[0])


def test_gradients_fed_in_grow_the_same_tree():
    """`train_one_iter(gradients, hessians)` grows from the given values:
    fed the objective's own gradients at the boost-from-average score, it
    grows the tree an ordinary first update grows (less the init bias)."""
    X, y = _data()
    params = {**PARAMS, "device_type": "cpu"}
    a = tlgb.Booster(params, tlgb.Dataset(X, label=y))
    a.update()
    b = tlgb.Booster(params, tlgb.Dataset(X, label=y))
    gb = b._gbdt
    init = gb.objective.boost_from_score(0)
    score = torch.full((gb.n_pad,), init, dtype=torch.float32)
    g, h = gb.objective.get_gradients(score, gb.label_dev, None)
    gb.train_one_iter(g[:N].numpy(), h[:N].numpy())
    ta, tb = a._gbdt.models_[0], gb.models_[0]
    ni = ta.num_leaves - 1
    assert ta.num_leaves == tb.num_leaves
    np.testing.assert_array_equal(ta.split_feature[:ni], tb.split_feature[:ni])
    np.testing.assert_array_equal(ta.threshold[:ni], tb.threshold[:ni])
    np.testing.assert_allclose(ta.leaf_value[:ni + 1] - init,
                               tb.leaf_value[:ni + 1], rtol=0, atol=1e-12)


def test_save_model_round_trip(boosters, tmp_path):
    _, bt, X = boosters
    path = tmp_path / "model.txt"
    bt.save_model(str(path))
    assert path.read_text() == bt.model_to_string()
    np.testing.assert_array_equal(
        tlgb.Booster(model_file=str(path),
                     params={"device_type": "cpu"}).predict(X),
        bt.predict(X))
