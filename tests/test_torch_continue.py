"""PyTorch port: continued training (`train(init_model=...)`,
`keep_training_booster`) and `Booster.rollback_one_iter` against the
JAX package, on the CPU.

The JAX package trains an init model; both packages then continue it
(given as a Booster, a model file or model text) on the same data.  The
adopted trees keep their model text; the new trees must equal the JAX
package's: the same split features, thresholds, decision types and
leaf counts, leaf values within 1e-5.  The threefry streams are keyed by
the absolute iteration, so the continued quantized run (stochastic
rounding, with bagging every second iteration: quantized training with
bagging end to end, and the NumPy bag stream restarting from its seed)
and the continued GOSS run (sampling from iteration 2 at learning_rate
0.5) hold that keying to the JAX package's.  Valid scores
are seeded from the init model: the recorded history equals the JAX
package's within the bound of tests/test_torch_valid.py, taken over the
new trees only (the adopted ones are the same text in both), and the
first recorded AUC and logloss equal those of
`predict(num_iteration=init + 1)` within 1e-9.  A rollback drops the
last trees and keeps the scores, as the JAX package's does.
"""

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.metric import create_metrics
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata

from test_torch_valid import LEAF_REL, _auc_swap_share

N, FEATS = 4096, 8
PARAMS = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
          "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
          "tpu_growth_strategy": "wave", "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    w = np.random.RandomState(7).randn(FEATS)
    logit = X @ w + 0.8 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _same_trees(a_trees, b_trees, what):
    assert len(a_trees) == len(b_trees), what
    for i, (a, b) in enumerate(zip(a_trees, b_trees)):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves, (what, i)
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni],
                                          err_msg=f"{what} tree {i} {k}")
        np.testing.assert_array_equal(a.leaf_count[:ni + 1],
                                      b.leaf_count[:ni + 1])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   b.leaf_value[:ni + 1], rtol=0, atol=1e-5,
                                   err_msg=f"{what} tree {i}")


def _jax_models(booster):
    booster._gbdt._sync_model()
    return booster._gbdt.models_


def _continue_pair(extra, init_rounds, rounds, tmp_path):
    """JAX init model -> (JAX continued booster, port continued booster,
    init text), both continued from the init model's file."""
    X, y = _data()
    params = {**PARAMS, **extra}
    bj1 = jlgb.train(params, jlgb.Dataset(X, label=y), init_rounds)
    path = tmp_path / "init.txt"
    bj1.save_model(str(path))
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), rounds,
                    init_model=str(path))
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y), rounds,
                    init_model=str(path))
    return bj, bt, path.read_text()


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """The JAX init model (3 rounds) and its continuation (3 more), from
    the model file and from the Booster itself."""
    X, y = _data()
    bj1 = jlgb.train(PARAMS, jlgb.Dataset(X, label=y), 3)
    path = tmp_path_factory.mktemp("init") / "init.txt"
    bj1.save_model(str(path))
    bj_file = jlgb.train(PARAMS, jlgb.Dataset(X, label=y), 3,
                         init_model=str(path))
    return X, y, path, _jax_models(bj_file)


@pytest.mark.parametrize("kind", ["booster", "file", "string"])
def test_continue_matches_jax(plain, kind):
    X, y, path, want = plain
    text = path.read_text()
    init = {"booster": lambda: tlgb.Booster(model_str=text, params=CPU),
            "file": lambda: str(path), "string": lambda: text}[kind]()
    bt = tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y), 3,
                    init_model=init)
    g = bt._gbdt
    assert g.num_init_iteration_ == 3 and g.iter_ == 3
    assert bt.num_trees() == 6
    init_trees = tlgb.Booster(model_str=text, params=CPU)._gbdt.models_
    for i in range(3):
        # adopted trees keep their model text
        assert g.models_[i].to_string(i) == init_trees[i].to_string(i)
    _same_trees(want, g.models_, kind)
    jb = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bt.predict(X), jb.predict(X), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("extra,init_rounds", [
    ({"use_quantized_grad": True, "bagging_fraction": 0.8,
      "bagging_freq": 2}, 2),
    ({"data_sample_strategy": "goss", "learning_rate": 0.5}, 2)],
    ids=["quantized", "goss"])
def test_continue_streams_by_absolute_iteration(extra, init_rounds,
                                                tmp_path):
    bj, bt, _ = _continue_pair(extra, init_rounds, 2, tmp_path)
    assert bt._gbdt.num_init_iteration_ == init_rounds
    _same_trees(_jax_models(bj), bt._gbdt.models_, str(extra))
    if "data_sample_strategy" in extra:
        # the continued iterations sample: GOSS keys them by 2 and 3
        mask, _, _ = bt._gbdt._update_bagging(*bt._gbdt._compute_gradients())
        assert 0 < float(mask.sum()) < N


def test_valid_scores_seeded_from_init_model(plain):
    X, y, path, _ = plain
    Xv, yv = _data(seed=2, n=1024)
    params = {**PARAMS, "metric": ["auc", "binary_logloss"]}
    hj, ht = {}, {}
    bj = jlgb.train(params, jlgb.Dataset(X, label=y), 2,
                    init_model=str(path),
                    valid_sets=[jlgb.Dataset(Xv, label=yv)],
                    valid_names=["v"],
                    callbacks=[jlgb.record_evaluation(hj)])
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y), 2,
                    init_model=str(path),
                    valid_sets=[tlgb.Dataset(Xv, label=yv)],
                    valid_names=["v"],
                    callbacks=[tlgb.record_evaluation(ht)])
    models = _jax_models(bj)
    leaves = bj.predict(Xv, pred_leaf=True)
    for i in range(2):
        lv = np.stack([models[t].leaf_value[leaves[:, t]]
                       for t in range(3, 4 + i)], 1)
        delta = LEAF_REL * np.abs(lv).sum(1).max()
        pj = bj.predict(Xv, num_iteration=4 + i, raw_score=True)
        for m, bound in (("auc", _auc_swap_share(pj, yv, delta)),
                         ("binary_logloss", delta)):
            assert abs(ht["v"][m][i] - hj["v"][m][i]) <= bound, (m, i)
    # the first recorded values are those of the init model + one tree
    raw = bt.predict(Xv, num_iteration=4, raw_score=True)
    md = Metadata(len(yv))
    md.set_label(yv)
    for metric in create_metrics(Config(params)):
        metric.init(md, len(yv))
        (name, value), = metric.eval(raw.astype(np.float64),
                                     bt._gbdt.objective)
        assert abs(ht["v"][name][0] - value) <= 1e-9, name


def test_keep_training_booster_trains_on():
    X, y = _data()
    bt = tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y), 2,
                    keep_training_booster=True)
    assert not bt.update()
    ref = tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y), 3)
    assert bt.model_to_string() == ref.model_to_string()


def test_rollback_matches_jax():
    X, y = _data()
    bj = jlgb.train(PARAMS, jlgb.Dataset(X, label=y), 3)
    bt = tlgb.train({**PARAMS, **CPU}, tlgb.Dataset(X, label=y), 3)
    before = bt.predict(X, num_iteration=2)
    assert bt.predict(X).tolist() != before.tolist()    # cache filled
    assert bt.rollback_one_iter() is bt
    assert bt.num_trees() == 2 and bt.current_iteration() == 2
    np.testing.assert_array_equal(bt.predict(X), before)
    # training on after a rollback: the scores keep the dropped tree's
    # contribution in both packages
    bj.rollback_one_iter()
    bj.update()
    bt.update()
    _same_trees(_jax_models(bj), bt._gbdt.models_, "rollback")
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-5)
