"""PyTorch port: forced splits and interaction constraints end to end
against the JAX package, on the CPU.

Data: 4096 x 8 binary logloss with random row weights (so that few
candidate splits tie); the label mixes features across the interaction
sets.  Forced splits come from a JSON file (the reference's
forced_splits.json format): `nested`, a depth-2 tree on features 0, 1
and 2 at their medians; `nested_max_depth`, the same with a third level
under max_depth=2, which ends the forcing at the depth limit;
`abort_chain`, a root whose left child's threshold leaves a child empty,
so that split and every later one are skipped and best-gain growth takes
their place.  Interaction constraints are given as the string
"[0,1,2],[3,4,5],[6,7]" and as the list of lists.  Both packages train 3
iterations (wave engine where named: the JAX package picks its leaf-wise
engine on the CPU; the nested tree runs on the leaf-wise engine, with
max_depth on the wave engine), and the trees are compared under the tie
rule of tests/test_torch_categorical.py (`compare_training`).  Then, on
the port alone: the forced nodes lead every tree on both engines; a
forced split that cannot apply is skipped, and growth goes on as without
it (the wave engine's overgrow-and-prune stays off); the wave engine's
forced prologue keeps the exact row partition at 96 leaves (its slot
bounds are multiplicative in the prologue's length); and every
root-to-leaf path of a constrained model uses the features of one set.
"""

import json

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb

from test_torch_categorical import compare_training

N, FEATS = 4096, 8
BASE = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}
SETS = [[0, 1, 2], [3, 4, 5], [6, 7]]


def _data(seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, FEATS).astype(np.float32)
    logit = (X[:, 0] * X[:, 3] + 0.8 * X[:, 1] - 0.6 * X[:, 4]
             + 0.5 * X[:, 2] * X[:, 6] + 0.4 * X[:, 7])
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    wt = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, wt


def _forced(kind, X):
    med = [float(np.median(X[:, f])) for f in range(FEATS)]
    tree = {"feature": 0, "threshold": med[0],
            "left": {"feature": 1, "threshold": med[1]},
            "right": {"feature": 2, "threshold": med[2]}}
    if kind == "nested_max_depth":
        tree["left"]["left"] = {"feature": 3, "threshold": med[3]}
    if kind == "abort_chain":
        tree["left"]["threshold"] = 99.0           # an empty right child
        tree["right"]["left"] = {"feature": 4, "threshold": med[4]}
    return tree


CASES = {
    "nested_leafwise": ({"tpu_growth_strategy": "leafwise"}, "nested"),
    "nested_max_depth_wave": ({"tpu_growth_strategy": "wave",
                               "max_depth": 2}, "nested_max_depth"),
    "abort_chain_leafwise": ({"tpu_growth_strategy": "leafwise"},
                             "abort_chain"),
    "interaction_string_wave": ({"tpu_growth_strategy": "wave",
                                 "interaction_constraints":
                                     "[0,1,2],[3,4,5],[6,7]"}, None),
    "interaction_list_leafwise": ({"tpu_growth_strategy": "leafwise",
                                   "interaction_constraints": SETS}, None),
}


def _params(case, tmp_path):
    extra, forced = CASES[case]
    params = {**BASE, **extra}
    if forced is not None:
        path = tmp_path / f"{forced}.json"
        path.write_text(json.dumps(_forced(forced, _data()[0])))
        params["forcedsplits_filename"] = str(path)
    return params


def _paths(tree):
    """Features on each root-to-leaf path."""
    out = []

    def walk(node, feats):
        if node < 0:
            out.append(feats)
            return
        f = int(tree.split_feature[node])
        walk(int(tree.left_child[node]), feats | {f})
        walk(int(tree.right_child[node]), feats | {f})
    if tree.num_leaves > 1:
        walk(0, frozenset())
    return out


def _check_forced(tree, kind, X):
    """The forced nodes lead the tree: node 0 the root, node 1 its left
    child, node 2 its right child (then node 3 under node 1)."""
    want = _forced(kind, X)
    assert tree.split_feature[0] == want["feature"]
    if kind == "abort_chain":
        assert tree.split_feature[1] != 1 or tree.threshold[1] < 50
        return
    assert tree.left_child[0] == 1 and tree.right_child[0] == 2
    assert tree.split_feature[1] == 1 and tree.split_feature[2] == 2
    if kind == "nested_max_depth":
        assert tree.leaf_depth[:tree.num_leaves].max() <= 2


@pytest.mark.parametrize("case", list(CASES))
def test_train_matches_jax(case, tmp_path):
    X, y, wt = _data()
    params = _params(case, tmp_path)
    bj = jlgb.train(params, jlgb.Dataset(X, label=y, weight=wt), 3)
    bt = tlgb.train({**params, **CPU}, tlgb.Dataset(X, label=y, weight=wt),
                    3)
    bj._gbdt._sync_model()
    gp = bt._gbdt.grow_params
    assert bt._gbdt.growth_strategy == params["tpu_growth_strategy"]
    assert bool(gp.forced_splits) == ("forcedsplits_filename" in params)
    assert bool(gp.interaction_sets) == ("interaction_constraints" in params)
    assert gp.forced_splits == bj._gbdt.grow_params.forced_splits
    assert gp.interaction_sets == bj._gbdt.grow_params.interaction_sets
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)
    forced = CASES[case][1]
    for t in bt._gbdt.models_:
        if forced is not None:
            _check_forced(t, forced, X)
        if "interaction_constraints" in params:
            for feats in _paths(t):
                assert any(feats <= set(s) for s in SETS), feats


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_forced_prefix_is_engine_independent(engine, tmp_path):
    """The forced prologue grows the same first three nodes on both
    engines, and growth goes on to the leaf budget after it."""
    X, y, wt = _data()
    params = {**_params("nested_leafwise", tmp_path), **CPU,
              "tpu_growth_strategy": engine, "num_leaves": 16}
    b = tlgb.train(params, tlgb.Dataset(X, label=y, weight=wt), 2)
    ref = tlgb.train({**params, "tpu_growth_strategy": "leafwise"},
                     tlgb.Dataset(X, label=y, weight=wt), 1)
    t, r = b._gbdt.models_[0], ref._gbdt.models_[0]
    np.testing.assert_array_equal(t.split_feature[:3], r.split_feature[:3])
    np.testing.assert_array_equal(t.threshold[:3], r.threshold[:3])
    assert t.num_leaves == 16
    _check_forced(t, "nested", X)


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_invalid_forced_split_is_skipped(engine, tmp_path):
    X, y, wt = _data()
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"feature": 2, "threshold": 99.0,
                                "left": {"feature": 1, "threshold": 0.0}}))
    b = tlgb.train({**BASE, **CPU, "tpu_growth_strategy": engine,
                    "forcedsplits_filename": str(path)},
                   tlgb.Dataset(X, label=y, weight=wt), 2)
    # forced splits turn the wave engine's overgrow-and-prune off
    free = tlgb.train({**BASE, **CPU, "tpu_growth_strategy": engine,
                       "wave_prune": False},
                      tlgb.Dataset(X, label=y, weight=wt), 2)
    for t, f in zip(b._gbdt.models_, free._gbdt.models_):
        assert t.num_leaves == BASE["num_leaves"]
        assert t.split_feature[0] != 2
        # a skipped prologue leaves best-gain growth as it was
        np.testing.assert_array_equal(t.split_feature, f.split_feature)
        np.testing.assert_array_equal(t.threshold, f.threshold)


def test_wave_forced_deep_growth_keeps_the_partition(tmp_path):
    """At 96 leaves the ladder after a forced prologue computes up to
    (KF + 1) 2^(k-1) slots a wave; an undersized bound would zero-pad
    real children in K3 and break the cache's subtraction, which shows
    as leaf counts that no longer partition the rows."""
    rng = np.random.RandomState(7)
    n = 16384
    X = rng.rand(n, 6).astype(np.float32)
    y = (X[:, 0] + 2 * X[:, 1] * X[:, 2] + 0.5 * np.sin(6 * X[:, 3])
         + 0.1 * rng.randn(n)).astype(np.float32)
    path = tmp_path / "deep.json"
    path.write_text(json.dumps({"feature": 5, "threshold": 0.5,
                                "right": {"feature": 4, "threshold": 0.5}}))
    b = tlgb.train({"objective": "regression", "num_leaves": 96,
                    "verbosity": -1, "min_data_in_leaf": 2,
                    "tpu_growth_strategy": "wave", **CPU,
                    "forcedsplits_filename": str(path)},
                   tlgb.Dataset(X, label=y), 2)
    for t in b._gbdt.models_:
        assert t.split_feature[0] == 5 and t.split_feature[1] == 4
        assert t.num_leaves >= 64, t.num_leaves
        assert int(t.leaf_count[:t.num_leaves].sum()) == n
        assert int(t.internal_count[0]) == n


@pytest.mark.parametrize("engine", ["wave", "leafwise"])
def test_interaction_paths_stay_in_one_set(engine):
    """More trees and leaves than the JAX comparison: every path stays in
    one set, the string and list forms grow the same model, and without
    constraints paths do mix sets."""
    X, y, wt = _data()
    params = {**BASE, **CPU, "num_leaves": 31, "tpu_growth_strategy": engine,
              "min_data_in_leaf": 5}
    models = {}
    for form, ic in (("string", "[0,1,2],[3,4,5],[6,7]"), ("list", SETS),
                     ("free", None)):
        p = params if ic is None else {**params,
                                       "interaction_constraints": ic}
        models[form] = tlgb.train(p, tlgb.Dataset(X, label=y, weight=wt),
                                  6)._gbdt.models_
    mixed = False
    for ts, tl, tf in zip(models["string"], models["list"], models["free"]):
        np.testing.assert_array_equal(ts.split_feature, tl.split_feature)
        np.testing.assert_array_equal(ts.threshold, tl.threshold)
        for feats in _paths(ts):
            assert any(feats <= set(s) for s in SETS), feats
        mixed |= any(not any(feats <= set(s) for s in SETS)
                     for feats in _paths(tf))
    assert mixed
