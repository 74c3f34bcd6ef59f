"""PyTorch port: the feature-parallel learner (tree_learner=feature) over
torch.distributed, on the CPU.

Worlds of 2 and 3 gloo ranks are spawned once for the module
(tests/torch_cluster.py); the children train every scenario in turn.

* Port against itself: each scenario's model text on every rank equals,
  byte for byte, the text of the port's serial run with the same params
  (tree_learner=feature without a process group trains on one device):
  the wave, leaf-wise and quantized engines, categorical features,
  forced splits with monotone constraints, the advanced monotone mode,
  interaction constraints with CEGB's split and coupled penalties, lazy
  CEGB, extra-trees with bynode sampling, multiclass, EFB bundles from a
  CSR matrix, 7 columns over 3 ranks (unequal blocks), a world that
  outnumbers the columns (a rank with no block; quantized too), leaf
  renewal by percentile (L1, quantile, MAPE), linear trees on both
  engines, lambdarank and rank_xendcg.
* The blocks: contiguous, `rows_of`-balanced over the device columns,
  covering every column once; every row stays on every rank; a scan
  moves kilobytes (the per-leaf best records), not histograms.
* Port against JAX: the trees hold the structure of the JAX package's
  `tree_learner=feature` trees on its 8-device mesh (the problem of
  tests/test_parallel.py `test_feature_parallel_training_identical_model`),
  floats within one unit of the 5th significant digit.
* The block scan: find_best_split's per-feature gains over a block of
  columns are bit for bit the matching columns of the gains over all
  columns (numerical, categorical, monotone, extra-trees and CEGB scans),
  which the learner's exactness rests on.
"""

import os
import re

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu_torch as tlgb
from torch_cluster import query_sizes, run_cluster, save_data

torch.set_num_threads(1)

N, F = 4096, 6
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.2, "max_bin": 32, "verbosity": -1,
        "tree_learner": "feature", "device_type": "cpu"}

# name -> (params over BASE, rounds, data)
SCENARIOS = {
    "wave": ({"tpu_growth_strategy": "wave"}, 4, "binary"),
    "leafwise": ({"tpu_growth_strategy": "leafwise"}, 4, "binary"),
    "quantized": ({"use_quantized_grad": True}, 4, "binary"),
    "categorical": ({"categorical_feature": [4]}, 4, "categorical"),
    "forced_monotone": ({"forcedsplits_filename": "@forced",
                         "monotone_constraints": [1, 0, 0, -1, 0, 0]}, 3,
                        "binary"),
    "monotone_advanced": ({"monotone_constraints": [1, 0, 0, -1, 0, 0],
                           "monotone_constraints_method": "advanced"}, 3,
                          "binary"),
    "interaction_cegb": ({"interaction_constraints": [[0, 1, 2], [3, 4, 5]],
                          "cegb_penalty_split": 1e-3,
                          "cegb_penalty_feature_coupled":
                              [0.5, 0.1, 0.2, 0.3, 0.0, 0.4]}, 3, "binary"),
    "lazy_cegb": ({"cegb_penalty_feature_lazy":
                   [0.01, 0.02, 0.0, 0.03, 0.01, 0.0]}, 3, "binary"),
    "extra_bynode": ({"extra_trees": True, "feature_fraction_bynode": 0.7},
                     3, "binary"),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, 3,
                   "multiclass"),
    "efb_csr": ({}, 3, "onehot_csr"),
    "seven_columns": ({"tpu_growth_strategy": "leafwise"}, 3, "seven"),
    "more_ranks_than_columns": ({}, 3, "two"),
    "more_ranks_than_columns_quantized": ({"use_quantized_grad": True}, 3,
                                          "two"),
    "l1": ({"objective": "regression_l1"}, 3, "regression"),
    "quantile": ({"objective": "quantile", "alpha": 0.7}, 3, "regression"),
    "mape": ({"objective": "mape"}, 3, "regression"),
    "linear_wave": ({"objective": "regression", "linear_tree": True,
                     "tpu_growth_strategy": "wave"}, 3, "regression"),
    "linear_leafwise": ({"objective": "regression", "linear_tree": True,
                         "tpu_growth_strategy": "leafwise"}, 3,
                        "regression"),
    "lambdarank": ({"objective": "lambdarank"}, 3, "rank"),
    "rank_xendcg": ({"objective": "rank_xendcg"}, 3, "rank"),
    # against the JAX package's mesh run (test_trees_match_jax_mesh)
    "jax": ({"objective": "regression", "tpu_growth_strategy": "leafwise",
             "max_bin": 255}, 4, "jax"),
}


# the query sizes of a data kind
GROUP = {"rank": query_sizes(N)}


def make_data(kind):
    """(X, y) of a scenario's data kind (the query sizes in GROUP)."""
    rng = np.random.RandomState(3)
    n = 2048 if kind == "jax" else N
    X = rng.rand(n, F)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit))).astype(np.float64)
    if kind == "jax":
        # tests/test_parallel.py `_problem(n=2048)`
        y = y.astype(np.float32)
    elif kind == "multiclass":
        y = np.clip(np.floor(X[:, 0] * 3 + 0.3 * rng.randn(n)), 0, 2)
    elif kind == "categorical":
        X[:, 4] = np.floor(X[:, 4] * 9)
        y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit + 0.4 * X[:, 4]
                                           - 1.5 * (X[:, 4] == 3)))
             ).astype(np.float64)
    elif kind == "onehot_csr":
        # four dense columns beside a one-hot of 12 levels: EFB bundles
        # the exclusive columns (the CSR arrives pre-bundled)
        level = np.minimum((X[:, 4] * 12).astype(int), 11)
        X = sps.csr_matrix(np.column_stack([X[:, :4], np.eye(12)[level]]))
        y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit
                                           + 0.2 * level))).astype(float)
    elif kind == "regression":
        y = logit + 0.1 * rng.randn(n)
    elif kind == "rank":
        y = np.clip(np.floor(logit + 0.5 * rng.randn(n)), 0, 4)
    elif kind == "seven":
        X = np.column_stack([X, rng.rand(n)])
    elif kind == "two":
        X = X[:, :2]
        y = (rng.rand(n) < 1 / (1 + np.exp(-4 * (X[:, 0] - X[:, 1])))
             ).astype(np.float64)
    return X, y


def _params(name, forced_path):
    extra, rounds, data = SCENARIOS[name]
    p = {**BASE, **extra}
    if p.get("forcedsplits_filename") == "@forced":
        p["forcedsplits_filename"] = forced_path
    return p, rounds, data


def _write_forced(path):
    import json
    with open(path, "w") as f:
        json.dump({"feature": 0, "threshold": 0.5,
                   "left": {"feature": 3, "threshold": 0.4}}, f)


def _run(world, tmp):
    forced = os.path.join(tmp, "forced.json")
    os.makedirs(tmp, exist_ok=True)
    _write_forced(forced)
    data = {}
    for kind in {SCENARIOS[n][2] for n in SCENARIOS}:
        X, y = make_data(kind)
        data[kind] = save_data(tmp, kind, X, y, group=GROUP.get(kind))
    return run_cluster(world, tmp, {n: _params(n, forced)
                                    for n in SCENARIOS}, data)


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    w = request.param
    return w, _run(w, str(tmp_path_factory.mktemp(f"fworld{w}")))


_SERIAL = {}


def serial_booster(name, tmp):
    """The port's serial run of a scenario (no process group)."""
    if name not in _SERIAL:
        forced = os.path.join(tmp, "forced.json")
        _write_forced(forced)
        params, rounds, data = _params(name, forced)
        X, y = make_data(data)
        b = tlgb.train(params, tlgb.Dataset(X, label=y, group=GROUP.get(data),
                                            params=params), rounds)
        _SERIAL[name] = b
    return _SERIAL[name]


def _no_forced_path(text):
    return re.sub(r"forcedsplits_filename: \S+", "forcedsplits_filename: @",
                  text)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_feature_parallel_model_text_equals_serial(world, name, tmp_path):
    w, ranks = world
    serial = serial_booster(name, str(tmp_path))
    want = _no_forced_path(serial.model_to_string())
    for r, out in enumerate(ranks):
        assert _no_forced_path(out[name]["model"]) == want, (name, w, r)
        # every rank keeps every row: nothing is row-sharded
        assert out[name]["rows"] is None and not out[name]["voting"]
    if name == "efb_csr":
        assert all(out[name]["bundled"] for out in ranks)


@pytest.mark.parametrize("name", ["wave", "efb_csr", "seven_columns",
                                  "more_ranks_than_columns"])
def test_blocks_cover_the_columns_once(world, name):
    """rows_of-balanced contiguous blocks of the device columns; with
    more ranks than columns the last ranks hold none."""
    from lightgbm_tpu_torch.parallel import rows_of
    w, ranks = world
    blocks = [out[name]["block"] for out in ranks]
    ncols = blocks[-1][1]
    assert [b[:2] for b in blocks] == [list(rows_of(ncols, w, r))
                                       for r in range(w)]
    assert blocks[0][0] == 0
    for a, b in zip(blocks, blocks[1:]):
        assert a[1] == b[0]
    if name == "seven_columns" and w == 3:
        assert [b[1] - b[0] for b in blocks] == [3, 2, 2]
    if name == "more_ranks_than_columns" and w == 3:
        assert blocks[-1][1] - blocks[-1][0] == 0 and blocks[-1][2] == 0


def test_scans_move_records_not_histograms(world):
    """The wave run's traffic: one all-gather of the per-leaf best
    records per scan, kilobytes per tree, far below one F x B x 2
    histogram of int64 per leaf."""
    w, ranks = world
    for out in ranks:
        rep = out["wave"]
        assert rep["calls"] > 0
        per_tree = rep["bytes"] / SCENARIOS["wave"][1]
        assert per_tree < 64 * 1024
        assert per_tree < 15 * F * 32 * 2 * 8


def test_forced_and_monotone_hold(world):
    _, ranks = world
    b = tlgb.Booster(model_str=ranks[0]["forced_monotone"]["model"],
                     params={"device_type": "cpu"})
    for t in b._gbdt.models_:
        assert t.split_feature[0] == 0 and t.num_leaves > 2
    X, _ = make_data("binary")
    grid = np.linspace(0, 1, 33)
    rows = np.repeat(X[:64], len(grid), axis=0)
    rows[:, 0] = np.tile(grid, 64)
    pred = b.predict(rows, raw_score=True).reshape(64, len(grid))
    assert np.all(np.diff(pred, axis=1) >= 0)


def test_trees_match_jax_mesh(world):
    """Against the JAX package's tree_learner=feature on its 8-device
    mesh (tests/test_parallel.py trains this problem so): the structure
    fields equal, the floats within one unit of the 5th digit."""
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.boosting.model_io import save_model_to_string
    from test_torch_data_parallel import _trees, same_structure
    _, ranks = world
    extra, rounds, data = SCENARIOS["jax"]
    X, y = make_data(data)
    params = {**BASE, **extra}
    params.pop("device_type")
    params.pop("max_bin")
    bj = jlgb.train({**params, "tpu_donate_buffers": False},
                    jlgb.Dataset(X, label=y), num_boost_round=rounds)
    assert bj._gbdt.mesh is not None
    jt = save_model_to_string(bj._gbdt)
    assert len(_trees(jt)) == rounds
    for out in ranks:
        same_structure(jt, out["jax"]["model"])


# ---------------------------------------------------------- the block scan
def _scan_inputs(L=5, F=9, B=16, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(L, F, B).astype(np.float32)
    h = (rng.rand(L, F, B) + 0.1).astype(np.float32)
    hist = torch.from_numpy(np.stack([g, h], -1))
    nb = torch.from_numpy(rng.randint(3, B + 1, F).astype(np.int32))
    mt = torch.from_numpy(rng.randint(0, 3, F).astype(np.int32))
    db = torch.from_numpy((rng.randint(0, 3, F)).astype(np.int32))
    pen = torch.from_numpy((0.5 + rng.rand(F)).astype(np.float32))
    sg = hist[..., 0].sum((1, 2)) / F
    sh = hist[..., 1].sum((1, 2)) / F
    cnt = torch.full((L,), 4000, dtype=torch.int32)
    po = torch.from_numpy(rng.randn(L).astype(np.float32) * 0.1)
    return hist, nb, mt, db, pen, sg, sh, cnt, po, rng


@pytest.mark.parametrize("mode", ["numerical", "categorical", "monotone",
                                  "extra_trees", "cegb"])
def test_block_feature_gains_are_the_columns_of_all(mode):
    from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split
    hist, nb, mt, db, pen, sg, sh, cnt, po, rng = _scan_inputs()
    L, F, B, _ = hist.shape
    cm = torch.from_numpy(rng.rand(L, F) > 0.2)
    sp = SplitParams(min_data_in_leaf=5, lambda_l2=0.5)
    kw = {}
    cats = (1, 4, 7)
    if mode == "categorical":
        is_cat = torch.zeros(F, dtype=torch.bool)
        is_cat[list(cats)] = True
        sp = sp._replace(has_categorical=True, cat_features=cats,
                         max_cat_to_onehot=4)
        kw["is_cat_feature"] = is_cat
    elif mode == "monotone":
        mono = torch.from_numpy(rng.randint(-1, 2, F).astype(np.int32))
        sp = sp._replace(has_monotone=True, monotone_penalty=0.5)
        kw.update(monotone=mono, constraint_min=torch.full((L,), -0.3),
                  constraint_max=torch.full((L,), 0.4),
                  mono_penalty=torch.from_numpy(
                      rng.rand(L).astype(np.float32)))
    elif mode == "extra_trees":
        sp = sp._replace(extra_trees=True)
        kw["rand_bin"] = torch.from_numpy(
            rng.randint(0, B - 2, (L, F)).astype(np.int32))
    elif mode == "cegb":
        sp = sp._replace(has_cegb=True, cegb_tradeoff=0.5,
                         cegb_penalty_split=1e-4)
        kw.update(cegb_coupled=torch.from_numpy(
            rng.rand(F).astype(np.float32)),
            cegb_used=torch.from_numpy(rng.rand(F) > 0.5))
    full = find_best_split(hist, nb, mt, db, pen, cm, sg, sh, cnt, po, sp,
                           return_feature_gains=True, **kw)
    assert (full > float("-inf")).any()
    for lo, hi in ((0, 3), (3, 5), (5, 9), (2, 8)):
        part = {}
        for k, v in kw.items():
            part[k] = v[..., lo:hi] if v.dim() and v.shape[-1] == F else v
        if mode == "categorical":
            part["is_cat_feature"] = kw["is_cat_feature"][lo:hi]
            local = tuple(c - lo for c in cats if lo <= c < hi)
            spb = (sp._replace(cat_features=local) if local
                   else sp._replace(has_categorical=False, cat_features=()))
        else:
            spb = sp
        got = find_best_split(hist[:, lo:hi], nb[lo:hi], mt[lo:hi],
                              db[lo:hi], pen[lo:hi], cm[:, lo:hi], sg, sh,
                              cnt, po, spb, return_feature_gains=True,
                              **part)
        assert torch.equal(got.view(torch.int32),
                           full[:, lo:hi].contiguous().view(torch.int32)), \
            (mode, lo, hi)


def test_block_split_is_the_serial_split():
    """ColumnBlock.best_split at world 1 over a block that holds every
    feature is find_best_split's SplitResult, field for field."""
    from lightgbm_tpu_torch.learner import FeatureMeta
    from lightgbm_tpu_torch.ops.split import SplitParams, find_best_split
    from lightgbm_tpu_torch.parallel import ColumnBlock

    class One:
        world, rank, backend = 1, 0, "gloo"

    hist, nb, mt, db, pen, sg, sh, cnt, po, rng = _scan_inputs(seed=1)
    L, F, B, _ = hist.shape
    meta = FeatureMeta(num_bin=nb, missing_type=mt, default_bin=db,
                       penalty=pen)
    block = ColumnBlock(One(), meta, F)
    cm = torch.ones(F, dtype=torch.bool)
    sp = SplitParams(min_data_in_leaf=5)
    want = find_best_split(hist, nb, mt, db, pen, cm, sg, sh, cnt, po, sp)
    got = block.best_split(hist, cm, sg, sh, cnt, po, sp)
    for k, v in want._asdict().items():
        assert torch.equal(getattr(got, k), v), k
