"""PyTorch port: data-parallel training (tree_learner=data) over
torch.distributed, on the CPU.

Worlds of 2 and 3 gloo ranks are spawned once for the module by
tests/torch_cluster.py `run_cluster` (one child process per rank, joined
over a FileStore in a temporary directory); the children run every
scenario in turn and write each rank's model text and training metrics.

* Port against itself: each scenario's model text on every rank equals,
  byte for byte, the text of the port's serial run with the same params
  (tree_learner=data without a process group trains on one device): the
  wave, leaf-wise and quantized engines, bagging, GOSS, multiclass,
  forced splits with monotone constraints, interaction constraints,
  CEGB, extra-trees with bynode sampling, weights, DART, RF, EFB
  bundles, the skewed-max grid
  case (one shard's labels 1000x the other's: the fixed-point grid must
  be the serial run's, not a rank's), shards of uneven rows (4,096
  rows over 3 ranks, and 4,001 rows, where the serial run pads too),
  lambdarank and rank_xendcg with and without position bias (queries of
  4-40 rows and one longer than a world-3 shard), leaf renewal by
  percentile (L1 with bagging, weighted quantile, MAPE) and linear
  trees on both engines.
* Port against JAX: the sharded trees have the structure of the JAX
  package's `tree_learner=data` trees on its 8-device mesh
  (`tpu_growth_strategy` pinned in both): the structure fields equal by
  the rule of tests/test_parallel.py `_structure_text`, the floats to 5
  significant digits (within one unit of the 5th: a value on a rounding
  boundary rounds either way between the packages).
* The sharded train eval: every rank reads the same metrics, equal (rtol
  1e-5) to the JAX package's sharded device forms (`device_binned_auc`,
  `device_binned_average_precision`, `device_pointwise_loss`,
  `device_auc_mu`, `ndcg_device_plan`, `map_device_plan`) on the same
  scores.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from torch_cluster import query_sizes, run_cluster

torch.set_num_threads(1)

N, F = 4096, 6
DEADLINE_S = 150
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.2, "max_bin": 32, "verbosity": -1,
        "tree_learner": "data", "device_type": "cpu"}
BIN_METRICS = ["auc", "average_precision", "binary_logloss", "binary_error"]
MC_METRICS = ["multi_logloss", "multi_error", "auc_mu"]
RANK = {"metric": ["ndcg", "map"], "eval_at": [1, 3, 5]}
LONG_QUERY = 1500         # rows of one query: more than a world-3 shard

# name -> (params over BASE, rounds, data)
SCENARIOS = {
    "wave": ({"tpu_growth_strategy": "wave", "metric": BIN_METRICS}, 6,
             "binary"),
    "leafwise": ({"tpu_growth_strategy": "leafwise",
                  "metric": BIN_METRICS}, 6, "binary"),
    "quantized": ({"use_quantized_grad": True}, 6, "binary"),
    "quantized_sr_renew": ({"use_quantized_grad": True,
                            "stochastic_rounding": True,
                            "quant_train_renew_leaf": True}, 4, "binary"),
    "bagging": ({"bagging_fraction": 0.7, "bagging_freq": 1,
                 "feature_fraction": 0.8}, 6, "binary"),
    "goss": ({"data_sample_strategy": "goss", "learning_rate": 0.5}, 6,
             "binary"),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "metric": MC_METRICS}, 4, "multiclass"),
    "forced_monotone": ({"forcedsplits_filename": "@forced",
                         "monotone_constraints": [1, 0, 0, -1, 0, 0]}, 4,
                        "binary"),
    "interaction_cegb": ({"interaction_constraints": [[0, 1, 2], [3, 4, 5]],
                          "cegb_penalty_split": 1e-3,
                          "tpu_growth_strategy": "leafwise"}, 4, "binary"),
    "extra_bynode": ({"extra_trees": True, "feature_fraction_bynode": 0.7},
                     4, "binary"),
    "weighted_regression": ({"objective": "regression", "metric": ["l2"]},
                            4, "weighted"),
    "skewed_max": ({"objective": "regression", "metric": ["l2", "l1"]}, 4,
                   "skewed"),
    "uneven_rows": ({"tpu_growth_strategy": "leafwise"}, 4, "uneven"),
    "dart": ({"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}, 4,
             "binary"),
    "rf": ({"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1,
            "tpu_growth_strategy": "leafwise"}, 4, "binary"),
    "efb_onehot": ({}, 4, "onehot"),
    "lambdarank": ({"objective": "lambdarank", **RANK}, 3, "rank"),
    "lambdarank_position": ({"objective": "lambdarank", **RANK}, 3,
                            "rank_position"),
    "xendcg": ({"objective": "rank_xendcg", **RANK}, 3, "rank"),
    "xendcg_position": ({"objective": "rank_xendcg", **RANK}, 3,
                        "rank_position"),
    "l1_bagging": ({"objective": "regression_l1", "bagging_fraction": 0.7,
                    "bagging_freq": 1, "metric": ["l1"]}, 3, "regression"),
    "quantile_weighted": ({"objective": "quantile", "alpha": 0.7,
                           "metric": ["quantile"]}, 3, "weighted"),
    "mape": ({"objective": "mape", "metric": ["mape"]}, 3, "regression"),
    "linear_wave": ({"objective": "regression", "linear_tree": True,
                     "tpu_growth_strategy": "wave"}, 3, "regression"),
    "linear_leafwise": ({"objective": "regression", "linear_tree": True,
                         "tpu_growth_strategy": "leafwise"}, 3,
                        "regression"),
    # against the JAX package's mesh run (test_sharded_trees_match_jax_mesh)
    "jax_leafwise": ({"objective": "regression",
                      "tpu_growth_strategy": "leafwise"}, 4, "binary"),
    "jax_wave": ({"objective": "regression", "tpu_growth_strategy": "wave"},
                 4, "binary"),
}

CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
spec = json.load(open(sys.argv[2]))
rank = int(sys.argv[3])
import numpy as np
import torch
torch.set_num_threads(1)
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.distributed import join_cluster, leave_cluster
join_cluster(["localhost:0"] * spec["world"], rank=rank,
             initialize_timeout=spec["timeout"], device_type="cpu",
             store_path=spec["store"])
out = {}
for name, (params, rounds, data) in spec["scenarios"].items():
    d = np.load(spec["data"][data])
    hist = {}
    opt = {k: d[k] for k in ("weight", "group", "position") if k in d.files}
    ds = tlgb.Dataset(d["X"], label=d["y"], **opt)
    b = tlgb.train(params, ds, rounds, valid_sets=[ds],
                   valid_names=["training"],
                   callbacks=[tlgb.record_evaluation(hist)])
    out[name] = {"model": b.model_to_string(),
                 "evals": {k: v[-1] for k, v in
                           hist.get("training", {}).items()},
                 "rows": b._gbdt.shard.count}
leave_cluster()
with open(spec["out"] % rank, "w") as f:
    json.dump(out, f)
"""


def rank_groups(n, seed=5):
    """Query sizes of `n` rows: random sizes of 4-40 around one query of
    LONG_QUERY rows (longer than a shard at world 3)."""
    first = (n - LONG_QUERY) // 2
    return np.array(query_sizes(first, seed) + [LONG_QUERY]
                    + query_sizes(n - first - LONG_QUERY, seed + 1),
                    np.int64)


def make_data(kind):
    """(X, y, weight or None) of a scenario's data kind; the ranking
    kinds' (X, y, {"group": sizes[, "position": ...]})."""
    rng = np.random.RandomState(3)
    n = 4001 if kind == "uneven" else N
    X = rng.rand(n, F)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit))).astype(np.float64)
    w = None
    if kind.startswith("rank"):
        sizes = rank_groups(n)
        y = np.clip(np.floor(logit + 0.5 * rng.randn(n)), 0, 4)
        extra = {"group": sizes}
        if kind == "rank_position":
            starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
            extra["position"] = (np.arange(n) - starts) % 12
        return X, y, extra
    if kind == "regression":
        y = logit + 0.1 * rng.randn(n)
    elif kind == "multiclass":
        y = np.clip(np.floor(X[:, 0] * 3 + 0.3 * rng.randn(n)), 0, 2)
    elif kind == "weighted":
        y = logit + 0.1 * rng.randn(n)
        w = rng.rand(n) + 0.5
    elif kind == "onehot":
        # four dense columns beside a one-hot of 12 levels: EFB bundles
        # the exclusive columns on every rank alike
        level = np.minimum((X[:, 4] * 12).astype(int), 11)
        X = np.column_stack([X[:, :4], np.eye(12)[level]])
        y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit
                                           + 0.2 * level))).astype(float)
    elif kind == "skewed":
        # the first half of the rows (rank 0's shard at world 2) holds
        # labels 1000x smaller than the rest: each shard's own max |g|
        # would give it another fixed-point grid
        y = logit + 0.1 * rng.randn(n)
        y[n // 2:] *= 1000.0
    return X, y, w


def _params(name, forced_path):
    extra, rounds, data = SCENARIOS[name]
    p = {**BASE, **extra}
    if p.get("forcedsplits_filename") == "@forced":
        p["forcedsplits_filename"] = forced_path
    return p, rounds, data


def _write_forced(path):
    with open(path, "w") as f:
        json.dump({"feature": 0, "threshold": 0.5,
                   "left": {"feature": 3, "threshold": 0.4}}, f)


def _dataset_kw(extra):
    """make_data's third item as Dataset keywords."""
    if extra is None:
        return {}
    return dict(extra) if isinstance(extra, dict) else {"weight": extra}


def run_world(world, tmp, names=None):
    """Spawn `world` ranks of CHILD (tests/torch_cluster.py `run_cluster`)
    that run the scenarios `names` (default: all); returns [per rank
    {scenario: {model, evals, rows}}]."""
    names = list(SCENARIOS) if names is None else names
    os.makedirs(tmp, exist_ok=True)
    forced = os.path.join(tmp, "forced.json")
    _write_forced(forced)
    data = {}
    for kind in {SCENARIOS[n][2] for n in names}:
        X, y, w = make_data(kind)
        path = os.path.join(tmp, f"{kind}.npz")
        np.savez(path, X=X, y=y, **_dataset_kw(w))
        data[kind] = path
    return run_cluster(world, tmp, {n: _params(n, forced) for n in names},
                       data, DEADLINE_S, child=CHILD)


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    w = request.param
    return w, run_world(w, str(tmp_path_factory.mktemp(f"world{w}")))


_SERIAL = {}


def serial_booster(name, tmp):
    """The port's serial run of a scenario (no process group)."""
    if name not in _SERIAL:
        forced = os.path.join(tmp, "forced.json")
        _write_forced(forced)
        params, rounds, data = _params(name, forced)
        X, y, w = make_data(data)
        ds = tlgb.Dataset(X, label=y, **_dataset_kw(w))
        b = tlgb.train(params, ds, rounds)
        _SERIAL[name] = (b, params)
    return _SERIAL[name]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_model_text_equals_serial(world, name, tmp_path):
    w, ranks = world
    serial, _ = serial_booster(name, str(tmp_path))
    want = serial.model_to_string()
    for r, out in enumerate(ranks):
        got = out[name]["model"]
        if "forced" in name:
            # the parameters block names the forced-splits file, which
            # lies in the children's and the parent's own directories
            got = re.sub(r"forcedsplits_filename: \S+",
                         "forcedsplits_filename: @", got)
            want = re.sub(r"forcedsplits_filename: \S+",
                          "forcedsplits_filename: @", want)
        assert got == want, (name, w, r)
    rows = [out[name]["rows"] for out in ranks]
    assert sum(rows) == serial._gbdt.num_data
    assert len(set(rows)) > 1 or serial._gbdt.num_data % w == 0


def test_forced_splits_and_monotone_applied(world, tmp_path):
    """The forced prologue and the monotone constraint hold in the
    sharded trees (which equal the serial ones)."""
    _, ranks = world
    b = tlgb.Booster(model_str=ranks[0]["forced_monotone"]["model"],
                     params={"device_type": "cpu"})
    for t in b._gbdt.models_:
        assert t.split_feature[0] == 0 and t.num_leaves > 2
    X, _, _ = make_data("binary")
    grid = np.linspace(0, 1, 33)
    rows = np.repeat(X[:64], len(grid), axis=0)
    rows[:, 0] = np.tile(grid, 64)
    pred = b.predict(rows, raw_score=True).reshape(64, len(grid))
    assert np.all(np.diff(pred, axis=1) >= 0)


def test_skewed_max_grid_is_the_serial_one(world, tmp_path):
    """One shard's max |g| is ~1000x the other's: a rank-local grid would
    round the small shard's rows differently from the serial run.  The
    model text equals the serial run's (above); here the per-rank rows
    are checked to be that skewed."""
    w, ranks = world
    _, y, _ = make_data("skewed")
    from lightgbm_tpu_torch.parallel import rows_of
    a, b = rows_of(len(y), w, 0)
    c, d = rows_of(len(y), w, w - 1)
    assert np.abs(y[c:d]).max() > 100 * np.abs(y[a:b]).max()


@pytest.mark.parametrize("name", ["wave", "leafwise", "multiclass",
                                  "weighted_regression", "skewed_max",
                                  "lambdarank", "xendcg_position",
                                  "l1_bagging"])
def test_sharded_eval_same_on_every_rank(world, name):
    _, ranks = world
    evals = [out[name]["evals"] for out in ranks]
    assert evals[0] and all(e == evals[0] for e in evals[1:])


def _jax_sharded_eval(name, booster):
    """The JAX package's sharded device forms on the serial port run's
    final training scores (the same scores every rank holds)."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.metric import (device_auc_mu, device_binned_auc,
                                     device_binned_average_precision,
                                     device_pointwise_loss)
    g = booster._gbdt
    n = g.num_data
    sc = g.scores[:, :n].numpy().astype(np.float32)
    md = g.train_data.metadata
    if g.config.objective in ("lambdarank", "rank_xendcg"):
        return _jax_rank_plans(g, sc[0], md)
    label = jnp.asarray(np.asarray(md.label, np.float32))
    w = jnp.asarray(np.ones(n, np.float32) if md.weight is None
                    else np.asarray(md.weight, np.float32))
    cfg = JConfig({"objective": g.config.objective,
                   "num_class": g.config.num_class})
    out = {}
    if g.num_tree_per_iteration > 1:
        s = jnp.asarray(sc)
        prob = jnp.exp(s - s.max(0)) / jnp.exp(s - s.max(0)).sum(0)
        K = prob.shape[0]
        p_lab = jnp.sum(jnp.where(label[None, :] == jnp.arange(K)[:, None],
                                  prob, 0.0), 0)
        out["multi_logloss"] = float(jnp.sum(
            -jnp.log(jnp.clip(p_lab, 1e-15, 1.0)) * w) / jnp.sum(w))
        num_ge = jnp.sum(prob >= p_lab[None, :], 0)
        out["multi_error"] = float(jnp.sum((num_ge > 1) * w) / jnp.sum(w))
        W = np.ones((K, K)) - np.eye(K)
        out["auc_mu"] = float(device_auc_mu(s, label, w, W))
        return out
    s = jnp.asarray(sc[0])
    conv = (1.0 / (1.0 + jnp.exp(-s)) if g.config.objective == "binary"
            else s)
    for m in g.config.metric:
        if m == "auc":
            out[m] = float(device_binned_auc(conv, label, w))
        elif m == "average_precision":
            out[m] = float(device_binned_average_precision(conv, label, w))
        else:
            fn = device_pointwise_loss(m, cfg)
            out[m] = float(jnp.sum(fn(conv, label) * w) / jnp.sum(w))
    return out


def _jax_rank_plans(g, sc, md):
    """The JAX package's `ndcg_device_plan` and `map_device_plan` (run on
    the CPU) on the serial run's final scores."""
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.metric import (MapMetric, NDCGMetric, map_device_plan,
                                     ndcg_device_plan)
    cfg = JConfig({"objective": g.config.objective,
                   "eval_at": list(g.config.eval_at)})
    n_pad = len(sc) + 1
    scp = jnp.asarray(np.append(sc, np.float32(0)))
    out = {}
    for cls, plan, name in ((NDCGMetric, ndcg_device_plan, "ndcg"),
                            (MapMetric, map_device_plan, "map")):
        m = cls(cfg)
        m.init(md, len(sc))
        bks, fn = plan(m, n_pad)
        vals = np.asarray(fn(scp, bks))
        out.update({f"{name}@{k}": float(v)
                    for k, v in zip(cfg.eval_at, vals)})
    return out


@pytest.mark.parametrize("name", ["wave", "multiclass",
                                  "weighted_regression", "lambdarank",
                                  "xendcg_position"])
def test_sharded_eval_equals_jax_device_forms(world, name, tmp_path):
    _, ranks = world
    serial, _ = serial_booster(name, str(tmp_path))
    want = _jax_sharded_eval(name, serial)
    got = ranks[0][name]["evals"]
    assert set(want) <= set(got)
    for m, v in want.items():
        np.testing.assert_allclose(got[m], v, rtol=1e-5, atol=1e-7,
                                   err_msg=m)


EXACT_FIELDS = ("num_leaves", "num_cat", "split_feature", "threshold",
                "decision_type", "left_child", "right_child", "leaf_count",
                "internal_count", "is_linear", "shrinkage")
FLOAT_FIELDS = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
                "internal_weight")


def _structure_text(text):
    """tests/test_parallel.py's rule: the model text before the
    parameters block, floats rounded to 5 significant digits."""
    text = text.split("\nparameters:")[0]
    return re.sub(r"-?\d+\.\d+(e[-+]?\d+)?",
                  lambda m: "%.5g" % float(m.group(0)), text)


def _trees(text):
    """Each Tree block of a model text as {field: tokens}."""
    out = []
    for block in text.split("\nparameters:")[0].split("\n\n"):
        if block.startswith("Tree="):
            out.append(dict(ln.split("=", 1) for ln in block.splitlines()
                            if "=" in ln and not ln.startswith("Tree=")))
    return out


def same_structure(jax_text, port_text):
    """The structure fields equal in `_structure_text`'s 5-digit form,
    and every float field within one unit of its 5th significant digit
    (the two packages add their float32 sums in other orders, so a value
    on a rounding boundary may round either way)."""
    jt, tt = _trees(jax_text), _trees(port_text)
    assert len(jt) == len(tt)
    for i, (a, b) in enumerate(zip(jt, tt)):
        for k in EXACT_FIELDS:
            assert _structure_text(a.get(k, "")) == _structure_text(
                b.get(k, "")), (i, k)
        for k in FLOAT_FIELDS:
            x = np.array(a[k].split(), np.float64)
            y = np.array(b[k].split(), np.float64)
            scale = np.maximum(np.abs(x), np.abs(y))
            assert np.all(np.abs(x - y) <= 1e-4 * scale
                          + 1e-4 * np.abs(x).max()), (i, k, x, y)


@pytest.mark.parametrize("strategy", ["leafwise", "wave"])
def test_sharded_trees_match_jax_mesh(world, strategy):
    """The port's sharded trees against the JAX package's
    tree_learner=data trees on its 8-device mesh (regression, as
    tests/test_parallel.py trains it), `tpu_growth_strategy` pinned."""
    import lightgbm_tpu as jlgb
    from lightgbm_tpu.boosting.model_io import save_model_to_string
    w, ranks = world
    extra, rounds, data = SCENARIOS[f"jax_{strategy}"]
    X, y, _ = make_data(data)
    params = {**BASE, **extra}
    params.pop("device_type")
    bj = jlgb.train({**params, "tpu_donate_buffers": False},
                    jlgb.Dataset(X, label=y), num_boost_round=rounds)
    assert bj._gbdt.mesh is not None
    jt = save_model_to_string(bj._gbdt)
    assert len(_trees(jt)) == rounds
    for out in ranks:
        same_structure(jt, out[f"jax_{strategy}"]["model"])
