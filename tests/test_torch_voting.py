"""PyTorch port: the voting-parallel learner (tree_learner=voting, PV-Tree)
over torch.distributed, on the CPU.

Worlds of 2 and 3 gloo ranks are spawned once for the module
(tests/torch_cluster.py).

* At top_k >= F with min_data_in_leaf 40 the vote elects every feature a
  serial scan splits on, and the trees equal the serial leaf-wise run's
  (the JAX package's `test_voting_parallel_full_topk_matches_serial`),
  here byte for byte: the elected histograms are the ranks' int64 sums on
  the serial grid.
* At top_k=2 the predictions correlate with the serial run's above 0.95
  (tests/test_parallel.py's bound), and the run moves a fraction of the
  bytes the data-parallel learner moves on the same problem.
* Voting composes with extra-trees and monotone constraints: at the
  default top_k the trees equal the serial run's with extra-trees on the
  same seed, and with the basic monotone mode that the intermediate one
  falls back to under the vote.
* The election against the JAX package's `voting_hist_elect` on a
  2-device mesh with the same row shards (n = 4096, 2048 rows each): the
  same elected mask, the elected histograms within float32 rounding;
  and its reductions carry k x B x 2 int64 sums, an [F] proposal and a
  count, not the F x B x 2 histogram.
* The JAX package's rules around the vote: EFB is not planned, a
  pre-bundled sparse Dataset falls back to data-parallel, top_k <= 0,
  forced splits and lazy CEGB are fatal, the intermediate monotone mode
  falls back to basic, the leaf-wise engine is forced; at world 1 the
  vote does not engage.
"""

import threading

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_tpu_torch as tlgb
from torch_cluster import run_cluster, save_data

torch.set_num_threads(1)

N, F = 2048, 6
BASE = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.2, "verbosity": -1, "tree_learner": "voting",
        "tpu_growth_strategy": "leafwise", "device_type": "cpu"}

SCENARIOS = {
    "full_topk": ({"min_data_in_leaf": 40}, 3, "binary"),
    "top2": ({"top_k": 2, "min_data_in_leaf": 40}, 4, "binary"),
    "data_top2": ({"tree_learner": "data", "min_data_in_leaf": 40}, 4,
                  "binary"),
    "extra_trees": ({"extra_trees": True, "min_data_in_leaf": 40}, 2,
                    "binary"),
    "monotone": ({"monotone_constraints": [1, 0, 0, 0, 0, 0],
                  "monotone_constraints_method": "intermediate",
                  "min_data_in_leaf": 40}, 2, "binary"),
    "wave_asked": ({"tpu_growth_strategy": "wave",
                    "min_data_in_leaf": 40}, 2, "binary"),
    "sparse_fallback": ({"objective": "binary"}, 2, "onehot_csr"),
}


def make_data(kind):
    """tests/test_parallel.py `_problem(n=2048)` (X, y), or a CSR of
    dense columns beside a one-hot (pre-bundled by sparse ingestion)."""
    rng = np.random.RandomState(3)
    X = rng.rand(N, F)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(N) < 1 / (1 + np.exp(-3 * logit))).astype(np.float32)
    if kind == "onehot_csr":
        level = np.minimum((X[:, 4] * 12).astype(int), 11)
        X = sps.csr_matrix(np.column_stack([X[:, :4], np.eye(12)[level]]))
    return X, y


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    w = request.param
    tmp = str(tmp_path_factory.mktemp(f"vworld{w}"))
    data = {k: save_data(tmp, k, *make_data(k))
            for k in {s[2] for s in SCENARIOS.values()}}
    scen = {n: ({**BASE, **p}, r, d) for n, (p, r, d) in SCENARIOS.items()}
    return w, run_cluster(w, tmp, scen, data)


def _serial(name, **over):
    p, rounds, data = SCENARIOS[name]
    X, y = make_data(data)
    params = {**BASE, **p, "tree_learner": "serial", **over}
    return tlgb.train(params, tlgb.Dataset(X, label=y), rounds)


def _trees_text(text):
    return text.split("\nparameters:")[0]


def test_full_topk_equals_serial(world):
    w, ranks = world
    want = _trees_text(_serial("full_topk").model_to_string())
    for out in ranks:
        rep = out["full_topk"]
        assert rep["voting"] and rep["strategy"] == "leafwise"
        assert _trees_text(rep["model"]) == want
    assert sum(out["full_topk"]["rows"] for out in ranks) == N


def test_small_top_k_stays_close_and_moves_fewer_bytes(world):
    w, ranks = world
    X, _ = make_data("binary")
    b = tlgb.Booster(model_str=ranks[0]["top2"]["model"],
                     params={"device_type": "cpu"})
    corr = np.corrcoef(b.predict(X), _serial("top2").predict(X))[0, 1]
    assert corr > 0.95, corr
    for out in ranks:
        vote, data = out["top2"]["bytes"], out["data_top2"]["bytes"]
        # each scan reduces 2 of 6 features' histograms; the data learner
        # reduces one histogram per split, the vote two (no subtraction)
        assert vote < data * (2 / F) * 2 * 1.25, (vote, data)


# the serial run each composition must equal: extra-trees with the same
# seed (the vote elects every feature, the exact scan keeps the draws);
# the intermediate monotone mode falls back to basic under the vote
COMPOSED_SERIAL = {"extra_trees": {},
                   "monotone": {"monotone_constraints_method": "basic"}}


@pytest.mark.parametrize("name", ["extra_trees", "monotone"])
def test_voting_composes(world, name):
    X, _ = make_data("binary")
    _, ranks = world
    want = _trees_text(_serial(name, **COMPOSED_SERIAL[name])
                       .model_to_string())
    for out in ranks:
        assert out[name]["voting"]
        assert _trees_text(out[name]["model"]) == want
    if name == "monotone":
        b = tlgb.Booster(model_str=ranks[0][name]["model"],
                         params={"device_type": "cpu"})
        grid = np.linspace(0, 1, 33)
        rows = np.repeat(X[:32], len(grid), axis=0)
        rows[:, 0] = np.tile(grid, 32)
        pred = b.predict(rows).reshape(32, len(grid))
        assert np.all(np.diff(pred, axis=1) >= -1e-12)


def test_vote_forces_leafwise_and_skips_bundles(world):
    _, ranks = world
    for out in ranks:
        assert out["wave_asked"]["strategy"] == "leafwise"
        assert out["wave_asked"]["voting"]
        # a pre-bundled sparse Dataset cannot vote: data-parallel instead
        rep = out["sparse_fallback"]
        assert not rep["voting"] and rep["bundled"]
        assert rep["rows"] is not None


# --------------------------------------------------- the election itself
class _ThreadNet:
    """A Network of `world` threads of this process (collectives through
    shared slots and a barrier), recording each collective's bytes."""

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank
        self.world = shared["world"]
        self.log = []

    def _collect(self, t, how):
        s = self.shared
        s["slots"][self.rank] = t.clone()
        s["barrier"].wait()
        parts = torch.stack(s["slots"])
        out = parts.sum(0) if how == "sum" else parts.amax(0)
        s["barrier"].wait()
        t.copy_(out)
        self.log.append((how, t.numel() * t.element_size()))
        return t

    def all_reduce_sum_(self, t):
        return self._collect(t, "sum")

    def all_reduce_max_(self, t):
        return self._collect(t, "max")


def _elect_inputs(n=4096, F=6, B=32, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    binned = np.stack([np.clip((X[:, f] * B).astype(np.int64), 0, B - 1)
                       for f in range(F)]).astype(np.uint8)
    logit = 4 * (X[:, 0] - 0.5) + 2 * X[:, 1] * X[:, 2] - X[:, 3]
    y = (rng.rand(n) < 1 / (1 + np.exp(-3 * logit))).astype(np.float32)
    gh = np.stack([0.5 - y, np.full(n, 0.25, np.float32)], 1).astype(
        np.float32)
    member = (rng.rand(n) < 0.7).astype(np.float32)
    return binned, gh, member


@pytest.mark.parametrize("top_k", [2, 4])
def test_election_matches_jax_voting_hist_elect(top_k):
    import jax.numpy as jnp
    from lightgbm_tpu.learner import FeatureMeta as JMeta
    from lightgbm_tpu.ops.split import SplitParams as JSplit
    from lightgbm_tpu.parallel import make_mesh
    from lightgbm_tpu.parallel.voting import (VotingSpec as JSpec,
                                              voting_hist_elect as jelect)
    from lightgbm_tpu_torch.learner import FeatureMeta
    from lightgbm_tpu_torch.ops.histogram import (fixed_unit, from_fixed,
                                                  scale_exps)
    from lightgbm_tpu_torch.ops.split import SplitParams
    from lightgbm_tpu_torch.parallel import (VotingSpec, rows_of,
                                             voting_hist_elect)
    binned, gh, member = _elect_inputs()
    F, n = binned.shape
    B = 32
    cm = np.ones(F, bool)
    cm[5] = False
    jm = JMeta(num_bin=jnp.full(F, B, jnp.int32),
               missing_type=jnp.zeros(F, jnp.int32),
               default_bin=jnp.zeros(F, jnp.int32),
               penalty=jnp.ones(F, jnp.float32))
    jh, jel = jelect(jnp.asarray(binned), jnp.asarray(gh),
                     jnp.asarray(member), jnp.asarray(cm), 0.0, jm,
                     JSpec(make_mesh(2), top_k, 2),
                     JSplit(min_data_in_leaf=40), B, "segment")
    jh, jel = np.asarray(jh), np.asarray(jel)

    meta = FeatureMeta(num_bin=torch.full((F,), B, dtype=torch.int32),
                       missing_type=torch.zeros(F, dtype=torch.int32),
                       default_bin=torch.zeros(F, dtype=torch.int32),
                       penalty=torch.ones(F))
    ght = torch.from_numpy(gh)
    exps = scale_exps(ght, n)          # the serial run's grid
    shared = {"world": 2, "slots": [None, None],
              "barrier": threading.Barrier(2, timeout=60)}
    res, nets = [None, None], []

    def rank_main(r):
        net = _ThreadNet(shared, r)
        nets.append(net)
        a, b = rows_of(n, 2, r)
        rows = torch.from_numpy(np.ascontiguousarray(binned[:, a:b].T))
        res[r] = voting_hist_elect(
            rows, ght[a:b].contiguous(), torch.from_numpy(member[a:b]),
            torch.from_numpy(cm), torch.tensor(0.0), meta,
            VotingSpec(net, top_k, 2), SplitParams(min_data_in_leaf=40),
            B, exps)

    threads = [threading.Thread(target=rank_main, args=(r,))
               for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    (h0, e0), (h1, e1) = res
    assert torch.equal(h0, h1) and torch.equal(e0, e1)
    np.testing.assert_array_equal(e0.numpy(), jel)
    assert int(e0.sum()) == top_k
    got = from_fixed(h0, fixed_unit(exps)).numpy()
    np.testing.assert_allclose(got[jel], jh[jel], rtol=2e-6, atol=1e-4)
    assert np.all(got[~jel] == 0)
    # the traffic: a count, the [F] proposal, k elected [B, 2] histograms
    for net in nets:
        assert net.log == [("sum", 8), ("max", 4 * F),
                           ("sum", top_k * B * 2 * 8)]


# ---------------------------------------------- the JAX package's rules
@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    """This process as rank 0 of a one-machine group: the vote does not
    engage at world 1 (the serial trees), as the JAX package's mesh of
    one device."""
    from lightgbm_tpu_torch import distributed as tdist
    tdist.join_cluster(["localhost:0"], rank=0, device_type="cpu",
                       initialize_timeout=60,
                       store_path=str(tmp_path / "store"))
    try:
        yield
    finally:
        tdist.leave_cluster()


def test_world_one_does_not_vote(world_of_one):
    X, y = make_data("binary")
    b = tlgb.train({**BASE, "min_data_in_leaf": 40},
                   tlgb.Dataset(X, label=y), 2)
    assert b._gbdt.voting is None and b._gbdt.shard is not None
    assert _trees_text(b.model_to_string()) == _serial_rounds(2)


def _serial_rounds(rounds):
    X, y = make_data("binary")
    return _trees_text(tlgb.train(
        {**BASE, "min_data_in_leaf": 40, "tree_learner": "serial"},
        tlgb.Dataset(X, label=y), rounds).model_to_string())


@pytest.mark.parametrize("extra,match", [
    ({"top_k": 0}, "top_k should be greater than 0"),
    ({"forcedsplits_filename": "@forced"}, "does not support forced"),
    ({"cegb_penalty_feature_lazy": [0.1] * F},
     "cegb_penalty_feature_lazy is not supported"),
])
def test_fatal_cases(extra, match, tmp_path):
    """Under an engaged vote (a world of two ranks), as the JAX booster
    refuses them (gbdt.py:424-426, 528-535)."""
    import json
    params = {**BASE, **extra}
    if extra.get("forcedsplits_filename"):
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({"feature": 0, "threshold": 0.5}))
        params["forcedsplits_filename"] = str(path)
    X, y = make_data("binary")
    data = {"binary": save_data(str(tmp_path), "binary", X[:1024],
                                y[:1024])}
    with pytest.raises(AssertionError) as err:
        run_cluster(2, str(tmp_path), {"c": (params, 1, "binary")}, data,
                    deadline_s=60)
    assert match in str(err.value)


def test_without_a_group_voting_trains_serially():
    X, y = make_data("binary")
    b = tlgb.train({**BASE, "min_data_in_leaf": 40, "top_k": 2},
                   tlgb.Dataset(X, label=y), 2)
    assert b._gbdt.voting is None and b._gbdt.shard is None
    assert _trees_text(b.model_to_string()) == _serial_rounds(2)
