"""PyTorch port: the ranking objectives (lambdarank, rank_xendcg, position
bias) and `LGBMRanker` against the JAX package, on the CPU.

The oracle is the JAX package's float64 host loop
(`RankingObjective.get_gradients_host`): the port computes the same
formulas in float64 on the scores' device and rounds once to float32, so
its gradients equal the host loop's within rtol 1e-6 (here they are
equal bit for bit).  The JAX package's own device program runs in
float32 and its tests hold it to the host loop at rtol 2e-3, atol 2e-4
(`tests/test_boosting_modes.py`); the port is held to it at that
tolerance too.  XENDCG's uniforms are threefry draws,
`uniform(fold_in(fold_in(PRNGKey(seed), it), q), (m,))`, held bit for
bit against `jax.random`; its gradients are held to the JAX host
formulas fed those uniforms (as `tests/test_xendcg_device.py` does for
the JAX device program).  With position bias both packages draw XENDCG's
uniforms from per-query NumPy streams, and the bias state follows the
host Newton loop within 1e-6.

Training runs the JAX package on its host path (its device programs
replaced by None, as `test_lambdarank_device_vs_host_training_close`
does; for XENDCG its per-query streams replaced by the threefry draws of
each iteration): trees follow the tie rule of
tests/test_torch_categorical.py (`same_trees`), the tie gains taken
from the gradients the JAX run recorded, leaf values within rtol 1e-4
plus atol 1e-6 (the JAX package's float32 leaf sums).
"""

import types

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import jax

import lightgbm_tpu as jlgb
import lightgbm_tpu.ranking as jrank
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import Metadata as JMetadata
from lightgbm_tpu.metric import bucket_queries as jbucket_queries
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import ranking as trank
from lightgbm_tpu_torch.boosting.gbdt import _PAD, discretize_gradients
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.metric import NDCGMetric, bucket_queries
from lightgbm_tpu_torch.utils import random as R
from test_torch_categorical import lam_of_booster, same_trees

CPU = {"device_type": "cpu"}
LENS = [1, 2, 3, 7, 8, 9, 31, 40, 64, 100, 130]
ROUNDS = 3
BASE = {"num_leaves": 15, "max_bin": 63, "learning_rate": 0.2,
        "min_data_in_leaf": 10, "verbosity": -1,
        "tpu_donate_buffers": False}


def _metadata(mod, labels, lens, weight=None, position=None):
    md = mod(len(labels))
    md.set_label(labels)
    md.set_group(np.asarray(lens, np.int64))
    md.set_weight(weight)
    if position is not None:
        md.set_position(position)
    return md


def _objectives(name, labels, lens, weight=None, position=None, **params):
    """The JAX package's and the port's objective on the same query
    metadata."""
    p = {"objective": name, **params}
    cls_j = {"lambdarank": jrank.LambdarankNDCG,
             "rank_xendcg": jrank.RankXENDCG}[name]
    cls_t = {"lambdarank": trank.LambdarankNDCG,
             "rank_xendcg": trank.RankXENDCG}[name]
    n = len(labels)
    oj = cls_j(JConfig(p))
    oj.init(_metadata(JMetadata, labels, lens, weight, position), n)
    ot = cls_t(TConfig(p))
    ot.init(_metadata(TMetadata, labels, lens, weight, position), n)
    return oj, ot


def _padded(v, n_pad, dtype=torch.float32):
    out = torch.zeros(n_pad, dtype=dtype)
    out[:len(v)] = torch.from_numpy(np.asarray(v)).to(dtype)
    return out


# ------------------------------------------------------------ buckets
@pytest.mark.parametrize("lens,n_pad", [
    (LENS, 1024), ([0, 1, 8, 9, 16, 17, 1251], 2048), ([5] * 40, 200)])
def test_bucket_queries_equal_jax(lens, n_pad):
    qb = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    got, want = bucket_queries(qb, n_pad), jbucket_queries(qb, n_pad)
    assert [b["m"] for b in got] == [b["m"] for b in want]
    for a, b in zip(got, want):
        assert a["qs"] == b["qs"]
        np.testing.assert_array_equal(a["idx"], b["idx"])
        np.testing.assert_array_equal(a["val"], b["val"])


# ------------------------------------------------- lambdarank gradients
CASES = {"norm": {}, "no_norm": {"lambdarank_norm": False},
         "label_gain": {"label_gain": [0, 1, 2, 5, 11]},
         "weighted": {}, "truncation": {"lambdarank_truncation_level": 5},
         "pad_multiple": {}}


@pytest.mark.parametrize("case", list(CASES))
def test_lambdarank_gradients_match_host(case):
    """The port's device program against the float64 host loop (rtol
    1e-6 after the float32 rounding) and against the JAX device program
    at its own 2e-3 / 2e-4.  `pad_multiple`: n = _PAD rows, so the
    buckets' padding index n_pad - 1 is a real row."""
    rng = np.random.RandomState(3)
    lens = list(LENS)
    if case == "pad_multiple":
        lens.append(_PAD - sum(lens))
    n = sum(lens)
    labels = rng.randint(0, 5, n).astype(np.float64)
    weight = ((0.5 + rng.rand(n)).astype(np.float32)
              if case == "weighted" else None)
    oj, ot = _objectives("lambdarank", labels, lens, weight,
                         **CASES[case])
    score = rng.randn(n).astype(np.float32)
    # ties: the first iteration's scores are all 0
    score[:40] = 0.0
    g_h, h_h = oj.get_gradients_host(score.astype(np.float64))
    n_pad = (n + _PAD - 1) // _PAD * _PAD
    assert n_pad - 1 < n or case != "pad_multiple"
    g_t, h_t = ot.get_gradients(
        _padded(score, n_pad), None,
        None if weight is None else _padded(weight, n_pad))
    assert g_t.dtype == h_t.dtype == torch.float32
    np.testing.assert_allclose(g_t[:n].numpy(), g_h, rtol=1e-6, atol=0)
    np.testing.assert_allclose(h_t[:n].numpy(), h_h, rtol=1e-6, atol=0)
    assert float(g_t[n:].abs().sum()) == float(h_t[n:].abs().sum()) == 0.0
    # the JAX package's float32 device program, at its tests' tolerance
    fn = oj.make_device_grad_fn(n_pad)
    sc = jax.numpy.asarray(_padded(score, n_pad).numpy())[None, :]
    w = None if weight is None else jax.numpy.asarray(
        _padded(weight, n_pad).numpy())
    g_d, h_d = fn(sc, w)
    np.testing.assert_allclose(g_t[:n].numpy(), np.asarray(g_d)[0, :n],
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(h_t[:n].numpy(), np.asarray(h_d)[0, :n],
                               rtol=2e-3, atol=2e-4)


def test_gradients_do_not_depend_on_chunking(monkeypatch):
    """Queries are independent: chunks of one query give the bits of the
    default chunking."""
    rng = np.random.RandomState(4)
    n = sum(LENS)
    labels = rng.randint(0, 5, n).astype(np.float64)
    score = _padded(rng.randn(n), _PAD)
    _, ot = _objectives("lambdarank", labels, LENS)
    want = ot.get_gradients(score)
    monkeypatch.setattr(trank, "PAIR_BUDGET", 1)
    _, ot1 = _objectives("lambdarank", labels, LENS)
    ot1_prog = ot1._program(score)
    assert len(ot1_prog["chunks"]) == len(LENS)
    got = ot1.get_gradients(score)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------- xendcg
@pytest.mark.parametrize("seed,it", [(5, 0), (5, 3), (11, 7)])
def test_xendcg_uniforms_bit_equal_jax(seed, it):
    qs = np.array([0, 1, 5, 17, 1000], np.int64)
    for m in (8, 64, 2048):
        key_it = R.fold_in(R.PRNGKey(seed), it)
        got = R.uniform(R.fold_in(key_it, torch.from_numpy(qs)), (m,))
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        want = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jkey, int(q)), (m,))) for q in qs])
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


class _Draws:
    """A per-query stream that hands the JAX host loop the threefry
    uniforms of the current iteration (state["it"])."""

    def __init__(self, seed, q, m, state):
        self.seed, self.q, self.m, self.state = seed, q, m, state

    def random_sample(self, cnt):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(self.seed), self.state["it"]), self.q)
        return np.asarray(jax.random.uniform(key, (self.m,)),
                          np.float64)[:cnt]


def _feed_threefry(obj, seed):
    """Replace a JAX RankXENDCG's per-query streams by `_Draws`; returns
    the iteration state."""
    state = {"it": 0}
    for b in jbucket_queries(obj.query_boundaries, 8):
        for q in b["qs"]:
            obj.rands[q] = _Draws(seed, q, b["m"], state)
    return state


@pytest.mark.parametrize("weighted", [False, True])
def test_xendcg_gradients_match_host_fed_the_uniforms(weighted):
    """Three calls (it = 0, 1, 2): each equal to the JAX host formulas
    fed that iteration's threefry uniforms."""
    rng = np.random.RandomState(6)
    n = sum(LENS)
    labels = rng.randint(0, 5, n).astype(np.float64)
    weight = (0.5 + rng.rand(n)).astype(np.float32) if weighted else None
    oj, ot = _objectives("rank_xendcg", labels, LENS, weight,
                         objective_seed=9)
    state = _feed_threefry(oj, 9)
    for it in range(3):
        score = rng.randn(n).astype(np.float32)
        state["it"] = it
        g_h, h_h = oj.get_gradients_host(score.astype(np.float64))
        g_t, h_t = ot.get_gradients(
            _padded(score, _PAD), None,
            None if weight is None else _padded(weight, _PAD))
        np.testing.assert_allclose(g_t[:n].numpy(), g_h, rtol=1e-6, atol=0)
        np.testing.assert_allclose(h_t[:n].numpy(), h_h, rtol=1e-6, atol=0)
    assert ot._xe_iter == 3


# ------------------------------------------------------- position bias
@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_position_bias_follows_host_newton_loop(name):
    """Five iterations on scores that move: the gradients equal the host
    loop's (rtol 1e-6) and the bias state stays within 1e-6 of it; a
    second run from the same state gives the same bias bits."""
    rng = np.random.RandomState(7)
    n = sum(LENS)
    labels = rng.randint(0, 5, n).astype(np.float64)
    position = np.concatenate([np.arange(k) for k in LENS]) % 12
    weight = (0.5 + rng.rand(n)).astype(np.float32)
    params = {"lambdarank_position_bias_regularization": 0.1,
              "learning_rate": 0.3}
    oj, ot = _objectives(name, labels, LENS, weight, position, **params)
    _, ot2 = _objectives(name, labels, LENS, weight, position, **params)
    w = _padded(weight, _PAD)
    for it in range(5):
        score = rng.randn(n).astype(np.float32)
        g_h, h_h = oj.get_gradients_host(score.astype(np.float64))
        g_t, h_t = ot.get_gradients(_padded(score, _PAD), None, w)
        ot2.get_gradients(_padded(score, _PAD), None, w)
        np.testing.assert_allclose(g_t[:n].numpy(), g_h, rtol=1e-6, atol=0)
        np.testing.assert_allclose(h_t[:n].numpy(), h_h, rtol=1e-6, atol=0)
        np.testing.assert_allclose(ot.pos_biases, oj.pos_biases, rtol=0,
                                   atol=1e-6)
    assert np.abs(ot.pos_biases).max() > 1e-3
    np.testing.assert_array_equal(ot.pos_biases, ot2.pos_biases)


def test_position_bias_needs_no_float_scatter():
    """The per-position sums are exact on the grid: equal to float64
    bincount within 1e-12 relative on values of mixed sign."""
    rng = np.random.RandomState(8)
    pos = rng.randint(0, 30, 5000)
    v = rng.randn(5000) * 10.0 ** rng.randint(-3, 3, 5000)
    order = np.argsort(pos, kind="stable")
    cnt = np.bincount(pos, minlength=31)
    ends = np.cumsum(cnt)
    prog = {"pos_order": torch.from_numpy(order),
            "pos_start": torch.from_numpy(ends - cnt),
            "pos_end": torch.from_numpy(ends)}
    got = trank.RankingObjective._segment_sums(torch.from_numpy(v), prog)
    want = np.bincount(pos, weights=v, minlength=31)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(v).sum())
    assert got[30] == 0.0


# ------------------------------------------------------------ training
N_Q, F = 90, 6


def _ranking_data(seed=0, n_q=N_Q):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 50, n_q)
    n = int(lens.sum())
    X = rng.randn(n, F).astype(np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.7 * rng.randn(n)
    y = np.digitize(rel, [-0.5, 0.4, 1.2, 2.0]).astype(np.float32)
    position = np.concatenate([np.arange(k) for k in lens]) % 10
    return X, y, lens, position


class _JaxHostRun:
    """Patches the JAX package's ranking objectives onto their host
    loops and records each iteration's gradients; XENDCG's streams are
    fed the threefry draws of each iteration (without position bias)."""

    def __init__(self, monkeypatch):
        self.grads = []
        run = self
        for cls in (jrank.LambdarankNDCG, jrank.RankXENDCG):
            monkeypatch.setattr(cls, "make_device_grad_fn",
                                lambda self, n_pad: None)
        orig_init = jrank.RankXENDCG.init

        def init(obj, md, n):
            orig_init(obj, md, n)
            if obj.positions is None:
                obj._state = _feed_threefry(obj, obj.seed)
        monkeypatch.setattr(jrank.RankXENDCG, "init", init)
        orig_host = jrank.RankingObjective.get_gradients_host

        def host(obj, score):
            g, h = orig_host(obj, score)
            run.grads.append((g.astype(np.float64), h.astype(np.float64)))
            if getattr(obj, "_state", None) is not None:
                obj._state["it"] += 1
            return g, h
        monkeypatch.setattr(jrank.RankingObjective, "get_gradients_host",
                            host)


TRAIN_CASES = [("lambdarank", "wave", {}), ("lambdarank", "leafwise", {}),
               ("lambdarank", "wave", {"use_quantized_grad": True}),
               ("rank_xendcg", "wave", {}), ("rank_xendcg", "leafwise", {}),
               ("rank_xendcg", "wave", {"use_quantized_grad": True}),
               ("lambdarank", "wave", {"position": True}),
               ("rank_xendcg", "leafwise", {"position": True})]


@pytest.fixture(scope="module")
def pairs():
    cache = {}
    mp = pytest.MonkeyPatch()

    def get(objective, engine, **kw):
        key = (objective, engine, tuple(sorted(kw.items())))
        if key in cache:
            return cache[key]
        X, y, lens, position = _ranking_data()
        pos = position if kw.pop("position", False) else None
        params = {**BASE, "objective": objective,
                  "tpu_growth_strategy": engine, "metric": "ndcg",
                  "eval_at": [3, 10], **kw}
        if pos is not None:
            params["lambdarank_position_bias_regularization"] = 0.1
        Xv, yv, lv, _ = _ranking_data(seed=1, n_q=30)
        with mp.context() as m:
            jr = _JaxHostRun(m)
            hj, ht = {}, {}
            bj = jlgb.train(params, jlgb.Dataset(X, label=y, group=lens,
                                                 position=pos), ROUNDS,
                            valid_sets=[jlgb.Dataset(Xv, label=yv,
                                                     group=lv)],
                            callbacks=[jlgb.record_evaluation(hj)])
            bj._gbdt._sync_model()
        bt = tlgb.train({**params, **CPU},
                        tlgb.Dataset(X, label=y, group=lens, position=pos),
                        ROUNDS, valid_sets=[tlgb.Dataset(Xv, label=yv,
                                                         group=lv)],
                        callbacks=[tlgb.record_evaluation(ht)])
        cache[key] = types.SimpleNamespace(
            bj=bj, bt=bt, X=X, Xv=Xv, grads=jr.grads, hj=hj["valid_0"],
            ht=ht["valid_0"], yv=yv, lv=lv)
        return cache[key]
    yield get
    mp.undo()


@pytest.mark.parametrize(
    "objective,engine,extra", TRAIN_CASES,
    ids=[f"{o}-{e}" + "".join(f"-{k}" for k in x)
         for o, e, x in TRAIN_CASES])
def test_trains_like_jax_host_path(pairs, objective, engine, extra):
    p = pairs(objective, engine, **extra)
    g = p.bt._gbdt
    assert g.growth_strategy == engine
    ja, tb = p.bj._gbdt.models_, g.models_
    assert len(ja) == len(tb) == ROUNDS == len(p.grads)
    lam = lam_of_booster(g)
    X64 = p.X.astype(np.float64)
    quant = g.use_quant
    n_ties = 0
    for it in range(ROUNDS):
        gr, he = p.grads[it]
        if quant:
            # the tie gains of quantized growth are the grid values'
            # (the booster's discretization, keyed by the iteration),
            # which tie across features too
            key = R.fold_in(R.PRNGKey(g.config.seed + 5), it)
            gq, hq, _ = discretize_gradients(
                _padded(gr, g.n_pad), _padded(he, g.n_pad),
                g.config.num_grad_quant_bins, False, key)
            gr, he = (gq[:len(gr)].double().numpy(),
                      hq[:len(he)].double().numpy())
        ties, changed = same_trees(ja[it], tb[it], X64, gr, he, lam,
                                   atol=1e-6, rtol=1e-4,
                                   feature_ties=quant)
        n_ties += len(ties)
        if changed:
            break
    print(f"{objective}/{engine}{extra}: {n_ties} tie nodes")
    assert tb[0].num_leaves > 2
    if changed:
        # a tie moved rows: the runs' later trees are not comparable
        return
    # raw scores within the leaf values' tolerance summed over the
    # trees, and the recorded valid NDCG with them
    leaves = p.bj.predict(p.Xv, pred_leaf=True)
    bound = sum(1e-4 * np.abs(ja[t].leaf_value[leaves[:, t]]) + 1e-6
                for t in range(ROUNDS))
    assert (np.abs(p.bt.predict(p.Xv, raw_score=True)
                   - p.bj.predict(p.Xv, raw_score=True)) <= bound).all()
    assert list(p.ht) == list(p.hj) == ["ndcg@3", "ndcg@10"]
    for k in p.ht:
        np.testing.assert_allclose(p.ht[k], p.hj[k], rtol=0, atol=1e-3)
    if "position" in extra:
        obj = g.objective
        assert obj.positions is not None
        assert obj.pos_biases.shape == (10,)
        np.testing.assert_allclose(obj.pos_biases,
                                   p.bj._gbdt.objective.pos_biases,
                                   rtol=0, atol=1e-4)


def test_recorded_ndcg_is_the_host_metric_of_predict(pairs):
    """The valid NDCG the port records is the host metric of its own
    predictions, exactly."""
    p = pairs("lambdarank", "wave")
    m = NDCGMetric(TConfig({"eval_at": [3, 10]}))
    m.init(_metadata(TMetadata, p.yv, p.lv), len(p.yv))
    for i in range(ROUNDS):
        s = p.bt.predict(p.Xv, num_iteration=i + 1, raw_score=True)
        got = dict(m.eval(s))
        assert got["ndcg@3"] == p.ht["ndcg@3"][i]
        assert got["ndcg@10"] == p.ht["ndcg@10"][i]


@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_model_text_crosses_both_ways(pairs, objective):
    p = pairs(objective, "wave")
    text_t, text_j = p.bt.model_to_string(), p.bj.model_to_string()
    assert f"objective={objective}\n" in text_t
    want = p.bt.predict(p.Xv)
    np.testing.assert_allclose(jlgb.Booster(model_str=text_t).predict(p.Xv),
                               want, rtol=0, atol=1e-12)
    bt2 = tlgb.Booster(model_str=text_t, params=CPU)
    np.testing.assert_array_equal(bt2.predict(p.Xv), want)
    np.testing.assert_allclose(
        tlgb.Booster(model_str=text_j, params=CPU).predict(p.Xv),
        jlgb.Booster(model_str=text_j).predict(p.Xv), rtol=0, atol=1e-12)


def test_ranking_needs_query_information():
    X, y, _, _ = _ranking_data()
    with pytest.raises(tlgb.LightGBMError,
                       match="Ranking tasks require query information"):
        tlgb.train({"objective": "lambdarank", **CPU},
                   tlgb.Dataset(X, label=y), 1)


def test_continued_xendcg_restarts_its_stream():
    """A continued booster builds its objective anew: its uniform
    stream's `it` starts again at 0, as in the JAX package (ROADMAP
    "Divergences of the reference")."""
    X, y, lens, _ = _ranking_data()
    params = {**BASE, "objective": "rank_xendcg", **CPU}
    b1 = tlgb.train(params, tlgb.Dataset(X, label=y, group=lens), 2)
    assert b1._gbdt.objective._xe_iter == 2
    b2 = tlgb.train(params, tlgb.Dataset(X, label=y, group=lens), 1,
                    init_model=b1)
    assert b2._gbdt.objective._xe_iter == 1
    assert b2.num_trees() == 3


# ------------------------------------------------------- user surface
def test_ranker():
    """tests/test_sklearn.py::test_ranker on the port, its trees equal
    `train`'s, and eval_set / eval_group / eval_at."""
    rng = np.random.RandomState(3)
    n_queries, per_q = 60, 20
    n = n_queries * per_q
    X = rng.rand(n, 4)
    rel = (3 * X[:, 0] + rng.rand(n) > 2).astype(int) + (X[:, 1] > 0.8)
    group = np.full(n_queries, per_q)
    rk = tlgb.LGBMRanker(n_estimators=10, num_leaves=7,
                         min_child_samples=5, **CPU)
    rk.fit(X, rel, group=group, eval_set=[(X[:400], rel[:400])],
           eval_group=[group[:20]], eval_at=[1, 3])
    s = rk.predict(X)
    corr = np.corrcoef(s, rel)[0, 1]
    assert corr > 0.5, corr
    assert list(rk.evals_result_["valid_0"]) == ["ndcg@1", "ndcg@3"]
    assert len(rk.evals_result_["valid_0"]["ndcg@3"]) == 10
    b = tlgb.train({"objective": "lambdarank", "num_leaves": 7,
                    "min_data_in_leaf": 5, "verbosity": -1, **CPU},
                   tlgb.Dataset(X, label=rel, group=group), 10)
    np.testing.assert_array_equal(s, b.predict(X))


def test_cv_ranking_query_aware_folds():
    """tests/test_engine.py::test_cv_ranking_query_aware_folds on the
    port: whole queries land in the folds."""
    rng = np.random.RandomState(0)
    sizes = rng.randint(5, 30, size=40)
    n = int(sizes.sum())
    X = rng.rand(n, 5)
    y = rng.randint(0, 4, n).astype(np.float64)
    ds = tlgb.Dataset(X, label=y, group=sizes)
    res = tlgb.cv({"objective": "lambdarank", "metric": "ndcg",
                   "ndcg_eval_at": [3], "num_leaves": 7, "verbosity": -1,
                   "min_data_in_leaf": 2, **CPU}, ds, num_boost_round=3,
                  nfold=4, return_cvbooster=True, seed=7)
    assert "valid ndcg@3-mean" in res
    assert len(res["valid ndcg@3-mean"]) == 3
    total_queries = 0
    for b in res["cvbooster"].boosters:
        qb = b._gbdt.train_data.metadata.query_boundaries
        assert qb is not None
        total_queries += len(qb) - 1
    assert total_queries == 40 * 3
