"""PyTorch port: the pieces of the row-sharding learners (tree_learner=data,
voting) that read more than sums of rows, on the CPU, with the ranks as
threads of this process (no process group).

* Ranking gradients: each rank's `get_gradients(..., shard=)` equals its
  slice of the serial gradients bit for bit, with queries that straddle
  the ranks' bounds and one longer than a shard, over iterations whose
  position-bias state (and the exponent of its fixed-point grid) must
  stay the serial one bit for bit.
* The NDCG and MAP device plans: their per-query values, summed over the
  queries each rank owns (its first row), give the host classes' means
  and the JAX package's `ndcg_device_plan` / `map_device_plan` within
  rtol 1e-5.
* Linear trees: the fit's exact per-leaf sums over sharded rows give
  the serial fit, which no row chunking or thread count changes.
* DevicePredictor's row split over several devices gives the one-device
  bytes.
"""

import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lightgbm_tpu_torch import ranking as trank
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.io.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.parallel.data_parallel import RowShard
from torch_cluster import query_sizes

PAD = 1024


class ThreadNet:
    """One rank of `world` threads: the Network collectives the row
    shard uses, through shared slots and a barrier."""

    def __init__(self, shared, rank):
        self.shared, self.rank = shared, rank
        self.world = shared["world"]

    def _swap(self, t):
        s = self.shared
        s["slots"][self.rank] = t.clone()
        s["barrier"].wait()
        parts = list(s["slots"])
        s["barrier"].wait()
        return parts

    def all_reduce_sum_(self, t):
        return t.copy_(torch.stack(self._swap(t)).sum(0))

    def all_reduce_max_(self, t):
        return t.copy_(torch.stack(self._swap(t)).amax(0))

    def all_gather_rows(self, t, sizes):
        parts = self._swap(t)
        return torch.cat([p[..., :n] for p, n in zip(parts, sizes)], -1)


def run_ranks(world, fn):
    """fn(rank, ThreadNet) on `world` threads; returns [per rank result]."""
    shared = {"world": world, "slots": [None] * world,
              "barrier": threading.Barrier(world)}
    out, errors = [None] * world, []

    def body(r):
        try:
            out[r] = fn(r, ThreadNet(shared, r))
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
            shared["barrier"].abort()
    threads = [threading.Thread(target=body, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def rank_problem(n=3000, seed=7):
    """Labels 0-4, query sizes of 4-40 around one query of 1,100 rows
    (more than a shard at world 3), positions 0-11 within a query."""
    rng = np.random.RandomState(seed)
    head = query_sizes(900, seed)
    sizes = np.array(head + [1100] + query_sizes(n - 2000, seed + 1))
    labels = rng.randint(0, 5, n).astype(np.float64)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    position = (np.arange(n) - starts) % 12
    return labels, sizes, position


def objective(name, labels, sizes, position):
    md = TMetadata(len(labels))
    md.set_label(labels)
    md.set_group(np.asarray(sizes, np.int64))
    if position is not None:
        md.set_position(position)
    cls = {"lambdarank": trank.LambdarankNDCG,
           "rank_xendcg": trank.RankXENDCG}[name]
    ot = cls(TConfig({"objective": name}))
    ot.init(md, len(labels))
    return ot


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("position", [False, True],
                         ids=["plain", "position"])
@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_sharded_ranking_gradients_equal_serial(monkeypatch, name, position,
                                                world):
    # small chunks: a rank keeps only the chunks that meet its queries
    monkeypatch.setattr(trank, "PAIR_BUDGET", 1 << 10)
    labels, sizes, pos = rank_problem()
    pos = pos if position else None
    n = len(labels)
    n_pad = -(-n // PAD) * PAD
    rng = np.random.RandomState(11)
    scores = [torch.from_numpy(np.pad(rng.randn(n).astype(np.float32),
                                      (0, n_pad - n))) for _ in range(3)]
    weight = torch.zeros(n_pad)
    weight[:n] = torch.from_numpy(rng.rand(n).astype(np.float32) + 0.5)
    serial = objective(name, labels, sizes, pos)
    want = [serial.get_gradients(s, weight=weight) for s in scores]
    want_bias = serial._biases_dev

    def rank(r, net):
        sh = RowShard(net, n, PAD)
        ot = objective(name, labels, sizes, pos)
        got = []
        for s in scores:
            local = torch.from_numpy(sh.local(s[:n].numpy()))
            w = torch.from_numpy(sh.local(weight[:n].numpy()))
            g, h = ot.get_gradients(local, weight=w, shard=sh)
            got.append((g[:sh.count], h[:sh.count], g[sh.count:],
                        h[sh.count:]))
        chunks = len(ot._prog["chunks"])
        return sh.start, sh.stop, got, ot._biases_dev, chunks

    res = run_ranks(world, rank)
    every = len(serial._prog["chunks"])
    assert all(r[4] <= every for r in res)
    assert sum(r[4] for r in res) < every * world
    for start, stop, got, bias, _ in res:
        for (g, h, gpad, hpad), (wg, wh) in zip(got, want):
            assert torch.equal(g, wg[start:stop])
            assert torch.equal(h, wh[start:stop])
            assert not gpad.any() and not hpad.any()
        if position:
            assert torch.equal(bias, want_bias)
    if position:
        assert want_bias.abs().max() > 1e-3


def test_segment_sum_grid_does_not_depend_on_the_split():
    """The position-bias grid's exponent comes from an exact sum of |v|:
    the serial sums and each rank's all-reduced partial sums are the
    same bits, on values of mixed sign and scale."""
    rng = np.random.RandomState(8)
    n = 5000
    pos = rng.randint(0, 30, n)
    v = torch.from_numpy(np.stack([rng.randn(n) * 10.0 ** rng.randint(
        -3, 3, n), rng.rand(n)]))

    def prog_of(p):
        order = np.argsort(p, kind="stable")
        cnt = np.bincount(p, minlength=31)
        ends = np.cumsum(cnt)
        return {"pos_order": torch.from_numpy(order),
                "pos_start": torch.from_numpy(ends - cnt),
                "pos_end": torch.from_numpy(ends)}
    want = trank.RankingObjective._segment_sums(v, prog_of(pos))

    def rank(r, net):
        sh = RowShard(net, n, PAD)
        return trank.RankingObjective._segment_sums(
            v[:, sh.start:sh.stop], prog_of(pos[sh.start:sh.stop]), net)
    for got in run_ranks(3, rank):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["ndcg", "map"])
def test_rank_plans_equal_host_and_jax(kind):
    import jax.numpy as jnp
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu import metric as jmetric
    from lightgbm_tpu_torch import metric as tmetric
    labels, sizes, _ = rank_problem()
    n = len(labels)
    md = TMetadata(n)
    md.set_label(labels)
    md.set_group(np.asarray(sizes, np.int64))
    params = {"objective": "lambdarank", "eval_at": [1, 3, 5, 10]}
    cls = {"ndcg": "NDCGMetric", "map": "MapMetric"}[kind]
    mt = getattr(tmetric, cls)(TConfig(params))
    mt.init(md, n)
    mj = getattr(jmetric, cls)(JConfig(params))
    mj.init(md, n)
    score = np.random.RandomState(3).randn(n).astype(np.float32)
    # one tie group per query, which the stable sort must keep in order
    score[:40] = 0.25
    n_pad = n + 1
    sc = torch.from_numpy(np.append(score, np.float32(0)))
    build = getattr(tmetric, f"{kind}_device_plan")
    qb = np.asarray(md.query_boundaries)
    # three "ranks" own the queries whose first row they hold
    sums = np.zeros(4)
    for a, b in ((0, 1000), (1000, 2000), (2000, n)):
        own = np.nonzero((qb[:-1] >= a) & (qb[:-1] < b))[0]
        nq, fn = build(mt, n_pad, "cpu", queries=own)
        per_q = fn(sc).numpy()
        assert per_q.shape == (nq, 4) == (len(own), 4)
        sums += per_q.sum(0)
    got = sums / (len(qb) - 1)
    host = [v for _, v in mt.eval(score.astype(np.float64))]
    np.testing.assert_allclose(got, host, rtol=1e-12)
    bks, jfn = getattr(jmetric, f"{kind}_device_plan")(mj, n_pad)
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(sc.numpy()),
                                                   bks)), rtol=1e-5)


def fit_inputs(n=3000):
    """A one-tree leaf-wise regression model of the port, its leaf ids
    on rows with 3% NaN, and random float32 gradients and hessians (a
    tenth of the hessians 0: rows the fit leaves out)."""
    import lightgbm_tpu_torch as tlgb
    from lightgbm_tpu_torch.learner.linear import raw_to_device
    rng = np.random.RandomState(0)
    X = rng.rand(n, 5)
    X[rng.rand(n, 5) < 0.03] = np.nan
    Z = np.nan_to_num(X, nan=0.5)
    y = np.where(Z[:, 0] > 0.5, 2.0 * Z[:, 1], -Z[:, 2]) + Z[:, 3] * Z[:, 4]
    b = tlgb.train({"objective": "regression", "num_leaves": 15,
                    "verbosity": -1, "device_type": "cpu",
                    "tpu_growth_strategy": "leafwise"},
                   tlgb.Dataset(X, label=y), 1)
    ds = b._gbdt.train_data
    lid = b.predict(X, pred_leaf=True).reshape(n)
    grad = rng.randn(n).astype(np.float32)
    hess = ((0.2 + rng.rand(n)) * (rng.rand(n) > 0.1)).astype(np.float32)
    return (b._gbdt.models_[0], raw_to_device(X, torch.device("cpu")),
            torch.from_numpy(lid.astype(np.int64)), torch.from_numpy(grad),
            torch.from_numpy(hess),
            lambda f: ds.bin_mappers[f].bin_type == 0,
            ds.inner_feature_index)


@pytest.mark.parametrize("world", [2, 3])
def test_linear_fit_over_sharded_rows_equals_serial(world):
    import copy
    from lightgbm_tpu_torch.learner.linear import fit_linear
    tree, raw_dev, ids, grad, hess, is_num, inner = fit_inputs()
    n = ids.shape[0]
    want = copy.deepcopy(tree)
    fit_linear(want, raw_dev, ids, grad, hess, 0.1, is_num, inner)
    assert want.num_leaves > 2 and any(want.leaf_coeff[:want.num_leaves])

    def rank(r, net):
        sh = RowShard(net, n, PAD)
        t = copy.deepcopy(tree)
        fit_linear(t, raw_dev[sh.start:sh.stop], ids[sh.start:sh.stop],
                   grad[sh.start:sh.stop], hess[sh.start:sh.stop], 0.1,
                   is_num, inner, shard=sh)
        return t
    for t in run_ranks(world, rank):
        L = want.num_leaves
        assert list(t.leaf_const[:L]) == list(want.leaf_const[:L])
        assert t.leaf_coeff[:L] == want.leaf_coeff[:L]
        assert t.leaf_features[:L] == want.leaf_features[:L]


def test_linear_fit_bits_do_not_depend_on_chunks_or_threads(monkeypatch):
    import copy
    from lightgbm_tpu_torch.learner import linear
    tree, raw_dev, ids, grad, hess, is_num, inner = fit_inputs()
    fits = []
    for chunk, threads in ((1 << 23, 1), (1000, 1), (1 << 23, 4)):
        monkeypatch.setattr(linear, "PRODUCT_CHUNK", chunk)
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            t = copy.deepcopy(tree)
            linear.fit_linear(t, raw_dev, ids, grad, hess, 0.1, is_num,
                              inner)
        finally:
            torch.set_num_threads(before)
        L = t.num_leaves
        fits.append((list(t.leaf_const[:L]), t.leaf_coeff[:L]))
    assert fits[1] == fits[0] and fits[2] == fits[0]


def _predictor_model():
    import lightgbm_tpu_torch as tlgb
    rng = np.random.RandomState(2)
    X = rng.rand(3000, 5).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0.8).astype(np.float64)
    b = tlgb.train({"objective": "binary", "num_leaves": 15,
                    "verbosity": -1, "device_type": "cpu"},
                   tlgb.Dataset(X, label=y), 5)
    Xq = rng.rand(2500, 5).astype(np.float32)
    Xq[::7, 3] = np.nan
    return b._gbdt, Xq


@pytest.mark.parametrize("devices", [2, 3])
def test_device_predictor_row_split_is_byte_equal(devices):
    from lightgbm_tpu_torch.inference import DevicePredictor
    g, Xq = _predictor_model()
    obj = g.objective

    def dp(**kw):
        return DevicePredictor(g.models_, convert=obj.convert_output,
                               min_bucket=100, device="cpu", **kw)
    one, split = dp(), dp(devices=["cpu"] * devices)
    assert split.bucket_rows(1) % devices == 0
    before = DevicePredictor.dispatch_counts().get("cpu", 0)
    for rows in (Xq, Xq[:1], Xq[:101]):
        assert one.predict(rows).tobytes() == split.predict(rows).tobytes()
        assert (one.predict_raw(rows).tobytes()
                == split.predict_raw(rows).tobytes())
        assert (one.predict_leaf(rows).tobytes()
                == split.predict_leaf(rows).tobytes())
        assert (one.predict_raw(rows, early_stop=(2, 1.5)).tobytes()
                == split.predict_raw(rows, early_stop=(2, 1.5)).tobytes())
    # one dispatch a device a call
    assert (DevicePredictor.dispatch_counts()["cpu"] - before
            == 12 * (1 + devices))
