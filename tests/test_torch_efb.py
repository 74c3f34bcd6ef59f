"""PyTorch port: exclusive feature bundling (EFB) from dense and scipy
sparse data, against the JAX package, on the CPU.

Data: `_onehot`, 4096 rows of three one-hot categoricals (12, 20 and 6
levels: mutually exclusive within one, so three bundles) and four
dense columns, binary label from per-level effects and two dense
columns, random row weights so that few candidate splits tie; and
`_random_sparse`, 4000 x 60 scipy random data at 2% density (members
that conflict, bundled at max_conflict_rate 0 and 0.05).

* The bundle plans (groups, offsets, default bins, bundle widths) and
  the bundle codes equal the JAX package's exactly, from the dense
  matrix (the booster's plan, `GBDT.init`) and from CSR, CSC and COO
  (`io/sparse.py`); the sparse plan equals the dense plan of the same
  matrix, and each feature's bins decoded from its bundle column
  (`Dataset.feature_bins`) equal the JAX package's.
* `bundle_hist_to_features` against the JAX function on one leaf's
  group-space histogram: member bins are gathered copies, so they are
  equal; the default bin of a bundle member is exact in the port (the
  bundle column's integer total less the member's other bins) and a
  float32 difference of the leaf sums in the JAX package, so the two
  agree within (B + 2) * 2^-24 * (|leaf sum| + sum of |bins|) per
  channel, float32's rounding over the B-term sum and the subtraction.
  The port's result equals the unbundled histogram exactly.
* Training: both packages train 3 iterations on the wave engine (dense
  one-hot), the leaf-wise engine (CSR) and quantized (CSC), and the
  trees are compared under the tie rule of
  tests/test_torch_categorical.py (`compare_training`).  The model text
  equals the JAX package's line for line, numbers within float32 noise.
* Bundled trees equal unbundled trees (`enable_bundle=false`) exactly on
  conflict-free data, on both engines, quantized, with DART (whose
  drops re-add trees through the bundle-decoding bin-space traversal),
  with a valid set, with `init_model` (the bin-space traversal of the
  bundled training rows), and with forced splits on bundle members (both
  engines) and interaction constraints.
* Sparse input: a CSR whose `toarray` raises trains; `predict(csr)`
  equals `predict(dense)` bit for bit, in one chunk or many; a CSR valid
  set with early stopping stops where the JAX package's does; `subset`
  and `cv` keep the plan; `Dataset(csr)` no longer raises ValueError.
* The kernels' plans take the group-space widths (F' columns, 256 bins).
"""

import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
from lightgbm_tpu.io.bundle import build_bundled as j_build_bundled
from lightgbm_tpu.io.bundle import plan_bundles as j_plan_bundles
from lightgbm_tpu.learner.grow import FeatureMeta as JMeta
from lightgbm_tpu.learner.grow import \
    bundle_hist_to_features as j_bundle_hist
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import basic as tbasic
from lightgbm_tpu_torch.boosting.gbdt import wave_fits
from lightgbm_tpu_torch.io.bundle import build_bundled, plan_bundles
from lightgbm_tpu_torch.learner.grow import (FeatureMeta,
                                             bundle_hist_to_features)
from lightgbm_tpu_torch.metric import create_metrics
from lightgbm_tpu_torch.ops import histogram as H

from test_torch_categorical import compare_training

N = 4096
LEVELS = (12, 20, 6)
DENSE = 4
BASE = {"objective": "binary", "num_leaves": 8, "max_bin": 63,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_donate_buffers": False}
CPU = {"device_type": "cpu"}


def _onehot(n=N, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, sum(LEVELS) + DENSE), np.float32)
    logit = np.zeros(n)
    off = 0
    for i, k in enumerate(LEVELS):
        code = rng.randint(0, k, n)
        X[np.arange(n), off + code] = 1.0
        logit += np.random.RandomState(10 + i).randn(k)[code]
        off += k
    X[:, off:] = rng.randn(n, DENSE)
    logit += X[:, off] - 0.5 * X[:, off + 1]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    wt = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, wt


def _random_sparse(n=4000, F=60, seed=0):
    rng = np.random.RandomState(seed)
    m = sps.random(n, F, density=0.02, random_state=rng,
                   data_rvs=lambda k: rng.randn(k) + 1.0,
                   dtype=np.float32).tocsr()
    y = (rng.rand(n) < 0.5).astype(np.float32)
    return m, y


def _plan_fields(plan):
    return ([list(map(int, g)) for g in plan.groups],
            np.asarray(plan.group_idx), np.asarray(plan.offsets),
            np.asarray(plan.zero_bin), np.asarray(plan.in_bundle),
            np.asarray(plan.group_num_bin))


def _same_plan(a, b):
    fa, fb = _plan_fields(a), _plan_fields(b)
    assert fa[0] == fb[0]
    for x, y in zip(fa[1:], fb[1:]):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------- the fault repaired
def test_dataset_from_csr_trains():
    """`Dataset(csr)` once raised `ValueError: setting an array element
    with a sequence` (np.asarray of the sparse object)."""
    X, y, _ = _onehot(1024)
    b = tlgb.train({**BASE, **CPU}, tlgb.Dataset(sps.csr_matrix(X), label=y),
                   2)
    assert b.num_trees() == 2
    assert b._gbdt.bundle_plan is not None


# ------------------------------------------------------------ plans, codes
@pytest.mark.parametrize("form", ["dense", "csr", "csc", "coo",
                                  "random_csr", "random_csc_conflicts"])
def test_plans_and_codes_equal_jax(form):
    params = {**BASE}
    if form.startswith("random"):
        m, y = _random_sparse()
        if form.endswith("conflicts"):
            params["max_conflict_rate"] = 0.05
        data = m.tocsc() if "csc" in form else m
    else:
        X, y, _ = _onehot()
        data = {"dense": X, "csr": sps.csr_matrix(X),
                "csc": sps.csc_matrix(X), "coo": sps.coo_matrix(X)}[form]
    dj = jlgb.Dataset(data, label=y, params=params)
    cj = dj._core_or_construct()
    dt = tlgb.Dataset(data, label=y, params={**params, **CPU})
    ct = dt._core_or_construct()
    if form == "dense":
        jplan = j_plan_bundles(np.asarray(cj.binned_host()), cj.bin_mappers,
                               cj.used_features)
        jcodes = j_build_bundled(np.asarray(cj.binned_host()), jplan)
        b = tlgb.Booster({**params, **CPU}, dt)
        tplan = b._gbdt.bundle_plan
        tcodes = b._gbdt.binned_dev[:, :N].numpy()
        # the dataset keeps its per-feature bins
        np.testing.assert_array_equal(ct.binned_host(),
                                      np.asarray(cj.binned_host()))
    else:
        jplan, jcodes = cj.pre_bundled_plan, np.asarray(cj.binned)
        tplan, tcodes = ct.pre_bundled_plan, ct.binned
        # the sparse plan and codes are the dense path's on the same data
        dense = tlgb.Dataset(data.toarray(), label=y,
                             params={**params, **CPU})._core_or_construct()
        dplan = plan_bundles(dense.binned_host(), dense.bin_mappers,
                             dense.used_features,
                             max_conflict_rate=params.get(
                                 "max_conflict_rate", 0.0))
        _same_plan(tplan, dplan)
        np.testing.assert_array_equal(
            tcodes, build_bundled(dense.binned_host(), dplan))
        # each member decoded from its bundle column: the JAX package's
        # bins, and the dense bins wherever no member conflicts
        for i in range(ct.num_features):
            fb = ct.feature_bins(i)
            np.testing.assert_array_equal(fb, np.asarray(cj.feature_bins(i)))
            if "conflicts" not in form:
                np.testing.assert_array_equal(fb, dense.binned_host()[i])
    assert tplan.effective
    _same_plan(tplan, jplan)
    assert tcodes.dtype == np.uint8
    np.testing.assert_array_equal(tcodes, jcodes)


# ----------------------------------------------------------- FixHistogram
def test_bundle_hist_to_features_matches_jax():
    X, y, wt = _onehot()
    core = tlgb.Dataset(X, label=y, params=CPU)._core_or_construct()
    bins = core.binned_host()
    plan = plan_bundles(bins, core.bin_mappers, core.used_features)
    codes = build_bundled(bins, plan)
    nb = np.array([core.bin_mappers[f].num_bin for f in core.used_features],
                  np.int32)
    B, hist_B = int(nb.max()), int(plan.group_num_bin.max())
    rng = np.random.RandomState(5)
    S = 2048
    gh = torch.from_numpy(np.stack([rng.randn(S), rng.rand(S)], 1).astype(
        np.float32))
    mask = torch.from_numpy((rng.rand(S) < 0.6).astype(np.float32))
    exps = H.scale_exps(gh)
    unit = H.fixed_unit(exps)
    g_hist = H.build_histogram_rows_plain(
        torch.from_numpy(codes[:, :S].T.copy()), gh, mask, max_bin=hist_B,
        exps=exps, fixed=True)                               # [F', B', 2]
    meta_t = FeatureMeta(
        num_bin=torch.from_numpy(nb), missing_type=None, default_bin=None,
        penalty=None, group=torch.from_numpy(plan.group_idx),
        offset=torch.from_numpy(plan.offsets),
        zero_bin=torch.from_numpy(plan.zero_bin),
        in_bundle=torch.from_numpy(plan.in_bundle))
    got = H.from_fixed(bundle_hist_to_features(g_hist, None, None, meta_t, B,
                                               hist_B, True), unit)
    # exact: the unbundled histogram of the same rows on the same grid
    want = H.build_histogram_rows_plain(
        torch.from_numpy(bins[:, :S].T.copy()), gh, mask, max_bin=B,
        exps=exps, fixed=True)
    assert torch.equal(bundle_hist_to_features(g_hist, None, None, meta_t,
                                               B, hist_B, True), want)
    # the JAX function on the float32 group histogram and leaf sums
    g_f32 = H.from_fixed(g_hist, unit)
    sums = H.from_fixed(g_hist[0].sum(0)[None], unit)[0]
    meta_j = JMeta(num_bin=jnp.asarray(nb), missing_type=None,
                   default_bin=None, penalty=None,
                   group=jnp.asarray(plan.group_idx),
                   offset=jnp.asarray(plan.offsets),
                   zero_bin=jnp.asarray(plan.zero_bin),
                   in_bundle=jnp.asarray(plan.in_bundle))
    ref = np.asarray(j_bundle_hist(jnp.asarray(g_f32.numpy()),
                                   jnp.asarray(sums[0].item()),
                                   jnp.asarray(sums[1].item()), meta_j, B,
                                   hist_B, True))
    got = got.numpy()
    zb_cell = np.zeros(got.shape[:2], bool)
    zb_cell[np.arange(len(nb)), plan.zero_bin] = True
    member = zb_cell & plan.in_bundle[:, None]
    np.testing.assert_array_equal(got[~member], ref[~member])
    scale = (np.abs(sums.numpy())[None, :]
             + np.abs(got).sum(1))                          # [F, 2]
    tol = (B + 2) * 2.0 ** -24 * scale
    err = np.abs(got - ref)                                 # [F, B, 2]
    assert (err.max(1) <= tol).all(), (err.max(1) / tol).max()


# ---------------------------------------------------- training against JAX
TRAIN_CASES = {
    "wave_dense": ({"tpu_growth_strategy": "wave"}, "dense"),
    "leafwise_csr": ({"tpu_growth_strategy": "leafwise"}, "csr"),
    "quantized_csc": ({"tpu_growth_strategy": "wave",
                       "use_quantized_grad": True}, "csc"),
}
_PAIRS = {}


def _as(form, X):
    return {"dense": X, "csr": sps.csr_matrix(X),
            "csc": sps.csc_matrix(X)}[form]


def _pair(case):
    if case not in _PAIRS:
        extra, form = TRAIN_CASES[case]
        X, y, wt = _onehot()
        params = {**BASE, **extra}
        bj = jlgb.train(params, jlgb.Dataset(_as(form, X), label=y,
                                             weight=wt), 3)
        bt = tlgb.train({**params, **CPU},
                        tlgb.Dataset(_as(form, X), label=y, weight=wt), 3)
        bj._gbdt._sync_model()
        _PAIRS[case] = (bj, bt, X, y, wt)
    return _PAIRS[case]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case):
    bj, bt, X, y, wt = _pair(case)
    assert bj._gbdt.bundle_plan is not None
    _same_plan(bt._gbdt.bundle_plan, bj._gbdt.bundle_plan)
    assert bt._gbdt.grow_params.has_bundles
    n_ties, whole = compare_training(bj, bt, X, y, wt)
    print(f"{case}: {n_ties} exact ties")
    if whole:
        np.testing.assert_allclose(bt.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-5)


_FLOAT_KEYS = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
               "internal_weight")


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_model_text_equals_jax(case):
    """Line for line: the numbers of float32 sums within 1e-4 relative
    (the last printed digit), everything else exactly; the port's text
    adds its device_type parameter and its tree sizes follow its digits."""
    bj, bt, X, _, _ = _pair(case)
    tj = bj.model_to_string().splitlines()
    tt = [ln for ln in bt.model_to_string().splitlines()
          if not ln.startswith("[device_type:")]
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        key = a.split("=", 1)[0]
        if key in _FLOAT_KEYS:
            assert b.split("=", 1)[0] == key
            va = np.array(a.split("=", 1)[1].split(), np.float64)
            vb = np.array(b.split("=", 1)[1].split(), np.float64)
            np.testing.assert_allclose(vb, va, rtol=1e-4, atol=1e-6)
        elif key != "tree_sizes":
            assert a == b, (a, b)
    # and the port's text predicts in the JAX package as the port does
    jb = jlgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(jb.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)


def test_sparse_valid_early_stopping_matches_jax():
    X, y, wt = _onehot()
    Xv, yv, _ = _onehot(2048, seed=1)
    params = {**BASE, "tpu_growth_strategy": "leafwise", "metric": "auc",
              "learning_rate": 0.3, "early_stopping_round": 2,
              "early_stopping_min_delta": 0.002}
    out = {}
    for name, lgb, p in (("jax", jlgb, params), ("port", tlgb,
                                                 {**params, **CPU})):
        ds = lgb.Dataset(sps.csr_matrix(X), label=y, weight=wt)
        hist = {}
        b = lgb.train(p, ds, 40,
                      valid_sets=[ds.create_valid(sps.csr_matrix(Xv),
                                                  label=yv)],
                      callbacks=[lgb.record_evaluation(hist)])
        out[name] = (b, hist)
    (bj, hj), (bt, ht) = out["jax"], out["port"]
    vt = bt._gbdt.valid_sets[0]
    assert vt.pre_bundled_plan is bt._gbdt.train_data.pre_bundled_plan
    assert bt.best_iteration == bj.best_iteration < 40
    aj, at = hj["valid_0"]["auc"], ht["valid_0"]["auc"]
    assert len(aj) == len(at)
    np.testing.assert_allclose(at, aj, rtol=0, atol=2e-4)
    # the bundle-decoding traversal of the valid codes scores as predict
    for i, a in enumerate(at):
        s = bt.predict(Xv, num_iteration=i + 1, raw_score=True)
        m = create_metrics(bt._gbdt.config)[0]
        m.init(vt.metadata, vt.num_data)
        assert abs(m.eval(s, None)[0][1] - a) <= 1e-9


# ------------------------------------------------ bundled equals unbundled
def _trees(b):
    out = []
    for t in b._gbdt.models_:
        ni = t.num_leaves - 1
        out.append((t.num_leaves, t.split_feature[:ni].tolist(),
                    t.threshold[:ni].tolist(), t.left_child[:ni].tolist(),
                    t.right_child[:ni].tolist(),
                    t.leaf_value[:ni + 1].tolist()))
    return out


UNBUNDLED_CASES = {
    "wave": {"tpu_growth_strategy": "wave"},
    "leafwise": {"tpu_growth_strategy": "leafwise"},
    "quantized": {"tpu_growth_strategy": "wave", "use_quantized_grad": True},
    "dart": {"tpu_growth_strategy": "wave", "boosting": "dart",
             "drop_rate": 0.5, "skip_drop": 0.0},
    "valid_set": {"tpu_growth_strategy": "leafwise"},
    "init_model": {"tpu_growth_strategy": "wave"},
    "forced_wave": {"tpu_growth_strategy": "wave"},
    "forced_leafwise": {"tpu_growth_strategy": "leafwise"},
    "interaction_wave": {"tpu_growth_strategy": "wave",
                         "interaction_constraints": [
                             list(range(0, 12)) + [38, 39],
                             list(range(12, 38)) + [40, 41]]},
}


@pytest.mark.parametrize("case", list(UNBUNDLED_CASES))
def test_bundled_equals_unbundled(case, tmp_path):
    X, y, wt = _onehot()
    Xv, yv, _ = _onehot(1024, seed=3)
    params = {**BASE, **CPU, "num_leaves": 15, **UNBUNDLED_CASES[case]}
    if case.startswith("forced"):
        # a bundle member at the root, a dense column and another
        # categorical's member under it
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({
            "feature": 3, "threshold": 0.0,
            "left": {"feature": 38, "threshold": 0.0},
            "right": {"feature": 20, "threshold": 0.0}}))
        params["forcedsplits_filename"] = str(path)
    got = []
    for bundle in (True, False):
        p = {**params, "enable_bundle": bundle}
        ds = tlgb.Dataset(X, label=y, weight=wt)
        kw = {}
        if case == "valid_set":
            kw = dict(valid_sets=[ds.create_valid(Xv, label=yv)])
        if case == "init_model":
            kw = dict(init_model=tlgb.train(
                p, tlgb.Dataset(X, label=y, weight=wt), 2))
        b = tlgb.train(p, ds, 4, **kw)
        assert (b._gbdt.bundle_plan is not None) == bundle
        got.append(b)
    on, off = got
    assert _trees(on) == _trees(off)
    if case.startswith("forced"):
        for t in on._gbdt.models_:
            assert t.split_feature[:3].tolist() == [3, 38, 20]
    assert torch.equal(on._gbdt.scores, off._gbdt.scores)
    np.testing.assert_array_equal(on.predict(X), off.predict(X))
    if case == "valid_set":
        np.testing.assert_array_equal(on._gbdt.valid_scores[0],
                                      off._gbdt.valid_scores[0])
        np.testing.assert_allclose(on._gbdt.valid_scores[0][0],
                                   on.predict(Xv, raw_score=True), rtol=0,
                                   atol=1e-12)


# -------------------------------------------------------------- sparse input
def test_csr_is_never_densified():
    X, y, wt = _onehot()

    class Guarded(sps.csr_matrix):
        def toarray(self, *a, **k):
            raise AssertionError("the sparse input was densified")
        todense = toarray

    ds = tlgb.Dataset(Guarded(sps.csr_matrix(X)), label=y, weight=wt)
    b = tlgb.train({**BASE, **CPU}, ds, 3)
    core = ds._core
    assert core.pre_bundled_plan is not None
    assert core.binned.shape == (len(LEVELS) + DENSE, N)
    assert b.current_iteration() == 3


@pytest.mark.parametrize("chunk_bytes", [None, 8 * 42 * 1000])
def test_predict_csr_equals_dense(monkeypatch, chunk_bytes):
    """One chunk, and chunks of 1,000 rows (the last one short)."""
    if chunk_bytes is not None:
        monkeypatch.setattr(tbasic, "SPARSE_CHUNK_BYTES", chunk_bytes)
    bj, bt, X, _, _ = _pair("leafwise_csr")
    Xs = _onehot(2500, seed=4)[0]
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True},
               {"num_iteration": 2}):
        np.testing.assert_array_equal(bt.predict(sps.csr_matrix(Xs), **kw),
                                      bt.predict(Xs, **kw))
    np.testing.assert_array_equal(bt.predict(sps.coo_matrix(Xs)),
                                  bt.predict(Xs))


def test_single_row_fast():
    _, bt, X, _, _ = _pair("leafwise_csr")
    for r in range(3):
        want = bt.predict(X[r:r + 1])
        np.testing.assert_allclose(bt.predict(X[r], single_row_fast=True),
                                   want, rtol=0, atol=1e-15)


def test_subset_and_cv_keep_the_plan():
    X, y, wt = _onehot()
    ds = tlgb.Dataset(sps.csr_matrix(X), label=y, weight=wt,
                      params={**BASE, **CPU})
    plan = ds.construct()._core.pre_bundled_plan
    idx = np.arange(0, N, 2)
    sub = ds.subset(idx)
    assert sub._core.pre_bundled_plan is plan
    np.testing.assert_array_equal(sub._core.binned,
                                  ds._core.binned[:, idx])
    a = tlgb.train({**BASE, **CPU}, sub, 2)
    assert a._gbdt.bundle_plan is plan
    res = tlgb.cv({**BASE, **CPU, "metric": "auc"}, ds, num_boost_round=2,
                  nfold=2, return_cvbooster=True)
    assert len(res["valid auc-mean"]) == 2
    for b in res["cvbooster"].boosters:
        assert b._gbdt.bundle_plan is plan
        assert b._gbdt.valid_sets[0].pre_bundled_plan is plan


# ------------------------------------------------------------ kernel plans
def test_kernel_plans_take_group_space_widths():
    """The EFB run's group space on the card: about 33 bundle columns of
    up to 256 bins (MAX_BUNDLE_BINS).  Every planner takes it, every
    tile fits its budget, and K3 takes the waves of 1, 2, 4 and 8
    computed slots, as at 255 bins."""
    from lightgbm_tpu_torch.io.bundle import MAX_BUNDLE_BINS
    B = MAX_BUNDLE_BINS
    for Fg in (7, 33, 36):
        FG = H.tile_feature_group(Fg, B, 2)
        assert 1 <= FG <= H.TILE_FEATURES
        assert 8 * (FG * B * 2 + 1) <= H.TILE_BYTES
        for slots in (8, 128, 384):
            plan = H.wave_part_plan(1 << 20, Fg, B, 2, slots)
            assert plan.tile_bytes <= H.TILE_BYTES
            qplan = H.wave_part_plan(1 << 20, Fg, B, 2, slots, cell_bytes=4)
            assert qplan.tile_bytes <= H.TILE_BYTES
        for slots in (1, 2, 4, 8):
            assert H.wave_hl_profitable(B, slots) == H.wave_hl_profitable(
                255, slots) is True
            assert H.wave_hl_fits(B, slots)
            for cb in (8, 4):
                few = H.wave_few_plan(Fg, B, 2, slots, cb)
                assert few.tile_bytes <= H.FEW_TILE_BYTES
        assert not H.wave_hl_profitable(B, 16)
        FG4, R = H.rows_plan(1 << 20, Fg, B, 2)
        assert FG4 == FG and R % 512 == 0
    assert wave_fits(33, B, 255)


def test_group_space_plain_histograms_agree():
    """K1's, K3's and K4's plain versions on bundle codes at 256 bins:
    one leaf's histogram is the same integer sums whichever computes it
    (the card holds each kernel against these)."""
    X, y, _ = _onehot(1024)
    core = tlgb.Dataset(sps.csr_matrix(X), label=y,
                        params=CPU)._core_or_construct()
    codes = torch.from_numpy(core.binned.copy())
    Fg, n = codes.shape
    rng = np.random.RandomState(8)
    gh = torch.from_numpy(np.stack([rng.randn(n), rng.rand(n),
                                    np.ones(n)], 1).astype(np.float32))
    slot = torch.from_numpy(rng.randint(0, 3, n).astype(np.int32))
    exps = H.scale_exps(gh)
    k1, c1 = H.build_histogram_wave_fixed(codes, slot, gh, exps, max_bin=256,
                                          num_slots=3)
    k3, c3 = H.build_histogram_wave_hl_fixed(codes, codes.t().contiguous(),
                                             slot, gh, exps, max_bin=256,
                                             num_slots=3, out_slots=8)
    assert torch.equal(k1, k3[:3]) and torch.equal(c1, c3[:3])
    assert not k3[3:].any()
    for s in range(3):
        k4 = H.build_histogram_rows_fixed(
            codes.t().contiguous(), gh[:, :2].contiguous(),
            (slot == s).to(torch.float32), exps[:2], max_bin=256)
        assert torch.equal(k4, k1[s])
