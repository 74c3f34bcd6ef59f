"""PyTorch port: the objective classes (lightgbm_tpu_torch/objective.py)
against the JAX package's (lightgbm_tpu/objective.py) on the same arrays,
on the CPU.

Every ported objective, unweighted and weighted, at n = 777 rows made
from a seed: gradients and hessians agree within rtol 2^-22 plus atol
1e-7.  The port evaluates them in float64 and rounds once to float32;
the JAX package's jnp maps are evaluated on the same float32 inputs in
float64 too (`jax.enable_x64`) and rounded the same way.  Evaluated in
float32 they lose up to 2^-24 (e^f + y) to the cancellation of
e^f - y (poisson, tweedie), 6.6e-6 relative on one poisson row of this
data, which no relative tolerance on the result covers.
`convert_output` (torch, float64) and `convert_output_host` agree with
the JAX package's NumPy converter;
`boost_from_score` is the same float64 NumPy code and agrees exactly.
The leaf renewal of L1, quantile and MAPE (`percentile_by_leaf`, on
the device) equals JAX `renew_tree_output` (a host loop over the leaves)
within rtol 1e-6, weighted and unweighted, with an empty leaf, with rows
out of the bag, and on residuals with ties.  The label checks raise the
JAX package's fatal messages.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu import objective as jobjective
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu_torch import objective as tobjective
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.utils.log import LightGBMError

N, K = 777, 4
EXTRA = {"alpha": 0.7, "fair_c": 0.8, "tweedie_variance_power": 1.3,
         "poisson_max_delta_step": 0.6, "verbosity": -1}
POINTWISE = ["regression", "regression_l1", "huber", "fair", "poisson",
             "quantile", "mape", "gamma", "tweedie", "cross_entropy",
             "cross_entropy_lambda", "binary"]
MULTICLASS = ["multiclass", "multiclassova"]
RENEW = ["regression_l1", "quantile", "mape"]
GRAD_TOL = {"rtol": 2.0 ** -22, "atol": 1e-7}


def _params(name, **kw):
    p = {"objective": name, **EXTRA, **kw}
    if name in MULTICLASS:
        p["num_class"] = K
    return p


def _label(name, rng, n=N):
    if name in MULTICLASS:
        return rng.randint(0, K, n).astype(np.float32)
    if name == "binary":
        return (rng.rand(n) < 0.4).astype(np.float32)
    if name.startswith("cross_entropy"):
        return rng.rand(n).astype(np.float32)
    if name in ("poisson", "tweedie"):
        return rng.poisson(2.0, n).astype(np.float32)
    if name == "gamma":
        return (rng.gamma(2.0, 1.0, n) + 0.01).astype(np.float32)
    return (rng.randn(n) * 2).astype(np.float32)


def _pair(name, weighted, seed=0, n=N, **kw):
    """(JAX objective, port objective, label, weight) initialised on the
    same metadata."""
    rng = np.random.RandomState(seed)
    label = _label(name, rng, n)
    weight = ((0.5 + rng.rand(n)).astype(np.float32) if weighted else None)
    md = types.SimpleNamespace(label=label, weight=weight, init_score=None,
                               query_boundaries=None)
    jo = jobjective.create_objective(JConfig(_params(name, **kw)))
    to = tobjective.create_objective(TConfig(_params(name, **kw)))
    jo.init(md, n)
    to.init(md, n)
    return jo, to, label, weight


def _score(name, seed=1, n=N):
    rng = np.random.RandomState(seed)
    shape = (K, n) if name in MULTICLASS else (n,)
    return (rng.randn(*shape) * 1.5).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", POINTWISE + MULTICLASS)
def test_gradients_match_jax(name, weighted):
    jo, to, label, weight = _pair(name, weighted)
    score = _score(name)

    def f64(a):
        return None if a is None else jnp.asarray(a.astype(np.float64))
    with jax.enable_x64(True):
        gj, hj = jo.get_gradients(f64(score), f64(label), f64(weight))
        assert gj.dtype == jnp.float64
        gj = np.asarray(gj).astype(np.float32)
        hj = np.asarray(hj).astype(np.float32)
    gt, ht = to.get_gradients(torch.from_numpy(score),
                              torch.from_numpy(label),
                              None if weight is None
                              else torch.from_numpy(weight))
    assert gt.dtype == torch.float32 and ht.dtype == torch.float32
    assert tuple(gt.shape) == score.shape == tuple(ht.shape)
    np.testing.assert_allclose(gt.numpy(), gj, **GRAD_TOL)
    np.testing.assert_allclose(ht.numpy(), hj, **GRAD_TOL)


@pytest.mark.parametrize("name", POINTWISE + MULTICLASS + ["reg_sqrt"])
def test_convert_and_boost_from_score_match_jax(name):
    reg_sqrt = name == "reg_sqrt"
    name = "regression" if reg_sqrt else name
    for weighted in (False, True):
        jo, to, label, _ = _pair(name, weighted, reg_sqrt=reg_sqrt)
        if reg_sqrt:
            np.testing.assert_array_equal(to.label, jo.label)
        score = _score(name).astype(np.float64)
        want = jo.convert_output_host(score)
        np.testing.assert_allclose(to.convert_output_host(score), want,
                                   rtol=1e-15, atol=0)
        got = to.convert_output(torch.from_numpy(score)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-300)
        with jax.enable_x64(True):
            jconv = np.asarray(jo.convert_output(jnp.asarray(score)))
        np.testing.assert_allclose(got, jconv, rtol=1e-13, atol=1e-300)
        for k in range(to.num_model_per_iteration()):
            assert to.boost_from_score(k) == jo.boost_from_score(k)


def _renew_case(name, weighted, seed, with_ties=False):
    """Leaf ids over 6 leaves with leaf 4 empty and ~20% of the rows out
    of the bag (-1), scores near the labels."""
    jo, to, label, weight = _pair(name, weighted, seed=seed)
    rng = np.random.RandomState(seed + 100)
    L = 6
    leaf = rng.randint(0, L, N)
    leaf[leaf == 4] = 5
    leaf[rng.rand(N) < 0.2] = -1
    score = (label + rng.randn(N)).astype(np.float32)
    if with_ties:
        score = (label - np.round(rng.randn(N) * 2)).astype(np.float32)
    return jo, to, leaf, score, L


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", RENEW)
def test_renewal_matches_jax(name, weighted, ties):
    for seed in range(3):
        jo, to, leaf, score, L = _renew_case(name, weighted, seed, ties)
        want = jo.renew_tree_output(leaf, score, L)
        got = to.renew_tree_output(torch.from_numpy(leaf),
                                   torch.from_numpy(score), L)
        assert got.dtype == torch.float64 and got.shape == (L,)
        assert want[4] == 0.0 and float(got[4]) == 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_renewal_against_a_float64_constant_score():
    """RF renews against its constant init score in float64: the
    residuals are float64 there, as in the JAX package."""
    for name in RENEW:
        jo, to, leaf, _, L = _renew_case(name, True, 5)
        score = np.full(N, 0.3712, np.float64)
        want = jo.renew_tree_output(leaf, score, L)
        got = to.renew_tree_output(torch.from_numpy(leaf),
                                   torch.from_numpy(score), L)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("alpha", [0.0, 0.05, 0.5, 0.95, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_percentile_by_leaf_equals_plain_version(alpha, weighted):
    """The device version against its NumPy plain version on segments of
    1, 2 and many rows, at the alphas that take each branch."""
    rng = np.random.RandomState(3)
    sizes = [1, 2, 3, 40, 0, 200]
    leaf = np.concatenate([np.full(s, i) for i, s in enumerate(sizes)])
    perm = rng.permutation(len(leaf))
    leaf = leaf[perm]
    vals = np.round(rng.randn(len(leaf)) * 4).astype(np.float32) / 4
    w = (0.25 + rng.rand(len(leaf))).astype(np.float32) if weighted else None
    got = tobjective.percentile_by_leaf(
        torch.from_numpy(leaf), torch.from_numpy(vals),
        None if w is None else torch.from_numpy(w), alpha, len(sizes))
    want = [tobjective._weighted_percentile(
        vals[leaf == i], None if w is None else w[leaf == i], alpha)
        for i in range(len(sizes))]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("name,label,message", [
    ("poisson", -1.0, r"\[poisson\]: at least one target label is negative"),
    ("gamma", -1.0, r"\[poisson\]: at least one target label is negative"),
    ("tweedie", -1.0, r"\[poisson\]: at least one target label is negative"),
    ("cross_entropy", 1.5, r"\[cross_entropy\]: label must be in \[0, 1\]"),
    ("cross_entropy_lambda", -0.5,
     r"\[cross_entropy_lambda\]: label must be in \[0, 1\]"),
    ("multiclass", 4.0, r"Label must be in \[0, 4\)"),
    ("multiclass", -1.0, r"Label must be in \[0, 4\)")])
def test_label_checks_are_fatal(name, label, message):
    rng = np.random.RandomState(0)
    lab = _label(name, rng)
    lab[7] = label
    md = types.SimpleNamespace(label=lab, weight=None, init_score=None,
                               query_boundaries=None)
    for mod, cfg in ((jobjective, JConfig), (tobjective, TConfig)):
        obj = mod.create_objective(cfg(_params(name)))
        with pytest.raises(Exception, match=message) as e:
            obj.init(md, N)
        if mod is tobjective:
            assert isinstance(e.value, LightGBMError)


def test_unported_and_unknown_objectives():
    # every objective is ported: the ranking ones build from the factory
    # as in the JAX package (training them: tests/test_torch_ranking.py)
    for name in ("lambdarank", "rank_xendcg"):
        obj = tobjective.create_objective(TConfig({"objective": name}))
        assert obj.name == name
        assert type(obj).__name__ == type(jobjective.create_objective(
            JConfig({"objective": name}))).__name__
    for name in ("custom", "none"):
        assert tobjective.create_objective(
            TConfig({"objective": name})) is None
    assert set(tobjective._REGISTRY) == set(jobjective._REGISTRY)
