"""PyTorch port: the ranking objectives and file loading on the card
against the same work on the CPU and against the objectives' plain
(NumPy, float64) versions.  These tests skip without a CUDA device.  The
file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_ranking_cuda.py
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch import ranking as trank
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

N_Q, F = 400, 8


def _data(seed=0, max_len=300):
    """Queries of 1 to max_len documents (buckets up to m = 512), graded
    labels, weights and positions."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len, N_Q)
    n = int(lens.sum())
    X = rng.randn(n, F).astype(np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.7 * rng.randn(n)
    y = np.digitize(rel, [-0.5, 0.4, 1.2, 2.0]).astype(np.float32)
    w = (0.5 + rng.rand(n)).astype(np.float32)
    pos = np.concatenate([np.arange(k) for k in lens]) % 20
    return X, y, lens, w, pos


def _objective(name, y, lens, w, pos, **params):
    md = Metadata(len(y))
    md.set_label(y)
    md.set_group(lens)
    md.set_weight(w)
    if pos is not None:
        md.set_position(pos)
    cls = {"lambdarank": trank.LambdarankNDCG,
           "rank_xendcg": trank.RankXENDCG}[name]
    obj = cls(Config({"objective": name, **params}))
    obj.init(md, len(y))
    return obj


def _pad(v, n_pad, dev):
    out = torch.zeros(n_pad, dtype=torch.float32)
    out[:len(v)] = torch.from_numpy(np.asarray(v, np.float32))
    return out.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name,position", [
    ("lambdarank", False), ("lambdarank", True), ("rank_xendcg", True)])
def test_card_gradients_equal_plain_version(name, position):
    """Three iterations: the card's gradients within rtol 1e-6 of the
    float64 host loop (`get_gradients_host`), the same bits on a second
    objective, and the position-bias state within 1e-9 of the host loop's
    and bit-equal between the two card runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, lens, w, pos = _data()
    pos = pos if position else None
    n = len(y)
    n_pad = (n + 1023) // 1024 * 1024
    dev = torch.device("cuda")
    params = {"lambdarank_position_bias_regularization": 0.1}
    card = [_objective(name, y, lens, w, pos, **params) for _ in range(2)]
    host = _objective(name, y, lens, w, pos, **params)
    rng = np.random.RandomState(1)
    for _ in range(3):
        score = rng.randn(n).astype(np.float32)
        g0, h0 = card[0].get_gradients(_pad(score, n_pad, dev), None,
                                       _pad(w, n_pad, dev))
        g1, h1 = card[1].get_gradients(_pad(score, n_pad, dev), None,
                                       _pad(w, n_pad, dev))
        assert torch.equal(g0, g1) and torch.equal(h0, h1)
        gh, hh = host.get_gradients_host(score.astype(np.float64))
        np.testing.assert_allclose(g0[:n].cpu().numpy(), gh, rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(h0[:n].cpu().numpy(), hh, rtol=1e-6,
                                   atol=1e-12)
        assert float(g0[n:].abs().sum()) == 0.0
    if position:
        np.testing.assert_array_equal(card[0].pos_biases, card[1].pos_biases)
        np.testing.assert_allclose(card[0].pos_biases, host.pos_biases,
                                   rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_card_xendcg_equals_cpu():
    """The threefry path: the card's draws and gradients equal the CPU's
    within rtol 1e-6 (float64 exp on two devices, rounded once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, lens, w, _ = _data(2)
    n = len(y)
    n_pad = (n + 1023) // 1024 * 1024
    objs = {d: _objective("rank_xendcg", y, lens, w, None)
            for d in ("cuda", "cpu")}
    rng = np.random.RandomState(3)
    for _ in range(2):
        score = rng.randn(n).astype(np.float32)
        out = {d: [t.cpu().numpy() for t in objs[d].get_gradients(
            _pad(score, n_pad, d), None, _pad(w, n_pad, d))]
            for d in objs}
        for a, b in zip(out["cuda"], out["cpu"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.cuda
def test_card_chunking_gives_the_same_bits(monkeypatch):
    """Queries of up to 1,251 documents (m = 2048): chunks of a few
    queries give the bits of the default chunking."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, lens, w, _ = _data(4, max_len=1252)
    n = len(y)
    n_pad = (n + 1023) // 1024 * 1024
    score = _pad(np.random.RandomState(5).randn(n), n_pad, "cuda")
    want = _objective("lambdarank", y, lens, w, None).get_gradients(score)
    monkeypatch.setattr(trank, "PAIR_BUDGET", 1 << 16)
    got = _objective("lambdarank", y, lens, w, None).get_gradients(score)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


CASES = [("lambdarank", {"tpu_growth_strategy": "wave"}, False),
         ("lambdarank", {"tpu_growth_strategy": "leafwise"}, True),
         ("rank_xendcg", {"use_quantized_grad": True}, False),
         ("rank_xendcg", {"tpu_growth_strategy": "wave"}, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("objective,extra,position", CASES,
                         ids=[f"{o}-{'-'.join(map(str, x.values()))}"
                              f"{'-position' if p else ''}"
                              for o, x, p in CASES])
def test_card_trees_equal_cpu_trees(objective, extra, position):
    """Three iterations, 31 leaves: the card grows the CPU's trees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, lens, w, pos = _data(6)
    params = {"objective": objective, "num_leaves": 31, "max_bin": 63,
              "verbosity": -1, **extra}
    models = {}
    for dev in ("cuda", "cpu"):
        b = tlgb.train({**params, "device_type": dev},
                       tlgb.Dataset(X, label=y, group=lens, weight=w,
                                    position=pos if position else None), 3)
        models[dev] = b._gbdt.models_
    for a, c in zip(models["cuda"], models["cpu"]):
        ni = a.num_leaves - 1
        assert a.num_leaves == c.num_leaves
        np.testing.assert_array_equal(a.split_feature[:ni],
                                      c.split_feature[:ni])
        np.testing.assert_array_equal(a.threshold[:ni], c.threshold[:ni])
        np.testing.assert_allclose(a.leaf_value[:ni + 1],
                                   c.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-9)


@pytest.mark.cuda
def test_card_dataset_from_file_equals_cpu(tmp_path):
    """A TSV file with .query and .weight side files and its binary copy
    load on the card with the CPU's bins, labels, weights and queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    X, y, lens, w, _ = _data(7, max_len=40)
    path = str(tmp_path / "rank.tsv")
    np.savetxt(path, np.column_stack([y, X]), fmt="%.7g", delimiter="\t")
    np.savetxt(path + ".query", lens, fmt="%d")
    np.savetxt(path + ".weight", w, fmt="%.7g")
    cores = {d: tlgb.Dataset(path, params={"device_type": d}).construct()
             for d in ("cuda", "cpu")}
    cores["cuda"].save_binary(str(tmp_path / "rank.bin"))
    cores["bin"] = tlgb.Dataset(str(tmp_path / "rank.bin")).construct()
    want = cores["cpu"]._core
    for key in ("cuda", "bin"):
        got = cores[key]._core
        np.testing.assert_array_equal(got.binned_host(), want.binned_host())
        for f in ("label", "weight", "query_boundaries"):
            np.testing.assert_array_equal(getattr(got.metadata, f),
                                          getattr(want.metadata, f))
