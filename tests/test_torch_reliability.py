"""PyTorch port: checkpoints, resume, rollback and fault injection on the
CPU (`device_type=cpu`), against the port's own uninterrupted runs and
against the JAX package.

* A run resumed from its checkpoint gives model text byte-identical to
  the uninterrupted run: binary, bagging, DART, quantized, leaf-wise.
* The checkpoint directory is the JAX package's (layout, manifest, npz
  keys, `params_hash`): a JAX checkpoint resumes in the port and a port
  checkpoint in the JAX package, both restoring the exact score buffer
  and sampling streams.  The trees equal the other package's
  uninterrupted run's (split features, thresholds and children exact:
  this data has no tied gains; leaf values within 1e-5) and the raw
  scores agree within 1e-5 (the float32 stray of ROADMAP Queue 3 is
  about 2e-6).
* Rotation and the manifest, `ckpt_corrupt` (truncate and bitflip) into
  quarantine and fallback, a format-1 manifest, mismatched params,
  `resume=false`, resuming past the target, `ckpt_write_fail`, the NaN
  sentinel raising without a checkpoint and rolling back with one, the
  fault-spec parser against the JAX package's, and the command line's
  resume flags.

Trees are compared with `tpu_growth_strategy` pinned in both packages.
Where the JAX package's own resume is not byte-exact (lambdarank's
position bias, rank_xendcg's draw counter, lazy CEGB's fetched rows and
coupled CEGB's used features ride no checkpoint), the port matches it:
ROADMAP Queue 3 states the divergence; these tests do not drive it.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu.reliability import faults as jfaults
from lightgbm_tpu.reliability.checkpoint import hash_params as jhash
from lightgbm_tpu_torch.reliability import (CheckpointManager,
                                            NonFiniteError, faults)
from lightgbm_tpu_torch.reliability.checkpoint import hash_params

PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "device_type": "cpu"}
# the cross-package runs: one engine pinned in both packages
CROSS = {**PARAMS, "num_leaves": 15, "tpu_growth_strategy": "leafwise"}


def _data(n=2048, F=5, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, F)
    y = (X[:, 0] * 2 + X[:, 1] ** 2 + 0.1 * rng.randn(n) > 1.2)
    return X, y.astype(np.float64)


def _text(b):
    return b.model_to_string(num_iteration=-1)


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(autouse=True)
def _clean_fault_env(monkeypatch):
    """Each test starts with no injected faults and leaves none behind."""
    for var in ("LGBM_TPU_FAULT", "LGBM_TPU_FAULT_CORRUPT",
                "LGBM_TPU_FAULT_ATTEMPT"):
        monkeypatch.delenv(var, raising=False)
    faults.reload()
    jfaults.reload()
    yield
    faults.reload()
    jfaults.reload()


def _inject(monkeypatch, spec, **env):
    monkeypatch.setenv("LGBM_TPU_FAULT", spec)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    faults.reload()


# ------------------------------------------------ byte-identical resume
@pytest.mark.parametrize("extra", [
    {},
    {"bagging_freq": 1, "bagging_fraction": 0.7, "feature_fraction": 0.8},
    {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0},
    {"use_quantized_grad": True, "num_grad_quant_bins": 4},
    {"tpu_growth_strategy": "leafwise"}],
    ids=["binary", "bagging", "dart", "quantized", "leafwise"])
def test_resume_is_byte_identical(tmp_path, extra):
    """Interrupted after 6 of 10 iterations (checkpoints at 3 and 6),
    resumed to 10: the model text equals the uninterrupted run's."""
    X, y = _data()
    p = {**PARAMS, **extra}
    full = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 10)
    ck = str(tmp_path / "ck")
    part = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 6,
                      checkpoint_dir=ck, checkpoint_freq=3)
    assert part.current_iteration() == 6
    resumed = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 10,
                         checkpoint_dir=ck, checkpoint_freq=3)
    assert _text(resumed) == _text(full)


def _spy_restore(monkeypatch, gbdt_cls):
    """Record what each restore_train_state call returned (True: the
    exact score buffer was restored)."""
    calls = []
    real = gbdt_cls.restore_train_state

    def spy(self, state):
        ok = real(self, state)
        calls.append(ok)
        return ok
    monkeypatch.setattr(gbdt_cls, "restore_train_state", spy)
    return calls


def _same_structure(ta, tb):
    """The trees of two packages: the same splits and children, leaf
    values within 1e-5."""
    assert ta.num_leaves == tb.num_leaves
    ni = ta.num_leaves - 1
    for a in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(ta, a)[:ni],
                                      getattr(tb, a)[:ni], err_msg=a)
    np.testing.assert_allclose(tb.leaf_value[:ta.num_leaves],
                               ta.leaf_value[:ta.num_leaves], atol=1e-5)


@pytest.mark.parametrize("extra", [
    {}, {"bagging_freq": 1, "bagging_fraction": 0.8}],
    ids=["plain", "bagging"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, monkeypatch, extra,
                                     direction):
    """A checkpoint after 3 iterations written by one package, resumed to
    6 by the other (its exact score buffer restored): trees equal the
    writing package's uninterrupted 6-iteration run,
    raw scores within 1e-5."""
    from lightgbm_tpu.boosting.gbdt import GBDT as JGBDT
    from lightgbm_tpu_torch.boosting.gbdt import GBDT as TGBDT
    X, y = _data(4096, 6)
    p = {**CROSS, **extra}
    writer, reader = ((jlgb, tlgb) if direction == "jax_to_port"
                      else (tlgb, jlgb))
    ck = str(tmp_path / "ck")
    writer.train(dict(p), writer.Dataset(X, label=y), 3,
                 checkpoint_dir=ck, checkpoint_freq=3)
    calls = _spy_restore(monkeypatch, TGBDT if reader is tlgb else JGBDT)
    resumed = reader.train(dict(p), reader.Dataset(X, label=y), 6,
                           checkpoint_dir=ck, checkpoint_freq=3)
    assert calls == [True], "the resume must restore the exact scores"
    full = writer.train(dict(p), writer.Dataset(X, label=y), 6)
    assert resumed.current_iteration() == 6
    # both models read back through the port's model-text loader
    ta, tb = (tlgb.Booster(model_str=_text(m), params={"device_type": "cpu"})
              ._gbdt.models_ for m in (full, resumed))
    assert len(ta) == len(tb) == 6
    for a, b in zip(ta, tb):
        _same_structure(a, b)
    np.testing.assert_allclose(resumed.predict(X, raw_score=True),
                               full.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("params", [
    {"objective": "binary"},
    {"objective": "regression", "bagging_freq": 1, "bagging_fraction": 0.8,
     "checkpoint_dir": "ck", "checkpoint_freq": 2},
    {"boosting": "dart", "metric": ["auc", "binary_logloss"],
     "objective": "binary"},
    {"objective": "binary", "max_bin": 511, "use_quantized_grad": True,
     "tpu_growth_strategy": "wave", "metrics_dir": "m", "verbosity": 2}],
    ids=["binary", "bagged_regression", "dart_two_metrics",
         "quantized_511_bins"])
def test_params_hash_equals_jax(params):
    """The same parameters hash alike in both packages (one
    `_HASH_EXCLUDE`), so a checkpoint's params_hash gate passes across
    them; model-neutral knobs leave the hash unchanged."""
    p = {**params, "device_type": "cpu"}
    assert hash_params(p) == jhash(p)
    assert hash_params(p) == hash_params({**p, "verbosity": -1,
                                          "output_model": "x.txt"})


# -------------------------------------------------- directory and manifest
def test_rotation_and_manifest(tmp_path):
    X, y = _data()
    ck = str(tmp_path / "ck")
    tlgb.train(dict(PARAMS, checkpoint_keep=2), tlgb.Dataset(X, label=y),
               9, checkpoint_dir=ck, checkpoint_freq=2)
    models = sorted(f for f in os.listdir(ck) if f.endswith(".txt"))
    # saves at 2, 4, 6, 8 and the final 9; keep_last=2 -> 8, 9
    assert models == ["ckpt_0000008.txt", "ckpt_0000009.txt"]
    m = json.load(open(os.path.join(ck, "manifest.json")))
    assert m["format"] == 2 and m["iteration"] == 9
    assert [g["iteration"] for g in m["generations"]] == [8, 9]
    assert m["num_rows"] == len(X)
    mgr = CheckpointManager(ck)
    ckpt = mgr.latest()
    assert ckpt.iteration == 9 and ckpt.verify() == (True, "ok")
    state = ckpt.load_state()
    assert sorted(state) == ["bag_mask", "num_data", "rng_bag", "rng_feat",
                             "scores"]
    assert state["scores"].dtype == np.float32
    assert state["scores"].shape[0] == 1


@pytest.mark.parametrize("mode,damaged", [("truncate", "txt"),
                                          ("bitflip", "npz")])
def test_ckpt_corrupt_quarantines_and_falls_back(tmp_path, monkeypatch,
                                                  mode, damaged):
    """ckpt_corrupt@6 damages the newest checkpoint after it lands; the
    resume quarantines it, falls back to iteration 4 with a
    ckpt_fallback event, and the finished run is byte-identical to an
    uninterrupted one."""
    X, y = _data()
    full = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 8)
    ck, mx = str(tmp_path / "ck"), str(tmp_path / "mx")
    _inject(monkeypatch, "ckpt_corrupt@6", LGBM_TPU_FAULT_CORRUPT=mode)
    tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
               checkpoint_dir=ck, checkpoint_freq=2)
    monkeypatch.delenv("LGBM_TPU_FAULT")
    faults.reload()
    resumed = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 8,
                         checkpoint_dir=ck, checkpoint_freq=2,
                         metrics_dir=mx)
    assert _text(resumed) == _text(full)
    assert glob.glob(os.path.join(ck, f"ckpt_0000006.{damaged}.corrupt-*"))
    fb = [e for e in _events(os.path.join(mx, "events-rank0.jsonl"))
          if e["event"] == "ckpt_fallback"]
    assert len(fb) == 1
    assert fb[0]["from_iteration"] == 6 and fb[0]["to_iteration"] == 4
    mgr = CheckpointManager(ck, params=PARAMS)
    for g in json.load(open(os.path.join(ck, "manifest.json")))[
            "generations"]:
        assert mgr._ck_from_entry(g).verify()[0]


def test_format1_manifest_loads_and_resumes(tmp_path):
    """A format-1 manifest (no digests, no generations) stays resumable
    and resumes byte-identically; a damaged manifest falls back to the
    directory scan."""
    X, y = _data()
    full = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6)
    ck = str(tmp_path / "ck")
    tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 4,
               checkpoint_dir=ck, checkpoint_freq=2)
    mpath = os.path.join(ck, "manifest.json")
    m = json.load(open(mpath))
    with open(mpath, "w") as f:
        json.dump({k: m[k] for k in ("iteration", "model", "state",
                                     "params_hash")}, f)
    ckpt = CheckpointManager(ck).resumable(PARAMS)
    assert ckpt is not None and ckpt.iteration == 4 and ckpt.digests is None
    resumed = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                         checkpoint_dir=ck, checkpoint_freq=2)
    assert _text(resumed) == _text(full)
    with open(mpath, "w") as f:
        f.write("{truncated")
    assert CheckpointManager(ck).latest().iteration == 6


def test_resume_ignores_mismatched_params(tmp_path):
    X, y = _data()
    ck = str(tmp_path / "ck")
    tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 3,
               checkpoint_dir=ck, checkpoint_freq=1)
    b = tlgb.train(dict(PARAMS, num_leaves=15), tlgb.Dataset(X, label=y), 3,
                   checkpoint_dir=ck, checkpoint_freq=1)
    assert b.num_trees() == 3      # trained from scratch, not 3 + 3


def test_resume_false_starts_over(tmp_path):
    X, y = _data()
    ck = str(tmp_path / "ck")
    tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 4,
               checkpoint_dir=ck, checkpoint_freq=2)
    b = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 3,
                   checkpoint_dir=ck, checkpoint_freq=2, resume=False)
    assert b.num_trees() == 3


def test_resume_past_target_returns_checkpoint_model(tmp_path):
    X, y = _data()
    ck = str(tmp_path / "ck")
    six = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                     checkpoint_dir=ck, checkpoint_freq=2)
    b = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 4,
                   checkpoint_dir=ck, checkpoint_freq=2)
    assert b.num_trees() == 6 and _text(b) == _text(six)


@pytest.mark.parametrize("async_io", [True, False])
def test_ckpt_write_fail_keeps_training_and_old_ckpt(tmp_path, monkeypatch,
                                                      async_io):
    """An injected write failure warns and training goes on; the earlier
    checkpoint stays resumable until the next good write, and the
    failure is counted and logged."""
    X, y = _data()
    _inject(monkeypatch, "ckpt_write_fail@2")
    ck, mx = str(tmp_path / "ck"), str(tmp_path / "mx")
    b = tlgb.train(dict(PARAMS, async_host_io=async_io),
                   tlgb.Dataset(X, label=y), 4, checkpoint_dir=ck,
                   checkpoint_freq=1, metrics_dir=mx)
    assert b.num_trees() == 4
    assert CheckpointManager(ck).latest().iteration == 4
    assert not os.path.exists(os.path.join(ck, "ckpt_0000002.txt"))
    evs = _events(os.path.join(mx, "events-rank0.jsonl"))
    assert [e["iteration"] for e in evs
            if e["event"] == "checkpoint_write_failed"] == [2]
    assert [e["kind"] for e in evs if e["event"] == "fault_injected"] \
        == ["ckpt_write_fail"]
    assert evs[-1]["event"] == "train_end"
    assert evs[-1]["counters"]["checkpoint_failures"] >= 1


def test_async_and_sync_checkpoints_are_the_same_bytes(tmp_path):
    """The writer thread writes what the synchronous path writes (the
    model text up to its parameters block, which names the knob)."""
    X, y = _data()
    p = dict(PARAMS, bagging_freq=1, bagging_fraction=0.8)
    dirs = {}
    for async_io in (True, False):
        d = str(tmp_path / f"ck_{async_io}")
        tlgb.train(dict(p, async_host_io=async_io), tlgb.Dataset(X, label=y),
                   4, checkpoint_dir=d, checkpoint_freq=2)
        dirs[async_io] = d
    for name in ("ckpt_0000004.txt", "ckpt_0000004.npz",
                 "ckpt_0000002.npz"):
        a, b = (open(os.path.join(dirs[k], name), "rb").read()
                for k in (True, False))
        if name.endswith(".txt"):
            # the parameters block names async_host_io itself
            a, b = (t.split(b"\nparameters:")[0] for t in (a, b))
        assert a == b, name


# --------------------------------------------------- non-finite sentinel
def test_nan_grad_sentinel_raises_without_checkpoint(monkeypatch):
    X, y = _data()
    _inject(monkeypatch, "nan_grad@2")
    with pytest.raises(NonFiniteError, match="[Nn]on-finite"):
        tlgb.train(dict(PARAMS, nonfinite_check_freq=1),
                   tlgb.Dataset(X, label=y), 5)


@pytest.mark.parametrize("extra", [{}, {"boosting": "dart",
                                        "drop_rate": 0.3,
                                        "skip_drop": 0.0}],
                         ids=["gbdt", "dart"])
def test_nan_grad_rolls_back_to_checkpoint(tmp_path, monkeypatch, extra):
    """With checkpoints the sentinel's check right before a checkpoint
    write catches nan_grad@5 (the default nonfinite_check_freq of 10
    would not reach it), rolls back once to iteration 4 and re-runs;
    the fault is one-shot, so the result is the clean run's text."""
    X, y = _data()
    p = {**PARAMS, **extra}
    clean = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 8)
    _inject(monkeypatch, "nan_grad@5")
    ck, mx = str(tmp_path / "ck"), str(tmp_path / "mx")
    b = tlgb.train(dict(p), tlgb.Dataset(X, label=y), 8,
                   checkpoint_dir=ck, checkpoint_freq=2, metrics_dir=mx)
    assert _text(b) == _text(clean)
    evs = _events(os.path.join(mx, "events-rank0.jsonl"))
    rb = [e for e in evs if e["event"] == "rollback_retry"]
    assert len(rb) == 1 and rb[0]["from_iteration"] == 4
    assert evs[-1]["counters"]["rollback_retries"] >= 1


# ------------------------------------------------------ fault injection
@pytest.mark.parametrize("spec", [
    "worker_crash@3,nan_grad@5@1,bogus@1,nan_grad@x",
    "hang@2, slow_iter@4@2 ,collective_stall@1",
    "ckpt_corrupt@4,ckpt_write_fail@2,worker_lost@7@1",
    "serve_crash@10,serve_shed@3,serve_slow@2,online_chunk_corrupt@1,"
    "online_publish_fail@2@0,@3,nan_grad"])
def test_fault_spec_parsing_equals_jax(monkeypatch, spec):
    """The same LGBM_TPU_FAULT parses to the same (kind, iteration,
    attempt) specs in both packages, malformed items dropped."""
    monkeypatch.setenv("LGBM_TPU_FAULT", spec)
    assert faults._KINDS == jfaults._KINDS
    assert faults._parse() == jfaults._parse()
    assert faults._parse()


def test_fault_attempt_gating_and_one_shot(monkeypatch):
    g, h = torch.ones(4), torch.ones(4)
    _inject(monkeypatch, "nan_grad@5@1", LGBM_TPU_FAULT_ATTEMPT="0")
    assert torch.isfinite(faults.maybe_nan_grad(g, h, 5)[0]).all()
    _inject(monkeypatch, "nan_grad@5@1", LGBM_TPU_FAULT_ATTEMPT="1")
    assert torch.isnan(faults.maybe_nan_grad(g, h, 5)[0]).all()
    assert torch.isfinite(faults.maybe_nan_grad(g, h, 5)[0]).all()
    # rank gating: a spec for rank 1 does not fire in rank 0
    _inject(monkeypatch, "nan_grad@5", LGBM_TPU_FAULT_RANK="1")
    assert torch.isfinite(faults.maybe_nan_grad(g, h, 5)[0]).all()


# ------------------------------------------------------------ callbacks
def test_checkpoint_callback_writes_resumable_checkpoints(tmp_path):
    """`tlgb.checkpoint(dir)` given explicitly: rotated checkpoints every
    `frequency` iterations, resumable by `train(checkpoint_dir=dir)`."""
    X, y = _data()
    full = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6)
    ck = str(tmp_path / "ck")
    tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 4,
               callbacks=[tlgb.checkpoint(ck, frequency=2, keep_last=1)])
    assert sorted(os.listdir(ck)) == ["ckpt_0000004.npz", "ckpt_0000004.txt",
                                      "manifest.json"]
    resumed = tlgb.train(dict(PARAMS), tlgb.Dataset(X, label=y), 6,
                         checkpoint_dir=ck, checkpoint_freq=2)
    assert _text(resumed) == _text(full)


# --------------------------------------------------------- command line
def test_cli_resume_flags(tmp_path):
    """task=train with checkpoint_dir/checkpoint_freq: a re-run of the
    same command continues from the newest checkpoint and reproduces an
    uninterrupted run's trees; resume=false starts over."""
    from lightgbm_tpu_torch.cli import main
    X, y = _data(n=600)
    data = str(tmp_path / "train.tsv")
    np.savetxt(data, np.column_stack([y, X]), delimiter="\t", fmt="%.8g")
    common = [f"data={data}", "objective=regression", "num_leaves=7",
              "min_data_in_leaf=5", "verbosity=-1", "device_type=cpu"]
    clean = str(tmp_path / "clean.txt")
    assert main(common + ["num_trees=6", f"output_model={clean}"]) == 0
    ck, out = str(tmp_path / "ck"), str(tmp_path / "model.txt")
    flags = [f"checkpoint_dir={ck}", "checkpoint_freq=2",
             f"output_model={out}"]
    assert main(common + ["num_trees=4"] + flags) == 0
    assert main(common + ["num_trees=6"] + flags) == 0

    def trees(path):
        return open(path).read().split("\nparameters:")[0]
    assert trees(out) == trees(clean)
    out2 = str(tmp_path / "model2.txt")
    assert main(common + ["num_trees=4", f"checkpoint_dir={ck}",
                          "checkpoint_freq=2", "resume=false",
                          f"output_model={out2}"]) == 0
    assert tlgb.Booster(model_file=out2,
                        params={"device_type": "cpu"}).num_trees() == 4
    shutil.rmtree(ck)
