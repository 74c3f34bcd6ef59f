"""PyTorch port: the command line (`python -m lightgbm_tpu_torch`) against
the JAX package's, on the CPU (`device_type=cpu`).

Data: 2,000 x 6 rows of a binary label written as a TSV file (label in
column 0), and a 500-row file for prediction; the cases of
tests/test_cli.py that need no reference examples.  Each task runs in
both packages' command lines on the same config file and arguments:
`train` grows the same trees (split features, thresholds, children;
leaf values within 1e-4 relative, the float32 stray of ROADMAP's
divergences) on the leaf-wise engine (`tpu_growth_strategy` passed to
both), `predict` writes the same numbers within 1e-5, `refit` the same
leaf values, `convert_model` C++ source; valid files, snapshots,
`input_model`, `save_binary`, streamed prediction in chunks, SHAP
contributions.  Then the port's own: `python -m lightgbm_tpu_torch` in a
subprocess with JAX blocked, the option that stays refused (training
across machines), the default device, which refuses without a card,
the serving tasks in subprocesses on the CPU: `serve` with a ready file
answering a line-JSON request byte for byte and draining to 143 on
SIGTERM, and `serve-fleet` answering through its router; and the online
task `train-and-serve`: a control run over three chunk files, a run
killed by SIGTERM after generation 2 (exit 143), and its relaunch, which
serves generation 2 at once and re-trains generation 3 into the control
run's checkpoint byte for byte.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu_torch as tlgb
import lightgbm_tpu_torch.cli as tcli
from lightgbm_tpu.cli import main as jmain
from lightgbm_tpu_torch.cli import main, parse_args

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["objective=binary", "num_leaves=7", "verbosity=-1",
          "tpu_growth_strategy=leafwise", "min_data_in_leaf=10"]
CPU = ["device_type=cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    for name, n in (("train.tsv", 2000), ("test.tsv", 500)):
        X = rng.randn(n, 6)
        y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.logistic(size=n) > 0)
        np.savetxt(d / name, np.column_stack([y, X]), delimiter="\t",
                   fmt="%.9g")
    conf = d / "train.conf"
    conf.write_text("task = train\nobjective = binary\nnum_leaves = 31\n"
                    "learning_rate = 0.2\n# a comment\n"
                    f"data = {d / 'train.tsv'}\n")
    return d


def _both(d, tag, args):
    """The same arguments through both command lines; model paths and
    outputs take the package's tag.  Returns (port rc, JAX rc)."""
    rcs = []
    for pkg, run, extra in (("t", main, CPU), ("j", jmain, [])):
        rcs.append(run([a.replace("{p}", f"{d}/{pkg}_{tag}") for a in args]
                       + extra))
    return rcs


def _same_models(path_t, path_j):
    bt = tlgb.Booster(model_file=path_t, params={"device_type": "cpu"})
    bj = jlgb.Booster(model_file=path_j)
    ta, tb = bj._gbdt.models_, bt._gbdt.models_
    assert len(ta) == len(tb) > 0
    for a, b in zip(ta, tb):
        ni = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "threshold", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:ni],
                                          getattr(b, k)[:ni], err_msg=k)
        np.testing.assert_allclose(b.leaf_value[:ni + 1],
                                   a.leaf_value[:ni + 1], rtol=1e-4,
                                   atol=1e-9)
    return bt, bj


def test_parse_args_precedence(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("num_leaves = 31\nlearning_rate = 0.05\n# comment\n")
    params = parse_args([f"config={conf}", "num_leaves=7", "data=x.txt"])
    assert params == {"num_leaves": "7", "learning_rate": "0.05",
                      "data": "x.txt"}


def test_train_predict_refit_convert_equal_jax(files):
    d = files
    assert _both(d, "m", [f"config={d}/train.conf", "num_iterations=5",
                          "num_leaves=7", *COMMON[1:],
                          "output_model={p}.txt"]) == [0, 0]
    bt, _ = _same_models(f"{d}/t_m.txt", f"{d}/j_m.txt")
    assert bt.num_trees() == 5
    # config file values under the command line's: 7 leaves, lr 0.2
    assert max(t.num_leaves for t in bt._gbdt.models_) <= 7
    assert _both(d, "m", ["task=predict", f"data={d}/test.tsv",
                          "input_model={p}.txt",
                          "output_result={p}.pred"]) == [0, 0]
    pt, pj = np.loadtxt(f"{d}/t_m.pred"), np.loadtxt(f"{d}/j_m.pred")
    assert pt.shape == (500,)
    np.testing.assert_allclose(pt, pj, rtol=1e-5)
    # the port's file equals its Booster.predict in %.18g
    X = np.loadtxt(f"{d}/test.tsv")[:, 1:]
    want = "".join(f"{v:.18g}\n" for v in bt.predict(X))
    assert open(f"{d}/t_m.pred").read() == want
    assert _both(d, "m", ["task=refit", f"data={d}/train.tsv",
                          "input_model={p}.txt",
                          "output_model={p}_refit.txt"]) == [0, 0]
    rt, rj = _same_models(f"{d}/t_m_refit.txt", f"{d}/j_m_refit.txt")
    assert open(f"{d}/t_m_refit.txt").read() != open(f"{d}/t_m.txt").read()
    # the port's refit equals Booster.refit on the parsed file
    tr = np.loadtxt(f"{d}/train.tsv")
    again = tlgb.Booster(model_file=f"{d}/t_m.txt",
                         params={"device_type": "cpu"}).refit(tr[:, 1:],
                                                              tr[:, 0])
    for a, b in zip(again._gbdt.models_, rt._gbdt.models_):
        np.testing.assert_array_equal(a.leaf_value[:a.num_leaves],
                                      b.leaf_value[:b.num_leaves])
    assert _both(d, "m", ["task=convert_model", "input_model={p}.txt",
                          "convert_model={p}.cpp"]) == [0, 0]
    src = open(f"{d}/t_m.cpp").read()
    assert "double Predict(const double* row)" in src
    assert "PredictTree0" in src


def test_valid_snapshot_and_input_model_equal_jax(files):
    d = files
    assert _both(d, "s", [f"data={d}/train.tsv", f"valid={d}/test.tsv",
                          "num_iterations=6", "snapshot_freq=2", *COMMON,
                          "output_model={p}.txt"]) == [0, 0]
    for pkg in ("t", "j"):
        snaps = sorted(os.listdir(d))
        assert [s for s in snaps if s.startswith(f"{pkg}_s.txt.snapshot")] \
            == [f"{pkg}_s.txt.snapshot_iter_{i}" for i in (2, 4, 6)]
    _same_models(f"{d}/t_s.txt", f"{d}/j_s.txt")
    # continued from the 2-iteration snapshot, 2 more iterations
    for pkg, run, extra in (("t", main, CPU), ("j", jmain, [])):
        assert run([f"data={d}/train.tsv", "num_iterations=2", *COMMON,
                    f"input_model={d}/{pkg}_s.txt.snapshot_iter_2",
                    f"output_model={d}/{pkg}_cont.txt", *extra]) == 0
    bt, _ = _same_models(f"{d}/t_cont.txt", f"{d}/j_cont.txt")
    assert bt.num_trees() == 4


def test_predict_streams_in_chunks_and_contrib(files, monkeypatch):
    d = files
    assert main([f"data={d}/train.tsv", "num_iterations=3", *COMMON,
                 f"output_model={d}/t_p.txt", *CPU]) == 0
    args = ["task=predict", f"data={d}/test.tsv",
            f"input_model={d}/t_p.txt", *CPU]
    assert main(args + [f"output_result={d}/full.txt"]) == 0
    monkeypatch.setattr(tcli, "_PREDICT_CHUNK_BUDGET", 8 * 6 * 100)
    assert main(args + [f"output_result={d}/chunked.txt"]) == 0
    full = open(f"{d}/full.txt").read()
    assert full == open(f"{d}/chunked.txt").read()
    assert len(full.splitlines()) == 500
    assert main(args + ["predict_contrib=true",
                        f"output_result={d}/contrib.txt"]) == 0
    contrib = np.loadtxt(f"{d}/contrib.txt")
    raw = tlgb.Booster(model_file=f"{d}/t_p.txt",
                       params={"device_type": "cpu"}).predict(
        np.loadtxt(f"{d}/test.tsv")[:, 1:], raw_score=True)
    assert contrib.shape == (500, 7)
    np.testing.assert_allclose(contrib.sum(1), raw, rtol=1e-9, atol=1e-12)


def test_save_binary_equals_jax(files):
    d = files
    for run, extra in ((main, CPU), (jmain, [])):
        assert run(["task=save_binary", f"data={d}/train.tsv",
                    "verbosity=-1", *extra]) == 0
        os.replace(f"{d}/train.tsv.bin.npz",
                   f"{d}/{'t' if run is main else 'j'}.bin.npz")
    a, b = (tlgb.Dataset(f"{d}/{p}.bin.npz",
                         params={"device_type": "cpu"}).construct()._core
            for p in ("t", "j"))
    np.testing.assert_array_equal(a.binned_host(), b.binned_host())
    np.testing.assert_array_equal(a.metadata.label, b.metadata.label)


def test_python_dash_m_with_jax_blocked(files, tmp_path):
    d = files
    code = ("import sys, runpy\n"
            "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['lightgbm_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('lightgbm_tpu_torch', run_name='__main__')\n")
    model = tmp_path / "model.txt"
    r = subprocess.run(
        [sys.executable, "-c", code, f"data={d}/train.tsv",
         "num_iterations=2", *COMMON, f"output_model={model}", *CPU],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert model.read_text().startswith("tree\n")


# num_machines > 1 is ported since (test_torch_distributed.py trains over
# a machine list), and so are the feature and voting learners: args2
# keeps its name and holds that tree_learner=voting with no machine list
# trains on one device, the serial run's model
@pytest.mark.parametrize("args", [
    pytest.param(["tree_learner=voting"], id="args2-item 15")])
def test_unported_refuse(files, args):
    d = files
    models = []
    for extra in (args, ["tree_learner=serial"]):
        out = d / f"{extra[0].replace('=', '_')}.txt"
        main([a.replace("{d}", str(d)) for a in extra]
             + [f"data={d}/train.tsv", "num_iterations=2", *COMMON,
                f"output_model={out}", *CPU])
        models.append(out.read_text().split("\nparameters:")[0])
    assert models[0] == models[1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_refuses_without_a_card(files):
    d = files
    with pytest.raises(RuntimeError, match="CUDA"):
        main([f"data={d}/train.tsv", "num_iterations=1", *COMMON,
              f"output_model={d}/nocard.txt"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("task", ["serve", "serve-fleet"])
def test_serving_tasks_refuse_without_a_card(files, task):
    d = files
    with pytest.raises(RuntimeError, match="CUDA"):
        main([task, f"serve_models=m={d}/absent.txt", "verbosity=-1"])


@pytest.fixture(scope="module")
def serve_model(files):
    d = files
    model = d / "serve_model.txt"
    assert main([f"data={d}/train.tsv", "num_iterations=4", *COMMON,
                 f"output_model={model}", *CPU]) == 0
    X = np.loadtxt(d / "test.tsv", delimiter="\t")[:, 1:]
    return model, X.astype(np.float32)


def _start(args, ready, env=None):
    """A `python -m lightgbm_tpu_torch` serving process; waits for its
    ready file and returns (process, ready JSON)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", *args,
         f"serve_ready_file={ready}"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 180
    while not os.path.exists(ready):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            pytest.fail(proc.communicate()[0][-3000:])
        time.sleep(0.1)
    with open(ready) as f:
        return proc, json.load(f)


def _sigterm(proc):
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode in (143, -signal.SIGTERM), out[-3000:]


def _oracle(model, X):
    b = tlgb.Booster(model_file=str(model),
                     params={"device_type": "cpu", "device_predict": "true"})
    return b.predict(X)


def test_cli_serve_answers_a_line_client(serve_model, tmp_path):
    from lightgbm_tpu_torch.serving import LineClient
    model, X = serve_model
    proc, ready = _start(["serve", f"serve_models=m={model}",
                          "serve_port=0", "device_predict_min_bucket=64",
                          "serve_max_batch_rows=256", "verbosity=-1",
                          *CPU], tmp_path / "ready.json")
    try:
        assert ready["pid"] == proc.pid and ready["models"] == {"m": 1}
        c = LineClient("127.0.0.1", ready["port"])
        reply = c.request({"model": "m", "rows": X[:7].tolist()},
                          timeout_s=60)
        assert reply["ok"] and reply["version"] == 1
        got = np.asarray(reply["preds"]).astype(np.float32)
        assert got.tobytes() == _oracle(model, X[:7]).tobytes()
        assert c.request({"op": "health"}, timeout_s=30)["ready"] is True
        c.close()
    finally:
        _sigterm(proc)


def test_cli_serve_fleet_answers_through_the_router(serve_model, tmp_path):
    from lightgbm_tpu_torch.serving import LineClient
    model, X = serve_model
    proc, ready = _start(["serve-fleet", f"serve_models=m={model}",
                          "serve_replicas=2", "serve_port=0",
                          "device_predict_min_bucket=64",
                          "serve_max_batch_rows=256", "verbosity=-1",
                          f"metrics_dir={tmp_path / 'fleet'}", *CPU],
                         tmp_path / "ready.json")
    try:
        assert len(ready["replicas"]) == 2
        c = LineClient("127.0.0.1", ready["port"])
        want = _oracle(model, X[:5]).tobytes()
        for _ in range(4):
            reply = c.request({"model": "m", "rows": X[:5].tolist(),
                               "deadline_ms": 30_000}, timeout_s=60)
            assert reply["ok"], reply
            got = np.asarray(reply["preds"]).astype(np.float32)
            assert got.tobytes() == want
        # the ready file lands once one replica is routable
        deadline = time.monotonic() + 120
        while True:
            h = c.request({"op": "health"}, timeout_s=30)
            if h["routable"] == 2 or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert h["ok"] and h["routable"] == 2
        page = c.request({"op": "metrics"}, timeout_s=30)["metrics"]
        assert "lgbm_router_requests" in page
        assert "lgbm_fleet_replicas_routable 2" in page
        c.close()
    finally:
        _sigterm(proc)


# ------------------------------------------------------ train-and-serve
ONLINE = ["objective=binary", "num_leaves=7", "verbosity=-1",
          "min_data_in_leaf=10", "device_predict=true",
          "device_predict_min_bucket=64", "serve_warmup=false",
          "online_mode=boost", "online_trees_per_chunk=2",
          "online_poll_interval_s=0.05", *CPU]
RUN_S = 300     # every child process's deadline


def _online(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", "train-and-serve",
         *ONLINE, *args], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, **kw)


def _finish(proc):
    try:
        out, _ = proc.communicate(timeout=RUN_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate(timeout=60)
        pytest.fail(f"timed out: {out[-3000:]}")
    return proc.returncode, out


def _wait_for(path, proc):
    deadline = time.monotonic() + RUN_S
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            pytest.fail(proc.communicate(timeout=60)[0][-3000:])
        time.sleep(0.1)


def test_cli_train_and_serve_sigterm_drill(serve_model, tmp_path):
    from lightgbm_tpu_torch.online import write_chunk
    from lightgbm_tpu_torch.serving import LineClient
    seed, X = serve_model
    rng = np.random.RandomState(5)
    (tmp_path / "src").mkdir()
    chunk_files = {}
    for g in (1, 2, 3):
        Xg = rng.randn(300, 6)
        yg = (Xg[:, 0] + 0.5 * Xg[:, 1] > 0).astype(np.float64)
        chunk_files[g] = write_chunk(str(tmp_path / "src"), g, Xg, yg)
    # control: all three generations in one run, exits once idle
    ck_a = tmp_path / "ck_a"
    rc, out = _finish(_online([f"online_chunk_dir={tmp_path / 'src'}",
                               f"checkpoint_dir={ck_a}", "serve_port=-1",
                               "online_idle_exit_s=1.5",
                               f"input_model={seed}"]))
    assert rc == 0, out[-3000:]
    control_g2 = (ck_a / "ckpt_0000002.txt").read_text()
    control_g3 = (ck_a / "ckpt_0000003.txt").read_text()
    # the drill: generations 1-2 land, SIGTERM after generation 2
    chunks_b = tmp_path / "chunks_b"
    chunks_b.mkdir()
    for g in (1, 2):
        os.link(chunk_files[g], chunks_b / os.path.basename(chunk_files[g]))
    ck_b = tmp_path / "ck_b"
    proc = _online([f"online_chunk_dir={chunks_b}", f"checkpoint_dir={ck_b}",
                    "serve_port=-1", "online_idle_exit_s=0",
                    f"input_model={seed}"])
    _wait_for(ck_b / "ckpt_0000002.txt", proc)
    time.sleep(0.3)     # the generation-2 publish settles
    proc.send_signal(signal.SIGTERM)
    rc, out = _finish(proc)
    assert rc in (143, -signal.SIGTERM), out[-3000:]
    # the relaunch with generation 3 landed: it serves generation 2 at
    # once, then re-trains generation 3 as the control run did
    os.link(chunk_files[3], chunks_b / os.path.basename(chunk_files[3]))
    ready = tmp_path / "ready.json"
    proc = _online([f"online_chunk_dir={chunks_b}", f"checkpoint_dir={ck_b}",
                    "serve_port=0", "online_idle_exit_s=1.5",
                    f"serve_ready_file={ready}", f"input_model={seed}"])
    _wait_for(ready, proc)
    with open(ready) as f:
        info = json.load(f)
    assert info["generation"] == 2 and info["model"] == "online"
    c = LineClient("127.0.0.1", info["port"])
    try:
        reply = c.request({"model": "online", "rows": X[:4].tolist()},
                          timeout_s=60)
    finally:
        c.close()
    assert reply["ok"], reply
    got = np.asarray(reply["preds"]).astype(np.float32).tobytes()
    served = [tlgb.Booster(model_str=t, params={
        "device_type": "cpu", "device_predict": "true"}).predict(
            X[:4]).tobytes() for t in (control_g2, control_g3)]
    assert got in served        # never the seed
    rc, out = _finish(proc)
    assert rc == 0, out[-3000:]
    assert (ck_b / "ckpt_0000003.txt").read_text() == control_g3


@pytest.mark.parametrize("spelling", [["task=train_and_serve"],
                                      ["task=train-and-serve"]])
def test_cli_train_and_serve_spellings(serve_model, tmp_path, spelling):
    """Both task spellings run the loop (here with no seed model: the
    first generation boosts from scratch), and without a chunk
    directory the task refuses."""
    from lightgbm_tpu_torch.online import write_chunk
    rng = np.random.RandomState(6)
    d = tmp_path / "chunks"
    d.mkdir()
    Xg = rng.randn(300, 6)
    write_chunk(str(d), 1, Xg, (Xg[:, 0] > 0).astype(np.float64))
    cmd = [sys.executable, "-m", "lightgbm_tpu_torch", *spelling, *ONLINE]
    r = subprocess.run(cmd + [f"online_chunk_dir={d}",
                              f"checkpoint_dir={tmp_path / 'ck'}",
                              "serve_port=-1", "online_max_generations=1"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=RUN_S)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    b = tlgb.Booster(model_file=str(tmp_path / "ck" / "ckpt_0000001.txt"),
                     params={"device_type": "cpu"})
    assert b.num_trees() == 2
    r = subprocess.run(cmd + ["serve_port=-1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=RUN_S)
    assert r.returncode != 0
    assert "online_chunk_dir" in r.stdout + r.stderr
