"""PyTorch port: it stands apart from JAX and from the JAX package, and it
never carries on silently on the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "lightgbm_tpu_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py", ROOT / "chip_rehearsal.py",
                          ROOT / "chip_guard.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "lightgbm_tpu"), (path, mod)


def test_imports_and_trains_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as L\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.randn(1024, 4).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "b = L.train({'objective': 'binary', 'num_leaves': 7,\n"
        "             'verbosity': -1, 'device_type': 'cpu'},\n"
        "            L.Dataset(X, label=y), num_boost_round=2)\n"
        "assert b.num_trees() == 2\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_cli_linear_refit_and_contrib_run_with_jax_blocked():
    """The command line, the linear fit, refit and TreeSHAP stand apart
    too (their files are among the ones checked above)."""
    for rel in ("cli.py", "__main__.py", "learner/linear.py",
                "native/treeshap.c"):
        assert (PORT / rel).is_file(), rel
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as L\n"
        "import lightgbm_tpu_torch.cli, lightgbm_tpu_torch.learner.linear\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.rand(1024, 4)\n"
        "y = np.where(X[:, 0] > 0.5, 2 * X[:, 1], -X[:, 2])\n"
        "b = L.train({'objective': 'regression', 'num_leaves': 7,\n"
        "             'linear_tree': True, 'verbosity': -1,\n"
        "             'device_type': 'cpu'}, L.Dataset(X, label=y), 2)\n"
        "assert all(t.is_linear for t in b._gbdt.models_)\n"
        "c = b.predict(X[:8], pred_contrib=True)\n"
        "assert c.shape == (8, 5)\n"
        "b.refit(X, y)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_parallel_learners_and_elastic_run_with_jax_blocked():
    """The feature- and voting-parallel learners (their block scan, the
    vote) and the elastic policy stand apart too: a world-1 vote and a
    ColumnBlock merge run with JAX blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import lightgbm_tpu_torch as L\n"
        "from lightgbm_tpu_torch.parallel import VotingSpec, "
        "voting_hist_elect\n"
        "from lightgbm_tpu_torch.learner import FeatureMeta\n"
        "from lightgbm_tpu_torch.ops.split import SplitParams\n"
        "from lightgbm_tpu_torch.reliability import ElasticPolicy, SHRINK\n"
        "from lightgbm_tpu_torch.reliability.supervisor import "
        "SuperviseResult, WorkerFailure\n"
        "class One:\n"
        "    world = 1\n"
        "    def all_reduce_sum_(self, t): return t\n"
        "    def all_reduce_max_(self, t): return t\n"
        "rng = np.random.RandomState(0)\n"
        "rows = torch.from_numpy(rng.randint(0, 8, (1024, 3))"
        ".astype(np.uint8))\n"
        "gh = torch.from_numpy(rng.randn(1024, 2).astype(np.float32))\n"
        "gh[:, 1] = 1.0\n"
        "meta = FeatureMeta(num_bin=torch.full((3,), 8, dtype=torch.int32),"
        " missing_type=torch.zeros(3, dtype=torch.int32),"
        " default_bin=torch.zeros(3, dtype=torch.int32),"
        " penalty=torch.ones(3))\n"
        "h, e = voting_hist_elect(rows, gh, torch.ones(1024),"
        " torch.ones(3, dtype=torch.bool), torch.tensor(0.0), meta,"
        " VotingSpec(One(), 2, 1), SplitParams(min_data_in_leaf=5), 8,"
        " torch.tensor([10, 10], dtype=torch.int32))\n"
        "assert int(e.sum()) == 2 and h.shape == (3, 8, 2)\n"
        "p = ElasticPolicy(3, rank_grace_s=0)\n"
        "d = p.observe(SuperviseResult(ok=False, timed_out=False,"
        " failures=[WorkerFailure(1, 77, '', kind='lost')]))\n"
        "assert d.action == SHRINK and d.num_machines == 2\n"
        "X = rng.rand(1024, 4)\n"
        "y = (X[:, 0] > 0.5).astype(float)\n"
        "for tl in ('feature', 'voting'):\n"
        "    b = L.train({'objective': 'binary', 'num_leaves': 7,"
        " 'verbosity': -1, 'device_type': 'cpu', 'tree_learner': tl},"
        " L.Dataset(X, label=y), 2)\n"
        "    assert b.num_trees() == 2\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_import_needs_no_sklearn_pandas_or_matplotlib():
    """Importing the package pulls in none of them; the estimators and
    plotting helpers import what they use when they are used, and the
    estimators keep their API on `object` bases without scikit-learn."""
    code = (
        "import sys\n"
        "import lightgbm_tpu_torch as L\n"
        "heavy = ('sklearn', 'pandas', 'matplotlib', 'graphviz')\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in heavy], 'imported'\n"
        "for m in heavy:\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "X = np.random.RandomState(0).randn(512, 3).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(int)\n"
        "clf = L.LGBMClassifier(n_estimators=2, num_leaves=7,\n"
        "                       device_type='cpu').fit(X, y)\n"
        "assert L.LGBMClassifier.__mro__[-2] is L.LGBMModel\n"
        "assert clf.get_params()['num_leaves'] == 7\n"
        "assert clf.predict(X).shape == (512,)\n"
        "try:\n"
        "    L.plot_importance(clf)\n"
        "except L.LightGBMError as e:\n"
        "    assert 'matplotlib' in str(e)\n"
        "else:\n"
        "    raise AssertionError('plotting ran without matplotlib')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).randn(512, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlgb.train({"objective": "binary", "verbosity": -1},
                   tlgb.Dataset(X, label=y), num_boost_round=1)


def test_unknown_device_raises():
    X = np.random.RandomState(0).randn(512, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(ValueError, match="device_type"):
        tlgb.train({"objective": "binary", "verbosity": -1,
                    "device_type": "tpu"},
                   tlgb.Dataset(X, label=y), num_boost_round=1)


def _env_without_repo():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied alone into an empty directory, the script cannot find the
    port and fails, even where CUDA is reported present."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "sys.path = [p for p in sys.path if p not in ('', '.')]\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=_env_without_repo())
    assert out.returncode != 0
    assert "lightgbm_tpu_torch" in out.stderr
    assert '"ok"' not in out.stdout


def test_serving_runs_with_jax_blocked():
    """The serving stack, the cost model and tracing stand apart too:
    a daemon on the CPU answers with JAX blocked."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import lightgbm_tpu_torch as L\n"
        "from lightgbm_tpu_torch.config import Config\n"
        "from lightgbm_tpu_torch.serving import ServingDaemon\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.randn(512, 4).astype(np.float32)\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "b = L.train({'objective': 'binary', 'num_leaves': 7,\n"
        "             'verbosity': -1, 'device_type': 'cpu'},\n"
        "            L.Dataset(X, label=y), num_boost_round=2)\n"
        "d = ServingDaemon(Config({'device_type': 'cpu', 'verbosity': -1,\n"
        "    'device_predict_min_bucket': 64,\n"
        "    'serve_max_batch_rows': 64})).start()\n"
        "d.registry.register('m', model_str=b.model_to_string(),\n"
        "                    block=True)\n"
        "assert d.predict('m', X[:3]).shape == (3,)\n"
        "assert d.stats()['roofline']['dispatches'] == 1\n"
        "d.stop()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_online_runs_with_jax_blocked(tmp_path):
    """The online loop stands apart too: with JAX blocked, chunk files
    land, the trainer boosts two generations on the CPU, checkpoints and
    publishes them into a daemon, which serves the newest."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from lightgbm_tpu_torch.config import Config\n"
        "from lightgbm_tpu_torch.online import (DirectoryChunkSource,\n"
        "    LocalPublisher, OnlineTrainer, write_chunk)\n"
        "from lightgbm_tpu_torch.serving import ServingDaemon\n"
        "rng = np.random.RandomState(0)\n"
        "d = sys.argv[1]\n"
        "for g in (1, 2):\n"
        "    X = rng.randn(256, 4)\n"
        "    write_chunk(d + '/chunks', g, X, (X[:, 0] > 0) * 1.0)\n"
        "p = {'objective': 'binary', 'num_leaves': 7, 'verbosity': -1,\n"
        "     'device_type': 'cpu', 'serve_warmup': False,\n"
        "     'online_trees_per_chunk': 2}\n"
        "daemon = ServingDaemon(Config(p)).start()\n"
        "tr = OnlineTrainer(DirectoryChunkSource(d + '/chunks'),\n"
        "                   LocalPublisher(daemon, timeout_s=60), params=p,\n"
        "                   checkpoint_dir=d + '/ck')\n"
        "out = tr.run(max_generations=2)\n"
        "assert out['generation'] == 2 and out['published'] == 2, out\n"
        "assert daemon.registry.versions() == {'online': 2}\n"
        "daemon.stop(drain=True, timeout=60)\n"
        "print('ok')\n")
    (tmp_path / "chunks").mkdir()
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
