"""PyTorch port: the online continual-learning loop on the CPU, against
the JAX package's (`lightgbm_tpu/online/`, tests/test_online.py).

* Chunk sources: monotone generations, partial and hidden files ignored,
  npz/csv/npy chunks with the label in the first column, a torn chunk
  surfaced as `chunk.error`; chunk files written by either package read
  the same in the other.
* The boost loop: from one seed model and the same chunks, each
  generation's new trees equal the JAX loop's (split features,
  thresholds, decision types, children and leaf counts exactly, leaf
  values within 1e-5: float32 sums in another order), raw scores within
  1e-5 per tree, on both engines (`tpu_growth_strategy` pinned in both
  packages).  `online_mode=auto` picks refit and boost where the JAX
  loop does, and the refit leaf values are within the same 1e-5.
* Failure semantics (port): a failed publish retries and lands, an
  exhausted publish keeps the old generation serving, a corrupt chunk
  is skipped, a stop after generation 2 resumes byte for byte, and
  skipped generations burn the freshness SLO.
* A JAX online checkpoint directory resumes in the port at its
  generation, and the next generation's trees equal the JAX loop's.
* Publishers: `RouterPublisher` over a real CPU fleet of two replicas,
  `WirePublisher` over the UDS front end, each generation served byte
  for byte as `Booster.predict` of its model text.

Every wait has its own deadline (`timeout=` on futures, joins and
subprocesses), so a hang fails one test and not the suite.
"""

import os

import numpy as np
import pytest
import torch

# the suite runs several test processes at once: keep each one's torch
# on one thread so they do not oversubscribe the cores
torch.set_num_threads(1)

import lightgbm_tpu as jlgb
import lightgbm_tpu.online as jonline
from lightgbm_tpu.observability.registry import \
    global_registry as jregistry
from lightgbm_tpu.reliability import faults as jfaults
import lightgbm_tpu_torch as tlgb
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.observability.registry import global_registry
from lightgbm_tpu_torch.online import (DirectoryChunkSource, LocalPublisher,
                                       MemoryChunkSource, OnlineTrainer,
                                       RouterPublisher, WirePublisher,
                                       write_chunk)
from lightgbm_tpu_torch.reliability import faults
from lightgbm_tpu_torch.serving import (ModelRegistry, ReplicaFleet, Router,
                                        ServingDaemon, serve_counters_reset,
                                        start_uds_frontend)

from test_torch_continue import _same_trees

CPU = {"device_type": "cpu"}
# the JAX suite's parameters, with the CPU named in both packages (so
# the checkpoint's params hash agrees across them)
PARAMS = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
          "min_data_in_leaf": 5, "device_predict": "true",
          "device_predict_min_bucket": 32, "serve_warmup": False,
          "online_trees_per_chunk": 2, "online_publish_backoff_ms": 1.0,
          "tpu_growth_strategy": "leafwise", "tpu_donate_buffers": False,
          **CPU}
COUNTERS = ("online_generations_published", "online_generations_skipped",
            "online_publish_retries")
WAIT_S = 60.0   # every future, join and load in this file


def _mk(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _registry():
    return ModelRegistry(min_bucket=32, warmup_rows=64, warmup=False,
                         device_type="cpu")


def _oracle(text):
    """The byte-identity oracle: Booster.predict of the model text on the
    serving path's traversal."""
    return tlgb.Booster(model_str=text, params={"device_type": "cpu",
                                                "device_predict": "true"})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for reg in (global_registry, jregistry):
        for key in COUNTERS:
            reg.inc(key, -reg.counter(key))
    monkeypatch.delenv("LGBM_TPU_FAULT", raising=False)
    faults.reload()
    jfaults.reload()
    yield
    monkeypatch.delenv("LGBM_TPU_FAULT", raising=False)
    faults.reload()
    jfaults.reload()


class _Recorder:
    """A publisher that keeps each published model text (the JAX side of
    the parity cases, which needs no serving)."""

    def __init__(self):
        self.texts = []

    def publish(self, name, model_str, path):
        self.texts.append(model_str)
        return len(self.texts)

    def probe(self, name, rows):
        return None, len(self.texts)


# ---------------------------------------------------------------- sources
def test_memory_source_monotone_generations():
    src = MemoryChunkSource()
    X, y = _mk(10)
    assert src.poll() is None
    assert src.push(X, y) == 1
    assert src.push(X, y) == 2
    c1, c2 = src.poll(), src.poll()
    assert (c1.generation, c2.generation) == (1, 2)
    assert c1.ok and c1.num_rows == 10
    assert src.poll() is None
    with pytest.raises(ValueError):
        src.push(X[:0], y[:0])


@pytest.mark.parametrize("writer,reader", [
    ("jax", "port"), ("port", "jax"), ("port", "port")])
def test_directory_source_orders_and_ignores_partials(tmp_path, writer,
                                                      reader):
    """Chunks landed out of order beside a temp file, a dotfile and a
    stray name, by one package's `write_chunk`, read by the other's
    watcher in generation order, the arrays bit for bit."""
    wmod = jonline if writer == "jax" else tlgb.online
    rmod = jonline if reader == "jax" else tlgb.online
    d = str(tmp_path)
    X, y = _mk(8)
    wmod.write_chunk(d, 2, X, y)
    wmod.write_chunk(d, 1, X, y)
    (tmp_path / "chunk-0000003.npz.12345.tmp").write_bytes(b"partial")
    (tmp_path / ".chunk-0000004.npz").write_bytes(b"hidden")
    (tmp_path / "notes.txt").write_text("ignored")
    src = rmod.DirectoryChunkSource(d)
    c = src.poll()
    assert c.generation == 1 and c.ok
    assert np.array_equal(c.X, X) and np.array_equal(c.y, y)
    assert c.X.dtype == X.dtype
    assert src.poll().generation == 2
    assert src.poll() is None
    # a resumed cursor never re-reads consumed generations
    src2 = rmod.DirectoryChunkSource(d, start_generation=2)
    assert src2.poll().generation == 2
    assert src2.poll() is None
    src3 = rmod.DirectoryChunkSource(d)
    src3.fast_forward(1)
    assert src3.poll().generation == 2


def test_directory_source_csv_and_npy_label_first_column(tmp_path):
    """csv and npy chunks (label first) read alike in both packages."""
    X, y = _mk(6)
    mat = np.column_stack([y, X]).astype(np.float64)
    np.savetxt(tmp_path / "chunk-0000001.csv", mat, delimiter=",")
    np.save(tmp_path / "chunk-0000002.npy", mat)
    src = DirectoryChunkSource(str(tmp_path))
    jsrc = jonline.DirectoryChunkSource(str(tmp_path))
    for gen in (1, 2):
        c, jc = src.poll(), jsrc.poll()
        assert c.generation == jc.generation == gen and c.ok
        assert np.allclose(c.X, X) and np.allclose(c.y, y)
        assert np.array_equal(c.X, jc.X) and np.array_equal(c.y, jc.y)


def test_directory_source_torn_chunk_surfaces_error(tmp_path):
    (tmp_path / "chunk-0000001.npz").write_bytes(b"not an npz at all")
    mat = np.ones((3, 1))                     # a label and no feature
    np.save(tmp_path / "chunk-0000002.npy", mat)
    src = DirectoryChunkSource(str(tmp_path))
    c = src.poll()
    assert c.generation == 1 and not c.ok and c.error
    assert c.num_rows == 0
    c = src.poll()
    assert c.generation == 2 and not c.ok and "label column" in c.error
    assert src.poll() is None  # monotone: the damaged gens are consumed


# ------------------------------------------------------ the loop vs JAX
def _seed(tmp_path, params):
    """The JAX package's seed model (2 trees on chunk 0) as a file."""
    X0, y0 = _mk(300, 0)
    sp = {k: v for k, v in params.items()
          if not k.startswith(("online_", "serve_"))}
    path = str(tmp_path / "seed.txt")
    jlgb.train(sp, jlgb.Dataset(X0, label=y0), 2).save_model(path)
    return path


def _jax_loop(tmp_path, params, chunks, seed_path, tag="jax"):
    """The JAX loop over `chunks` from the seed: its boosters' models
    after each generation, the modes it picked and its checkpoint dir."""
    src = jonline.MemoryChunkSource()
    ck = str(tmp_path / f"ck_{tag}")
    tr = jonline.OnlineTrainer(src, _Recorder(), params=dict(params),
                               checkpoint_dir=ck, seed_model=seed_path)
    tr.start()
    models, modes = [], []
    for X, y in chunks:
        src.push(X, y)
        modes.append(tr._pick_mode(src._queue[0]))
        assert tr.step()
        tr.booster._gbdt._sync_model()
        models.append(tlgb.Booster(
            model_str=tr.booster.model_to_string(),
            params=CPU)._gbdt.models_)
    return models, modes, ck


@pytest.mark.parametrize("strategy", ["leafwise", "wave"])
def test_boost_loop_matches_jax(tmp_path, strategy):
    """Three boost generations from one seed model: the port's trees equal
    the JAX loop's generation by generation, each published generation
    is its checkpoint byte for byte and serves `Booster.predict` of it
    exactly."""
    params = {**PARAMS, "online_mode": "boost",
              "tpu_growth_strategy": strategy}
    seed = _seed(tmp_path, params)
    chunks = [_mk(300, g) for g in (1, 2, 3)]
    want, _, _ = _jax_loop(tmp_path, params, chunks, seed)
    reg = _registry()
    src = MemoryChunkSource()
    seen = []
    tr = OnlineTrainer(src, LocalPublisher(reg, timeout_s=WAIT_S),
                       params=dict(params),
                       checkpoint_dir=str(tmp_path / "ck"),
                       seed_model=seed,
                       on_publish=lambda g, v, s: seen.append((g, v, s)))
    tr.start()
    assert reg.versions() == {"online": 1}          # the seed, published
    for g, (X, y) in enumerate(chunks, 1):
        src.push(X, y)
        assert tr.step()
        got = tr.booster._gbdt.models_
        assert tr.booster._gbdt.growth_strategy == strategy
        _same_trees(want[g - 1], got, f"generation {g}")
        jb = jlgb.Booster(model_str=tr.booster.model_to_string())
        np.testing.assert_allclose(
            tr.booster.predict(X, raw_score=True),
            jb.predict(X, raw_score=True), rtol=0,
            atol=1e-5 * len(got))
    assert not tr.step()
    assert reg.versions() == {"online": 4}
    assert [(g, v) for g, v, _ in seen] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    for gen, _v, text in seen[1:]:
        assert (tmp_path / "ck" / f"ckpt_{gen:07d}.txt").read_text() == text
    Xq = _mk(40, 9)[0]
    entry = reg.get("online")
    try:
        got = np.asarray(entry.predictor.predict(Xq))
    finally:
        entry.release()
    assert got.tobytes() == _oracle(seen[-1][2]).predict(Xq).tobytes()
    stats = tr.stats()
    assert stats["generations_published"] == 3 and stats["generation"] == 3
    assert stats["freshness_lag_s"] is not None \
        and stats["freshness_lag_s"] > 0
    assert global_registry.gauge("model_freshness_lag_s") is not None
    assert [h["trees"] for h in tr.history] == [4, 6, 8]
    assert all(h["mode"] == "boost" and h["train_s"] > 0
               for h in tr.history)


def test_auto_mode_refits_small_chunks_boosts_large(tmp_path):
    """auto: boost on 300 rows, refit in place on 3 (fewer rows than
    trees), as the JAX loop picks; the refit keeps the structure and its
    leaf values are within 1e-5 of the JAX refit's."""
    params = {**PARAMS, "online_mode": "auto"}
    seed = _seed(tmp_path, params)
    chunks = [_mk(300, 1), _mk(300, 2), _mk(3, 3)]
    want, jmodes, _ = _jax_loop(tmp_path, params, chunks, seed)
    assert jmodes == ["boost", "boost", "refit"]
    reg = _registry()
    src = MemoryChunkSource()
    tr = OnlineTrainer(src, LocalPublisher(reg, timeout_s=WAIT_S),
                       params=dict(params),
                       checkpoint_dir=str(tmp_path / "ck"), seed_model=seed)
    tr.start()
    modes = []
    for g, (X, y) in enumerate(chunks, 1):
        src.push(X, y)
        modes.append(tr._pick_mode(src._queue[0]))
        before = tr.booster.model_to_string()
        assert tr.step()
        _same_trees(want[g - 1], tr.booster._gbdt.models_,
                    f"generation {g}")
    assert modes == jmodes
    assert tr.booster.num_trees() == 6                  # no new trees
    assert tr.booster.model_to_string() != before       # leaves moved
    assert reg.versions()["online"] == 4


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The JAX loop's checkpoint directory after generation 2: the port's
    trainer resumes at generation 2, publishes the JAX checkpoint text
    verbatim, and its generation 3 equals the JAX loop's."""
    params = {**PARAMS, "online_mode": "boost"}
    seed = _seed(tmp_path, params)
    chunks = [_mk(250, 10 + g) for g in (1, 2, 3)]
    want, _, _ = _jax_loop(tmp_path, params, chunks, seed, tag="full")
    _, _, ck = _jax_loop(tmp_path, params, chunks[:2], seed, tag="cut")
    d = tmp_path / "chunks"
    d.mkdir()
    for g, (X, y) in enumerate(chunks, 1):
        write_chunk(str(d), g, X, y)
    reg = _registry()
    published = []
    tr = OnlineTrainer(DirectoryChunkSource(str(d)),
                       LocalPublisher(reg, timeout_s=WAIT_S),
                       params=dict(params), checkpoint_dir=ck,
                       on_publish=lambda g, v, s: published.append((g, s)))
    tr.start()
    assert tr.generation == 2
    assert published[0] == (2, open(os.path.join(
        ck, "ckpt_0000002.txt")).read())
    assert tr.step() and not tr.step()               # generation 3 only
    assert tr.generation == 3
    _same_trees(want[2], tr.booster._gbdt.models_, "generation 3")


# ------------------------------------------------------ failure semantics
def test_publish_fail_fault_retries_and_lands(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "online_publish_fail@1")
    faults.reload()
    reg = _registry()
    src = MemoryChunkSource()
    tr = OnlineTrainer(src, LocalPublisher(reg, timeout_s=WAIT_S),
                       params=dict(PARAMS), checkpoint_dir=str(tmp_path))
    src.push(*_mk(200, 1))
    tr.start()
    assert tr.step()
    # the first attempt raised (injected), the retry published: never a
    # half-published model, never a lost generation
    assert reg.versions() == {"online": 1}
    assert global_registry.counter("online_publish_retries") == 1
    assert global_registry.counter("online_generations_published") == 1
    assert global_registry.counter("online_generations_skipped") == 0


class _AlwaysFailPublisher:
    def publish(self, name, model_str, path):
        raise RuntimeError("publish target down")

    def probe(self, name, rows):
        raise RuntimeError("unreachable")


def test_publish_exhausted_skips_and_keeps_old_generation(tmp_path):
    reg = _registry()
    src = MemoryChunkSource()
    good = OnlineTrainer(src, LocalPublisher(reg, timeout_s=WAIT_S),
                         params=dict(PARAMS),
                         checkpoint_dir=str(tmp_path / "a"))
    src.push(*_mk(200, 1))
    good.start()
    assert good.step()
    assert reg.versions() == {"online": 1}
    # a second trainer whose publisher is down: the generation is counted
    # skipped after the bounded retries, and the registry still serves
    # the old version untouched
    src2 = MemoryChunkSource()
    bad = OnlineTrainer(src2, _AlwaysFailPublisher(),
                        params={**PARAMS, "online_publish_retry_max": 1},
                        checkpoint_dir=str(tmp_path / "b"))
    src2.push(*_mk(200, 2))
    bad.start()
    assert bad.step()
    assert reg.versions() == {"online": 1}
    assert global_registry.counter("online_generations_skipped") == 1
    assert global_registry.counter("online_publish_retries") == 2
    assert bad.history == []


def test_chunk_corrupt_fault_skips_generation(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "online_chunk_corrupt@2")
    faults.reload()
    d = tmp_path / "chunks"
    d.mkdir()
    for g in (1, 2, 3):
        write_chunk(str(d), g, *_mk(200, g))
    reg = _registry()
    tr = OnlineTrainer(DirectoryChunkSource(str(d)),
                       LocalPublisher(reg, timeout_s=WAIT_S),
                       params=dict(PARAMS),
                       checkpoint_dir=str(tmp_path / "ck"))
    tr.start()
    assert tr.step()                        # gen 1 publishes (v1)
    assert tr.step()                        # gen 2 corrupt -> skipped
    assert reg.versions() == {"online": 1}  # the old generation serves
    assert global_registry.counter("online_generations_skipped") == 1
    assert tr.step()                        # gen 3 publishes (v2)
    assert reg.versions() == {"online": 2}
    assert tr.stats()["generation"] == 3
    # an in-memory chunk is poisoned instead
    monkeypatch.setenv("LGBM_TPU_FAULT", "online_chunk_corrupt@1")
    faults.reload()
    src = MemoryChunkSource()
    src.push(*_mk(20, 4))
    c = src.poll()
    assert not c.ok and c.X is None


def test_resume_from_checkpoint_is_byte_exact(tmp_path):
    """A trainer stopped after generation 2 and relaunched publishes its
    checkpoint first (no served-version regression) and re-trains
    generation 3 into exactly the bytes of the uninterrupted run."""
    d = tmp_path / "chunks"
    d.mkdir()
    for g in (1, 2, 3):
        write_chunk(str(d), g, *_mk(250, 10 + g))
    reg_a = _registry()
    tr_a = OnlineTrainer(DirectoryChunkSource(str(d)),
                         LocalPublisher(reg_a, timeout_s=WAIT_S),
                         params=dict(PARAMS),
                         checkpoint_dir=str(tmp_path / "ck_a"))
    tr_a.start()
    assert tr_a.step() and tr_a.step() and tr_a.step()
    final_a = tr_a.booster.model_to_string()
    gen2_a = (tmp_path / "ck_a" / "ckpt_0000002.txt").read_text()
    tr_b = OnlineTrainer(DirectoryChunkSource(str(d)),
                         LocalPublisher(_registry(), timeout_s=WAIT_S),
                         params=dict(PARAMS),
                         checkpoint_dir=str(tmp_path / "ck_b"))
    tr_b.start()
    assert tr_b.step() and tr_b.step()
    reg_c = _registry()
    published = []
    tr_c = OnlineTrainer(DirectoryChunkSource(str(d)),
                         LocalPublisher(reg_c, timeout_s=WAIT_S),
                         params=dict(PARAMS),
                         checkpoint_dir=str(tmp_path / "ck_b"),
                         on_publish=lambda g, v, s:
                         published.append((g, v, s)))
    tr_c.start()
    assert tr_c.generation == 2
    assert published and published[0][0] == 2
    assert published[0][2] == gen2_a
    assert reg_c.versions() == {"online": 1}
    assert tr_c.step()
    assert not tr_c.step()      # generations 1-2 never re-consumed
    assert tr_c.generation == 3
    assert tr_c.booster.model_to_string() == final_a
    assert (tmp_path / "ck_b" / "ckpt_0000003.txt").read_text() == final_a


def test_freshness_slo_feeds_burn_tracker(tmp_path):
    """online_max_lag_s wires each generation's lag into the SloTracker:
    skipped generations count against the error budget."""
    src = MemoryChunkSource()
    tr = OnlineTrainer(src, _AlwaysFailPublisher(),
                       params={**PARAMS, "online_max_lag_s": 5.0,
                               "online_publish_retry_max": 0,
                               "serve_slo_fast_window_s": 1.0,
                               "serve_slo_slow_window_s": 2.0},
                       checkpoint_dir=str(tmp_path))
    assert tr.slo.enabled
    for g in range(1, 4):
        src.push(*_mk(120, g))
        tr.start()
        assert tr.step()
    assert tr.slo.evaluate() is True
    assert global_registry.gauge("fleet_slo_burning") == 1.0


def test_run_stops_at_max_generations_and_on_idle(tmp_path):
    src = MemoryChunkSource()
    tr = OnlineTrainer(src, LocalPublisher(_registry(), timeout_s=WAIT_S),
                       params={**PARAMS, "online_poll_interval_s": 0.01},
                       checkpoint_dir=str(tmp_path))
    for g in (1, 2, 3):
        src.push(*_mk(120, g))
    out = tr.run(max_generations=2)
    assert out["generation"] == 2 and src.pending == 1
    out = tr.run(idle_exit_s=0.05)
    assert out["generation"] == 3 and out["published"] == 3


# ------------------------------------------------------------ publishers
def test_router_publisher_on_a_cpu_fleet(tmp_path):
    """Two real CPU replicas serving the seed model behind the router:
    each generation rolls out replica by replica from its checkpoint
    file, and the router then serves `Booster.predict` of that text."""
    X0, y0 = _mk(300, 0)
    seed = str(tmp_path / "seed.txt")
    tlgb.train({**PARAMS, "num_leaves": 7}, tlgb.Dataset(X0, label=y0),
               2).save_model(seed)
    serve_counters_reset()
    fleet = ReplicaFleet(
        2, [("online", seed)], str(tmp_path / "fleet"),
        params={"device_predict_min_bucket": 32,
                "serve_max_batch_rows": 256, "verbosity": -1},
        max_restarts=0, health_interval_s=0.2, force_cpu=True).start()
    try:
        assert fleet.wait_ready(timeout=120), fleet.describe()
        router = Router(fleet, Config({"serve_retry_max": 2,
                                       "serve_request_timeout_s": WAIT_S}))
        src = MemoryChunkSource()
        seen = []
        tr = OnlineTrainer(src, RouterPublisher(router, timeout_s=WAIT_S),
                           params=dict(PARAMS),
                           checkpoint_dir=str(tmp_path / "ck"),
                           seed_model=seed,
                           on_publish=lambda g, v, s: seen.append((g, v, s)))
        tr.start()
        for g in (1, 2):
            src.push(*_mk(200, g))
            assert tr.step()
        assert [g for g, _, _ in seen] == [0, 1, 2]
        assert global_registry.counter("online_generations_published") == 2
        Xq = _mk(16, 9)[0]
        r = router.predict("online", Xq, deadline_ms=WAIT_S * 1000)
        want = _oracle(seen[-1][2]).predict(Xq)
        assert np.asarray(r.preds).astype(np.float32).tobytes() == \
            want.astype(np.float32).tobytes()
        assert tr.stats()["freshness_lag_s"] is not None
    finally:
        rcs = fleet.stop(drain=True, timeout=WAIT_S)
    assert all(rc in (143, -15) for rc in rcs.values()), rcs


def test_wire_publisher_over_uds(tmp_path):
    """`op=publish` of each generation's checkpoint over a Unix socket
    to a CPU daemon; the wire probe reads the new version, and the
    daemon serves `Booster.predict` of its text."""
    uds = str(tmp_path / "serve.sock")
    daemon = ServingDaemon(Config({**CPU, "device_predict_min_bucket": 32,
                                   "serve_warmup": False,
                                   "verbosity": -1})).start()
    srv = start_uds_frontend(daemon, uds, request_timeout_s=WAIT_S)
    pub = WirePublisher(uds_path=uds, timeout_s=WAIT_S)
    try:
        src = MemoryChunkSource()
        seen = []
        tr = OnlineTrainer(src, pub, params=dict(PARAMS),
                           checkpoint_dir=str(tmp_path / "ck"),
                           on_publish=lambda g, v, s: seen.append((g, v, s)))
        tr.start()
        for g in (1, 2):
            src.push(*_mk(200, g))
            assert tr.step()
        assert [(g, v) for g, v, _ in seen] == [(1, 1), (2, 2)]
        assert tr.stats()["version"] == 2
        Xq = _mk(16, 9)[0]
        got = np.asarray(daemon.submit("online", Xq).result(timeout=WAIT_S))
        assert got.tobytes() == _oracle(seen[-1][2]).predict(Xq).tobytes()
    finally:
        pub.close()
        srv.shutdown()
        daemon.stop(drain=True, timeout=WAIT_S)
