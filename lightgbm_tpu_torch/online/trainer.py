"""OnlineTrainer: the closed train->serve loop (PyTorch port of
`lightgbm_tpu/online/trainer.py`; docs/Online.md).  Each generation's
`train()` and refit run on the device of `device_type` (the card unless
the caller asks for the CPU), and so does the local serving daemon.

The reference engine's cheapest production win is that a trained model
is never final: `init_model` continued training and `refit` leaf
re-estimation (ref: gbdt.cpp:252 RefitTree) let CTR/fraud/ranking
deployments chase non-stationary data.  This module wires the
ingredients the repo already holds — byte-exact checkpoint/resume
(reliability/checkpoint.py), continued training, hot-swap serving
(serving/registry.py) and fleet publish (serving/router.py) — into one
loop:

    per chunk generation g (ChunkSource, monotone ids):
      1. TRAIN   — boost `online_trees_per_chunk` new trees via
                   init_model continuation, or refit the existing
                   leaves on the fresh chunk (`online_mode`; auto picks
                   refit when the chunk has fewer rows than the
                   ensemble has trees — too little signal to grow new
                   structure, plenty to re-estimate leaf values);
      2. CHECKPOINT — through the existing CheckpointManager keyed by
                   generation id: a SIGTERM/crash mid-generation
                   resumes from the last completed generation and
                   re-trains the interrupted one BYTE-EXACTLY (each
                   generation is a pure function of (model text, chunk
                   bytes));
      3. PUBLISH — atomically into serving (a local ModelRegistry hot
                   swap, an in-process Router rolling/canary rollout,
                   or `op=publish` over the wire) while the previous
                   generation keeps serving.  A failed publish keeps
                   the old generation serving and retries with backoff
                   (`online_publish_retry_max`) — never a half-
                   published model;
      4. FRESHNESS — one probe request through the serving path proves
                   a model that saw the chunk is answering; the lag
                   (chunk arrival -> probe response) lands on the
                   `model_freshness_lag_s` gauge, the `online_publish`
                   event, and — with `online_max_lag_s` > 0 — the
                   SloTracker burn-rate windows.

Publishers deliberately serialize the model TEXT (or publish the
generation's immutable checkpoint file): the registry builds its own
Booster from the bytes, so the trainer's live booster — which refit
mutates IN PLACE — never aliases trees a serving entry is dispatching
(the mutation-repack hazard, closed structurally here).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import Config
from ..observability import emit_event
from ..observability.registry import global_registry
from ..observability.tracing import SloTracker
from ..utils import log
from .chunks import Chunk, ChunkSource, DirectoryChunkSource


class PublishError(RuntimeError):
    """A publish attempt failed; the previous generation keeps serving."""


class LocalPublisher:
    """Publish into an in-process `ServingDaemon` (or bare
    `ModelRegistry`): a background load + warmup, then the atomic
    one-pointer hot swap — requests in flight finish on the old entry.
    The probe rides the daemon's real submit path (coalescer included)
    so the measured freshness lag is what a client would see."""

    def __init__(self, target, timeout_s: float = 300.0):
        self._daemon = target if hasattr(target, "registry") else None
        self._registry = target.registry if self._daemon else target
        self._timeout_s = float(timeout_s)

    def publish(self, name: str, model_str: str,
                path: Optional[str]) -> int:
        handle = self._registry.register(name, model_str=model_str,
                                         block=True,
                                         timeout=self._timeout_s)
        return int(handle.entry.version)

    def probe(self, name: str, rows: np.ndarray):
        if self._daemon is not None:
            fut = self._daemon.submit(name, rows)
            out = fut.result(timeout=self._timeout_s)
            return np.asarray(out), fut.version
        entry = self._registry.get(name)
        try:
            return (np.asarray(entry.predictor.predict(
                np.asarray(rows, np.float32))), entry.version)
        finally:
            entry.release()


class RouterPublisher:
    """Publish through an in-process fleet `Router`: rolling publish
    replica-by-replica (canary split + auto-rollback when
    `serve_canary_pct` > 0 — a rolled-back canary surfaces as a
    PublishError, so the trainer counts the generation skipped and the
    incumbent keeps serving fleet-wide)."""

    def __init__(self, router, timeout_s: float = 300.0):
        self._router = router
        self._timeout_s = float(timeout_s)

    def publish(self, name: str, model_str: str,
                path: Optional[str]) -> int:
        if not path:
            raise PublishError("router publish needs the generation's "
                               "on-disk model path (set checkpoint_dir)")
        out = self._router.publish(name, path, timeout_s=self._timeout_s)
        if out.get("canary"):
            verdict = self._router.canary_wait(name,
                                               timeout=self._timeout_s)
            if verdict != "promoted":
                raise PublishError(f"canary verdict: {verdict}")
        versions = out.get("replicas") or {}
        return int(max(versions.values())) if versions else 0

    def probe(self, name: str, rows: np.ndarray):
        r = self._router.predict(name, np.asarray(rows).tolist())
        return np.asarray(r.preds), r.version


class WirePublisher:
    """Publish over the line-JSON wire (`op=publish`) to a remote
    router or replica front end — TCP (`host:port`) or a Unix socket
    (`uds_path`).  The probe is one wire predict on the same
    connection."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None,
                 uds_path: Optional[str] = None,
                 timeout_s: float = 300.0):
        from ..serving.frontend import LineClient
        self._conn = LineClient(host, port, uds_path=uds_path)
        self._conn_lock = threading.Lock()
        self._timeout_s = float(timeout_s)

    def publish(self, name: str, model_str: str,
                path: Optional[str]) -> int:
        if not path:
            raise PublishError("wire publish needs the generation's "
                               "on-disk model path (set checkpoint_dir)")
        with self._conn_lock:
            reply = self._conn.request(
                {"op": "publish", "model": name, "path": str(path),
                 "timeout_s": self._timeout_s},
                timeout_s=self._timeout_s)
        if not reply.get("ok"):
            raise PublishError(f"remote publish failed: "
                               f"{reply.get('error')}")
        return int(reply.get("version") or 0)

    def probe(self, name: str, rows: np.ndarray):
        with self._conn_lock:
            reply = self._conn.request(
                {"model": name, "rows": np.asarray(rows).tolist()},
                timeout_s=self._timeout_s)
        if not reply.get("ok"):
            raise PublishError(f"probe failed: {reply.get('error')}")
        return np.asarray(reply["preds"]), reply.get("version")

    def close(self) -> None:
        self._conn.close()


# params the per-generation inner train() must NOT inherit: the online
# loop owns checkpointing/telemetry/serving itself, and the boosting
# round count is online_trees_per_chunk
_TRAIN_PARAM_STRIP = ("task", "data", "valid", "input_model",
                      "output_model", "checkpoint_dir", "checkpoint_freq",
                      "checkpoint_keep", "resume", "metrics_dir",
                      "metrics_port", "num_iterations")


class OnlineTrainer:
    """The streaming trainer (docs/Online.md).  Single consumer loop:
    construct, optionally `install_signal_handlers()`, then `run()` —
    or drive `step()` manually from a test.  `stats()` is thread-safe
    (the bench reads it while the loop runs)."""

    def __init__(self, source: ChunkSource, publisher,
                 params: Optional[Dict[str, Any]] = None,
                 config: Optional[Config] = None,
                 checkpoint_dir: Optional[str] = None,
                 model_name: Optional[str] = None,
                 seed_model=None, on_publish=None):
        self.config = Config(dict(params or {})) if config is None \
            else config
        cfg = self.config
        self.source = source
        self.publisher = publisher
        self.model_name = model_name or cfg.online_model_name
        self.trees_per_chunk = max(int(cfg.online_trees_per_chunk), 1)
        self.poll_interval_s = max(float(cfg.online_poll_interval_s), 0.01)
        self.publish_retry_max = max(int(cfg.online_publish_retry_max), 0)
        self.publish_backoff_s = max(
            float(cfg.online_publish_backoff_ms), 0.0) / 1000.0
        # the full params hash-gate the checkpoint (online_*/serve_* are
        # _HASH_EXCLUDEd); the inner train() gets the stripped subset
        self._params = dict(cfg.raw_params)
        self._train_params = {
            k: v for k, v in self._params.items()
            if k not in _TRAIN_PARAM_STRIP
            and not k.startswith(("online_", "serve_"))}
        self.ckpt_mgr = None
        if checkpoint_dir or cfg.checkpoint_dir:
            from ..reliability import CheckpointManager
            self.ckpt_mgr = CheckpointManager(
                checkpoint_dir or cfg.checkpoint_dir,
                keep_last=cfg.checkpoint_keep, params=self._params)
        self._seed_model = seed_model
        self._on_publish = on_publish
        # freshness SLO: per-generation lag observations feed the
        # multi-window burn tracker; inert when online_max_lag_s == 0
        self.slo = SloTracker(
            p99_ms=float(cfg.online_max_lag_s) * 1000.0,
            error_pct=float(cfg.serve_slo_error_pct),
            fast_window_s=float(cfg.serve_slo_fast_window_s),
            slow_window_s=float(cfg.serve_slo_slow_window_s),
            burn_threshold=float(cfg.serve_slo_burn_threshold))
        self._stop = threading.Event()
        # guards the published-state the loop writes and stats() reads
        # from other threads (a feeder or monitor, CLI status)
        self._lock = threading.Lock()
        self.booster = None
        self.generation = 0
        self._published_version: Optional[int] = None
        self._last_lag_s: Optional[float] = None
        self._published = 0
        self._skipped = 0
        self._started = False
        self._probe_rows: Optional[np.ndarray] = None
        # one entry per published chunk generation: its mode, rows,
        # trees, train seconds and freshness lag (read under _lock)
        self.history: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- control
    def request_stop(self) -> None:
        self._stop.set()

    @property
    def stopped(self) -> bool:
        return self._stop.is_set()

    def install_signal_handlers(self) -> bool:
        """SIGTERM = stop notice: the loop exits at the next boundary;
        a signal landing MID-GENERATION terminates the process after the
        host-I/O flush (exit stays 143) and the next launch resumes from
        the last completed generation's checkpoint, re-training the
        interrupted one byte-exactly."""
        from ..observability import install_sigterm_flush, \
            set_preemption_hook
        ok = install_sigterm_flush()
        if ok:
            set_preemption_hook(self._sigterm)
        return ok

    def _sigterm(self):
        self._stop.set()
        return None  # finish_preemption() flushes and re-delivers

    # -------------------------------------------------------------- startup
    def start(self) -> "OnlineTrainer":
        """Resume (or seed) the model and publish it so serving starts
        from the newest complete generation — a relaunch must never
        regress the served version below its own checkpoint."""
        if self._started:
            return self
        self._started = True
        resumed = None
        if self.ckpt_mgr is not None:
            resumed = self.ckpt_mgr.resumable(self._params)
        if resumed is not None:
            booster = self._load(resumed.model_path)
            with self._lock:
                self.booster = booster
                self.generation = int(resumed.iteration)
            emit_event("online_resume", generation=self.generation,
                       model=resumed.model_path)
            log.info(f"Online trainer resuming at generation "
                     f"{self.generation} ({resumed.model_path})")
            if isinstance(self.source, DirectoryChunkSource):
                self.source.fast_forward(self.generation)
            self._publish_current("resume", resumed.model_path)
        elif self._seed_model is not None:
            booster = (self._seed_model if hasattr(self._seed_model,
                                                   "model_to_string")
                       else self._load(os.fspath(self._seed_model)))
            with self._lock:
                self.booster = booster
            path = (os.fspath(self._seed_model)
                    if not hasattr(self._seed_model, "model_to_string")
                    else None)
            self._publish_current("seed", path)
        return self

    def _load(self, path: str):
        """A Booster read from a model file, on the trainer's device."""
        from ..basic import Booster
        cfg = self.config
        return Booster(model_file=path,
                       params={"device_type": cfg.device_type,
                               "device_predict": cfg.device_predict})

    # ----------------------------------------------------------------- loop
    def run(self, max_generations: Optional[int] = None,
            idle_exit_s: Optional[float] = None) -> Dict[str, Any]:
        """Blocking loop: poll -> train -> checkpoint -> publish until
        stopped (SIGTERM/request_stop), `max_generations` chunks have
        been consumed, or the source has been idle for `idle_exit_s`."""
        cfg = self.config
        if max_generations is None:
            max_generations = int(cfg.online_max_generations) or None
        if idle_exit_s is None:
            idle_exit_s = float(cfg.online_idle_exit_s) or None
        self.start()
        emit_event("online_start", model=self.model_name,
                   mode=cfg.online_mode,
                   trees_per_chunk=self.trees_per_chunk,
                   max_lag_s=cfg.online_max_lag_s or None)
        processed = 0
        last_progress = time.monotonic()
        while not self._stop.is_set():
            if self.step():
                processed += 1
                last_progress = time.monotonic()
                if max_generations and processed >= max_generations:
                    break
                continue
            if idle_exit_s is not None and \
                    time.monotonic() - last_progress > idle_exit_s:
                log.info(f"Online trainer idle for {idle_exit_s:g}s; "
                         "exiting")
                break
            self._stop.wait(self.poll_interval_s)
        out = self.stats()
        emit_event("online_stop", **{k: v for k, v in out.items()
                                     if not isinstance(v, dict)})
        return out

    def step(self) -> bool:
        """Consume at most one chunk; returns True when one was
        processed (published OR skipped), False when the source was
        empty."""
        chunk = self.source.poll()
        if chunk is None:
            return False
        if not chunk.ok:
            self._skip(chunk, chunk.error or "unreadable chunk")
            return True
        mode = self._pick_mode(chunk)
        try:
            t0 = time.monotonic()
            booster = self._train(chunk, mode)
            train_s = time.monotonic() - t0
        except Exception as e:  # noqa: BLE001 - a bad chunk must not kill the loop
            self._skip(chunk, f"train failed: {e}")
            return True
        with self._lock:
            self.booster = booster
            self.generation = chunk.generation
        path = self._checkpoint(chunk.generation)
        self._publish(chunk, mode, path, train_s)
        return True

    # ------------------------------------------------------------ internals
    def _pick_mode(self, chunk: Chunk) -> str:
        if self.booster is None:
            return "boost"  # nothing to refit yet
        mode = self.config.online_mode
        if mode in ("boost", "refit"):
            return mode
        # auto heuristic: a chunk with fewer rows than the ensemble has
        # trees cannot support growing trees_per_chunk fresh trees of
        # structure, but is plenty to re-estimate the existing leaves
        # on the new distribution (the reference's cheap-update path)
        return "refit" if chunk.num_rows < self.booster.num_trees() \
            else "boost"

    def _train(self, chunk: Chunk, mode: str):
        from ..basic import Dataset
        from ..engine import train
        if mode == "refit":
            # in-place leaf re-estimation; bumps the mutation counter so
            # every slice-keyed predictor cache repacks
            self.booster.refit(chunk.X, chunk.y)
            return self.booster
        return train(dict(self._train_params),
                     Dataset(np.asarray(chunk.X, np.float64),
                             label=np.asarray(chunk.y, np.float64)),
                     num_boost_round=self.trees_per_chunk,
                     init_model=self.booster)

    def _checkpoint(self, generation: int) -> Optional[str]:
        if self.ckpt_mgr is None:
            return None
        try:
            ck = self.ckpt_mgr.save(self.booster, generation)
            return ck.model_path
        except OSError as e:
            # a lost checkpoint widens the redo window on the next
            # resume but must not stop the publish — serving freshness
            # is the loop's product, the checkpoint its insurance
            log.warning(f"Online checkpoint at generation {generation} "
                        f"failed: {e}; continuing")
            emit_event("checkpoint_write_failed", iteration=generation,
                       error=str(e))
            return None

    def _skip(self, chunk: Chunk, reason: str) -> None:
        with self._lock:
            self._skipped += 1
        global_registry.inc("online_generations_skipped")
        emit_event("online_chunk_skipped", generation=chunk.generation,
                   reason=str(reason)[:200])
        log.warning(f"Online chunk generation {chunk.generation} "
                    f"skipped: {reason}")
        # a skipped generation is a freshness failure: the fleet keeps
        # serving a model that never saw this chunk
        self.slo.observe(0.0, ok=False)

    def _publish_attempts(self, generation: int, model_str: str,
                          path: Optional[str]) -> Optional[int]:
        """Publish with bounded retry/backoff; None = gave up (the
        previous generation keeps serving)."""
        from ..reliability import faults
        attempt = 0
        while True:
            try:
                if faults.active():
                    faults.maybe_online_publish_fail(generation)
                return self.publisher.publish(self.model_name, model_str,
                                              path)
            except Exception as e:  # noqa: BLE001 - publish failures are retried/reported
                attempt += 1
                global_registry.inc("online_publish_retries")
                emit_event("online_publish_failed", generation=generation,
                           attempt=attempt, error=str(e)[:200])
                log.warning(f"Publish of generation {generation} failed "
                            f"(attempt {attempt}/"
                            f"{self.publish_retry_max + 1}): {e}")
                if attempt > self.publish_retry_max or \
                        self._stop.is_set():
                    return None
                time.sleep(self.publish_backoff_s * (2 ** (attempt - 1)))

    def _probe_freshness(self, version: Optional[int]
                         ) -> Optional[float]:
        """One request through the serving path; returns its monotonic
        completion stamp once a model AT LEAST as new as `version` is
        answering (None: probe failed / version still older)."""
        rows = self._probe_rows
        if rows is None:
            return None
        try:
            _, served = self.publisher.probe(self.model_name, rows)
        except Exception as e:  # noqa: BLE001 - freshness must not kill the loop
            log.warning(f"Freshness probe failed: {e}")
            return None
        if served is not None and version is not None \
                and int(served) < int(version):
            return None  # raced an older entry; lag unknown this round
        return time.monotonic()

    def _publish(self, chunk: Chunk, mode: str, path: Optional[str],
                 train_s: float) -> None:
        model_str = self.booster.model_to_string(num_iteration=-1)
        if self._probe_rows is None:
            # fixed probe rows (first row of the first chunk): constant
            # width, constant bucket — the probe never retraces
            self._probe_rows = np.ascontiguousarray(
                np.asarray(chunk.X[:1], np.float32))
        version = self._publish_attempts(chunk.generation, model_str, path)
        if version is None:
            self._skip(chunk, "publish failed after "
                              f"{self.publish_retry_max + 1} attempt(s)")
            return
        t_served = self._probe_freshness(version)
        lag_s = (t_served - chunk.t_arrival) if t_served is not None \
            else None
        with self._lock:
            self._published += 1
            self._published_version = version
            self._last_lag_s = lag_s
            self.history.append({
                "generation": chunk.generation, "version": version,
                "mode": mode, "rows": chunk.num_rows,
                "trees": self.booster.num_trees(), "train_s": train_s,
                "freshness_lag_s": lag_s})
        global_registry.inc("online_generations_published")
        global_registry.set_gauge("online_generation", chunk.generation)
        if lag_s is not None:
            global_registry.set_gauge("model_freshness_lag_s",
                                      round(lag_s, 6))
            self.slo.observe(lag_s * 1000.0, ok=True)
        emit_event("online_publish", generation=chunk.generation,
                   version=version, mode=mode, rows=chunk.num_rows,
                   trees=self.booster.num_trees(),
                   train_s=round(train_s, 3),
                   freshness_lag_s=(round(lag_s, 6)
                                    if lag_s is not None else None))
        if self._on_publish is not None:
            self._on_publish(chunk.generation, version, model_str)
        log.info(f"Online generation {chunk.generation} published as "
                 f"{self.model_name!r} v{version} ({mode}, "
                 f"{chunk.num_rows} rows"
                 + (f", lag {lag_s * 1000.0:.0f} ms" if lag_s is not None
                    else "") + ")")

    def _publish_current(self, reason: str,
                         path: Optional[str]) -> None:
        """Publish the resumed/seeded model before consuming chunks, so
        a relaunch serves its newest checkpoint immediately.  The
        on-disk checkpoint text is published VERBATIM when there is one:
        a load/serialize round trip can normalize the embedded
        parameters block, and the resumed publish must be byte-identical
        to what the pre-kill process published."""
        model_str = None
        if path is not None:
            try:
                with open(path) as f:
                    model_str = f.read()
            except OSError:
                model_str = None
        if model_str is None:
            model_str = self.booster.model_to_string(num_iteration=-1)
        version = self._publish_attempts(self.generation, model_str, path)
        if version is None:
            log.warning(f"Initial ({reason}) publish failed; serving "
                        "keeps whatever it already holds")
            return
        with self._lock:
            self._published_version = version
        emit_event("online_publish", generation=self.generation,
                   version=version, mode=reason,
                   rows=0, trees=self.booster.num_trees(),
                   train_s=0.0, freshness_lag_s=None)
        if self._on_publish is not None:
            self._on_publish(self.generation, version, model_str)

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "model": self.model_name,
                "generation": self.generation,
                "published": self._published,
                "skipped": self._skipped,
                "version": self._published_version,
                "freshness_lag_s": self._last_lag_s,
            }
        out["generations_published"] = int(
            global_registry.counter("online_generations_published"))
        out["generations_skipped"] = int(
            global_registry.counter("online_generations_skipped"))
        if self.slo.enabled:
            out["slo"] = self.slo.stats()
        return out
