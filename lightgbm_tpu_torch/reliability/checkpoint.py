"""Checkpoint/resume for boosting runs (PyTorch port of
`lightgbm_tpu/reliability/checkpoint.py`: the same layout, manifest and
npz keys, so each package resumes the other's checkpoints).

Layout of a checkpoint directory:

    ckpt_0000012.txt   -- full model text at iteration 12 (the standard
                          LightGBM v4 format: a checkpoint IS a model)
    ckpt_0000012.npz   -- exact trainer state: float32 score buffer and
                          bagging/feature RNG streams, so a resumed run
                          reproduces the uninterrupted run byte-for-byte
                          (predict-based reseeding differs in ulps)
    manifest.json      -- {"iteration", "model", "state", "params_hash"}

Every write is atomic (temp file + os.replace) and the manifest is
written last, so a crash mid-checkpoint leaves the previous checkpoint
fully intact.  Rotation keeps the newest `keep_last` checkpoints.

Integrity: the manifest
records a SHA-256 digest per artifact for every retained generation
(`"generations"`, format 2).  Resume verifies the newest generation's
digests before trusting it; a torn or bit-flipped checkpoint is
QUARANTINED (artifacts renamed `*.corrupt-<ts>`, generation dropped
from the manifest) and resume falls back to the previous rotation
generation with a structured `ckpt_fallback` event — instead of
crashing on a half-written npz or, worse, silently training from a
corrupt score buffer.  Format-1 manifests (no digests) stay loadable.

Resume semantics vs `init_model`: `init_model` adopts a model's trees
and re-seeds scores from its predictions (good enough for continued
training on *new* data); a checkpoint resume additionally restores the
exact score buffer and RNG state of the interrupted run, so training
continues as if never interrupted.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import threading
import time
import zipfile
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import atomic_write_bytes, atomic_write_text, log
from . import faults

MANIFEST = "manifest.json"
_FORMAT = 2

# knobs that do not affect the trained model: a checkpoint taken with a
# different output path, verbosity, telemetry or serving configuration
# is still resumable
_HASH_EXCLUDE = frozenset((
    "verbosity", "verbose", "output_model", "input_model", "output_result",
    "data", "valid", "snapshot_freq", "checkpoint_dir", "checkpoint_freq",
    "checkpoint_keep", "resume", "max_retries", "retry_backoff",
    "nonfinite_check_freq", "machines", "machine_list_filename",
    "local_listen_port", "num_machines", "time_out",
    "metrics_dir", "metrics_rotate_mb", "profile_dir",
    "async_host_io", "compile_cache_dir", "device_eval",
    "device_predict", "device_predict_min_bucket",
    # serving-daemon knobs: pure inference-side
    # configuration, model-neutral by construction
    "serve_models", "serve_max_coalesce_wait_ms", "serve_queue_depth",
    "serve_max_batch_rows", "serve_warmup", "serve_port",
    "serve_drain_timeout_s",
    # serving-fleet knobs: router /
    # replica / canary topology, likewise model-neutral
    "serve_request_timeout_s", "serve_replicas",
    "serve_max_replica_restarts", "serve_health_interval_s",
    "serve_retry_max", "serve_retry_backoff_ms", "serve_canary_pct",
    "serve_canary_min_samples", "serve_canary_max_divergence",
    "serve_canary_max_error_rate", "serve_ready_file",
    # fleet SLO / tracing knobs: telemetry only
    "serve_slo_p99_ms", "serve_slo_error_pct", "serve_slo_fast_window_s",
    "serve_slo_slow_window_s", "serve_slo_burn_threshold",
    "serve_trace_sample", "serve_adaptive_coalesce", "serve_uds_path",
    # online continual-learning loop knobs: the chunk
    # cadence, publish topology and freshness SLO never change what a
    # given (model text, chunk bytes) pair trains into — a checkpoint
    # must resume across any of them (the SIGTERM drill relaunches with
    # a different online_idle_exit_s, for one)
    "online_chunk_dir", "online_mode", "online_trees_per_chunk",
    "online_poll_interval_s", "online_model_name", "online_max_lag_s",
    "online_publish_retry_max", "online_publish_backoff_ms",
    "online_publish_addr", "online_max_generations", "online_idle_exit_s",
    # the degradation ladder (reliability/guard.py) flips these between
    # attempts; all are model-neutral perf/telemetry knobs, and a
    # degraded relaunch MUST still resume the interrupted checkpoint
    "tpu_donate_buffers", "auto_degrade", "stall_floor_s", "stall_factor",
    # elastic recovery knobs: a shrunken or
    # preempted relaunch must still resume the interrupted checkpoint
    "preempt_ckpt_grace_s", "elastic_rank_grace_s", "elastic_min_machines",
))


def hash_params(params: Dict[str, Any]) -> str:
    """Canonical hash of the training-relevant parameters: a checkpoint
    is only resumed into a run with the same boosting configuration."""
    from ..config import Config
    changed = Config(dict(params or {})).changed_params()
    key = {k: v for k, v in sorted(changed.items()) if k not in _HASH_EXCLUDE}
    blob = json.dumps(key, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _sha256_file(path: str) -> Optional[str]:
    """Streaming SHA-256 of a file, None when unreadable."""
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


@dataclass
class Checkpoint:
    iteration: int
    model_path: str
    state_path: Optional[str]
    params_hash: Optional[str]
    # per-artifact SHA-256 digests keyed by basename (format-2
    # manifests); None for legacy checkpoints, which skip verification
    digests: Optional[Dict[str, str]] = None
    num_rows: Optional[int] = None

    def verify(self) -> Tuple[bool, str]:
        """Recompute artifact digests against the manifest's record.
        Legacy checkpoints (no digests) pass vacuously — lenient, like
        the manifest handling everywhere else in this module."""
        if not self.digests:
            return True, "no digests recorded (legacy checkpoint)"
        for path in (self.model_path, self.state_path):
            if not path:
                continue
            want = self.digests.get(os.path.basename(path))
            if want is None:
                continue
            have = _sha256_file(path)
            if have is None:
                return False, f"{os.path.basename(path)}: unreadable"
            if have != want:
                return False, (f"{os.path.basename(path)}: digest mismatch "
                               f"(manifest {want[:12]}…, disk {have[:12]}…)")
        return True, "ok"

    def load_state(self) -> Optional[Dict[str, np.ndarray]]:
        if not self.state_path or not os.path.exists(self.state_path):
            return None
        try:
            with np.load(self.state_path, allow_pickle=True) as z:
                return {k: z[k] for k in z.files}
        except (OSError, ValueError) as e:
            log.warning(f"Unreadable checkpoint state {self.state_path}: "
                        f"{e}; resuming from model text only")
            return None


def _state_bytes(state: Dict[str, Any]) -> bytes:
    """Deterministic npz: np.savez stamps each zip member with the
    current wall clock (2 s DOS resolution), so two runs writing the
    SAME state produce different bytes — which breaks the async-vs-sync
    byte-exactness contract (tests/test_async_io.py).  Write the same
    .npy-in-zip layout with a fixed epoch timestamp instead; np.load
    reads it unchanged."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as zf:
        for key, value in state.items():
            member = io.BytesIO()
            np.lib.format.write_array(member, np.asarray(value),
                                      allow_pickle=True)
            info = zipfile.ZipInfo(key + ".npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            zf.writestr(info, member.getvalue())
    return buf.getvalue()


class CheckpointManager:
    """Atomic, rotated checkpoints of a training run.

    With `writer` (observability.hostio.AsyncWriter) the serialization
    and file I/O run off the training thread: the training thread only
    captures the state — the model text plus a score snapshot whose
    copy into pinned host memory is enqueued on the current stream with
    a CUDA event behind it — and the worker waits on the event, packs
    and atomically renames.  Failure
    accounting flows through `on_done` in both modes, so a failed async
    write still warns/counts and never kills training."""

    def __init__(self, directory: str, keep_last: int = 3,
                 params: Optional[Dict[str, Any]] = None, writer=None):
        self.dir = os.fspath(directory)
        self.keep_last = max(int(keep_last), 1)
        self.params_hash = hash_params(params) if params is not None else None
        self.writer = writer
        os.makedirs(self.dir, exist_ok=True)
        # serializes the generations-list read/modify/write and the
        # manifest rewrite: in async mode `_write` runs on the writer
        # thread while `save_now` (the SIGTERM preemption checkpoint)
        # runs the SAME code on the training thread — unserialized, the
        # two read-modify-writes race and the manifest can lose a
        # generation.  RLock so
        # _write may call _write_manifest while holding it.
        self._gen_lock = threading.RLock()
        # per-generation manifest records {iteration, model, state,
        # digests, num_rows}, oldest -> newest; reloaded from an
        # existing manifest so a resumed process keeps the history it
        # needs for digest verification and generation fallback
        self._generations: List[Dict[str, Any]] = self._load_generations()

    def _load_generations(self) -> List[Dict[str, Any]]:
        try:
            with open(os.path.join(self.dir, MANIFEST)) as f:
                m = json.load(f)
            gens = m.get("generations")
            if isinstance(gens, list):
                return [g for g in gens if isinstance(g, dict)
                        and "iteration" in g and "model" in g]
        except (OSError, ValueError):
            pass
        return []

    # ------------------------------------------------------------- save
    def _name(self, iteration: int, ext: str) -> str:
        return os.path.join(self.dir, f"ckpt_{iteration:07d}.{ext}")

    def save(self, booster, iteration: int, on_done=None) -> Checkpoint:
        """Checkpoint `booster` as of `iteration` completed rounds.

        Synchronous mode raises OSError on write failure when no
        `on_done` is given (direct callers decide); with `on_done(ok,
        err, ck)` — the training callback's accounting hook — failures
        are reported through the hook instead.  Async mode returns
        immediately after capture; the hook fires from the writer
        thread once the files land (or fail)."""
        from ..utils.timer import global_timer
        with global_timer.scope("Checkpoint::save"):
            it = int(iteration)
            model_txt = booster.model_to_string(num_iteration=-1)
            state = None
            num_rows = None
            gbdt = getattr(booster, "_gbdt", None)
            if gbdt is not None and hasattr(gbdt, "capture_train_state"):
                state = gbdt.capture_train_state(
                    async_copy=self.writer is not None)
                num_rows = int(getattr(gbdt, "num_data", 0)) or None
            ck = Checkpoint(it, self._name(it, "txt"),
                            self._name(it, "npz") if state is not None
                            else None, self.params_hash, num_rows=num_rows)
            if self.writer is not None:
                self.writer.submit(self._write_reporting, it, model_txt,
                                   state, ck, on_done, num_rows)
                return ck
            try:
                self._write(it, model_txt, state, num_rows)
            except OSError as e:
                if on_done is not None:
                    on_done(False, e, ck)
                    return ck
                raise
        if on_done is not None:
            on_done(True, None, ck)
        return ck

    def save_in_group(self, booster, iteration: int, net,
                      on_done=None) -> Optional[Checkpoint]:
        """A process group's checkpoint: every rank captures the trainer
        state (a rank of a row-sharded learner gathers the serial run's
        scores and bag mask, a collective), rank 0 writes it
        synchronously in a serial checkpoint's layout, and every rank
        then waits at a barrier, so that no rank runs ahead of a
        checkpoint that is not yet on disk.  Returns rank 0's
        Checkpoint (None on the others); failures go through `on_done`
        as in `save`."""
        from ..utils.timer import global_timer
        it = int(iteration)
        with global_timer.scope("Checkpoint::save"):
            gbdt = booster._gbdt
            state = gbdt.capture_train_state(async_copy=False)
            ck = None
            if net.rank == 0:
                num_rows = int(getattr(gbdt, "num_data", 0)) or None
                ck = Checkpoint(it, self._name(it, "txt"),
                                self._name(it, "npz"), self.params_hash,
                                num_rows=num_rows)
                err = None
                try:
                    self._write(it, booster.model_to_string(
                        num_iteration=-1), state, num_rows)
                except OSError as e:
                    err = e
                if on_done is not None:
                    on_done(err is None, err, ck)
                elif err is not None:
                    raise err
            net.barrier()
        return ck

    def save_now(self, booster, iteration: int,
                 grace_s: Optional[float] = None) -> Optional[Checkpoint]:
        """Out-of-band SYNCHRONOUS checkpoint for the preemption
        handler: capture on the calling
        (training) thread, write without the AsyncWriter — whose queue
        the dying process may never drain — and keep the whole save
        inside `grace_s`: when the capture alone has eaten the budget,
        the exact-state npz is dropped and the model text (which still
        resumes, predict-seeded) is written alone.  Returns None when
        there is nothing worth saving (no completed iteration)."""
        it = int(iteration)
        if it <= 0:
            return None
        t0 = time.monotonic()
        # serialize exactly `it` iterations: the pipelined engine may
        # hold trees past the declared boundary, and a checkpoint whose
        # model text disagrees with its iteration cannot resume exactly
        model_txt = booster.model_to_string(num_iteration=it)
        state = None
        num_rows = None
        gbdt = getattr(booster, "_gbdt", None)
        if gbdt is not None and hasattr(gbdt, "capture_train_state"):
            state = gbdt.capture_train_state(async_copy=False)
            num_rows = int(getattr(gbdt, "num_data", 0)) or None
        if grace_s is not None and time.monotonic() - t0 > float(grace_s):
            log.warning(f"Preemption checkpoint capture overran the "
                        f"{grace_s:.1f}s grace budget; writing model text "
                        "without the exact-state npz")
            state = None
        self._write(it, model_txt, state, num_rows)
        return Checkpoint(it, self._name(it, "txt"),
                          self._name(it, "npz") if state is not None
                          else None, self.params_hash, num_rows=num_rows)

    def _write_reporting(self, it, model_txt, state, ck, on_done,
                         num_rows=None) -> None:
        """Worker-side write wrapper: route the outcome through on_done
        and swallow the failure (reliability contract: a lost checkpoint
        must never kill a long run)."""
        try:
            self._write(it, model_txt, state, num_rows)
        except OSError as e:
            if on_done is not None:
                on_done(False, e, ck)
            else:
                log.warning(f"Async checkpoint write failed at iteration "
                            f"{it}: {e}; training continues")
            return
        if on_done is not None:
            on_done(True, None, ck)

    def _write(self, it: int, model_txt: str, state,
               num_rows: Optional[int] = None) -> None:
        """Serialize + atomically rename one captured checkpoint (runs
        on the writer thread in async mode).  Digests are computed over
        the exact bytes handed to the atomic writer, so a later
        mismatch can only mean on-disk damage, never a race."""
        faults.maybe_ckpt_write_fail(it)
        model_path = self._name(it, "txt")
        model_bytes = model_txt.encode()
        atomic_write_bytes(model_path, model_bytes)
        digests = {os.path.basename(model_path):
                   hashlib.sha256(model_bytes).hexdigest()}
        state_path = None
        if state is not None:
            state_path = self._name(it, "npz")
            sbytes = _state_bytes(state)
            atomic_write_bytes(state_path, sbytes)
            digests[os.path.basename(state_path)] = \
                hashlib.sha256(sbytes).hexdigest()
        entry = {"iteration": it,
                 "model": os.path.basename(model_path),
                 "state": (os.path.basename(state_path)
                           if state_path else None),
                 "digests": digests, "num_rows": num_rows,
                 "params_hash": self.params_hash}
        with self._gen_lock:
            self._generations = sorted(
                [g for g in self._generations if g.get("iteration") != it]
                + [entry], key=lambda g: g["iteration"])[-self.keep_last:]
            self._write_manifest()
            self._rotate()
        # post-landing damage injection (ckpt_corrupt drill): the
        # manifest now describes a healthy write the disk no longer holds
        if faults.active():
            faults.maybe_ckpt_corrupt(it, model_path, state_path)
        log.debug(f"Checkpoint written at iteration {it} -> {model_path}")

    def _write_manifest(self) -> None:
        with self._gen_lock:
            if not self._generations:
                try:
                    os.unlink(os.path.join(self.dir, MANIFEST))
                except OSError:
                    pass
                return
            newest = self._generations[-1]
            manifest = {"format": _FORMAT, "iteration": newest["iteration"],
                        "model": newest["model"], "state": newest["state"],
                        "params_hash": self.params_hash,
                        "num_rows": newest.get("num_rows"),
                        "digests": newest.get("digests"),
                        "generations": self._generations}
            atomic_write_text(os.path.join(self.dir, MANIFEST),
                              json.dumps(manifest, indent=1))

    def _rotate(self) -> None:
        models = sorted(glob.glob(os.path.join(self.dir, "ckpt_*.txt")))
        for stale in models[:-self.keep_last]:
            for p in (stale, stale[:-4] + ".npz"):
                try:
                    os.unlink(p)
                except OSError:
                    pass

    # ----------------------------------------------------------- latest
    def _ck_from_entry(self, g: Dict[str, Any]) -> Checkpoint:
        return Checkpoint(
            int(g["iteration"]), os.path.join(self.dir, g["model"]),
            (os.path.join(self.dir, g["state"]) if g.get("state") else None),
            g.get("params_hash", self.params_hash),
            digests=g.get("digests"), num_rows=g.get("num_rows"))

    def _candidates(self) -> List[Checkpoint]:
        """Resumable candidates, newest first: the manifest's retained
        generations when available, else the single newest checkpoint
        the manifest or a directory scan yields (legacy layouts)."""
        # re-read: another process (async writer, preempt handler,
        # previous attempt) may have advanced the manifest on disk
        with self._gen_lock:
            self._generations = self._load_generations() \
                or self._generations
            gens = list(self._generations)
        if gens:
            return [self._ck_from_entry(g) for g in reversed(gens)]
        ck = self.latest()
        return [ck] if ck is not None else []

    def latest(self) -> Optional[Checkpoint]:
        """Newest complete checkpoint, or None.  Prefers the manifest;
        falls back to scanning ckpt_*.txt when the manifest is missing
        or damaged (it is written atomically, but be lenient)."""
        mpath = os.path.join(self.dir, MANIFEST)
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    m = json.load(f)
                model = os.path.join(self.dir, m["model"])
                if os.path.exists(model):
                    state = (os.path.join(self.dir, m["state"])
                             if m.get("state") else None)
                    return Checkpoint(int(m["iteration"]), model, state,
                                      m.get("params_hash"),
                                      digests=m.get("digests"),
                                      num_rows=m.get("num_rows"))
                log.warning(f"Checkpoint manifest points at missing file "
                            f"{model}; scanning {self.dir} instead")
            except (OSError, ValueError, KeyError) as e:
                log.warning(f"Damaged checkpoint manifest {mpath}: {e}; "
                            f"scanning {self.dir} instead")
        models = sorted(glob.glob(os.path.join(self.dir, "ckpt_*.txt")))
        if not models:
            return None
        model = models[-1]
        try:
            it = int(os.path.basename(model)[5:-4])
        except ValueError:
            return None
        state = model[:-4] + ".npz"
        return Checkpoint(it, model, state if os.path.exists(state) else None,
                          None)

    def quarantine(self, ck: Checkpoint, reason: str) -> None:
        """Move a failed-verification generation out of the resume path:
        artifacts renamed `*.corrupt-<ts>` (kept for forensics, invisible
        to the ckpt_*.txt scan) and the generation dropped from the
        manifest, so neither this process nor the next one can resume
        into the damage."""
        ts = int(time.time())
        for path in (ck.model_path, ck.state_path):
            if not path or not os.path.exists(path):
                continue
            try:
                os.replace(path, f"{path}.corrupt-{ts}")
            except OSError as e:
                log.warning(f"Could not quarantine {path}: {e}")
        with self._gen_lock:
            self._generations = [g for g in self._generations
                                 if int(g.get("iteration", -1))
                                 != ck.iteration]
            self._write_manifest()
        log.warning(f"Quarantined corrupt checkpoint at iteration "
                    f"{ck.iteration} in {self.dir}: {reason}")

    def resumable(self, params: Optional[Dict[str, Any]] = None
                  ) -> Optional[Checkpoint]:
        """Newest VERIFIED checkpoint, gated on a params-hash match: a
        checkpoint from a different configuration is reported and
        ignored; a corrupt one (manifest digest mismatch — torn write,
        bad disk, injected `ckpt_corrupt`) is quarantined and resume
        falls back to the previous rotation generation, emitting one
        structured `ckpt_fallback` event per generation skipped."""
        candidates = self._candidates()
        if not candidates:
            return None
        want = (hash_params(params) if params is not None
                else self.params_hash)
        ck = candidates[0]
        if ck.params_hash is not None and want is not None \
                and ck.params_hash != want:
            log.warning(
                f"Ignoring checkpoint at iteration {ck.iteration} in "
                f"{self.dir}: it was written with different training "
                f"parameters (hash {ck.params_hash} != {want}). Delete the "
                f"directory or pass resume=False to start over.")
            return None
        skipped: List[Tuple[Checkpoint, str]] = []
        winner = None
        for ck in candidates:
            ok, detail = ck.verify()
            if ok:
                winner = ck
                break
            self.quarantine(ck, detail)
            skipped.append((ck, detail))
        if skipped:
            from ..observability import emit_event, global_registry
            for bad, detail in skipped:
                global_registry.inc("ckpt_fallbacks")
                emit_event("ckpt_fallback", from_iteration=bad.iteration,
                           to_iteration=(winner.iteration
                                         if winner is not None else None),
                           reason=detail)
            log.warning(
                f"Checkpoint integrity: quarantined "
                f"{len(skipped)} corrupt generation(s) in {self.dir}; "
                + (f"resuming from generation at iteration "
                   f"{winner.iteration} instead"
                   if winner is not None else
                   "no intact generation remains — starting over"))
        return winner
