"""Command line: `python -m lightgbm_tpu_torch config=train.conf [k=v ...]`
(the PyTorch port of `lightgbm_tpu/cli.py`; ref: src/main.cpp:14,
src/application/application.cpp:31 Application).

Parameters as the reference's LoadParameters takes them: command-line
`key=value` pairs win over the config file's entries (the first value
of a key wins, ref: application.cpp:79 KeepFirstValues).  Tasks: train,
predict, refit, save_binary and convert_model (ref: config.h TaskType),
the JAX package's serving tasks `serve` and `serve-fleet`, and its
online task `train-and-serve`.
`device_type` comes from the parameters like any other, so the command
line runs on the card unless `device_type=cpu` is given, models loaded
for predict, refit and serving included.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .basic import Booster, Dataset
from .config import Config, read_config_file
from .engine import train as train_api
from .utils import log
from .utils.device import resolve_device


def parse_args(argv: List[str]) -> Dict[str, str]:
    """argv `key=value` tokens and the optional config file, the command
    line first (ref: application.cpp:50-86 LoadParameters)."""
    params: Dict[str, str] = {}
    for tok in argv:
        if "=" not in tok:
            log.fatal(f"Unknown argument {tok!r}; expected key=value")
        k, v = tok.split("=", 1)
        params.setdefault(k.strip(), v.strip())
    conf = params.get("config", params.get("config_file", ""))
    if conf:
        for k, v in read_config_file(conf).items():
            params.setdefault(k, v)       # the command line's value wins
    params.pop("config", None)
    params.pop("config_file", None)
    return params


def _load_model(cfg: Config, task: str) -> Booster:
    if not cfg.input_model:
        log.fatal(f"task={task} needs input_model=<file>")
    return Booster(model_file=cfg.input_model,
                   params={"device_type": cfg.device_type})


def _load_train_data(cfg: Config, params: Dict[str, str]) -> Dataset:
    if not cfg.data:
        log.fatal("No training data: set data=<file>")
    return Dataset(cfg.data, params=dict(params))


def _task_train(cfg: Config, params: Dict[str, str]) -> None:
    train_set = _load_train_data(cfg, params)
    valid_sets, valid_names = [], []
    for i, vf in enumerate(cfg.valid):
        valid_sets.append(Dataset(vf, params=dict(params),
                                  reference=train_set))
        valid_names.append(f"valid_{i}" if len(cfg.valid) > 1 else "valid")
    callbacks = None
    if cfg.snapshot_freq > 0:
        # periodic model files (ref: gbdt.cpp:244-248 snapshot_freq writes
        # model.snapshot_iter_N; resume through input_model)
        def _snapshot(env):
            it = env.iteration + 1
            if it % cfg.snapshot_freq == 0:
                env.model.save_model(
                    f"{cfg.output_model}.snapshot_iter_{it}")
        _snapshot.order = 100
        callbacks = [_snapshot]
    # resume flags (the JAX package's cli.py:66-93): checkpoint_dir=DIR
    # writes rotated atomic checkpoints every checkpoint_freq rounds, and
    # re-running the same command continues from the newest one unless
    # resume=false; metrics_dir and profile_dir reach train in params
    if cfg.checkpoint_dir:
        log.info(f"Checkpointing to {cfg.checkpoint_dir} every "
                 f"{cfg.checkpoint_freq} iteration(s) "
                 f"(resume={'on' if cfg.resume else 'off'})")
    if cfg.metrics_dir:
        log.info(f"Writing per-iteration telemetry events to "
                 f"{cfg.metrics_dir}")
    if cfg.profile_dir:
        log.info(f"Profiling the run; the trace will be written to "
                 f"{cfg.profile_dir}")
    booster = train_api(dict(params), train_set,
                        num_boost_round=cfg.num_iterations,
                        valid_sets=valid_sets or None,
                        valid_names=valid_names or None,
                        init_model=cfg.input_model or None,
                        callbacks=callbacks,
                        checkpoint_dir=cfg.checkpoint_dir or None,
                        checkpoint_freq=cfg.checkpoint_freq,
                        resume=cfg.resume)
    booster.save_model(cfg.output_model)
    log.info(f"Finished training; model saved to {cfg.output_model}")


# the rows of one streamed chunk of file prediction, in bytes of float64
# features; tests shrink it to force several chunks
_PREDICT_CHUNK_BUDGET = 32 << 20


def _task_predict(cfg: Config, params: Dict[str, str]) -> None:
    """File prediction in bounded memory: the input streams through
    `parse_file_stream` in row chunks (ref: predictor.hpp:30
    PipelineReader), so the peak is one chunk and the model."""
    booster = _load_model(cfg, "predict")
    from .io.parser import parse_file_stream
    nf = booster.num_feature()
    chunk_rows = max(128, _PREDICT_CHUNK_BUDGET // max(8 * nf, 1))
    n_done = 0
    with open(cfg.output_result, "w") as f:
        for feats, _ in parse_file_stream(
                cfg.data, has_header=cfg.header,
                label_column=cfg.label_column, chunk_rows=chunk_rows,
                num_features=nf):
            pred = booster.predict(
                feats, raw_score=cfg.predict_raw_score,
                pred_leaf=cfg.predict_leaf_index,
                pred_contrib=cfg.predict_contrib,
                num_iteration=cfg.num_iteration_predict)
            for row in np.atleast_1d(pred):
                if np.ndim(row) == 0:
                    f.write(f"{row:.18g}\n")
                else:
                    f.write("\t".join(f"{v:.18g}" for v in row) + "\n")
            n_done += len(feats)
    log.info(f"Finished prediction of {n_done} rows; results saved to "
             f"{cfg.output_result}")


def _task_refit(cfg: Config, params: Dict[str, str]) -> None:
    """Refit the existing tree structures to the data file's rows (ref:
    task=refit -> GBDT::RefitTree)."""
    booster = _load_model(cfg, "refit")
    from .io.parser import parse_file
    feats, labels, _ = parse_file(cfg.data, has_header=cfg.header,
                                  label_column=cfg.label_column)
    booster.refit(feats, labels)
    booster.save_model(cfg.output_model)
    log.info(f"Finished refit; model saved to {cfg.output_model}")


def _task_save_binary(cfg: Config, params: Dict[str, str]) -> None:
    ds = _load_train_data(cfg, params)
    out = (cfg.data or "train") + ".bin"
    ds._core_or_construct().save_binary(out)
    log.info(f"Saved binary dataset to {out}")


def _task_convert_model(cfg: Config, params: Dict[str, str]) -> None:
    """The model as standalone C++ if-else source (ref:
    gbdt_model_text.cpp SaveModelToIfElse)."""
    booster = _load_model(cfg, "convert_model")
    out = cfg.convert_model or "gbdt_prediction.cpp"
    with open(out, "w") as f:
        f.write(booster.model_to_if_else())
    log.info(f"Converted model saved to {out}")


def _serve_entries(cfg: Config, task: str) -> List[Tuple[str, str]]:
    """(name, model file) pairs from serve_models (`name=path`, a bare
    path serving under its file stem), else input_model as `default`."""
    entries = []
    for tok in cfg.serve_models:
        name, sep, path = tok.partition("=")
        if not sep:
            name, path = os.path.splitext(os.path.basename(tok))[0], tok
        entries.append((name.strip(), path.strip()))
    if not entries and cfg.input_model:
        entries.append(("default", cfg.input_model))
    if not entries:
        log.fatal(f"task={task} needs serve_models=name=model.txt[,...] "
                  "or input_model=<file>")
    return entries


def _event_log(cfg: Config) -> None:
    """serve_* events (swap/evict/drain) land in the JSONL event log
    under metrics_dir, as training telemetry does."""
    from .observability import EventLogger, set_event_logger
    set_event_logger(EventLogger(cfg.metrics_dir,
                                 rotate_mb=cfg.metrics_rotate_mb))


def _write_ready_file(path: str, payload: Dict[str, object]) -> None:
    from .utils import atomic_write_text
    atomic_write_text(path, json.dumps({"pid": os.getpid(), **payload}))
    log.info(f"Ready file written to {path}")


def _task_serve(cfg: Config, params: Dict[str, str]) -> None:
    """Long-lived multi-model serving daemon (the JAX package's task):
    `python -m lightgbm_tpu_torch serve serve_models=name=model.txt`.
    Loads and warms every model (the whole bucket ladder on the
    device) BEFORE serving, optionally exposes the line-JSON front end
    on TCP (serve_port=0 for an ephemeral port) and a Unix socket
    (serve_uds_path), and treats SIGTERM as a drain notice: queued
    requests complete, a final `serve_drain` event lands, and the exit
    stays 143 (the supervisor's *preempt* classification)."""
    from .serving import ServingDaemon, start_frontend, start_uds_frontend

    if cfg.metrics_dir:
        _event_log(cfg)
        # SIGUSR2 dumps the flight recorder + registry snapshot from the
        # LIVE daemon without killing it
        from .reliability.faults import register_flight_dump_signal
        register_flight_dump_signal(cfg.metrics_dir)
    entries = _serve_entries(cfg, "serve")
    daemon = ServingDaemon(cfg)
    for name, path in entries:
        daemon.registry.register(name, model_file=path, block=True)
        log.info(f"Serving model {name!r} from {path} on "
                 f"{daemon.registry.device} (warmed)")
    daemon.start()
    daemon.install_signal_handlers()
    srv = uds_srv = None
    if cfg.serve_port >= 0:
        srv = start_frontend(daemon, port=cfg.serve_port,
                             request_timeout_s=cfg.serve_request_timeout_s)
    if cfg.serve_uds_path:
        uds_srv = start_uds_frontend(
            daemon, cfg.serve_uds_path,
            request_timeout_s=cfg.serve_request_timeout_s)
    if cfg.serve_ready_file:
        # readiness marker for the fleet supervisor: port + pid land
        # atomically only AFTER every model is loaded, warmed, and the
        # front end listens; an early file would route traffic into
        # cold buckets
        _write_ready_file(cfg.serve_ready_file, {
            "port": srv.server_address[1] if srv is not None else -1,
            "metrics_port": (daemon.metrics_server.port
                             if daemon.metrics_server else -1),
            "models": daemon.registry.versions()})
    log.info(f"Serving {len(entries)} model(s); SIGTERM drains and exits")
    try:
        while not daemon.stopped:
            time.sleep(0.2)
    except KeyboardInterrupt:
        log.info("Interrupted; draining the request queue")
        daemon.stop(drain=True, timeout=cfg.serve_drain_timeout_s)
    finally:
        if srv is not None:
            srv.shutdown()
        if uds_srv is not None:
            uds_srv.shutdown()


def _task_serve_fleet(cfg: Config, params: Dict[str, str]) -> None:
    """Serving fault domain (the JAX package's task):
    `python -m lightgbm_tpu_torch serve-fleet serve_models=m=model.txt
    serve_replicas=2 serve_port=0`.  Spawns `serve_replicas` replica
    daemons (each a supervised `task=serve` child process with its own
    CUDA context and ready file), health-checks them, and fronts them
    with the retry/shed/canary router on `serve_port`.  SIGTERM drains
    the WHOLE fleet: the router stops accepting, every replica gets its
    own SIGTERM drain (each exits 143), and the runner re-delivers: the
    exit stays 143.  The router process itself touches no device."""
    import tempfile

    from .observability import install_sigterm_flush, set_preemption_hook
    from .serving import ReplicaFleet, Router

    if cfg.metrics_dir:
        _event_log(cfg)
    entries = _serve_entries(cfg, "serve-fleet")
    force_cpu = os.environ.get("LGBM_TPU_SERVE_FORCE_CPU") == "1"
    if not force_cpu:
        # the replicas serve where device_type says: refuse here, once,
        # rather than in every child (no card, no fallback)
        resolve_device(cfg.device_type)
    workdir = cfg.metrics_dir or tempfile.mkdtemp(prefix="lgbm-fleet-")
    # replica daemons inherit the serving knobs; their OWN ports are
    # ephemeral (the ready file reports them) and the router owns the
    # client-facing serve_port
    replica_params = {k: v for k, v in params.items()
                      if k not in ("task", "serve_port", "serve_replicas",
                                   "serve_ready_file", "metrics_dir",
                                   "metrics_port")}
    fleet = ReplicaFleet(
        num_replicas=cfg.serve_replicas, model_entries=entries,
        workdir=workdir, params=replica_params,
        max_restarts=cfg.serve_max_replica_restarts,
        health_interval_s=cfg.serve_health_interval_s,
        force_cpu=force_cpu).start()
    router = Router(fleet, cfg)
    for name, path in entries:
        router.register_incumbent(name, path)
    if not fleet.wait_ready(timeout=300.0, min_replicas=1):
        fleet.stop(drain=False)
        log.fatal("serve-fleet: no replica became ready within 300 s "
                  f"(see {workdir}/replica-*.log)")
    srv = router.start_frontend(port=max(cfg.serve_port, 0),
                                metrics_port=cfg.metrics_port)
    log.info(f"Fleet router listening on "
             f"{srv.server_address[0]}:{srv.server_address[1]} "
             f"({cfg.serve_replicas} replicas); SIGTERM drains the fleet")
    if cfg.serve_slo_p99_ms > 0:
        log.info(f"SLO tracking on: p99 <= {cfg.serve_slo_p99_ms:g} ms, "
                 f"error budget {cfg.serve_slo_error_pct:g}% "
                 f"(burn windows {cfg.serve_slo_fast_window_s:g}s / "
                 f"{cfg.serve_slo_slow_window_s:g}s)")
    if cfg.serve_ready_file:
        _write_ready_file(cfg.serve_ready_file, {
            "port": srv.server_address[1],
            "metrics_port": (router.metrics_server.port
                             if router.metrics_server else -1),
            "replicas": fleet.describe()})
    stopping = {"flag": False}

    def _drain():
        stopping["flag"] = True
        router.stop()
        fleet.stop(drain=True, timeout=cfg.serve_drain_timeout_s + 30.0)
        return None  # finish_preemption re-delivers; rc stays 143

    if install_sigterm_flush():
        set_preemption_hook(_drain)
    try:
        while not stopping["flag"] and fleet.alive():
            time.sleep(0.2)
        if not stopping["flag"]:
            log.warning("serve-fleet: every replica exhausted its "
                        "restart budget; shutting down")
    except KeyboardInterrupt:
        log.info("Interrupted; draining the fleet")
        _drain()
    finally:
        router.stop()


def _task_train_and_serve(cfg: Config, params: Dict[str, str]) -> None:
    """Online continual learning (the JAX package's task):
    `python -m lightgbm_tpu_torch train-and-serve online_chunk_dir=DIR
    checkpoint_dir=CKPT [input_model=seed.txt] [serve_port=0]`.

    One process closing the train->serve loop: a DirectoryChunkSource
    watches `online_chunk_dir`, the OnlineTrainer boosts/refits per
    chunk generation (on the card unless `device_type=cpu`),
    checkpoints each generation (byte-exact SIGTERM/crash resume), and
    publishes atomically — into this process's own serving daemon
    (default; serve_port/serve_uds_path expose it), or over the wire to
    a remote router/replica when `online_publish_addr=host:port` is set.
    SIGTERM stops the loop at the next boundary (mid-generation: the
    relaunch resumes from the last completed generation's checkpoint)
    and drains the local daemon; exit stays 143."""
    from .observability import set_preemption_hook
    from .online import (DirectoryChunkSource, LocalPublisher,
                         OnlineTrainer, WirePublisher)

    if cfg.metrics_dir:
        _event_log(cfg)
        from .reliability.faults import register_flight_dump_signal
        register_flight_dump_signal(cfg.metrics_dir)
    if not cfg.online_chunk_dir:
        log.fatal("task=train-and-serve needs online_chunk_dir=<dir>")
    if not cfg.checkpoint_dir:
        log.warning("train-and-serve without checkpoint_dir=: a restart "
                    "re-trains from scratch (no byte-exact resume)")

    daemon = srv = uds_srv = None
    if cfg.online_publish_addr:
        host, _, port = cfg.online_publish_addr.rpartition(":")
        if not port.isdigit():
            log.fatal(f"online_publish_addr must be host:port "
                      f"(got {cfg.online_publish_addr!r})")
        publisher = WirePublisher(host or "127.0.0.1", int(port))
        log.info(f"Publishing generations to {cfg.online_publish_addr} "
                 "(op=publish over the wire)")
    else:
        from .serving import (ServingDaemon, start_frontend,
                              start_uds_frontend)
        daemon = ServingDaemon(cfg).start()
        publisher = LocalPublisher(daemon)
        if cfg.serve_port >= 0:
            srv = start_frontend(
                daemon, port=cfg.serve_port,
                request_timeout_s=cfg.serve_request_timeout_s)
        if cfg.serve_uds_path:
            uds_srv = start_uds_frontend(
                daemon, cfg.serve_uds_path,
                request_timeout_s=cfg.serve_request_timeout_s)

    source = DirectoryChunkSource(cfg.online_chunk_dir)
    trainer = OnlineTrainer(source, publisher, config=cfg,
                            params=dict(params),
                            checkpoint_dir=cfg.checkpoint_dir or None,
                            seed_model=cfg.input_model or None)
    trainer.install_signal_handlers()
    if daemon is not None:
        # one preemption-hook slot: the trainer owns it; chain the
        # daemon's drain behind the loop-stop so a SIGTERM between
        # generations completes queued requests before the exit
        def _stop_all():
            trainer.request_stop()
            daemon.stop(drain=True, timeout=cfg.serve_drain_timeout_s)
            return None  # finish_preemption re-delivers; rc stays 143

        set_preemption_hook(_stop_all)
    trainer.start()  # resume (or seed) + initial publish
    if cfg.serve_ready_file:
        _write_ready_file(cfg.serve_ready_file, {
            "port": (srv.server_address[1] if srv is not None else -1),
            "uds_path": cfg.serve_uds_path or None,
            "metrics_port": (daemon.metrics_server.port
                             if daemon is not None
                             and daemon.metrics_server else -1),
            "generation": trainer.generation,
            "model": trainer.model_name})
    log.info(f"Online loop watching {cfg.online_chunk_dir} "
             f"(mode={cfg.online_mode}, "
             f"{cfg.online_trees_per_chunk} trees/chunk"
             + (f", freshness SLO {cfg.online_max_lag_s:g}s"
                if cfg.online_max_lag_s > 0 else "") + ")")
    try:
        stats = trainer.run()
        log.info(f"Online loop finished: {stats}")
    except KeyboardInterrupt:
        log.info("Interrupted; stopping the online loop")
        trainer.request_stop()
    finally:
        if daemon is not None and not daemon.stopped:
            daemon.stop(drain=True, timeout=cfg.serve_drain_timeout_s)
        if srv is not None:
            srv.shutdown()
        if uds_srv is not None:
            uds_srv.shutdown()


HANDLERS = {"train": _task_train, "predict": _task_predict,
            "prediction": _task_predict, "refit": _task_refit,
            "refit_tree": _task_refit, "save_binary": _task_save_binary,
            "convert_model": _task_convert_model, "serve": _task_serve,
            "serve-fleet": _task_serve_fleet,
            "serve_fleet": _task_serve_fleet,
            "train-and-serve": _task_train_and_serve,
            "train_and_serve": _task_train_and_serve}


def _machine_entries(cfg: Config) -> List[str]:
    """machines="ip1:port1,ip2:port2" or machine_list_filename (one
    "ip port" per line) -> ordered list of "host:port" strings
    (ref: config.h machines/machine_list_filename; network.cpp
    Network::Init parses both the same way)."""
    if cfg.machines:
        return [e.strip() for e in str(cfg.machines).split(",")
                if e.strip()]
    if cfg.machine_list_filename:
        entries = []
        with open(cfg.machine_list_filename) as f:
            for ln in f:
                toks = ln.split()
                if len(toks) >= 2:
                    entries.append(f"{toks[0]}:{toks[1]}")
        return entries
    return []


def _maybe_init_distributed(cfg: Config) -> None:
    """Multi-machine launch (ref: application.cpp:100-115 machine setup;
    the JAX package's cli.py `_maybe_init_distributed`).  Each worker runs
    this same CLI with the shared `machines` list and its OWN
    local_listen_port; the rank is `LIGHTGBM_TPU_MACHINE_RANK`, else the
    machine-list entry matching this host and port (the reference's rank
    resolution); entry 0 serves the group's TCPStore.  After
    `join_cluster`, tree_learner=data or voting trains this rank's rows,
    tree_learner=feature its block of columns, checkpoints are taken by
    every rank (rank 0 writes the serial run's state), and the
    collectives replace the reference's socket linkers."""
    if cfg.num_machines <= 1:
        return
    from .distributed import join_cluster, resolve_rank
    entries = _machine_entries(cfg)
    if not entries:
        log.warning("num_machines > 1 without machines / "
                    "machine_list_filename: training runs in this process "
                    "on one device")
        return
    if len(entries) != cfg.num_machines:
        log.fatal(f"num_machines={cfg.num_machines} but machine list has "
                  f"{len(entries)} entries")
    rank_env = os.environ.get("LIGHTGBM_TPU_MACHINE_RANK")
    rank = (int(rank_env) if rank_env is not None
            else resolve_rank(entries, cfg.local_listen_port))
    join_cluster(entries, rank=rank, initialize_timeout=cfg.time_out,
                 device_type=cfg.device_type)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "serve-fleet", "train-and-serve"):
        # `python -m lightgbm_tpu_torch serve ...`, as the JAX package's
        argv = [f"task={argv[0]}"] + list(argv[1:])
    params = parse_args(argv)
    cfg = Config(dict(params))
    task = cfg.task
    if task not in HANDLERS:
        log.fatal(f"Unknown task {task!r}")
    _maybe_init_distributed(cfg)
    try:
        HANDLERS[task](cfg, params)
    finally:
        if cfg.num_machines > 1:
            from .distributed import leave_cluster
            leave_cluster()
    return 0


if __name__ == "__main__":
    sys.exit(main())
