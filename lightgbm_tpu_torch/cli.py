"""Command line: `python -m lightgbm_tpu_torch config=train.conf [k=v ...]`
(the PyTorch port of `lightgbm_tpu/cli.py`; ref: src/main.cpp:14,
src/application/application.cpp:31 Application).

Parameters as the reference's LoadParameters takes them: command-line
`key=value` pairs win over the config file's entries (the first value
of a key wins, ref: application.cpp:79 KeepFirstValues).  Tasks: train,
predict, refit, save_binary and convert_model (ref: config.h TaskType).
`device_type` comes from the parameters like any other, so the command
line runs on the card unless `device_type=cpu` is given, models loaded
for predict and refit included.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .config import Config, read_config_file
from .engine import train as train_api
from .utils import log


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


def _refuse_unported(task: str) -> None:
    raise NotImplementedError(
        f"task={task} is not ported yet (ROADMAP Queue 1 item 16): the "
        "PyTorch port's command line trains, predicts, refits, saves "
        "binary datasets and converts models")


HANDLERS = {"train": _task_train, "predict": _task_predict,
            "prediction": _task_predict, "refit": _task_refit,
            "refit_tree": _task_refit, "save_binary": _task_save_binary,
            "convert_model": _task_convert_model}
# the JAX package's serving and online tasks
UNPORTED_TASKS = ("serve", "serve-fleet", "serve_fleet", "train-and-serve",
                  "train_and_serve")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "serve-fleet", "train-and-serve"):
        # `python -m lightgbm_tpu_torch serve ...`, as the JAX package's
        argv = [f"task={argv[0]}"] + list(argv[1:])
    params = parse_args(argv)
    cfg = Config(dict(params))
    task = cfg.task
    if task in UNPORTED_TASKS:
        _refuse_unported(task)
    if cfg.num_machines > 1:
        raise NotImplementedError(
            "num_machines > 1 (training across machines) is not ported yet "
            "(ROADMAP Queue 1 item 15)")
    if task not in HANDLERS:
        log.fatal(f"Unknown task {task!r}")
    HANDLERS[task](cfg, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
