"""Model text (de)serialization (the PyTorch port's copy of
`lightgbm_tpu/boosting/model_io.py`), line-compatible with the reference's v4 format
(ref: src/boosting/gbdt_model_text.cpp SaveModelToString/LoadModelFromString).

The text model is also the checkpoint format (ref: SURVEY.md §5 checkpoint/resume:
snapshot_freq writes model.snapshot_iter_N; resume = load + continue training).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..models.tree import Tree
from ..utils import log


def objective_to_string(objective, config) -> str:
    """ref: each objective's ToString()."""
    if objective is None:
        if config is not None and config.objective not in ("custom", ""):
            return config.objective
        return "custom"
    name = objective.name
    if name == "binary":
        return f"binary sigmoid:{objective.sigmoid:g}"
    if name in ("multiclass", "multiclassova"):
        s = f"{name} num_class:{objective.num_class}"
        if name == "multiclassova":
            s += f" sigmoid:{objective.binary[0].sigmoid:g}"
        return s
    if name == "quantile":
        return f"quantile alpha:{objective.alpha:g}"
    if name == "huber":
        return f"huber alpha:{objective.alpha:g}"
    if name == "fair":
        return f"fair c:{objective.c:g}"
    if name == "tweedie":
        return f"tweedie tweedie_variance_power:{objective.rho:g}"
    if name == "lambdarank":
        return "lambdarank"
    if name == "rank_xendcg":
        return "rank_xendcg"
    return name


def save_model_to_string(booster, num_iteration: int = -1,
                         start_iteration: int = 0,
                         importance_type: str = "split") -> str:
    """ref: gbdt_model_text.cpp GBDT::SaveModelToString."""
    if hasattr(booster, "_sync_model"):
        booster._sync_model()
    ds = booster.train_data
    K = booster.num_tree_per_iteration
    cfg = booster.config
    total_iters = len(booster.models_) // max(K, 1)
    if num_iteration < 0:
        num_iteration = total_iters - start_iteration
    end = min(start_iteration + num_iteration, total_iters)

    if ds is not None:
        max_feature_idx = ds.num_total_features - 1
        feature_names = ds.feature_names
        feature_infos = ds.feature_infos()
    else:
        max_feature_idx = booster._loaded_max_feature_idx
        feature_names = booster._loaded_feature_names
        feature_infos = booster._loaded_feature_infos

    lines = [
        "tree",
        "version=v4",
        f"num_class={cfg.num_class if cfg else K}",
        f"num_tree_per_iteration={K}",
        "label_index=0",
        f"max_feature_idx={max_feature_idx}",
        f"objective={objective_to_string(booster.objective, cfg)}",
        "feature_names=" + " ".join(feature_names),
        "feature_infos=" + " ".join(feature_infos),
    ]
    if getattr(booster, "average_output_", False):
        lines.append("average_output")  # ref: gbdt_model_text.cpp:330-331
    tree_blocks = []
    for it in range(start_iteration, end):
        for k in range(K):
            idx = it * K + k
            tree_blocks.append(booster.models_[idx].to_string(len(tree_blocks)))
    # each block is "Tree=N\n...\n\n"; tree_sizes are the exact byte lengths of
    # the blocks as written, concatenated with no separator, so the reference
    # loader can seek by cumulative offsets (ref: gbdt_model_text.cpp:355-372)
    lines.append("tree_sizes=" + " ".join(str(len(b)) for b in tree_blocks))
    lines.append("")
    out = "\n".join(lines) + "\n"
    out += "".join(tree_blocks)
    out += "end of trees\n"

    imp = booster.feature_importance(importance_type)
    order = np.argsort(-imp, kind="stable")
    out += "\nfeature_importances:\n"
    for f in order:
        if imp[f] > 0 and f < len(feature_names):
            out += f"{feature_names[f]}={imp[f]:g}\n"
    out += "\nparameters:\n"
    loaded = getattr(booster, "_loaded_parameters", None)
    if ds is None and loaded is not None:
        # a model loaded from text writes its parameters back as read
        # (ref: gbdt_model_text.cpp loaded_parameter_), so its text
        # survives a pickle or a reload unchanged
        out += loaded
    elif cfg is not None:
        for key, val in sorted(cfg.changed_params().items()):
            if isinstance(val, list):
                val = ",".join(str(v) for v in val)
            out += f"[{key}: {val}]\n"
    out += "end of parameters\n"
    out += "\npandas_categorical:null\n"
    return out


def load_model_from_string(text: str):
    """ref: gbdt_model_text.cpp GBDT::LoadModelFromString.  Returns a GBDT in
    predictor mode (no train data)."""
    from ..config import Config
    from ..objective import RANKING, create_objective
    from .gbdt import GBDT

    booster = GBDT()
    head, _, rest = text.partition("\nTree=")
    kv: Dict[str, str] = {}
    for line in head.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k.strip()] = v.strip()
        elif line.strip() == "average_output":
            booster.average_output_ = True  # ref: gbdt_model_text.cpp:487
    # the reference Log::Fatal's on unrecognized text ("Model format
    # error"); a submodel header ("tree") must open the file
    if not text.lstrip().startswith("tree"):
        log.fatal("Unknown model format or submodel type in model file")
    if "version" not in kv:
        log.warning("Unknown model format version")
    if not rest.strip() and "end of trees" not in text:
        # zero-tree saves are valid (they carry the end-of-trees marker);
        # header-only junk is not (ref: gbdt_model_text.cpp Log::Fatal)
        log.fatal("Model file doesn't contain any trees "
                  "(ref: gbdt_model_text.cpp 'Model format error')")
    num_class = int(kv.get("num_class", "1"))
    K = int(kv.get("num_tree_per_iteration", str(num_class)))
    booster.num_class = num_class
    booster.num_tree_per_iteration = K
    booster._loaded_max_feature_idx = int(kv.get("max_feature_idx", "0"))
    booster._loaded_feature_names = kv.get("feature_names", "").split()
    booster._loaded_feature_infos = kv.get("feature_infos", "").split()

    obj_str = kv.get("objective", "custom")
    obj_tokens = obj_str.split()
    params = {"objective": obj_tokens[0], "num_class": num_class, "verbosity": -1}
    for tok in obj_tokens[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            params[{"num_class": "num_class", "sigmoid": "sigmoid",
                    "alpha": "alpha", "c": "fair_c",
                    "tweedie_variance_power": "tweedie_variance_power"}
                   .get(k, k)] = v
    prev_verbosity = log.get_verbosity()
    cfg = Config(params)
    # the predictor-mode Config is built quiet (verbosity -1 above), but
    # Config._post_process sets the PROCESS-WIDE log level as a side
    # effect — restore it, or loading any model silences the host (the
    # serving daemon loads models mid-flight and must keep its logs)
    log.set_verbosity(prev_verbosity)
    booster.config = cfg
    if obj_tokens[0] in RANKING:
        # a ranking model predicts raw scores (its conversion is the
        # identity) and carries no query data to build its objective on
        obj = None
    else:
        # custom/none give None; any other objective that fails to build
        # raises, so a model never predicts in the wrong space
        obj = create_objective(cfg)
    if obj is not None and obj_tokens[0] not in ("multiclass",
                                                 "multiclassova"):
        # predictor-mode init with a dummy label so convert_output works
        class _MD:
            label = np.zeros(1, np.float32)
            weight = None
            init_score = None
            query_boundaries = None
        obj.init(_MD(), 1)
    booster.objective = obj

    # tree blocks
    if rest:
        body = "Tree=" + rest
        end_pos = body.find("end of trees")
        body = body[:end_pos] if end_pos >= 0 else body
        blocks = body.split("\nTree=")
        for i, blk in enumerate(blocks):
            blk = blk.strip()
            if not blk:
                continue
            if not blk.startswith("Tree="):
                blk = "Tree=" + blk
            booster.models_.append(Tree.from_string(blk))
    booster.iter_ = len(booster.models_) // max(K, 1)
    _, found, params_block = text.partition("\nparameters:\n")
    if found and "end of parameters\n" in params_block:
        booster._loaded_parameters = params_block.split(
            "end of parameters\n", 1)[0]
    return booster


def save_model_to_file(booster, filename: str, num_iteration: int = -1,
                       start_iteration: int = 0,
                       importance_type: str = "split") -> None:
    # atomic: temp sibling + os.replace, so a crash mid-save never leaves
    # a truncated model on disk (the reference writes model files whole)
    from ..utils import atomic_write_text
    atomic_write_text(filename,
                      save_model_to_string(booster, num_iteration,
                                           start_iteration, importance_type))


def load_model_from_file(filename: str):
    with open(filename) as f:
        return load_model_from_string(f.read())
