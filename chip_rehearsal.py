"""Rehearse chip_smoke.py's split_features, objectives, efb,
forced_interaction, surface, ranking, file, linear, refit_contrib, cli,
wide_bins, monotone_modes, reliability, serving, online, huge_bins,
data_parallel and parallel_learners phases on the CPU at 1/8 of their
rows, to size their gates before a run on the card:

    python3 chip_rehearsal.py [split_features] [objectives] [efb]
                              [forced_interaction] [surface] [ranking]
                              [file] [linear] [refit_contrib] [cli]
                              [wide_bins] [monotone_modes] [reliability]
                              [serving] [online] [huge_bins]
                              [data_parallel] [parallel_learners]

(the first two when no phase is named).  The main path and the runs of
each phase (split_features: categorical, monotone, smooth_cegb;
objectives: regression, quantile, multiclass, rf, dart; efb: the
one-hot CSR run; forced_interaction: forced, interaction) train on
make_higgs_like(125_000, 28) with 12,500 held-out rows (every
`make_higgs_like(n, ...)` of chip_smoke.py at n / 8, the efb phase's
categoricals beside it), on `device_type=cpu`, with chip_smoke.py's gates
but the held-out bounds that are sized from these values and the host
RSS gate (its bound scales with the rows, the process's libraries do
not); the kernels' launch counts are not read (the kernels count only
on the card) and no device time or memory is measured.  Prints each
run's line.  The efb phase scans 778 features a wave on the CPU: about
10 minutes.  The surface phase predicts through the torch traversal on
the CPU (device_predict=true) and counts its CPU dispatches as the
card's.  The ranking phase trains lambdarank and rank_xendcg on
RANK_ROWS / 8 rows (whole queries) with RANK_VALID_ROWS / 8 held-out
rows, then runs the three ranking card-vs-CPU cases (both sides on the
CPU); the file phase runs at its full FILE_ROWS of the 1/8 data.  The
linear phase trains the main path's workload with linear_tree=true and
holds its fits of LINEAR_FIT_TREES to the plain version (its line gives
the AUC that LINEAR_AUC_MIN is taken from and each fit's largest error
over LINEAR_FIT_REL's bound), then runs the two linear card-vs-CPU cases
(both sides on the CPU); refit_contrib runs on the main path's booster
(its CPU dispatches counted as the card's); the command line runs with
`device_type=cpu` added to its arguments.  wide_bins trains at
max_bin=1023 on 16-bit codes and monotone_modes on the leaf-wise engine
(each of its runs rescans every leaf after every split on the CPU: a few
minutes); their lines give the held-out AUCs WIDE_LEAFWISE_AUC_MIN and
MONO_MODE_AUC_MIN are taken from (the path B numbers they stand beside
are the card's, not rehearsed).  reliability runs the rollback on the
main path's 13 trees and its child processes on the CPU at CHILD_ROWS /
8 rows; the device-memory gauge and the stall diagnosis's allocator
snapshot are card-only (a stand-in gauge, the snapshot's device name),
and the grow_tree roofline reads the host seconds of `Tree::histogram`.
serving runs the in-process and fleet drills on the main path's 13 trees
with the daemon and the replica children on the CPU (their CPU
dispatches counted as the card's); the bw_util gate holds against the
cost model's cpu peaks.  online runs the in-process loop (chunks of
ONLINE_CHUNK_ROWS / 8 rows, the chaos spec, the client threads) and the
SIGTERM drill's train-and-serve children on the CPU.  huge_bins keeps its
HUGE_ROWS rows (1/8 of them hold fewer than 65,536 distinct values, so
no column would reach int32 codes) and trains its "card" sides on the CPU
too.  data_parallel trains its ranks (train_distributed's workers and the
one-machine cluster, gloo: no NCCL on the CPU) and its serial references
on the CPU; the ranks' launch counts read 0 there.  parallel_learners
runs data_parallel first (its serial references and bins file), then
its cluster, its "card" and CPU runs and the elastic drill all on the
CPU (the drill's relaunch on gloo).
"""

import json
import sys

import torch

import chip_smoke as cs

SCALE = 8


def main(argv) -> int:
    phases = [a for a in argv if not a.startswith("-")] or [
        "split_features", "objectives"]
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils.timer import global_timer

    full = cs.make_higgs_like
    cs.make_higgs_like = lambda n, F, seed=0: full(n // SCALE, F, seed)
    cs.RANK_ROWS //= SCALE
    cs.RANK_VALID_ROWS //= SCALE

    def on_cpu(params):
        return {**(params or {}), "device_type": "cpu"}

    class CpuBooster(lgb.Booster):
        def __init__(self, params=None, **kw):
            super().__init__(params=on_cpu(params), **kw)

    class Rehearsal:
        """The port's entry points, on the CPU."""
        def __getattr__(self, name):
            return getattr(lgb, name)
        Booster = CpuBooster
        Dataset = staticmethod(lambda *a, params=None, **kw: lgb.Dataset(
            *a, params=on_cpu(params), **kw))
        LGBMClassifier = staticmethod(lambda **kw: lgb.LGBMClassifier(
            device_type="cpu", device_predict="true", **kw))
        train = staticmethod(lambda params, *a, **kw: lgb.train(
            on_cpu(params), *a, **kw))

    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.memory_allocated = lambda *a: 0
    # launch counts are card-only: every kernel reads as launched
    cs.launch_counts = lambda H: {k: 1 for k in cs.KERNELS}
    cs.check_kernels = lambda *a: None
    # the rehearsal measures the values that the gates are taken from
    cs.CAT_AUC_MIN = 0.0
    cs.OBJECTIVE_GATES = {k: (m, sense, None)
                          for k, (m, sense, _) in cs.OBJECTIVE_GATES.items()}
    cs.QUANTILE_COVER_BAND = None
    cs.EFB_AUC_MIN = cs.FORCED_AUC_MIN = cs.INTERACTION_AUC_MIN = 0.0
    cs.RANK_NDCG_MIN = {k: 0.0 for k in cs.RANK_NDCG_MIN}
    cs.LINEAR_AUC_MIN = 0.0
    cs.WIDE_LEAFWISE_AUC_MIN = 0.0
    cs.MONO_MODE_AUC_MIN = {k: 0.0 for k in cs.MONO_MODE_AUC_MIN}
    from lightgbm_tpu_torch import cli
    cli_main = cli.main
    cli.main = lambda argv: cli_main(list(argv) + ["device_type=cpu"])

    def rss_not_read(self):
        self.done.set()
        return 0.0, "not read in the rehearsal"
    cs.RssPeak.stop = rss_not_read
    probe = cs.ScanProbe()
    probe.reset()
    bench = cs.bench_rows(Rehearsal())
    data = bench[0]
    r = cs.drive_path(Rehearsal(), H, global_timer, "main_path", {}, 13,
                      data, train_set=bench[1])
    booster = r["booster"]
    if "surface" in phases or "refit_contrib" in phases:
        # the surface and refit_contrib phases run on the main path's 13
        # trees
        booster.rollback_one_iter().rollback_one_iter().rollback_one_iter()
    main = {"s_per_iter": r["s_per_iter"], "ms_per_iter": r["ms_per_iter"],
            "auc": r["auc"],
            "features": cs.distinct_features(r["booster"]._gbdt.models_[:13]),
            "path_b": {"s_per_iter": None, "ms_per_iter": {}}}
    print(json.dumps({"rehearsal": "main_path", "heldout_auc": r["auc"],
                      "distinct_features": len(main["features"])}))
    del r
    for phase in phases:
        if phase == "split_features":
            _, lines = cs.phase_split_features(Rehearsal(), H, global_timer,
                                               "cpu rehearsal", main, probe,
                                               bench)
        elif phase == "objectives":
            _, lines = cs.phase_objectives(Rehearsal(), H, global_timer,
                                           "cpu rehearsal", main)
        elif phase == "efb":
            _, line = cs.phase_efb(Rehearsal(), H, global_timer,
                                   "cpu rehearsal")
            lines = {"efb": {**line, "run": "efb"}}
        elif phase in ("ranking", "file"):
            rank = cs.ranking_data()
            if phase == "file":
                cs.phase_file(Rehearsal(), H, "cpu rehearsal", rank[0])
                lines = {}
            else:
                cs.phase_ranking(Rehearsal(), H, global_timer,
                                 "cpu rehearsal", rank)
                for name, extra in (
                        ("lambdarank_position_bias_wave",
                         {"objective": "lambdarank",
                          "lambdarank_position_bias_regularization": 0.1}),
                        ("rank_xendcg_quantized",
                         {"objective": "rank_xendcg",
                          "use_quantized_grad": True}),
                        ("lambdarank_leafwise",
                         {"objective": "lambdarank",
                          "tpu_growth_strategy": "leafwise"})):
                    cs.phase_card_vs_cpu(Rehearsal(), H, cs.case_inputs(
                        name, extra, data="mslr", rank=rank[0]))
                lines = {}
        elif phase in ("surface", "refit_contrib"):
            from lightgbm_tpu_torch.inference import DevicePredictor

            def cpu_dispatches(fn):
                before = DevicePredictor.dispatches.get("cpu", 0)
                out = fn()
                return out, DevicePredictor.dispatches.get("cpu", 0) - before
            cs.card_predict = cpu_dispatches
            booster.__class__ = lgb.Booster     # pickled by its class
            booster.reset_parameter({"device_predict": "true"})
            if phase == "surface":
                line = cs.phase_surface(Rehearsal(), H, booster, data)
                lines = {"surface": {**line, "run": "surface"}}
            else:
                cs.phase_refit_contrib(Rehearsal(), booster, data,
                                       "cpu rehearsal")
                lines = {}
        elif phase == "linear":
            cs.phase_linear(Rehearsal(), H, global_timer, "cpu rehearsal",
                            main, data)
            for name, extra in (
                    ("linear_quantized", {"linear_tree": True,
                                          "tpu_growth_strategy": "wave",
                                          "use_quantized_grad": True}),
                    ("linear_leafwise", {"linear_tree": True,
                                         "tpu_growth_strategy":
                                         "leafwise"})):
                cs.phase_card_vs_cpu(Rehearsal(), H, cs.case_inputs(
                    name, extra, rows=cs.CARD_LINEAR_ROWS))
            lines = {}
        elif phase == "cli":
            cs.phase_cli(Rehearsal(), H, "cpu rehearsal", data)
            lines = {}
        elif phase == "wide_bins":
            cs.phase_wide_bins(Rehearsal(), H, global_timer,
                               "cpu rehearsal", main, data)
            lines = {}
        elif phase == "reliability":
            # the main path's 13 trees; the children on the CPU too; the
            # allocator's gauges and snapshot are card-only
            booster.rollback_one_iter().rollback_one_iter() \
                .rollback_one_iter()
            main["model_text"] = booster.model_to_string(num_iteration=-1)
            import lightgbm_tpu_torch.observability as obs
            obs.update_memory_gauges = lambda device=None: \
                obs.global_registry.set_gauge("device_bytes_in_use", 1)
            cs.CHILD_ROWS //= SCALE
            cs.STALL_DEVICE_KEY = "device"
            cs.RELIABILITY_DEVICE = "cpu"
            # no CUDA events on the CPU: the scope's host seconds
            cs.GROW_TREE_PHASE = "Tree::histogram"
            start = cs.start_children
            cs.start_children = lambda script, specs: start(script, [
                (name, on_cpu(p), kw, fault, attempt)
                for name, p, kw, fault, attempt in specs])
            cs.phase_reliability(Rehearsal(), H, "cpu rehearsal", main,
                                 bench)
            lines = {}
        elif phase == "serving":
            main["model_text"] = booster.model_to_string(num_iteration=13)
            main["model_text_v1"] = booster.model_to_string(
                num_iteration=cs.SERVE_V1_ITERATIONS)
            cs.SERVE_DEVICE = "cpu"
            cs.SERVE_PARAMS = on_cpu(cs.SERVE_PARAMS)
            cs.FLEET_PARAMS = on_cpu(cs.FLEET_PARAMS)
            cs.phase_serving(Rehearsal(), "cpu rehearsal", main, data)
            lines = {}
        elif phase == "online":
            cs.ONLINE_DEVICE = "cpu"
            cs.ONLINE_PARAMS = on_cpu(cs.ONLINE_PARAMS)
            cs.phase_online(Rehearsal(), H, "cpu rehearsal")
            lines = {}
        elif phase == "huge_bins":
            cs.make_higgs_like = full
            cs.phase_huge_bins(Rehearsal(), H, "cpu rehearsal")
            cs.make_higgs_like = lambda n, F, seed=0: full(n // SCALE, F,
                                                           seed)
            lines = {}
        elif phase in ("data_parallel", "parallel_learners"):
            # the ranks and the one-machine cluster on the CPU (gloo)
            cs.DP_DEVICE = cs.PL_DEVICE = "cpu"
            _, refs = cs.phase_data_parallel(Rehearsal(), H,
                                             "cpu rehearsal", bench)
            if phase == "parallel_learners":
                cs.phase_parallel_learners(Rehearsal(), H, "cpu rehearsal",
                                           bench, refs)
            lines = {}
        elif phase == "monotone_modes":
            cs.phase_monotone_modes(Rehearsal(), H, global_timer,
                                    "cpu rehearsal", main, bench)
            lines = {}
        else:
            _, lines = cs.phase_forced_interaction(
                Rehearsal(), H, global_timer, "cpu rehearsal", main, bench)
        probe.reset()
        for line in lines.values():
            keep = {k: v for k, v in line.items()
                    if "ms" not in k and "s_per_iter" not in k
                    and "rss" not in k
                    and k not in ("peak_mem_gib", "launches", "card")}
            print(json.dumps({"rehearsal": line["run"], **keep}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
