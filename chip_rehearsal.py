"""Rehearse chip_smoke.py's split_features, objectives, efb,
forced_interaction and surface phases on the CPU at 1/8 of their rows,
to size their gates before a run on the card:

    python3 chip_rehearsal.py [split_features] [objectives] [efb]
                              [forced_interaction] [surface]

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
card's.
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

    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    # launch counts are card-only: every kernel reads as launched
    cs.launch_counts = lambda H: {k: 1 for k in cs.KERNELS}
    # the rehearsal measures the values that the gates are taken from
    cs.CAT_AUC_MIN = 0.0
    cs.OBJECTIVE_GATES = {k: (m, sense, None)
                          for k, (m, sense, _) in cs.OBJECTIVE_GATES.items()}
    cs.QUANTILE_COVER_BAND = None
    cs.EFB_AUC_MIN = cs.FORCED_AUC_MIN = cs.INTERACTION_AUC_MIN = 0.0

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
    if "surface" in phases:
        # the surface phase runs on the main path's 13 trees
        booster.rollback_one_iter().rollback_one_iter().rollback_one_iter()
    main = {"s_per_iter": r["s_per_iter"], "ms_per_iter": r["ms_per_iter"],
            "auc": r["auc"],
            "features": cs.distinct_features(r["booster"]._gbdt.models_[:13])}
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
        elif phase == "surface":
            from lightgbm_tpu_torch.inference import DevicePredictor

            def cpu_dispatches(fn):
                before = DevicePredictor.dispatches.get("cpu", 0)
                out = fn()
                return out, DevicePredictor.dispatches.get("cpu", 0) - before
            cs.card_predict = cpu_dispatches
            booster.__class__ = lgb.Booster     # pickled by its class
            booster.reset_parameter({"device_predict": "true"})
            line = cs.phase_surface(Rehearsal(), H, booster, data)
            lines = {"surface": {**line, "run": "surface"}}
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
