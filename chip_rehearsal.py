"""Rehearse chip_smoke.py's split_features phase on the CPU at 1/8 of its
rows, to size its gates before a run on the card:

    python3 chip_rehearsal.py

The main path and the three runs of the phase (categorical, monotone,
smooth_cegb) train on make_higgs_like(125_000, 28) with 12,500 held-out
rows (every `make_higgs_like(n, ...)` of chip_smoke.py at n / 8), on
`device_type=cpu`, with chip_smoke.py's gates; the kernels' launch
counts are not read (the kernels count only on the card) and no device
time or memory is measured.  Prints each run's line.
"""

import json
import sys

import torch

import chip_smoke as cs

SCALE = 8


def main() -> int:
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

    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    # launch counts are card-only: every kernel reads as launched
    cs.launch_counts = lambda H: {k: 1 for k in cs.KERNELS}
    # the rehearsal measures the AUC that the gate is taken from
    cs.CAT_AUC_MIN = 0.0
    probe = cs.ScanProbe()
    probe.reset()
    data = (*cs.make_higgs_like(1_000_000, 28),
            *cs.make_higgs_like(100_000, 28, seed=1))
    r = cs.drive_path(Rehearsal(), H, global_timer, "main_path", {}, 13,
                      data)
    main = {"s_per_iter": r["s_per_iter"], "ms_per_iter": r["ms_per_iter"],
            "auc": r["auc"],
            "features": cs.distinct_features(r["booster"]._gbdt.models_[:13])}
    print(json.dumps({"rehearsal": "main_path", "heldout_auc": r["auc"],
                      "distinct_features": len(main["features"])}))
    del r
    _, lines = cs.phase_split_features(Rehearsal(), H, global_timer,
                                       "cpu rehearsal", main, probe)
    for line in lines.values():
        keep = {k: v for k, v in line.items()
                if "ms" not in k and "s_per_iter" not in k
                and k not in ("peak_mem_gib", "launches", "card")}
        print(json.dumps({"rehearsal": line["run"], **keep}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
