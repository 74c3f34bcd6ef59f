"""Drive the PyTorch port's training paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: compile every kernel source of lightgbm_tpu_torch/ops/csrc,
     then one `resources` line per source: each kernel's registers,
     static shared memory, stack frame and spills (`ptxas -v`) and the
     atomic opcodes of its SASS (`cuobjdump -sass`); a kernel whose SASS
     holds `ATOMS.CAST` (a compare-and-swap loop) fails the run;
  3. main path: `Booster` updates with the bench workload (binary logloss,
     make_higgs_like(1_000_000, 28), 255 leaves, 255 bins, 13 iterations)
     on the card; held-out AUC >= 0.72 and K1 and K3 launched.  Then
     `predict`: the 13 trees score the 1M training rows and the 100k
     held-out rows through `Booster.predict` with default params (the
     card's tensor traversal), with the DevicePredictor dispatch count
     set to 0 just before and read just after (5 on the card, none on
     the CPU); leaf ids equal to the native host predictor's, each raw
     score within 2·T·2^-24·Σ_t|leaf value| of the float64 host score,
     held-out AUC within 1e-6; rows/s of the card end to end, by device
     time (kernels and copies), of the native OpenMP predictor and of
     the Python loop (50,000 rows); the pack's depth, the bucket and
     the peak device memory;
  4. path A, quantized training: the same workload with
     use_quantized_grad=true (4 bins, stochastic rounding), 13
     iterations; K2 launched, K1/K3 not; held-out AUC within 0.01 of
     phase 3's;
  5. path B, the leaf-wise engine: the same workload with
     tpu_growth_strategy=leafwise, 13 iterations; K4 launched, held-out
     AUC >= 0.72;
  5a. valid path: `train` on the main path's workload with
     valid_sets=[train, valid] (valid = make_higgs_like(100_000, 28,
     seed=1)), metric=["auc", "binary_logloss"], early_stopping_round=5,
     early_stopping_min_delta=VALID_MIN_DELTA, num_boost_round=100, and
     record_evaluation and log_evaluation(10) callbacks, the port's timer
     on.  Gates: (a) the training metrics ran on the card through
     DeviceEval, one transfer per tick, no host fallback; (b) the last
     tick's AUC and logloss within 2^-23 relative of the float64 host
     Metric's on the pulled training scores; (c) each recorded valid AUC
     within 1e-6 of the host AUC of predict(num_iteration=i+1); (d) the
     stop fired 5 iterations after best_iteration, which the min_delta
     rule replayed over the recorded history gives too; (e) predict()
     equals predict(num_iteration=best_iteration) exactly; (f) K1 and K3
     launched; (g) cv(nfold=3) at 60,000 rows on the card returns
     mean/stdv lists of one length and a cvbooster.  One `valid` line:
     GBDT::eval ms/iter and its share, s/iter with evaluation beside the
     main path's (both with the timer on), best_iteration, iterations
     and fetches per tick, the card's name and power limit;
  5b. device binning: make_higgs_like(2^21, 28) float32 binned by a
     default (card) Dataset and by a device_type=cpu one: the bins equal
     bit for bit, both `Dataset::binning` times, and one main-path update
     on each grows the same tree (the card bins padded on the card);
  6. card against CPU: `train` at 65,536 rows, 3 iterations, on "cuda"
     and "cpu", for the main path and paths A and B: the same split
     features and thresholds in every tree, leaf values within rtol 1e-4;
  7. kernels at the main path's widths (28 features, 255 bins, 2
     channels), one `kernel` line per shape: K1 at 1/2/4/8/16/128/256
     slots on n = 2^20 rows (half on the sentinel), at 384 slots of
     uneven sizes (slot s takes a share ~ 1 / (s + 1)) and at 128 slots
     on n = 999,936 rows (no multiple of K1's chunks); K3 at 1/2/4/8
     computed slots (K1 at the same slots is its yardstick) and at 1/8
     slots with every row in one bin of every feature (the hot cell);
     K2 at 1/2/4/8/16/128/256 slots on quantized gh and hot at 8/256;
     K4 at S = 512, 4,096, 65,536 and 2^20 rows (half in the mask) and
     on 4,096- and 65,536-row hot-cell segments, with half the rows in
     the mask or all.  Then `sweep` lines (skipped where the checkout's
     kernels predate them): the streaming kernel (K3, K2 at few slots)
     at three tile budgets, and K2 on both routes at 4/8/16 slots, the
     choice of K2_FEW_SLOTS.
     Every kernel's output must equal its plain PyTorch version's bit
     for bit (all four sum exact integers) and repeat bit for bit on a
     second launch, and each call must advance the kernel's launch count
     (no silent plain fallback).  Times per call: `ms`, CUDA events
     around one Python call (median of 10, host enqueue included);
     `loop_ms`, 50 back-to-back calls between two events; `kernel_ms`,
     the device time of the call's kernels and memsets in a
     torch.profiler trace (`kernel_ms_by_name` splits it); `host_share`
     = 1 - kernel_ms / ms; the plain version's and one `index_add_` over
     precomputed flat ids (the yardstick, `library_ms`).  K4's engine
     variant (`kernel_fixed` lines) must launch nothing but its kernel.
     Each shape's inputs are freed before the next is made.  This phase
     comes last so that the paths run in a process that holds no kernel
     inputs and that no profiler has traced.
Every path runs with all four launch counts set to 0 just before it and
reads them just after, then prints the breakdown of three instrumented
iterations.  Then the kernels line, the card's name and power limit, and
the result.

Any failure raises and exits nonzero.  With no CUDA device it exits
nonzero before printing any result.

    python3 chip_smoke.py --kernels-only

runs phases 1 and 7 only (no `resources` lines) and prints no result
line.  Copied into a checkout of another commit (e.g. the parent,
unpacked with `git archive`), it times that commit's kernels by the
same methods, for a comparison within one call.
"""

import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = ("K1", "K2", "K3", "K4")
N_KERNEL = 1 << 20
N_ODD = 1953 * 512             # rows that are no multiple of K1's chunks
F, B, C = 28, 255, 2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
VALID_MIN_DELTA = 0.001        # early_stopping_min_delta of the valid path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_higgs_like(n, F, seed=0):
    """The bench's synthetic Higgs-like workload (bench.py)."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, F), dtype=np.float32)
    for f in range(F):
        if f % 3 == 0:
            X[:, f] = rng.randn(n)
        elif f % 3 == 1:
            X[:, f] = np.abs(rng.randn(n)) ** 1.5
        else:
            X[:, f] = rng.rand(n)
    w = np.random.RandomState(1234).randn(F) / np.sqrt(F)
    logit = X @ w + 0.5 * X[:, 0] * X[:, 1]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def auc(y, s):
    """Tie-averaged rank-sum AUC."""
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts) - counts
    ranks = (cum + (counts + 1) / 2.0)[inv]
    pos = y > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / max(n_pos * n_neg, 1))


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of one call fn() over reps runs, by CUDA events
    recorded around the Python call (host enqueue included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, reps=50):
    """Milliseconds per call of reps back-to-back calls between two CUDA
    events: the device time when the host enqueues faster than the card
    runs, else the host's enqueue time."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=10, tries=3):
    """Device time per call from a torch.profiler trace of reps calls:
    (total over every kernel and memset, {kernel name: ms}), or (None,
    {}) when no trace of `tries` holds device time.  A name's time per
    call is its mean time per launch times its launches per call, so a
    trace that lost some records still counts whole calls."""
    fn()
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0)
            if t and ev.count:
                name = ev.key.replace("(anonymous namespace)::", "")
                per_call = max(1, round(ev.count / reps))
                per[name.split("(")[0].strip()] = (t / ev.count * per_call
                                                   / 1e3)
        if per:
            return sum(per.values()), per
    return None, {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(num_slots, dev, seed, n=N_KERNEL, uneven=False,
                  hot=False):
    """Main-path-shaped inputs: half the rows in computed slots (the
    smaller children), the rest on the sentinel slot.  `uneven` gives
    the slots the main path's leaf sizes: slot s takes a share
    proportional to 1 / (s + 1), so one slot is large and most small.
    `hot` puts every row in bin 17 of every feature (the hot cell)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    binned = torch.randint(0, B, (F, n), generator=g, dtype=torch.uint8)
    if hot:
        binned.fill_(17)
    if uneven:
        w = 1.0 / torch.arange(1, num_slots + 1, dtype=torch.float64)
        slot = torch.multinomial(w, n, replacement=True,
                                 generator=g).to(torch.int32)
    else:
        slot = torch.randint(0, num_slots, (n,), generator=g,
                             dtype=torch.int32)
    off = torch.rand(n, generator=g) < 0.5
    slot = torch.where(off, torch.full_like(slot, 1 << 20), slot)
    grad = torch.randn(n, generator=g)
    hess = torch.rand(n, generator=g) * 0.25
    gh = torch.stack([grad, hess, torch.ones(n)], 1)
    binned = binned.to(dev)
    return (binned, binned.t().contiguous(), slot.to(dev),
            gh.contiguous().to(dev))


def bound_of(binned_bytes, n, num_slots, rows_in_slots):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM bandwidth, against one add per computed row,
    feature and channel (plus the count) over the float32 peak."""
    nbytes = (binned_bytes + 4 * n + 4 * (C + 1) * n
              + num_slots * F * B * C * 4 + num_slots * 4)
    ops = rows_in_slots * (F * C + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def same(name, got, want):
    """Bit-identical outputs (tuples of tensors or one tensor); returns
    max |got - want| (0.0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for x, y in zip(got, want):
        if not torch.equal(x, y):
            diff = (x.double() - y.double()).abs().max()
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max |diff| {float(diff)})")
    return 0.0


def kernel_row(name, counter, k, p, lib, **extra):
    """Check the entry point k against its plain version p (bit for bit,
    and on a repeat launch), check that each call launched the kernel
    (its count advances by one), then time kernel, plain version and the
    `index_add_` yardstick lib by CUDA events and the kernel's device
    time by torch.profiler, and print the row."""
    before = counter.launches
    out1, out2 = k(), k()
    torch.cuda.synchronize()
    if counter.launches != before + 2:
        raise AssertionError(f"{name}: {counter.launches - before} kernel "
                             "launches for 2 calls")
    ref = p()
    err = same(name, out1, ref)
    same(f"{name} (repeat launch)", out1, out2)
    row = dict(kernel=name, max_abs_err=err, ms=cuda_ms(k),
               loop_ms=loop_ms(k), plain_ms=cuda_ms(p, reps=5),
               library_ms=cuda_ms(lib), repeat_bit_identical=True,
               equal_to_plain=True, **extra)
    total, per = device_ms(k)
    row.update(kernel_ms=total, kernel_ms_by_name=per,
               host_share=(None if total is None
                           else max(0.0, 1.0 - total / row["ms"])))
    emit({"phase": "kernel", **row})
    return row


def wave_yardstick(binned, slot, gh, NL, dev, vals_of=None):
    """One `index_add_` over precomputed flat (slot, feature, bin) ids of
    the computed rows (float32 values; int64 through vals_of)."""
    valid = (slot >= 0) & (slot < NL)
    ids = ((slot.long()[None, :] * F
            + torch.arange(F, device=dev)[:, None]) * B
           + binned.long())[:, valid].reshape(-1)
    v = gh[valid][:, :C] if vals_of is None else vals_of(gh[valid])
    vals = v.repeat(F, 1)
    out = torch.zeros(NL * F * B, C, dtype=vals.dtype, device=dev)
    return (lambda: out.index_add_(0, ids, vals)), int(valid.sum())


# K1 shapes: (slots, uneven leaf sizes, rows).  1-8 slots also go to K3
# on the main path: K1 is timed there for the choice between the two.
K1_SHAPES = [(1, False, N_KERNEL), (2, False, N_KERNEL),
             (4, False, N_KERNEL), (8, False, N_KERNEL),
             (16, False, N_KERNEL), (128, False, N_KERNEL),
             (256, False, N_KERNEL), (384, True, N_KERNEL),
             (128, False, N_ODD)]


# K3 shapes: (computed slots, hot cell)
K3_SHAPES = [(1, False), (2, False), (4, False), (8, False), (1, True),
             (8, True)]
# K2 shapes: (slots, hot cell); up to K2_FEW_SLOTS slots the streaming
# kernel, above it the partition
K2_SHAPES = [(1, False), (2, False), (4, False), (8, False), (16, False),
             (128, False), (256, False), (8, True), (256, True)]


def phase_kernels(H, dev):
    results = {}
    for NL, uneven, n in K1_SHAPES:
        binned, _, slot, gh = kernel_inputs(NL, dev, seed=NL + n % 7,
                                            n=n, uneven=uneven)
        k = functools.partial(H.build_histogram_wave, binned, slot, gh,
                              max_bin=B, num_slots=NL)
        p = functools.partial(H.build_histogram_wave_plain, binned, slot, gh,
                              max_bin=B, num_slots=NL)
        lib, rows_in = wave_yardstick(binned, slot, gh, NL, dev)
        bound, by = bound_of(F * n, n, NL, rows_in)
        results[("K1", NL, uneven, n)] = kernel_row(
            "K1", H.build_histogram_wave, k, p, lib, num_slots=NL,
            uneven=uneven, rows=n, bound_ms=bound, bound_by=by)
        del lib
    for Ks, hot in K3_SHAPES:
        binned, binned_rm, slot, gh = kernel_inputs(Ks, dev, seed=100 + Ks,
                                                    hot=hot)
        Kb = H.wave_slot_pad(Ks)
        k = functools.partial(H.build_histogram_wave_hl, binned, binned_rm,
                              slot, gh, max_bin=B, num_slots=Ks,
                              out_slots=Kb)
        p = functools.partial(H.build_histogram_wave_hl_plain, binned,
                              binned_rm, slot, gh, max_bin=B, num_slots=Ks,
                              out_slots=Kb)
        lib, rows_in = wave_yardstick(binned, slot, gh, Ks, dev)
        bound, by = bound_of(F * N_KERNEL, N_KERNEL, Kb, rows_in)
        results[("K3", Ks, hot)] = kernel_row(
            "K3", H.build_histogram_wave_hl, k, p, lib, num_slots=Ks,
            out_slots=Kb, hot_cell=hot, bound_ms=bound, bound_by=by)
        del lib
    return results


def quantized_gh(n, gen, qbins=4):
    """gh on the quantization grid (as discretize_gradients leaves it)
    and its scales."""
    scales = torch.tensor([0.0123, 0.0456])
    gi = torch.randint(-qbins // 2, qbins // 2 + 1, (n,), generator=gen)
    hi = torch.randint(0, qbins + 1, (n,), generator=gen)
    gh = torch.stack([gi * scales[0], hi * scales[1], torch.ones(n)], 1)
    return gh.to(torch.float32).contiguous(), scales


def bound_rows(S, rows_in_mask):
    """K4's (bound_ms, bound_by): rows, gh and mask read once and the
    float32 histograms written once, against one add per masked row,
    feature and channel."""
    nbytes = S * F + 4 * C * S + 4 * S + F * B * C * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows_in_mask * F * C / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# K4 shapes: (rows S, every row in one bin of every feature, every row
# in the mask).  S = 512 is one row tile; a hot segment piles every add
# onto F cells.
K4_SHAPES = [(512, False, False), (4096, False, False),
             (65536, False, False), (1 << 20, False, False),
             (65536, True, False), (4096, True, True), (65536, True, True)]


def phase_kernels_k2_k4(H, dev):
    results = {}
    for NL, hot in K2_SHAPES:
        binned, _, slot, _ = kernel_inputs(NL, dev, seed=200 + NL, hot=hot)
        gh, scales = quantized_gh(N_KERNEL,
                                  torch.Generator().manual_seed(NL))
        gh, scales = gh.to(dev), scales.to(dev)
        k = functools.partial(H.build_histogram_wave, binned, slot, gh,
                              max_bin=B, num_slots=NL, quant_bins=4,
                              quant_scales=scales)
        p = functools.partial(H.build_histogram_wave_int_plain, binned, slot,
                              gh, scales, max_bin=B, num_slots=NL)
        lib, rows_in = wave_yardstick(
            binned, slot, gh, NL, dev,
            vals_of=lambda v: torch.round(v[:, :C] / scales).to(torch.int64))
        bound, by = bound_of(F * N_KERNEL, N_KERNEL, NL, rows_in)
        results[("K2", NL, hot)] = kernel_row(
            "K2", H.build_histogram_wave_int, k, p, lib, num_slots=NL,
            hot_cell=hot, bound_ms=bound, bound_by=by)
        del lib
    for S, hot, full in K4_SHAPES:
        g = torch.Generator().manual_seed(S + hot)
        rows = torch.randint(0, B, (S, F), generator=g, dtype=torch.uint8)
        if hot:
            rows.fill_(17)
        rows = rows.to(dev)
        gh = torch.stack([torch.randn(S, generator=g),
                          torch.rand(S, generator=g) * 0.25], 1)
        gh = gh.contiguous().to(dev)
        mask = (torch.rand(S, generator=g) < 0.5) | full
        mask = mask.to(torch.float32).to(dev)
        k = functools.partial(H.build_histogram_rows_pallas, rows, gh, mask,
                              max_bin=B)
        p = functools.partial(H.build_histogram_rows_plain, rows, gh, mask,
                              max_bin=B)
        ids = (torch.arange(F, device=dev)[None, :] * B
               + rows.long()).reshape(-1)
        vals = (gh * mask[:, None]).repeat_interleave(F, dim=0)
        lib_out = torch.zeros(F * B, C, device=dev)
        lib = lambda: lib_out.index_add_(0, ids, vals)
        bound, by = bound_rows(S, int((mask != 0).sum()))
        results[("K4", S, hot, full)] = kernel_row(
            "K4", H.build_histogram_rows_pallas, k, p, lib, rows=S,
            features=F, hot_cell=hot, full_mask=full, bound_ms=bound,
            bound_by=by)
        # the engines' variant: the tree's exponents, int64 sums, no
        # helper launches
        e = H.scale_exps(gh)
        kf = functools.partial(H.build_histogram_rows_fixed, rows, gh, mask,
                               e, max_bin=B)
        same(f"K4 fixed S={S}", kf(), H.build_histogram_rows_plain(
            rows, gh, mask, max_bin=B, exps=e, fixed=True))
        total, per = device_ms(kf)
        # nothing but its kernel (and the memset of its result)
        helpers = [n for n in per if n not in ("rows_hist_kernel", "Memset")]
        if helpers:
            raise AssertionError(f"K4 fixed S={S}: launched {helpers}")
        emit({"phase": "kernel_fixed", "kernel": "K4", "rows": S,
              "hot_cell": hot, "full_mask": full, "ms": cuda_ms(kf),
              "loop_ms": loop_ms(kf), "kernel_ms": total,
              "kernel_ms_by_name": per})
        del ids, vals, lib_out
    return results


SWEEP_BUDGETS = (64 * 1024, None, 200 * 1024)   # None: the default


def phase_sweep(H, dev):
    """The streaming kernel's tile budget (K3 at 1 and 8 slots, K2's few
    route at 8) and K2's route boundary (streaming kernel against the
    partition at 4/8/16 slots), on the kernel phase's inputs: each
    variant checked bit for bit against the plain version, then its
    device time per call (torch.profiler) and event time.  Checkouts
    whose kernels predate the streaming kernel skip it."""
    if not hasattr(H, "wave_few_plan"):
        return
    for name, Ks, cb in (("K3", 1, 8), ("K3", 8, 8), ("K2", 8, 4)):
        binned, _, slot, gh = kernel_inputs(Ks, dev, seed=300 + Ks)
        Kb = H.wave_slot_pad(Ks)
        if name == "K2":
            gh, scales = quantized_gh(N_KERNEL,
                                      torch.Generator().manual_seed(Ks))
            gh, scales = gh.to(dev), scales.to(dev)
            ref = H.build_histogram_wave_int_plain(
                binned, slot, gh, scales, max_bin=B, num_slots=Ks,
                fixed=True)
        else:
            e = H.scale_exps(gh)
            ref = H.build_histogram_wave_hl_plain(
                binned, binned.t(), slot, gh, max_bin=B, num_slots=Ks,
                out_slots=Kb, exps=e, fixed=True)
        for budget in SWEEP_BUDGETS:
            budget = budget or H.FEW_TILE_BYTES
            plan = H.wave_few_plan(F, B, C, Ks, cb, budget)
            if name == "K2":
                fn = functools.partial(H._launch_wave_int, binned, slot, gh,
                                       scales, B, Ks, False, few=True,
                                       tile_budget=budget)
            else:
                fn = functools.partial(H._launch_wave_hl, binned, slot, gh,
                                       e, B, Ks, Kb, False,
                                       tile_budget=budget)
            same(f"{name} {Ks} slots, budget {budget}", fn(), ref)
            total, _ = device_ms(fn)
            emit({"phase": "sweep", "kernel": name, "num_slots": Ks,
                  "tile_budget": budget, "FG": plan.FG,
                  "tile_bytes": plan.tile_bytes,
                  "blocks_per_sm_by_smem": plan.blocks_per_sm,
                  "kernel_ms": total, "ms": cuda_ms(fn)})
    for NL in (4, 8, 16):
        binned, _, slot, _ = kernel_inputs(NL, dev, seed=400 + NL)
        gh, scales = quantized_gh(N_KERNEL, torch.Generator().manual_seed(NL))
        gh, scales = gh.to(dev), scales.to(dev)
        ref = H.build_histogram_wave_int_plain(binned, slot, gh, scales,
                                               max_bin=B, num_slots=NL,
                                               fixed=True)
        for few in (True, False):
            fn = functools.partial(H._launch_wave_int, binned, slot, gh,
                                   scales, B, NL, False, few=few)
            same(f"K2 {NL} slots, few={few}", fn(), ref)
            total, per = device_ms(fn)
            emit({"phase": "sweep", "kernel": "K2", "num_slots": NL,
                  "route": "streaming" if few else "partition",
                  "kernel_ms": total, "kernel_ms_by_name": per,
                  "ms": cuda_ms(fn), "K2_FEW_SLOTS": H.K2_FEW_SLOTS})


def launch_counts(H):
    return {"K1": H.build_histogram_wave.launches,
            "K2": H.build_histogram_wave_int.launches,
            "K3": H.build_histogram_wave_hl.launches,
            "K4": H.build_histogram_rows_pallas.launches}


def reset_counts(H):
    for fn in (H.build_histogram_wave, H.build_histogram_wave_int,
               H.build_histogram_wave_hl, H.build_histogram_rows_pallas):
        fn.launches = 0


def drive_path(lgb, H, global_timer, name, extra, iterations, data,
               after_training=None):
    """Train the bench workload with `extra` params on the card: counts
    set to 0 just before the updates and read just after; then
    `after_training(booster)`, if given; then three instrumented
    iterations for the breakdown."""
    X, y, Xte, yte = data
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              "device_type": "cuda", **extra}
    t0 = time.perf_counter()
    booster = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts(H)
    iters = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        if booster.update():
            raise AssertionError(f"{name}: training stopped early")
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t0)
    launches = launch_counts(H)
    score = auc(yte, booster.predict(Xte, raw_score=True))
    last = iters[-10:]
    emit({"phase": name, "rows": X.shape[0], "features": X.shape[1],
          "num_leaves": 255, "max_bin": 255, "params": extra,
          "iterations": iterations,
          "growth_strategy": booster._gbdt.growth_strategy,
          "setup_s": setup_s, "first_iter_s": iters[0],
          f"s_per_iter_last{len(last)}": sum(last) / len(last),
          "iter_s": iters, "heldout_auc": score,
          "num_trees": booster.num_trees(),
          "leaves_per_tree": [t.num_leaves
                              for t in booster._gbdt.models_],
          "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    if after_training is not None:
        after_training(booster)
    # where the time goes: three more iterations with the port's timer on
    # (host scopes plus CUDA-event device scopes; the timer synchronizes
    # at scope ends, so these iterations run slower than the ones above)
    global_timer.reset()
    global_timer.enabled = True
    t0 = time.perf_counter()
    for _ in range(3):
        booster.update()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    snap = global_timer.snapshot()
    global_timer.enabled = False
    emit({"phase": f"{name}_breakdown", "iterations": 3,
          "instrumented_s_per_iter": wall,
          "ms_per_iter": {k: v[0] * 1e3 / 3 for k, v in snap.items()},
          "calls_per_iter": {k: v[1] / 3 for k, v in snap.items()}})
    return launches, score, wall


def phase_paths(lgb, H, global_timer):
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    data = (X, y, Xte, yte)
    out = {}
    launches, auc_main, main_wall = drive_path(
        lgb, H, global_timer, "main_path", {}, 13, data,
        after_training=lambda b: phase_predict(b, data))
    if auc_main < 0.72:
        raise AssertionError(f"main path: held-out AUC {auc_main} < 0.72")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"main path: a kernel was not launched: "
                             f"{launches}")
    out["main_path"] = launches
    launches, auc_q, _ = drive_path(lgb, H, global_timer, "path_a_quantized",
                                 {"use_quantized_grad": True}, 13, data)
    if launches["K2"] <= 0 or launches["K1"] or launches["K3"]:
        raise AssertionError(f"path A: K2 must carry every histogram: "
                             f"{launches}")
    if abs(auc_q - auc_main) > 0.01:
        raise AssertionError(f"path A: held-out AUC {auc_q} is more than "
                             f"0.01 from the float path's {auc_main}")
    out["path_a_quantized"] = launches
    launches, auc_l, _ = drive_path(lgb, H, global_timer, "path_b_leafwise",
                                 {"tpu_growth_strategy": "leafwise"}, 13,
                                 data)
    if launches["K4"] <= 0:
        raise AssertionError(f"path B: K4 was not launched: {launches}")
    if auc_l < 0.72:
        raise AssertionError(f"path B: held-out AUC {auc_l} < 0.72")
    out["path_b_leafwise"] = launches
    return out, main_wall


def replay_early_stop(hist, rounds, min_delta, higher):
    """The early-stopping rule (callback.early_stopping) replayed over a
    recorded history: (best iteration index, stop index) or None."""
    order = [(n, m) for n in hist for m in hist[n]]
    best, best_it = {}, {}
    for i in range(len(hist[order[0][0]][order[0][1]])):
        for name, metric in order:
            if name == "training":
                continue
            v = hist[name][metric][i]
            key = (name, metric)
            if key not in best or (v > best[key] + min_delta
                                   if higher[metric]
                                   else v < best[key] - min_delta):
                best[key], best_it[key] = v, i
            elif i - best_it[key] >= rounds:
                return best_it[key], i
    return None


def phase_valid_path(lgb, H, global_timer, card, main_wall):
    """`train` with validation sets, device eval and early stopping at
    the main path's width (gates (a)-(g) of the module docstring)."""
    from lightgbm_tpu_torch.metric import AUCMetric, create_metrics
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "min_data_in_leaf": 20,
              "verbosity": -1, "device_type": "cuda",
              "metric": ["auc", "binary_logloss"],
              "early_stopping_round": 5,
              "early_stopping_min_delta": VALID_MIN_DELTA}
    # the datasets are binned before the timed run
    train_ds = lgb.Dataset(X, label=y, params=params).construct()
    valid_ds = train_ds.create_valid(Xte, label=yte).construct()
    hist = {}
    torch.cuda.synchronize()
    reset_counts(H)
    global_timer.reset()
    global_timer.enabled = True
    t0 = time.perf_counter()
    booster = lgb.train(params, train_ds, num_boost_round=100,
                        valid_sets=[train_ds, valid_ds],
                        valid_names=["training", "valid"],
                        callbacks=[lgb.record_evaluation(hist),
                                   lgb.log_evaluation(10)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = global_timer.snapshot()
    global_timer.enabled = False
    launches = launch_counts(H)
    g = booster._gbdt
    iters = booster.current_iteration()
    best = booster.best_iteration
    # (a) the training metrics ran on the card, one transfer per tick
    de = g._device_eval
    if de is None or not de.ok or g.device.type != "cuda":
        raise AssertionError("valid path: training metrics did not run "
                             "through DeviceEval on the card")
    fetches = de.fetches
    if fetches != iters or len(hist["training"]["auc"]) != iters:
        raise AssertionError(f"valid path: {fetches} transfers for "
                             f"{iters} ticks")
    # (b) the tick against the float64 host metrics on the pulled scores
    pulled = booster._inner_predict_train().astype(np.float64)
    host_train = dict(g._eval(pulled[None, :], g.train_metrics))
    tick_err = {}
    for m, v in host_train.items():
        got = hist["training"][m][-1]
        tick_err[m] = abs(got - v)
        if tick_err[m] > 2.0 ** -23 * abs(v):
            raise AssertionError(f"valid path: training {m} {got!r} from "
                                 f"the card, {v!r} on the host")
    # (c) each recorded valid AUC against predict(num_iteration=i+1)
    auc_m = AUCMetric(g.config)
    auc_m.init(g.valid_sets[0].metadata, len(yte))
    worst = 0.0
    for i in range(iters):
        s = booster.predict(Xte, num_iteration=i + 1, raw_score=True)
        ref = auc_m.eval(s.astype(np.float64))[0][1]
        worst = max(worst, abs(hist["valid"]["auc"][i] - ref))
    if worst > 1e-6:
        raise AssertionError(f"valid path: a recorded valid AUC is {worst} "
                             "from the AUC of predict(num_iteration)")
    # (d) the stop fired, where the min_delta rule puts it
    higher = {m.name: m.is_higher_better
              for m in create_metrics(g.config)}
    replay = replay_early_stop(hist, 5, VALID_MIN_DELTA, higher)
    if not (0 < best < iters <= 100) or iters - best != 5:
        raise AssertionError(f"valid path: best_iteration {best}, "
                             f"{iters} iterations run")
    if replay is None or (replay[0] + 1, replay[1] + 1) != (best, iters):
        raise AssertionError(f"valid path: the min_delta rule over the "
                             f"history gives {replay}, the run stopped at "
                             f"{iters} with best {best}")
    # (e) predict uses best_iteration
    if not np.array_equal(booster.predict(Xte),
                          booster.predict(Xte, num_iteration=best)):
        raise AssertionError("valid path: predict() differs from "
                             "predict(num_iteration=best_iteration)")
    # (f) the main path's kernels carried the histograms
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"valid path: a kernel was not launched: "
                             f"{launches}")
    # (g) a small cv on the card
    Xc, yc = make_higgs_like(60_000, 28, seed=4)
    res = lgb.cv({**params, "num_leaves": 63, "early_stopping_round": 0},
                 lgb.Dataset(Xc, label=yc), num_boost_round=5, nfold=3,
                 return_cvbooster=True)
    lens = {k: len(v) for k, v in res.items() if k != "cvbooster"}
    cvb = res.get("cvbooster")
    if (set(lens) != {"valid auc-mean", "valid auc-stdv",
                      "valid binary_logloss-mean",
                      "valid binary_logloss-stdv"}
            or set(lens.values()) != {5} or cvb is None
            or len(cvb.boosters) != 3
            or any(b._gbdt.device.type != "cuda" for b in cvb.boosters)):
        raise AssertionError(f"valid path: cv returned {lens}, {cvb}")
    # the parts of an iteration's evaluation, each alone on the final
    # model (host clock, ending in a synchronize): the training tick, the
    # valid set's host metrics, the valid traversal of the last tree
    parts_ms = {"train_tick": host_ms(g.eval_train),
                "valid_host_metrics": host_ms(lambda: g.eval_valid(0)),
                "valid_traversal": host_ms(
                    lambda: g._tree_leaf_ids(g.models_[-1], 0))}
    ms = {k: v[0] * 1e3 / iters for k, v in snap.items()}
    eval_ms = ms.get("GBDT::eval", 0.0)
    emit({"phase": "valid", "rows": X.shape[0], "valid_rows": Xte.shape[0],
          "features": X.shape[1], "num_leaves": 255, "max_bin": 255,
          "early_stopping_round": 5, "min_delta": VALID_MIN_DELTA,
          "best_iteration": best, "iterations": iters,
          "best_valid_auc": booster.best_score["valid"]["auc"],
          "best_valid_logloss": booster.best_score["valid"]["binary_logloss"],
          "ticks": iters, "fetches": fetches,
          "fetches_per_tick": fetches / iters,
          "tick_vs_host_abs_err": tick_err,
          "valid_auc_vs_predict_max_abs_err": worst,
          "eval_ms_per_iter": eval_ms,
          "train_one_iter_ms_per_iter": ms.get("GBDT::train_one_iter"),
          "eval_share": eval_ms / (wall / iters * 1e3),
          "s_per_iter_with_eval": wall / iters,
          "main_path_instrumented_s_per_iter": main_wall,
          "ms_per_iter": ms, "eval_parts_ms": parts_ms,
          "launches": launches,
          "cv_rounds": sorted(set(lens.values())),
          "cv_valid_auc_mean": res["valid auc-mean"], "nvidia_smi": card})


def host_ms(fn, reps=3):
    """Median milliseconds of fn() on the host clock, each call ending in
    a synchronize (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_predict(booster, data):
    """Batch prediction with the main path's booster after its 13 trees,
    through `Booster.predict` with default params (device_predict=auto
    on the card, float32 input): the training rows and the held-out
    rows, raw scores, leaf ids and probabilities.  The DevicePredictor
    dispatch count is set to 0 just before and read just after.  Held
    against the native host predictor (OpenMP, float64): leaf ids equal
    element for element; each raw score within 2·T·2^-24·Σ_t|leaf value|
    of its row's float64 score; held-out AUC within 1e-6.  Then rows/s
    of the card end to end (H2D and D2H included), of the card's device
    time (torch.profiler: kernels, and copies apart), of the native
    predictor and of the Python loop over the trees (50,000 rows)."""
    from lightgbm_tpu_torch.inference import DevicePredictor
    from lightgbm_tpu_torch.native import predictor_lib
    X, _, Xte, yte = data
    g = booster._gbdt
    if predictor_lib() is None:
        raise AssertionError("predict: the native host predictor did not "
                             "build")
    T = booster.num_trees()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    DevicePredictor.dispatches.clear()
    raw = booster.predict(X, raw_score=True)
    leaf = booster.predict(X, pred_leaf=True)
    raw_te = booster.predict(Xte, raw_score=True)
    leaf_te = booster.predict(Xte, pred_leaf=True)
    prob_te = booster.predict(Xte)
    dispatches = dict(DevicePredictor.dispatches)
    peak = torch.cuda.max_memory_allocated()
    if dispatches.get("cuda", 0) != 5 or dispatches.get("cpu", 0):
        raise AssertionError(f"predict: DevicePredictor dispatches "
                             f"{dispatches}, expected 5 on the card")
    dp = g._device_pred[1]
    packed = g._packed_for(0, T, 1)
    worst = {}
    for name, Xs, r, lf in (("train", X, raw, leaf),
                            ("heldout", Xte, raw_te, leaf_te)):
        X64 = Xs.astype(np.float64)
        host_leaf = packed.predict_leaf(X64)
        if not np.array_equal(lf, host_leaf):
            bad = np.argwhere(lf != host_leaf)[:3].tolist()
            raise AssertionError(f"predict {name}: card leaf ids differ "
                                 f"from the native predictor's at {bad}")
        host_raw = packed.predict(X64, 1, False)[:, 0]
        sum_abs = np.zeros(len(Xs))
        for i, t in enumerate(g.models_):
            sum_abs += np.abs(t.leaf_value[lf[:, i]])
        bound = 2.0 * T * 2.0 ** -24 * sum_abs
        err = np.abs(r.astype(np.float64) - host_raw)
        if (err > bound).any():
            i = int(np.argmax(err - bound))
            raise AssertionError(f"predict {name}: row {i} raw score "
                                 f"{r[i]!r} vs host {host_raw[i]!r}, bound "
                                 f"{bound[i]!r}")
        worst[name] = {"max_abs_err": float(err.max()),
                       "max_err_over_bound": float((err / bound).max())}
        if name == "heldout":
            auc_card, auc_host = auc(yte, r), auc(yte, host_raw)
            if abs(auc_card - auc_host) > 1e-6:
                raise AssertionError(f"predict: held-out AUC {auc_card} "
                                     f"from the card, {auc_host} on host")
            # the sigmoid's slope is at most 1/4; float32 rounds it
            perr = np.abs(prob_te - 1 / (1 + np.exp(-host_raw)))
            if (perr > bound / 4 + 2.0 ** -23).any():
                raise AssertionError("predict: held-out probabilities "
                                     "differ from the host's")
    n = X.shape[0]
    X64 = X.astype(np.float64)
    e2e_ms = host_ms(lambda: booster.predict(X, raw_score=True))
    leaf_ms = host_ms(lambda: booster.predict(X, pred_leaf=True))
    _, per = device_ms(lambda: booster.predict(X, raw_score=True), reps=3)
    copy_ms = sum(v for k, v in per.items() if k.startswith("Memcpy"))
    kern_ms = sum(v for k, v in per.items() if not k.startswith("Memcpy"))
    native_ms = host_ms(lambda: packed.predict(X64, 1, False))
    n_py = min(n, 50_000)
    Xp = X64[:n_py]

    def py_loop():
        acc = np.zeros(n_py)
        for t in g.models_:
            acc += t.predict(Xp)
        return acc
    t0 = time.perf_counter()
    py_loop()
    py_s = time.perf_counter() - t0
    emit({"phase": "predict", "trees": T, "rows": n,
          "heldout_rows": Xte.shape[0], "max_depth": dp.pack.max_depth,
          "bucket": dp.bucket_rows(n),
          "bucket_heldout": dp.bucket_rows(Xte.shape[0]),
          "dispatches": dispatches, "leaf_ids_equal_native": True,
          "score_error": worst, "heldout_auc_card": auc_card,
          "heldout_auc_host": auc_host,
          "peak_mem_gib": peak / 2**30,
          "card_e2e_ms": e2e_ms, "card_e2e_rows_per_s": n / e2e_ms * 1e3,
          "card_leaf_e2e_ms": leaf_ms,
          "card_device_ms": kern_ms + copy_ms,
          "card_kernel_ms": kern_ms, "card_copy_ms": copy_ms,
          "card_device_rows_per_s": (n / (kern_ms + copy_ms) * 1e3
                                     if per else None),
          "card_kernel_rows_per_s": n / kern_ms * 1e3 if per else None,
          "card_device_ms_by_name": per,
          "host_share": (1.0 - (kern_ms + copy_ms) / e2e_ms
                         if per else None),
          "native_ms": native_ms,
          "native_rows_per_s": n / native_ms * 1e3,
          "native_threads": len(os.sched_getaffinity(0)),
          "python_rows": n_py, "python_rows_per_s": n_py / py_s})


def phase_device_bin(lgb, global_timer):
    """Device binning at 2^21 x 28 float32 (make_higgs_like): the default
    Dataset (device_type=cuda) bins on the card, a device_type=cpu
    Dataset on the host; the bins must be equal bit for bit.  Then one
    training update on each, on the card: the device bins are padded on
    the card (no host pull) and grow the same tree."""
    from lightgbm_tpu_torch.io.device_bin import bin_matrix_device
    X, y = make_higgs_like(1 << 21, 28, seed=3)
    times = {}
    cores = {}
    for dev in ("cuda", "cpu"):
        global_timer.reset()
        global_timer.enabled = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ds = lgb.Dataset(X, label=y, params={"device_type": dev,
                                             "max_bin": 255})
        core = ds.construct()._core
        torch.cuda.synchronize()
        times[dev] = {"construct_s": time.perf_counter() - t0,
                      "binning_s": global_timer.snapshot()[
                          "Dataset::binning"][0],
                      "peak_mem_gib": torch.cuda.max_memory_allocated()
                      / 2**30}
        global_timer.enabled = False
        cores[dev] = (ds, core)
    dev_bins = cores["cuda"][1].binned
    if not (isinstance(dev_bins, torch.Tensor)
            and dev_bins.device.type == "cuda"):
        raise AssertionError("device_bin: the cuda dataset did not bin on "
                             "the card")
    if not np.array_equal(dev_bins.cpu().numpy(), cores["cpu"][1].binned):
        raise AssertionError("device_bin: card bins differ from host bins")
    core = cores["cpu"][1]
    pass_ms = host_ms(lambda: bin_matrix_device(
        X, core.bin_mappers, core.used_features, "cuda"))
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.1, "max_bin": 255, "min_data_in_leaf": 20,
              "verbosity": -1, "device_type": "cuda"}
    texts = {}
    for dev, (ds, core) in cores.items():
        b = lgb.Booster(params=params, train_set=ds)
        b.update()
        texts[dev] = b.model_to_string()
        if dev == "cuda" and (core.binned is not b._gbdt.binned_dev
                              or core._efb_sample_bins is None):
            raise AssertionError("device_bin: GBDT.init did not keep the "
                                 "device bins on the card")
    if texts["cuda"] != texts["cpu"]:
        raise AssertionError("device_bin: device-binned data grew another "
                             "tree than host-binned data")
    emit({"phase": "device_bin", "rows": X.shape[0], "features": X.shape[1],
          "bins_equal_host": True, "first_tree_equal": True,
          "card": times["cuda"], "host": times["cpu"],
          "card_second_pass_ms": pass_ms})


def phase_card_vs_cpu(lgb, name, extra):
    X, y = make_higgs_like(65_536, 28, seed=2)
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              **extra}
    models = {}
    for dev in ("cuda", "cpu"):
        b = lgb.train({**params, "device_type": dev},
                      lgb.Dataset(X, label=y), num_boost_round=3)
        models[dev] = b._gbdt.models_
    worst = 0.0
    for i, (a, b) in enumerate(zip(models["cuda"], models["cpu"])):
        ni = a.num_leaves - 1
        same = (a.num_leaves == b.num_leaves
                and np.array_equal(a.split_feature[:ni], b.split_feature[:ni])
                and np.array_equal(a.threshold[:ni], b.threshold[:ni]))
        if not same:
            diff = [j for j in range(min(a.num_leaves, b.num_leaves) - 1)
                    if (a.split_feature[j], a.threshold[j])
                    != (b.split_feature[j], b.threshold[j])][:3]
            raise AssertionError(
                f"{name} tree {i}: card and CPU trees differ at nodes {diff}: "
                + "; ".join(f"card f{a.split_feature[j]}<={a.threshold[j]!r} "
                            f"gain {a.split_gain[j]!r}, cpu "
                            f"f{b.split_feature[j]}<={b.threshold[j]!r} "
                            f"gain {b.split_gain[j]!r}" for j in diff))
        lv_a, lv_b = a.leaf_value[:ni + 1], b.leaf_value[:ni + 1]
        if not np.allclose(lv_a, lv_b, rtol=1e-4, atol=0.0):
            raise AssertionError(f"{name} tree {i}: leaf values differ")
        worst = max(worst, float(np.max(np.abs(lv_a - lv_b)
                                        / np.maximum(np.abs(lv_b), 1e-30))))
    if len(models["cuda"]) != 3 or len(models["cpu"]) != 3:
        raise AssertionError(f"{name}: card/CPU tree counts differ from 3")
    emit({"phase": "card_vs_cpu", "path": name, "params": extra,
          "rows": 65_536, "trees": 3,
          "leaves": [t.num_leaves for t in models["cuda"]],
          "max_rel_leaf_diff": worst})


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import _kernels
    from lightgbm_tpu_torch.utils.timer import global_timer
    from lightgbm_tpu_torch.ops import histogram as H

    dev = torch.device("cuda", 0)
    card = card_line()
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": card})

    t0 = time.perf_counter()
    _kernels.build_all()
    for src in _kernels.SOURCES:
        _kernels.lib(src)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_kernels.SOURCES)})
    if kernels_only:
        phase_kernels(H, dev)
        phase_kernels_k2_k4(H, dev)
        phase_sweep(H, dev)
        print(card, flush=True)
        return 0
    # per kernel: registers, shared memory, stack and spills (ptxas -v)
    # and the atomic opcodes of its SASS (ATOMS.CAST.SPIN is a CAS loop)
    for src in _kernels.SOURCES:
        usage = _kernels.resource_usage(src)
        atomics = _kernels.sass_atomics(src)
        emit({"phase": "resources", "source": src, "kernels": {
            re.sub(r"^_ZN\w*?_cu_[0-9a-f]+\d+", "", fn): {
                **usage.get(fn, {}), "sass_atomics": atomics.get(fn, [])}
            for fn in sorted(set(usage) | set(atomics))}})
        cas = sorted(fn for fn, ops in atomics.items()
                     if any(op.startswith("ATOMS.CAST") for op in ops))
        if cas:
            raise AssertionError(f"{src}: compare-and-swap shared atomics "
                                 f"(ATOMS.CAST) in {cas}")

    launches, main_wall = phase_paths(lgb, H, global_timer)
    phase_valid_path(lgb, H, global_timer, card, main_wall)
    phase_device_bin(lgb, global_timer)
    for name, extra in (("main_path", {}),
                        ("path_a_quantized", {"use_quantized_grad": True}),
                        ("path_b_leafwise",
                         {"tpu_growth_strategy": "leafwise"})):
        phase_card_vs_cpu(lgb, name, extra)
    per_shape = phase_kernels(H, dev)
    per_shape.update(phase_kernels_k2_k4(H, dev))
    phase_sweep(H, dev)

    csrc = "lightgbm_tpu_torch/ops/csrc/"
    hist_py = "lightgbm_tpu/ops/histogram.py"
    entries = []
    for name, key, path, src, replaces in (
            ("K1 slot-partitioned wave_part_hist_kernel<FixedCells> "
             "(build_histogram_wave)", ("K1", 256, False, N_KERNEL),
             "main_path", "wave_hist.cu",
             f"{hist_py}:147 _wave_kernel (fp32), called at :499"),
            ("K2 wave_few_kernel<IntCells> up to K2_FEW_SLOTS slots, "
             "slot-partitioned wave_part_hist_kernel<IntCells> above "
             "(build_histogram_wave, quant_scales)", ("K2", 256, False),
             "path_a_quantized", "wave_hist.cu",
             f"{hist_py}:147 _wave_kernel (int8 mode, :462-469, :517-520)"),
            ("K3 wave_few_kernel<FixedCells> (build_histogram_wave_hl)",
             ("K3", 8, False), "main_path", "wave_hist.cu",
             f"{hist_py}:237 _wave_kernel_hl, called at :369"),
            ("K4 rows_hist_kernel (build_histogram_rows_pallas)",
             ("K4", 1 << 20, False, False), "path_b_leafwise",
             "rows_hist.cu",
             f"{hist_py}:94 _hist_pallas_kernel, called at :136")):
        r = per_shape[key]
        shape = ({"n": N_KERNEL, "F": F, "B": B, "C": C,
                  "num_slots": key[1]} if key[0] != "K4"
                 else {"S": key[1], "F": F, "B": B, "C": C})
        entries.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": launches[path][key[0]],
            "launches_path": path,
            "max_abs_err": max(v["max_abs_err"] for k, v in per_shape.items()
                               if k[0] == key[0]),
            "ms": r["ms"], "kernel_ms": r["kernel_ms"],
            "loop_ms": r["loop_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "status": "ported",
            "shape": shape})
        if key[0] == "K2":    # the streaming route at 8 slots
            few = per_shape[("K2", 8, False)]
            entries[-1]["few_slot_route"] = {
                k: few[k] for k in ("num_slots", "ms", "kernel_ms",
                                    "plain_ms", "library_ms", "bound_ms")}
    emit({"kernels": entries, "launches_by_path": launches})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
