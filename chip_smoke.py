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
  5c. sampling: the main path's workload (1M x 28, 255 leaves, 255
     bins, 13 iterations, held-out AUC on the 100k rows) with (a)
     bagging_fraction=0.8, bagging_freq=1, feature_fraction=0.8 on the
     wave engine; (b) data_sample_strategy=goss,
     feature_fraction_bynode=0.8 on the wave engine (at learning_rate 0.1
     GOSS samples from iteration 10 on, the line says so); (c)
     extra_trees=true with (a)'s bagging on the leaf-wise engine; (d)
     (a) with use_quantized_grad=true (K2 under bagging).  Gates: K1 and
     K3 launched for (a) and (b), K4 for (c), K2 for (d); each
     iteration's in-bag count int(n * 0.8) for (a), (c) and (d); every
     split feature of a tree of (a) and (d) inside that tree's column
     mask (the NumPy draws replayed here); held-out AUC >= 0.72 for (a),
     (b) and (d), >= 0.715 for (c) (a CPU rehearsal at 125,000 rows gave
     0.72459, PERF.md).  One
     `sampling` line per run: s/iter of iterations 4-13 beside the main
     path's, `GBDT::bagging` and `GBDT::col_sampling` ms/iter (from the
     breakdown iterations), AUC, launches, in-bag counts, the card's
     name and power limit;
  5d. continue: 7 rounds of (a) through `train`, then 6 more with
     `init_model=<the first booster's model text>`,
     `keep_training_booster=True` and the 100k rows as a valid set
     (metric auc).  Gates: 13 trees, the first 7 with the init model's
     text; held-out AUC >= 0.72; the first recorded valid AUC within 1e-6
     of the AUC of predict(num_iteration=8) (the valid scores were
     seeded from the init model); K1 and K3 launched by the continued
     run (the counts set to 0 after the 7 init rounds).  Then
     rollback_one_iter(): 12 trees, and predict equal bit for bit to the
     unrolled booster's predict(num_iteration=12).  One `continue` line;
  5e. split_features: three runs of the main path's workload (13
     iterations, held-out AUC on the 100k rows), each driven like the
     paths: `categorical`, columns 0, 1 and 3 replaced by category codes
     (each its equal-frequency bucket index, 32, 3 and 200 buckets, put
     through RandomState(7).permutation(K); column 1 one-hot, 0 and 3
     sorted-subset; 1% of column 3 NaN) passed as categorical_feature,
     the 100k rows as a valid set (metric auc); `monotone`,
     monotone_constraints sign(w) on features 2, 5 and 8 (w the data's
     weights); `smooth_cegb`, path_smooth=1.0, cegb_penalty_split=1e-5
     and a coupled penalty of 2e-4 x rows on every feature.  Gates: K1
     and K3 launched in each; categorical: categorical splits in the
     model, card leaf ids equal the native predictor's on all 1.1M rows
     and raw scores within the predict phase's bound, the recorded valid
     AUC within 1e-6 of the AUC of predict, the model text reloads to
     bit-equal predictions, held-out AUC >= CAT_AUC_MIN (chip_rehearsal.py
     at 1/8 of the rows, less 0.01); monotone: each constrained feature
     swept over 64 values in 1,000 held-out rows gives monotone
     predictions exactly; smooth_cegb: its first 13 trees split on fewer
     distinct features than the main path's.  One `split_features` line
     per run (emitted after the card-vs-CPU phase): s/iter of iterations
     4-13 and `Tree::split_find::device` ms/iter beside the main path's,
     scan calls per tree and launches of one scan (torch.profiler
     traces of the run's last scan, replayed after every path has run),
     launches, peak GiB, AUC;
  6. card against CPU: `train` at 65,536 rows, 3 iterations, on "cuda"
     and "cpu", for the main path, paths A and B, sampling runs (a), (b)
     at learning_rate 0.5 (GOSS samples from iteration 2), (c), and (a)
     with use_quantized_grad=true (K2 on a sampling path, gated); then on
     the categorical run's transform of the data: the wave engine (K1,
     K3 gated), extra_trees on the leaf-wise engine (K4), quantized (K2),
     and monotone + path_smooth + CEGB on the leaf-wise engine (K4): the
     same split features, thresholds, decision types and category sets
     in every tree, leaf values within rtol 1e-4; the card run's launch
     counts in each line;
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
               after_training=None, after_update=None, dataset_kw=None,
               before_training=None):
    """Train the bench workload with `extra` params on the card
    (`dataset_kw` to its Dataset; `before_training(booster)`, if given,
    runs before the counts are set): counts set to 0 just before the
    updates and read just after (`after_update(booster)`, if given, runs
    after each update, outside its time); then `after_training(booster)`,
    if given; then three instrumented iterations for the breakdown.
    Returns a dict: launches, auc, s_per_iter (iterations 4-13),
    instrumented wall s/iter and the breakdown's ms per iteration."""
    X, y, Xte, yte = data
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              "device_type": "cuda", **extra}
    t0 = time.perf_counter()
    booster = lgb.Booster(params=params, train_set=lgb.Dataset(
        X, label=y, **(dataset_kw or {})))
    if before_training is not None:
        before_training(booster)
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
        if after_update is not None:
            after_update(booster)
    launches = launch_counts(H)
    peak = torch.cuda.max_memory_allocated() / 2**30
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
          "launches": launches, "peak_mem_gib": peak})
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
    ms_per_iter = {k: v[0] * 1e3 / 3 for k, v in snap.items()}
    emit({"phase": f"{name}_breakdown", "iterations": 3,
          "instrumented_s_per_iter": wall, "ms_per_iter": ms_per_iter,
          "calls_per_iter": {k: v[1] / 3 for k, v in snap.items()}})
    return {"launches": launches, "auc": score, "wall": wall,
            "s_per_iter": sum(last) / len(last), "ms_per_iter": ms_per_iter,
            "booster": booster, "peak_gib": peak}


def phase_paths(lgb, H, global_timer, probe):
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    data = (X, y, Xte, yte)
    out = {}
    probe.reset()
    r = drive_path(lgb, H, global_timer, "main_path", {}, 13, data,
                   after_training=lambda b: phase_predict(b, data))
    calls = probe.keep("main_path")
    launches, auc_main, main_wall = r["launches"], r["auc"], r["wall"]
    main = {"s_per_iter": r["s_per_iter"], "ms_per_iter": r["ms_per_iter"],
            "auc": auc_main,
            "scan_calls_per_tree": calls / len(r["booster"]._gbdt.models_),
            "features": distinct_features(r["booster"]._gbdt.models_[:13])}
    del r
    if auc_main < 0.72:
        raise AssertionError(f"main path: held-out AUC {auc_main} < 0.72")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"main path: a kernel was not launched: "
                             f"{launches}")
    out["main_path"] = launches
    r = drive_path(lgb, H, global_timer, "path_a_quantized",
                   {"use_quantized_grad": True}, 13, data)
    launches, auc_q = r["launches"], r["auc"]
    if launches["K2"] <= 0 or launches["K1"] or launches["K3"]:
        raise AssertionError(f"path A: K2 must carry every histogram: "
                             f"{launches}")
    if abs(auc_q - auc_main) > 0.01:
        raise AssertionError(f"path A: held-out AUC {auc_q} is more than "
                             f"0.01 from the float path's {auc_main}")
    out["path_a_quantized"] = launches
    r = drive_path(lgb, H, global_timer, "path_b_leafwise",
                   {"tpu_growth_strategy": "leafwise"}, 13, data)
    launches, auc_l = r["launches"], r["auc"]
    if launches["K4"] <= 0:
        raise AssertionError(f"path B: K4 was not launched: {launches}")
    if auc_l < 0.72:
        raise AssertionError(f"path B: held-out AUC {auc_l} < 0.72")
    out["path_b_leafwise"] = launches
    return out, main_wall, main


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


def hold_to_native(g, what, Xs, r, lf):
    """Card leaf ids `lf` and raw scores `r` of rows `Xs` against the
    native host predictor (OpenMP, float64): leaf ids equal element for
    element, each raw score within 2·T·2^-24·Σ_t|leaf value| of its row's
    float64 score.  Returns (errors, host raw scores, bounds)."""
    T = len(g.models_)
    packed = g._packed_for(0, T, 1)
    X64 = Xs.astype(np.float64)
    host_leaf = packed.predict_leaf(X64)
    if not np.array_equal(lf, host_leaf):
        bad = np.argwhere(lf != host_leaf)[:3].tolist()
        raise AssertionError(f"{what}: card leaf ids differ from the "
                             f"native predictor's at {bad}")
    host_raw = packed.predict(X64, 1, False)[:, 0]
    sum_abs = np.zeros(len(Xs))
    for i, t in enumerate(g.models_):
        sum_abs += np.abs(t.leaf_value[lf[:, i]])
    bound = 2.0 * T * 2.0 ** -24 * sum_abs
    err = np.abs(r.astype(np.float64) - host_raw)
    if (err > bound).any():
        i = int(np.argmax(err - bound))
        raise AssertionError(f"{what}: row {i} raw score {r[i]!r} vs host "
                             f"{host_raw[i]!r}, bound {bound[i]!r}")
    return ({"max_abs_err": float(err.max()),
             "max_err_over_bound": float((err / bound).max())},
            host_raw, bound)


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
        worst[name], host_raw, bound = hold_to_native(
            g, f"predict {name}", Xs, r, lf)
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


BAG = {"bagging_fraction": 0.8, "bagging_freq": 1}
SAMPLING_RUNS = (
    # (name, params, kernels that must launch, held-out AUC bound)
    ("sampling_a_bagging", {**BAG, "feature_fraction": 0.8}, ("K1", "K3"),
     0.72),
    ("sampling_b_goss", {"data_sample_strategy": "goss",
                         "feature_fraction_bynode": 0.8}, ("K1", "K3"),
     0.72),
    ("sampling_c_extra_trees", {**BAG, "extra_trees": True,
                                "tpu_growth_strategy": "leafwise"},
     ("K4",), 0.715),
    ("sampling_d_quantized_bagging", {**BAG, "feature_fraction": 0.8,
                                      "use_quantized_grad": True},
     ("K2",), 0.72))


def phase_sampling(lgb, H, global_timer, card, main_s):
    """Row and column sampling at the main path's width (runs (a)-(d) of
    the module docstring), each driven like the paths; one `sampling`
    line per run.  Returns the launches of each run."""
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    data = (X, y, Xte, yte)
    n = X.shape[0]
    out = {}
    for name, extra, kernels, auc_min in SAMPLING_RUNS:
        in_bag = []
        r = drive_path(lgb, H, global_timer, name, extra, 13, data,
                       after_update=lambda b: in_bag.append(
                           int(b._gbdt._bag_mask_host[:n].sum())))
        launches, g = r["launches"], r["booster"]._gbdt
        if any(launches[k] <= 0 for k in kernels):
            raise AssertionError(f"{name}: {kernels} must launch: {launches}")
        if "bagging_fraction" in extra and set(in_bag) != {int(n * 0.8)}:
            raise AssertionError(f"{name}: in-bag counts {in_bag}, not "
                                 f"{int(n * 0.8)} each iteration")
        if r["auc"] < auc_min:
            raise AssertionError(f"{name}: held-out AUC {r['auc']} < "
                                 f"{auc_min}")
        line = {"phase": "sampling", "run": name, "rows": n,
                "params": extra, "iterations": 13,
                "s_per_iter_4_13": r["s_per_iter"],
                "main_path_s_per_iter_4_13": main_s,
                "bagging_ms_per_iter": r["ms_per_iter"].get("GBDT::bagging"),
                "col_sampling_ms_per_iter": r["ms_per_iter"].get(
                    "GBDT::col_sampling"),
                "instrumented_s_per_iter": r["wall"],
                "heldout_auc": r["auc"], "auc_min": auc_min,
                "launches": launches, "in_bag": in_bag, "card": card}
        if "feature_fraction" in extra:
            # replay the per-tree column draws: every split feature of a
            # tree lies in that tree's mask
            rng = np.random.RandomState(g.config.feature_fraction_seed)
            F = g.train_data.num_features
            cnt = max(1, int(round(F * extra["feature_fraction"])))
            for i, t in enumerate(g.models_):
                mask = np.zeros(F, bool)
                mask[rng.choice(F, cnt, replace=False)] = True
                used = t.split_feature_inner[:t.num_leaves - 1]
                if not mask[used].all():
                    raise AssertionError(f"{name}: tree {i} splits on a "
                                         "feature outside its column mask")
            line["trees_within_col_mask"] = len(g.models_)
        if extra.get("data_sample_strategy") == "goss":
            # no sampling for the first 1 / learning_rate iterations
            line["goss_samples_from_iteration"] = int(
                1.0 / g.config.learning_rate)
        emit(line)
        out[name] = launches
        del r, g
    return out


def phase_continue(lgb, H, global_timer, card):
    """Continued training and rollback at the main path's width, run (a)'s
    params: 7 rounds, then 6 more from the first booster's model text
    with a valid set, the timer on (the line's `continue_ms_by_scope`:
    `GBDT::continue_from` is the seeding), then one rollback (gates in
    the module docstring)."""
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              "device_type": "cuda", "metric": "auc",
              **SAMPLING_RUNS[0][1]}
    t0 = time.perf_counter()
    b1 = lgb.train(params, lgb.Dataset(X, label=y), 7)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    text = b1.model_to_string()
    hist = {}
    # the continued run's own launches
    reset_counts(H)
    # the timer on for the continued run: the seeding's own scope
    global_timer.reset()
    global_timer.enabled = True
    t0 = time.perf_counter()
    b2 = lgb.train(params, lgb.Dataset(X, label=y), 6, init_model=text,
                   keep_training_booster=True,
                   valid_sets=[lgb.Dataset(Xte, label=yte)],
                   callbacks=[lgb.record_evaluation(hist)])
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    snap = global_timer.snapshot()
    global_timer.enabled = False
    launches = launch_counts(H)
    g = b2._gbdt
    if b2.num_trees() != 13 or g.num_init_iteration_ != 7:
        raise AssertionError(f"continue: {b2.num_trees()} trees, "
                             f"{g.num_init_iteration_} init iterations")
    if ([t.to_string(i) for i, t in enumerate(g.models_[:7])]
            != [t.to_string(i) for i, t in enumerate(b1._gbdt.models_)]):
        raise AssertionError("continue: the first 7 trees' text differs "
                             "from the init model's")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"continue: K1/K3 not launched: {launches}")
    score = auc(yte, b2.predict(Xte, raw_score=True))
    if score < 0.72:
        raise AssertionError(f"continue: held-out AUC {score} < 0.72")
    first = hist["valid_0"]["auc"][0]
    want = auc(yte, b2.predict(Xte, num_iteration=8, raw_score=True))
    if abs(first - want) > 1e-6:
        raise AssertionError(f"continue: the first recorded valid AUC "
                             f"{first} is not predict(num_iteration=8)'s "
                             f"{want}: the valid scores were not seeded")
    p12 = b2.predict(Xte, num_iteration=12)
    b2.rollback_one_iter()
    if b2.num_trees() != 12:
        raise AssertionError(f"rollback: {b2.num_trees()} trees, not 12")
    if not np.array_equal(b2.predict(Xte), p12):
        raise AssertionError("rollback: predict differs from the unrolled "
                             "booster's predict(num_iteration=12)")
    emit({"phase": "continue", "rows": X.shape[0], "params": params,
          "init_iterations": 7, "continued_iterations": 6,
          "init_train_s": t_init, "continue_train_s": t_cont,
          "continue_ms_by_scope": {k: v[0] * 1e3 for k, v in snap.items()
                                   if k in ("GBDT::continue_from",
                                            "Dataset::binning",
                                            "GBDT::train_one_iter",
                                            "GBDT::eval")},
          "heldout_auc": score,
          "first_valid_auc": first, "predict_8_auc": want,
          "first_valid_auc_diff": abs(first - want),
          "trees_after_rollback": b2.num_trees(),
          "launches": launches, "launches_of": "the 6 continued rounds",
          "card": card})
    return launches


# columns of the categorical run, their bucket counts (column 1: one-hot
# mode at max_cat_to_onehot=4; columns 0 and 3: sorted-subset mode)
CAT_COLUMNS = (0, 1, 3)
CAT_BUCKETS = (32, 3, 200)
MONOTONE_FEATURES = (2, 5, 8)   # uniform features outside the interaction
CEGB_PENALTY_SPLIT = 1e-5
CEGB_COUPLED_PER_ROW = 2e-4     # coupled penalty = this x training rows
# the categorical run's held-out AUC gate: 0.70201 in the CPU rehearsal
# at 1/8 of the rows (chip_rehearsal.py), less 0.01 for the noise of the
# smaller sets
CAT_AUC_MIN = 0.692


def categorical_transform(*mats):
    """Columns 0, 1 and 3 become category codes: each column's
    equal-frequency bucket index (32, 3 and 200 buckets, edges from the
    first matrix's quantiles) put through
    np.random.RandomState(7).permutation(K), so that the codes' order
    carries no signal; 1% of column 3 NaN (its own draw per matrix)."""
    base = mats[0]
    edges = [np.quantile(base[:, c], np.linspace(0, 1, k + 1)[1:-1])
             for c, k in zip(CAT_COLUMNS, CAT_BUCKETS)]
    perms = [np.random.RandomState(7).permutation(k) for k in CAT_BUCKETS]
    out = []
    for i, M in enumerate(mats):
        M = M.copy()
        for c, e, p in zip(CAT_COLUMNS, edges, perms):
            M[:, c] = p[np.searchsorted(e, M[:, c], side="right")]
        M[np.random.RandomState(11 + i).rand(len(M)) < 0.01, 3] = np.nan
        out.append(M)
    return out


def monotone_signs():
    """sign(w) on MONOTONE_FEATURES, w make_higgs_like's weights."""
    w = np.random.RandomState(1234).randn(F) / np.sqrt(F)
    mc = [0] * F
    for f in MONOTONE_FEATURES:
        mc[f] = int(np.sign(w[f]))
    return mc


class ScanProbe:
    """Counts the split scan's calls (one per wave on the wave engine) and
    keeps each run's last call, so that its launches can be counted later
    by a replay under torch.profiler (after every path has run)."""

    def __init__(self):
        from lightgbm_tpu_torch.learner import grow, wave
        self.fn = wave.find_best_split
        self.calls, self.last, self.kept = 0, None, {}

        def probed(*a, **k):
            self.calls += 1
            self.last = (a, k)
            return self.fn(*a, **k)
        grow.find_best_split = wave.find_best_split = probed

    def reset(self):
        self.calls, self.last = 0, None

    def keep(self, run):
        """File the last call under `run`; returns the calls so far."""
        self.kept[run] = self.last
        calls, self.calls, self.last = self.calls, 0, None
        return calls

    def launches(self, reps=5, tries=3):
        """{run: device launches (kernels, copies, memsets) of one scan},
        None where no trace holds a device record.  A trace may lose
        records: each counts `reps` replays of the run's last scan, a
        name's launches per scan are its count / reps rounded, and the
        most of `tries` traces is kept."""
        out = {}
        act = [torch.profiler.ProfilerActivity.CUDA]
        for run, (a, k) in self.kept.items():
            self.fn(*a, **k)
            torch.cuda.synchronize()
            best = 0
            for _ in range(tries):
                with torch.profiler.profile(activities=act) as prof:
                    for _ in range(reps):
                        self.fn(*a, **k)
                    torch.cuda.synchronize()
                n = 0
                for ev in prof.key_averages():
                    t = getattr(ev, "device_time_total", None)
                    if t is None:
                        t = getattr(ev, "cuda_time_total", 0)
                    if t and ev.count:
                        n += max(1, round(ev.count / reps))
                best = max(best, n)
            out[run] = best or None
        return out


def distinct_features(models):
    return sorted({int(f) for t in models
                   for f in t.split_feature[:t.num_leaves - 1]})


def phase_split_features(lgb, H, global_timer, card, main, probe):
    """The split scan's categorical, monotone and smoothing/CEGB branches
    at the main path's width (runs and gates in the module docstring).
    Returns ({run: launches}, {run: line}); the lines are emitted after
    the scan launches are counted."""
    from lightgbm_tpu_torch.metric import AUCMetric
    X0, y = make_higgs_like(1_000_000, 28)
    Xte0, yte = make_higgs_like(100_000, 28, seed=1)
    n = X0.shape[0]
    Xc, Xtec = categorical_transform(X0, Xte0)
    mc = monotone_signs()
    coupled = CEGB_COUPLED_PER_ROW * n
    runs = (
        ("categorical", {"metric": "auc"}, (Xc, y, Xtec, yte),
         {"categorical_feature": list(CAT_COLUMNS)}),
        ("monotone", {"monotone_constraints": mc}, (X0, y, Xte0, yte), {}),
        ("smooth_cegb", {"path_smooth": 1.0,
                         "cegb_penalty_split": CEGB_PENALTY_SPLIT,
                         "cegb_penalty_feature_coupled": [coupled] * F},
         (X0, y, Xte0, yte), {}))
    launches, lines = {}, {}
    for name, extra, data, ds_kw in runs:
        X, _, Xte, _ = data
        valid = {}

        def add_valid(b):
            valid["ds"] = lgb.Dataset(Xte, label=yte)
            b.add_valid(valid["ds"], "heldout")

        probe.reset()
        r = drive_path(lgb, H, global_timer, f"split_features_{name}", extra,
                       13, data, dataset_kw=ds_kw,
                       before_training=(add_valid if name == "categorical"
                                        else None))
        calls = probe.keep(name)
        b, g = r["booster"], r["booster"]._gbdt
        lc = r["launches"]
        if lc["K1"] <= 0 or lc["K3"] <= 0:
            raise AssertionError(f"{name}: K1/K3 not launched: {lc}")
        trees = len(g.models_)          # 13 counted + 3 breakdown trees
        line = {"phase": "split_features", "run": name, "rows": n,
                "params": extra, "iterations": 13,
                "s_per_iter_4_13": r["s_per_iter"],
                "main_path_s_per_iter_4_13": main["s_per_iter"],
                "split_find_device_ms_per_iter": r["ms_per_iter"].get(
                    "Tree::split_find::device"),
                "main_path_split_find_device_ms_per_iter": main[
                    "ms_per_iter"].get("Tree::split_find::device"),
                "scan_calls_per_tree": calls / trees,
                "instrumented_s_per_iter": r["wall"],
                "peak_mem_gib": r["peak_gib"], "heldout_auc": r["auc"],
                "main_path_heldout_auc": main["auc"], "launches": lc,
                "leaves_per_tree": [t.num_leaves for t in g.models_],
                "prune": (g.grow_params.wave_prune
                          and not g.grow_params.split.has_monotone
                          and not g.grow_params.split.has_cegb),
                "card": card}
        if name == "categorical":
            ncat = sum(t.num_cat for t in g.models_)
            if ncat == 0:
                raise AssertionError("categorical: no categorical split")
            T = len(g.models_)
            errs = {}
            for what, Xs in (("train", X), ("heldout", Xte)):
                errs[what], _, _ = hold_to_native(
                    g, f"categorical {what}", Xs,
                    b.predict(Xs, raw_score=True), b.predict(Xs,
                                                             pred_leaf=True))
            # the valid AUC recorded through the bin-space traversal of
            # categorical nodes, against the AUC of predict
            rec = [v for _, m, v, _ in b.eval_valid() if m == "auc"][0]
            auc_m = AUCMetric(g.config)
            auc_m.init(g.valid_sets[0].metadata, len(yte))
            want = auc_m.eval(b.predict(Xte, raw_score=True).astype(
                np.float64))[0][1]
            if abs(rec - want) > 1e-6:
                raise AssertionError(f"categorical: valid AUC {rec} is not "
                                     f"predict's {want}")
            re_b = lgb.Booster(model_str=b.model_to_string())
            if not np.array_equal(re_b.predict(Xte), b.predict(Xte)):
                raise AssertionError("categorical: the reloaded model text "
                                     "predicts other scores")
            if r["auc"] < CAT_AUC_MIN:
                raise AssertionError(f"categorical: held-out AUC {r['auc']} "
                                     f"< {CAT_AUC_MIN}")
            line.update(categorical_splits=ncat, trees=T,
                        leaf_ids_equal_native_rows=n + len(Xte),
                        score_error=errs, valid_auc_recorded=rec,
                        valid_auc_predict=want, auc_min=CAT_AUC_MIN,
                        reload_bit_equal=True)
        elif name == "monotone":
            # each constrained feature swept over 64 values in 1,000
            # held-out rows: predictions monotone exactly
            rows = Xte[:1000]
            worst = {}
            for f in MONOTONE_FEATURES:
                grid = np.linspace(X[:, f].min(), X[:, f].max(), 64,
                                   dtype=np.float32)
                Xs = np.repeat(rows, 64, axis=0)
                Xs[:, f] = np.tile(grid, len(rows))
                pred = b.predict(Xs, raw_score=True).reshape(len(rows), 64)
                steps = np.diff(pred.astype(np.float64), axis=1) * mc[f]
                bad = int((steps < 0).sum())
                if bad:
                    raise AssertionError(f"monotone: {bad} steps against "
                                         f"the constraint of feature {f}")
                worst[f] = float(np.abs(pred[:, -1] - pred[:, 0]).mean())
            line.update(monotone_constraints=mc, sweep_rows=len(rows),
                        sweep_values=64, mean_abs_sweep_change=worst)
        else:
            used = distinct_features(g.models_[:13])
            if len(used) >= len(main["features"]):
                raise AssertionError(f"smooth_cegb: {len(used)} distinct "
                                     f"features, the main path "
                                     f"{len(main['features'])}")
            line.update(distinct_features=len(used),
                        main_path_distinct_features=len(main["features"]),
                        features=used, coupled_penalty=coupled)
        launches[f"split_features_{name}"] = lc
        lines[name] = line
        del r, b, g
    return launches, lines


def phase_card_vs_cpu(lgb, H, name, extra, categorical=False):
    """`train` at 65,536 rows, 3 iterations, on the card and the CPU
    (`categorical`: the split_features phase's transform of the data,
    columns 0, 1 and 3 as `categorical_feature`): the same trees, category
    sets included.  Returns the card run's launches."""
    X, y = make_higgs_like(65_536, 28, seed=2)
    ds_kw = {}
    if categorical:
        X, = categorical_transform(X)
        ds_kw = {"categorical_feature": list(CAT_COLUMNS)}
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              **extra}
    models = {}
    for dev in ("cuda", "cpu"):
        reset_counts(H)
        b = lgb.train({**params, "device_type": dev},
                      lgb.Dataset(X, label=y, **ds_kw), num_boost_round=3)
        models[dev] = b._gbdt.models_
        if dev == "cuda":
            launches = launch_counts(H)
    worst = 0.0
    cat_nodes = 0
    for i, (a, b) in enumerate(zip(models["cuda"], models["cpu"])):
        ni = a.num_leaves - 1
        # on a categorical node `threshold` is the index of its category
        # set: the sets themselves are compared too
        same = (a.num_leaves == b.num_leaves
                and np.array_equal(a.split_feature[:ni], b.split_feature[:ni])
                and np.array_equal(a.threshold[:ni], b.threshold[:ni])
                and np.array_equal(a.decision_type[:ni],
                                   b.decision_type[:ni])
                and a.cat_boundaries == b.cat_boundaries
                and a.cat_threshold == b.cat_threshold)
        cat_nodes += a.num_cat
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
    if categorical and cat_nodes == 0:
        raise AssertionError(f"{name}: no categorical split to compare")
    emit({"phase": "card_vs_cpu", "path": name, "params": extra,
          "rows": 65_536, "trees": 3, "categorical": categorical,
          "categorical_nodes": cat_nodes,
          "leaves": [t.num_leaves for t in models["cuda"]],
          "max_rel_leaf_diff": worst, "card_launches": launches})
    return launches


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

    probe = ScanProbe()
    launches, main_wall, main = phase_paths(lgb, H, global_timer, probe)
    phase_valid_path(lgb, H, global_timer, card, main_wall)
    phase_device_bin(lgb, global_timer)
    launches.update(phase_sampling(lgb, H, global_timer, card,
                                   main["s_per_iter"]))
    launches["continue"] = phase_continue(lgb, H, global_timer, card)
    sf_launches, sf_lines = phase_split_features(lgb, H, global_timer, card,
                                                 main, probe)
    launches.update(sf_launches)
    sampling_a, sampling_b, sampling_c = (r[1] for r in SAMPLING_RUNS[:3])
    for name, extra in (("main_path", {}),
                        ("path_a_quantized", {"use_quantized_grad": True}),
                        ("path_b_leafwise",
                         {"tpu_growth_strategy": "leafwise"}),
                        ("sampling_a_bagging", sampling_a),
                        ("sampling_b_goss_lr0.5",
                         {**sampling_b, "learning_rate": 0.5}),
                        ("sampling_c_extra_trees", sampling_c),
                        ("sampling_a_quantized",
                         {**sampling_a, "use_quantized_grad": True})):
        card_launches = phase_card_vs_cpu(lgb, H, name, extra)
        if name == "sampling_a_quantized":
            # K2 on a sampling path
            if card_launches["K2"] <= 0:
                raise AssertionError(f"{name}: K2 was not launched: "
                                     f"{card_launches}")
            launches[f"card_vs_cpu_{name}"] = card_launches
    # the split_features phase's data: categorical columns 0, 1 and 3
    for name, extra, kernels in (
            ("categorical_wave", {}, ("K1", "K3")),
            ("categorical_extra_trees_leafwise",
             {"extra_trees": True, "tpu_growth_strategy": "leafwise"},
             ("K4",)),
            ("categorical_quantized", {"use_quantized_grad": True}, ("K2",)),
            ("monotone_smooth_cegb_leafwise",
             {"monotone_constraints": monotone_signs(), "path_smooth": 1.0,
              "cegb_penalty_split": CEGB_PENALTY_SPLIT,
              "cegb_penalty_feature_coupled": [
                  CEGB_COUPLED_PER_ROW * 65_536] * F,
              "tpu_growth_strategy": "leafwise"}, ("K4",))):
        card_launches = phase_card_vs_cpu(lgb, H, name, extra,
                                          categorical=True)
        if any(card_launches[k] <= 0 for k in kernels):
            raise AssertionError(f"{name}: {kernels} must launch: "
                                 f"{card_launches}")
        launches[f"card_vs_cpu_{name}"] = card_launches
    # the scan's launches, counted after every path has run (a profiler
    # trace of one replayed scan of each run)
    scan_launches = probe.launches()
    for name, line in sf_lines.items():
        emit({**line, "scan_launches_per_wave": scan_launches.get(name),
              "main_path_scan_launches_per_wave":
                  scan_launches.get("main_path"),
              "main_path_scan_calls_per_tree": main["scan_calls_per_tree"]})
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
