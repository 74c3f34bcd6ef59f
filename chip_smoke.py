"""Drive the PyTorch port's training paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: compile every kernel source of lightgbm_tpu_torch/ops/csrc,
     then one `resources` line per source: each kernel's registers,
     static shared memory, stack frame and spills (`ptxas -v`) and the
     atomic opcodes of its SASS (`cuobjdump -sass`);
  3. main path: `Booster` updates with the bench workload (binary logloss,
     make_higgs_like(1_000_000, 28), 255 leaves, 255 bins, 13 iterations)
     on the card; held-out AUC >= 0.72 and K1 and K3 launched;
  4. path A, quantized training: the same workload with
     use_quantized_grad=true (4 bins, stochastic rounding), 13
     iterations; K2 launched, K1/K3 not; held-out AUC within 0.01 of
     phase 3's;
  5. path B, the leaf-wise engine: the same workload with
     tpu_growth_strategy=leafwise, 13 iterations; K4 launched, held-out
     AUC >= 0.72;
  6. card against CPU: `train` at 65,536 rows, 3 iterations, on "cuda"
     and "cpu", for the main path and paths A and B: the same split
     features and thresholds in every tree, leaf values within rtol 1e-4;
  7. kernels at the main path's widths (28 features, 255 bins, 2
     channels), one `kernel` line per shape: K1 at 1/2/4/8/16/128/256
     slots on n = 2^20 rows (half on the sentinel), at 384 slots of
     uneven sizes (slot s takes a share ~ 1 / (s + 1)) and at 128 slots
     on n = 999,936 rows (no multiple of K1's chunks); K3 at 1/2/4/8
     computed slots; K2 at 16/128/256 slots on quantized gh; K4 at S =
     512, 4,096, 65,536 and 2^20 rows (half in the mask) and on 4,096-
     and 65,536-row segments whose rows all fall in one bin of every
     feature (the hot cell), with half the rows in the mask or all.
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


def kernel_inputs(num_slots, dev, seed, n=N_KERNEL, uneven=False):
    """Main-path-shaped inputs: half the rows in computed slots (the
    smaller children), the rest on the sentinel slot.  `uneven` gives
    the slots the main path's leaf sizes: slot s takes a share
    proportional to 1 / (s + 1), so one slot is large and most small."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    binned = torch.randint(0, B, (F, n), generator=g, dtype=torch.uint8)
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
    for Ks in (1, 2, 4, 8):
        binned, binned_rm, slot, gh = kernel_inputs(Ks, dev, seed=100 + Ks)
        Kb = H.wave_slot_pad(Ks)
        k = functools.partial(H.build_histogram_wave_hl, binned, binned_rm,
                              slot, gh, max_bin=B, num_slots=Ks,
                              out_slots=Kb)
        p = functools.partial(H.build_histogram_wave_hl_plain, binned,
                              binned_rm, slot, gh, max_bin=B, num_slots=Ks,
                              out_slots=Kb)
        lib, rows_in = wave_yardstick(binned, slot, gh, Ks, dev)
        bound, by = bound_of(F * N_KERNEL, N_KERNEL, Kb, rows_in)
        results[("K3", Ks)] = kernel_row(
            "K3", H.build_histogram_wave_hl, k, p, lib, num_slots=Ks,
            out_slots=Kb, bound_ms=bound, bound_by=by)
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
    for NL in (16, 128, 256):
        binned, _, slot, _ = kernel_inputs(NL, dev, seed=200 + NL)
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
        results[("K2", NL)] = kernel_row(
            "K2", H.build_histogram_wave_int, k, p, lib, num_slots=NL,
            bound_ms=bound, bound_by=by)
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


def launch_counts(H):
    return {"K1": H.build_histogram_wave.launches,
            "K2": H.build_histogram_wave_int.launches,
            "K3": H.build_histogram_wave_hl.launches,
            "K4": H.build_histogram_rows_pallas.launches}


def reset_counts(H):
    for fn in (H.build_histogram_wave, H.build_histogram_wave_int,
               H.build_histogram_wave_hl, H.build_histogram_rows_pallas):
        fn.launches = 0


def drive_path(lgb, H, global_timer, name, extra, iterations, data):
    """Train the bench workload with `extra` params on the card: counts
    set to 0 just before the updates and read just after; then three
    instrumented iterations for the breakdown."""
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
    return launches, score


def phase_paths(lgb, H, global_timer):
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    data = (X, y, Xte, yte)
    out = {}
    launches, auc_main = drive_path(lgb, H, global_timer, "main_path", {},
                                    13, data)
    if auc_main < 0.72:
        raise AssertionError(f"main path: held-out AUC {auc_main} < 0.72")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"main path: a kernel was not launched: "
                             f"{launches}")
    out["main_path"] = launches
    launches, auc_q = drive_path(lgb, H, global_timer, "path_a_quantized",
                                 {"use_quantized_grad": True}, 13, data)
    if launches["K2"] <= 0 or launches["K1"] or launches["K3"]:
        raise AssertionError(f"path A: K2 must carry every histogram: "
                             f"{launches}")
    if abs(auc_q - auc_main) > 0.01:
        raise AssertionError(f"path A: held-out AUC {auc_q} is more than "
                             f"0.01 from the float path's {auc_main}")
    out["path_a_quantized"] = launches
    launches, auc_l = drive_path(lgb, H, global_timer, "path_b_leafwise",
                                 {"tpu_growth_strategy": "leafwise"}, 13,
                                 data)
    if launches["K4"] <= 0:
        raise AssertionError(f"path B: K4 was not launched: {launches}")
    if auc_l < 0.72:
        raise AssertionError(f"path B: held-out AUC {auc_l} < 0.72")
    out["path_b_leafwise"] = launches
    return out


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

    launches = phase_paths(lgb, H, global_timer)
    for name, extra in (("main_path", {}),
                        ("path_a_quantized", {"use_quantized_grad": True}),
                        ("path_b_leafwise",
                         {"tpu_growth_strategy": "leafwise"})):
        phase_card_vs_cpu(lgb, name, extra)
    per_shape = phase_kernels(H, dev)
    per_shape.update(phase_kernels_k2_k4(H, dev))

    csrc = "lightgbm_tpu_torch/ops/csrc/"
    hist_py = "lightgbm_tpu/ops/histogram.py"
    entries = []
    for name, key, path, src, replaces in (
            ("K1 slot-partitioned wave_part_hist_kernel "
             "(build_histogram_wave)", ("K1", 256, False, N_KERNEL),
             "main_path", "wave_hist.cu",
             f"{hist_py}:147 _wave_kernel (fp32), called at :499"),
            ("K2 wave_hist_kernel<int32> (build_histogram_wave, "
             "quant_scales)", ("K2", 256), "path_a_quantized",
             "wave_hist.cu",
             f"{hist_py}:147 _wave_kernel (int8 mode, :462-469, :517-520)"),
            ("K3 wave_hist_hl_kernel (build_histogram_wave_hl)", ("K3", 8),
             "main_path", "wave_hist.cu",
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
    emit({"kernels": entries, "launches_by_path": launches})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
