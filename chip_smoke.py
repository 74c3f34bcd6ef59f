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
  3a. surface: on the main path's booster right after `predict` (1.1M
     rows, every predict on the card advancing the DevicePredictor's
     card dispatches): a pickle round trip (the card and device_predict
     kept, the same model text, raw scores bit for bit), dump_model (13
     tree_info entries, the text's num_leaves), set_leaf_output (1.0 on
     tree 0's most populated leaf moves its rows by 1.0 within the two
     scores' float32 bounds, the other rows unchanged bit for bit, and
     restoring the leaf restores the scores bit for bit), shuffle_models
     on the restored copy (the text changes, scores within
     2·T·2^-24·Σ|leaf|), then model_from_string back (bit for bit); then
     LGBMClassifier(n_estimators=13, num_leaves=255, max_bin=255,
     learning_rate=0.1).fit on the 1M rows with the launch counts set to
     0 before and read after (K1 and K3 launched), its model text from
     `Tree=0` on equal to `train`'s with its parameters (on the main
     path's Dataset of the same rows), held-out AUC
     >= 0.72, a pickled estimator's predict_proba bit for bit.  One
     `surface` line: the phase's seconds, the estimator's s/iter of
     iterations 4-13 beside the main path's, the card;
  3b. refit_contrib: on the main path's booster right after `surface`:
     the SHAP contributions of CONTRIB_ROWS held-out rows: the native
     TreeSHAP library explains every tree, each row sums to its float64
     host raw score within 1e-9 of its Σ|phi|, the native result on 16
     rows of tree 0 equals the Python fallback's within 1e-12, and the
     first 256 rows as CSR give CSR of the same values.  Then
     `Booster.refit` on the 100k held-out rows, which must advance the
     DevicePredictor's card dispatches (the rows' leaves) and move no
     split; each leaf value within REFIT_SLACK float32 roundings of each
     gradient and hessian (the bound (1 - decay)·shrinkage·REFIT_SLACK·
     2^-24·(Σ|g| + |out|·Σh) / Σh) of the plain refit from the native
     predictor's leaf ids and float64 host gradients.  One
     `refit_contrib` line: refit seconds, contributions rows/s, the card;
  4. path A, quantized training: the same workload with
     use_quantized_grad=true (4 bins, stochastic rounding), 13
     iterations; K2 launched, K1/K3 not; held-out AUC within 0.01 of
     phase 3's;
  5. path B, the leaf-wise engine: the same workload with
     tpu_growth_strategy=leafwise, 13 iterations; K4 launched, held-out
     AUC >= 0.72;
  5.1 efb: exclusive feature bundling from scipy sparse input at full
     width: make_higgs_like(1_000_000, 28)'s 28 columns beside four
     one-hot categoricals of 50, 100, 200 and 400 levels (778 columns,
     32M nonzeros; label: higgs_logit plus a per-level effect of
     N(0, 0.5^2) per categorical, a Bernoulli draw), handed to `Dataset` as a
     float32 CSR built from its nonzeros; 255 leaves, 255 bins, 13
     iterations, the wave engine, default enable_bundle; held-out rows:
     the same construction at 100k rows, seed 1, scored through
     `Booster.predict(csr)`.  One `efb` line: bundle columns F', bundles,
     group_max_bin, device bytes of the bundle codes against n x 778,
     construction seconds, peak host RSS (the phase's resident set
     sampled every 5 ms), s/iter of
     iterations 4-13, `Tree::histogram`, `Tree::split_find` and
     `Tree::partition` device ms/iter, launches, peak device GiB,
     held-out AUC.  Gates: K1 and K3 launched; the booster trained on
     the dataset's plan; held-out AUC >= EFB_AUC_MIN (chip_rehearsal.py
     efb at 1/8 of the rows, less a margin); the card's leaf ids equal
     the native predictor's on the 100k held-out rows, raw scores
     within the predict phase's bound; peak host RSS below the dense
     float32 matrix's 3.1 GB, counted as the phase's peak over the
     resident set it began with (it runs first of the training phases,
     so that set is little more than the CUDA context and libraries);
  5.2 forced_interaction: the main path's workload with (a)
     `forcedsplits_filename`, a JSON the script writes: a depth-2 forced
     tree on features 0, 1 and 2 at their medians (root, left child,
     right child); (b) interaction_constraints=[[0..9], [10..19],
     [20..27]].  One `forced_interaction` line per run: s/iter, the
     `Tree::split_find` device ms/iter beside the main path's, launches
     (the forced prologue's one-slot K3 waves among them), held-out
     AUC.  Gates: K1 and K3 launched; (a) every tree's first three
     internal nodes are the forced splits (feature and bin upper bound
     of the median); (b) every root-to-leaf path uses the features of
     one set; held-out AUC >= FORCED_AUC_MIN, INTERACTION_AUC_MIN
     (chip_rehearsal.py forced_interaction, less a margin);
  5.3 linear: the main path's workload with linear_tree=true (its own
     Dataset, which keeps the raw values), 13 iterations, the wave
     engine.  Gates: K1 and K3 launched; every tree linear; the device
     fits of trees LINEAR_FIT_TREES (0 and 12), captured as they ran,
     against calculate_linear_plain on the same leaf ids, gradients and
     hessians, pulled: each row's leaf output within LINEAR_FIT_REL ·
     max(1, |output|) (sized by chip_rehearsal.py linear); tree 0's fit
     rerun on the card gives the same bits; the training scores within
     2·T·2^-24·Σ_t|output| of Σ_t host float64 Tree.predict of the raw
     rows; held-out AUC >= LINEAR_AUC_MIN (chip_rehearsal.py linear at 1/8
     of the rows, less a margin); the model text reloads to the same bits
     on the held-out rows.  One `linear_line`: s/iter of iterations 4-13
     beside the main path's, `GBDT::linear_fit`, `Tree::histogram`,
     `Tree::split_find` and `Tree::partition` device ms/iter, the raw
     matrix's device bytes, peak GiB, leaves fitted, degenerate and
     solved by pseudo-inverse, mean k, held-out AUC;
  5.4 wide_bins: the main path's workload at max_bin=WIDE_MAX_BIN (1023)
     on its own Dataset, binned on the host (its construction seconds in
     the line), on 16-bit device codes: the wave engine, 13 iterations
     (K3 on the waves of up to 7 computed slots, K1 on those of 8 and
     more, whose histograms exceed K3's tile at 1023 bins), quantized, 13
     iterations (K2), and the leaf-wise engine, 3 iterations (K4).
     Gates: the device codes int16; exactly the run's kernels launched;
     held-out AUC >= 0.72 (wave), within 0.01 of the wave run's
     (quantized), >= WIDE_LEAFWISE_AUC_MIN (leaf-wise, chip_rehearsal.py
     wide_bins less a margin).  One `wide_bins` line per run: s/iter
     beside the same engine's at 255 bins (the main path, path B),
     `Tree::histogram`/`split_find`/`partition` device ms/iter, peak
     GiB, launches, AUC;
  5.5 monotone_modes: the main path's workload on the leaf-wise engine,
     5 iterations each, with monotone_signs() on MODE_MONOTONE_FEATURES
     (the logit's three strongest features) under
     monotone_constraints_method=intermediate and =advanced, and with
     lazy CEGB (LAZY_PER_ROW on every feature).  Gates: K4 launched and
     the mode's flags set; the monotone sweep of the split_features phase
     over the constrained features, of which one at least must move the
     predictions (intermediate, advanced); every feature's fetched rows marked
     exactly for the features the trees split on (lazy); held-out AUC >=
     MONO_MODE_AUC_MIN (chip_rehearsal.py monotone_modes less a margin).
     One `monotone_modes` line per run: s/iter beside path B's, the
     `Tree::monotone_rescan` device ms/iter (the bounds and the rescan of
     every alive leaf after each split), `Tree::split_find` beside path
     B's, peak GiB, launches, AUC;
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
  5f. objectives: five runs of the main path's width (1M x 28, 255
     leaves, 255 bins, 13 iterations, wave engine, held-out rows
     make_higgs_like(100_000, 28, seed=1)), each driven like the paths:
     (a) `regression` on the label make_higgs_like's logit (X @ w + 0.5
     X0 X1) plus 0.5 x N(0, 1) from its own stream; (b) `quantile`,
     alpha 0.9, on (a)'s label (the leaf renewal at width); (c)
     `multiclass`, 5 classes: the logit plus logistic noise cut at the
     training rows' 20/40/60/80% quantiles (the same cuts for the
     held-out rows, a valid set with multi_logloss and multi_error); (d)
     `rf` on the binary label: bagging_fraction 0.632, bagging_freq 1,
     feature_fraction 0.8; (e) `dart` on the binary label: drop_rate
     0.1, skip_drop 0.5.  Gates in each: K1 and K3 launched; card leaf
     ids equal the native predictor's on all 1.1M rows, raw scores
     within the predict phase's bound (per class; RF's averages with one
     more rounding), converted predictions within the conversion's slope
     times it plus 2^-21 of the float64 host conversion; the training
     metric through DeviceEval; a held-out bound (OBJECTIVE_GATES, sized
     by chip_rehearsal.py at 1/8 of the rows).  (b): the held-out share
     of labels under the prediction within QUANTILE_COVER_BAND of 0.9.
     (c): each recorded valid metric within 1e-6 of the host metric of
     predict(num_iteration=i + 1); predicted rows sum to 1 within 1e-6.
     (e): the drops of each iteration equal a replay of
     RandomState(drop_seed).  One `objectives` line per run: s/iter of
     iterations 4-13 beside the main path's, `GBDT::gradients`
     ms/iter, `GBDT::renew` ms/iter (b), `DART::drop` ms/iter (e),
     trees, launches, peak GiB, the held-out measure, the card;
  5g. ranking: make_mslr_like, MSLR-WEB30K's published shape (136
     float32 features, graded labels 0-4 skewed toward 0, queries of 1 to
     1,251 documents, mean about 120), whole queries up to 2^20 rows
     (about 8,700 queries, so the float32 matrix bins on the card), and
     100,000 held-out rows in whole queries (seed 1) as a valid set on the
     training bin mappers; two runs of 13 iterations, 255 leaves, 255
     bins, learning rate 0.1, the wave engine: `lambdarank` and
     `rank_xendcg`, each with metric ndcg, eval_at 1, 3, 5, 10.  Gates in
     each: K1 and K3 launched; valid NDCG@10 higher after iteration 13
     than after iteration 1, and at least RANK_NDCG_MIN
     (chip_rehearsal.py ranking at 1/8 of the rows, less a margin).  One
     `ranking` line per run: s/iter of iterations 4-13, `GBDT::gradients`,
     `Tree::split_find` / `Tree::histogram` / `Tree::partition` device
     and `GBDT::eval` ms/iter (three instrumented iterations after the
     13), peak device GiB of the 13 and of the gradients step alone,
     launches, valid NDCG@10 at iterations 1 and 13;
  5h. file: the ranking rows' first whole queries in 65,536 rows (1/16
     grid values, so the text holds them exactly) written as a TSV file
     with a header and as LibSVM, each with `.query` and `.weight` side
     files, and loaded through `Dataset(path)`, with two_round=true, and
     through save_binary -> `Dataset(path.bin)`.  Gates: each Dataset's
     bin codes, labels, weights and query boundaries equal the Dataset
     built from the arrays; three lambdarank iterations on the TSV's
     Dataset grow the trees of the arrays' (model text from `Tree=0` on)
     with K1 and K3 launched; the native parser built and parsed both
     formats.  One `file` line: load seconds of each route, parse
     seconds and rows/s of the native and the NumPy parser;
  5i. cli: the main data's first CLI_ROWS rows written as a TSV (label
     first) and `lightgbm_tpu_torch.cli.main` run in-process on the card
     with the main path's parameters: `train`, 13 iterations, with K1 and
     K3 launched and the model text from `Tree=0` on equal to `train`'s
     on `Dataset(path)`; `predict`, whose file equals Booster.predict in
     %.18g; `refit`, whose model equals Booster.refit's on the parsed
     file; `convert_model`, C++ source with the trees.  One `cli` line:
     the tasks' seconds, launches;
  6. card against CPU (the CPU sides train in CARD_CPU_WORKERS spawned
     worker processes of CARD_CPU_THREADS torch threads while the main
     process runs the card sides in turn): `train` at CARD_ROWS (65,536)
     rows, 3 iterations, on "cuda"
     and "cpu", for the main path, paths A and B, sampling runs (a), (b)
     at learning_rate 0.5 (GOSS samples from iteration 2), (c), and (a)
     with use_quantized_grad=true (K2 on a sampling path, gated); then on
     the categorical run's transform of the data: the wave engine (K1,
     K3 gated), extra_trees on the leaf-wise engine (K4), quantized (K2),
     and monotone + path_smooth + CEGB on the leaf-wise engine (K4); then
     the objectives: regression_l1 on the wave engine (renewal; K1, K3
     gated), multiclass with 3 classes on the wave engine (K1, K3) and
     quantized (K2), tweedie on the leaf-wise engine (K4), dart on the
     wave engine (K1, K3) and rf on the leaf-wise engine (K4); then EFB
     on the efb phase's construction with categoricals of 10, 20, 40 and 80
     levels (178 columns): a dense one-hot numpy matrix on the wave
     engine (K1, K3), CSR on the wave engine (K1, K3), the leaf-wise
     engine (K4) and quantized (K2), the same bundle plan on both
     devices; then forced splits (the rows' medians, held on both
     devices) and interaction constraints on the leaf-wise engine (K4):
     the same split features, thresholds, decision types and category
     sets in every tree, leaf values within rtol 1e-4; then the ranking
     objectives on the ranking data's whole queries in its first 32,768
     rows: lambdarank with position bias on the wave engine (K1, K3),
     rank_xendcg quantized (K2) and lambdarank on the leaf-wise engine
     (K4); then linear trees at CARD_LINEAR_ROWS (32,768) rows, quantized
     on the wave engine (K2) and on the leaf-wise engine (K4), each tree's
     per-row linear outputs held too (tree 0 within LINEAR_FIT_REL, later
     trees within LINEAR_LATER_ATOL, of max(1, |output|)); then max_bin
     1023 on 16-bit codes at CARD_ROWS rows: the wave engine (K1, K3),
     quantized (K2), the leaf-wise engine (K4), and the EFB CSR data
     with CARD_WIDE_EFB_LEVELS on the wave engine (K1, K3); then at
     CARD_LINEAR_ROWS rows (their CPU sides queued first) on the
     leaf-wise engine (K4) the intermediate and advanced monotone modes
     and lazy CEGB; the card run's launch counts in each line;
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
     choice of K2_FEW_SLOTS.  Then one row per kernel at the efb run's
     group space (its F' bundle columns, codes over [0, 256) with half
     of them 0, max_bin 256): K1 and K2 at 256 slots, K3 at 8, K4 at
     2^20 rows; and K1 at 256 slots and K3 at 8 at the ranking width
     (136 features, 255 bins).  Then the four kernels on 16-bit codes
     (int16 storage, the kernels' uint16_t instantiations) at 28 features
     of WIDE_B (1023) bins: K1 and K2 at 256 slots, K3 at the most slots
     wave_hl_fits lets it take there (7), K4 at 2^20 rows; and in bin
     windows, WINDOW_F (4) features of WINDOW_B (32,768) bins, n = 2^20:
     K1 at 16 slots, K2 at 16 (partition) and 4 (streaming), K3 at 1,
     K4 at 2^20 rows.  The kernels line lists these as four more rows,
     each with its windowed shapes.
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
iterations.  A `total` line gives the run's seconds before the kernels
line.  The paths that train on the bench rows and labels with
BENCH_PARAMS' Dataset parameters share one Dataset constructed once
(`bench_rows`, its `bench_dataset` line; a path whose params would bin
it otherwise is refused), and each JSON line carries `t_s`, the seconds
since the script started.  Then the kernels line, the card's name and
power limit, and the result.

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
GROUP_BINS = 256               # EFB bundle codes: MAX_BUNDLE_BINS
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
VALID_MIN_DELTA = 0.001        # early_stopping_min_delta of the valid path
CARD_ROWS = 65_536             # rows of the higgs and EFB card-vs-CPU cases
CARD_LINEAR_ROWS = 32_768      # rows of the linear card-vs-CPU cases
# the card-vs-CPU cases' CPU sides train in worker processes meanwhile
CARD_CPU_WORKERS = 4
CARD_CPU_THREADS = 2


T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line, with `t_s`, the seconds since the script
    started (where the run's time goes)."""
    print(json.dumps({**obj, "t_s": time.perf_counter() - T0}), flush=True)


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
    y = (rng.rand(n) < 1 / (1 + np.exp(-higgs_logit(X)))).astype(
        np.float32)
    return X, y


def higgs_logit(X):
    """make_higgs_like's logit of rows X: X @ w + 0.5 * X0 * X1, with the
    generator's fixed weights w."""
    w = np.random.RandomState(1234).randn(X.shape[1]) / np.sqrt(X.shape[1])
    return X @ w + 0.5 * X[:, 0] * X[:, 1]


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
                  hot=False, width=(F, B)):
    """Main-path-shaped inputs: half the rows in computed slots (the
    smaller children), the rest on the sentinel slot.  `uneven` gives
    the slots the main path's leaf sizes: slot s takes a share
    proportional to 1 / (s + 1), so one slot is large and most small.
    `hot` puts every row in bin 17 of every feature (the hot cell).
    `width` = (columns, bins); at GROUP_BINS bins (EFB's bundle codes)
    half the codes are 0, every member of a bundle at its default."""
    Fw, Bw = width
    g = torch.Generator(device="cpu").manual_seed(seed)
    binned = torch.randint(0, Bw, (Fw, n), generator=g, dtype=torch.uint8)
    if Bw == GROUP_BINS:
        binned[torch.rand(Fw, n, generator=g) < 0.5] = 0
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


def bound_of(binned_bytes, n, num_slots, rows_in_slots, width=(F, B)):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM bandwidth, against one add per computed row,
    feature and channel (plus the count) over the float32 peak."""
    Fw, Bw = width
    nbytes = (binned_bytes + 4 * n + 4 * (C + 1) * n
              + num_slots * Fw * Bw * C * 4 + num_slots * 4)
    ops = rows_in_slots * (Fw * C + 1)
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


def wave_yardstick(binned, slot, gh, NL, dev, vals_of=None, width=(F, B)):
    """One `index_add_` over precomputed flat (slot, feature, bin) ids of
    the computed rows (float32 values; int64 through vals_of)."""
    Fw, Bw = width
    valid = (slot >= 0) & (slot < NL)
    ids = ((slot.long()[None, :] * Fw
            + torch.arange(Fw, device=dev)[:, None]) * Bw
           + binned.long())[:, valid].reshape(-1)
    v = gh[valid][:, :C] if vals_of is None else vals_of(gh[valid])
    vals = v.repeat(Fw, 1)
    out = torch.zeros(NL * Fw * Bw, C, dtype=vals.dtype, device=dev)
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


def bound_rows(S, rows_in_mask, width=(F, B), code_bytes=1):
    """K4's (bound_ms, bound_by): rows (codes of `code_bytes` bytes), gh
    and mask read once and the float32 histograms written once, against
    one add per masked row, feature and channel."""
    Fw, Bw = width
    nbytes = S * Fw * code_bytes + 4 * C * S + 4 * S + Fw * Bw * C * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows_in_mask * Fw * C / F32_OPS_PER_S * 1e3
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
        helpers = [n for n in per
                   if n != "Memset" and "rows_hist_kernel" not in n]
        if helpers:
            raise AssertionError(f"K4 fixed S={S}: launched {helpers}")
        emit({"phase": "kernel_fixed", "kernel": "K4", "rows": S,
              "hot_cell": hot, "full_mask": full, "ms": cuda_ms(kf),
              "loop_ms": loop_ms(kf), "kernel_ms": total,
              "kernel_ms_by_name": per})
        del ids, vals, lib_out
    return results


# 16-bit codes: the wide_bins phase's width, and one shape whose feature
# does not fit a block (the kernels cut its bins into windows)
WIDE_B = 1023
WINDOW_F, WINDOW_B = 4, 32768


def wide_inputs(num_slots, dev, seed, width):
    """kernel_inputs on 16-bit codes (int16 storage, codes over [0, B)):
    (binned, its codes as int64 for the yardstick, slot, gh)."""
    Fw, Bw = width
    g = torch.Generator(device="cpu").manual_seed(seed)
    codes = torch.randint(0, Bw, (Fw, N_KERNEL), generator=g)
    slot = torch.randint(0, num_slots, (N_KERNEL,), generator=g,
                         dtype=torch.int32)
    off = torch.rand(N_KERNEL, generator=g) < 0.5
    slot = torch.where(off, torch.full_like(slot, 1 << 20), slot)
    gh = torch.stack([torch.randn(N_KERNEL, generator=g),
                      torch.rand(N_KERNEL, generator=g) * 0.25,
                      torch.ones(N_KERNEL)], 1)
    from lightgbm_tpu_torch.ops.histogram import codes_to_device
    binned = codes_to_device(codes.numpy(), dev, num_bin=max(Bw, 257))
    return binned, codes.to(dev), slot.to(dev), gh.contiguous().to(dev)


def phase_kernels_wide(H, dev):
    """K1-K4 on 16-bit codes at the wide_bins phase's width (28 features,
    WIDE_B bins; K1 and K2 at 256 slots, K3 at the most slots
    `wave_hl_fits` lets it take there, K4 at 2^20 rows) and in bin
    windows (WINDOW_F features of WINDOW_B bins: K1 and K2's partition
    at 16 slots, K2's streaming route at 4, K3 at 1, K4 at 2^20 rows),
    each bit for bit its plain version and itself on a repeat, each call
    one launch.  Returns {(kernel, "wide" | "window"): row}."""
    K3_SLOTS = max(s for s in range(1, 64) if H.wave_hl_fits(WIDE_B, s))
    out = {}
    for tag, width, shapes in (
            ("wide", (F, WIDE_B), (("K1", 256), ("K2", 256),
                                   ("K3", K3_SLOTS), ("K4", 0))),
            ("window", (WINDOW_F, WINDOW_B),
             (("K1", 16), ("K2", 16), ("K2", 4), ("K3", 1), ("K4", 0)))):
        Fw, Bw = width
        for kern, NL in shapes:
            binned, codes, slot, gh = wide_inputs(max(NL, 1), dev,
                                                  seed=900 + NL, width=width)
            extra = {"codes": "uint16 (int16 storage)", "features": Fw,
                     "max_bin": Bw, "windowed": tag == "window"}
            if kern == "K4":
                rows = binned.t().contiguous()
                mask = (slot < (1 << 20)).to(torch.float32)
                g2 = gh[:, :C].contiguous()
                k = functools.partial(H.build_histogram_rows_pallas, rows,
                                      g2, mask, max_bin=Bw)
                p = functools.partial(H.build_histogram_rows_plain, rows, g2,
                                      mask, max_bin=Bw)
                ids = (torch.arange(Fw, device=dev)[None, :] * Bw
                       + codes.t()).reshape(-1)
                vals = (g2 * mask[:, None]).repeat_interleave(Fw, dim=0)
                lib_out = torch.zeros(Fw * Bw, C, device=dev)
                lib = lambda: lib_out.index_add_(0, ids, vals)
                bnd = bound_rows(N_KERNEL, int(mask.sum()), width=width,
                                 code_bytes=2)
                row = kernel_row(kern, H.build_histogram_rows_pallas, k, p,
                                 lib, rows=N_KERNEL, bound_ms=bnd[0],
                                 bound_by=bnd[1], **extra)
                out[(kern, tag)] = row
                del ids, vals, lib_out
                continue
            if kern == "K2":
                gh, scales = quantized_gh(N_KERNEL,
                                          torch.Generator().manual_seed(NL))
                gh, scales = gh.to(dev), scales.to(dev)
                k = functools.partial(H.build_histogram_wave, binned, slot,
                                      gh, max_bin=Bw, num_slots=NL,
                                      quant_bins=4, quant_scales=scales)
                p = functools.partial(H.build_histogram_wave_int_plain,
                                      binned, slot, gh, scales, max_bin=Bw,
                                      num_slots=NL)
                counter = H.build_histogram_wave_int
                vals_of = (lambda v: torch.round(v[:, :C] / scales)
                           .to(torch.int64))
                slots_out = NL
                extra["route"] = ("streaming" if NL <= H.K2_FEW_SLOTS
                                  else "partition")
            elif kern == "K1":
                k = functools.partial(H.build_histogram_wave, binned, slot,
                                      gh, max_bin=Bw, num_slots=NL)
                p = functools.partial(H.build_histogram_wave_plain, binned,
                                      slot, gh, max_bin=Bw, num_slots=NL)
                counter, vals_of, slots_out = H.build_histogram_wave, None, NL
            else:
                Kb = H.wave_slot_pad(NL)
                k = functools.partial(H.build_histogram_wave_hl, binned,
                                      binned.t(), slot, gh, max_bin=Bw,
                                      num_slots=NL, out_slots=Kb)
                p = functools.partial(H.build_histogram_wave_hl_plain,
                                      binned, binned.t(), slot, gh,
                                      max_bin=Bw, num_slots=NL,
                                      out_slots=Kb)
                counter, vals_of, slots_out = (H.build_histogram_wave_hl,
                                               None, Kb)
                extra["out_slots"] = Kb
            lib, rows_in = wave_yardstick(codes, slot, gh, NL, dev,
                                          vals_of=vals_of, width=width)
            bound, by = bound_of(2 * Fw * N_KERNEL, N_KERNEL, slots_out,
                                 rows_in, width=width)
            row = kernel_row(kern, counter, k, p, lib, num_slots=NL,
                             bound_ms=bound, bound_by=by, **extra)
            out[(kern, tag) if (kern, tag) not in out
                else (kern, tag, NL)] = row
            del lib
        del binned, codes, slot, gh
    return out


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


def phase_kernels_group_space(H, dev, Fg):
    """K1-K4 at the efb run's group space: Fg bundle columns, codes over
    [0, 256) (half of them 0), max_bin GROUP_BINS; K1 and K2 at 256
    slots, K3 at 8, K4 at 2^20 rows.  Each row held bit for bit against
    its plain version and on repeat, as the main rows are.  Returns
    {kernel: row}."""
    W = (Fg, GROUP_BINS)
    out = {}
    for name, NL in (("K1", 256), ("K3", 8), ("K2", 256)):
        binned, binned_rm, slot, gh = kernel_inputs(NL, dev, seed=700 + NL,
                                                    width=W)
        if name == "K1":
            k = functools.partial(H.build_histogram_wave, binned, slot, gh,
                                  max_bin=GROUP_BINS, num_slots=NL)
            p = functools.partial(H.build_histogram_wave_plain, binned, slot,
                                  gh, max_bin=GROUP_BINS, num_slots=NL)
            lib, rows_in = wave_yardstick(binned, slot, gh, NL, dev, width=W)
            counter, extra = H.build_histogram_wave, {"num_slots": NL}
        elif name == "K3":
            Kb = H.wave_slot_pad(NL)
            k = functools.partial(H.build_histogram_wave_hl, binned,
                                  binned_rm, slot, gh, max_bin=GROUP_BINS,
                                  num_slots=NL, out_slots=Kb)
            p = functools.partial(H.build_histogram_wave_hl_plain, binned,
                                  binned_rm, slot, gh, max_bin=GROUP_BINS,
                                  num_slots=NL, out_slots=Kb)
            lib, rows_in = wave_yardstick(binned, slot, gh, NL, dev, width=W)
            counter, extra = H.build_histogram_wave_hl, {"num_slots": NL,
                                                         "out_slots": Kb}
        else:
            gh, scales = quantized_gh(N_KERNEL,
                                      torch.Generator().manual_seed(NL + 1))
            gh, scales = gh.to(dev), scales.to(dev)
            k = functools.partial(H.build_histogram_wave, binned, slot, gh,
                                  max_bin=GROUP_BINS, num_slots=NL,
                                  quant_bins=4, quant_scales=scales)
            p = functools.partial(H.build_histogram_wave_int_plain, binned,
                                  slot, gh, scales, max_bin=GROUP_BINS,
                                  num_slots=NL)
            lib, rows_in = wave_yardstick(
                binned, slot, gh, NL, dev, width=W,
                vals_of=lambda v: torch.round(v[:, :C] / scales).to(
                    torch.int64))
            counter, extra = H.build_histogram_wave_int, {"num_slots": NL}
        bound, by = bound_of(Fg * N_KERNEL, N_KERNEL, NL, rows_in, width=W)
        out[name] = kernel_row(name, counter, k, p, lib, group_space=True,
                               features=Fg, max_bin=GROUP_BINS,
                               bound_ms=bound, bound_by=by, **extra)
        del lib, binned, binned_rm, slot, gh
    S = 1 << 20
    g = torch.Generator().manual_seed(S + 5)
    rows = kernel_inputs(1, torch.device("cpu"), seed=705, n=S,
                         width=W)[1].to(dev)
    gh = torch.stack([torch.randn(S, generator=g),
                      torch.rand(S, generator=g) * 0.25], 1)
    gh = gh.contiguous().to(dev)
    mask = (torch.rand(S, generator=g) < 0.5).to(torch.float32).to(dev)
    k = functools.partial(H.build_histogram_rows_pallas, rows, gh, mask,
                          max_bin=GROUP_BINS)
    p = functools.partial(H.build_histogram_rows_plain, rows, gh, mask,
                          max_bin=GROUP_BINS)
    ids = (torch.arange(Fg, device=dev)[None, :] * GROUP_BINS
           + rows.long()).reshape(-1)
    vals = (gh * mask[:, None]).repeat_interleave(Fg, dim=0)
    lib_out = torch.zeros(Fg * GROUP_BINS, C, device=dev)
    bound, by = bound_rows(S, int((mask != 0).sum()), width=W)
    out["K4"] = kernel_row("K4", H.build_histogram_rows_pallas, k, p,
                           lambda: lib_out.index_add_(0, ids, vals),
                           group_space=True, rows=S, features=Fg,
                           max_bin=GROUP_BINS, bound_ms=bound, bound_by=by)
    return out


# the params of every training path, under its own `extra`
BENCH_PARAMS = {"objective": "binary", "num_leaves": 255,
                "learning_rate": 0.1, "max_bin": 255, "min_data_in_leaf": 20,
                "verbosity": -1, "device_type": "cuda"}
# the Config fields that Dataset.construct reads, but device_type: it
# picks where the bins are computed, not what they are (the device_bin
# phase holds the card's bins equal to the CPU's)
DATASET_FIELDS = ("max_bin", "min_data_in_bin", "min_data_in_leaf",
                  "bin_construct_sample_cnt", "use_missing",
                  "zero_as_missing", "feature_pre_filter", "data_random_seed",
                  "max_conflict_rate", "enable_bundle", "max_bin_by_feature",
                  "forcedbins_filename", "linear_tree")


def check_dataset_params(what, params, train_set):
    """Refuse to train with `params` on the constructed `train_set` when
    they would have binned it otherwise: a constructed Dataset ignores
    the Dataset parameters a Booster hands it."""
    from lightgbm_tpu_torch.config import Config
    quiet = {"verbosity": -1}
    want, have = (Config({**p, **quiet})
                  for p in (params, train_set.params))
    diff = {k: (getattr(want, k), getattr(have, k)) for k in DATASET_FIELDS
            if getattr(want, k) != getattr(have, k)}
    if diff:
        raise AssertionError(f"{what}: params would bin the shared Dataset "
                             f"otherwise (wanted, built): {diff}")


def bench_rows(lgb):
    """The bench rows, make_higgs_like(1_000_000, 28) and the 100,000
    held-out rows (seed 1), and one Dataset of the 1M rows constructed
    with BENCH_PARAMS, which every path on these rows and labels with
    those Dataset parameters trains on: host binning of 1M x 28 takes
    7-12 s on the card's machine, once instead of once a path.  Prints
    the `bench_dataset` line.  Returns ((X, y, Xte, yte), Dataset)."""
    X, y = make_higgs_like(1_000_000, 28)
    Xte, yte = make_higgs_like(100_000, 28, seed=1)
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params=dict(BENCH_PARAMS)).construct()
    torch.cuda.synchronize()
    emit({"phase": "bench_dataset", "rows": X.shape[0],
          "features": X.shape[1], "construct_s": time.perf_counter() - t0})
    return (X, y, Xte, yte), ds


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
               before_training=None, metric=None, train_set=None):
    """Train the bench workload with `extra` params on the card
    (`dataset_kw` to its Dataset, or the Dataset `train_set` already
    made, refused if `extra` would have binned it otherwise;
    `before_training(booster)`, if given,
    runs before the counts are set): counts set to 0 just before the
    updates and read just after (`after_update(booster)`, if given, runs
    after each update, outside its time); then `after_training(booster)`,
    if given; then three instrumented iterations for the breakdown.
    `metric` = (name, fn(booster, Xte, yte)) is the held-out measure,
    the AUC of the raw scores by default.  Returns a dict: launches, auc
    (the measure), s_per_iter (iterations 4-13), instrumented wall
    s/iter and the breakdown's ms per iteration."""
    X, y, Xte, yte = data
    params = {**BENCH_PARAMS, **extra}
    if train_set is not None:
        if dataset_kw:
            raise AssertionError(f"{name}: dataset_kw or train_set, not both")
        check_dataset_params(name, params, train_set)
    t0 = time.perf_counter()
    booster = lgb.Booster(params=params, train_set=train_set or lgb.Dataset(
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
    metric_name, metric_fn = metric or (
        "heldout_auc", lambda b, Xs, ys: auc(ys, b.predict(Xs,
                                                           raw_score=True)))
    score = metric_fn(booster, Xte, yte)
    last = iters[-10:]
    emit({"phase": name, "rows": X.shape[0], "features": X.shape[1],
          "num_leaves": params["num_leaves"], "max_bin": params["max_bin"],
          "params": extra,
          "iterations": iterations,
          "growth_strategy": booster._gbdt.growth_strategy,
          "setup_s": setup_s, "first_iter_s": iters[0],
          f"s_per_iter_last{len(last)}": sum(last) / len(last),
          "iter_s": iters, metric_name: score,
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


def phase_paths(lgb, H, global_timer, probe, bench):
    data, ds = bench
    out = {}
    probe.reset()
    surface = {}

    def after_main(b):
        phase_predict(b, data)
        # the estimator's and train's scans are not the main path's
        held = probe.calls, probe.last
        surface.update(phase_surface(lgb, H, b, data))
        probe.calls, probe.last = held
        phase_refit_contrib(lgb, b, data, card_line())
    r = drive_path(lgb, H, global_timer, "main_path", {}, 13, data,
                   after_training=after_main, train_set=ds)
    emit({**surface, "main_path_s_per_iter_last10": r["s_per_iter"],
          "nvidia_smi": card_line()})
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
                   {"use_quantized_grad": True}, 13, data, train_set=ds)
    launches, auc_q = r["launches"], r["auc"]
    if launches["K2"] <= 0 or launches["K1"] or launches["K3"]:
        raise AssertionError(f"path A: K2 must carry every histogram: "
                             f"{launches}")
    if abs(auc_q - auc_main) > 0.01:
        raise AssertionError(f"path A: held-out AUC {auc_q} is more than "
                             f"0.01 from the float path's {auc_main}")
    out["path_a_quantized"] = launches
    r = drive_path(lgb, H, global_timer, "path_b_leafwise",
                   {"tpu_growth_strategy": "leafwise"}, 13, data,
                   train_set=ds)
    launches, auc_l = r["launches"], r["auc"]
    if launches["K4"] <= 0:
        raise AssertionError(f"path B: K4 was not launched: {launches}")
    if auc_l < 0.72:
        raise AssertionError(f"path B: held-out AUC {auc_l} < 0.72")
    out["path_b_leafwise"] = launches
    main["path_b"] = {"s_per_iter": r["s_per_iter"],
                      "ms_per_iter": r["ms_per_iter"]}
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
    float64 score, T the trees of its class (for K classes `r` is
    [n, K]); under RF's averaging both are divided by T, and one more
    rounding is allowed for the division.  Returns (errors, host raw
    scores, bounds)."""
    K = g.num_tree_per_iteration
    T = len(g.models_) // K
    avg = g.average_output_
    packed = g._packed_for(0, T, K)
    X64 = Xs.astype(np.float64)
    host_leaf = packed.predict_leaf(X64)
    if not np.array_equal(lf, host_leaf):
        bad = np.argwhere(lf != host_leaf)[:3].tolist()
        raise AssertionError(f"{what}: card leaf ids differ from the "
                             f"native predictor's at {bad}")
    host_raw = packed.predict(X64, K, avg)
    host_raw = host_raw[:, 0] if K == 1 else host_raw
    sum_abs = np.zeros((len(Xs), K))
    for i, t in enumerate(g.models_):
        sum_abs[:, i % K] += np.abs(t.leaf_value[lf[:, i]])
    sum_abs = sum_abs[:, 0] if K == 1 else sum_abs
    bound = (2.0 * (T + 1) * 2.0 ** -24 * sum_abs / T if avg
             else 2.0 * T * 2.0 ** -24 * sum_abs)
    err = np.abs(r.astype(np.float64) - host_raw)
    if (err > bound).any():
        i = np.unravel_index(int(np.argmax(err - bound)), err.shape)
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


SURFACE_DELTA = 1.0    # added to one leaf of tree 0 by the surface phase


def card_predict(fn):
    """fn()'s result and the DevicePredictor dispatches it made on the
    card (the device route of `Booster.predict`)."""
    from lightgbm_tpu_torch.inference import DevicePredictor
    before = DevicePredictor.dispatches.get("cuda", 0)
    out = fn()
    return out, DevicePredictor.dispatches.get("cuda", 0) - before


def sum_abs_leaves(models, leaf):
    """Σ_t |leaf value| of each row's leaves (leaf ids `leaf`, [n, T])."""
    out = np.zeros(leaf.shape[0])
    for t, tree in enumerate(models):
        out += np.abs(tree.leaf_value[leaf[:, t]])
    return out


def phase_surface(lgb, H, booster, data):
    """The user surface on the main path's booster after its 13 trees,
    right after `predict` (1.1M rows: the training and held-out rows).
    Every predict here goes through `Booster.predict` on the card and
    must advance the DevicePredictor's card dispatches.  Gates:
    pickle: `pickle.loads(pickle.dumps(booster))` keeps the booster's
    device (the card) and device_predict (auto), gives the same model
    text, and raw scores equal bit for bit; dump_model: 13 `tree_info`
    entries with the text's num_leaves; set_leaf_output: SURFACE_DELTA
    added to tree 0's most populated leaf moves its rows (by pred_leaf)
    by the delta within the sum of the two scores' float32 bounds
    (2·T·2^-24·Σ|leaf| each), every other row unchanged bit for bit, and
    restoring the leaf gives the original scores bit for bit;
    shuffle_models on the restored copy: the text changes, each raw
    score within 2·T·2^-24·Σ|leaf| of the unshuffled one;
    model_from_string of the original text on that copy gives the text
    and the scores back bit for bit.  Then the estimator:
    LGBMClassifier(n_estimators=13, num_leaves=255, max_bin=255,
    learning_rate=0.1).fit on the 1M rows with the launch counts set to 0
    just before and read just after (K1 and K3 launched); its model text
    from `Tree=0` on equal to `train`'s with its booster's parameters on
    the main path's Dataset of the same rows; held-out AUC of
    predict_proba >= 0.72; a pickled and restored estimator's
    predict_proba equal bit for bit on the card.  Returns the phase's
    line (the caller adds the main path's s/iter and prints it)."""
    import pickle
    t_phase = time.perf_counter()
    X, y, Xte, yte = data
    Xall = np.concatenate([X, Xte])
    g = booster._gbdt
    T = booster.num_trees()
    text = booster.model_to_string()

    def on_card(what, fn):
        out, n = card_predict(fn)
        if n != 1:
            raise AssertionError(f"surface {what}: {n} card dispatches, "
                                 "expected 1")
        return out

    raw = on_card("live", lambda: booster.predict(Xall, raw_score=True))
    leaf = booster.predict(Xall, pred_leaf=True)
    bound = 2.0 * T * 2.0 ** -24 * sum_abs_leaves(g.models_, leaf)
    # pickle
    t0 = time.perf_counter()
    blob = pickle.dumps(booster)
    restored = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    rg = restored._gbdt
    if (rg.device != g.device
            or rg.config.device_predict != g.config.device_predict):
        raise AssertionError(f"surface pickle: restored on {rg.device}, "
                             f"device_predict {rg.config.device_predict}")
    if restored.model_to_string() != text:
        raise AssertionError("surface pickle: the model text changed")
    if not np.array_equal(on_card("pickle", lambda: restored.predict(
            Xall, raw_score=True)), raw):
        raise AssertionError("surface pickle: restored raw scores differ")
    # dump_model
    dump = booster.dump_model()
    text_leaves = [int(v) for v in re.findall(r"^num_leaves=(\d+)$", text,
                                               re.M)]
    dump_leaves = [t["num_leaves"] for t in dump["tree_info"]]
    if len(dump_leaves) != 13 or dump_leaves != text_leaves:
        raise AssertionError(f"surface dump_model: num_leaves "
                             f"{dump_leaves} vs the text's {text_leaves}")
    # set_leaf_output on the live booster, then restored
    leaf_id = int(np.bincount(leaf[:, 0]).argmax())
    in_leaf = leaf[:, 0] == leaf_id
    v = booster.get_leaf_output(0, leaf_id)
    booster.set_leaf_output(0, leaf_id, v + SURFACE_DELTA)
    if booster.get_leaf_output(0, leaf_id) != v + SURFACE_DELTA:
        raise AssertionError("surface set_leaf_output: the leaf was not set")
    moved = on_card("set_leaf_output",
                    lambda: booster.predict(Xall, raw_score=True))
    bound_moved = 2.0 * T * 2.0 ** -24 * sum_abs_leaves(g.models_, leaf)
    if not np.array_equal(moved[~in_leaf], raw[~in_leaf]):
        raise AssertionError("surface set_leaf_output: rows outside the "
                             "leaf moved")
    delta_err = np.abs(moved[in_leaf].astype(np.float64)
                       - raw[in_leaf] - SURFACE_DELTA)
    if (delta_err > bound[in_leaf] + bound_moved[in_leaf]).any():
        raise AssertionError(f"surface set_leaf_output: the leaf's rows "
                             f"moved by delta +- {delta_err.max()!r}")
    booster.set_leaf_output(0, leaf_id, v)
    if not np.array_equal(on_card("set_leaf_output restored",
                                  lambda: booster.predict(
                                      Xall, raw_score=True)), raw):
        raise AssertionError("surface set_leaf_output: restoring the leaf "
                             "did not restore the scores")
    # shuffle_models, then model_from_string, on the restored copy
    restored.shuffle_models()
    if restored.model_to_string() == text:
        raise AssertionError("surface shuffle_models: the text is unchanged")
    shuffled = on_card("shuffle_models",
                       lambda: restored.predict(Xall, raw_score=True))
    shuffle_err = np.abs(shuffled.astype(np.float64) - raw)
    if (shuffle_err > bound).any():
        raise AssertionError(f"surface shuffle_models: error "
                             f"{shuffle_err.max()!r} over the bound")
    restored.model_from_string(text)
    if (restored.model_to_string() != text or not np.array_equal(
            on_card("model_from_string",
                    lambda: restored.predict(Xall, raw_score=True)), raw)):
        raise AssertionError("surface model_from_string: not the original")
    del restored, moved, shuffled, Xall
    # the estimator
    stamps = {"estimator": [], "train": []}

    def stamper(key):
        """A callback that stamps the end of each iteration."""
        def stamp(env):
            torch.cuda.synchronize()
            stamps[key].append(time.perf_counter())
        return stamp
    reset_counts(H)
    t0 = time.perf_counter()
    clf = lgb.LGBMClassifier(n_estimators=13, num_leaves=255, max_bin=255,
                             learning_rate=0.1)
    clf.fit(X, y, callbacks=[stamper("estimator")])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts(H)
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"surface estimator: K1 and K3 must launch: "
                             f"{launches}")
    # `train` on the main path's Dataset of the same rows: binned apart
    # from the estimator's, and no second binning of 1M rows
    t0 = time.perf_counter()
    check_dataset_params("surface train", clf.booster_.params,
                         booster._train_set)
    ref = lgb.train(clf.booster_.params, booster._train_set, 13,
                    callbacks=[stamper("train")])
    train_s = time.perf_counter() - t0
    est_text = clf.booster_.model_to_string()
    ref_text = ref.model_to_string()
    if est_text[est_text.index("Tree=0"):] != ref_text[ref_text.index(
            "Tree=0"):]:
        raise AssertionError("surface estimator: its trees differ from "
                             "train's")
    proba = on_card("estimator", lambda: clf.predict_proba(Xte))
    est_auc = auc(yte, proba[:, 1])
    if est_auc < 0.72:
        raise AssertionError(f"surface estimator: held-out AUC {est_auc} "
                             "< 0.72")
    clf2 = pickle.loads(pickle.dumps(clf))
    if not np.array_equal(on_card("estimator pickle",
                                  lambda: clf2.predict_proba(Xte)), proba):
        raise AssertionError("surface estimator: the restored estimator's "
                             "predict_proba differs")
    iter_s = {k: np.diff(v).tolist() for k, v in stamps.items()}
    return {"phase": "surface", "trees": T, "rows": int(len(raw)),
            "pickle_bytes": len(blob), "pickle_round_trip_s": pickle_s,
            "leaf": [0, leaf_id], "leaf_rows": int(in_leaf.sum()),
            "delta": SURFACE_DELTA,
            "delta_max_abs_err": float(delta_err.max()),
            "shuffle_max_abs_err": float(shuffle_err.max()),
            "shuffle_max_err_over_bound": float((shuffle_err / bound).max()),
            "estimator_fit_s": fit_s, "train_s": train_s,
            "estimator_s_per_iter_last10": float(np.mean(
                iter_s["estimator"][-10:])),
            "train_s_per_iter_last10": float(np.mean(iter_s["train"][-10:])),
            "iter_s_2_to_13": iter_s,
            "estimator_heldout_auc": est_auc,
            "estimator_trees_equal_main_path": (
                est_text[est_text.index("Tree=0"):est_text.index(
                    "end of trees")]
                == text[text.index("Tree=0"):text.index("end of trees")]),
            "estimator_launches": launches,
            "seconds": time.perf_counter() - t_phase}


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


def phase_sampling(lgb, H, global_timer, card, main_s, bench):
    """Row and column sampling at the main path's width (runs (a)-(d) of
    the module docstring), each driven like the paths on the bench
    Dataset; one `sampling` line per run.  Returns the launches of each
    run."""
    data, ds = bench
    n = data[0].shape[0]
    out = {}
    for name, extra, kernels, auc_min in SAMPLING_RUNS:
        in_bag = []
        r = drive_path(lgb, H, global_timer, name, extra, 13, data,
                       train_set=ds, after_update=lambda b: in_bag.append(
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


def phase_continue(lgb, H, global_timer, card, bench):
    """Continued training and rollback at the main path's width, run (a)'s
    params: 7 rounds, then 6 more from the first booster's model text
    with a valid set, the timer on (the line's `continue_ms_by_scope`:
    `GBDT::continue_from` is the seeding), then one rollback (gates in
    the module docstring)."""
    (X, y, Xte, yte), ds = bench
    params = {**BENCH_PARAMS, "metric": "auc", **SAMPLING_RUNS[0][1]}
    check_dataset_params("continue", params, ds)
    t0 = time.perf_counter()
    b1 = lgb.train(params, ds, 7)
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
    b2 = lgb.train(params, ds, 6, init_model=text,
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


def monotone_signs(features=MONOTONE_FEATURES):
    """sign(w) on `features`, w make_higgs_like's weights."""
    w = np.random.RandomState(1234).randn(F) / np.sqrt(F)
    mc = [0] * F
    for f in features:
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


def monotone_sweep(what, b, X, Xte, mc):
    """Each constrained feature swept over 64 values in 1,000 held-out
    rows: predictions monotone exactly, else the run fails.  Returns
    {feature: mean |change| over the sweep}."""
    rows = Xte[:1000]
    worst = {}
    for f in np.flatnonzero(mc).tolist():
        grid = np.linspace(X[:, f].min(), X[:, f].max(), 64,
                           dtype=np.float32)
        Xs = np.repeat(rows, 64, axis=0)
        Xs[:, f] = np.tile(grid, len(rows))
        pred = b.predict(Xs, raw_score=True).reshape(len(rows), 64)
        steps = np.diff(pred.astype(np.float64), axis=1) * mc[f]
        bad = int((steps < 0).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} steps against the "
                                 f"constraint of feature {f}")
        worst[f] = float(np.abs(pred[:, -1] - pred[:, 0]).mean())
    return worst


def distinct_features(models):
    return sorted({int(f) for t in models
                   for f in t.split_feature[:t.num_leaves - 1]})


def phase_split_features(lgb, H, global_timer, card, main, probe, bench):
    """The split scan's categorical, monotone and smoothing/CEGB branches
    at the main path's width (runs and gates in the module docstring).
    Returns ({run: launches}, {run: line}); the lines are emitted after
    the scan launches are counted."""
    from lightgbm_tpu_torch.metric import AUCMetric
    (X0, y, Xte0, yte), ds = bench
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
                       train_set=None if ds_kw else ds,
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
            worst = monotone_sweep("monotone", b, X, Xte, mc)
            line.update(monotone_constraints=mc, sweep_rows=1000,
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


# the objectives phase: labels of make_higgs_like's rows
REG_NOISE = 0.5           # regression label noise, x N(0, 1)
MC_CLASSES = 5
MC_CUTS = (0.2, 0.4, 0.6, 0.8)   # class cuts at these training quantiles
RF = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}
DART = {"boosting": "dart", "drop_rate": 0.1, "skip_drop": 0.5}
# each run's held-out gate: (measure, "max" or "min", bound).  The
# bounds are the CPU rehearsal's values at 1/8 of the rows
# (chip_rehearsal.py, PERF.md: l2 0.62856, quantile 0.14940,
# multi_logloss 1.50734, rf AUC 0.72144, dart AUC 0.71507) with a margin
# for the smaller sets; the rehearsal sets them to None and prints the
# values.
OBJECTIVE_GATES = {
    "regression": ("l2", "max", 0.64),
    "quantile": ("quantile", "max", 0.155),
    "multiclass": ("multi_logloss", "max", 1.52),
    "rf": ("auc", "min", 0.71),
    "dart": ("auc", "min", 0.705),
}
# the quantile run's held-out share of labels under the prediction:
# within this band around alpha = 0.9 (the rehearsal's 0.9112, plus a
# margin)
QUANTILE_COVER_BAND = 0.025


def objective_labels(X, seed, cuts=None):
    """(regression label, 5-class label, the class cuts) of rows X:
    make_higgs_like's logit plus REG_NOISE x N(0, 1) noise, and the logit
    plus logistic noise cut at `cuts` (the training rows' MC_CUTS
    quantiles when None); each noise from its own stream keyed by
    `seed`."""
    logit = higgs_logit(X)
    reg = (logit + REG_NOISE * np.random.RandomState(21 + seed).randn(
        len(X))).astype(np.float32)
    latent = logit + np.random.RandomState(31 + seed).logistic(size=len(X))
    if cuts is None:
        cuts = np.quantile(latent, MC_CUTS)
    mc = np.searchsorted(cuts, latent, side="right").astype(np.float32)
    return reg, mc, cuts


def heldout_measure(kind, alpha=0.9):
    """fn(booster, X, y) -> the held-out measure `kind` of the converted
    predictions (auc of the raw scores)."""
    def fn(b, X, y):
        if kind == "auc":
            return auc(y, b.predict(X, raw_score=True))
        p = b.predict(X).astype(np.float64)
        y = y.astype(np.float64)
        if kind == "l2":
            return float(np.mean((p - y) ** 2))
        if kind == "quantile":
            d = y - p
            return float(np.mean(np.where(d >= 0, alpha * d,
                                          (alpha - 1.0) * d)))
        if kind == "multi_logloss":
            pl = p[np.arange(len(y)), y.astype(np.int64)]
            return float(np.mean(-np.log(np.clip(pl, 1e-15, 1.0))))
        raise ValueError(kind)
    return fn


def replay_dart_drops(cfg, iterations):
    """The trees DART drops in each of its first `iterations`
    iterations, replayed from RandomState(drop_seed) with the weight
    bookkeeping of ref: dart.hpp (weighted drop, not xgboost mode)."""
    rng = np.random.RandomState(cfg.drop_seed)
    weight, total, out = [], 0.0, []
    for it in range(iterations):
        drop = []
        if rng.rand() >= cfg.skip_drop and total > 0:
            inv_avg = len(weight) / total
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop * inv_avg / total)
            for i in range(it):
                if rng.rand() < rate * weight[i] * inv_avg:
                    drop.append(i)
                    if cfg.max_drop > 0 and len(drop) >= cfg.max_drop:
                        break
        k = len(drop)
        for i in drop:
            total -= weight[i] / (k + 1.0)
            weight[i] *= k / (k + 1.0)
        lr = cfg.learning_rate / (1.0 + k)
        weight.append(lr)
        total += lr
        out.append(drop)
    return out


def hold_converted(g, what, pred, host_raw, bound, slope):
    """Converted card predictions against the objective's float64 host
    conversion of the native raw scores: within slope x the raw bound
    (the conversion's largest slope: 1 for the identity, 1/4 for the
    sigmoid, 1/2 for softmax) plus 2^-21 for the card's float32
    conversion.  Returns the largest error."""
    conv = g.objective.convert_output_host
    want = (conv(host_raw.T).T if host_raw.ndim == 2 else conv(host_raw))
    err = np.abs(pred.astype(np.float64) - want)
    b = bound.max(axis=1, keepdims=True) if bound.ndim == 2 else bound
    if (err > slope * b + 2.0 ** -21).any():
        i = np.unravel_index(int(np.argmax(err - slope * b)), err.shape)
        raise AssertionError(f"{what}: converted prediction {pred[i]!r} vs "
                             f"host {want[i]!r}")
    return float(err.max())


def phase_objectives(lgb, H, global_timer, card, main):
    """The objectives and boosting modes at the main path's width (runs
    (a)-(e) and gates in the module docstring), each driven like the
    paths.  Returns ({run: launches}, {run: line})."""
    from lightgbm_tpu_torch.metric import create_metrics
    X, yb = make_higgs_like(1_000_000, 28)
    Xte, ybte = make_higgs_like(100_000, 28, seed=1)
    yr, ym, cuts = objective_labels(X, 0)
    yrte, ymte, _ = objective_labels(Xte, 1, cuts)
    mc_metrics = ["multi_logloss", "multi_error"]
    runs = (
        ("regression", {"objective": "regression"}, yr, yrte, 1.0),
        ("quantile", {"objective": "quantile", "alpha": 0.9}, yr, yrte, 1.0),
        ("multiclass", {"objective": "multiclass",
                        "num_class": MC_CLASSES, "metric": mc_metrics},
         ym, ymte, 0.5),
        ("rf", RF, yb, ybte, 0.25),
        ("dart", DART, yb, ybte, 0.25))
    launches, lines = {}, {}
    for name, extra, y, yte, slope in runs:
        kind, sense, gate = OBJECTIVE_GATES[name]
        rec, checks = [], {}

        def before(b, yte=yte):
            if name == "multiclass":
                b.add_valid(lgb.Dataset(Xte, label=yte), "heldout")

        def after_update(b):
            g = b._gbdt
            if name == "multiclass":
                rec.append(dict((m, v) for _, m, v, _ in b.eval_valid()))
            elif name == "dart":
                rec.append(list(g.drop_index_))

        def after_training(b, yte=yte, slope=slope):
            g = b._gbdt
            errs, conv = {}, {}
            for what, Xs in (("train", X), ("heldout", Xte)):
                raw = b.predict(Xs, raw_score=True)
                leaf = b.predict(Xs, pred_leaf=True)
                errs[what], host_raw, bound = hold_to_native(
                    g, f"{name} {what}", Xs, raw, leaf)
                pred = b.predict(Xs)
                conv[what] = hold_converted(g, f"{name} {what}", pred,
                                            host_raw, bound, slope)
                if what == "heldout":
                    checks["pred"] = pred
            # the default metric runs on the card through DeviceEval
            b.eval_train()
            de = g._device_eval
            if de is None or not de.ok:
                raise AssertionError(f"{name}: the training metrics did "
                                     "not run through DeviceEval")
            checks.update(score_error=errs, converted_max_abs_err=conv,
                          device_eval=[p[0] for p in de._plans])
            if name == "multiclass":
                # each recorded valid metric against the host metric of
                # predict(num_iteration=i + 1)
                ms = create_metrics(g.config)
                for m in ms:
                    m.init(g.valid_sets[0].metadata, len(yte))
                worst = 0.0
                for i, r in enumerate(rec):
                    s = b.predict(Xte, num_iteration=i + 1,
                                  raw_score=True).astype(np.float64)
                    for m in ms:
                        for mn, v in m.eval(s.T, g.objective):
                            worst = max(worst, abs(r[mn] - v))
                if worst > 1e-6:
                    raise AssertionError(f"multiclass: a recorded valid "
                                         f"metric is {worst} from predict's")
                rows = checks["pred"].astype(np.float64).sum(axis=1)
                if np.abs(rows - 1.0).max() > 1e-6:
                    raise AssertionError("multiclass: predict rows do not "
                                         "sum to 1")
                checks.update(valid_metric_max_abs_err=worst,
                              row_sum_max_err=float(np.abs(rows - 1).max()))
            if name == "dart":
                want = replay_dart_drops(g.config, len(rec))
                if rec != want:
                    raise AssertionError(f"dart: drops {rec}, the replay "
                                         f"of RandomState(drop_seed) {want}")
                checks.update(drops=rec)

        r = drive_path(lgb, H, global_timer, f"objectives_{name}", extra,
                       13, (X, y, Xte, yte), after_training=after_training,
                       after_update=after_update, before_training=before,
                       metric=(f"heldout_{kind}", heldout_measure(kind)))
        b, g = r["booster"], r["booster"]._gbdt
        lc, value = r["launches"], r["auc"]
        if lc["K1"] <= 0 or lc["K3"] <= 0:
            raise AssertionError(f"{name}: K1/K3 not launched: {lc}")
        if gate is not None and (value > gate if sense == "max"
                                 else value < gate):
            raise AssertionError(f"{name}: held-out {kind} {value} against "
                                 f"the gate {sense} {gate}")
        line = {"phase": "objectives", "run": name, "rows": X.shape[0],
                "params": extra, "iterations": 13,
                "s_per_iter_4_13": r["s_per_iter"],
                "main_path_s_per_iter_4_13": main["s_per_iter"],
                "gradients_ms_per_iter": r["ms_per_iter"].get(
                    "GBDT::gradients"),
                "instrumented_s_per_iter": r["wall"],
                "trees": len(g.models_), "launches": lc,
                "peak_mem_gib": r["peak_gib"], f"heldout_{kind}": value,
                "gate": [sense, gate],
                "leaf_ids_equal_native_rows": X.shape[0] + Xte.shape[0],
                **{k: v for k, v in checks.items() if k != "pred"},
                "card": card}
        if name == "quantile":
            cover = float(np.mean(yte <= checks["pred"]))
            if (QUANTILE_COVER_BAND is not None
                    and abs(cover - 0.9) > QUANTILE_COVER_BAND):
                raise AssertionError(f"quantile: held-out share under the "
                                     f"prediction {cover}, not within "
                                     f"{QUANTILE_COVER_BAND} of 0.9")
            line.update(renew_ms_per_iter=r["ms_per_iter"].get(
                "GBDT::renew"), heldout_share_under=cover,
                cover_band=QUANTILE_COVER_BAND)
        if name == "dart":
            line["drop_ms_per_iter"] = r["ms_per_iter"].get("DART::drop")
        if name == "multiclass":
            line["num_class"] = MC_CLASSES
        emit(line)
        launches[f"objectives_{name}"] = lc
        lines[name] = line
        del r, b, g
    return launches, lines


# the efb phase: one-hot categoricals beside make_higgs_like's 28 columns
EFB_LEVELS = (50, 100, 200, 400)
EFB_EFFECT_SD = 0.5
# card_vs_cpu's one-hot cases: narrower categoricals, so that the CPU's scan
# over every feature stays short
CARD_EFB_LEVELS = (10, 20, 40, 80)
# the wide EFB case: one-hot blocks of its first two (a scan over 1023
# bins a feature costs the CPU side per column)
CARD_WIDE_EFB_LEVELS = CARD_EFB_LEVELS[:2]
# held-out AUC gates: the CPU rehearsal at 1/8 of the rows
# (chip_rehearsal.py: efb 0.69987, forced 0.71676, interaction 0.71753)
# less 0.01 for the noise of the smaller sets
EFB_AUC_MIN = 0.690
FORCED_AUC_MIN = 0.706
INTERACTION_AUC_MIN = 0.707
INTERACTION_SETS = (tuple(range(0, 10)), tuple(range(10, 20)),
                    tuple(range(20, 28)))
FORCED_FEATURES = (0, 1, 2)   # root, its left child, its right child


def make_onehot_csr(n, seed=0, levels=None):
    """make_higgs_like(n, 28, seed)'s 28 dense columns and one one-hot
    block per categorical of `levels` levels (codes from RandomState(seed +
    100)), as a float32 CSR [n, 28 + sum(levels)] built from its
    nonzeros (no dense matrix of that width is made), and the label:
    higgs_logit of the dense columns plus each categorical's per-level effect
    (N(0, EFB_EFFECT_SD^2), one draw per level, the same for every
    seed), then a Bernoulli draw."""
    import scipy.sparse as sps
    levels = EFB_LEVELS if levels is None else levels
    X, _ = make_higgs_like(n, 28, seed)
    n = X.shape[0]
    rng = np.random.RandomState(seed + 100)
    codes = [rng.randint(0, k, n) for k in levels]
    logit = higgs_logit(X)
    for i, (k, c) in enumerate(zip(levels, codes)):
        logit += np.random.RandomState(500 + i).normal(
            0.0, EFB_EFFECT_SD, k)[c]
    y = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    per_row = 28 + len(levels)
    starts = 28 + np.cumsum((0,) + tuple(levels[:-1]))
    indices = np.empty((n, per_row), np.int32)
    indices[:, :28] = np.arange(28, dtype=np.int32)
    data = np.ones((n, per_row), np.float32)
    data[:, :28] = X
    del X
    for i, c in enumerate(codes):
        indices[:, 28 + i] = starts[i] + c
    indptr = np.arange(0, n * per_row + 1, per_row, dtype=np.int64)
    csr = sps.csr_matrix((data.reshape(-1), indices.reshape(-1), indptr),
                         shape=(n, 28 + sum(levels)))
    return csr, y


def current_rss_bytes():
    """This process's resident set now (/proc/self/statm), or None."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class RssPeak:
    """The peak resident set while it runs: /proc/self/statm sampled every
    5 ms by a thread, or, where that file cannot be read, getrusage's
    peak over the process's life.  `stop()` returns (GiB, how it was
    counted)."""

    def __init__(self):
        import threading
        self.start = self.peak = current_rss_bytes()
        self.done = threading.Event()
        self.thread = None
        if self.peak is not None:
            self.thread = threading.Thread(target=self._run, daemon=True)
            self.thread.start()

    def _run(self):
        while not self.done.wait(0.005):
            self.peak = max(self.peak, current_rss_bytes() or 0)

    def stop(self):
        if self.thread is None:
            import resource
            kib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            return kib * 1024 / 2**30, "getrusage peak since the process began"
        self.done.set()
        self.thread.join()
        return self.peak / 2**30, "/proc/self/statm every 5 ms in the phase"

    def growth_gib(self):
        """Peak less the resident set when sampling began (None without
        samples)."""
        if self.thread is None:
            return None
        return (self.peak - self.start) / 2**30


def hold_sparse_to_native(g, what, csr, r, lf):
    """hold_to_native over the rows of `csr` in chunks of 10,000 (each
    chunk densified alone); returns the largest error over bound."""
    worst = 0.0
    for i in range(0, csr.shape[0], 10_000):
        e, _, _ = hold_to_native(g, what, csr[i:i + 10_000].toarray(),
                                 r[i:i + 10_000], lf[i:i + 10_000])
        worst = max(worst, e["max_err_over_bound"])
    return worst


def phase_efb(lgb, H, global_timer, card):
    """Exclusive feature bundling from scipy CSR at full width (module
    docstring, phase 5.1).  Returns (launches, line)."""
    rss = RssPeak()
    stages = {"start": current_rss_bytes()}
    X, y = make_onehot_csr(1_000_000)
    Xte, yte = make_onehot_csr(100_000, seed=1)
    stages["data"] = current_rss_bytes()
    n, width = X.shape
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y).construct()
    construct_s = time.perf_counter() - t0
    stages["constructed"] = current_rss_bytes()
    plan = ds._core.pre_bundled_plan
    if plan is None:
        raise AssertionError("efb: the CSR dataset holds no bundle plan")
    r = drive_path(lgb, H, global_timer, "efb", {}, 13, (X, y, Xte, yte),
                   train_set=ds)
    stages["trained"] = current_rss_bytes()
    b, g = r["booster"], r["booster"]._gbdt
    lc = r["launches"]
    if g.bundle_plan is not plan or not g.grow_params.has_bundles:
        raise AssertionError("efb: the booster did not train on the plan")
    if lc["K1"] <= 0 or lc["K3"] <= 0:
        raise AssertionError(f"efb: K1/K3 not launched: {lc}")
    # the card's leaf ids and raw scores of the held-out CSR rows (all
    # the booster's trees) against the native predictor's
    err = hold_sparse_to_native(g, "efb heldout", Xte,
                                b.predict(Xte, raw_score=True),
                                b.predict(Xte, pred_leaf=True))
    stages["predicted"] = current_rss_bytes()
    peak_rss, method = rss.stop()
    growth = rss.growth_gib()
    dense_gb = n * width * 4 / 1e9
    # the phase's own host memory: its peak over the resident set it
    # began with (the CUDA context and the libraries are not its doing)
    held = peak_rss if growth is None else growth
    if held * 2**30 / 1e9 >= dense_gb:
        raise AssertionError(f"efb: the phase's peak host RSS grew by "
                             f"{held:.3f} GiB, not below the dense float32 "
                             f"{dense_gb} GB")
    auc_te = r["auc"]
    if auc_te < EFB_AUC_MIN:
        raise AssertionError(f"efb: held-out AUC {auc_te} < {EFB_AUC_MIN}")
    ms = r["ms_per_iter"]
    line = {"phase": "efb", "rows": n, "columns": width,
            "nonzeros": int(X.nnz), "levels": list(EFB_LEVELS),
            "features": len(g.train_data.used_features),
            "bundle_columns": plan.num_groups,
            "bundles": int(sum(len(m) > 1 for m in plan.groups)),
            "group_max_bin": g.grow_params.group_max_bin,
            "device_bytes": int(g.binned_dev.numel()
                                * g.binned_dev.element_size()),
            "dense_uint8_bytes": n * width,
            "dense_float32_gb": dense_gb,
            "construct_s": construct_s, "peak_host_rss_gib": peak_rss,
            "peak_host_rss_counted": method,
            "peak_host_rss_growth_gib": growth,
            "host_rss_gib_by_stage": {
                k: (None if v is None else v / 2**30)
                for k, v in stages.items()},
            "s_per_iter_4_13": r["s_per_iter"],
            "histogram_device_ms_per_iter": ms.get("Tree::histogram::device"),
            "split_find_device_ms_per_iter": ms.get(
                "Tree::split_find::device"),
            "partition_device_ms_per_iter": ms.get(
                "Tree::partition::device"),
            "launches": lc, "peak_mem_gib": r["peak_gib"],
            "heldout_auc": auc_te, "auc_min": EFB_AUC_MIN,
            "leaf_ids_equal_native_rows": len(yte),
            "max_err_over_bound": err, "card": card}
    emit(line)
    return lc, line


def forced_splits_json(X):
    """A depth-2 forced tree on FORCED_FEATURES at their medians over the
    rows X: the root, then its left and its right child."""
    f0, f1, f2 = FORCED_FEATURES
    med = [float(np.median(X[:, f])) for f in FORCED_FEATURES]
    return {"feature": f0, "threshold": med[0],
            "left": {"feature": f1, "threshold": med[1]},
            "right": {"feature": f2, "threshold": med[2]}}


def path_features(tree):
    """The features on each root-to-leaf path of a host tree."""
    out, stack = [], [(0, frozenset())] if tree.num_leaves > 1 else []
    while stack:
        node, feats = stack.pop()
        feats = feats | {int(tree.split_feature[node])}
        for c in (int(tree.left_child[node]), int(tree.right_child[node])):
            if c < 0:
                out.append(feats)
            else:
                stack.append((c, feats))
    return out


def check_forced(g, forced):
    """Every tree's first three internal nodes are the forced splits:
    node 0 the root, 1 and 2 its children, each on its feature at the
    bin upper bound of its median."""
    mappers = g.train_data.bin_mappers
    want = [(forced["feature"], forced["threshold"]),
            (forced["left"]["feature"], forced["left"]["threshold"]),
            (forced["right"]["feature"], forced["right"]["threshold"])]
    for i, t in enumerate(g.models_):
        if t.left_child[0] != 1 or t.right_child[0] != 2:
            raise AssertionError(f"forced: tree {i}'s root children are "
                                 f"{t.left_child[0]}, {t.right_child[0]}")
        for j, (f, v) in enumerate(want):
            m = mappers[f]
            thr = m.bin_to_value(m.value_to_bin(v))
            if t.split_feature[j] != f or t.threshold[j] != thr:
                raise AssertionError(
                    f"forced: tree {i} node {j} splits feature "
                    f"{t.split_feature[j]} at {t.threshold[j]!r}, not "
                    f"{f} at {thr!r}")


def phase_forced_interaction(lgb, H, global_timer, card, main, bench):
    """Forced splits and interaction constraints at the main path's width,
    on the bench Dataset (module docstring, phase 5.2).  Returns
    (launches, lines)."""
    (X, y, Xte, yte), ds = bench
    forced = forced_splits_json(X)
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", "chip_smoke_forced_splits.json")
    with open(path, "w") as f:
        json.dump(forced, f)
    sets = [list(s) for s in INTERACTION_SETS]
    launches, lines = {}, {}
    for name, extra, auc_min in (
            ("forced", {"forcedsplits_filename": path}, FORCED_AUC_MIN),
            ("interaction", {"interaction_constraints": sets},
             INTERACTION_AUC_MIN)):
        r = drive_path(lgb, H, global_timer, f"forced_interaction_{name}",
                       extra, 13, (X, y, Xte, yte), train_set=ds)
        g = r["booster"]._gbdt
        lc = r["launches"]
        if lc["K1"] <= 0 or lc["K3"] <= 0:
            raise AssertionError(f"{name}: K1/K3 not launched: {lc}")
        if name == "forced":
            check_forced(g, forced)
            gate = {"forced_nodes_per_tree": 3, "trees": len(g.models_)}
        else:
            for i, t in enumerate(g.models_):
                for feats in path_features(t):
                    if not any(feats <= set(s) for s in INTERACTION_SETS):
                        raise AssertionError(f"interaction: tree {i} has a "
                                             f"path on {sorted(feats)}")
            gate = {"paths_checked": sum(len(path_features(t))
                                         for t in g.models_),
                    "sets": sets}
        if r["auc"] < auc_min:
            raise AssertionError(f"{name}: held-out AUC {r['auc']} < "
                                 f"{auc_min}")
        line = {"phase": "forced_interaction", "run": name,
                "rows": X.shape[0], "params": extra, "iterations": 13,
                "s_per_iter_4_13": r["s_per_iter"],
                "main_path_s_per_iter_4_13": main["s_per_iter"],
                "split_find_device_ms_per_iter": r["ms_per_iter"].get(
                    "Tree::split_find::device"),
                "main_path_split_find_device_ms_per_iter": main[
                    "ms_per_iter"].get("Tree::split_find::device"),
                "launches": lc, "peak_mem_gib": r["peak_gib"],
                "heldout_auc": r["auc"], "auc_min": auc_min,
                "main_path_heldout_auc": main["auc"],
                "leaves_per_tree": [t.num_leaves for t in g.models_],
                **gate, "card": card}
        if name == "forced":
            line["forced_splits"] = forced
        emit(line)
        launches[name] = lc
        lines[name] = line
        del r, g
    return launches, lines


RANK_F = 136                  # MSLR-WEB30K's features
RANK_MAX_LEN = 1251           # its longest query
RANK_ROWS = 1 << 20           # whole queries up to at least this many rows
RANK_VALID_ROWS = 100_000
RANK_EVAL_AT = (1, 3, 5, 10)
RANK_PARAMS = {"num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
               "min_data_in_leaf": 20, "tpu_growth_strategy": "wave",
               "verbosity": -1, "device_type": "cuda"}
# held-out NDCG@10 after 13 iterations: chip_rehearsal.py ranking at 1/8
# of the rows, less a margin (PERF.md)
RANK_NDCG_MIN = {"lambdarank": 0.596, "rank_xendcg": 0.596}
# the ranking card-vs-CPU cases (their CPU sides took 40-57 s each at
# 65,536 rows, PERF.md) and the file phase
CARD_RANK_ROWS = 32_768
FILE_ROWS = 65_536


def make_mslr_like(n_rows, seed=0):
    """Ranking data of MSLR-WEB30K's published shape (the "MS LTR" set of
    LightGBM's docs/Experiments.rst): 136 float32 features, query
    lengths from 1 to 1,251 documents (lognormal, mean about 120), whole
    queries until at least `n_rows` rows, graded labels 0-4 skewed
    toward 0 (shares 0.52 / 0.32 / 0.12 / 0.03 / 0.01, from a latent
    score of 20 features, a per-query effect and noise).  Features sit
    on a 1/16 grid (as MSLR's counts and scores are mostly short
    decimals), so a text file of them parses back to the same values.
    Returns (X [n, 136] float32, y float32, query sizes, position: each
    document's index in its query)."""
    rng = np.random.RandomState(seed)
    lens = np.clip(np.round(rng.lognormal(4.56, 0.7, 4 * n_rows // 100
                                          + 16)), 1, RANK_MAX_LEN)
    lens = lens.astype(np.int64)
    ends = np.cumsum(lens)
    nq = int(np.searchsorted(ends, n_rows)) + 1
    lens, n = lens[:nq], int(ends[nq - 1])
    X = np.empty((n, RANK_F), np.float32)
    for f in range(RANK_F):
        kind = f % 4
        col = (rng.randn(n) if kind == 0
               else np.abs(rng.randn(n)) ** 1.5 * 4 if kind == 1
               else rng.rand(n) if kind == 2
               else rng.poisson(3.0, n).astype(np.float64))
        X[:, f] = np.round(col * 16) / 16
    w = np.random.RandomState(4321).randn(20)
    qeff = np.repeat(rng.randn(nq), lens)
    latent = X[:, :20] @ w / 8 + 0.5 * qeff + rng.randn(n)
    cuts = np.quantile(latent, (0.52, 0.84, 0.96, 0.99))
    y = np.searchsorted(cuts, latent, side="right").astype(np.float32)
    position = np.arange(n) - np.repeat(ends[:nq] - lens, lens)
    return X, y, lens, position


def head_queries(lens, rows):
    """(query count, row count) of the whole queries that fit in `rows`."""
    ends = np.cumsum(lens)
    nq = int(np.searchsorted(ends, rows, side="right"))
    return nq, int(ends[nq - 1])


def ranking_data():
    """The ranking phase's rows: make_mslr_like at RANK_ROWS (seed 0) and
    RANK_VALID_ROWS held-out rows (seed 1)."""
    return make_mslr_like(RANK_ROWS), make_mslr_like(RANK_VALID_ROWS, 1)


def phase_ranking(lgb, H, global_timer, card, data):
    """lambdarank and rank_xendcg at MSLR-WEB30K's width (gates in the
    module docstring): one Dataset of the rows, binned once, a valid set
    on its bin mappers; per run 13 updates with the launch counts set to
    0 just before and read just after, the valid NDCG after each, then
    the gradients step alone (its peak device memory) and three
    instrumented iterations (`GBDT::eval` around the valid evaluation,
    as `train` has it).  Returns {run: launches}."""
    (X, y, lens, _), (Xv, yv, lv, _) = data
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, group=lens,
                     params=dict(RANK_PARAMS)).construct()
    valid = ds.create_valid(Xv, label=yv, group=lv).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    out = {}
    for name in ("lambdarank", "rank_xendcg"):
        params = {**RANK_PARAMS, "objective": name, "metric": "ndcg",
                  "eval_at": list(RANK_EVAL_AT)}
        booster = lgb.Booster(params=params, train_set=ds)
        booster.add_valid(valid, "valid")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(H)
        iters, evals, ndcg = [], [], []
        for _ in range(13):
            t0 = time.perf_counter()
            if booster.update():
                raise AssertionError(f"ranking {name}: training stopped "
                                     "early")
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            res = {m: v for _, m, v, _ in booster.eval_valid()}
            evals.append(time.perf_counter() - t0)
            ndcg.append(res)
        launches = launch_counts(H)
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the gradients step alone: its peak over what is held before it
        g = booster._gbdt
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        g._compute_gradients()
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        grad_peak = torch.cuda.max_memory_allocated()
        global_timer.reset()
        global_timer.enabled = True
        for _ in range(3):
            booster.update()
            with global_timer.scope("GBDT::eval"):
                booster.eval_valid()
        torch.cuda.synchronize()
        snap = global_timer.snapshot()
        global_timer.enabled = False
        ms = {k: v[0] * 1e3 / 3 for k, v in snap.items()}
        last = iters[3:]
        line = {
            "phase": "ranking", "run": name, "rows": X.shape[0],
            "queries": len(lens), "features": X.shape[1],
            "max_query_len": int(lens.max()),
            "mean_query_len": float(lens.mean()),
            "valid_rows": Xv.shape[0], "valid_queries": len(lv),
            "num_leaves": 255, "max_bin": 255, "iterations": 13,
            "construct_s": construct_s, "first_iter_s": iters[0],
            "s_per_iter_last10": sum(last) / len(last), "iter_s": iters,
            "valid_eval_s_per_iter": sum(evals) / len(evals),
            "gradients_ms_per_iter": ms.get("GBDT::gradients"),
            "gradients_alone_s": grad_s,
            "split_find_device_ms_per_iter": ms.get(
                "Tree::split_find::device"),
            "histogram_device_ms_per_iter": ms.get(
                "Tree::histogram::device"),
            "partition_device_ms_per_iter": ms.get(
                "Tree::partition::device"),
            "eval_ms_per_iter": ms.get("GBDT::eval"),
            "breakdown_ms_per_iter": ms,
            "peak_mem_gib": peak, "gradients_peak_gib": grad_peak / 2**30,
            "gradients_extra_gib": (grad_peak - held) / 2**30,
            "launches": launches,
            "valid_ndcg10_iter1": ndcg[0]["ndcg@10"],
            "valid_ndcg10_iter13": ndcg[-1]["ndcg@10"],
            "valid_ndcg_iter13": ndcg[-1],
            "ndcg10_min": RANK_NDCG_MIN[name],
            "leaves_per_tree": [t.num_leaves for t in g.models_[:13]],
            "card": card}
        emit(line)
        if launches["K1"] <= 0 or launches["K3"] <= 0:
            raise AssertionError(f"ranking {name}: K1 and K3 must launch: "
                                 f"{launches}")
        if not ndcg[-1]["ndcg@10"] > ndcg[0]["ndcg@10"]:
            raise AssertionError(f"ranking {name}: valid NDCG@10 did not "
                                 f"rise: {ndcg[0]['ndcg@10']} -> "
                                 f"{ndcg[-1]['ndcg@10']}")
        if ndcg[-1]["ndcg@10"] < RANK_NDCG_MIN[name]:
            raise AssertionError(f"ranking {name}: valid NDCG@10 "
                                 f"{ndcg[-1]['ndcg@10']} < "
                                 f"{RANK_NDCG_MIN[name]}")
        out[f"ranking_{name}"] = launches
        del booster, g
    return out


def write_rank_files(X, y, lens, w, folder):
    """The rows as a TSV file with a header (label first) and as a
    LibSVM file (every feature written, zeros too), each with `.query`
    and `.weight` side files.  Returns (tsv path, libsvm path)."""
    os.makedirs(folder, exist_ok=True)
    tsv = os.path.join(folder, "rank.tsv")
    svm = os.path.join(folder, "rank.svm")
    mat = np.column_stack([y.astype(np.float64), X.astype(np.float64)])
    head = "\t".join(["label"] + [f"f{i}" for i in range(X.shape[1])])
    np.savetxt(tsv, mat, fmt="%.8g", delimiter="\t", header=head,
               comments="")
    np.savetxt(svm, mat, fmt=["%.8g"] + [f"{j}:%.8g"
                                         for j in range(X.shape[1])],
               delimiter=" ")
    for path in (tsv, svm):
        np.savetxt(path + ".query", lens, fmt="%d")
        np.savetxt(path + ".weight", w, fmt="%.8g")
    return tsv, svm


def phase_file(lgb, H, card, data):
    """The file front end at the ranking width (gates in the module
    docstring): the first FILE_ROWS rows of the ranking data, in
    whole queries, written as TSV and LibSVM with side files, loaded
    whole, with two_round=true, and through save_binary, each held to
    the Dataset built from the arrays; three lambdarank iterations on
    the TSV's Dataset and the arrays' grow the same trees."""
    import lightgbm_tpu_torch.native as native
    from lightgbm_tpu_torch.io import parser
    X, y, lens, _ = data
    nq, n = head_queries(lens, FILE_ROWS)
    X, y, lens = X[:n], y[:n], lens[:nq]
    w = (np.round((0.5 + np.random.RandomState(12).rand(n)) * 64)
         / 64).astype(np.float32)
    folder = os.path.join("build", "chip_smoke_files")
    t0 = time.perf_counter()
    tsv, svm = write_rank_files(X, y, lens, w, folder)
    write_s = time.perf_counter() - t0
    if native.parser_lib() is None:
        raise AssertionError("file: the native parser did not build")
    calls = {"dense": 0, "libsvm": 0}
    real = {"dense": native.parse_dense_native,
            "libsvm": native.parse_libsvm_native}

    def counted(kind):
        def fn(*a, **kw):
            calls[kind] += 1
            return real[kind](*a, **kw)
        return fn
    native.parse_dense_native = counted("dense")
    native.parse_libsvm_native = counted("libsvm")
    ds_params = {"max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
                 "device_type": "cuda"}
    tsv_params = {**ds_params, "header": True, "label_column": "name:label"}
    t0 = time.perf_counter()
    arrays = lgb.Dataset(X, label=y, group=lens, weight=w,
                         params=ds_params).construct()
    want = arrays._core
    array_s = time.perf_counter() - t0
    loads, load_s = {}, {}
    try:
        for name, path, params in (
                ("tsv", tsv, tsv_params),
                ("tsv_two_round", tsv, {**tsv_params, "two_round": True}),
                ("libsvm", svm, ds_params),
                ("libsvm_two_round", svm, {**ds_params,
                                           "two_round": True})):
            t0 = time.perf_counter()
            loads[name] = lgb.Dataset(path, params=params).construct()
            load_s[name] = time.perf_counter() - t0
        for name in ("tsv", "libsvm"):
            binpath = os.path.join(folder, f"{name}.bin")
            loads[name]._core.save_binary(binpath)
            t0 = time.perf_counter()
            loads[f"{name}_binary"] = lgb.Dataset(
                binpath, params=ds_params).construct()
            load_s[f"{name}_binary"] = time.perf_counter() - t0
        native_calls = dict(calls)
        t0 = time.perf_counter()
        parser.parse_file(tsv, has_header=True)
        native_s = time.perf_counter() - t0
        keep = native.parser_lib
        native.parser_lib = lambda: None
        try:
            t0 = time.perf_counter()
            parser.parse_file(tsv, has_header=True)
            numpy_s = time.perf_counter() - t0
        finally:
            native.parser_lib = keep
    finally:
        native.parse_dense_native = real["dense"]
        native.parse_libsvm_native = real["libsvm"]
    if native_calls["dense"] <= 0 or native_calls["libsvm"] <= 0:
        raise AssertionError(f"file: the native parser was not used: "
                             f"{native_calls}")
    for name, d in loads.items():
        core = d._core
        if not np.array_equal(core.binned_host(), want.binned_host()):
            raise AssertionError(f"file {name}: bin codes differ from the "
                                 "array-built Dataset's")
        for f in ("label", "weight", "query_boundaries"):
            if not np.array_equal(getattr(core.metadata, f),
                                  getattr(want.metadata, f)):
                raise AssertionError(f"file {name}: {f} differs from the "
                                     "array-built Dataset's")
    params = {**ds_params, "objective": "lambdarank", "num_leaves": 255,
              "learning_rate": 0.1}

    def trees(ds):
        text = lgb.train(params, ds, 3).model_to_string()
        return text.split("Tree=0", 1)[1].split("end of trees")[0]
    # the Datasets compared above, now handed to the boosters
    reset_counts(H)
    from_file = trees(loads["tsv"])
    launches = launch_counts(H)
    from_arrays = trees(arrays)
    if from_file != from_arrays:
        raise AssertionError("file: the TSV's trees differ from the "
                             "arrays' trees")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"file: K1 and K3 must launch: {launches}")
    emit({"phase": "file", "rows": n, "queries": nq, "features": X.shape[1],
          "tsv_mb": os.path.getsize(tsv) / 1e6,
          "libsvm_mb": os.path.getsize(svm) / 1e6, "write_s": write_s,
          "array_construct_s": array_s, "load_s": load_s,
          "native_parse_s": native_s, "native_rows_per_s": n / native_s,
          "numpy_parse_s": numpy_s, "numpy_rows_per_s": n / numpy_s,
          "native_parser_calls": native_calls,
          "equal_to_arrays": sorted(loads), "trees_equal": True,
          "launches": launches, "card": card})
    return launches


def phase_kernels_ranking_width(H, dev):
    """K1 (256 slots) and K3 (8 slots) at the ranking width, RANK_F
    features of 255 bins, held bit for bit against their plain versions
    and on repeat, as the main rows are.  Returns {kernel: row}."""
    W = (RANK_F, B)
    out = {}
    for name, NL in (("K1", 256), ("K3", 8)):
        binned, binned_rm, slot, gh = kernel_inputs(NL, dev, seed=900 + NL,
                                                    width=W)
        if name == "K1":
            k = functools.partial(H.build_histogram_wave, binned, slot, gh,
                                  max_bin=B, num_slots=NL)
            p = functools.partial(H.build_histogram_wave_plain, binned, slot,
                                  gh, max_bin=B, num_slots=NL)
            counter, extra = H.build_histogram_wave, {"num_slots": NL}
            slots = NL
        else:
            Kb = H.wave_slot_pad(NL)
            k = functools.partial(H.build_histogram_wave_hl, binned,
                                  binned_rm, slot, gh, max_bin=B,
                                  num_slots=NL, out_slots=Kb)
            p = functools.partial(H.build_histogram_wave_hl_plain, binned,
                                  binned_rm, slot, gh, max_bin=B,
                                  num_slots=NL, out_slots=Kb)
            counter, extra = H.build_histogram_wave_hl, {"num_slots": NL,
                                                         "out_slots": Kb}
            slots = Kb
        lib, rows_in = wave_yardstick(binned, slot, gh, NL, dev, width=W)
        bound, by = bound_of(RANK_F * N_KERNEL, N_KERNEL, slots, rows_in,
                             width=W)
        out[name] = kernel_row(name, counter, k, p, lib, ranking_width=True,
                               features=RANK_F, max_bin=B, bound_ms=bound,
                               bound_by=by, **extra)
        del lib, binned, binned_rm, slot, gh
    return out


def check_kernels(what, launches, want):
    """The kernels `want` launched and no other one: they carried every
    histogram of the run."""
    if any(launches[k] <= 0 for k in want) or any(
            launches[k] for k in KERNELS if k not in want):
        raise AssertionError(f"{what}: {want} must carry every histogram: "
                             f"{launches}")


# the wide_bins phase: the main path's workload at this many bins
WIDE_MAX_BIN = 1023
WIDE_RUNS = (("wave", {}, 13), ("quantized", {"use_quantized_grad": True}, 13),
             ("leafwise", {"tpu_growth_strategy": "leafwise"}, 3))
# held-out AUC of the 3 leaf-wise iterations: 0.70242 in
# chip_rehearsal.py wide_bins at 1/8 of the rows, less 0.01
WIDE_LEAFWISE_AUC_MIN = 0.692


def phase_wide_bins(lgb, H, global_timer, card, main, data):
    """The main path's workload at max_bin=WIDE_MAX_BIN on its own
    Dataset, binned on the host: the wave engine (K3 on the first
    waves, K1 where 8 and more slots exceed K3's tile), quantized (K2)
    and the leaf-wise engine (K4), on 16-bit device codes.  Returns
    {run: launches}."""
    X, y, Xte, yte = data
    t0 = time.perf_counter()
    ds = lgb.Dataset(X, label=y, params={**BENCH_PARAMS,
                                         "max_bin": WIDE_MAX_BIN}).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    out, wave_auc = {}, None
    for name, extra, iters in WIDE_RUNS:
        r = drive_path(lgb, H, global_timer, f"wide_bins_{name}",
                       {"max_bin": WIDE_MAX_BIN, **extra}, iters, data,
                       train_set=ds)
        g, lc = r["booster"]._gbdt, r["launches"]
        if g.binned_dev.dtype != torch.int16:
            raise AssertionError(f"wide_bins {name}: device codes "
                                 f"{g.binned_dev.dtype}, not 16-bit")
        check_kernels(f"wide_bins {name}", lc,
                      {"wave": ("K1", "K3"), "quantized": ("K2",),
                       "leafwise": ("K4",)}[name])
        if name == "wave":
            wave_auc = r["auc"]
            if r["auc"] < 0.72:
                raise AssertionError(f"wide_bins wave: held-out AUC "
                                     f"{r['auc']} < 0.72")
        elif name == "quantized" and abs(r["auc"] - wave_auc) > 0.01:
            raise AssertionError(f"wide_bins quantized: held-out AUC "
                                 f"{r['auc']} is more than 0.01 from the "
                                 f"float run's {wave_auc}")
        elif name == "leafwise" and r["auc"] < WIDE_LEAFWISE_AUC_MIN:
            raise AssertionError(f"wide_bins leafwise: held-out AUC "
                                 f"{r['auc']} < {WIDE_LEAFWISE_AUC_MIN}")
        ms = r["ms_per_iter"]
        ref = main["path_b"] if name == "leafwise" else main
        emit({"phase": "wide_bins", "run": name, "max_bin": WIDE_MAX_BIN,
              "rows": X.shape[0], "iterations": iters,
              "construct_s": construct_s,
              "s_per_iter": r["s_per_iter"],
              "same_engine_255_bins_s_per_iter": ref["s_per_iter"],
              **{f"{k.split('::')[1]}_device_ms_per_iter": ms.get(k)
                 for k in ("Tree::histogram::device",
                           "Tree::split_find::device",
                           "Tree::partition::device")},
              "same_engine_255_bins_histogram_device_ms_per_iter": ref[
                  "ms_per_iter"].get("Tree::histogram::device"),
              "peak_mem_gib": r["peak_gib"], "launches": lc,
              "heldout_auc": r["auc"], "card": card})
        out[f"wide_bins_{name}"] = lc
        del r, g
    del ds
    return out


# the monotone_modes phase: the monotone signs of the three strongest
# features of make_higgs_like's logit (all N(0, 1) columns; the
# split_features phase's uniform MONOTONE_FEATURES go unsplit in 5
# leaf-wise trees of 1M rows, where a sweep would gate nothing), and lazy
# CEGB's per-row penalty of every feature
MODE_MONOTONE_FEATURES = (9, 18, 27)
LAZY_PER_ROW = 2e-4
# held-out AUC after 5 iterations: chip_rehearsal.py monotone_modes at
# 1/8 of the rows gave 0.69432 (intermediate), 0.70092 (advanced) and
# 0.70948 (lazy), less 0.01
MONO_MODE_AUC_MIN = {"intermediate": 0.684, "advanced": 0.690,
                     "lazy": 0.699}


def phase_monotone_modes(lgb, H, global_timer, card, main, bench):
    """The main path's workload on the leaf-wise engine with the monotone
    signs of MODE_MONOTONE_FEATURES under the intermediate and the
    advanced method, and with lazy CEGB (LAZY_PER_ROW on every feature):
    5 iterations each.  Returns {run: launches}."""
    data, ds = bench
    X, _, Xte, _ = data
    mc = monotone_signs(MODE_MONOTONE_FEATURES)
    runs = (("intermediate", {"monotone_constraints": mc,
                              "monotone_constraints_method":
                                  "intermediate"}),
            ("advanced", {"monotone_constraints": mc,
                          "monotone_constraints_method": "advanced"}),
            ("lazy", {"cegb_penalty_feature_lazy": [LAZY_PER_ROW] * F}))
    out = {}
    for name, extra in runs:
        r = drive_path(lgb, H, global_timer, f"monotone_modes_{name}",
                       {"tpu_growth_strategy": "leafwise", **extra}, 5,
                       data, train_set=ds)
        b, g, lc = r["booster"], r["booster"]._gbdt, r["launches"]
        gp = g.grow_params
        check_kernels(f"monotone_modes {name}", lc, ("K4",))
        if (g.growth_strategy != "leafwise"
                or gp.monotone_intermediate != (name != "lazy")
                or gp.monotone_advanced != (name == "advanced")
                or gp.split.has_cegb_lazy != (name == "lazy")):
            raise AssertionError(f"monotone_modes {name}: the mode's flags "
                                 f"or engine differ: {gp}")
        if r["auc"] < MONO_MODE_AUC_MIN[name]:
            raise AssertionError(f"monotone_modes {name}: held-out AUC "
                                 f"{r['auc']} < {MONO_MODE_AUC_MIN[name]}")
        line = {}
        if name == "lazy":
            # rows are fetched for the features the trees split on only
            used = set(distinct_features(g.models_))
            fetched = g.lazy_used[:, :g.num_data].sum(1).cpu().numpy()
            if any(bool(fetched[f]) != (f in used) for f in range(F)):
                raise AssertionError("monotone_modes lazy: fetched rows "
                                     f"{fetched.tolist()}, split features "
                                     f"{sorted(used)}")
            line.update(distinct_features=len(used),
                        fetched_rows=fetched.tolist())
        else:
            sweep = monotone_sweep(f"monotone_modes {name}", b, X, Xte, mc)
            if not any(sweep.values()):
                raise AssertionError(f"monotone_modes {name}: no constrained "
                                     "feature moves a prediction")
            line.update(monotone_constraints=mc,
                        mean_abs_sweep_change=sweep)
        ms = r["ms_per_iter"]
        emit({"phase": "monotone_modes", "run": name, "rows": X.shape[0],
              "iterations": 5, "s_per_iter": r["s_per_iter"],
              "path_b_s_per_iter": main["path_b"]["s_per_iter"],
              "monotone_rescan_device_ms_per_iter": ms.get(
                  "Tree::monotone_rescan::device"),
              "split_find_device_ms_per_iter": ms.get(
                  "Tree::split_find::device"),
              "path_b_split_find_device_ms_per_iter": main["path_b"][
                  "ms_per_iter"].get("Tree::split_find::device"),
              "histogram_device_ms_per_iter": ms.get(
                  "Tree::histogram::device"),
              "peak_mem_gib": r["peak_gib"], "launches": lc,
              "heldout_auc": r["auc"], "auc_min": MONO_MODE_AUC_MIN[name],
              "leaves_per_tree": [t.num_leaves for t in g.models_],
              **line, "card": card})
        out[f"monotone_modes_{name}"] = lc
        del r, b, g
    return out


def case_inputs(name, extra, categorical=False, label="binary",
                data="higgs", forced=False, rank=None, rows=CARD_ROWS):
    """The inputs of one card-vs-CPU case: `train` at `rows` rows, 3
    iterations (`categorical`: the split_features phase's transform of
    the data, columns 0, 1 and 3 as `categorical_feature`; `label`:
    "binary", the objectives phase's "regression" label, its
    non-negative part ("nonnegative") or its class label cut into 3
    classes ("multiclass3"); `data`: "higgs", or the efb phase's
    construction with CARD_EFB_LEVELS (CARD_WIDE_EFB_LEVELS when `extra`
    sets max_bin) as CSR ("efb_csr") or as a dense
    numpy matrix ("efb_dense"), bundled on both devices, or "mslr", the
    whole queries of the ranking data `rank` = (X, y, query sizes,
    positions) in its first CARD_RANK_ROWS rows, with their group and,
    when `extra` sets lambdarank_position_bias_regularization, their
    positions; `forced`: the forced splits of the rows' medians, written
    to a JSON file that both devices read)."""
    ds_kw = {}
    if data == "higgs":
        X, y = make_higgs_like(rows, 28, seed=2)
    elif data == "mslr":
        X, y, lens, pos = rank
        nq, n = head_queries(lens, CARD_RANK_ROWS)
        X, y = X[:n], y[:n]
        ds_kw = {"group": lens[:nq]}
        if "lambdarank_position_bias_regularization" in extra:
            ds_kw["position"] = pos[:n]
    else:
        X, y = make_onehot_csr(rows, seed=2, levels=(
            CARD_WIDE_EFB_LEVELS if "max_bin" in extra else CARD_EFB_LEVELS))
        if data == "efb_dense":
            X = X.toarray()
    if forced:
        os.makedirs("build", exist_ok=True)
        path = os.path.join("build", f"chip_smoke_forced_{name}.json")
        forced = forced_splits_json(X)
        with open(path, "w") as f:
            json.dump(forced, f)
        extra = {**extra, "forcedsplits_filename": path}
    if label != "binary":
        reg, _, _ = objective_labels(X, 2)
        latent = higgs_logit(X) + np.random.RandomState(33).logistic(
            size=len(X))
        y = {"regression": reg, "nonnegative": np.maximum(reg, 0.0),
             "multiclass3": np.searchsorted(
                 np.quantile(latent, (1 / 3, 2 / 3)), latent,
                 side="right").astype(np.float32)}[label]
    if categorical:
        X, = categorical_transform(X)
        ds_kw = {"categorical_feature": list(CAT_COLUMNS)}
    params = {"objective": "binary", "num_leaves": 255, "learning_rate": 0.1,
              "max_bin": 255, "min_data_in_leaf": 20, "verbosity": -1,
              **extra}
    return {"name": name, "X": X, "y": y, "ds_kw": ds_kw, "params": params,
            "forced": forced, "extra": extra, "categorical": categorical,
            "label": label, "data": data}


def train_case(lgb, inputs, dev):
    """A case's 3 iterations on `dev`: (trees, bundle groups or None);
    forced splits are held on the way."""
    b = lgb.train({**inputs["params"], "device_type": dev},
                  lgb.Dataset(inputs["X"], label=inputs["y"],
                              **inputs["ds_kw"]), num_boost_round=3)
    if inputs["forced"]:
        check_forced(b._gbdt, inputs["forced"])
    plan = b._gbdt.bundle_plan
    return b._gbdt.models_, None if plan is None else plan.groups


def cpu_case(inputs):
    """A case's CPU side, in a worker process (CARD_CPU_WORKERS of them
    train while the card sides run in the main process)."""
    torch.set_num_threads(CARD_CPU_THREADS)
    import lightgbm_tpu_torch as lgb
    return train_case(lgb, inputs, "cpu")


def phase_card_vs_cpu(lgb, H, inputs, cpu_side=None):
    """One case (`case_inputs`) on the card and on the CPU (`cpu_side()`,
    the worker's result, or trained here): the same trees, category sets
    included; linear trees' per-row outputs on the rows, the first
    tree's within LINEAR_FIT_REL · max(1, |output|) (the same
    gradients), later ones' within LINEAR_LATER_ATOL · max(1, |output|)
    (gradients at scores that differ by float32 roundings).  Returns the
    card run's launches."""
    name, X, extra = inputs["name"], inputs["X"], inputs["extra"]
    categorical, data = inputs["categorical"], inputs["data"]
    reset_counts(H)
    models, plans = {}, {}
    models["cuda"], plans["cuda"] = train_case(lgb, inputs, "cuda")
    launches = launch_counts(H)
    models["cpu"], plans["cpu"] = (cpu_side() if cpu_side is not None
                                   else train_case(lgb, inputs, "cpu"))
    if data.startswith("efb") and (
            plans["cuda"] is None or plans["cpu"] is None
            or plans["cuda"] != plans["cpu"]):
        raise AssertionError(f"{name}: the bundle plans differ or are "
                             "missing")
    worst = 0.0
    linear_worst = {}
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
        if a.is_linear or b.is_linear:
            X64 = np.asarray(X, np.float64)
            pa, pb = a.predict(X64), b.predict(X64)
            tol = LINEAR_FIT_REL if i == 0 else LINEAR_LATER_ATOL
            ratio = np.abs(pa - pb) / (tol * np.maximum(1.0, np.abs(pb)))
            if not (a.is_linear and b.is_linear) or (ratio > 1).any():
                raise AssertionError(f"{name} tree {i}: linear outputs "
                                     "differ")
            linear_worst[i] = float(ratio.max())
    K = extra.get("num_class", 1)
    if len(models["cuda"]) != 3 * K or len(models["cpu"]) != 3 * K:
        raise AssertionError(f"{name}: card/CPU tree counts differ from "
                             f"{3 * K}")
    if categorical and cat_nodes == 0:
        raise AssertionError(f"{name}: no categorical split to compare")
    emit({"phase": "card_vs_cpu", "path": name, "params": extra,
          "rows": X.shape[0], "trees": 3 * K, "categorical": categorical,
          "label": inputs["label"], "data": data, "columns": X.shape[1],
          "bundle_columns": (None if plans["cuda"] is None
                             else len(plans["cuda"])),
          "categorical_nodes": cat_nodes,
          "leaves": [t.num_leaves for t in models["cuda"]],
          "max_rel_leaf_diff": worst,
          "linear_output_err_over_bound": linear_worst or None,
          "card_launches": launches})
    return launches


# held-out AUC of the linear run: chip_rehearsal.py linear at 1/8 of the
# rows gave 0.73092 (PERF.md), less 0.01
LINEAR_AUC_MIN = 0.720
LINEAR_FIT_REL = 1e-9          # device fit against the plain one, per row
LINEAR_LATER_ATOL = 1e-4       # card against CPU, trees after the first
LINEAR_FIT_TREES = (0, 12)     # the trees whose fit is held to the plain
REFIT_SLACK = 4.0              # float32 roundings the refit bound allows
CONTRIB_ROWS = 2048
CLI_ROWS = 65_536


def hold_linear_fit(g, what, pre, fitted, raw, ids, grad, hess):
    """The device fit `fitted` of the tree `pre` against
    calculate_linear_plain on the same leaf ids and gradients (pulled):
    each row's leaf output within LINEAR_FIT_REL · max(1, |output|).
    Returns the largest error over its bound."""
    import copy
    from lightgbm_tpu_torch.learner.linear import (calculate_linear_plain,
                                                   linear_outputs,
                                                   raw_to_device)
    ds = g.train_data
    plain = copy.deepcopy(pre)
    calculate_linear_plain(
        plain, raw, ids, grad, hess, g.config.linear_lambda,
        lambda f: ds.bin_mappers[f].bin_type == 0, ds.inner_feature_index)
    raw_cpu = raw_to_device(raw, torch.device("cpu"))
    ids_cpu = torch.from_numpy(ids)
    a, b = (linear_outputs(t, raw_cpu, ids_cpu).numpy()
            for t in (plain, fitted))
    ratio = np.abs(a - b) / (LINEAR_FIT_REL * np.maximum(1.0, np.abs(a)))
    if (ratio > 1).any():
        i = int(np.argmax(ratio))
        raise AssertionError(f"{what}: row {i}'s leaf output {b[i]!r} of "
                             f"the device fit vs {a[i]!r} of the plain")
    return float(ratio.max())


def phase_linear(lgb, H, global_timer, card, main, data):
    """Linear trees at the main path's width (gates in the module
    docstring): its own Dataset (linear_tree keeps the raw values), the
    fits of LINEAR_FIT_TREES captured as they run (the tree before and
    after the device fit, the leaf ids and gradients cloned on the card)
    and held to the plain version after the 13 updates."""
    import copy
    from lightgbm_tpu_torch.learner.linear import fit_linear
    X = data[0]
    raw = X.astype(np.float64)
    cap = {}

    def capture(b):
        g = b._gbdt
        fit = g._calculate_linear

        def capturing(tree, ids, grad, hess):
            t = len(g.models_)
            if t not in LINEAR_FIT_TREES:
                return fit(tree, ids, grad, hess)
            pre = copy.deepcopy(tree)
            stats = fit(tree, ids, grad, hess)
            cap[t] = (pre, copy.deepcopy(tree), ids.clone(), grad.clone(),
                      hess.clone())
            return stats
        g._calculate_linear = capturing

    check = {}

    def after(b):
        g = b._gbdt
        if not all(t.is_linear for t in g.models_):
            raise AssertionError("linear: a tree is not linear")
        ds = g.train_data
        worst = {}
        for t, (pre, fitted, ids, grad, hess) in sorted(cap.items()):
            worst[t] = hold_linear_fit(
                g, f"linear tree {t}", pre, fitted, raw,
                ids.cpu().numpy(), grad.cpu().numpy(), hess.cpu().numpy())
        pre, fitted, ids, grad, hess = cap[0]
        again = copy.deepcopy(pre)
        fit_linear(again, g.raw_dev, ids, grad, hess,
                   g.config.linear_lambda,
                   lambda f: ds.bin_mappers[f].bin_type == 0,
                   ds.inner_feature_index)
        nl = again.num_leaves
        if (list(again.leaf_const[:nl]) != list(fitted.leaf_const[:nl])
                or again.leaf_coeff[:nl] != fitted.leaf_coeff[:nl]):
            raise AssertionError("linear: tree 0's fit changed bits on a "
                                 "second run")
        # the training scores against the host float64 predictions
        outs = [t.predict(raw) for t in g.models_]
        host = np.sum(outs, axis=0)
        bound = 2 * len(outs) * 2.0 ** -24 * np.sum(np.abs(outs), axis=0)
        sc = g.scores[0, :len(raw)].cpu().numpy().astype(np.float64)
        err = np.abs(sc - host)
        if (err > bound).any():
            i = int(np.argmax(err - bound))
            raise AssertionError(f"linear: row {i} training score {sc[i]!r} "
                                 f"vs host {host[i]!r}, bound {bound[i]!r}")
        text = b.model_to_string()
        Xte = data[2]
        if not np.array_equal(
                lgb.Booster(model_str=text).predict(Xte, raw_score=True),
                b.predict(Xte, raw_score=True)):
            raise AssertionError("linear: the model text predicts other "
                                 "bits")
        st = g.linear_fit_stats[:13]
        check.update({
            "fit_err_over_bound": worst,
            "score_err_over_bound": float((err / bound).max()),
            "raw_device_bytes": g.raw_dev.nbytes,
            "raw_device_dtype": str(g.raw_dev.dtype),
            "leaves_fitted": sum(x.fitted for x in st),
            "leaves_degenerate": sum(x.degenerate for x in st),
            "leaves_pinv": sum(x.pinv for x in st),
            "mean_k": (sum(x.mean_k * x.fitted for x in st)
                       / max(sum(x.fitted for x in st), 1))})
    r = drive_path(lgb, H, global_timer, "linear", {"linear_tree": True},
                   13, data, before_training=capture, after_training=after)
    launches, auc_l = r["launches"], r["auc"]
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"linear: K1 and K3 must launch: {launches}")
    if auc_l < LINEAR_AUC_MIN:
        raise AssertionError(f"linear: held-out AUC {auc_l} < "
                             f"{LINEAR_AUC_MIN}")
    ms = r["ms_per_iter"]
    emit({"phase": "linear_line", "run": "linear",
          "s_per_iter_last10": r["s_per_iter"],
          "main_path_s_per_iter_last10": main["s_per_iter"],
          **{f"{k}_device_ms_per_iter": ms.get(f"{k}::device")
             for k in ("GBDT::linear_fit", "Tree::histogram",
                       "Tree::split_find", "Tree::partition")},
          "main_path_linear_free": {
              f"{k}_device_ms_per_iter": main["ms_per_iter"].get(
                  f"{k}::device") for k in ("Tree::histogram",
                                            "Tree::split_find",
                                            "Tree::partition")},
          **check, "peak_mem_gib": r["peak_gib"], "heldout_auc": auc_l,
          "launches": launches, "card": card})
    return launches


def host_binary_gradients(score, y):
    """Binary logloss gradients in float64 on the host (sigmoid 1)."""
    lv = np.where(y > 0, 1.0, -1.0)
    resp = -lv / (1.0 + np.exp(lv * score))
    a = np.abs(resp)
    return resp, a * (1.0 - a)


def phase_refit_contrib(lgb, booster, data, card):
    """SHAP contributions and refit on the main path's booster after
    `surface` (gates in the module docstring).  The contributions come
    first: a refit rewrites leaf counts, and a leaf its rows leave empty
    gives TreeSHAP a zero path fraction (NaN, in both packages)."""
    import scipy.sparse as sps
    from lightgbm_tpu_torch import native
    _, _, Xte, yte = data
    g = booster._gbdt
    T = len(g.models_)
    cfg = g.config
    X64 = Xte.astype(np.float64)
    # SHAP contributions of the held-out rows
    Xc = X64[:CONTRIB_ROWS]
    calls = dict(native.TREESHAP_CALLS)
    t0 = time.perf_counter()
    phi = booster.predict(Xc, pred_contrib=True)
    contrib_s = time.perf_counter() - t0
    if (native.TREESHAP_CALLS["native"] - calls["native"] != T
            or native.TREESHAP_CALLS["python"] != calls["python"]):
        raise AssertionError("refit_contrib: the native TreeSHAP library "
                             "did not explain every tree")
    raw = g._predict_raw_impl(Xc, 0, -1, False, 10, 10.0)
    scale = np.abs(phi).sum(1)
    sum_err = np.abs(phi.sum(1) - raw)
    if not (sum_err <= 1e-9 * scale).all():
        raise AssertionError("refit_contrib: contributions do not sum to "
                             "the raw score")
    a = np.zeros((16, phi.shape[1]))
    b = np.zeros((16, phi.shape[1]))
    native.tree_shap(g.models_[0], Xc[:16], a)
    native._tree_shap_py(g.models_[0], Xc[:16], b)
    if not np.allclose(a, b, rtol=1e-12, atol=1e-15):
        raise AssertionError("refit_contrib: native TreeSHAP differs from "
                             "the Python fallback")
    csr = booster.predict(sps.csr_matrix(Xc[:256]), pred_contrib=True)
    if not (sps.isspmatrix_csr(csr)
            and np.array_equal(csr.toarray(), phi[:256])):
        raise AssertionError("refit_contrib: CSR contributions differ")
    # refit on the held-out rows
    keys = ("split_feature", "threshold", "decision_type", "left_child",
            "right_child")
    before = [{k: getattr(t, k).copy() for k in keys} for t in g.models_]
    old = [t.leaf_value[:t.num_leaves].copy() for t in g.models_]
    lids = g._packed_for(0, T, 1).predict_leaf(X64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, dispatches = card_predict(lambda: booster.refit(Xte, yte))
    refit_s = time.perf_counter() - t0
    if dispatches <= 0:
        raise AssertionError("refit_contrib: refit made no card dispatch")
    for i, (t, b) in enumerate(zip(g.models_, before)):
        if any(not np.array_equal(getattr(t, k), b[k]) for k in keys):
            raise AssertionError(f"refit_contrib: tree {i}'s splits moved")
    # the plain refit: native leaf ids, float64 host gradients at the
    # float32-rounded running scores, sums in float64; the bound allows
    # each float32 gradient and hessian REFIT_SLACK roundings
    score = np.zeros(len(yte))
    worst = 0.0
    for m, t in enumerate(g.models_):
        nl = t.num_leaves
        lp = lids[:, m]
        gr, he = host_binary_gradients(
            score.astype(np.float32).astype(np.float64), yte)
        sg = np.bincount(lp, weights=gr, minlength=nl)[:nl]
        sh = np.bincount(lp, weights=he, minlength=nl)[:nl] + 1e-15
        sa = np.bincount(lp, weights=np.abs(gr), minlength=nl)[:nl]
        out = -sg / (sh + cfg.lambda_l2)
        plain = (cfg.refit_decay_rate * old[m]
                 + (1 - cfg.refit_decay_rate) * out * t.shrinkage)
        bound = ((1 - cfg.refit_decay_rate) * t.shrinkage * REFIT_SLACK
                 * 2.0 ** -24 * (sa + np.abs(out) * sh) / sh + 1e-15)
        err = np.abs(t.leaf_value[:nl] - plain)
        if not (err <= bound).all():
            j = int(np.argmax(err - bound))
            raise AssertionError(f"refit_contrib: tree {m} leaf {j} refit "
                                 f"{t.leaf_value[j]!r} vs plain "
                                 f"{plain[j]!r}")
        worst = max(worst, float((err / bound).max()))
        score += plain[lp]
    emit({"phase": "refit_contrib", "refit_rows": len(yte),
          "refit_s": refit_s, "refit_card_dispatches": dispatches,
          "refit_err_over_bound": worst, "contrib_rows": CONTRIB_ROWS,
          "contrib_s": contrib_s, "contrib_rows_per_s": CONTRIB_ROWS
          / contrib_s, "contrib_sum_err_over_scale": float(
              (sum_err / scale).max()), "card": card})


def model_trees(text):
    """Model text from `Tree=0` to `end of trees`."""
    return text[text.index("Tree=0"):text.index("end of trees")]


def phase_cli(lgb, H, card, data):
    """The command line in-process on the card (gates in the module
    docstring) on the first CLI_ROWS rows of the main data as a TSV."""
    from lightgbm_tpu_torch import cli
    from lightgbm_tpu_torch.io.parser import parse_file
    X, y = data[0][:CLI_ROWS], data[1][:CLI_ROWS]
    folder = os.path.join("build", "chip_smoke_cli")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "train.tsv")
    model = os.path.join(folder, "model.txt")
    t0 = time.perf_counter()
    np.savetxt(path, np.column_stack([y, X]).astype(np.float64),
               delimiter="\t", fmt="%.9g")
    times = {"write_s": time.perf_counter() - t0}
    params = {k: v for k, v in BENCH_PARAMS.items() if k != "device_type"}
    args = [f"{k}={v}" for k, v in params.items()]
    reset_counts(H)
    t0 = time.perf_counter()
    if cli.main([f"data={path}", "num_iterations=13", *args,
                 f"output_model={model}"]) != 0:
        raise AssertionError("cli: train failed")
    torch.cuda.synchronize()
    times["train_s"] = time.perf_counter() - t0
    launches = launch_counts(H)
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"cli: K1 and K3 must launch: {launches}")
    want = lgb.train(dict(BENCH_PARAMS), lgb.Dataset(path), 13)
    text = open(model).read()
    if model_trees(text) != model_trees(want.model_to_string()):
        raise AssertionError("cli: the trees differ from train on "
                             "Dataset(path)'s")
    feats, labels, _ = parse_file(path)
    pred = os.path.join(folder, "pred.txt")
    t0 = time.perf_counter()
    cli.main(["task=predict", f"data={path}", f"input_model={model}",
              f"output_result={pred}", "verbosity=-1"])
    times["predict_s"] = time.perf_counter() - t0
    expect = "".join(f"{v:.18g}\n" for v in
                     lgb.Booster(model_file=model).predict(feats))
    if open(pred).read() != expect:
        raise AssertionError("cli: predict's file differs from "
                             "Booster.predict")
    refit = os.path.join(folder, "refit.txt")
    t0 = time.perf_counter()
    cli.main(["task=refit", f"data={path}", f"input_model={model}",
              f"output_model={refit}", "verbosity=-1"])
    times["refit_s"] = time.perf_counter() - t0
    again = lgb.Booster(model_file=model).refit(feats, labels)
    if open(refit).read() != again.model_to_string():
        raise AssertionError("cli: refit differs from Booster.refit")
    cpp = os.path.join(folder, "model.cpp")
    cli.main(["task=convert_model", f"input_model={model}",
              f"convert_model={cpp}", "verbosity=-1"])
    src = open(cpp).read()
    if "PredictTree0" not in src:
        raise AssertionError("cli: convert_model wrote no tree")
    emit({"phase": "cli", "rows": CLI_ROWS, **times,
          "convert_bytes": len(src), "launches": launches, "card": card})
    return launches


def card_cases(rank):
    """Every card-vs-CPU case: (inputs, kernels that must launch)."""
    sampling_a, sampling_b, sampling_c = (r[1] for r in SAMPLING_RUNS[:3])
    out = [(case_inputs(name, extra), kernels) for name, extra, kernels in (
        ("main_path", {}, ()),
        ("path_a_quantized", {"use_quantized_grad": True}, ()),
        ("path_b_leafwise", {"tpu_growth_strategy": "leafwise"}, ()),
        ("sampling_a_bagging", sampling_a, ()),
        ("sampling_b_goss_lr0.5", {**sampling_b, "learning_rate": 0.5}, ()),
        ("sampling_c_extra_trees", sampling_c, ()),
        # K2 on a sampling path
        ("sampling_a_quantized", {**sampling_a, "use_quantized_grad": True},
         ("K2",)))]
    # the split_features phase's data: categorical columns 0, 1 and 3
    out += [(case_inputs(name, extra, categorical=True), kernels)
            for name, extra, kernels in (
        ("categorical_wave", {}, ("K1", "K3")),
        ("categorical_extra_trees_leafwise",
         {"extra_trees": True, "tpu_growth_strategy": "leafwise"}, ("K4",)),
        ("categorical_quantized", {"use_quantized_grad": True}, ("K2",)),
        ("monotone_smooth_cegb_leafwise",
         {"monotone_constraints": monotone_signs(), "path_smooth": 1.0,
          "cegb_penalty_split": CEGB_PENALTY_SPLIT,
          "cegb_penalty_feature_coupled": [
              CEGB_COUPLED_PER_ROW * CARD_ROWS] * F,
          "tpu_growth_strategy": "leafwise"}, ("K4",)))]
    # the objectives phase's six cases
    out += [(case_inputs(name, extra, label=lab), kernels)
            for name, extra, lab, kernels in (
        ("regression_l1_wave", {"objective": "regression_l1"},
         "regression", ("K1", "K3")),
        ("multiclass3_wave", {"objective": "multiclass", "num_class": 3},
         "multiclass3", ("K1", "K3")),
        ("multiclass3_quantized", {"objective": "multiclass",
                                   "num_class": 3,
                                   "use_quantized_grad": True},
         "multiclass3", ("K2",)),
        ("tweedie_leafwise", {"objective": "tweedie",
                              "tpu_growth_strategy": "leafwise"},
         "nonnegative", ("K4",)),
        ("dart_wave", DART, "binary", ("K1", "K3")),
        ("rf_leafwise", {**RF, "tpu_growth_strategy": "leafwise"},
         "binary", ("K4",)))]
    # EFB's bundle codes, forced splits and interaction constraints
    out += [(case_inputs(name, extra, data=data,
                         forced=name.startswith("forced")), kernels)
            for name, extra, data, kernels in (
        ("efb_dense_onehot_wave", {"tpu_growth_strategy": "wave"},
         "efb_dense", ("K1", "K3")),
        ("efb_csr_wave", {"tpu_growth_strategy": "wave"}, "efb_csr",
         ("K1", "K3")),
        ("efb_csr_leafwise", {"tpu_growth_strategy": "leafwise"},
         "efb_csr", ("K4",)),
        ("efb_csr_quantized", {"tpu_growth_strategy": "wave",
                               "use_quantized_grad": True}, "efb_csr",
         ("K2",)),
        ("forced_leafwise", {"tpu_growth_strategy": "leafwise"},
         "higgs", ("K4",)),
        ("interaction_leafwise", {
            "tpu_growth_strategy": "leafwise",
            "interaction_constraints": [list(s)
                                        for s in INTERACTION_SETS]},
         "higgs", ("K4",)))]
    # the ranking objectives on the ranking data's first whole queries
    out += [(case_inputs(name, extra, data="mslr", rank=rank), kernels)
            for name, extra, kernels in (
        ("lambdarank_position_bias_wave",
         {"objective": "lambdarank", "tpu_growth_strategy": "wave",
          "lambdarank_position_bias_regularization": 0.1}, ("K1", "K3")),
        ("rank_xendcg_quantized",
         {"objective": "rank_xendcg", "tpu_growth_strategy": "wave",
          "use_quantized_grad": True}, ("K2",)),
        ("lambdarank_leafwise",
         {"objective": "lambdarank", "tpu_growth_strategy": "leafwise"},
         ("K4",)))]
    # linear trees, quantized (K2) and on the leaf-wise engine (K4)
    out += [(case_inputs(name, extra, rows=CARD_LINEAR_ROWS), kernels)
            for name, extra, kernels in (
        ("linear_quantized", {"linear_tree": True,
                              "tpu_growth_strategy": "wave",
                              "use_quantized_grad": True}, ("K2",)),
        ("linear_leafwise", {"linear_tree": True,
                             "tpu_growth_strategy": "leafwise"}, ("K4",)))]
    # more than 256 bins: 16-bit codes through every kernel, and with EFB
    # (one-hot columns bundled beside wide columns of their own)
    wide = {"max_bin": WIDE_MAX_BIN}
    out += [(case_inputs(name, extra, data=data), kernels)
            for name, extra, data, kernels in (
        ("wide_wave", {**wide, "tpu_growth_strategy": "wave"}, "higgs",
         ("K1", "K3")),
        ("wide_quantized", {**wide, "tpu_growth_strategy": "wave",
                            "use_quantized_grad": True}, "higgs", ("K2",)),
        ("wide_leafwise", {**wide, "tpu_growth_strategy": "leafwise"},
         "higgs", ("K4",)),
        ("wide_efb_csr_wave", {**wide, "tpu_growth_strategy": "wave"},
         "efb_csr", ("K1", "K3")))]
    # the leaf-wise engine's intermediate/advanced monotone modes and
    # lazy CEGB (their CPU sides rescan leaves after every split)
    mc = monotone_signs(MODE_MONOTONE_FEATURES)
    out += [(case_inputs(name, {"tpu_growth_strategy": "leafwise", **extra},
                         rows=CARD_LINEAR_ROWS), ("K4",))
            for name, extra in (
        ("intermediate_leafwise", {"monotone_constraints": mc,
                                   "monotone_constraints_method":
                                       "intermediate"}),
        ("advanced_leafwise", {"monotone_constraints": mc,
                               "monotone_constraints_method": "advanced"}),
        ("lazy_leafwise", {"cegb_penalty_feature_lazy":
                           [LAZY_PER_ROW] * F}))]
    return out


# card-vs-CPU cases whose CPU sides take longest (the rescans of the
# monotone modes, the wide scan over EFB's columns)
CPU_FIRST = ("advanced_leafwise", "intermediate_leafwise",
             "wide_efb_csr_wave")


def run_card_vs_cpu(lgb, H, rank):
    """Every case's CPU side in CARD_CPU_WORKERS worker processes (spawned,
    so they hold no CUDA context), while the main process runs the card
    sides in turn and compares each with its CPU side's trees.  Returns
    the gated cases' card launches; the pool is shut down, its queued
    cases cancelled, whatever happens."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    cases = card_cases(rank)
    out = {}
    pool = ProcessPoolExecutor(
        max_workers=CARD_CPU_WORKERS,
        mp_context=multiprocessing.get_context("spawn"))
    try:
        # the slowest CPU sides are queued first, so that they train while
        # the card sides before them run
        futures = [None] * len(cases)
        for i in sorted(range(len(cases)),
                        key=lambda i: cases[i][0]["name"] not in CPU_FIRST):
            futures[i] = pool.submit(cpu_case, cases[i][0])
        for (inputs, kernels), fut in zip(cases, futures):
            card_launches = phase_card_vs_cpu(lgb, H, inputs, fut.result)
            if any(card_launches[k] <= 0 for k in kernels):
                raise AssertionError(f"{inputs['name']}: {kernels} must "
                                     f"launch: {card_launches}")
            if kernels:
                out[f"card_vs_cpu_{inputs['name']}"] = card_launches
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return out


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import _kernels
    from lightgbm_tpu_torch.utils.timer import global_timer
    from lightgbm_tpu_torch.ops import histogram as H

    rss_imported = current_rss_bytes()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    card = card_line()
    # the host resident set before any phase: after the imports, and
    # with the CUDA context up (the efb phase's memory gate reads its
    # growth over the set it begins with)
    rss_gib = {k: (None if v is None else v / 2**30) for k, v in (
        ("imported", rss_imported), ("cuda_context", current_rss_bytes()))}
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "host_rss_gib": rss_gib})

    t0 = time.perf_counter()
    _kernels.build_all()
    for src in _kernels.SOURCES:
        _kernels.lib(src)
    rss = current_rss_bytes()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": list(_kernels.SOURCES),
          "host_rss_gib": None if rss is None else rss / 2**30})
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
    # EFB first: its host memory gate reads the process's resident set
    efb_launches, efb_line = phase_efb(lgb, H, global_timer, card)
    bench = bench_rows(lgb)
    probe.reset()
    launches, main_wall, main = phase_paths(lgb, H, global_timer, probe,
                                            bench)
    launches["efb"] = efb_launches
    fi_launches, _ = phase_forced_interaction(lgb, H, global_timer, card,
                                              main, bench)
    launches.update(fi_launches)
    launches["linear"] = phase_linear(lgb, H, global_timer, card, main,
                                      bench[0])
    launches.update(phase_wide_bins(lgb, H, global_timer, card, main,
                                    bench[0]))
    launches.update(phase_monotone_modes(lgb, H, global_timer, card, main,
                                         bench))
    probe.reset()
    phase_valid_path(lgb, H, global_timer, card, main_wall)
    phase_device_bin(lgb, global_timer)
    launches.update(phase_sampling(lgb, H, global_timer, card,
                                   main["s_per_iter"], bench))
    launches["continue"] = phase_continue(lgb, H, global_timer, card, bench)
    sf_launches, sf_lines = phase_split_features(lgb, H, global_timer, card,
                                                 main, probe, bench)
    launches.update(sf_launches)
    obj_launches, _ = phase_objectives(lgb, H, global_timer, card, main)
    launches.update(obj_launches)
    rank = ranking_data()
    launches.update(phase_ranking(lgb, H, global_timer, card, rank))
    launches["file"] = phase_file(lgb, H, card, rank[0])
    launches["cli"] = phase_cli(lgb, H, card, bench[0])
    launches.update(run_card_vs_cpu(lgb, H, rank[0]))
    del rank
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
    group = phase_kernels_group_space(H, dev, efb_line["bundle_columns"])
    ranking_width = phase_kernels_ranking_width(H, dev)
    wide = phase_kernels_wide(H, dev)

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
        gs = group[key[0]]
        entries[-1]["group_space"] = {
            "features": efb_line["bundle_columns"], "B": GROUP_BINS,
            "C": C, **{k: gs[k] for k in (
                "num_slots", "rows", "max_abs_err", "ms", "kernel_ms",
                "loop_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in gs},
            "efb_launches": launches["efb"][key[0]]}
        entries[-1]["max_abs_err"] = max(entries[-1]["max_abs_err"],
                                         gs["max_abs_err"])
        if key[0] in ranking_width:
            rw = ranking_width[key[0]]
            entries[-1]["ranking_width"] = {
                "features": RANK_F, "B": B, "C": C, **{k: rw[k] for k in (
                    "num_slots", "max_abs_err", "ms", "kernel_ms",
                    "loop_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "ranking_launches": {
                    run: launches[f"ranking_{run}"][key[0]]
                    for run in ("lambdarank", "rank_xendcg")}}
            entries[-1]["max_abs_err"] = max(entries[-1]["max_abs_err"],
                                             rw["max_abs_err"])
        if key[0] == "K2":    # the streaming route at 8 slots
            few = per_shape[("K2", 8, False)]
            entries[-1]["few_slot_route"] = {
                k: few[k] for k in ("num_slots", "ms", "kernel_ms",
                                    "plain_ms", "library_ms", "bound_ms")}
    # the same kernels on 16-bit codes (their uint16_t instantiations):
    # at the wide_bins phase's width, and in bin windows
    row_keys = ("max_abs_err", "ms", "kernel_ms", "loop_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")
    for e16, (kern, path) in zip(list(entries), (
            ("K1", "wide_bins_wave"), ("K2", "wide_bins_quantized"),
            ("K3", "wide_bins_wave"), ("K4", "wide_bins_leafwise"))):
        r = wide[(kern, "wide")]
        windows = {k: v for k, v in wide.items()
                   if k[0] == kern and k[1] == "window"}
        entries.append({
            "name": f"{e16['name']} on 16-bit codes", "route": "cuda",
            "source": e16["source"], "replaces": e16["replaces"],
            "launches": launches[path][kern], "launches_path": path,
            "max_abs_err": max(v["max_abs_err"] for v in
                               [r, *windows.values()]),
            **{k: r[k] for k in row_keys if k != "max_abs_err"},
            "status": "ported",
            "shape": {"n": N_KERNEL, "F": F, "B": WIDE_B, "C": C,
                      "codes": "uint16", **({"num_slots": r["num_slots"]}
                                            if kern != "K4" else
                                            {"S": N_KERNEL})},
            "windowed": [{"F": WINDOW_F, "B": WINDOW_B,
                          "num_slots": v.get("num_slots"),
                          "route": v.get("route"),
                          **{k: v[k] for k in row_keys}}
                         for v in windows.values()]})
    emit({"phase": "total", "seconds": time.perf_counter() - T0,
          "card": card})
    emit({"kernels": entries, "launches_by_path": launches})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
