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
  3c. reliability: the training host planes right after the main path
     (its model text kept before `predict`): `train` on the main path's
     Dataset and params, 13 iterations, with checkpoint_dir
     (checkpoint_freq=4), metrics_dir and LGBM_TPU_FAULT=nan_grad@7 set
     in the process; the launch counts set to 0 just before and read
     just after.  Gates: one `rollback_retry` event, to the checkpoint
     at 4; the final model text equal to the main path's byte for byte;
     K1 and K3 launched; an iteration event for each of the 13
     iterations, each with `GBDT::*` phase seconds and a `roofline`
     whose `grow_tree` group (the histogram passes) reads the CUDA-event
     time of `Tree::histogram::device` with 0 < bw_util <= BW_UTIL_MAX
     (1.05); non-empty torch.cuda memory gauges in the last;
     `train_end` last.  Then
     child processes on the card at CHILD_ROWS (65,536) rows, 255
     leaves, started together in two waves: worker_crash@5 with
     checkpoints every 2 iterations exits 17 and the relaunch resumes
     to the model text of an uninterrupted child, with bagging and with
     DART; hang@3 with stall_floor_s=STALL_FLOOR_S (3), stall_factor 3
     and auto_degrade exits 86 with a stall-rank0.json whose last
     iteration is 3 and whose device snapshot holds the allocator's
     bytes, and the relaunch degrades tpu_donate_buffers and resumes to
     the trees of a clean child with tpu_donate_buffers=false.  One
     `reliability` line: checkpoint bytes, sync write ms and async
     capture ms per checkpoint, s/iter of the checkpointed run (timer
     on) beside the main path's, each roofline group's bw_util, the
     children's exit codes and seconds, the stall's silent seconds,
     the launches, the card;
  3d. serving: the main path's first SERVE_V1_ITERATIONS (7) trees (v1)
     and all 13 (v2) as model text.  In process: a ServingDaemon on the
     card (roofline=true, metrics_port=0, buckets 64-1,024) serves v1;
     SERVE_STREAMS (256) closed-loop streams of SERVE_ROWS (4) rows over
     SERVE_THREADS (16) threads, SERVE_ROUNDS (5) rounds, v2 loaded and
     hot-swapped in under the third round's traffic once two rounds are
     done (the last two rounds wait for it to land).  Gates: every response byte-identical
     to `Booster.predict` (device_predict=true, on the card) of the
     version that served it; no failed request; both versions seen;
     serve_recompiles 0 after warmup; one line-JSON TCP request equal to
     the in-process answer; `/metrics` with the daemon and cost series;
     a `roofline` block with 0 < bw_util <= BW_UTIL_MAX (1.05).  Then
     the fleet drill (bench.py --serve-fleet --smoke's setup): 2 replica
     children on the card (`python -m lightgbm_tpu_torch` task=serve,
     fresh processes), the router, FLEET_THREADS (6) client threads of
     4-row requests (at least FLEET_REQUESTS, 400), serve_crash@25 on
     replica 1 (relaunched), serve_shed@10 on replica 0, a rolling
     publish to v2 once the relaunch is routable, then a canary trained
     with scale_pos_weight=100 that must roll back.  Gates: no failed
     request (the router's explicit `overloaded` answers, bench.py's
     admission rejections, at most FLEET_OVERLOAD_MAX (5%) of the served
     ones, the client backing off 0.1 s after each); every reply byte-identical to one version's
     `Booster.predict`; a relaunch; each replica's health reporting its
     CUDA dispatches; the router's `/metrics` with lgbm_router_requests
     and lgbm_fleet_replicas_routable; a sampled trace assembled across
     2 processes; SIGTERM draining every replica to rc 143 (or -15).
     One `serving` line: p50/p99 ms, rows/s, dispatches and mean batch
     rows of each drill, the roofline, the fleet's seconds, the card;
  3e. online (bench.py --online's full sizes, copied here): a seed model
     of ONLINE_SEED_TREES (10) trees on chunk 0, then an OnlineTrainer
     thread over ONLINE_CHUNKS (10) MemoryChunkSource chunks of
     make_higgs_like(ONLINE_CHUNK_ROWS (20,000), 28) rows, one every
     ONLINE_PUSH_S (1) s, boosting ONLINE_TREES_PER_CHUNK (3) trees of 15
     leaves a chunk on the card, checkpointing each generation and
     publishing it into a local ServingDaemon on the card while
     ONLINE_THREADS (8) closed-loop client threads send 4-row requests,
     under LGBM_TPU_FAULT=ONLINE_FAULT (the publish of generation 2 fails
     once, chunk 4 arrives corrupt), the launch counts set to 0 after the
     seed and read after the loop.  Gates: zero lost requests; every
     response byte-identical to `Booster.predict` (device_predict=true)
     of the generation that served it; >= 3 generations published;
     exactly one skipped; >= 1 publish retry; a finite freshness lag <=
     ONLINE_MAX_LAG_S (60 s); `/metrics` with the freshness series; the
     wave engine's kernels alone launched (K3, which takes every wave of
     up to 8 computed slots, so all of them at 15 leaves; K1 on any
     wider one).  Then the SIGTERM drill, `python -m
     lightgbm_tpu_torch train-and-serve` children on the card over three
     chunk files: a control run and a drill run side by side, the drill
     SIGTERM'd after its generation-2 checkpoint (exit 143, the control
     0); the drill's relaunch writes its ready file at generation 2,
     serves generation 2 (or 3) over TCP, and its generation-3
     checkpoint equals the control run's byte for byte (children and
     logs in build/chip_smoke_online/).  One `online` line: generations
     published and skipped, retries, p50/p99 ms, rows/s, the lag, each
     generation's train seconds and trees, the drill's seconds;
  3f. data_parallel (right after the three paths): tree_learner=data at
     the main path's width, the bench Dataset's bins saved once with
     `save_binary` and loaded by every rank.  (a)
     `train_distributed(num_machines=1)`: one CUDA child joins a
     one-machine cluster (NCCL by the backend rule) and trains
     DP_NCCL_ITERATIONS (3) wave iterations; (b)
     `train_distributed(num_machines=DP_RANKS)` (2 ranks sharing the
     card, gloo) trains the wave engine 5 iterations,
     quantized 3 and leaf-wise DP_LEAFWISE_ITERATIONS (1; 3 until the
     parallel_learners phase took their time, which reuses its
     reference).  Gates: each model text equal byte for
     byte to the serial card run's with the same params (no process
     group: one device); each rank's launch counts hold its path's
     kernels and no other; the backends nccl (a) and gloo (b).  One
     `data_parallel` line per run: each rank's s/iter, all-reduce ms,
     bytes and calls per iteration, backend and launches, the cluster's
     and the serial run's seconds;
  3g. parallel_learners (right after data_parallel, on its bins file and
     against its serial references' trees, from `Tree=0` on): one
     cluster of PL_RANKS (2) ranks sharing the card (join_cluster, gloo)
     trains voting at top_k=PL_TOP_K (4) at PL_CPU_ROWS (16,384) rows
     on the card and on the CPU in the same group, the trees equal (one
     iteration, PL_CPU_ITERATIONS), then tree_learner=feature on the
     wave engine 5 iterations (K1 and K3 over each rank's block of
     columns) and quantized 3 (K2), tree_learner=voting at top_k=28
     leaf-wise PL_VOTE_ITERATIONS (1; 2 in the phase's first version)
     (K4), each with the serial run's first trees, and voting at
     top_k=PL_TOP_K as many: its collective bytes per iteration at most
     4/28 of the top-28 run's plus F*4 + 72 bytes a call, held-out raw
     scores correlated >= 0.95 with the leaf-wise reference's first
     trees'.  Meanwhile (while the cluster starts and trains the
     16,384-row pair), the elastic drill through `train_distributed`:
     tree_learner=data, wave, 5 iterations, two ranks with
     worker_lost@3 on rank 1, max_retries=1, checkpoint_freq=1; the
     first attempt fails (exit 77), the relaunch is one rank on NCCL
     resumed from the checkpoint (2 iterations in its event log), with
     the wave reference's trees and elastic_shrinks 1 (children, logs,
     checkpoints and events in build/chip_smoke_parallel_learners/).
     `reliability.supervisor.supervise` reaps the cluster.  One
     `parallel_learners` line per run: each rank's s/iter, collective
     ms, bytes and calls per iteration, backend, launches and block or
     rows, the run's seconds and attempts;
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
     MONO_MODE_ITERATIONS (3) iterations each (5 until the
     parallel_learners phase took their time; its depth, not its width,
     cut), with monotone_signs() on MODE_MONOTONE_FEATURES
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
  5.6 huge_bins: more than 65,536 bins in a column: HUGE_ROWS (100,000)
     rows of make_higgs_like's first HUGE_F (4) features at max_bin
     HUGE_MAX_BIN (70,000), min_data_in_bin 1, 15 leaves, HUGE_ITERATIONS
     (2; 3 until the parallel_learners phase took their time)
     iterations on one Dataset: the leaf-wise engine (K4), quantized
     on the wave engine (K2) and the wave engine (K1; K3 takes no wave
     above 7,231 bins, `wave_kernels_at`), the wave runs where
     `wave_fits` takes the width.  Gates: int32 device codes; the
     run's engine; exactly the run's kernels launched; the trees equal
     the port's CPU trees (phase_card_vs_cpu's rule; the CPU sides train
     in spawned workers meanwhile).  One `huge_bins` line per run: each
     feature's bins, s/iter, peak GiB, launches;
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
  5h. file: the ranking rows' first whole queries in FILE_ROWS (32,768)
     rows (1/16
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
     process runs the card sides in turn): `train` at CARD_ROWS (16,384)
     rows, CARD_ITERATIONS (2) iterations (3 for the GOSS and DART
     cases), on "cuda"
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
     objectives on the ranking data's whole queries in its first 16,384
     rows: lambdarank with position bias on the wave engine (K1, K3),
     rank_xendcg quantized (K2) and lambdarank on the leaf-wise engine
     (K4); then linear trees at CARD_LINEAR_ROWS (16,384) rows, quantized
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
     each with its windowed shapes.  Then the same shapes on 32-bit codes
     (int32 storage, the kernels' uint32_t instantiations) at INT32_F
     (2) features of INT32_B (131,072) bins, n = 2^20, in bin windows:
     three more rows of the kernels line (K1, K2 with both routes, K4,
     each with the huge_bins run's launches) and K3's row inside K3's
     entry (`int32_codes`: no training wave goes to K3 at that width).
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
reads them just after, then prints the breakdown of
BREAKDOWN_ITERATIONS (1; 3 until the parallel_learners phase took their
time) instrumented iterations.  A `total` line gives the run's seconds
before the kernels line.  The paths that train on the bench rows and labels with
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

import faulthandler
import functools
import json
import os
import re
import shutil
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
VALID_MIN_DELTA = 0.001        # early_stopping_min_delta of the valid path
# rows of the higgs and EFB card-vs-CPU cases (65,536 until the online
# and huge_bins phases came: the command then took 912 s)
CARD_ROWS = 16_384
CARD_LINEAR_ROWS = 16_384      # rows of the linear card-vs-CPU cases
# iterations of a card-vs-CPU case (3 until the serving phase came): the
# GOSS case samples from its third iteration and DART's drops need
# trees to drop, so those two keep 3
CARD_ITERATIONS = 2
CARD_ITERATIONS_OF = {"sampling_b_goss_lr0.5": 3, "dart_wave": 3}
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
    feature and channel (plus the count) over the float32 peak: the
    cost model's count (costmodel.wave_hist_bytes / wave_hist_ops) at
    its H100 peaks (PEAK_TABLE["gpu"])."""
    from lightgbm_tpu_torch.observability import costmodel as cm
    Fw, Bw = width
    return cm.bound_ms(
        cm.wave_hist_bytes(binned_bytes, n, num_slots, Fw, Bw, C),
        cm.wave_hist_ops(rows_in_slots, Fw, C))


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
    one add per masked row, feature and channel: the cost model's count
    (costmodel.rows_hist_bytes / rows_hist_ops)."""
    from lightgbm_tpu_torch.observability import costmodel as cm
    Fw, Bw = width
    return cm.bound_ms(cm.rows_hist_bytes(S, Fw, Bw, C, code_bytes),
                       cm.rows_hist_ops(rows_in_mask, Fw, C))


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
# does not fit a block (the kernels cut its bins into windows); 32-bit
# codes: INT32_F features of INT32_B bins (int32 storage, bin windows)
WIDE_B = 1023
WINDOW_F, WINDOW_B = 4, 32768
INT32_F, INT32_B = 2, 131072


def wide_inputs(num_slots, dev, seed, width):
    """kernel_inputs on 16-bit codes (int16 storage, codes over [0, B)),
    or int32 ones above 65,536 bins: (binned, its codes as int64 for the
    yardstick, slot, gh)."""
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


WINDOW_SHAPES = (("K1", 16), ("K2", 16), ("K2", 4), ("K3", 1), ("K4", 0))


def phase_kernels_wide(H, dev, tags=("wide", "window", "int32")):
    """K1-K4 on 16-bit codes at the wide_bins phase's width (28 features,
    WIDE_B bins; K1 and K2 at 256 slots, K3 at the most slots
    `wave_hl_fits` lets it take there, K4 at 2^20 rows) and in bin
    windows (WINDOW_F features of WINDOW_B bins: K1 and K2's partition
    at 16 slots, K2's streaming route at 4, K3 at 1, K4 at 2^20 rows),
    then on 32-bit codes (the kernels' uint32_t instantiations) at
    INT32_F features of INT32_B bins in windows, at the window shapes;
    each bit for bit its plain version and itself on a repeat, each call
    one launch.  Returns {(kernel, "wide" | "window" | "int32"): row}."""
    K3_SLOTS = max(s for s in range(1, 64) if H.wave_hl_fits(WIDE_B, s))
    out = {}
    for tag, width, shapes in (
            ("wide", (F, WIDE_B), (("K1", 256), ("K2", 256),
                                   ("K3", K3_SLOTS), ("K4", 0))),
            ("window", (WINDOW_F, WINDOW_B), WINDOW_SHAPES),
            ("int32", (INT32_F, INT32_B), WINDOW_SHAPES)):
        if tag not in tags:
            continue
        Fw, Bw = width
        for kern, NL in shapes:
            binned, codes, slot, gh = wide_inputs(max(NL, 1), dev,
                                                  seed=900 + NL, width=width)
            cb = binned.element_size()
            if cb != (4 if tag == "int32" else 2):
                raise AssertionError(f"{tag} rows: {binned.dtype} codes")
            extra = {"codes": ("uint16 (int16 storage)" if cb == 2
                               else "uint32 (int32 storage)"),
                     "features": Fw, "max_bin": Bw,
                     "windowed": tag != "wide"}
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
                                 code_bytes=cb)
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
            bound, by = bound_of(cb * Fw * N_KERNEL, N_KERNEL, slots_out,
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


# the instrumented iterations of a path's breakdown (3 until the
# parallel_learners phase took their time)
BREAKDOWN_ITERATIONS = 1


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
    if given; then BREAKDOWN_ITERATIONS instrumented iterations for the
    breakdown.
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
    # where the time goes: BREAKDOWN_ITERATIONS more iterations with the
    # port's timer on (host scopes plus CUDA-event device scopes; the
    # timer synchronizes at scope ends, so these iterations run slower
    # than the ones above)
    nb = BREAKDOWN_ITERATIONS
    global_timer.reset()
    global_timer.enabled = True
    t0 = time.perf_counter()
    for _ in range(nb):
        booster.update()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / nb
    snap = global_timer.snapshot()
    global_timer.enabled = False
    ms_per_iter = {k: v[0] * 1e3 / nb for k, v in snap.items()}
    emit({"phase": f"{name}_breakdown", "iterations": nb,
          "instrumented_s_per_iter": wall, "ms_per_iter": ms_per_iter,
          "calls_per_iter": {k: v[1] / nb for k, v in snap.items()}})
    return {"launches": launches, "auc": score, "wall": wall,
            "s_per_iter": sum(last) / len(last), "ms_per_iter": ms_per_iter,
            "booster": booster, "peak_gib": peak}


def phase_paths(lgb, H, global_timer, probe, bench):
    data, ds = bench
    out = {}
    probe.reset()
    surface = {}
    model_text = []

    def after_main(b):
        # the uninterrupted run the reliability phase's rollback must
        # reproduce, before the later phases touch the booster
        model_text.append(b.model_to_string(num_iteration=-1))
        # the serving phase's v1: the first SERVE_V1_ITERATIONS trees
        model_text.append(b.model_to_string(
            num_iteration=SERVE_V1_ITERATIONS))
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
            "features": distinct_features(r["booster"]._gbdt.models_[:13]),
            "model_text": model_text[0], "model_text_v1": model_text[1]}
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
        trees = len(g.models_)          # 13 counted + the breakdown's
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
# 65,536 rows, PERF.md) and the file phase (65,536 rows until the
# reliability phase needed its ~30 s: the file loads are host binning,
# linear in the rows)
CARD_RANK_ROWS = 16_384
FILE_ROWS = 32_768


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
MONO_MODE_ITERATIONS = 3
# held-out AUC after MONO_MODE_ITERATIONS iterations: chip_rehearsal.py
# monotone_modes at 1/8 of the rows gave 0.68473 (intermediate), 0.69433
# (advanced) and 0.69924 (lazy), less 0.01
MONO_MODE_AUC_MIN = {"intermediate": 0.674, "advanced": 0.684,
                     "lazy": 0.689}


def phase_monotone_modes(lgb, H, global_timer, card, main, bench):
    """The main path's workload on the leaf-wise engine with the monotone
    signs of MODE_MONOTONE_FEATURES under the intermediate and the
    advanced method, and with lazy CEGB (LAZY_PER_ROW on every feature):
    MONO_MODE_ITERATIONS iterations each.  Returns {run: launches}."""
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
                       {"tpu_growth_strategy": "leafwise", **extra},
                       MONO_MODE_ITERATIONS, data, train_set=ds)
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
              "iterations": MONO_MODE_ITERATIONS,
              "s_per_iter": r["s_per_iter"],
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
    """The inputs of one card-vs-CPU case: `train` at `rows` rows,
    CARD_ITERATIONS iterations (CARD_ITERATIONS_OF names the cases that
    take more; `categorical`: the split_features phase's transform of
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
            "iterations": CARD_ITERATIONS_OF.get(name, CARD_ITERATIONS),
            "forced": forced, "extra": extra, "categorical": categorical,
            "label": label, "data": data}


def train_case(lgb, inputs, dev):
    """A case's iterations on `dev`: (trees, bundle groups or None);
    forced splits are held on the way."""
    b = lgb.train({**inputs["params"], "device_type": dev},
                  lgb.Dataset(inputs["X"], label=inputs["y"],
                              **inputs["ds_kw"]),
                  num_boost_round=inputs["iterations"])
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


def hold_tree(what, i, a, b):
    """Tree i of the card (a) against the CPU's (b): the same split
    features, thresholds and decision types (on a categorical node
    `threshold` is the index of its category set: the sets themselves
    are compared too), leaf values within rtol 1e-4.  Returns the
    largest relative leaf difference."""
    ni = a.num_leaves - 1
    same = (a.num_leaves == b.num_leaves
            and np.array_equal(a.split_feature[:ni], b.split_feature[:ni])
            and np.array_equal(a.threshold[:ni], b.threshold[:ni])
            and np.array_equal(a.decision_type[:ni], b.decision_type[:ni])
            and a.cat_boundaries == b.cat_boundaries
            and a.cat_threshold == b.cat_threshold)
    if not same:
        diff = [j for j in range(min(a.num_leaves, b.num_leaves) - 1)
                if (a.split_feature[j], a.threshold[j])
                != (b.split_feature[j], b.threshold[j])][:3]
        raise AssertionError(
            f"{what} tree {i}: card and CPU trees differ at nodes {diff}: "
            + "; ".join(f"card f{a.split_feature[j]}<={a.threshold[j]!r} "
                        f"gain {a.split_gain[j]!r}, cpu "
                        f"f{b.split_feature[j]}<={b.threshold[j]!r} "
                        f"gain {b.split_gain[j]!r}" for j in diff))
    lv_a, lv_b = a.leaf_value[:ni + 1], b.leaf_value[:ni + 1]
    if not np.allclose(lv_a, lv_b, rtol=1e-4, atol=0.0):
        raise AssertionError(f"{what} tree {i}: leaf values differ")
    return float(np.max(np.abs(lv_a - lv_b)
                        / np.maximum(np.abs(lv_b), 1e-30)))


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
        worst = max(worst, hold_tree(name, i, a, b))
        cat_nodes += a.num_cat
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
    trees = inputs["iterations"] * K
    if len(models["cuda"]) != trees or len(models["cpu"]) != trees:
        raise AssertionError(f"{name}: card/CPU tree counts differ from "
                             f"{trees}")
    if categorical and cat_nodes == 0:
        raise AssertionError(f"{name}: no categorical split to compare")
    emit({"phase": "card_vs_cpu", "path": name, "params": extra,
          "rows": X.shape[0], "trees": trees, "categorical": categorical,
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


# card-vs-CPU cases whose CPU sides take longest, slowest first (the
# ranking gradients over 136 columns, the rescans of the monotone modes,
# the wide scan over EFB's columns)
CPU_FIRST = ("rank_xendcg_quantized", "advanced_leafwise",
             "wide_efb_csr_wave", "lambdarank_position_bias_wave",
             "intermediate_leafwise")


def cpu_order(cases):
    """The order the CPU sides are queued in: CPU_FIRST's, then the
    cases' own."""
    def key(i):
        name = cases[i][0]["name"]
        return CPU_FIRST.index(name) if name in CPU_FIRST else len(CPU_FIRST)
    return sorted(range(len(cases)), key=key)


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
        for i in cpu_order(cases):
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


REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
RELIABILITY_DIR = os.path.join("build", "chip_smoke_reliability")
RELIABILITY_NAN_AT = 7      # nan_grad@7: the 8th update's gradients
RELIABILITY_CKPT_FREQ = 4   # the rollback lands on the checkpoint at 4
CHILD_ROWS = 65_536         # the crash and stall drills' children
CHILD_ITERATIONS = 8
CHILD_CRASH_AT = 5          # worker_crash@5: after the checkpoint at 4
CHILD_TIMEOUT_S = 300
CHILD_THREADS = 1           # torch threads a child: six run at once
STALL_FLOOR_S = 3.0
STALL_HANG_AT = 3
STALL_ITERATIONS = 6
# the stall diagnosis's device snapshot must hold the card's allocator
STALL_DEVICE_KEY = "allocated_bytes"
RELIABILITY_DEVICE = "cuda"     # where the checkpointed run must train
# the phase whose seconds the grow_tree roofline must read: the
# histogram passes' CUDA-event time (costmodel.GROUP_PHASES)
GROW_TREE_PHASE = "Tree::histogram::device"
BW_UTIL_MAX = 1.05          # a byte count above this is a wrong count

# a child of the crash and stall drills: trains make_higgs_like(CHILD_ROWS,
# 28) with BENCH_PARAMS + REL_PARAMS on the card, writes its model text
RELIABILITY_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REL_REPO"])
import torch
torch.set_num_threads(int(os.environ["REL_THREADS"]))
import lightgbm_tpu_torch as lgb
from chip_smoke import BENCH_PARAMS, make_higgs_like
X, y = make_higgs_like(int(os.environ["REL_ROWS"]), 28, seed=2)
kw = json.loads(os.environ.get("REL_KW", "{}"))
b = lgb.train({**BENCH_PARAMS, **json.loads(os.environ["REL_PARAMS"])},
              lgb.Dataset(X, label=y), int(os.environ["REL_ITERS"]), **kw)
with open(os.environ["REL_OUT"], "w") as f:
    f.write(b.model_to_string(num_iteration=-1))
print(json.dumps({"iterations": b.current_iteration(),
                  "device": str(b._gbdt.device)}), flush=True)
"""


def start_children(script, specs):
    """Start one child per spec (name, REL_PARAMS, REL_KW, fault,
    attempt), all at once; returns {name: (Popen, log file, start)}."""
    out = {}
    for name, params, kw, fault, attempt in specs:
        env = dict(os.environ)
        env.pop("LGBM_TPU_FAULT", None)
        env.update({"REL_REPO": REPO_ROOT,
                    "REL_ROWS": str(CHILD_ROWS),
                    "REL_ITERS": str(STALL_ITERATIONS if name.startswith(
                        "stall") else CHILD_ITERATIONS),
                    "REL_PARAMS": json.dumps(params),
                    "REL_KW": json.dumps(kw),
                    "REL_THREADS": str(CHILD_THREADS),
                    "REL_OUT": os.path.join(RELIABILITY_DIR, name + ".txt"),
                    "LGBM_TPU_FAULT_ATTEMPT": str(attempt)})
        if fault:
            env["LGBM_TPU_FAULT"] = fault
        log = open(os.path.join(RELIABILITY_DIR, name + ".log"), "w")
        out[name] = (subprocess.Popen([sys.executable, script], env=env,
                                      stdout=log, stderr=subprocess.STDOUT),
                     log, time.perf_counter())
    return out


def wait_children(running):
    """Wait for every child (killing all of them on a timeout); returns
    {name: (returncode, seconds)}."""
    done = {}
    try:
        for name, (p, log, t0) in running.items():
            rc = p.wait(timeout=max(1.0, CHILD_TIMEOUT_S
                                    - (time.perf_counter() - t0)))
            done[name] = (rc, time.perf_counter() - t0)
    finally:
        for p, log, _ in running.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return done


def child_tail(name, n=1500):
    with open(os.path.join(RELIABILITY_DIR, name + ".log")) as f:
        return f.read()[-n:]


def child_model(name, trees_only=False):
    with open(os.path.join(RELIABILITY_DIR, name + ".txt")) as f:
        text = f.read()
    return text.split("\nparameters:")[0] if trees_only else text


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def roofline_of_iterations(its):
    """Gate the iteration events' training roofline: every event's
    `grow_tree` group (the histogram passes) reads GROW_TREE_PHASE's
    seconds and moves 0 < bw_util <= BW_UTIL_MAX.  Returns, per group,
    the events it is in, its bw_util range, and its mean device ms,
    bytes and calls per event."""
    out = {}
    for e in its:
        roof = e.get("roofline") or {}
        g = roof.get("grow_tree")
        dev = e["phases"].get(GROW_TREE_PHASE)
        if g is None or dev is None or g["device_s"] is None \
                or abs(g["device_s"] - dev) > 1e-6 \
                or not 0 < (g.get("bw_util") or 0) <= BW_UTIL_MAX:
            raise AssertionError(
                f"reliability: iteration {e['iteration']}'s grow_tree "
                f"roofline {g} against {GROW_TREE_PHASE} = {dev}")
        for group, r in roof.items():
            o = out.setdefault(group, {"events": 0, "bw_util": [],
                                       "device_ms": 0.0, "bytes": 0.0,
                                       "calls": 0})
            o["events"] += 1
            o["bw_util"].append(r.get("bw_util"))
            o["device_ms"] += (r["device_s"] or 0.0) * 1e3
            o["bytes"] += r["bytes"]
            o["calls"] += r["calls"]
    for o in out.values():
        n = o.pop("events")
        bw = [x for x in o.pop("bw_util") if x is not None]
        o.update(events=n, bw_util_min=min(bw, default=None),
                 bw_util_max=max(bw, default=None),
                 device_ms_per_event=o.pop("device_ms") / n,
                 bytes_per_event=o.pop("bytes") / n,
                 calls_per_event=o.pop("calls") / n)
    return out


def phase_reliability(lgb, H, card, main, bench):
    """The training host planes on the card (gates in the module
    docstring): the full-width rollback run with its event log, then
    the crash/resume and stall/degrade drills in child processes.
    Returns the checkpointed run's launch counts."""
    import shutil
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.reliability.checkpoint import CheckpointManager
    from lightgbm_tpu_torch.reliability.guard import STALL_EXIT_CODE
    data, ds = bench
    shutil.rmtree(RELIABILITY_DIR, ignore_errors=True)
    os.makedirs(RELIABILITY_DIR)
    ck = os.path.join(RELIABILITY_DIR, "ckpt")
    mx = os.path.join(RELIABILITY_DIR, "metrics")
    t_phase = time.perf_counter()
    params = dict(BENCH_PARAMS)
    check_dataset_params("reliability", params, ds)
    os.environ["LGBM_TPU_FAULT"] = f"nan_grad@{RELIABILITY_NAN_AT}"
    faults.reload()
    try:
        torch.cuda.synchronize()
        reset_counts(H)
        t0 = time.perf_counter()
        b = lgb.train(params, ds, 13, checkpoint_dir=ck,
                      checkpoint_freq=RELIABILITY_CKPT_FREQ, metrics_dir=mx)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = launch_counts(H)
    finally:
        del os.environ["LGBM_TPU_FAULT"]
        faults.reload()
    if b._gbdt.device.type != RELIABILITY_DEVICE:
        raise AssertionError(f"reliability: trained on {b._gbdt.device}")
    if launches["K1"] <= 0 or launches["K3"] <= 0:
        raise AssertionError(f"reliability: K1 and K3 must launch in the "
                             f"checkpointed run: {launches}")
    ev = read_events(os.path.join(mx, "events-rank0.jsonl"))
    rollbacks = [e for e in ev if e["event"] == "rollback_retry"]
    if len(rollbacks) != 1 or rollbacks[0]["from_iteration"] \
            != RELIABILITY_CKPT_FREQ:
        raise AssertionError(f"reliability: want one rollback_retry to "
                             f"{RELIABILITY_CKPT_FREQ}: {rollbacks}")
    if b.model_to_string(num_iteration=-1) != main["model_text"]:
        raise AssertionError("reliability: the rolled-back run's model "
                             "text differs from the main path's")
    its = [e for e in ev if e["event"] == "iteration"]
    if sorted({e["iteration"] for e in its}) != list(range(1, 14)):
        raise AssertionError(f"reliability: iteration events "
                             f"{[e['iteration'] for e in its]}")
    for e in its:
        if not any(k.startswith("GBDT::") for k in e["phases"]):
            raise AssertionError(f"reliability: no GBDT:: phase seconds "
                                 f"in iteration {e['iteration']}")
    roof = roofline_of_iterations(its)
    gauges = its[-1]["gauges"]
    if not gauges.get("device_bytes_in_use", 0) > 0:
        raise AssertionError(f"reliability: no device memory gauges in "
                             f"the last iteration event: {gauges}")
    if ev[-1]["event"] != "train_end":
        raise AssertionError(f"reliability: the log ends with "
                             f"{ev[-1]['event']}")
    # the training thread's share of a checkpoint (the capture: model
    # text + the scores' clone and pinned copy), from the event phases
    cap_s = sum(e["phases"].get("Checkpoint::save", 0.0) for e in its)
    n_ckpt = sum(1 for e in ev if e["event"] == "checkpoint")
    # s/iter of the second pass's last iterations (timer on: the metrics
    # run synchronizes at each scope's end)
    tail = [e["time_s"] for e in its[-10:]]
    # one synchronous write, as the preemption hook makes it
    sync = CheckpointManager(os.path.join(RELIABILITY_DIR, "sync"),
                             keep_last=1, params=params)
    write_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        sync.save(b, 13)
        write_ms.append((time.perf_counter() - t0) * 1e3)
    last = sync.latest()
    ckpt_bytes = sum(os.path.getsize(p) for p in (last.model_path,
                                                   last.state_path))
    del b

    # crash and resume, stall and degrade: children on the card
    script = os.path.join(RELIABILITY_DIR, "child.py")
    with open(script, "w") as f:
        f.write(RELIABILITY_CHILD)
    crash = f"worker_crash@{CHILD_CRASH_AT}@0"
    hang = f"hang@{STALL_HANG_AT}@0"
    stall_params = {"metrics_dir": os.path.join(RELIABILITY_DIR, "stall_m"),
                    "checkpoint_dir": os.path.join(RELIABILITY_DIR,
                                                   "stall_ck"),
                    "checkpoint_freq": 1, "auto_degrade": True,
                    "stall_floor_s": STALL_FLOOR_S, "stall_factor": 3.0}
    drills = {"bagging": BAG, "dart": DART}
    first = []
    for name, extra in drills.items():
        ckw = {"checkpoint_dir": os.path.join(RELIABILITY_DIR, f"ck_{name}"),
               "checkpoint_freq": 2}
        first += [(f"crash_{name}", extra, ckw, crash, 0),
                  (f"clean_{name}", extra, {}, "", 0)]
    first += [("stall_hang", stall_params, {}, hang, 0),
              ("stall_clean", {"tpu_donate_buffers": False}, {}, "", 0)]
    t0 = time.perf_counter()
    rc1 = wait_children(start_children(script, first))
    for name in drills:
        if rc1[f"crash_{name}"][0] != faults.CRASH_EXIT_CODE:
            raise AssertionError(f"reliability crash_{name}: rc "
                                 f"{rc1[f'crash_{name}'][0]}\n"
                                 f"{child_tail(f'crash_{name}')}")
        if rc1[f"clean_{name}"][0] != 0:
            raise AssertionError(f"reliability clean_{name}: "
                                 f"{child_tail(f'clean_{name}')}")
    if rc1["stall_hang"][0] != STALL_EXIT_CODE:
        raise AssertionError(f"reliability stall: rc {rc1['stall_hang'][0]}"
                             f"\n{child_tail('stall_hang')}")
    if rc1["stall_clean"][0] != 0:
        raise AssertionError(f"reliability stall_clean: "
                             f"{child_tail('stall_clean')}")
    with open(os.path.join(stall_params["metrics_dir"],
                           "stall-rank0.json")) as f:
        diag = json.load(f)
    if diag["last_iteration"] != STALL_HANG_AT or diag["exit_code"] \
            != STALL_EXIT_CODE or not diag["device"].get(STALL_DEVICE_KEY):
        raise AssertionError(f"reliability stall: diagnosis "
                             f"{ {k: diag.get(k) for k in ('last_iteration', 'exit_code', 'device')} }")
    second = [(f"resume_{name}", extra,
               {"checkpoint_dir": os.path.join(RELIABILITY_DIR,
                                               f"ck_{name}"),
                "checkpoint_freq": 2}, crash, 1)
              for name, extra in drills.items()]
    second.append(("stall_degraded", stall_params, {}, hang, 1))
    rc2 = wait_children(start_children(script, second))
    for name, (rc, _) in rc2.items():
        if rc != 0:
            raise AssertionError(f"reliability {name}: rc {rc}\n"
                                 f"{child_tail(name)}")
    for name in drills:
        if child_model(f"resume_{name}") != child_model(f"clean_{name}"):
            raise AssertionError(f"reliability {name}: the resumed model "
                                 "differs from the uninterrupted child's")
    with open(os.path.join(stall_params["metrics_dir"],
                           "degrade-state.json")) as f:
        degraded = json.load(f)["degraded_knobs"]
    if degraded != ["tpu_donate_buffers"]:
        raise AssertionError(f"reliability stall: degraded {degraded}")
    if child_model("stall_degraded", True) != child_model("stall_clean",
                                                          True):
        raise AssertionError("reliability stall: the degraded resume's "
                             "trees differ from the clean run's")
    drills_s = time.perf_counter() - t0
    emit({"phase": "reliability", "rows": data[0].shape[0],
          "iterations": 13, "nan_grad_at": RELIABILITY_NAN_AT,
          "checkpoint_freq": RELIABILITY_CKPT_FREQ,
          "rollback_to": rollbacks[0]["from_iteration"],
          "updates_run": len(its), "run_s": run_s,
          "s_per_iter_last10_timer_on": sum(tail) / len(tail),
          "main_path_s_per_iter_last10": main["s_per_iter"],
          "checkpoints_written": n_ckpt,
          "capture_ms_per_checkpoint": (cap_s * 1e3 / n_ckpt
                                        if n_ckpt else None),
          "sync_write_ms": write_ms, "checkpoint_bytes": ckpt_bytes,
          "device_gauges": gauges, "roofline": roof,
          "launches": launches,
          "children": {k: {"rc": v[0], "s": v[1]}
                       for k, v in {**rc1, **rc2}.items()},
          "child_rows": CHILD_ROWS, "stall_floor_s": STALL_FLOOR_S,
          "stall_silent_s": diag["silent_s"], "degraded": degraded,
          "drills_s": drills_s, "phase_s": time.perf_counter() - t_phase,
          "card": card})
    return launches


SERVING_DIR = os.path.join("build", "chip_smoke_serving")
SERVE_STREAMS = 256         # closed-loop streams of SERVE_ROWS rows
SERVE_THREADS = 16
SERVE_ROUNDS = 5
SERVE_ROWS = 4
SERVE_SWAP_AT = 2           # v2 loads once this many rounds are done,
                            # under the next round's traffic
SERVE_V1_ITERATIONS = 7     # v1: the main path's first 7 iterations
SERVE_POOL = 4096           # the rows requests draw from
SERVE_PARAMS = {"device_predict_min_bucket": 64,
                "serve_max_batch_rows": 1024, "verbosity": -1}
FLEET_REPLICAS = 2
FLEET_THREADS = 6
FLEET_REQUESTS = 400
FLEET_FAULTS = {1: "serve_crash@25", 0: "serve_shed@10"}
FLEET_CANARY_AT = 120       # requests served before the canary goes out
# the admission controller's explicit `overloaded` answers, as bench.py
# --serve-fleet counts them: not failures, at most this share of the
# served requests (a shed on one replica while the other relaunches
# marks the only routable replica as shedding for up to a second)
FLEET_OVERLOAD_MAX = 0.05
FLEET_PARAMS = {"device_predict_min_bucket": 64,
                "serve_max_batch_rows": 256, "serve_queue_depth": 256,
                "verbosity": -1}
FLEET_ROUTER = {"serve_retry_max": 4, "serve_retry_backoff_ms": 25.0,
                "serve_request_timeout_s": 60.0, "serve_canary_pct": 50.0,
                "serve_canary_min_samples": 24,
                "serve_canary_max_divergence": 2.0,
                "serve_canary_max_error_rate": 0.2,
                "serve_trace_sample": 16}
SERVE_DEVICE = "cuda"       # where the daemon and the replicas must serve


def serve_in_process(lgb, texts, pool, expected):
    """The in-process drill (module docstring): returns its line."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.inference import DevicePredictor
    from lightgbm_tpu_torch.observability.registry import global_registry
    from lightgbm_tpu_torch.serving import (LineClient, ServingDaemon,
                                            serve_counters_reset,
                                            start_frontend)
    serve_counters_reset()
    for key in ("device_predict_flops", "device_predict_bytes",
                "device_predict_s", "device_predict_dispatches"):
        global_registry.inc(key, -global_registry.counter(key))
    d = ServingDaemon(Config({**SERVE_PARAMS, "roofline": True,
                              "metrics_port": 0})).start()
    srv = None
    try:
        t0 = time.perf_counter()
        d.registry.register("higgs", model_str=texts[1], block=True)
        warm_s = time.perf_counter() - t0
        if d.registry.device.type != SERVE_DEVICE:
            raise AssertionError(f"serving: daemon on {d.registry.device}")
        cuda_before = DevicePredictor.dispatch_counts().get(SERVE_DEVICE, 0)
        lat, bad, seen = [], [], {1: 0, 2: 0}
        lock = threading.Lock()
        rounds_done = [0]
        swap_go, swap_done = threading.Event(), threading.Event()

        def worker(tid):
            streams = range(tid, SERVE_STREAMS, SERVE_THREADS)
            for rnd in range(SERVE_ROUNDS):
                if rnd == SERVE_SWAP_AT + 1:
                    # the load and warmup ran under round SERVE_SWAP_AT's
                    # traffic; the rounds after it must see v2
                    swap_done.wait(timeout=120)
                sent = []
                for s in streams:
                    lo = (s * 61 + rnd * 1031) % (SERVE_POOL - SERVE_ROWS)
                    sent.append((lo, time.perf_counter(), d.submit(
                        "higgs", pool[lo:lo + SERVE_ROWS])))
                for lo, ts, fut in sent:
                    try:
                        out = fut.result(timeout=60)
                        ms = (time.perf_counter() - ts) * 1e3
                        v = fut.version
                        ok = out.tobytes() == expected[v][
                            lo:lo + SERVE_ROWS].tobytes()
                    except Exception as e:  # noqa: BLE001
                        with lock:
                            bad.append(repr(e))
                        continue
                    with lock:
                        lat.append(ms)
                        seen[v] += 1
                        if not ok:
                            bad.append(f"v{v} rows {lo}: not Booster.predict")
                with lock:
                    rounds_done[0] += 1
                    if rounds_done[0] == SERVE_SWAP_AT * SERVE_THREADS:
                        swap_go.set()

        def swapper():
            swap_go.wait(timeout=120)
            d.registry.register("higgs", model_str=texts[2], block=True)
            swap_done.set()

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(SERVE_THREADS)]
        sw = threading.Thread(target=swapper)
        t0 = time.perf_counter()
        sw.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        sw.join(timeout=120)
        if bad:
            raise AssertionError(f"serving: {len(bad)} failed or differing "
                                 f"responses: {bad[:3]}")
        if not (seen[1] and seen[2]):
            raise AssertionError(f"serving: the hot swap was not seen "
                                 f"mid-run: {seen}")
        recompiles = d.registry.serve_recompiles()
        if recompiles:
            raise AssertionError(f"serving: {recompiles} programs first run "
                                 "by live traffic after warmup")
        srv = start_frontend(d, port=0, request_timeout_s=60.0)
        c = LineClient("127.0.0.1", srv.server_address[1])
        reply = c.request({"model": "higgs",
                           "rows": pool[:SERVE_ROWS].tolist()}, timeout_s=60)
        c.close()
        wire = np.asarray(reply.get("preds", []), np.float64).astype(
            np.float32)
        if not reply.get("ok") or wire.tobytes() != d.predict(
                "higgs", pool[:SERVE_ROWS]).tobytes():
            raise AssertionError(f"serving: the TCP answer differs from "
                                 f"the in-process one: {reply}")
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{d.metrics_server.port}/metrics",
            timeout=30).read().decode()
        missing = [k for k in ("lgbm_serve_requests", "lgbm_serve_latency_ms",
                               "lgbm_serve_recompiles",
                               "lgbm_cost_bytes_total") if k not in page]
        if missing:
            raise AssertionError(f"serving: /metrics lacks {missing}")
        stats = d.stats()
        rl = stats.get("roofline")
        if rl is None or not 0 < rl["bw_util"] <= BW_UTIL_MAX:
            raise AssertionError(f"serving: roofline {rl}")
        cuda = (DevicePredictor.dispatch_counts().get(SERVE_DEVICE, 0)
                - cuda_before)
        n_req = int(stats["serve_requests"])
        return {"requests": n_req, "rows": int(stats["serve_rows"]),
                "streams": SERVE_STREAMS, "threads": SERVE_THREADS,
                "rounds": SERVE_ROUNDS, "rows_per_request": SERVE_ROWS,
                "versions_seen": seen, "warmup_s": warm_s, "wall_s": wall,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "rows_per_s": len(lat) * SERVE_ROWS / wall,
                "dispatches": int(stats["serve_dispatches"]),
                "cuda_dispatches": cuda,
                "mean_batch_rows": stats["serve_rows"]
                / max(stats["serve_dispatches"], 1),
                "daemon_p50_ms": stats["serve_p50_ms"],
                "daemon_p99_ms": stats["serve_p99_ms"],
                "serve_recompiles": recompiles, "roofline": rl}
    finally:
        if srv is not None:
            srv.shutdown()
        d.stop(drain=True, timeout=30)


def serve_fleet(lgb, paths, pool, expected):
    """The fleet drill (module docstring): returns its line."""
    import threading
    import urllib.request
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.serving import (LineClient, OverloadedError,
                                            ReplicaFleet, Router)
    fleet = ReplicaFleet(
        num_replicas=FLEET_REPLICAS, model_entries=[("higgs", paths[1])],
        workdir=os.path.abspath(SERVING_DIR), params=FLEET_PARAMS,
        max_restarts=3, health_interval_s=0.25,
        fault_envs={i: {"LGBM_TPU_FAULT": f} for i, f in
                    FLEET_FAULTS.items()}).start()
    router = Router(fleet, Config({**FLEET_PARAMS, **FLEET_ROUTER}))
    router.register_incumbent("higgs", paths[1])
    t_start = time.perf_counter()
    rcs, failures, ok, tags, overloads = None, [], [0], {}, [0]
    lock, stop = threading.Lock(), threading.Event()
    lat = []
    try:
        if not fleet.wait_ready(timeout=240.0):
            raise AssertionError(f"serving fleet: not ready: "
                                 f"{fleet.describe()}")
        ready_s = time.perf_counter() - t_start

        def client(tid):
            rnd = 0
            while not stop.is_set():
                rnd += 1
                lo = (tid * 2654435761 + rnd * 97) % (SERVE_POOL - SERVE_ROWS)
                try:
                    r = router.predict("higgs", pool[lo:lo + SERVE_ROWS],
                                       deadline_ms=45_000.0)
                except OverloadedError:
                    # the fleet's explicit answer: back off, as a client
                    with lock:
                        overloads[0] += 1
                    time.sleep(0.1)
                    continue
                except Exception as e:  # noqa: BLE001
                    with lock:
                        failures.append(f"t{tid}r{rnd}: {e!r}")
                    time.sleep(0.05)
                    continue
                got = np.asarray(r.preds, np.float64).astype(np.float32)
                tag = next((t for t, exp in expected.items() if got.tobytes()
                            == exp[lo:lo + SERVE_ROWS].tobytes()), None)
                with lock:
                    ok[0] += 1
                    lat.append(r.latency_ms)
                    if tag is None:
                        failures.append(f"t{tid}r{rnd}: v{r.version} on "
                                        f"replica {r.replica} matches no "
                                        "version's Booster.predict")
                    else:
                        tags[tag] = tags.get(tag, 0) + 1

        def wait_for(n, timeout=180.0):
            deadline = time.perf_counter() + timeout
            while ok[0] < n and time.perf_counter() < deadline:
                time.sleep(0.02)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(FLEET_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # the crash and the shed fire in the first third; the rolling
        # publish to v2 waits for the crashed replica's relaunch
        wait_for(FLEET_REQUESTS * 35 // 100)
        fleet.wait_ready(timeout=180.0)
        relaunch_s = time.perf_counter() - t0
        publish = router.publish("higgs", paths[2], canary_pct=0)
        wait_for(ok[0] + FLEET_CANARY_AT)
        fleet.wait_ready(timeout=120.0, min_replicas=FLEET_REPLICAS)
        router.publish("higgs", paths["bad"])
        verdict = router.canary_wait("higgs", timeout=120.0)
        wait_for(max(FLEET_REQUESTS, ok[0] + 50))
        stop.set()
        for t in threads:
            t.join(timeout=120)
        drive_s = time.perf_counter() - t0
        if failures:
            raise AssertionError(f"serving fleet: {len(failures)} failed "
                                 f"requests: {failures[:3]}")
        if overloads[0] > FLEET_OVERLOAD_MAX * ok[0]:
            raise AssertionError(f"serving fleet: {overloads[0]} overloaded "
                                 f"answers against {ok[0]} served")
        if verdict != "rolled_back":
            raise AssertionError(f"serving fleet: the canary was "
                                 f"{verdict}, not rolled back")
        desc = fleet.describe()
        if not any(r["restarts"] >= 1 for r in desc):
            raise AssertionError(f"serving fleet: no relaunch: {desc}")
        health = {}
        for ep in fleet.endpoints():
            c = LineClient(ep.host, ep.port)
            health[ep.idx] = c.request({"op": "health"}, timeout_s=30)
            c.close()
        no_card = {i: h.get("dispatches") for i, h in health.items()
                   if not h.get("dispatches", {}).get(SERVE_DEVICE)
                   or not str(h.get("device", "")).startswith(SERVE_DEVICE)}
        if len(health) != FLEET_REPLICAS or no_card:
            raise AssertionError(f"serving fleet: replicas without CUDA "
                                 f"dispatches: {no_card or health}")
        router.start_frontend(port=0, metrics_port=0)
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{router.metrics_server.port}/metrics",
            timeout=30).read().decode()
        missing = [k for k in ("lgbm_router_requests",
                               "lgbm_fleet_replicas_routable")
                   if k not in page]
        if missing:
            raise AssertionError(f"serving fleet: /metrics lacks {missing}")
        traces = [t for t in router.assembler.traces()
                  if t.get("outcome") == "ok"
                  and len(t.get("processes", ())) >= 2]
        if not traces:
            raise AssertionError("serving fleet: no sampled trace "
                                 "assembled across 2 processes")
        line = {"requests_ok": ok[0], "overloaded": overloads[0],
                "versions_served": tags,
                "fleet_ready_s": ready_s, "relaunch_wait_s": relaunch_s,
                "drive_s": drive_s, "publish": publish, "canary": verdict,
                "p50_ms": float(np.percentile(lat, 50)),
                "p99_ms": float(np.percentile(lat, 99)),
                "replicas": desc,
                "replica_dispatches": {i: h["dispatches"]
                                       for i, h in health.items()},
                "trace_spans": len(traces[-1]["spans"]),
                "trace_processes": len(traces[-1]["processes"])}
    finally:
        stop.set()
        router.stop()
        rcs = fleet.stop(drain=True, timeout=60.0)
    if sorted(rcs) != list(range(FLEET_REPLICAS)) or any(
            rc not in (143, -15) for rc in rcs.values()):
        raise AssertionError(f"serving fleet: SIGTERM drain exit codes "
                             f"{rcs}")
    line["drain_rcs"] = rcs
    line["seconds"] = time.perf_counter() - t_start
    return line


def phase_serving(lgb, card, main, data):
    """The serving phase (module docstring): the in-process drill, then
    the fleet drill, on the main path's model texts."""
    import shutil
    X, y = data[0], data[1]
    t_phase = time.perf_counter()
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    os.makedirs(SERVING_DIR)
    pool = np.ascontiguousarray(X[:SERVE_POOL], np.float32)
    # the canary bait: a pathological class weight, so its scores diverge
    bad = lgb.train({"objective": "binary", "num_leaves": 31,
                     "verbosity": -1, "scale_pos_weight": 100.0},
                    lgb.Dataset(X[:20_000], label=y[:20_000]), 10)
    texts = {1: main["model_text_v1"], 2: main["model_text"],
             "bad": bad.model_to_string()}
    paths = {}
    for tag, text in texts.items():
        paths[tag] = os.path.abspath(os.path.join(SERVING_DIR,
                                                  f"model_{tag}.txt"))
        with open(paths[tag], "w") as f:
            f.write(text)
    expected = {tag: lgb.Booster(model_str=text, params={
        "device_predict": "true"}).predict(pool)
        for tag, text in texts.items()}
    inproc = serve_in_process(lgb, texts, pool, expected)
    fleet = serve_fleet(lgb, paths, pool, expected)
    emit({"phase": "serving", "seconds": time.perf_counter() - t_phase,
          "in_process": inproc, "fleet": fleet, "card": card})


# the online phase: bench.py --online's full sizes
ONLINE_DIR = os.path.join("build", "chip_smoke_online")
ONLINE_F = 28
ONLINE_CHUNK_ROWS = 20_000
ONLINE_CHUNKS = 10
ONLINE_SEED_TREES = 10      # the seed model, on chunk 0
ONLINE_TREES_PER_CHUNK = 3
ONLINE_THREADS = 8          # closed-loop clients of ONLINE_REQ_ROWS rows
ONLINE_REQ_ROWS = 4
ONLINE_PUSH_S = 1.0         # a chunk arrives every this many seconds
ONLINE_MAX_LAG_S = 60.0
ONLINE_POOL = 2048          # the rows requests draw from
# the publish of generation 2 fails once (it must retry and land); chunk
# generation 4 arrives corrupt (it must be skipped, generation 3 serving)
ONLINE_FAULT = "online_publish_fail@2,online_chunk_corrupt@4"
ONLINE_PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
                 "min_data_in_leaf": 10, "device_predict": "true",
                 "device_predict_min_bucket": 64,
                 "serve_max_batch_rows": 256, "serve_queue_depth": 256,
                 "serve_max_coalesce_wait_ms": 2.0, "metrics_port": 0,
                 "online_trees_per_chunk": ONLINE_TREES_PER_CHUNK,
                 "online_mode": "boost", "online_max_lag_s": ONLINE_MAX_LAG_S,
                 "online_publish_backoff_ms": 25.0}
# the SIGTERM drill's `python -m lightgbm_tpu_torch train-and-serve`
# children: 3 on-disk chunks, 2 trees a chunk
ONLINE_CHILD_ARGS = ["objective=binary", "num_leaves=15", "verbosity=-1",
                     "min_data_in_leaf=10", "device_predict=true",
                     "device_predict_min_bucket=64", "serve_warmup=false",
                     "online_mode=boost", "online_trees_per_chunk=2",
                     "online_poll_interval_s=0.05"]
ONLINE_CHILD_S = 600        # each child's deadline
ONLINE_DEVICE = "cuda"      # where the generations train and are served
ONLINE_COUNTERS = ("online_generations_published",
                   "online_generations_skipped", "online_publish_retries")


def online_chunk(seed, rows=None):
    return make_higgs_like(rows or ONLINE_CHUNK_ROWS, ONLINE_F, seed=seed)


def child_run(cmd, log, env):
    """A drill child with its output in `log` (a path)."""
    f = open(log, "w")
    try:
        return subprocess.Popen(cmd, cwd=REPO_ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    finally:
        f.close()


def wait_exit(proc, what, log, timeout=ONLINE_CHILD_S):
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        raise AssertionError(f"online drill: {what} did not exit within "
                             f"{timeout} s: {open(log).read()[-1500:]}")


def wait_file(path, proc, what, log, timeout=ONLINE_CHILD_S):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            proc.wait(timeout=60)
            raise AssertionError(f"online drill: {what}: no {path} (rc "
                                 f"{proc.returncode}): "
                                 f"{open(log).read()[-1500:]}")
        time.sleep(0.1)


def online_drill(lgb, workdir, seed_path, pool):
    """The SIGTERM drill (module docstring): a control child and the drill
    child side by side, then the drill's relaunch.  Returns its line."""
    import shutil
    import signal
    from lightgbm_tpu_torch.online import write_chunk
    from lightgbm_tpu_torch.serving import LineClient
    t0 = time.perf_counter()
    chunks_a = os.path.join(workdir, "chunks-a")
    chunks_b = os.path.join(workdir, "chunks-b")
    os.makedirs(chunks_a)
    os.makedirs(chunks_b)
    files = {g: write_chunk(chunks_a, g, *online_chunk(100 + g))
             for g in (1, 2, 3)}
    base = [sys.executable, "-m", "lightgbm_tpu_torch", "train-and-serve",
            *ONLINE_CHILD_ARGS, f"input_model={seed_path}"]
    if ONLINE_DEVICE != "cuda":
        base.append(f"device_type={ONLINE_DEVICE}")
    env = {k: v for k, v in os.environ.items() if k != "LGBM_TPU_FAULT"}
    ck_a, ck_b = (os.path.join(workdir, d) for d in ("ckpt-a", "ckpt-b"))
    logs = {k: os.path.join(workdir, f"{k}.log")
            for k in ("control", "drill", "relaunch")}
    control = child_run(base + [f"online_chunk_dir={chunks_a}",
                                f"checkpoint_dir={ck_a}", "serve_port=-1",
                                "online_idle_exit_s=1.5"],
                        logs["control"], env)
    for g in (1, 2):
        shutil.copy(files[g], chunks_b)
    drill = child_run(base + [f"online_chunk_dir={chunks_b}",
                              f"checkpoint_dir={ck_b}", "serve_port=-1",
                              "online_idle_exit_s=0"], logs["drill"], env)
    try:
        wait_file(os.path.join(ck_b, "ckpt_0000002.txt"), drill, "drill",
                  logs["drill"])
        time.sleep(0.3)     # the generation-2 publish settles
        drill.send_signal(signal.SIGTERM)
        kill_rc = wait_exit(drill, "the SIGTERM'd drill", logs["drill"])
        control_rc = wait_exit(control, "control", logs["control"])
    finally:
        for p in (drill, control):
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
    control_s = time.perf_counter() - t0
    if control_rc != 0 or kill_rc not in (143, -15):
        raise AssertionError(f"online drill: control rc {control_rc}, "
                             f"SIGTERM rc {kill_rc} (want 0, 143)")
    texts = {g: open(os.path.join(ck_a, f"ckpt_000000{g}.txt")).read()
             for g in (2, 3)}
    expected = {g: lgb.Booster(model_str=t, params={
        "device_predict": "true"}).predict(pool[:ONLINE_REQ_ROWS])
        for g, t in texts.items()}
    shutil.copy(files[3], chunks_b)
    ready = os.path.join(workdir, "ready-b2.json")
    t1 = time.perf_counter()
    relaunch = child_run(base + [f"online_chunk_dir={chunks_b}",
                                 f"checkpoint_dir={ck_b}", "serve_port=0",
                                 "online_idle_exit_s=1.5",
                                 f"serve_ready_file={ready}"],
                         logs["relaunch"], env)
    try:
        wait_file(ready, relaunch, "relaunch", logs["relaunch"])
        ready_s = time.perf_counter() - t1
        with open(ready) as f:
            info = json.load(f)
        c = LineClient("127.0.0.1", int(info["port"]))
        try:
            reply = c.request({"model": "online",
                               "rows": pool[:ONLINE_REQ_ROWS].tolist()},
                              timeout_s=120)
        finally:
            c.close()
        resume_rc = wait_exit(relaunch, "relaunch", logs["relaunch"])
    finally:
        if relaunch.poll() is None:
            relaunch.kill()
            relaunch.wait(timeout=60)
    got = np.asarray(reply.get("preds", []), np.float64).astype(np.float32)
    served = [g for g, e in expected.items() if got.tobytes() == e.tobytes()]
    with open(os.path.join(ck_b, "ckpt_0000003.txt")) as f:
        byte_exact = f.read() == texts[3]
    if (info.get("generation") != 2 or not reply.get("ok") or not served
            or resume_rc != 0 or not byte_exact):
        raise AssertionError(
            f"online drill: relaunch ready at generation "
            f"{info.get('generation')} (want 2), served generation "
            f"{served} (want 2 or 3), rc {resume_rc}, generation 3 byte "
            f"for byte the control's: {byte_exact}; "
            f"{open(logs['relaunch']).read()[-1500:]}")
    return {"control_rc": control_rc, "kill_rc": kill_rc,
            "resume_rc": resume_rc, "byte_exact": byte_exact,
            "relaunch_ready_generation": info["generation"],
            "relaunch_served_generation": served[0],
            "control_and_kill_s": control_s, "relaunch_ready_s": ready_s,
            "seconds": time.perf_counter() - t0}


def phase_online(lgb, H, card):
    """The online phase (module docstring): the in-process loop under
    load with the chaos spec, then the SIGTERM drill.  Returns the boost
    generations' launches."""
    import shutil
    import threading
    import urllib.request
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.observability.registry import global_registry
    from lightgbm_tpu_torch.online import (LocalPublisher,
                                           MemoryChunkSource, OnlineTrainer)
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.serving import ServingDaemon, serve_counters_reset
    t_phase = time.perf_counter()
    shutil.rmtree(ONLINE_DIR, ignore_errors=True)
    os.makedirs(ONLINE_DIR)
    workdir = os.path.abspath(ONLINE_DIR)
    corrupt = {int(tok.split("@")[1]) for tok in ONLINE_FAULT.split(",")
               if tok.startswith("online_chunk_corrupt@")}
    serve_counters_reset()
    for key in ONLINE_COUNTERS:
        global_registry.inc(key, -global_registry.counter(key))
    pool = np.ascontiguousarray(
        make_higgs_like(ONLINE_POOL, ONLINE_F, seed=99)[0], np.float32)
    chunks = [online_chunk(g) for g in range(ONLINE_CHUNKS + 1)]
    X0, y0 = chunks[0]
    seed = lgb.train({k: v for k, v in ONLINE_PARAMS.items()
                      if not k.startswith(("serve_", "online_", "metrics_"))},
                     lgb.Dataset(X0, label=y0), ONLINE_SEED_TREES)
    seed_path = os.path.join(workdir, "seed.txt")
    seed.save_model(seed_path)
    prev_fault = os.environ.get("LGBM_TPU_FAULT")
    os.environ["LGBM_TPU_FAULT"] = ONLINE_FAULT
    faults.reload()
    failures, samples, models = [], [], {}
    lock = threading.Lock()
    try:
        daemon = ServingDaemon(Config(ONLINE_PARAMS)).start()
        try:
            if daemon.registry.device.type != ONLINE_DEVICE:
                raise AssertionError(f"online: daemon on "
                                     f"{daemon.registry.device}")

            def on_publish(gen, version, model_str):
                with lock:
                    models[version] = model_str

            source = MemoryChunkSource()
            trainer = OnlineTrainer(
                source, LocalPublisher(daemon, timeout_s=300.0),
                params=dict(ONLINE_PARAMS),
                checkpoint_dir=os.path.join(workdir, "ckpt"),
                seed_model=seed_path, on_publish=on_publish)
            trainer.start()
            stop = threading.Event()

            def client(tid):
                rnd = 0
                while not stop.is_set():
                    rnd += 1
                    lo = ((tid * 2654435761 + rnd * 97)
                          % (len(pool) - ONLINE_REQ_ROWS))
                    ts = time.perf_counter()
                    try:
                        fut = daemon.submit(trainer.model_name,
                                            pool[lo:lo + ONLINE_REQ_ROWS])
                        out = fut.result(timeout=120)
                    except Exception as e:  # noqa: BLE001
                        with lock:
                            failures.append(f"t{tid}r{rnd}: {e!r}")
                        time.sleep(0.05)
                        continue
                    ms = (time.perf_counter() - ts) * 1e3
                    with lock:
                        samples.append((fut.version, lo, np.asarray(out), ms))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(ONLINE_THREADS)]
            # the generations' launches alone: the seed trained before
            reset_counts(H)
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            loop = threading.Thread(target=trainer.run, kwargs={
                "max_generations": ONLINE_CHUNKS, "idle_exit_s": 60.0})
            loop.start()
            for g in range(1, ONLINE_CHUNKS + 1):
                source.push(*chunks[g])
                time.sleep(ONLINE_PUSH_S)
            loop.join(timeout=600)
            stop.set()
            for t in threads:
                t.join(timeout=120)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = launch_counts(H)
            alive = [t.name for t in threads + [loop] if t.is_alive()]
            if alive:
                trainer.request_stop()
                raise AssertionError(f"online: {alive} still running")
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{daemon.metrics_server.port}/metrics",
                timeout=30).read().decode()
        finally:
            daemon.stop(drain=True, timeout=60)
    finally:
        if prev_fault is None:
            os.environ.pop("LGBM_TPU_FAULT", None)
        else:
            os.environ["LGBM_TPU_FAULT"] = prev_fault
        faults.reload()
    expected = {v: lgb.Booster(model_str=s, params={
        "device_predict": "true"}).predict(pool) for v, s in models.items()}
    mismatches = sum(
        1 for v, lo, preds, _ in samples
        if v not in expected
        or preds.tobytes() != expected[v][lo:lo + ONLINE_REQ_ROWS].tobytes())
    published = int(global_registry.counter("online_generations_published"))
    skipped = int(global_registry.counter("online_generations_skipped"))
    retries = int(global_registry.counter("online_publish_retries"))
    stats = trainer.stats()
    lag = stats.get("freshness_lag_s")
    missing = [k for k in ("lgbm_model_freshness_lag_s",
                           "lgbm_online_generations_published",
                           "lgbm_online_generation",
                           "lgbm_online_generations_skipped")
               if k not in page]
    problems = []
    if failures:
        problems.append(f"{len(failures)} lost requests: {failures[:3]}")
    if mismatches:
        problems.append(f"{mismatches} responses not byte-identical to "
                        "their serving generation")
    if published < 3:
        problems.append(f"{published} generations published (want >= 3)")
    if skipped != 1 or skipped != len(corrupt):
        problems.append(f"{skipped} generations skipped (want 1)")
    if retries < 1:
        problems.append("no publish retry")
    if lag is None or not np.isfinite(lag) or lag > ONLINE_MAX_LAG_S:
        problems.append(f"freshness lag {lag} (want finite, <= "
                        f"{ONLINE_MAX_LAG_S} s)")
    if missing:
        problems.append(f"/metrics lacks {missing}")
    if problems:
        raise AssertionError("online: " + "; ".join(problems))
    # the wave engine carries every histogram: at 15 leaves no wave has
    # more than 8 computed slots, so K3 takes them all and K1 may not run
    check_kernels("online", launches,
                  ("K1", "K3") if launches["K1"] else ("K3",))
    drill = online_drill(lgb, workdir, seed_path, pool)
    lat = [ms for *_, ms in samples]
    hist = trainer.history
    emit({"phase": "online", "chunk_rows": ONLINE_CHUNK_ROWS,
          "features": ONLINE_F, "chunks": ONLINE_CHUNKS,
          "seed_trees": ONLINE_SEED_TREES,
          "trees_per_chunk": ONLINE_TREES_PER_CHUNK,
          "num_leaves": ONLINE_PARAMS["num_leaves"], "fault": ONLINE_FAULT,
          "generations_published": published,
          "generations_skipped": skipped, "publish_retries": retries,
          "requests": len(samples), "lost_requests": len(failures),
          "versions_served": sorted({v for v, *_ in samples}),
          "p50_ms": float(np.percentile(lat, 50)),
          "p99_ms": float(np.percentile(lat, 99)),
          "rows_per_s": len(samples) * ONLINE_REQ_ROWS / wall,
          "freshness_lag_s": lag,
          "lag_s_by_generation": [h["freshness_lag_s"] for h in hist],
          "train_s_by_generation": [h["train_s"] for h in hist],
          "trees_by_generation": [h["trees"] for h in hist],
          "generations": [h["generation"] for h in hist],
          "launches": launches, "loop_wall_s": wall, "drill": drill,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return launches


# the huge_bins phase: more than 65,536 bins in a column (int32 codes)
HUGE_ROWS = 100_000
HUGE_F = 4
HUGE_MAX_BIN = 70_000
HUGE_ITERATIONS = 2
HUGE_PARAMS = {"objective": "binary", "num_leaves": 15,
               "learning_rate": 0.1, "max_bin": HUGE_MAX_BIN,
               "min_data_in_bin": 1, "min_data_in_leaf": 20,
               "verbosity": -1}
HUGE_RUNS = (("leafwise", {"tpu_growth_strategy": "leafwise"}, ("K4",)),
             ("quantized", {"tpu_growth_strategy": "wave",
                            "use_quantized_grad": True}, ("K2",)),
             ("wave", {"tpu_growth_strategy": "wave"}, ("K1", "K3")))


def wave_kernels_at(H, max_bin):
    """The wave engine's float kernels at `max_bin` bins: K1, and K3 where
    the dispatch rule (the JAX package's `wave_hl_profitable`, then the
    tile rule `wave_hl_fits`) marks a wave of 1-8 computed slots; above
    7,231 bins it marks none (the tile rule; above 8,192 the JAX rule
    too), so K1 takes every wave."""
    k3 = any(H.wave_hl_profitable(max_bin, s) and H.wave_hl_fits(max_bin, s)
             for s in range(1, 9))
    return ("K1", "K3") if k3 else ("K1",)


def phase_huge_bins(lgb, H, card):
    """max_bin HUGE_MAX_BIN on HUGE_ROWS rows of HUGE_F features: int32
    device codes through the leaf-wise engine (K4), quantized (K2) and
    the wave engine (K1/K3, where `wave_fits` takes the width), each run
    HUGE_ITERATIONS iterations on one Dataset, its trees held to the
    port's CPU trees (trained in spawned workers meanwhile).  Returns
    {run: launches}."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from lightgbm_tpu_torch.boosting.gbdt import wave_fits
    t_phase = time.perf_counter()
    X, y = make_higgs_like(HUGE_ROWS, HUGE_F, seed=3)
    wave_ok = wave_fits(HUGE_F, HUGE_MAX_BIN, HUGE_PARAMS["num_leaves"])
    runs = [r for r in HUGE_RUNS if wave_ok or r[0] == "leafwise"]
    cases = {name: {"name": f"huge_bins_{name}", "X": X, "y": y,
                    "ds_kw": {}, "params": {**HUGE_PARAMS, **extra},
                    "iterations": HUGE_ITERATIONS, "forced": False}
             for name, extra, _ in runs}
    pool = ProcessPoolExecutor(
        max_workers=len(cases),
        mp_context=multiprocessing.get_context("spawn"))
    out = {}
    try:
        futures = {name: pool.submit(cpu_case, c)
                   for name, c in cases.items()}
        t0 = time.perf_counter()
        ds = lgb.Dataset(X, label=y, params=dict(HUGE_PARAMS)).construct()
        construct_s = time.perf_counter() - t0
        for name, extra, kernels in runs:
            params = {**HUGE_PARAMS, **extra}
            check_dataset_params(f"huge_bins {name}", params, ds)
            booster = lgb.Booster(params=params, train_set=ds)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(H)
            iters = []
            for _ in range(HUGE_ITERATIONS):
                t1 = time.perf_counter()
                if booster.update():
                    raise AssertionError(f"huge_bins {name}: stopped early")
                torch.cuda.synchronize()
                iters.append(time.perf_counter() - t1)
            launches = launch_counts(H)
            peak = torch.cuda.max_memory_allocated() / 2**30
            g = booster._gbdt
            if g.binned_dev.dtype != torch.int32:
                raise AssertionError(f"huge_bins {name}: device codes "
                                     f"{g.binned_dev.dtype}, not int32")
            want = extra["tpu_growth_strategy"]
            if g.growth_strategy != want:
                raise AssertionError(f"huge_bins {name}: the "
                                     f"{g.growth_strategy} engine")
            if name == "wave":
                kernels = wave_kernels_at(H, HUGE_MAX_BIN)
            check_kernels(f"huge_bins {name}", launches, kernels)
            cpu_models, _ = futures[name].result(timeout=900)
            if len(cpu_models) != len(g.models_):
                raise AssertionError(f"huge_bins {name}: {len(g.models_)} "
                                     f"card trees, {len(cpu_models)} CPU")
            worst = max(hold_tree(f"huge_bins {name}", i, a, b)
                        for i, (a, b) in enumerate(zip(g.models_,
                                                       cpu_models)))
            emit({"phase": "huge_bins", "run": name, "rows": HUGE_ROWS,
                  "features": HUGE_F, "max_bin": HUGE_MAX_BIN,
                  "num_bin": [int(b) for b in g.f_num_bin],
                  "num_leaves": HUGE_PARAMS["num_leaves"],
                  "iterations": HUGE_ITERATIONS, "codes": "int32",
                  "growth_strategy": g.growth_strategy,
                  "construct_s": construct_s, "iter_s": iters,
                  "s_per_iter": sum(iters) / len(iters),
                  "peak_mem_gib": peak, "launches": launches,
                  "leaves": [t.num_leaves for t in g.models_],
                  "card_vs_cpu_max_rel_leaf_diff": worst, "card": card})
            out[f"huge_bins_{name}"] = launches
            del booster, g
        if not wave_ok:
            emit({"phase": "huge_bins", "run": "wave", "skipped":
                  "wave_fits refuses the width"})
        del ds
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "huge_bins_total", "seconds": time.perf_counter() - t_phase,
          "card": card})
    return out


DP_DIR = os.path.join("build", "chip_smoke_data_parallel")
DP_RANKS = 2                # train_distributed's ranks, sharing the card
# the leaf-wise run (the voting runs' reference): 1 (3 until the
# parallel_learners phase took its time, then 2)
DP_LEAFWISE_ITERATIONS = 1
DP_RUNS = (("wave", {}, 5, ("K1", "K3")),
           ("quantized", {"use_quantized_grad": True}, 3, ("K2",)),
           ("leafwise", {"tpu_growth_strategy": "leafwise"},
            DP_LEAFWISE_ITERATIONS, ("K4",)))
DP_NCCL_ITERATIONS = 3      # (a): world size 1 on NCCL, the wave engine
DP_TIMEOUT_S = 600          # each cluster's deadline
DP_DEVICE = "cuda"          # where the ranks train
DP_KERNEL_NAMES = {"build_histogram_wave": "K1",
                   "build_histogram_wave_int": "K2",
                   "build_histogram_wave_hl": "K3",
                   "build_histogram_rows_pallas": "K4"}
def dp_rank_line(st):
    """One rank's figures: s/iter (every iteration, the first included),
    the all-reduce's ms and bytes per iteration, the backend, the
    launches by kernel."""
    it = max(st["iterations"], 1)
    launches = st["launches"]
    return {"rank": st["rank"], "backend": st["backend"],
            "world": st["world"], "iterations": st["iterations"],
            "s_per_iter": st["seconds"] / it,
            "allreduce_ms_per_iter": 1000.0 * st["allreduce_seconds"] / it,
            "allreduce_bytes_per_iter": st["allreduce_bytes"] / it,
            "allreduce_calls_per_iter": st["allreduce_calls"] / it,
            "launches": {DP_KERNEL_NAMES.get(k, k): v
                         for k, v in launches.items()}}


def phase_data_parallel(lgb, H, card, bench):
    """tree_learner=data at the main path's width (bench rows, 255
    leaves, 255 bins, binary).  The serial references: each run's params
    (tree_learner=data, no process group: one device) on the shared bench
    Dataset, whose bins every rank loads from a `save_binary` file.  (a)
    world size 1 on NCCL: `train_distributed(num_machines=1)`, one CUDA
    child that joins a one-machine cluster and trains DP_NCCL_ITERATIONS
    wave iterations; its model text must equal the serial run's byte for
    byte.  (b) DP_RANKS ranks sharing the card through
    `train_distributed` (gloo by the backend rule), each training its
    half of the rows: the wave engine (K1/K3), quantized (K2) and the
    leaf-wise engine (K4), each model text equal to the serial run's byte
    for byte and each rank's launches of the run's kernels > 0 (the
    others 0).  One `data_parallel` line per run, with each rank's
    s/iter, all-reduce ms, bytes and calls per iteration, backend and
    launches.  Returns ({path: rank 0's launches}, the references the
    parallel_learners phase reuses: the bins' file and each serial
    run's model text)."""
    from lightgbm_tpu_torch.distributed import train_distributed
    t_phase = time.perf_counter()
    (X, _, _, _), ds = bench
    os.makedirs(DP_DIR, exist_ok=True)
    serial = {}
    want_runs = [("nccl_wave", {}, DP_NCCL_ITERATIONS, ("K1", "K3"))] + [
        (name, extra, iters, kern) for name, extra, iters, kern in DP_RUNS]
    # the bench Dataset's bins as a binary file, which every rank loads
    # instead of binning the rows again
    data_path = os.path.join(DP_DIR, "bench.bin")
    ds.save_binary(data_path)
    for name, extra, iters, _ in want_runs:
        params = {**BENCH_PARAMS, **extra, "tree_learner": "data",
                  "device_type": DP_DEVICE}
        check_dataset_params(f"data_parallel {name}", params, ds)
        t0 = time.perf_counter()
        b = lgb.train(params, ds, iters)
        torch.cuda.synchronize()
        serial[name] = (b.model_to_string(), time.perf_counter() - t0)
        if b._gbdt.net is not None:
            raise AssertionError("data_parallel: the serial reference "
                                 "trained in a process group")
        del b
    out = {}
    # (a) world size 1 on NCCL, then (b) DP_RANKS ranks sharing the card
    for name, extra, iters, kernels in want_runs:
        world = 1 if name == "nccl_wave" else DP_RANKS
        params = {**BENCH_PARAMS, **extra, "tree_learner": "data",
                  "device_type": DP_DEVICE}
        t0 = time.perf_counter()
        b = train_distributed(params, data_path, num_boost_round=iters,
                              num_machines=world, timeout=DP_TIMEOUT_S)
        cluster_s = time.perf_counter() - t0
        ranks = [dp_rank_line(st) for st in b.worker_stats]
        if b.model_to_string() != serial[name][0]:
            raise AssertionError(f"data_parallel {name}: the model text "
                                 "differs from the serial run's")
        # NCCL takes one rank a card; ranks sharing the card take gloo
        backend = "nccl" if DP_DEVICE == "cuda" and world == 1 else "gloo"
        for r in ranks:
            if r["backend"] != backend:
                raise AssertionError(f"data_parallel {name}: rank "
                                     f"{r['rank']} on {r['backend']}, not "
                                     f"{backend}")
            check_kernels(f"data_parallel {name} rank {r['rank']}",
                          r["launches"], kernels)
            if r["world"] != world or r["iterations"] != iters:
                raise AssertionError(f"data_parallel {name}: rank {r}")
        out[f"data_parallel_{name}"] = ranks[0]["launches"]
        emit({"phase": "data_parallel", "run": name, "world": world,
              "rows": int(X.shape[0]), "iterations": iters,
              "model_text_equal": True, "cluster_s": cluster_s,
              "serial_s": serial[name][1],
              "serial_s_per_iter": serial[name][1] / iters,
              "ranks": ranks, "card": card})
        del b
    emit({"phase": "data_parallel_total",
          "seconds": time.perf_counter() - t_phase, "card": card})
    return out, {"data_path": data_path,
                 "serial": {k: v[0] for k, v in serial.items()}}


PL_DIR = os.path.join("build", "chip_smoke_parallel_learners")
PL_RANKS = 2                # ranks of the learners' cluster, sharing the card
PL_TOP_K = 4                # the small vote (of the bench's 28 features)
PL_CPU_ROWS = 16_384        # the small vote held to a CPU cluster's trees
PL_CPU_ITERATIONS = 1       # ... for this many iterations
PL_CORR_MIN = 0.95          # held-out raw-score correlation of the small vote
PL_TIMEOUT_S = 600          # the cluster's and the drill's deadline
PL_DEVICE = "cuda"          # where the ranks train
# the votes' iterations, held to the leaf-wise reference's first trees
# (2 in the phase's first version)
PL_VOTE_ITERATIONS = 1
# (name, params over BENCH_PARAMS, iterations, data_parallel's serial
# reference, the kernels that carry it)
PL_RUNS = (
    ("feature_wave", {"tree_learner": "feature"}, 5, "wave", ("K1", "K3")),
    ("feature_quantized", {"tree_learner": "feature",
                           "use_quantized_grad": True}, 3, "quantized",
     ("K2",)),
    ("voting_full", {"tree_learner": "voting", "top_k": 28,
                     "tpu_growth_strategy": "leafwise"},
     PL_VOTE_ITERATIONS, "leafwise", ("K4",)),
    ("voting_top4", {"tree_learner": "voting", "top_k": PL_TOP_K,
                     "tpu_growth_strategy": "leafwise"},
     PL_VOTE_ITERATIONS, None, ("K4",)))
PL_DRILL_ITERATIONS = 5     # the elastic drill (data_parallel's wave ref)
PL_DRILL_FAULT = "worker_lost@3"
# one rank of the learners' cluster: joins the group over a FileStore,
# trains each run of the spec on the bench bins (or on PL_CPU_ROWS rows of
# make_higgs_like), prints one `pl_stats` line a run and rank 0 writes
# each model text
PL_CHILD = r"""
import json, os, sys, time
spec = json.load(open(sys.argv[1]))
rank = int(sys.argv[2])
sys.path.insert(0, spec["repo"])
import torch
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.distributed import join_cluster, leave_cluster
from lightgbm_tpu_torch.ops import histogram as H
from lightgbm_tpu_torch.parallel import current_network
from chip_smoke import BENCH_PARAMS, make_higgs_like
join_cluster(["localhost:0"] * spec["world"], rank=rank,
             initialize_timeout=spec["timeout"], device_type=spec["device"],
             store_path=spec["store"])
net = current_network()
kernels = (H.build_histogram_wave, H.build_histogram_wave_hl,
           H.build_histogram_wave_int, H.build_histogram_rows_pallas)
bench = lgb.Dataset(spec["data"], params={**BENCH_PARAMS,
                                          "device_type": spec["device"]})
for run in spec["runs"]:
    params = run["params"]
    if params["device_type"] == "cpu":
        # CPU ranks share the host's cores (train_distributed's rule)
        torch.set_num_threads(spec["cpu_threads"])
    if run["rows"]:
        X, y = make_higgs_like(run["rows"], 28, seed=3)
        ds = lgb.Dataset(X, label=y, params=params)
    else:
        ds = bench
    for k in kernels:
        k.launches = 0
    before = dict(net.stats())
    t0 = time.perf_counter()
    b = lgb.train(params, ds, run["iterations"])
    if params["device_type"] == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = net.stats()
    g = b._gbdt
    print("pl_stats " + json.dumps({
        "run": run["name"], "rank": rank, "seconds": seconds,
        "iterations": b.current_iteration(), "backend": after["backend"],
        "world": after["world"],
        "allreduce_calls": after["calls"] - before["calls"],
        "allreduce_bytes": after["bytes"] - before["bytes"],
        "allreduce_seconds": after["seconds"] - before["seconds"],
        "launches": {k.__name__: k.launches for k in kernels},
        "block": None if g.block is None else [g.block.start, g.block.stop],
        "rows": None if g.shard is None else g.shard.count,
        "voting": g.voting is not None,
        "strategy": g.growth_strategy}), flush=True)
    if rank == 0:
        with open(os.path.join(spec["out"], run["name"] + ".txt"), "w") as f:
            f.write(b.model_to_string())
    del b, ds
leave_cluster()
print(f"rank {rank} done", flush=True)
"""


def trees_of(text, k=None):
    """A model text's trees, from `Tree=0` to `end of trees` (the header
    and the parameters block name the learner), or its first k."""
    end = text.index("end of trees")
    if k is not None and f"Tree={k}\n" in text:
        end = text.index(f"Tree={k}\n")
    return text[text.index("Tree=0"):end]


def pl_start(runs, data_path):
    """Start PL_RANKS ranks of PL_CHILD over `runs` (one process group for
    all of them: each rank starts once); returns (processes, log
    paths)."""
    os.makedirs(PL_DIR, exist_ok=True)
    script = os.path.join(PL_DIR, "child.py")
    with open(script, "w") as f:
        f.write(PL_CHILD)
    store = os.path.join(PL_DIR, "store")
    if os.path.exists(store):
        os.unlink(store)
    spec = {"world": PL_RANKS, "repo": REPO_ROOT, "store": store,
            "timeout": PL_TIMEOUT_S, "device": PL_DEVICE,
            "cpu_threads": max(1, (os.cpu_count() or 1) // PL_RANKS),
            "data": data_path, "out": PL_DIR, "runs": runs}
    spec_path = os.path.join(PL_DIR, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    logs = [os.path.join(PL_DIR, f"rank{r}.log") for r in range(PL_RANKS)]
    procs = []
    try:
        for r in range(PL_RANKS):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, script, spec_path, str(r)],
                    stdout=f, stderr=subprocess.STDOUT))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        raise
    return procs, logs


def pl_stats(res, logs):
    """The cluster's `pl_stats` lines, {run: [rank stats]}, once
    `supervise` has reaped it (`res`, its SuperviseResult)."""
    if not res.ok:
        raise AssertionError("parallel_learners: the cluster failed\n"
                             + res.describe())
    stats = {}
    for path in logs:
        with open(path) as f:
            for ln in f:
                if ln.startswith("pl_stats "):
                    st = json.loads(ln[len("pl_stats "):])
                    stats.setdefault(st["run"], []).append(st)
    return stats


def elastic_drill(data_path):
    """The elastic drill through `train_distributed` (PL_RANKS ranks,
    PL_DRILL_FAULT on rank 1, one retry); returns (booster, seconds,
    metrics dir)."""
    from lightgbm_tpu_torch.distributed import train_distributed
    md = os.path.join(PL_DIR, "metrics")
    ck = os.path.join(PL_DIR, "ckpt")
    for d in (md, ck):
        shutil.rmtree(d, ignore_errors=True)
    params = {**BENCH_PARAMS, "tree_learner": "data", "metrics_dir": md,
              "device_type": PL_DEVICE}
    t0 = time.perf_counter()
    b = train_distributed(params, data_path,
                          num_boost_round=PL_DRILL_ITERATIONS,
                          num_machines=PL_RANKS, timeout=PL_TIMEOUT_S,
                          max_retries=1, checkpoint_dir=ck,
                          checkpoint_freq=1, retry_backoff=0.5,
                          worker_env={"LGBM_TPU_FAULT": PL_DRILL_FAULT,
                                      "LGBM_TPU_FAULT_RANK": "1"})
    return b, time.perf_counter() - t0, md


def phase_parallel_learners(lgb, H, card, bench, dp):
    """The feature- and voting-parallel learners and the elastic relaunch
    at the main path's width, right after data_parallel, on its bench
    bins file and against its serial card references (model text from
    `Tree=0` on, the run's first trees; no serial training here).  One
    cluster of PL_RANKS ranks sharing the card (gloo) trains, in turn:
    (0) voting at top_k = PL_TOP_K at PL_CPU_ROWS rows for
    PL_CPU_ITERATIONS on the card and on the CPU in the same group, the
    trees equal; (1) feature, the wave engine, 5 iterations:
    data_parallel's wave reference, K1 and K3 on each rank; (2) feature
    quantized, 3: its quantized reference, K2; (3) voting at top_k = 28
    (every feature), leaf-wise, PL_VOTE_ITERATIONS (1): its leaf-wise
    reference, K4; (4) voting at top_k = PL_TOP_K, as many: K4, the
    collective bytes per iteration at most PL_TOP_K/28 of run 3's plus
    F*4 + 72 bytes a call (the [F] proposals and the small reductions),
    the held-out raw scores' correlation with the leaf-wise reference's
    first trees >= PL_CORR_MIN.  (5) Meanwhile, while the cluster starts
    and trains (0), the elastic drill through `train_distributed`:
    tree_learner=data, wave, PL_DRILL_ITERATIONS iterations, 2 ranks
    with PL_DRILL_FAULT on rank 1 (exit 77, a tombstone),
    max_retries=1, checkpoint_freq=1: the relaunch is one rank on NCCL
    that resumes from the checkpoint (its event log holds 2 iterations)
    and ends with data_parallel's wave reference's trees,
    elastic_shrinks 1.  The cluster's ranks are reaped by
    `reliability.supervisor.supervise` (a failed rank ends the others;
    the deadline PL_TIMEOUT_S ends all).  One `parallel_learners` line
    per run: each rank's s/iter, collective ms, bytes and calls per
    iteration, backend and launches, the run's (or the drill's) seconds
    and attempts.  Returns {path: rank 0's launches}."""
    from lightgbm_tpu_torch.reliability.supervisor import supervise
    t_phase = time.perf_counter()
    (X, _, Xte, _), _ = bench
    os.makedirs(PL_DIR, exist_ok=True)
    small = dict(PL_RUNS[-1][1])
    runs = [{"name": f"voting_top4_{PL_CPU_ROWS}_{side}",
             "iterations": PL_CPU_ITERATIONS, "rows": PL_CPU_ROWS,
             "params": {**BENCH_PARAMS, **small, "device_type": dev}}
            for side, dev in (("card", PL_DEVICE), ("cpu", "cpu"))]
    runs += [{"name": name, "iterations": iters, "rows": 0,
              "params": {**BENCH_PARAMS, **extra, "device_type": PL_DEVICE}}
             for name, extra, iters, _, _ in PL_RUNS]
    procs, logs = pl_start(runs, dp["data_path"])
    t0 = time.perf_counter()
    try:
        b, drill_s, md = elastic_drill(dp["data_path"])
    finally:
        res = supervise(procs, logs, PL_TIMEOUT_S)
    cluster_s = time.perf_counter() - t0
    stats = pl_stats(res, logs)

    def model(name):
        with open(os.path.join(PL_DIR, name + ".txt")) as f:
            return f.read()

    out = {}
    for name, extra, iters, ref, kernels in PL_RUNS:
        ranks = sorted(stats[name], key=lambda st: st["rank"])
        lines = [{**dp_rank_line(st), "block": st["block"],
                  "rows": st["rows"]} for st in ranks]
        text = model(name)
        if ref is not None and (trees_of(text)
                                != trees_of(dp["serial"][ref], iters)):
            raise AssertionError(f"parallel_learners {name}: the trees "
                                 f"differ from the serial {ref} run's")
        for st, ln in zip(ranks, lines):
            check_kernels(f"parallel_learners {name} rank {st['rank']}",
                          ln["launches"], kernels)
            if (st["backend"] != "gloo" or st["world"] != PL_RANKS
                    or st["iterations"] != iters
                    or st["voting"] != extra["tree_learner"].startswith("v")
                    or (st["block"] is None)
                    != (extra["tree_learner"] != "feature")):
                raise AssertionError(f"parallel_learners {name}: {st}")
        line = {"phase": "parallel_learners", "run": name,
                "world": PL_RANKS, "rows": int(X.shape[0]),
                "iterations": iters, "trees_equal_serial": ref is not None,
                "run_s": max(st["seconds"] for st in ranks), "attempts": 1,
                "ranks": lines, "card": card}
        if name == "voting_top4":
            full = stats["voting_full"]
            Fb = X.shape[1]
            for st, fst in zip(ranks, sorted(full,
                                             key=lambda t: t["rank"])):
                per_it = st["allreduce_bytes"] / iters
                allowed = (PL_TOP_K / 28.0 * fst["allreduce_bytes"] / iters
                           + st["allreduce_calls"] / iters * (Fb * 4 + 72))
                if per_it > allowed:
                    raise AssertionError(
                        f"parallel_learners {name}: {per_it} bytes an "
                        f"iteration, above {allowed}")
            ref_b = lgb.Booster(model_str=dp["serial"]["leafwise"])
            got_b = lgb.Booster(model_str=text)
            corr = float(np.corrcoef(
                got_b.predict(Xte, raw_score=True),
                ref_b.predict(Xte, raw_score=True,
                              num_iteration=iters))[0, 1])
            if not corr >= PL_CORR_MIN:
                raise AssertionError(f"parallel_learners {name}: held-out "
                                     f"raw-score correlation {corr}")
            small_txt = [model(f"voting_top4_{PL_CPU_ROWS}_{side}")
                         for side in ("card", "cpu")]
            if trees_of(small_txt[0]) != trees_of(small_txt[1]):
                raise AssertionError(f"parallel_learners {name}: at "
                                     f"{PL_CPU_ROWS} rows the card's trees "
                                     "differ from the CPU cluster's")
            line.update(heldout_corr_vs_leafwise=corr,
                        bytes_ratio_vs_top28=(
                            ranks[0]["allreduce_bytes"]
                            / max(full[0]["allreduce_bytes"], 1)),
                        card_equals_cpu_rows=PL_CPU_ROWS,
                        card_equals_cpu_run_s=[
                            max(st["seconds"] for st in stats[
                                f"voting_top4_{PL_CPU_ROWS}_{side}"])
                            for side in ("card", "cpu")])
        out[f"parallel_learners_{name}"] = lines[0]["launches"]
        emit(line)
    # (5) the elastic drill
    if trees_of(b.model_to_string()) != trees_of(dp["serial"]["wave"]):
        raise AssertionError("parallel_learners elastic: the trees differ "
                             "from the serial wave run's")
    sup = read_events(os.path.join(md, "events-ranksupervisor.jsonl"))
    kinds = [(e["event"], e.get("classification")) for e in sup]
    shrink = [e for e in sup if e["event"] == "elastic_shrink"]
    ev0 = read_events(os.path.join(md, "events-rank0.jsonl"))
    last = max(i for i, e in enumerate(ev0) if e["event"] == "train_start")
    resumed_its = [e["iteration"] for e in ev0[last:]
                   if e["event"] == "iteration"]
    expect_its = PL_DRILL_ITERATIONS - int(PL_DRILL_FAULT.split("@")[1])
    # the relaunch's figures per iteration it trained (its booster counts
    # the resumed ones too)
    ranks = [dp_rank_line({**st, "iterations": len(resumed_its)})
             for st in b.worker_stats]
    if (b.elastic_shrinks != 1 or b.final_num_machines != 1
            or b.attempts != 2 or len(ranks) != 1
            or ranks[0]["backend"] != ("nccl" if PL_DEVICE == "cuda"
                                       else "gloo")
            or ("cluster_attempt_failed", "lost") not in kinds
            or len(shrink) != 1 or shrink[0]["new_num_machines"] != 1
            or shrink[0]["lost_ranks"] != [1]
            or len(resumed_its) != expect_its):
        raise AssertionError(f"parallel_learners elastic: shrinks "
                             f"{b.elastic_shrinks}, world "
                             f"{b.final_num_machines}, attempts "
                             f"{b.attempts}, ranks {ranks}, supervisor "
                             f"{kinds}, resumed iterations {resumed_its}")
    check_kernels("parallel_learners elastic", ranks[0]["launches"],
                  ("K1", "K3"))
    out["parallel_learners_elastic"] = ranks[0]["launches"]
    emit({"phase": "parallel_learners", "run": "elastic_drill",
          "fault": PL_DRILL_FAULT, "world": [PL_RANKS, 1],
          "rows": int(X.shape[0]), "iterations": PL_DRILL_ITERATIONS,
          "trees_equal_serial": True, "cluster_s": drill_s,
          "attempts": b.attempts, "elastic_shrinks": b.elastic_shrinks,
          "resumed_iterations": resumed_its,
          "reshard": shrink[0].get("reshard"), "ranks": ranks,
          "card": card})
    emit({"phase": "parallel_learners_total", "cluster_s": cluster_s,
          "seconds": time.perf_counter() - t_phase, "card": card})
    return out


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    # a fatal signal (a crash after a device-side assert, say) dumps
    # every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)
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
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": card,
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
    dp_launches, dp_refs = phase_data_parallel(lgb, H, card, bench)
    launches.update(dp_launches)
    launches.update(phase_parallel_learners(lgb, H, card, bench, dp_refs))
    del dp_refs
    phase_serving(lgb, card, main, bench[0])
    launches["online"] = phase_online(lgb, H, card)
    launches["reliability"] = phase_reliability(lgb, H, card, main, bench)
    fi_launches, _ = phase_forced_interaction(lgb, H, global_timer, card,
                                              main, bench)
    launches.update(fi_launches)
    launches["linear"] = phase_linear(lgb, H, global_timer, card, main,
                                      bench[0])
    launches.update(phase_wide_bins(lgb, H, global_timer, card, main,
                                    bench[0]))
    launches.update(phase_huge_bins(lgb, H, card))
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
    # and on 32-bit codes (their uint32_t instantiations): INT32_F
    # features of INT32_B bins, in bin windows, K2 on both routes.  K1, K2
    # and K4 carry the huge_bins runs; no wave of those runs goes to K3
    # (wave_kernels_at), so its 32-bit row stands in its entry
    for e8, (kern, path) in zip(entries[:4], (
            ("K1", "huge_bins_wave"), ("K2", "huge_bins_quantized"),
            ("K3", None), ("K4", "huge_bins_leafwise"))):
        rows32 = [v for k, v in wide.items()
                  if k[0] == kern and k[1] == "int32"]
        r = wide[(kern, "int32")]
        if path is None:
            e8["int32_codes"] = {
                "F": INT32_F, "B": INT32_B, "C": C, "codes": "uint32",
                "num_slots": r["num_slots"], **{k: r[k] for k in row_keys},
                "launches": 0, "launches_path": None,
                "why": f"at {HUGE_MAX_BIN} bins the wave engine's dispatch "
                       "sends every wave to K1"}
            e8["max_abs_err"] = max(e8["max_abs_err"], r["max_abs_err"])
            continue
        entries.append({
            "name": f"{e8['name']} on 32-bit codes", "route": "cuda",
            "source": e8["source"], "replaces": e8["replaces"],
            "launches": launches.get(path, {}).get(kern, 0),
            "launches_path": path,
            "max_abs_err": max(v["max_abs_err"] for v in rows32),
            **{k: r[k] for k in row_keys if k != "max_abs_err"},
            "status": "ported",
            "shape": {"n": N_KERNEL, "F": INT32_F, "B": INT32_B, "C": C,
                      "codes": "uint32", **({"num_slots": r["num_slots"]}
                                            if kern != "K4" else
                                            {"S": N_KERNEL})},
            "routes": [{"num_slots": v.get("num_slots"),
                        "route": v.get("route"),
                        **{k: v[k] for k in row_keys}} for v in rows32]})
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
