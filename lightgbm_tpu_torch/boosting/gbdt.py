"""GBDT boosting loop (PyTorch port of `lightgbm_tpu/boosting/gbdt.py`,
ref: src/boosting/gbdt.cpp, gbdt.h:37).

Binned data, scores and gradients live on the booster's device (the card
unless `device_type=cpu`).  Each iteration computes the objective's
gradients (quantized when `use_quantized_grad`), grows one tree per class
on the wave or the leaf-wise engine, updates the scores, and pulls the
tree to the host as a `Tree` in one flat transfer (like CUDATree::ToHost,
ref: src/io/cuda/cuda_tree.cpp) for model text and prediction.
Prediction runs on the card by default (`device_predict=auto` on a
card booster): the ensemble is packed once and traversed as tensors
(`inference/`); the host paths are the native OpenMP predictor and the
Python loop over the host trees.

Row sampling (`GBDT::bagging`) follows the JAX booster: bagging and
balanced bagging draw a host mask from NumPy's `RandomState(bagging_seed)`
every `bagging_freq` iterations and put it on the device; GOSS keeps the
top rows by |g·h| and samples the rest with the threefry stream keyed by
the absolute iteration, rescaling them.  The mask (padding folded in) is
the growth engines' row mask.  `feature_fraction` draws a per-tree column
mask from `RandomState(feature_fraction_seed)`; extra-trees and
`feature_fraction_bynode` draw per leaf scan inside the engines, their
keys folded with the absolute iteration.  `continue_from` adopts an
earlier model's trees and seeds the scores with its predictions;
`rollback_one_iter` drops the last iteration's trees.

Checkpoints (reliability/checkpoint.py) carry the exact trainer state
beside the model text: `capture_train_state` takes the float32 score
buffer, the NumPy bagging and feature streams and the host bag mask,
under the JAX package's npz keys; `restore_train_state` puts them back
after `continue_from` adopted the checkpoint's trees, so a resumed run
grows the uninterrupted run's trees bit for bit.  The fault hooks of
`LGBM_TPU_FAULT` (crash, worker loss, hang at an iteration's start, NaN
gradients, a stalled collective before a tree's growth) sit behind one
`faults.active()` check.

Training metrics are evaluated on the booster's device, one packed
transfer per tick (`ops/metrics.py` DeviceEval).  Validation sets keep
float64 scores on the host, advanced per finished tree by the leaf ids of
a bin-space traversal of their bin codes, which are put on the device
once (`leaf_index_bin_space`); the host `Metric` classes evaluate them.

The split scan carries categorical features, monotone constraints (basic
on both engines; intermediate and advanced on the leaf-wise engine, which
these modes force, as in the JAX package), path smoothing and CEGB's
split, coupled and lazy penalties; a booster-level vector of the features
earlier trees used carries CEGB's coupled penalty from tree to tree, and
an [F, n] bitset of the rows each feature has been fetched for carries
the lazy one.

More than 256 bins: the device codes are 16-bit where a column has more
than 256 bins and int32 above 65,536 (ops/histogram.py `code_dtype`),
binned on the host as in the JAX package.

The objectives' gradients are [K, n_pad] (softmax over the classes for
multiclass); L1, quantile and MAPE renew each tree's leaf outputs on the
device from the scores before the tree's update (objective.py
`percentile_by_leaf`).  A custom objective (`fobj`) hands its gradients
to `train_one_iter`.  RF and DART (rf.py, dart.py) subclass this loop;
`_add_tree_score` adds a host tree's current outputs to the device
scores through a bin-space traversal.

EFB (`enable_bundle`, on by default): a scipy-sparse dataset arrives
with bundle codes and their plan (`io/sparse.py`); dense bins are
planned here and bundled on the host (`io/bundle.py`).  The engines then
read `[F', n]` bundle codes, and every bin-space traversal of them
(valid scores, DART's drops, `_add_tree_score`, `continue_from`)
decodes each node's feature from its bundle column.  Forced splits
(`forcedsplits_filename`) and interaction constraints are parsed here
into the engines' static tuples.

Linear trees (`linear_tree`): after a tree is grown, its leaves' ridge
models are fitted on the device (learner/linear.py) from the raw matrix,
put on the device once at `init`, and the scores advance by each row's
linear output; valid sets predict them on the host.  `refit` rewrites
the leaf values of the existing trees from new rows; `predict_contrib`
gives SHAP contributions on the host (native TreeSHAP).

Data-parallel training (`tree_learner=data` inside a torch.distributed
process group, parallel/data_parallel.py): every rank holds the whole
Dataset on the host (the same bin mappers and EFB plan as the serial
run) and its `rows_of` slice of the rows on its device, padded to its
own `_PAD` multiple.  Every row reduction is exact: the engines
all-reduce their int64 histograms and counts on the serial run's
fixed-point grid, the root and leaf sums are limb sums (`exact_sum`),
maxima are all-reduced, and every stream (the NumPy bagging mask, the
threefry uniforms of GOSS and stochastic rounding) is drawn over the
serial run's shape and sliced.  What reads more than sums of rows
gathers them: the ranking objectives all-gather every row's scores and
compute the queries that meet the rank's rows (ranking.py), the NDCG and
MAP train metrics evaluate the queries whose first row the rank holds
(ops/metrics.py ShardedEval), leaf renewal by percentile gathers the
leaf ids and scores, and the linear fit all-reduces its exact per-leaf
sums (learner/linear.py).  A sharded run grows the serial run's trees bit
for bit.  The feature-parallel learner (`tree_learner=feature`)
keeps every row on every rank and cuts the device columns into blocks
(`ColumnBlock`): each rank histograms and scans its block, and the
engines merge the ranks' best splits, so it too grows the serial trees
bit for bit.  The voting-parallel learner (`tree_learner=voting`) shards
the rows as data does, on the leaf-wise engine without a histogram
stack, and reduces only the histograms of the features its ranks elect
(parallel/voting.py).  Without a group, every learner trains on one
device.

Checkpoints of a process group hold the serial run's state: every rank
gathers the score buffer and the bag mask into the serial row order,
rank 0 writes them in a serial checkpoint's layout, and a restore slices
them by the resuming run's rows, so a checkpoint of any world size
resumes at any other, and serially.

The port covers in-memory dense and scipy-sparse data with the wave and
leaf-wise engines and quantized gradients.  Every parameter whose
behaviour it does not carry raises NotImplementedError naming the
ROADMAP item that brings it, so the port never quietly trains a
different model.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..inference import DevicePredictor
from ..io.binning import (BIN_CATEGORICAL, BIN_NUMERICAL, MISSING_NAN,
                          MISSING_ZERO)
from ..io.bundle import decode_bundle_column
from ..io.dataset import Dataset
from ..learner import (FeatureMeta, GrowParams, grow_tree_impl,
                       grow_tree_wave_impl)
from ..learner.linear import fit_linear, linear_outputs, raw_to_device
from ..metric import Metric
from ..models.tree import K_CATEGORICAL_MASK, Tree, _to_bitset
from ..native import PackedPredictor, SingleRowFastPredictor, predictor_lib
from ..objective import ObjectiveFunction
from ..parallel.data_parallel import (DATA_LEARNERS, ColumnBlock,
                                      RowShard, current_network, exact_sum)
from ..ops.histogram import (code_dtype, codes_to_device, codes_to_int,
                             wave_part_plan, wave_slot_pad)
from ..ops.split import SplitParams, cat_bitset_words, leaf_output
from ..observability import emit_event, global_registry
from ..observability.costmodel import global_cost_model, gradients_cost
from ..reliability import faults
from ..utils import log
from ..utils import random as jrandom
from ..utils.device import resolve_device
from ..utils.timer import global_timer

K_EPSILON = 1e-15
_PAD = 1024  # row padding multiple (a multiple of the kernels' row tile)


def check_slice(config: Config) -> None:
    """Refuse an unknown boosting type, growth strategy or tree
    learner."""
    c = config
    if c.boosting not in ("gbdt", "rf", "dart"):
        log.fatal(f"Unknown boosting type: {c.boosting}")
    if c.tpu_growth_strategy not in ("auto", "wave", "leafwise"):
        raise ValueError(f"Unknown tpu_growth_strategy "
                         f"{c.tpu_growth_strategy!r}; expected auto, wave, "
                         "or leafwise")
    if c.tree_learner not in ("serial",) + tuple(DATA_LEARNERS):
        log.fatal(f"Unknown tree_learner {c.tree_learner!r}")


def discretize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                         num_bins: int, const_hess: bool,
                         key: Optional[torch.Tensor] = None,
                         shard: Optional[RowShard] = None):
    """Quantize one class's gradients (ref: gradient_discretizer.cpp:120-160
    DiscretizeGradients; port of the JAX booster's `_disc`, gbdt.py:841).

    grad and hess are snapped to the grids gscale = max|grad| / (bins/2)
    and hscale = max|hess| / bins (max|hess| under a constant hessian,
    where every hessian becomes one step).  With a `key` (stochastic
    rounding) the noise is `uniform(split(key))`, the JAX stream bit for
    bit; without one it is 0.5.  Integers come from truncation toward
    zero, with the noise signed by the gradient's sign (round away from
    zero), as static_cast<int8_t> does in the reference.

    A data-parallel rank passes its `shard`: the maxima are the serial
    run's (all-reduced, over the rows the serial run's maxima see) and
    the noise is its slice of the serial run's stream.

    Returns (grad on the grid, hess on the grid, scales [2] float32).
    """
    qhalf = max(num_bins // 2, 1)
    ga, ha = grad.abs(), hess.abs()
    if shard is None:
        amax = torch.stack([ga.max(), ha.max()])
    else:
        amax = shard.max_(torch.stack([shard.serial_rows(ga).max(),
                                       shard.serial_rows(ha).max()]))

    def rg_of(k):
        if shard is None:
            return jrandom.uniform(k, grad.shape, device=grad.device)
        return shard.uniform(k, grad.device)

    gscale = torch.clamp(amax[0], min=1e-35) / qhalf
    hmax = torch.clamp(amax[1], min=1e-35)
    hscale = hmax if const_hess else hmax / num_bins
    if key is not None:
        kg, kh = jrandom.split(key)
        rg, rh = rg_of(kg), rg_of(kh)
    else:
        rg = rh = 0.5
    gi = torch.trunc(grad / gscale + torch.sign(grad) * rg)
    hi = (torch.ones_like(hess) if const_hess
          else torch.trunc(hess / hscale + rh))
    return gi * gscale, hi * hscale, torch.stack([gscale, hscale])


def goss_sample(grad: torch.Tensor, hess: torch.Tensor,
                pad_mask: torch.Tensor, key: torch.Tensor, top_k: int,
                other_k: int, shard: Optional[RowShard] = None):
    """Gradient one-side sampling (ref: goss.hpp:118-165; port of the JAX
    booster's `_goss_sample`, gbdt.py:53): keep the top_k rows by
    Σ_k |g·h|, keep each other row with probability other_k / rest and
    scale its gradients by rest / other_k.  Every step is float32, as in
    the JAX package, so the same float32 inputs give the same rows and
    the same bits.  grad, hess: [K, n]; returns (keep mask [n] float32,
    grad, hess).  A data-parallel rank passes its `shard`: the top-k
    threshold is taken over every rank's importances (all-gathered), the
    counts are all-reduced, and the uniforms are its slice of the serial
    run's stream."""
    imp = (grad * hess).abs().sum(0) * pad_mask
    real = pad_mask > 0
    if shard is None:
        thr = torch.topk(imp, top_k).values[-1]
    else:
        every = shard.net.all_gather_rows(imp[:shard.count], shard.sizes)
        thr = torch.topk(every, top_k).values[-1]
    is_top = (imp >= thr) & real
    counts = torch.stack([real.sum(dtype=torch.int64),
                          is_top.sum(dtype=torch.int64)])
    if shard is not None:
        shard.net.all_reduce_sum_(counts)
    rest = (counts[0] - counts[1]).to(torch.float32)
    prob = other_k / torch.clamp(rest, min=1.0)
    u = (jrandom.uniform(key, imp.shape, device=imp.device) if shard is None
         else shard.uniform(key, imp.device))
    sampled = (u < prob) & ~is_top & real
    scale = torch.where(sampled, rest / other_k,
                        torch.ones((), dtype=torch.float32,
                                   device=imp.device))
    keep = (is_top | sampled).to(grad.dtype)
    return keep, grad * scale[None, :], hess * scale[None, :]


def renew_leaf_values(leaf_value: torch.Tensor, leaf_id: torch.Tensor,
                      grad: torch.Tensor, hess: torch.Tensor,
                      mask: torch.Tensor, params: SplitParams, net=None):
    """Leaf outputs recomputed from the float gradients after quantized
    growth (ref: gradient_discretizer.cpp RenewIntGradTreeOutput; port of
    the JAX booster's `_renew`, gbdt.py:870).  Leaf sums are exact limb
    sums (`exact_sum`, all-reduced over a data-parallel `net`), so CPU,
    CUDA and any sharding agree.  Leaves with no hessian keep their
    value."""
    L = leaf_value.shape[0]
    ids = leaf_id.to(torch.int64).clamp(0, L - 1)

    def leaf_sum(v):
        return exact_sum(v * mask, ids, L, net).to(torch.float32)

    sg, sh = leaf_sum(grad), leaf_sum(hess)
    out = leaf_output(sg, sh, torch.zeros_like(sg), 0.0, params)
    return torch.where(sh > 0, out, leaf_value)


def tree_depth(tree: Tree) -> int:
    """Depth of the deepest leaf, from the child arrays (the number of
    steps a traversal from the root takes)."""
    ni = tree.num_leaves - 1
    depth, stack = 0, [(0, 0)] if ni > 0 else []
    while stack:
        node, d = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                stack.append((int(child), d + 1))
            else:
                depth = max(depth, d + 1)
    return depth


def leaf_index_bin_space(tree: Tree, binned: torch.Tensor,
                         missing_type: np.ndarray, num_bin: np.ndarray,
                         default_bin: np.ndarray,
                         plan=None) -> torch.Tensor:
    """Leaf index of every row of `binned` [F_used, n] (bin codes on the
    device) for a host tree trained on the same bin mappers: the
    bin-space traversal of the JAX package (boosting/gbdt.py:104
    leaf_index_bin_space; ref: dense_bin.hpp:346-366 SplitInner and
    tree.h:372 CategoricalDecision), `tree_depth` steps of elementwise
    torch with no host synchronization.  The feature metadata are the
    host arrays of the used features; each node's row of one table
    carries its feature's offset into `binned`, threshold, default
    direction, the bin code that means missing (-1 for none), its
    children, whether it is categorical, and, for a categorical node,
    its bins-left bitset (`cat_threshold_inner`, zero-padded to the
    widest node's words): a bin goes left when its bit is set.  With a
    BundlePlan `plan`, `binned` holds [F', n] EFB bundle codes: the
    offset is the feature's bundle column's, and the row also carries
    the feature's code offset, bin count and default bin, which decode
    its bin (a code outside its range means the default bin).  A step
    gathers one row per data row."""
    n = binned.shape[1]
    dev = binned.device
    nl = tree.num_leaves
    if nl <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    ni = nl - 1
    sf = tree.split_feature_inner[:ni].astype(np.int64)
    mt = missing_type[sf]
    miss = np.where(mt == MISSING_NAN, num_bin[sf] - 1,
                    np.where(mt == MISSING_ZERO, default_bin[sf], -1))
    is_cat = (tree.decision_type[:ni] & K_CATEGORICAL_MASK) > 0
    col = sf if plan is None else plan.group_idx[sf].astype(np.int64)
    cols = [col * n, tree.threshold_in_bin[:ni],
            (tree.decision_type[:ni] & 2) > 0, miss, tree.left_child[:ni],
            tree.right_child[:ni], is_cat]
    if plan is not None:
        cols += [plan.offsets[sf], num_bin[sf], plan.zero_bin[sf]]
    nbase = len(cols)
    W = 0
    if is_cat.any():
        cb = np.asarray(tree.cat_boundaries_inner, np.int64)
        ct = np.asarray(tree.cat_threshold_inner, np.int64)
        W = int(np.diff(cb).max())
        words = np.zeros((ni, W), np.int64)
        for nd in np.nonzero(is_cat)[0]:
            ci = int(tree.threshold_in_bin[nd])
            seg = ct[cb[ci]:cb[ci + 1]]
            words[nd, :len(seg)] = seg
        cols += list(words.T)
    table = torch.from_numpy(np.stack(cols, 1).astype(np.int64)).to(dev)
    rows = torch.arange(n, device=dev)
    flat = binned.reshape(-1)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for _ in range(tree_depth(tree)):
        t = table[node.clamp(min=0)]
        b = codes_to_int(flat[t[:, 0] + rows])
        if plan is not None:
            local = b - t[:, 7]
            inside = (local >= 0) & (local < t[:, 8])
            b = torch.where((t[:, 7] == 0) | inside, local, t[:, 9])
        go_left = torch.where(b == t[:, 3], t[:, 2] > 0, b <= t[:, 1])
        if W:
            wi = b // 32
            word = torch.gather(t[:, nbase:], 1,
                                wi.clamp(max=W - 1)[:, None])
            cat_left = (wi < W) & (((word[:, 0] >> (b % 32)) & 1) > 0)
            go_left = torch.where(t[:, 6] > 0, cat_left, go_left)
        node = torch.where(node >= 0,
                           torch.where(go_left, t[:, 4], t[:, 5]), node)
    return (~node).to(torch.int32)


def wave_fits(num_features: int, max_bin: int, num_leaves: int) -> bool:
    """The wave kernels' shared-memory tiles hold one slot's histograms of
    one feature and the partition holds the slot counters (the analogue
    of the JAX package's VMEM gate `wave_pallas_vmem_ok`).  K1's 8-byte
    cells are the widest, so its plan decides for K2 too."""
    if num_features < 1:
        return False
    try:
        wave_part_plan(1, num_features, max_bin, 2, wave_slot_pad(num_leaves))
    except ValueError:
        return False
    return True


class PendingHostCopy:
    """A device tensor's copy into pinned host memory, in flight: made on
    the training thread (a `clone()` snapshot on the current stream, a
    `non_blocking` copy into a pinned tensor, a recorded CUDA event),
    read as an array on the checkpoint writer's thread, which waits on
    the event first (`np.asarray` calls `__array__`).  A non_blocking
    copy into pageable memory would be silently synchronous; into pinned
    memory the host must not read it before the event."""

    def __init__(self, t: torch.Tensor):
        self._snap = t.clone()
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(self._snap, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def __array__(self, dtype=None, copy=None):
        self._event.synchronize()
        self._snap = None
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype, copy=False)


class GBDT:
    """ref: src/boosting/gbdt.cpp GBDT."""

    def __init__(self):
        self.models_: List[Tree] = []
        self.iter_ = 0
        # iterations of an init model (continue_from); with iter_ it keys
        # the threefry streams (quantization, GOSS, extra-trees, bynode)
        self.num_init_iteration_ = 0
        self.config: Optional[Config] = None
        self.train_data: Optional[Dataset] = None
        self.objective: Optional[ObjectiveFunction] = None
        self.num_tree_per_iteration = 1
        self.average_output_ = False
        # the torch device of training and prediction: set by init, or by
        # Booster for a loaded model
        self.device: Optional[torch.device] = None
        # prediction caches (native pack, DevicePredictor), keyed by the
        # model slice, len(models_) and the in-place mutation count
        self._model_mutations = 0
        self._packed_pred = None
        self._device_pred = None
        self.train_metrics: List[Metric] = []
        self.valid_sets: List[Dataset] = []
        self.valid_metrics: List[List[Metric]] = []
        # float64 [K, n] host scores of each valid set, and its bin codes
        # on the booster's device
        self.valid_scores: List[np.ndarray] = []
        self.valid_bins: List[torch.Tensor] = []
        self._device_eval = None    # ops.metrics.DeviceEval, built lazily
        self._grad_ok = None        # device flag: every gradient finite
        self._finite_cache = None   # (grads_finite, scores_finite) of iter
        # linear trees: the raw matrix on the device, the fits' stats and
        # each valid set's raw matrix on the host
        self.raw_dev: Optional[torch.Tensor] = None
        self.linear_fit_stats = []
        self._valid_raw = {}
        # parallel learners: the group's Network and this rank's rows
        # (data, voting), the vote (voting), or this rank's column block
        # (feature); None when training serially
        self.net = None
        self.shard: Optional[RowShard] = None
        self.voting = None
        self.block: Optional[ColumnBlock] = None

    # ------------------------------------------------------------------ init
    def init(self, config: Config, train_data: Dataset,
             objective: Optional[ObjectiveFunction],
             metrics: Sequence[Metric] = ()) -> None:
        check_slice(config)
        self.device = resolve_device(config.device_type)
        dev = self.device
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.train_metrics = list(metrics)
        self.shrinkage_rate = config.learning_rate
        self.num_tree_per_iteration = (objective.num_model_per_iteration()
                                       if objective is not None
                                       else config.num_class)
        self.num_data = n = train_data.num_data
        self.n_pad = (n + _PAD - 1) // _PAD * _PAD
        self._init_shard(config, objective, n)
        if self.shard is not None:
            self.n_pad = self.shard.n_pad

        binned = train_data.binned
        on_device = isinstance(binned, torch.Tensor)
        # EFB (ref: feature_group.h; io/bundle.py): exclusive features
        # share a device column.  A sparse-ingested dataset holds bundle
        # codes already (io/sparse.py); dense bins are planned here, a
        # device-binned dataset from the host bins of its construction
        # sample, and bundled on the host.  The dataset keeps its own
        # bins (the host paths read per-feature bins), so only a dataset
        # whose bins are the device matrix's takes the padded copy over.
        self.bundle_plan = train_data.pre_bundled_plan
        own_bins = True
        if self._vote and self.bundle_plan is not None:
            # the vote is per feature: bundle codes from sparse ingestion
            # cannot vote (gbdt.py:317-324 of the JAX package)
            log.warning("tree_learner=voting needs per-feature bins; "
                        "sparse pre-bundled datasets fall back to "
                        "data-parallel histogram reduction")
            self._vote = False
        # EFB is not planned when the vote engages (the vote is per
        # feature, gbdt.py:273-290 of the JAX package)
        if (self.bundle_plan is None and config.enable_bundle
                and train_data.num_features > 1 and not self._vote):
            from ..io.bundle import build_bundled, plan_bundles
            plan_src = train_data.efb_sample_bins() if on_device else binned
            if plan_src is None:
                plan_src = train_data.binned_host()
            plan = plan_bundles(plan_src, train_data.bin_mappers,
                                train_data.used_features,
                                max_conflict_rate=config.max_conflict_rate)
            if plan.effective:
                self.bundle_plan = plan
                binned = build_bundled(train_data.binned_host(), plan)
                on_device = own_bins = False
                log.info(f"EFB bundled {len(plan.group_idx)} features into "
                         f"{plan.num_groups} columns")
        sh = self.shard
        if sh is not None:
            # this rank's rows of the whole dataset's (bundle) codes; the
            # dataset keeps every row (valid-set and host paths read it)
            binned = binned[:, sh.start:sh.stop]
            own_bins = False
        n_here = n if sh is None else sh.count
        # device codes: uint8 while every column has at most 256 bins,
        # 16-bit codes (int16 storage) up to 65,536, int32 above
        # (ops/histogram.py code_dtype)
        col_bins = (train_data.max_num_bin if self.bundle_plan is None
                    else int(self.bundle_plan.group_num_bin.max(initial=1)))
        codes = code_dtype(col_bins)
        if on_device:
            # device bins (io/device_bin.py, or an earlier booster's
            # padded copy) are padded on the device: no host round trip
            self.binned_dev = torch.zeros((binned.shape[0], self.n_pad),
                                          dtype=binned.dtype, device=dev)
            self.binned_dev[:, :n_here] = binned[:, :n_here].to(dev)
        else:
            host = np.zeros((binned.shape[0], self.n_pad),
                            {torch.uint8: np.uint8, torch.int16: np.uint16,
                             torch.int32: np.int32}[codes])
            host[:, :n_here] = binned
            self.binned_dev = codes_to_device(host, dev, col_bins)
        if own_bins:
            # the dataset's device-bins slot now holds the padded copy
            train_data.binned = self.binned_dev
        pad = np.zeros(self.n_pad, np.float32)
        pad[:n_here] = 1.0
        self.pad_mask = torch.from_numpy(pad).to(dev)
        # row and column sampling streams (the JAX booster's, gbdt.py:898):
        # the bag mask holds the padding's zeros and starts as all rows
        self._rng_bag = np.random.RandomState(config.bagging_seed)
        self._rng_feat = np.random.RandomState(config.feature_fraction_seed)
        self._bag_mask_host = pad
        self.bag_mask = self.pad_mask

        mt, nb, db, cat = [], [], [], []
        for f in train_data.used_features:
            m = train_data.bin_mappers[f]
            mt.append(m.missing_type)
            nb.append(m.num_bin)
            db.append(m.default_bin)
            cat.append(m.bin_type == BIN_CATEGORICAL)
        self.f_missing_type = np.array(mt, np.int32)
        self.f_num_bin = np.array(nb, np.int32)
        self.f_default_bin = np.array(db, np.int32)
        self.f_is_cat = np.array(cat, bool)
        penalty = np.ones(len(nb), np.float32)
        if config.feature_contri:
            for i, f in enumerate(train_data.used_features):
                if f < len(config.feature_contri):
                    penalty[i] = config.feature_contri[f]
        # monotone constraints and coupled CEGB penalties are indexed by
        # real feature; the scan takes them per used feature
        mono = np.zeros(len(nb), np.int32)
        mc_list = list(config.monotone_constraints or [])
        for i, f in enumerate(train_data.used_features):
            if f < len(mc_list):
                mono[i] = int(mc_list[f])
        has_mono = bool(np.any(mono != 0))
        if has_mono and config.monotone_constraints_method not in (
                "basic", "intermediate", "advanced"):
            log.fatal("Unknown monotone_constraints_method "
                      f"{config.monotone_constraints_method!r}")
        # intermediate/advanced modes (gbdt.py:387-396 of the JAX package)
        mono_inter = mono_adv = False
        if has_mono and config.monotone_constraints_method != "basic":
            if config.extra_trees or config.feature_fraction_bynode < 1.0:
                log.warning("monotone_constraints_method="
                            f"{config.monotone_constraints_method} "
                            "falls back to basic with extra_trees / "
                            "feature_fraction_bynode (the full-tree "
                            "pending rescan has no per-leaf random state)")
            else:
                mono_inter = True
                mono_adv = config.monotone_constraints_method == "advanced"
        has_lazy = bool(config.cegb_penalty_feature_lazy)
        lazy = np.zeros(len(nb), np.float32)
        if has_lazy:
            lz = list(config.cegb_penalty_feature_lazy)
            if len(lz) != train_data.num_total_features:
                log.fatal("cegb_penalty_feature_lazy should be the same "
                          "size as feature number.")
            for i, f in enumerate(train_data.used_features):
                lazy[i] = lz[f]
        coupled = np.zeros(len(nb), np.float32)
        if config.cegb_penalty_feature_coupled:
            cp = list(config.cegb_penalty_feature_coupled)
            if len(cp) != train_data.num_total_features:
                log.fatal("cegb_penalty_feature_coupled should be the same "
                          "size as feature number.")
            for i, f in enumerate(train_data.used_features):
                coupled[i] = cp[f]
        # ref: cost_effective_gradient_boosting.hpp IsEnable
        has_cegb = (config.cegb_tradeoff < 1.0
                    or config.cegb_penalty_split > 0.0
                    or bool(config.cegb_penalty_feature_coupled)
                    or has_lazy)
        # the features any tree has split on, carried from tree to tree
        self.cegb_used = (torch.zeros(len(nb), dtype=torch.bool, device=dev)
                          if has_cegb else None)
        if has_lazy and mono_inter:
            log.warning("monotone intermediate mode falls back to basic "
                        "with cegb_penalty_feature_lazy")
            mono_inter = False
        if has_lazy and self._vote:
            log.fatal("cegb_penalty_feature_lazy is not supported with "
                      "tree_learner=voting")
        # the rows each feature has been fetched for, carried from tree to
        # tree (ref: cost_effective_gradient_boosting.hpp:63
        # feature_used_in_data_)
        self.lazy_used = (torch.zeros((len(nb), self.n_pad), dtype=torch.bool,
                                      device=dev) if has_lazy else None)
        bp = self.bundle_plan

        def on_dev(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(dev)
        self.meta = FeatureMeta(
            num_bin=on_dev(self.f_num_bin),
            missing_type=on_dev(self.f_missing_type),
            default_bin=on_dev(self.f_default_bin),
            penalty=on_dev(penalty), is_cat=on_dev(self.f_is_cat),
            monotone=on_dev(mono), cegb_coupled=on_dev(coupled),
            cegb_lazy=on_dev(lazy),
            group=on_dev(None if bp is None else bp.group_idx),
            offset=on_dev(None if bp is None else bp.offsets),
            zero_bin=on_dev(None if bp is None else bp.zero_bin),
            in_bundle=on_dev(None if bp is None else bp.in_bundle))
        max_b = int(self.f_num_bin.max()) if len(nb) else 1
        # the kernels' histogram width: the widest bundle column under EFB
        hist_b = max_b if bp is None else int(bp.group_num_bin.max())
        # histogram stack memory guard (HistogramPool analogue): the
        # leaf-wise engine's int64 stack against histogram_pool_size MB
        stack_bytes = config.num_leaves * len(nb) * max_b * 2 * 8
        budget = (config.histogram_pool_size * 1024 * 1024
                  if config.histogram_pool_size > 0 else 512 * 1024 * 1024)
        # quantized histograms (K2) hold exact int32 sums: the grid must
        # fit int8 and n * bins must fit int32; outside the gate the wave
        # engine takes K1 on the dequantized values, as in the JAX package
        # (n is the serial run's padded rows, so every rank gates alike)
        n_gate = self.n_pad if self.shard is None else self.shard.grid_rows
        quant_bins = (config.num_grad_quant_bins
                      if (config.use_quantized_grad
                          and config.num_grad_quant_bins <= 126
                          and n_gate * config.num_grad_quant_bins
                          < 2 ** 31) else 0)
        self.grow_params = GrowParams(
            num_leaves=config.num_leaves, max_depth=config.max_depth,
            max_bin=max_b,
            split=SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                min_data_in_leaf=config.min_data_in_leaf,
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                min_gain_to_split=config.min_gain_to_split,
                max_delta_step=config.max_delta_step,
                path_smooth=config.path_smooth,
                has_categorical=bool(self.f_is_cat.any()),
                cat_features=tuple(np.nonzero(self.f_is_cat)[0].tolist()),
                max_cat_to_onehot=config.max_cat_to_onehot,
                max_cat_threshold=config.max_cat_threshold,
                cat_l2=config.cat_l2, cat_smooth=config.cat_smooth,
                min_data_per_group=config.min_data_per_group,
                has_monotone=has_mono,
                monotone_penalty=config.monotone_penalty,
                extra_trees=config.extra_trees,
                extra_seed=config.extra_seed,
                has_cegb=has_cegb,
                cegb_tradeoff=config.cegb_tradeoff,
                cegb_penalty_split=config.cegb_penalty_split,
                has_cegb_lazy=has_lazy),
            monotone_intermediate=mono_inter,
            monotone_advanced=mono_adv,
            wave_tail_halving=config.wave_tail_halving,
            wave_prune=config.wave_prune,
            wave_prune_overshoot=config.wave_prune_overshoot,
            wave_spike_reserve=config.wave_spike_reserve,
            wave_spike_k=config.wave_spike_k,
            use_hist_stack=stack_bytes <= budget,
            quant_bins=quant_bins,
            feature_fraction_bynode=config.feature_fraction_bynode,
            bynode_seed=config.feature_fraction_seed + 1,
            has_bundles=bp is not None,
            group_max_bin=0 if bp is None else hist_b,
            forced_splits=self._parse_forced_splits(config, train_data),
            interaction_sets=self._parse_interaction_sets(config,
                                                          train_data))
        if (self.grow_params.forced_splits
                and not self.grow_params.use_hist_stack):
            log.fatal("forced splits need the per-leaf histogram stack; "
                      "raise histogram_pool_size")
        if (self.grow_params.monotone_intermediate
                and not self.grow_params.use_hist_stack):
            log.warning("monotone intermediate mode needs the per-leaf "
                        "histogram stack (histogram_pool_size); falling "
                        "back to basic")
            self.grow_params = self.grow_params._replace(
                monotone_intermediate=False)
        if self._vote:
            # PV-Tree vote (gbdt.py:524-542 of the JAX package): children
            # are rebuilt per scan (a parent and its children elect other
            # features, so subtraction is invalid)
            from ..parallel.voting import VotingSpec
            if config.forcedsplits_filename:
                log.fatal("tree_learner=voting does not support forced "
                          "splits")
            if config.top_k <= 0:
                log.fatal("top_k should be greater than 0 (ref: "
                          "config.cpp CHECK_GT(top_k, 0))")
            if self.grow_params.monotone_intermediate:
                log.warning("monotone intermediate mode falls back to "
                            "basic under tree_learner=voting (no "
                            "histogram stack to rescan)")
            self.grow_params = self.grow_params._replace(
                use_hist_stack=False, monotone_intermediate=False,
                monotone_advanced=False)
            self.voting = VotingSpec(self.net, min(config.top_k, len(nb)),
                                     self.net.world)
        # growth engine (gbdt.py:582-636 of the JAX package): wave when at
        # least 8 leaves and the wave kernels' tile fits, else leaf-wise;
        # intermediate/advanced monotone and lazy CEGB recompute state
        # after every split and keep the leaf-wise engine
        strategy = config.tpu_growth_strategy
        if (self.grow_params.monotone_intermediate
                or self.grow_params.split.has_cegb_lazy
                or self.voting is not None):
            if strategy == "wave":
                log.warning("voting / intermediate monotone / lazy CEGB "
                            "use the leaf-wise engine")
            strategy = "leafwise"
        if strategy == "auto":
            strategy = ("wave" if config.num_leaves >= 8
                        and wave_fits(self.binned_dev.shape[0], hist_b,
                                      config.num_leaves)
                        else "leafwise")
        self.growth_strategy = strategy
        if self._feature_net is not None:
            # feature-parallel: this rank's block of the device columns
            # (rows_of-balanced; may be empty when the world outnumbers
            # them)
            self.block = ColumnBlock(self._feature_net, self.meta,
                                     self.binned_dev.shape[0])
            log.info(f"tree_learner=feature: rank {self.block.net.rank}/"
                     f"{self.block.net.world} histograms columns "
                     f"[{self.block.start}, {self.block.stop}) of "
                     f"{self.binned_dev.shape[0]} ("
                     f"{len(self.block.features)} features) on "
                     f"{self.device} over {self.block.net.backend}")
        # only the leaf-wise engine's K4 reads a row-major copy (of a
        # feature-parallel rank's block)
        self.binned_rm_dev = None
        if strategy == "leafwise":
            b = self.block
            self.binned_rm_dev = (self.binned_dev if b is None else
                                  self.binned_dev[b.start:b.stop]
                                  ).t().contiguous()
        self.col_mask = torch.ones(len(nb), dtype=torch.bool, device=dev)

        # linear leaves (learner/linear.py): the raw matrix on the device
        # once, beside a zero column that pads the feature tables
        if config.linear_tree:
            if objective is not None and objective.need_renew_tree_output:
                # ref: config.cpp "Cannot use regression_l1 objective for
                # linear tree" (renewal would overwrite the leaf models)
                log.fatal(f"Cannot use objective {config.objective!r} "
                          "with linear_tree")
            if train_data.raw_data is None:
                # the bins' representative values are no substitute: the
                # last bin of a feature reconstructs to +inf
                log.fatal("linear_tree needs the training rows' raw values: "
                          "construct the Dataset with linear_tree=true (a "
                          "binary or two-round Dataset holds none)")
            # a row-sharded rank holds its own rows (the dtype is the
            # one every row allows, so every rank takes the serial one)
            self.raw_dev = raw_to_device(
                train_data.raw_data, dev,
                None if self.shard is None else (self.shard.start,
                                                 self.shard.stop))
            log.info(f"Linear trees: raw matrix of {self.raw_dev.nbytes} "
                     f"bytes ({self.raw_dev.dtype}) on {dev}")

        self.use_quant = config.use_quantized_grad
        if self.use_quant:
            self._quant_const_hess = bool(
                objective is not None
                and getattr(objective, "is_constant_hessian", False)
                and train_data.metadata.weight is None)
            self._quant_key = jrandom.PRNGKey(config.seed + 5, device=dev)
            self._renew_params = SplitParams(
                lambda_l1=config.lambda_l1, lambda_l2=config.lambda_l2,
                max_delta_step=config.max_delta_step)

        K = self.num_tree_per_iteration
        self.scores = torch.zeros((K, self.n_pad), dtype=torch.float32,
                                  device=dev)
        md = train_data.metadata
        self.has_init_score = md.init_score is not None
        if self.has_init_score:
            init = np.asarray(md.init_score, np.float64).reshape(K, n)
            self.scores = torch.from_numpy(
                self._local_rows(init.astype(np.float32))).to(dev)
        self.class_need_train = [True] * K
        if objective is not None:
            # the objective sees every row on the host (its init scores
            # are the serial run's); the device gets this rank's rows
            objective.init(md, n)
            self.label_dev = torch.from_numpy(self._local_rows(
                np.asarray(objective.label, np.float32))).to(dev)
            self.weight_dev = None
            if md.weight is not None:
                self.weight_dev = torch.from_numpy(self._local_rows(
                    np.asarray(md.weight, np.float32))).to(dev)
            if getattr(objective, "need_train", True) is False:
                self.class_need_train = [False] * K
        for m in self.train_metrics:
            m.init(md, n)

    def _init_shard(self, config: Config, objective, n: int) -> None:
        """Parallel learner selection (the JAX booster's
        `_make_training_mesh`, gbdt.py:179-220; ref: tree_learner.cpp:15
        CreateTreeLearner).  Inside a process group, data and voting
        shard the rows (this rank takes its rows; the vote engages at a
        world above 1) and feature shards the device columns (every rank
        keeps every row; the block is cut in `init` once the columns are
        known).  Unlike the JAX package, which shrinks its feature mesh
        to a divisor of the column count, every rank takes part: blocks
        may be unequal, and a rank may hold none.  Without a group every
        learner trains on one device."""
        tl = config.tree_learner
        self._vote = False
        self._feature_net = None
        if tl not in DATA_LEARNERS:
            return
        net = current_network()
        if net is None:
            log.info(f"tree_learner={tl} without a process group: training "
                     "on one device (train_distributed or join_cluster "
                     "spreads it over GPUs)")
            return
        if net.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL process group needs device_type=cuda")
        if DATA_LEARNERS[tl] == "columns":
            self._feature_net = net
            return
        self.net = net
        self.shard = RowShard(net, n, _PAD)
        self._vote = tl == "voting" and net.world > 1
        log.info(f"tree_learner={tl}: rank {net.rank}/{net.world} trains "
                 f"rows [{self.shard.start}, {self.shard.stop}) of {n} on "
                 f"{self.device} over {net.backend}")

    def _local_rows(self, a: np.ndarray) -> np.ndarray:
        """A host array over every training row (last axis) -> this
        rank's rows, zero-padded to n_pad."""
        if self.shard is not None:
            return self.shard.local(a)
        out = np.zeros(a.shape[:-1] + (self.n_pad,), a.dtype)
        out[..., :a.shape[-1]] = a
        return out

    @staticmethod
    def _parse_forced_splits(config: Config, train_data: Dataset) -> tuple:
        """forcedsplits_filename's JSON tree -> BFS (leaf, inner feature,
        threshold bin) tuples in this package's split numbering: the left
        child keeps its leaf, the right one takes the next new leaf
        (ref: serial_tree_learner.cpp:614 ForceSplits; gbdt.py:543-578 of
        the JAX package)."""
        if not config.forcedsplits_filename:
            return ()
        import json
        from collections import deque
        with open(config.forcedsplits_filename) as f:
            root = json.load(f)
        inner_of = {f: i for i, f in enumerate(train_data.used_features)}
        forced = []
        queue = deque([(root, 0)])
        while queue and len(forced) < config.num_leaves - 1:
            node, leaf = queue.popleft()
            if not node or "feature" not in node:
                continue
            real_f = int(node["feature"])
            if real_f not in inner_of:
                log.warning(f"forced split feature {real_f} unused; "
                            "skipping subtree")
                continue
            mapper = train_data.bin_mappers[real_f]
            new_leaf = len(forced) + 1
            forced.append((leaf, inner_of[real_f],
                           int(mapper.value_to_bin(float(node["threshold"])))))
            if node.get("left"):
                queue.append((node["left"], leaf))
            if node.get("right"):
                queue.append((node["right"], new_leaf))
        return tuple(forced)

    @staticmethod
    def _parse_interaction_sets(config: Config, train_data: Dataset) -> tuple:
        """interaction_constraints, as the string "[0,1],[2,3]" or a list
        of lists, -> sorted tuples of inner feature indices (ref:
        config.h:585; gbdt.py:586-603 of the JAX package); unused
        features drop out, as do sets left empty."""
        if not config.interaction_constraints:
            return ()
        import re
        inner_of = {f: i for i, f in enumerate(train_data.used_features)}
        sets = []
        for grp in re.findall(r"\[([^\[\]]*)\]",
                              str(config.interaction_constraints)):
            idxs = tuple(sorted(inner_of[int(tok)] for tok in grp.split(",")
                                if tok.strip() != ""
                                and int(tok) in inner_of))
            if idxs:
                sets.append(idxs)
        return tuple(sets)

    # ------------------------------------------------------- checkpoint state
    def capture_train_state(self, async_copy: bool = False):
        """Exact trainer state for CheckpointManager (the JAX booster's
        keys, gbdt.py:985): the float32 [K, n_pad] score buffer, the row
        count, the bagging and feature RandomState streams and the host
        bag mask.  Model text alone is not enough for a byte-identical
        resume: scores re-seeded from predictions differ from the
        accumulated buffer in ulps, which changes later trees.

        With `async_copy` (the async checkpoint writer) on a CUDA booster
        the scores are snapshotted with `clone()` on the current stream
        and copied `non_blocking` into a pinned host tensor behind a
        recorded CUDA event; the returned `scores` is a `PendingHostCopy`
        that the writer thread turns into an array (waiting on the
        event) when it serializes, so the training thread never waits
        for the copy.

        A rank of a learner that shards the rows gathers the scores and
        the bag mask of every rank into the serial row order and
        [K, grid_rows] layout (every rank must call it: it is a
        collective), the padding columns holding the serial run's
        padding scores; the state is then the serial run's."""
        sc = self.scores
        bag = np.array(self._bag_mask_host)
        if self.shard is not None:
            scores, bag = self._gather_serial_state()
        elif async_copy and sc.is_cuda:
            scores = PendingHostCopy(sc)
        else:
            # a copy even on the CPU, where .cpu() would alias the live
            # buffer that the next update changes in place
            scores = sc.to("cpu", copy=True).numpy()
        return {"scores": scores,
                "num_data": np.int64(self.num_data),
                "rng_bag": np.array(self._rng_bag.get_state(legacy=False),
                                    dtype=object),
                "rng_feat": np.array(self._rng_feat.get_state(legacy=False),
                                     dtype=object),
                "bag_mask": bag}

    def _gather_serial_state(self):
        """(scores [K, grid_rows] float32, bag mask [grid_rows] float32) in
        the serial run's row order, gathered from every rank.  All
        padding rows hold one score (every code 0, the same init), and
        a rank that pads holds it: the serial run pads only when some
        rank does."""
        sh, net = self.shard, self.net
        K, n = self.num_tree_per_iteration, self.num_data
        scores = np.zeros((K, sh.grid_rows), np.float32)
        scores[:, :n] = net.all_gather_rows(
            self.scores[:, :sh.count], sh.sizes).cpu().numpy()
        if sh.grid_rows > n:
            pad = torch.full((K,), float("-inf"), device=self.device)
            if self.n_pad > sh.count:
                pad = self.scores[:, sh.count].clone()
            scores[:, n:] = net.all_reduce_max_(pad).cpu().numpy()[:, None]
        bag = np.zeros(sh.grid_rows, np.float32)
        local = torch.from_numpy(np.ascontiguousarray(
            self._bag_mask_host[:sh.count])).to(self.device)
        bag[:n] = net.all_gather_rows(local, sh.sizes).cpu().numpy()
        return scores, bag

    def group_network(self):
        """The Network of this booster's process group (any parallel
        learner), or None when it trains serially."""
        return self.net if self.block is None else self.block.net

    def restore_train_state(self, state) -> bool:
        """Restore a capture_train_state() payload, of either package,
        after continue_from adopted the checkpoint's trees (it goes
        through continue_from, which keyed the threefry streams by the
        adopted iterations).  The scores land in the padded [K, n_pad]
        buffer (the padding too when the buffer has this run's width),
        the bag mask on the host and on the device.  Returns True when
        the exact score buffer was restored."""
        if state is None:
            return False
        ok = False
        sc = state.get("scores")
        if sc is not None:
            sc = np.asarray(sc, np.float32)
            sc = sc.reshape(self.num_tree_per_iteration, -1)
            n = int(state.get("num_data", sc.shape[-1]))
            if n != self.num_data:
                log.warning(f"Checkpoint state has {n} rows but the train "
                            f"set has {self.num_data}; keeping "
                            "predict-seeded scores")
            else:
                if self.shard is None and sc.shape[1] == self.n_pad:
                    buf = np.ascontiguousarray(sc)
                else:
                    # this run's rows (a shard's slice of the serial
                    # order), the padding at the serial padding's score
                    # where the state has one
                    buf = self._local_rows(sc[:, :n])
                    if sc.shape[1] > n:
                        real = n if self.shard is None else self.shard.count
                        buf[:, real:] = sc[:, n:n + 1]
                self.scores = torch.from_numpy(buf).to(self.device)
                ok = True
        for key, rng in (("rng_bag", self._rng_bag),
                         ("rng_feat", self._rng_feat)):
            st = state.get(key)
            if st is not None:
                try:
                    rng.set_state(st.item() if hasattr(st, "item") else st)
                except (ValueError, TypeError) as e:
                    log.warning(f"Could not restore {key} RNG state: {e}")
        bm = state.get("bag_mask")
        if bm is not None and len(bm) >= self.num_data:
            mask = self._local_rows(
                np.asarray(bm, np.float32)[:self.num_data])
            self._bag_mask_host = mask
            self.bag_mask = torch.from_numpy(mask).to(self.device)
        return ok

    def add_valid_data(self, valid_data: Dataset,
                       metrics: Sequence[Metric]) -> None:
        """A validation set (ref: gbdt.cpp AddValidDataset): float64 host
        scores from its init_score, its bin codes on the device once."""
        self.valid_sets.append(valid_data)
        ms = list(metrics)
        for m in ms:
            m.init(valid_data.metadata, valid_data.num_data)
        self.valid_metrics.append(ms)
        K = self.num_tree_per_iteration
        sc = np.zeros((K, valid_data.num_data), np.float64)
        md = valid_data.metadata
        if md.init_score is not None:
            init = np.asarray(md.init_score, np.float64)
            sc += (np.tile(init, (K, 1)) if init.ndim == 1 and K > 1
                   else init.reshape(K, -1))
        self.valid_scores.append(sc)
        binned = valid_data.binned
        if isinstance(binned, torch.Tensor):
            vb = binned[:, :valid_data.num_data].to(self.device)
        else:
            vb = codes_to_device(binned, self.device)
        self.valid_bins.append(vb.contiguous())

    # ---------------------------------------------------- continued training
    def _reconstruct_raw(self, ds: Dataset, bins: torch.Tensor,
                         plan=None) -> np.ndarray:
        """Raw feature matrix of `ds` for prediction: its kept raw data, else
        each bin's representative value (gbdt.py:905 `_raw_or_reconstruct`
        of the JAX package): exact for trees trained on the same bin
        mappers, whose numerical thresholds are bin upper bounds.  `bins`
        are the set's [F_used, num_data] codes on the device, or its
        [F', num_data] bundle codes under the BundlePlan `plan`."""
        if ds.raw_data is not None:
            return ds.raw_data
        codes = codes_to_int(bins[:, :ds.num_data], torch.int32).cpu().numpy()
        X = np.zeros((ds.num_data, ds.num_total_features))
        for i, f in enumerate(ds.used_features):
            m = ds.bin_mappers[f]
            fb = codes[i] if plan is None else decode_bundle_column(
                codes[plan.group_idx[i]], plan, i, m.num_bin)
            lut = np.array([m.bin_to_value(b) for b in range(m.num_bin)])
            # missing bins reconstruct to what default_left routes
            if m.missing_type == MISSING_NAN:
                lut[m.num_bin - 1] = np.nan
            elif m.missing_type == MISSING_ZERO:
                lut[m.default_bin] = 0.0
            X[:, f] = lut[np.clip(fb, 0, m.num_bin - 1)]
        return X

    def _reconstruct_bin_space(self, tree: Tree) -> None:
        """Bin-space routing fields (split_feature_inner, threshold_in_bin)
        of a tree read from model text, against this run's bin mappers
        (gbdt.py:1583 of the JAX package): the real threshold is the
        upper bound of its bin, so a search recovers the bin."""
        if getattr(tree, "_bin_space_valid", True):
            return
        tree._bin_space_valid = True
        ni = tree.num_leaves - 1
        if ni <= 0:
            return
        ds = self.train_data
        inner_of = {f: i for i, f in enumerate(ds.used_features)}
        cat_mask = (tree.decision_type[:ni] & K_CATEGORICAL_MASK) > 0
        per_ci_bins = {}
        for nd in range(ni):
            f = int(tree.split_feature[nd])
            if f in inner_of:
                tree.split_feature_inner[nd] = inner_of[f]
            mapper = ds.bin_mappers[f]
            if cat_mask[nd]:
                # the model's bitset holds category values; the bin-space
                # one holds this run's bins of those values (gbdt.py
                # :1610-1636 of the JAX package)
                ci = int(tree.threshold[nd])
                tree.threshold_in_bin[nd] = ci
                lo, hi = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
                cats = [32 * w + j
                        for w, word in enumerate(tree.cat_threshold[lo:hi])
                        for j in range(32) if (word >> j) & 1]
                c2b = getattr(mapper, "categorical_2_bin", {})
                per_ci_bins[ci] = _to_bitset(
                    [c2b[c] for c in cats if c in c2b])
                continue
            ub = np.asarray(mapper.bin_upper_bound, np.float64)
            b = int(np.searchsorted(ub, float(tree.threshold[nd]),
                                    side="left"))
            tree.threshold_in_bin[nd] = min(b, max(mapper.num_bin - 1, 0))
        if tree.num_cat > 0:
            ct_inner, cb_inner = [], [0]
            for ci in range(tree.num_cat):
                ct_inner.extend(per_ci_bins.get(ci, []))
                cb_inner.append(len(ct_inner))
            tree.cat_threshold_inner = ct_inner
            tree.cat_boundaries_inner = cb_inner

    def continue_from(self, prev: "GBDT", train_raw=None,
                      valid_raws=None) -> None:
        """Continued training (gbdt.py:925 of the JAX package; ref:
        application.cpp:94-97, gbdt.h:70 MergeFrom): adopt prev's trees,
        seed the training and valid scores with its raw predictions, and
        count its iterations into the absolute iteration."""
        K = self.num_tree_per_iteration
        if prev.num_tree_per_iteration != K:
            log.fatal("Cannot continue training: the initial model has "
                      f"{prev.num_tree_per_iteration} trees per iteration, "
                      f"this one needs {K}")
        if prev.average_output_ != self.average_output_:
            log.fatal("Cannot continue training across averaging modes "
                      "(rf vs gbdt/dart): tree outputs would be combined "
                      "with the wrong weights")
        self.models_ = [copy.deepcopy(t) for t in prev.models_]
        for t in self.models_:
            self._reconstruct_bin_space(t)
        self.num_init_iteration_ = len(self.models_) // max(K, 1)
        self.iter_ = 0
        self._bump_model_mutations()
        ds = self.train_data
        if train_raw is not None:
            X = train_raw
        elif self.shard is not None:
            # every row, from the dataset's own codes (the device holds
            # only this rank's)
            bins = (ds.binned if isinstance(ds.binned, torch.Tensor)
                    else codes_to_device(ds.binned, "cpu"))
            X = self._reconstruct_raw(ds, bins, ds.pre_bundled_plan)
        else:
            X = self._reconstruct_raw(ds, self.binned_dev, self.bundle_plan)
        raw = prev.predict_raw(np.asarray(X, np.float64))
        raw = raw[:, None] if raw.ndim == 1 else raw             # [n, K]
        sc = self._local_rows(np.ascontiguousarray(raw.T, np.float32))
        self.scores = self.scores + torch.from_numpy(sc).to(self.device)
        for vi, vds in enumerate(self.valid_sets):
            vX = (valid_raws[vi] if valid_raws is not None
                  and valid_raws[vi] is not None
                  else self._reconstruct_raw(vds, self.valid_bins[vi],
                                             vds.pre_bundled_plan))
            vraw = prev.predict_raw(np.asarray(vX, np.float64))
            vraw = vraw[:, None] if vraw.ndim == 1 else vraw
            self.valid_scores[vi] += vraw.T

    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees (ref: gbdt.cpp:443
        RollbackOneIter; the JAX booster's, gbdt.py:2308, which keeps the
        training and valid scores as they are) and the prediction caches
        built from them."""
        K = self.num_tree_per_iteration
        if len(self.models_) >= K:
            del self.models_[-K:]
            self.iter_ -= 1
            self._bump_model_mutations()

    # ------------------------------------------------------------ gradients
    def _boost_from_average(self, class_id: int) -> float:
        """ref: gbdt.cpp:313 BoostFromAverage."""
        cfg, obj = self.config, self.objective
        if self.models_ or self.has_init_score or obj is None:
            return 0.0
        if cfg.boost_from_average or self.train_data.num_features == 0:
            init = obj.boost_from_score(class_id)
            if abs(init) > K_EPSILON:
                self.scores[class_id] += init
                for sc in self.valid_scores:
                    sc[class_id] += init
                log.info(f"Start training from score {init:.6f}")
                return init
        elif obj.name in ("regression_l1", "quantile", "mape"):
            log.warning(f"Disabling boost_from_average in {obj.name} "
                        "may cause the slow convergence")
        return 0.0

    def _compute_gradients(self):
        """Per-class gradients [K, n_pad] (ref: gbdt.cpp:220 Boosting):
        a multiclass objective takes the [K, n_pad] scores, the others
        the one class's row."""
        obj = self.objective
        if self.num_tree_per_iteration > 1:
            return obj.get_gradients(self.scores, self.label_dev,
                                     self.weight_dev)
        # the ranking objectives read whole queries across the ranks
        kw = ({"shard": self.shard} if self.shard is not None
              and getattr(obj, "takes_shard", False) else {})
        g, h = obj.get_gradients(self.scores[0], self.label_dev,
                                 self.weight_dev, **kw)
        return g[None, :], h[None, :]

    def pre_gradient_hook(self) -> None:
        """Runs before the training scores are read for the gradients, a
        custom objective's too (DART drops its trees here)."""

    def _update_bagging(self, grad, hess):
        """Row sampling for this iteration (the JAX booster's
        `_update_bagging`, gbdt.py:1115; ref: bagging.hpp, goss.hpp).
        Returns (row mask [n_pad] on the device, grad, hess).  The streams
        are keyed by the absolute iteration, so continued training
        advances GOSS's; the NumPy bagging stream restarts from its seed
        in each booster, as in the JAX package."""
        cfg = self.config
        n = self.num_data
        abs_iter = self.num_init_iteration_ + self.iter_
        if cfg.data_sample_strategy == "goss":
            # no sampling for the first 1/learning_rate iterations
            if abs_iter < int(1.0 / max(cfg.learning_rate, 1e-10)):
                return self.bag_mask, grad, hess
            key = jrandom.PRNGKey(cfg.bagging_seed + abs_iter,
                                  device=self.device)
            return goss_sample(grad, hess, self.pad_mask, key,
                               max(1, int(n * cfg.top_rate)),
                               max(1, int(n * cfg.other_rate)),
                               shard=self.shard)
        if (cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0
                and abs_iter % cfg.bagging_freq == 0):
            # over every row: a data-parallel rank keeps its slice
            mask = np.zeros(n, np.float32)
            pos_frac, neg_frac = (cfg.pos_bagging_fraction,
                                  cfg.neg_bagging_fraction)
            if ((pos_frac < 1.0 or neg_frac < 1.0)
                    and self.objective is not None
                    and self.objective.name == "binary"):
                # balanced bagging (ref: bagging.hpp balanced_bagging_)
                lab = np.asarray(self.train_data.metadata.label) > 0
                for cls_mask, frac in ((lab, pos_frac), (~lab, neg_frac)):
                    cls_idx = np.nonzero(cls_mask)[0]
                    take = int(len(cls_idx) * frac)
                    mask[self._rng_bag.choice(cls_idx, take,
                                              replace=False)] = 1.0
            else:
                cnt = int(n * cfg.bagging_fraction)
                mask[self._rng_bag.choice(n, cnt, replace=False)] = 1.0
            mask = self._local_rows(mask)
            self._bag_mask_host = mask
            self.bag_mask = torch.from_numpy(mask).to(self.device)
        return self.bag_mask, grad, hess

    def _col_mask(self) -> torch.Tensor:
        """Per-tree feature_fraction mask [F_used] (gbdt.py:1157 of the JAX
        package; ref: col_sampler.hpp ResetByTree)."""
        cfg = self.config
        if cfg.feature_fraction >= 1.0:
            return self.col_mask
        F = self.train_data.num_features
        cnt = max(1, int(round(F * cfg.feature_fraction)))
        mask = np.zeros(F, bool)
        mask[self._rng_feat.choice(F, cnt, replace=False)] = True
        return torch.from_numpy(mask).to(self.device)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration; returns True when training should stop
        (ref: gbdt.cpp:338 TrainOneIter)."""
        K = self.num_tree_per_iteration
        abs_iter = self.num_init_iteration_ + self.iter_
        if faults.active():
            faults.maybe_crash(abs_iter)
            faults.maybe_worker_lost(abs_iter)
            faults.maybe_hang(abs_iter)
        # the sentinel flags fetched for the previous iteration are stale
        self._finite_cache = None
        init_scores = [0.0] * K
        if gradients is None:
            for k in range(K):
                init_scores[k] = self._boost_from_average(k)
            with global_timer.scope("GBDT::gradients"):
                grad, hess = self._compute_gradients()
                grad, hess = global_timer.block((grad, hess))
            if global_cost_model.enabled:
                global_cost_model.account("gradients", *gradients_cost(
                    K, self.n_pad, self.weight_dev is not None))
            if faults.active():
                grad, hess = faults.maybe_nan_grad(grad, hess, abs_iter)
            if self.config.nonfinite_check_freq > 0:
                # device flag, accumulated with no host synchronization;
                # the engine's sentinel fetches it (gradients_finite)
                ok = torch.isfinite(grad).all() & torch.isfinite(hess).all()
                self._grad_ok = (ok if self._grad_ok is None
                                 else self._grad_ok & ok)
        else:
            grad = self._pad_rows(gradients, K)
            hess = self._pad_rows(hessians, K)
        with global_timer.scope("GBDT::bagging"):
            bag_mask, grad, hess = self._update_bagging(grad, hess)
            global_timer.block(bag_mask)
        grew = False
        for k in range(K):
            tree = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                g_k, h_k, qscales = grad[k], hess[k], None
                if self.use_quant:
                    # per-tree discretization keyed by absolute iteration
                    # (the JAX booster's key, gbdt.py:1216-1230)
                    with global_timer.scope("GBDT::discretize"):
                        key = None
                        if self.config.stochastic_rounding:
                            key = jrandom.fold_in(
                                self._quant_key,
                                (self.num_init_iteration_ + self.iter_) * K
                                + k)
                        g_k, h_k, qscales = discretize_gradients(
                            g_k, h_k, self.config.num_grad_quant_bins,
                            self._quant_const_hess, key, shard=self.shard)
                # the per-scan draws' keys advance with the absolute
                # iteration (gbdt.py:1242-1248 of the JAX package)
                extra_tag = None
                if (self.config.extra_trees
                        or self.config.feature_fraction_bynode < 1.0):
                    extra_tag = (self.num_init_iteration_ + self.iter_) * K + k
                arrays, leaf_id = self._grow(
                    g_k, h_k, bag_mask,
                    quant_scales=(qscales if self.grow_params.quant_bins > 0
                                  else None),
                    extra_tag=extra_tag)
                linear = self.config.linear_tree
                if (self.use_quant and self.config.quant_train_renew_leaf
                        and not linear):
                    # leaf outputs from the float gradients (gbdt.py:1494),
                    # summed over the bagging mask (the whole data under
                    # GOSS, whose rescaled gradients they are)
                    arrays = arrays._replace(leaf_value=renew_leaf_values(
                        arrays.leaf_value, leaf_id, grad[k], hess[k],
                        self.bag_mask, self._renew_params, self.net))
                with global_timer.scope("GBDT::finalize_tree"):
                    if linear:
                        # fitted on the float gradients, quantized training
                        # included (gbdt.py:1228-1238 of the JAX package)
                        tree = self._finalize_linear(arrays, leaf_id, k,
                                                     init_scores[k], grad[k],
                                                     hess[k])
                    else:
                        tree = self._finalize_tree(arrays, leaf_id, k,
                                                   init_scores[k])
                global_registry.inc("trees_grown")
            if tree is None:
                # no split: this class keeps a stump, a constant one in
                # the first iteration (ref: gbdt.cpp:372-391)
                tree = (self._make_const_stump(k) if len(self.models_) < K
                        else self._stump())
            else:
                grew = True
            self.models_.append(tree)
        if not grew:
            # no class split: the reference's stop (gbdt.cpp:338-418)
            # drops the iteration, keeping the first one's constant stumps
            log.warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            if len(self.models_) > K:
                del self.models_[-K:]
            return True
        self.iter_ += 1
        return False

    def _grow(self, g_k, h_k, bag_mask, quant_scales=None, extra_tag=None):
        """One tree on this iteration's column mask, on the booster's
        engine; marks its split features for CEGB.  Returns (device tree
        arrays, leaf id of every row)."""
        with global_timer.scope("GBDT::col_sampling"):
            col_mask = self._col_mask()
        if faults.active():
            # one rank wedging here leaves its peers blocked in the
            # histogram reduction: the stall watchdog's shape
            faults.maybe_collective_stall(self.num_init_iteration_
                                          + self.iter_)
        # parallel learners: the Network and the serial run's padded row
        # count (data, voting), the vote, or the column block (feature)
        dp = ({} if self.shard is None else
              dict(net=self.net, grid_rows=self.shard.grid_rows))
        if self.block is not None:
            dp["block"] = self.block
        with global_timer.scope("GBDT::grow_tree"):
            if self.growth_strategy == "wave":
                arrays, leaf_id = grow_tree_wave_impl(
                    self.binned_dev, g_k, h_k, bag_mask, col_mask,
                    self.meta, self.grow_params, quant_scales=quant_scales,
                    extra_tag=extra_tag, cegb_used=self.cegb_used, **dp)
            else:
                out = grow_tree_impl(
                    self.binned_dev, g_k, h_k, bag_mask, col_mask,
                    self.meta, self.grow_params,
                    binned_rm=self.binned_rm_dev, extra_tag=extra_tag,
                    cegb_used=self.cegb_used, lazy_used=self.lazy_used,
                    voting=self.voting, **dp)
                # lazy CEGB's fetched rows ride from tree to tree
                # (gbdt.py:1249-1267 of the JAX package; RF's loop too)
                arrays, leaf_id = out[:2]
                if self.lazy_used is not None:
                    self.lazy_used = out[2]
            global_timer.block(leaf_id)
        if self.cegb_used is not None:
            # the tree's split features become used (gbdt.py:1270 of the
            # JAX package)
            self.cegb_used[arrays.split_feature[
                :arrays.num_leaves - 1].to(torch.int64)] = True
        return arrays, leaf_id

    def _pad_rows(self, values, K: int) -> torch.Tensor:
        """A custom objective's gradients over every training row ->
        this rank's rows on the device, padded."""
        a = np.asarray(values, np.float32).reshape(K, -1)
        return torch.from_numpy(self._local_rows(a)).to(self.device)

    def train_scores(self) -> torch.Tensor:
        """The training scores of every row, [K, num_data] on the
        booster's device (all-gathered from the ranks under
        data-parallel training)."""
        sh = self.shard
        if sh is None:
            return self.scores[:, :self.num_data]
        return self.net.all_gather_rows(self.scores[:, :sh.count], sh.sizes)

    @staticmethod
    def _stump() -> Tree:
        """A one-leaf tree of output 0."""
        tree = Tree(2)
        tree.num_leaves = 1
        tree.shrinkage = 1.0
        return tree

    def _make_const_stump(self, k: int) -> Tree:
        """One-leaf tree for a class with no first-iteration split
        (ref: gbdt.cpp:372-391)."""
        tree = self._stump()
        init = 0.0
        if (self.objective is not None
                and not self.config.boost_from_average
                and not self.has_init_score):
            init = self.objective.boost_from_score(k)
            self.scores[k] += init
            for sc in self.valid_scores:
                sc[k] += init
        tree.leaf_value[0] = init
        return tree

    # ------------------------------------------------------------ tree pull
    def _pack_tree(self, t) -> torch.Tensor:
        """The whole tree as ONE flat float32 buffer (int arrays ride
        along bit-exactly), so the host pulls it in one transfer."""
        def bits(a):
            return a.to(torch.int32).view(torch.float32)
        num = torch.tensor([t.num_leaves], dtype=torch.int32,
                           device=t.leaf_value.device)
        return torch.cat([
            bits(num), bits(t.split_feature), bits(t.threshold_bin),
            bits(t.default_left), t.split_gain, bits(t.left_child),
            bits(t.right_child), t.internal_value, t.internal_weight,
            bits(t.internal_count), t.leaf_value, t.leaf_weight,
            bits(t.leaf_count), bits(t.leaf_parent), bits(t.leaf_depth),
            bits(t.split_is_cat), bits(t.cat_bitset.reshape(-1))])

    def _packed_to_tree(self, flat: np.ndarray) -> Optional[Tree]:
        """Decode the packed flat tree buffer into a host Tree (None when
        the tree grew no split)."""
        ints = flat.view(np.int32)
        L = self.config.num_leaves
        ni = max(L - 1, 1)
        W = cat_bitset_words(self.grow_params.max_bin)
        parts = []
        off = 1
        for size, is_int in ((ni, True), (ni, True), (ni, True),
                             (ni, False), (ni, True), (ni, True),
                             (ni, False), (ni, False), (ni, True),
                             (L, False), (L, False), (L, True),
                             (L, True), (L, True), (ni, True),
                             (ni * W, True)):
            parts.append(ints[off:off + size] if is_int
                         else flat[off:off + size])
            off += size
        (split_feature, threshold_bin, default_left, split_gain,
         left_child, right_child, internal_value, internal_weight,
         internal_count, leaf_value, leaf_weight, leaf_count,
         leaf_parent, leaf_depth, split_is_cat, cat_bits) = parts
        cat_bits = cat_bits.reshape(ni, W).astype(np.uint32)
        num_leaves = int(ints[0])
        if num_leaves <= 1:
            return None
        ds = self.train_data
        tree = Tree(max(L, 2))
        tree.num_leaves = num_leaves
        ni = num_leaves - 1
        sf_inner = split_feature[:ni]
        thr_bin = threshold_bin[:ni]
        dleft = default_left[:ni] != 0
        tree.split_feature_inner[:ni] = sf_inner
        tree.split_feature[:ni] = np.array(
            [ds.used_features[f] for f in sf_inner], np.int32)
        tree.threshold_in_bin[:ni] = thr_bin
        for i in range(ni):
            mapper = ds.bin_mappers[tree.split_feature[i]]
            if split_is_cat[i]:
                # the bins-left bitset becomes the category set (gbdt.py
                # :1418-1437 of the JAX package)
                words = cat_bits[i]
                bins_left = [b for b in range(mapper.num_bin)
                             if (words[b // 32] >> (b % 32)) & 1]
                cats_left = [mapper.bin_2_categorical[b] for b in bins_left
                             if mapper.bin_2_categorical[b] >= 0]
                tree.register_cat_split(i, bins_left, cats_left,
                                        mapper.missing_type)
                continue
            tree.threshold[i] = mapper.bin_to_value(int(thr_bin[i]))
            dt = 0
            if dleft[i]:
                dt |= 2
            dt |= (mapper.missing_type & 3) << 2
            tree.decision_type[i] = dt
        tree.split_gain[:ni] = split_gain[:ni]
        tree.left_child[:ni] = left_child[:ni]
        tree.right_child[:ni] = right_child[:ni]
        tree.internal_value[:ni] = internal_value[:ni]
        tree.internal_weight[:ni] = internal_weight[:ni]
        tree.internal_count[:ni] = internal_count[:ni]
        nl = num_leaves
        tree.leaf_value[:nl] = leaf_value[:nl]
        tree.leaf_weight[:nl] = leaf_weight[:nl]
        tree.leaf_count[:nl] = leaf_count[:nl]
        tree.leaf_parent[:nl] = leaf_parent[:nl]
        tree.leaf_depth[:nl] = leaf_depth[:nl]
        return tree

    def _renew_by_objective(self, leaf_id: torch.Tensor, score: torch.Tensor,
                            num_leaves: int) -> torch.Tensor:
        """The objective's leaf renewal (L1, quantile, MAPE) over the
        in-bag rows (the bagging mask; every row under GOSS, as in the
        JAX package, gbdt.py:1527-1536): float64 [num_leaves] on the
        device, from `score` [n_pad] of before this tree's update.  A
        row-sharded rank all-gathers its rows' leaf ids (-1 out of the
        bag) and scores in rank order, which is the serial row order
        (`rows_of` is contiguous), 8 B a row a tree on float32 scores,
        and renews over
        every row as the serial run does (the objective holds every
        row's labels and weights on the host)."""
        sh = self.shard
        n = self.num_data if sh is None else sh.count
        with global_timer.scope("GBDT::renew"):
            ids = torch.where(self.bag_mask[:n] > 0,
                              leaf_id[:n].to(torch.int64),
                              torch.full((n,), -1, dtype=torch.int64,
                                         device=leaf_id.device))
            score = score[:n]
            if sh is not None:
                # leaf ids ride in the scores' dtype (exact below 2^24)
                every = self.net.all_gather_rows(
                    torch.stack([ids.to(score.dtype), score]), sh.sizes)
                ids, score = every[0].to(torch.int64), every[1]
            out = self.objective.renew_tree_output(ids, score, num_leaves)
            return global_timer.block(out)

    def _pull_tree(self, arrays) -> Optional[Tree]:
        """The device tree as a host Tree, in one transfer (None when it
        grew no split)."""
        return self._packed_to_tree(self._pack_tree(arrays).cpu().numpy())

    def _calculate_linear(self, tree: Tree, leaf_id: torch.Tensor,
                          grad: torch.Tensor, hess: torch.Tensor):
        """Fit the tree's linear leaf models on the device (learner/
        linear.py; the JAX booster's `_calculate_linear`, gbdt.py:2119):
        `leaf_id`, `grad`, `hess` [rows] (this rank's under a row shard,
        whose sums the fit reduces over the ranks), the gradients
        multiplied by the bag mask."""
        ds = self.train_data
        stats = fit_linear(
            tree, self.raw_dev, leaf_id, grad, hess,
            self.config.linear_lambda,
            lambda f: ds.bin_mappers[f].bin_type == BIN_NUMERICAL,
            ds.inner_feature_index, shard=self.shard)
        self.linear_fit_stats.append(stats)
        return stats

    def _finalize_linear(self, arrays, leaf_id, class_id: int,
                         init_score: float, grad: torch.Tensor,
                         hess: torch.Tensor) -> Optional[Tree]:
        """A linear tree (gbdt.py:1470-1490 of the JAX package): fit the
        leaf models on the float gradients, shrink, then add each row's
        linear output on the device (float64, rounded once to float32)
        at the leaf the growth gave it."""
        tree = self._pull_tree(arrays)
        if tree is None:
            return None
        n = self.num_data if self.shard is None else self.shard.count
        ids = leaf_id[:n]
        bag = self.bag_mask[:n]
        with global_timer.scope("GBDT::linear_fit"):
            self._calculate_linear(tree, ids, grad[:n] * bag, hess[:n] * bag)
            tree.apply_shrinkage(self.shrinkage_rate)
            delta = linear_outputs(tree, self.raw_dev, ids)
            self.scores[class_id, :n] += delta.to(torch.float32)
            global_timer.block(self.scores)
        for vi in range(len(self.valid_sets)):
            self._add_valid_tree_score(vi, tree, class_id)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        return tree

    def _finalize_tree(self, arrays, leaf_id, class_id: int,
                       init_score: float) -> Optional[Tree]:
        """Renew the leaf outputs (L1, quantile, MAPE), shrink, update the
        scores on the device and pull the tree (ref: gbdt.cpp:395-407)."""
        lv = arrays.leaf_value
        renewed = None
        obj = self.objective
        if obj is not None and obj.need_renew_tree_output:
            # from the scores before this tree's update; the renewed
            # values replace the grown ones before the shrinkage and the
            # score updates (gbdt.py:1524-1543 of the JAX package)
            renewed = self._renew_by_objective(
                leaf_id, self.scores[class_id], lv.shape[0])
            delta = (renewed * self.shrinkage_rate).to(torch.float32)
        else:
            delta = lv * self.shrinkage_rate
        delta = delta[leaf_id.to(torch.int64).clamp(0, lv.shape[0] - 1)]
        self.scores[class_id] += delta * self.pad_mask
        tree = self._pull_tree(arrays)
        if tree is None:
            return None
        if renewed is not None:
            nl = tree.num_leaves
            tree.leaf_value[:nl] = renewed[:nl].cpu().numpy()
        tree.apply_shrinkage(self.shrinkage_rate)
        # valid scores on the host, before the init score joins the
        # first tree's leaves (gbdt.py:1543 of the JAX package)
        for vi in range(len(self.valid_sets)):
            self._add_valid_tree_score(vi, tree, class_id)
        if abs(init_score) > K_EPSILON:
            tree.add_bias(init_score)
        return tree

    def _add_tree_score(self, tree: Tree, class_id: int, train: bool = True,
                        valid: bool = True,
                        train_ids: Optional[torch.Tensor] = None
                        ) -> Optional[torch.Tensor]:
        """score += the host tree's current leaf outputs (ref:
        score_updater.hpp:21 AddScore; DART's drops and normalization, RF's
        averaging): the training scores on the device, through a
        bin-space traversal of the training bins (or `train_ids`, the leaf
        ids of an earlier call), the valid scores in float64 on the host.
        Returns the training rows' leaf ids."""
        if train:
            if train_ids is None:
                train_ids = leaf_index_bin_space(
                    tree, self.binned_dev, self.f_missing_type,
                    self.f_num_bin, self.f_default_bin, self.bundle_plan)
            nl = max(tree.num_leaves, 1)
            vals = torch.from_numpy(
                tree.leaf_value[:nl].astype(np.float32)).to(self.device)
            self.scores[class_id] += (vals[train_ids.to(torch.int64)]
                                      * self.pad_mask)
        if valid:
            for vi in range(len(self.valid_sets)):
                self._add_valid_tree_score(vi, tree, class_id)
        return train_ids

    def _tree_leaf_ids(self, tree: Tree, vi: int) -> np.ndarray:
        """Leaf index of every row of valid set `vi` (the traversal runs
        on the booster's device; one transfer of the ids)."""
        ids = leaf_index_bin_space(tree, self.valid_bins[vi],
                                   self.f_missing_type, self.f_num_bin,
                                   self.f_default_bin,
                                   self.valid_sets[vi].pre_bundled_plan)
        return ids.cpu().numpy()

    def _add_valid_tree_score(self, vi: int, tree: Tree,
                              class_id: int) -> None:
        """valid score += the tree's leaf outputs, in float64 on the host
        (gbdt.py:1673-1681 of the JAX package); a linear tree predicts the
        set's raw matrix, kept when it was constructed under linear_tree
        (the JAX package predicts the matrix its bins reconstruct, +inf in
        a feature's last bin), else the reconstructed one."""
        if tree.is_linear:
            if vi not in self._valid_raw:
                vds = self.valid_sets[vi]
                self._valid_raw[vi] = np.asarray(self._reconstruct_raw(
                    vds, self.valid_bins[vi], vds.pre_bundled_plan),
                    np.float64)
            self.valid_scores[vi][class_id] += tree.predict(
                self._valid_raw[vi])
            return
        vids = self._tree_leaf_ids(tree, vi)
        self.valid_scores[vi][class_id] += tree.leaf_value[vids]

    # ------------------------------------------------------------ eval
    def _ensure_finite_flags(self):
        """(gradients_finite, scores_finite) for the current iteration:
        from the eval tick's packed transfer when one ran, else one
        dedicated transfer of a [2] vector."""
        if self._finite_cache is None:
            flag = (self._grad_ok if self._grad_ok is not None
                    else torch.tensor(True, device=self.device))
            flags = torch.stack([
                flag.to(torch.float32),
                torch.isfinite(self.scores).all().to(torch.float32)])
            if self.net is not None:
                # every rank takes the same sentinel decision
                self.net.all_reduce_min_(flags)
            flags = flags.cpu().numpy()
            self._finite_cache = (bool(flags[0] > 0), bool(flags[1] > 0))
        return self._finite_cache

    def gradients_finite(self) -> bool:
        """Every gradient since training began was finite (the engine's
        sentinel)."""
        return self._ensure_finite_flags()[0]

    def scores_finite(self) -> bool:
        """Every training score is finite (the engine's sentinel)."""
        return self._ensure_finite_flags()[1]

    def eval_train(self):
        """Training metrics: one device tick (ops/metrics.py DeviceEval),
        or the host Metric classes on the pulled scores when the metric
        set has no full device form or `device_eval=false`."""
        de = self._device_eval
        if de is None:
            from ..ops.metrics import DeviceEval, ShardedEval
            de = self._device_eval = (DeviceEval(self) if self.net is None
                                      else ShardedEval(self))
        if de.ok:
            if not de._plans:
                return []
            out, grads_ok, scores_ok = de.run(self.scores, self._grad_ok)
            # the sentinel flags rode the packed transfer
            self._finite_cache = (grads_ok, scores_ok)
            return out
        score = self.train_scores().cpu().numpy().astype(np.float64)
        return self._eval(score, self.train_metrics)

    def eval_valid(self, idx: int):
        return self._eval(self.valid_scores[idx], self.valid_metrics[idx])

    def _eval(self, score, metrics):
        out = []
        sc = score[0] if score.shape[0] == 1 else score
        for m in metrics:
            out.extend(m.eval(sc, self.objective))
        return out

    # ------------------------------------------------------------ predict
    def _bump_model_mutations(self) -> None:
        """Invalidate the packed/device predictor caches after a change of
        the trees that `len(models_)` cannot see: a rollback followed by
        new trees, adopted trees, and later in-place mutations (DART
        re-weighting, refit, set_leaf_output).  Serving
        a model mid-mutation must repack, never reuse stale leaf
        values."""
        self._model_mutations += 1

    def _slice_end(self, start_iteration: int, num_iteration: int) -> int:
        K = self.num_tree_per_iteration
        total_iters = len(self.models_) // max(K, 1)
        if num_iteration is None or num_iteration < 0:
            num_iteration = total_iters - start_iteration
        return min(start_iteration + num_iteration, total_iters)

    def _packed_for(self, start_iteration: int, end: int, K: int):
        """Cached native PackedPredictor for a model slice, invalidated by
        growth (len) and in-place mutation (_model_mutations)."""
        if predictor_lib() is None:
            return None
        key = (start_iteration, end, len(self.models_),
               self._model_mutations)
        cached = self._packed_pred
        if cached is None or cached[0] != key:
            cached = (key, PackedPredictor(
                self.models_[start_iteration * K:end * K]))
            self._packed_pred = cached
        packed = cached[1]
        return packed if packed.ok else None

    def make_single_row_fast(self, num_features: int,
                             start_iteration: int = 0,
                             num_iteration: int = -1,
                             raw_score: bool = False):
        """Cached single-row fast predictor (ref: c_api.h:1350
        LGBM_BoosterPredictForMatSingleRowFastInit): pack once, reuse
        buffers per call.  None when the native predictor is unavailable
        (linear trees / no compiler)."""
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        packed = self._packed_for(start_iteration, end, K)
        if packed is None:
            return None
        conv = None
        if not raw_score and self.objective is not None:
            conv = self.objective.convert_output_host
        sp = SingleRowFastPredictor(packed, num_features, K,
                                    self.average_output_, convert=conv)
        return sp if sp.ok else None

    def _host_fallback(self, reason: str):
        """One host-fallback decision of the device-predict router, named
        by its KEY (the README's port section lists every key).  Returns
        None for the caller."""
        log.debug(f"device_predict: host fallback ({reason})")
        return None

    def _device_predictor(self, X, start_iteration: int,
                          num_iteration: int):
        """Route decision for device prediction.  Returns
        (DevicePredictor, float32 matrix) ready to serve, or None when
        the host paths must: device_predict=false, auto on a booster
        whose device is not the card, float64 data that is NOT
        losslessly float32-representable (the bit-exact routing argument
        needs float32 inputs; lossless float64 is downcast and served),
        non-float input, linear-tree models and empty slices.  With
        `true` the traversal runs on the booster's device, the CPU
        included."""
        cfg = self.config
        mode = cfg.device_predict if cfg is not None else "false"
        if mode == "false":
            return None
        arr = X if isinstance(X, np.ndarray) else np.asarray(X)
        if arr.dtype == np.float32:
            X32 = arr
        elif arr.dtype == np.float64:
            # one downcast and one compare pass: equal after the round
            # trip (NaN kept as missing) means the float32 traversal
            # routes bit-identically to the float64 host path
            X32 = arr.astype(np.float32)
            if not bool(np.all((X32 == arr) | np.isnan(arr))):
                return self._host_fallback("float64-lossy")
        else:
            return self._host_fallback("non-float-input")
        dev = (self.device if self.device is not None
               else resolve_device(cfg.device_type))
        if mode == "auto" and dev.type != "cuda":
            return None
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        if end <= start_iteration:
            return self._host_fallback("empty-slice")
        dp = self._device_pred_for(start_iteration, end, K, dev)
        # dp.ok is False exactly when the slice cannot pack: linear trees
        # (inference/pack.py) are the one reachable case here
        return (dp, X32) if dp.ok else self._host_fallback("linear-tree")

    def _device_pred_for(self, start_iteration: int, end: int, K: int,
                         device: torch.device):
        """Cached DevicePredictor per model slice, invalidated by growth
        (len) and in-place mutation, mirroring _packed_for."""
        key = (start_iteration, end, len(self.models_),
               self._model_mutations, device)
        cached = self._device_pred
        if cached is None or cached[0] != key:
            obj = self.objective
            cached = (key, DevicePredictor(
                self.models_[start_iteration * K:end * K], num_class=K,
                average=self.average_output_,
                convert=obj.convert_output if obj is not None else None,
                min_bucket=self.config.device_predict_min_bucket,
                device=device))
            self._device_pred = cached
        return cached[1]

    def _device_predict_run(self, dp, X, mode: str,
                            early_stop=None) -> np.ndarray:
        """One device predict dispatch under the `GBDT::predict_device`
        timer scope, and a structured `predict` event when an EventLogger
        is active.  `early_stop=(freq, margin)` runs the device masked
        accumulation (parity with the host early-stop path)."""
        with global_timer.scope("GBDT::predict_device"):
            if mode == "leaf":
                out = dp.predict_leaf(X)
            elif mode == "raw":
                out = dp.predict_raw(X, early_stop=early_stop)
            else:
                out = dp.predict(X, early_stop=early_stop)
        n = out.shape[0]
        emit_event("predict", path="device", mode=mode, rows=int(n),
                   trees=dp.pack.num_trees, bucket=dp.bucket_rows(n),
                   early_stop=early_stop is not None)
        return out

    def _es_tuple(self, pred_early_stop, freq, margin):
        """(freq, margin) when prediction early stopping engages: the
        same gate as the host path's use_es (off under output averaging,
        ref: gbdt_prediction.cpp)."""
        if pred_early_stop and not self.average_output_ and freq > 0:
            return (int(freq), float(margin))
        return None

    def predict_raw(self, X: np.ndarray, start_iteration: int = 0,
                    num_iteration: int = -1, pred_early_stop: bool = False,
                    pred_early_stop_freq: int = 10,
                    pred_early_stop_margin: float = 10.0) -> np.ndarray:
        """Raw scores [n] or [n, K] (ref: gbdt_prediction.cpp PredictRaw;
        early stopping per prediction_early_stop.cpp: rows whose margin
        exceeds the threshold every round_period iterations keep their
        partial sum; binary margin = 2|score|, multiclass = top1-top2)."""
        hit = self._device_predictor(X, start_iteration, num_iteration)
        if hit is not None:
            es = self._es_tuple(pred_early_stop, pred_early_stop_freq,
                                pred_early_stop_margin)
            return self._device_predict_run(hit[0], hit[1], "raw", es)
        with global_timer.scope("GBDT::predict"):
            return self._predict_raw_impl(
                X, start_iteration, num_iteration, pred_early_stop,
                pred_early_stop_freq, pred_early_stop_margin)

    def _predict_raw_impl(self, X, start_iteration, num_iteration,
                          pred_early_stop, pred_early_stop_freq,
                          pred_early_stop_margin) -> np.ndarray:
        """The host paths: the native batch predictor (OpenMP over rows),
        else the Python loop over the host trees, which also carries
        early stopping."""
        X = np.asarray(X, dtype=np.float64)
        n = X.shape[0]
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        use_es = pred_early_stop and not self.average_output_
        if not use_es and end > start_iteration:
            # the flattened pack is cached per model slice and
            # invalidated by growth and in-place mutation
            packed = self._packed_for(start_iteration, end, K)
            if packed is not None:
                res = packed.predict(X, K, self.average_output_)
                if res is not None:
                    return res[:, 0] if K == 1 else res
        out = np.zeros((K, n))
        active_idx = np.arange(n) if use_es else None
        Xa = X
        for i, it in enumerate(range(start_iteration, end)):
            if use_es and i > 0 and i % pred_early_stop_freq == 0:
                sub = out[:, active_idx]
                if K == 1:
                    margin = 2.0 * np.abs(sub[0])
                else:
                    top2 = np.partition(sub, K - 2, axis=0)[K - 2:]
                    margin = top2[1] - top2[0]
                keep = margin <= pred_early_stop_margin
                active_idx = active_idx[keep]
                if len(active_idx) == 0:
                    break
                # the point of early stopping is SKIPPING work: later
                # trees only traverse the still-active rows
                Xa = X[active_idx]
            for k in range(K):
                pred = self.models_[it * K + k].predict(Xa)
                if use_es:
                    out[k][active_idx] += pred
                else:
                    out[k] += pred
        if self.average_output_ and end > start_iteration:
            out /= end - start_iteration  # ref: gbdt_prediction.cpp:57
        return out[0] if K == 1 else out.T

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0, num_iteration: int = -1,
                pred_leaf: bool = False, **pred_kwargs) -> np.ndarray:
        if pred_leaf:
            return self.predict_leaf_index(X, start_iteration, num_iteration)
        if raw_score or self.objective is None:
            return self.predict_raw(X, start_iteration, num_iteration,
                                    **pred_kwargs)
        es_args = (pred_kwargs.get("pred_early_stop", False),
                   pred_kwargs.get("pred_early_stop_freq", 10),
                   pred_kwargs.get("pred_early_stop_margin", 10.0))
        hit = self._device_predictor(X, start_iteration, num_iteration)
        if hit is not None:
            # convert_output runs on the device after the sums
            return self._device_predict_run(hit[0], hit[1], "convert",
                                            self._es_tuple(*es_args))
        # the route is decided once: the host paths from here
        with global_timer.scope("GBDT::predict"):
            raw = self._predict_raw_impl(X, start_iteration, num_iteration,
                                         *es_args)
        # host path: the scores are already NumPy; the objective's host
        # converter avoids a round trip through the device
        conv = self.objective.convert_output_host
        if raw.ndim == 2:
            return np.asarray(conv(raw.T)).T
        return np.asarray(conv(raw))

    def predict_leaf_index(self, X: np.ndarray, start_iteration: int = 0,
                           num_iteration: int = -1) -> np.ndarray:
        """Leaf ids [n, trees] (ref: tree.h:422 GetLeaf)."""
        hit = self._device_predictor(X, start_iteration, num_iteration)
        if hit is not None:
            return self._device_predict_run(hit[0], hit[1], "leaf")
        X = np.asarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        end = self._slice_end(start_iteration, num_iteration)
        if end > start_iteration:
            # the native traversal as in predict, returning leaf ids;
            # shares predict_raw's packed-model cache
            packed = self._packed_for(start_iteration, end, K)
            if packed is not None:
                res = packed.predict_leaf(X)
                if res is not None:
                    return res
        cols = []
        for it in range(start_iteration, end):
            for k in range(K):
                cols.append(self.models_[it * K + k].get_leaf_index(X))
        return (np.stack(cols, axis=1) if cols
                else np.zeros((X.shape[0], 0), np.int32))

    def predict_contrib(self, X: np.ndarray, start_iteration: int = 0,
                        num_iteration: int = -1) -> np.ndarray:
        """SHAP feature contributions [n, K·(F + 1)]: per class, F
        per-feature columns and the expected value, summing to the raw
        score of constant-leaf trees (ref: gbdt.h:314 PredictContrib;
        TreeSHAP of src/io/tree.cpp; gbdt.py:2244 of the JAX package).
        A linear tree's contributions explain its constant leaf values,
        as the JAX package's do."""
        from ..native import tree_shap
        # the recursive path-weight algorithm has no device form
        self._host_fallback("pred-contrib")
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        n = X.shape[0]
        K = self.num_tree_per_iteration
        F = (self.train_data.num_total_features
             if self.train_data is not None
             else self._loaded_max_feature_idx + 1)
        start = start_iteration
        end = self._slice_end(start, num_iteration)
        phi = np.zeros((K, n, F + 1))
        for it in range(start, end):
            for k in range(K):
                tree_shap(self.models_[it * K + k], X, phi[k])
        if self.average_output_ and end > start:
            phi /= end - start
        if K == 1:
            return phi[0]
        return phi.transpose(1, 0, 2).reshape(n, K * (F + 1))

    # --------------------------------------------------------------- refit
    def refit(self, X: np.ndarray, label: np.ndarray,
              weight: Optional[np.ndarray] = None) -> None:
        """Refit the leaf values of the existing tree structures to new
        data (ref: gbdt.cpp:252 RefitTree; serial_tree_learner.cpp:241
        FitByExistingTree; gbdt.py:2181 of the JAX package): new leaf =
        decay·old + (1 − decay)·output·shrinkage.  The rows' leaves come
        from `predict_leaf_index` (the card for float32-exact input), the
        gradients from the objective on the booster's device.  A linear
        tree keeps its leaf models, as in the JAX package."""
        from ..io.dataset import Metadata
        from ..objective import create_objective
        X = np.asarray(X, np.float64)
        n = X.shape[0]
        leaf_preds = self.predict_leaf_index(X)             # [n, trees]
        md = Metadata(n)
        md.set_label(np.asarray(label, np.float64))
        if weight is not None:
            md.set_weight(weight)
        obj = self.objective or create_objective(self.config)
        obj.init(md, n)
        dev = (self.device if self.device is not None
               else resolve_device(self.config.device_type))
        lab = torch.from_numpy(np.asarray(obj.label, np.float32)).to(dev)
        w = (None if md.weight is None else torch.from_numpy(
            np.asarray(md.weight, np.float32)).to(dev))
        score = np.zeros((self.num_tree_per_iteration, n), np.float64)
        try:
            self._refit_trees(obj, lab, w, score, leaf_preds)
        finally:
            # after the mutations (not before predict_leaf_index, which
            # would cache the old trees under the new count), and also
            # when an iteration raises midway
            self._bump_model_mutations()

    def _refit_trees(self, obj, lab, w, score, leaf_preds) -> None:
        """Iteration by iteration: gradients at the running float64 scores
        rounded to float32, pulled in one transfer; per-leaf sums in
        float64 by `np.bincount` on the host, as the JAX package sums
        them (gbdt.py:2213-2242)."""
        cfg = self.config
        K = self.num_tree_per_iteration
        decay = cfg.refit_decay_rate
        l1, l2 = cfg.lambda_l1, cfg.lambda_l2
        n = score.shape[1]
        dev = lab.device
        for it in range(len(self.models_) // K):
            sc = torch.from_numpy(score.astype(np.float32)).to(dev)
            g, h = obj.get_gradients(sc if K > 1 else sc[0], lab, w)
            gh = torch.stack([g.reshape(K, n), h.reshape(K, n)]).cpu()
            g, h = gh.numpy()
            for k in range(K):
                m = it * K + k
                tree = self.models_[m]
                nl = tree.num_leaves
                lp = np.clip(leaf_preds[:, m], 0, nl - 1)
                sg = np.bincount(lp, weights=g[k], minlength=nl)[:nl]
                sh = (np.bincount(lp, weights=h[k], minlength=nl)[:nl]
                      + K_EPSILON)
                sg_l1 = np.sign(sg) * np.maximum(np.abs(sg) - l1, 0.0)
                out = -sg_l1 / (sh + l2)
                if cfg.max_delta_step > 0:
                    out = np.clip(out, -cfg.max_delta_step,
                                  cfg.max_delta_step)
                new = (decay * tree.leaf_value[:nl]
                       + (1.0 - decay) * out * tree.shrinkage)
                tree.leaf_value[:nl] = new
                tree.leaf_count[:nl] = np.bincount(lp, minlength=nl)[:nl]
                score[k] += new[lp]

    # --------------------------------------------------------------- model
    @property
    def num_trees(self) -> int:
        return len(self.models_)

    def current_iteration(self) -> int:
        return len(self.models_) // max(self.num_tree_per_iteration, 1)

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        F = self.train_data.num_total_features if self.train_data else (
            max(int(t.split_feature[:t.num_leaves - 1].max(initial=0))
                for t in self.models_) + 1 if self.models_ else 0)
        out = np.zeros(F)
        for t in self.models_:
            if importance_type == "split":
                out += t.feature_importance_split(F)
            else:
                out += t.feature_importance_gain(F)
        return out
