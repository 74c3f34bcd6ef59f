"""DART boosting: per-iteration tree dropout and normalization (PyTorch
port of `lightgbm_tpu/boosting/dart.py`; ref: src/boosting/dart.hpp:23
DART).

Mechanics per iteration (ref: dart.hpp Normalize note):
  1. pick dropped trees from RandomState(drop_seed), in the JAX package's
     order, and subtract their contribution from the training scores
     (the gradients are then computed on the "dropped" ensemble);
  2. train the new tree with shrinkage lr/(1+k);
  3. re-add the dropped trees scaled to k/(k+1) of their old weight and
     fix up the train and valid scores.
A dropped host tree's training rows are routed once, by a bin-space
traversal of the training bins on the device; the drop and the
normalization reuse its leaf ids.  Valid scores stay float64 on the
host.  The drop state does not ride a checkpoint yet (ROADMAP Queue 1
item 16).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..utils.timer import global_timer
from .gbdt import GBDT


class DART(GBDT):
    """ref: dart.hpp:23."""

    def init(self, config, train_data, objective, metrics=()) -> None:
        super().init(config, train_data, objective, metrics)
        self._rng_drop = np.random.RandomState(config.drop_seed)
        self.tree_weight_: List[float] = []
        self.sum_weight_ = 0.0
        self.drop_index_: List[int] = []
        self._dropped_cur_iter = False
        # training leaf ids of the dropped trees, by model index
        self._drop_ids: Dict[int, torch.Tensor] = {}

    def pre_gradient_hook(self) -> None:
        """Drop before the caller reads training scores, once per iteration
        (ref: dart.hpp:77 GetTrainingScore / is_update_score_cur_iter_)."""
        if not self._dropped_cur_iter:
            with global_timer.scope("DART::drop"):
                self._dropping_trees()
            self._dropped_cur_iter = True

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        cfg = self.config
        self.pre_gradient_hook()
        self._dropped_cur_iter = False
        ret = super().train_one_iter(gradients, hessians)
        if ret:
            return ret
        with global_timer.scope("DART::drop"):
            self._normalize()
        if not cfg.uniform_drop:
            self.tree_weight_.append(self.shrinkage_rate)
            self.sum_weight_ += self.shrinkage_rate
        return False

    # ------------------------------------------------------------------
    def _dropping_trees(self) -> None:
        """ref: dart.hpp:97 DroppingTrees."""
        cfg = self.config
        self.drop_index_ = []
        if self._rng_drop.rand() >= cfg.skip_drop:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight_ > 0:
                    inv_avg = len(self.tree_weight_) / self.sum_weight_
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate,
                                        cfg.max_drop * inv_avg / self.sum_weight_)
                    for i in range(self.iter_):
                        if self._rng_drop.rand() < (drop_rate
                                                    * self.tree_weight_[i] * inv_avg):
                            self.drop_index_.append(self.num_init_iteration_ + i)
                            if (cfg.max_drop > 0
                                    and len(self.drop_index_) >= cfg.max_drop):
                                break
            else:
                if cfg.max_drop > 0 and self.iter_ > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter_)
                for i in range(self.iter_):
                    if self._rng_drop.rand() < drop_rate:
                        self.drop_index_.append(self.num_init_iteration_ + i)
                        if (cfg.max_drop > 0
                                and len(self.drop_index_) >= cfg.max_drop):
                            break
        # drop: flip each selected tree to -weight and add it to the
        # training scores
        K = self.num_tree_per_iteration
        self._drop_ids = {}
        for i in self.drop_index_:
            for k in range(K):
                idx = i * K + k
                tree = self.models_[idx]
                tree.apply_shrinkage(-1.0)
                self._drop_ids[idx] = self._add_tree_score(tree, k,
                                                           valid=False)
        if self.drop_index_:
            # the in-place leaf re-weighting invalidates the packed and
            # device predictor caches: a predict between drop and
            # normalize must score the CURRENT drop state
            self._bump_model_mutations()
        k_cnt = float(len(self.drop_index_))
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k_cnt)
        else:
            self.shrinkage_rate = (cfg.learning_rate if not self.drop_index_
                                   else cfg.learning_rate
                                   / (cfg.learning_rate + k_cnt))

    def _normalize(self) -> None:
        """ref: dart.hpp:160 Normalize."""
        cfg = self.config
        K = self.num_tree_per_iteration
        k_cnt = float(len(self.drop_index_))
        for i in self.drop_index_:
            for k in range(K):
                idx = i * K + k
                tree = self.models_[idx]
                ids = self._drop_ids[idx]
                if not cfg.xgboost_dart_mode:
                    # tree currently at -w; scale to -w/(k+1), fix valid, then
                    # to +w*k/(k+1), fix train
                    tree.apply_shrinkage(1.0 / (k_cnt + 1.0))
                    self._add_tree_score(tree, k, train=False)
                    tree.apply_shrinkage(-k_cnt)
                    self._add_tree_score(tree, k, valid=False,
                                         train_ids=ids)
                else:
                    tree.apply_shrinkage(self.shrinkage_rate)
                    self._add_tree_score(tree, k, train=False)
                    tree.apply_shrinkage(-k_cnt / cfg.learning_rate)
                    self._add_tree_score(tree, k, valid=False,
                                         train_ids=ids)
            j = i - self.num_init_iteration_
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight_ -= self.tree_weight_[j] / (k_cnt + 1.0)
                    self.tree_weight_[j] *= k_cnt / (k_cnt + 1.0)
                else:
                    self.sum_weight_ -= (self.tree_weight_[j]
                                         / (k_cnt + cfg.learning_rate))
                    self.tree_weight_[j] *= (k_cnt
                                             / (k_cnt + cfg.learning_rate))
        self._drop_ids = {}
        if self.drop_index_:
            # normalization re-weighted the dropped trees in place: a
            # mid-training DART model must serve its current weights
            self._bump_model_mutations()
