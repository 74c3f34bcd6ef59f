"""Random-forest mode: bagged trees, no shrinkage, averaged outputs
(PyTorch port of `lightgbm_tpu/boosting/rf.py`; ref: src/boosting/rf.hpp:25
RF).

Gradients are computed ONCE from the constant init score (no boosting);
the training score is kept as the running average of the trees'
outputs by the multiply/add/multiply pattern of rf.hpp TrainOneIter, on
the device; valid scores follow in float64 on the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils import log
from ..utils.timer import global_timer
from .gbdt import GBDT, K_EPSILON


class RF(GBDT):
    """ref: rf.hpp:25."""

    def __init__(self):
        super().__init__()
        self.average_output_ = True

    def init(self, config, train_data, objective, metrics=()) -> None:
        if config.data_sample_strategy == "goss":
            # GOSS reweights gradients per iteration; RF reuses ONE
            # gradient map for every tree (rf.hpp:95 Boosting computes
            # once), so the combination is meaningless
            log.fatal("RF mode does not support data_sample_strategy=goss")
        if config.data_sample_strategy == "bagging":
            ok = ((config.bagging_freq > 0
                   and 0.0 < config.bagging_fraction < 1.0)
                  or 0.0 < config.feature_fraction < 1.0)
            if not ok:
                log.fatal("RF mode requires bagging "
                          "(bagging_freq > 0 and bagging_fraction in (0, 1)) "
                          "or feature_fraction in (0, 1)")
        if objective is None:
            log.fatal("RF mode does not support custom objective functions")
        super().init(config, train_data, objective, metrics)
        if self.has_init_score:
            log.fatal("RF mode does not support init_score")
        self.shrinkage_rate = 1.0
        self._rf_boosting()

    def _rf_boosting(self) -> None:
        """Gradients from the constant init score, computed once
        (ref: rf.hpp:95 Boosting)."""
        cfg, obj = self.config, self.objective
        K = self.num_tree_per_iteration
        self._rf_init_scores: List[float] = [0.0] * K
        if cfg.boost_from_average and self.train_data.num_features > 0:
            for k in range(K):
                self._rf_init_scores[k] = obj.boost_from_score(k)
        saved = self.scores
        self.scores = torch.tensor(
            self._rf_init_scores, dtype=torch.float32,
            device=self.device)[:, None].expand(K, self.n_pad).contiguous()
        self._rf_grad, self._rf_hess = self._compute_gradients()
        self.scores = saved

    # rf.hpp:44-47's MultiplyScore(1/num_init) has no counterpart here:
    # continue_from seeds with prev.predict_raw(), which already averages
    # when the init model is an RF (average_output_)

    def _rf_multiply_score(self, class_id: int, val: float) -> None:
        """ref: rf.hpp:210 MultiplyScore (train + valid updaters)."""
        self.scores[class_id] *= val
        for sc in self.valid_scores:
            sc[class_id] *= val

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """ref: rf.hpp:117 TrainOneIter: never stops, never shrinks."""
        if gradients is not None or hessians is not None:
            log.fatal("RF mode does not support custom objective functions")
        # sentinel flags fetched for the previous iteration are stale now
        self._finite_cache = None
        K = self.num_tree_per_iteration
        n = self.num_data
        with global_timer.scope("GBDT::bagging"):
            bag_mask, grad, hess = self._update_bagging(self._rf_grad,
                                                        self._rf_hess)
        cur = float(self.iter_ + self.num_init_iteration_)
        for k in range(K):
            tree = leaf_id = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                arrays, leaf_id = self._grow(grad[k], hess[k], bag_mask)
                with global_timer.scope("GBDT::finalize_tree"):
                    tree = self._pull_tree(arrays)
            if tree is not None:
                nl = tree.num_leaves
                init = self._rf_init_scores[k]
                obj = self.objective
                if obj.need_renew_tree_output:
                    # residual against the constant init score, matching
                    # rf.hpp's residual_getter = label - init
                    tree.leaf_value[:nl] = self._renew_by_objective(
                        leaf_id, torch.full((n,), init, dtype=torch.float64,
                                            device=self.device),
                        nl).cpu().numpy()
                if abs(init) > K_EPSILON:
                    tree.add_bias(init)
                # running average: score = (score*cur + tree_pred)/(cur+1)
                self._rf_multiply_score(k, cur)
                vals = torch.from_numpy(
                    tree.leaf_value[:nl].astype(np.float32)).to(self.device)
                self.scores[k] += (vals[leaf_id.to(torch.int64).clamp(
                    0, nl - 1)] * self.pad_mask)
                self._add_tree_score(tree, k, train=False)
                self._rf_multiply_score(k, 1.0 / (cur + 1.0))
            else:
                tree = self._stump()
                if len(self.models_) < K:
                    output = 0.0
                    if not self.class_need_train[k]:
                        output = self.objective.boost_from_score(k)
                    tree.leaf_value[0] = output
                    self._rf_multiply_score(k, cur)
                    self.scores[k] += float(output) * self.pad_mask
                    for sc in self.valid_scores:
                        sc[k] += output
                    self._rf_multiply_score(k, 1.0 / (cur + 1.0))
            self.models_.append(tree)
        self.iter_ += 1
        return False
