"""Linear leaf models (ref: src/treelearner/linear_tree_learner.cpp:184
CalculateLinear; Shi et al., arXiv:1802.05640, Eq. 3; port of the JAX
booster's `_calculate_linear`, lightgbm_tpu/boosting/gbdt.py:2119).

After a tree's structure is grown with constant-leaf gains, each leaf
gets a ridge regression on the numerical features of its branch:

    (X'HX + lambda * I_k) c = -X'g

over the leaf's rows with a positive hessian and no NaN in any of its
features, X the leaf's feature columns plus a constant column (lambda
on the k feature diagonals only).  A leaf with fewer than k + 1 such
rows keeps its constant-leaf value and no features.  A singular system
takes the pseudo-inverse.

`fit_linear` runs the fit on the raw matrix's device: the usable rows
are stable-sorted by leaf, their features gathered into one float64
matrix (each leaf's table padded to the widest with a zero column), one
product per leaf gives [X'HX | X'g], and one batched solve covers every
leaf, the padded rows and columns holding the identity.  Every sum is a
matrix product (no float atomics), so the same inputs give the same
bits.  `calculate_linear_plain` is the JAX package's NumPy loop, the
plain version the tests and chip_smoke.py hold the device fit to.
`linear_outputs` evaluates the fitted leaves on the device, as
`Tree.predict` does on the host (a row with NaN in a feature of its
leaf takes the leaf's constant value).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import numpy as np
import torch

ZERO_THRESHOLD = 1e-35     # kZeroThreshold: smaller coefficients are dropped


class LinearFitStats(NamedTuple):
    """What one fit did: leaves fitted, degenerate (constant kept) and
    solved by pseudo-inverse, and the mean feature count of the fitted
    leaves."""
    fitted: int
    degenerate: int
    pinv: int
    mean_k: float


def branch_features(tree, is_numerical: Callable[[int], bool]
                    ) -> List[List[int]]:
    """Per leaf, the sorted numerical features split on along its branch
    (the parent chain through `leaf_parent` and the child arrays)."""
    nl = tree.num_leaves
    ni = nl - 1
    parent = np.full(max(ni, 1), -1, np.int64)
    for node in range(ni):
        for child in (tree.left_child[node], tree.right_child[node]):
            if child >= 0:
                parent[child] = node
    out = []
    for leaf in range(nl):
        feats = set()
        node = int(tree.leaf_parent[leaf]) if ni > 0 else -1
        while node >= 0:
            feats.add(int(tree.split_feature[node]))
            node = int(parent[node])
        out.append(sorted(f for f in feats if is_numerical(f)))
    return out


def _set_leaf(tree, leaf, feats, coeffs, k, inner_index):
    keep = [i for i in range(k) if abs(coeffs[i]) > ZERO_THRESHOLD]
    tree.leaf_features[leaf] = [feats[i] for i in keep]
    tree.leaf_features_inner[leaf] = [inner_index(feats[i]) for i in keep]
    tree.leaf_coeff[leaf] = [float(coeffs[i]) for i in keep]
    tree.leaf_const[leaf] = float(coeffs[k])


def _keep_constant(tree, leaf):
    tree.leaf_const[leaf] = tree.leaf_value[leaf]
    tree.leaf_features[leaf] = []
    tree.leaf_features_inner[leaf] = []
    tree.leaf_coeff[leaf] = []


def calculate_linear_plain(tree, raw: np.ndarray, leaf_id: np.ndarray,
                           grad: np.ndarray, hess: np.ndarray,
                           linear_lambda: float,
                           is_numerical: Callable[[int], bool],
                           inner_index: Callable[[int], int]
                           ) -> LinearFitStats:
    """The plain version: the JAX package's host loop in NumPy float64
    (gbdt.py:2119-2179 of the JAX package).  `raw` [n, F_total];
    `leaf_id`, `grad`, `hess` [n] (the gradients already multiplied by
    the bag mask).  Fills the tree's linear fields."""
    tree.is_linear = True
    feats_of = branch_features(tree, is_numerical)
    fitted = degenerate = pinv = 0
    ks = []
    for leaf in range(tree.num_leaves):
        feats = feats_of[leaf]
        rows = np.nonzero((leaf_id == leaf) & (hess > 0))[0]
        k = len(feats)
        if len(rows) == 0:
            _keep_constant(tree, leaf)
            degenerate += 1
            continue
        Xl = raw[np.ix_(rows, feats)] if k else np.zeros((len(rows), 0))
        ok = ~np.isnan(Xl).any(axis=1)
        if ok.sum() < k + 1:
            _keep_constant(tree, leaf)
            degenerate += 1
            continue
        Xd = np.column_stack([Xl[ok], np.ones(int(ok.sum()))])
        g = grad[rows][ok]
        h = hess[rows][ok]
        XTHX = Xd.T @ (Xd * h[:, None])
        XTHX[np.arange(k), np.arange(k)] += linear_lambda
        XTg = Xd.T @ g
        try:
            coeffs = -np.linalg.solve(XTHX, XTg)
        except np.linalg.LinAlgError:
            coeffs = -np.linalg.pinv(XTHX) @ XTg
            pinv += 1
        _set_leaf(tree, leaf, feats, coeffs, k, inner_index)
        fitted += 1
        ks.append(k)
    return LinearFitStats(fitted, degenerate, pinv,
                          float(np.mean(ks)) if ks else 0.0)


def fit_linear(tree, raw_dev: torch.Tensor, leaf_id: torch.Tensor,
               grad: torch.Tensor, hess: torch.Tensor, linear_lambda: float,
               is_numerical: Callable[[int], bool],
               inner_index: Callable[[int], int]) -> LinearFitStats:
    """The device fit.  `raw_dev` [n, F_total + 1] on the device, its last
    column zero (the padding of the feature tables); `leaf_id`, `grad`,
    `hess` [n] on the same device (the gradients already multiplied by
    the bag mask).  Fills the tree's linear fields on the host, from one
    transfer of every leaf's coefficients (a second one only when a leaf
    needs the pseudo-inverse)."""
    tree.is_linear = True
    dev = raw_dev.device
    f64 = torch.float64
    L = tree.num_leaves
    zero_col = raw_dev.shape[1] - 1
    feats_of = branch_features(tree, is_numerical)
    ks = np.array([len(f) for f in feats_of], np.int64)
    kmax = int(ks.max()) if L else 0
    table = np.full((L, max(kmax, 1)), zero_col, np.int64)
    for leaf, feats in enumerate(feats_of):
        table[leaf, :len(feats)] = feats
    table = torch.from_numpy(table[:, :kmax]).to(dev)

    lid = leaf_id.to(torch.int64)
    usable = hess > 0
    rows = torch.arange(lid.shape[0], device=dev)
    X = raw_dev[rows[:, None], table[lid]]                  # [n, kmax]
    if kmax:
        usable &= ~torch.isnan(X).any(1)
    idx = torch.nonzero(usable).squeeze(1)
    # rows grouped by leaf, in row order within a leaf
    idx = idx[torch.sort(lid[idx], stable=True).indices]
    lid_s = lid[idx]
    counts = torch.bincount(lid_s, minlength=L)
    Xs = X[idx]
    # a branch feature constant over a leaf's usable rows makes the leaf's
    # system singular in exact arithmetic (min and max are exact in any
    # order, so the test gives the same answer on every device)
    flat = torch.zeros(L, dtype=torch.bool, device=dev)
    if kmax:
        real = torch.from_numpy(np.arange(kmax)[None, :]
                                < ks[:, None]).to(dev)
        same = (torch.segment_reduce(Xs, "max", lengths=counts, axis=0)
                == torch.segment_reduce(Xs, "min", lengths=counts, axis=0))
        flat = (same & real).any(1)
    head = torch.stack([counts, flat.to(torch.int64)]).cpu().numpy()
    counts, flat = head[0], head[1] > 0
    Xd = torch.cat([Xs.to(f64),
                    torch.ones((idx.shape[0], 1), dtype=f64, device=dev)], 1)
    W = torch.cat([Xd * hess[idx].to(f64)[:, None],
                   grad[idx].to(f64)[:, None]], 1)
    fit = counts >= ks + 1
    M = torch.zeros((L, kmax + 1, kmax + 2), dtype=f64, device=dev)
    off = 0
    for leaf in range(L):
        c = int(counts[leaf])
        if fit[leaf]:
            torch.matmul(Xd[off:off + c].T, W[off:off + c], out=M[leaf])
        off += c
    # lambda on each leaf's k feature diagonals, the identity on the
    # padded ones and on a degenerate leaf's whole system
    diag = np.zeros((L, kmax + 1))
    for leaf in range(L):
        if fit[leaf]:
            diag[leaf, :ks[leaf]] = linear_lambda
            diag[leaf, ks[leaf]:kmax] = 1.0
        else:
            diag[leaf] = 1.0
    A = M[:, :, :kmax + 1] + torch.diag_embed(torch.from_numpy(diag).to(dev))
    b = M[:, :, kmax + 1]
    sol, info = torch.linalg.solve_ex(A, b)
    pulled = torch.cat([sol.reshape(-1), info.to(f64)]).cpu().numpy()
    coeffs = -pulled[:L * (kmax + 1)].reshape(L, kmax + 1)
    bad = np.nonzero(fit & (flat | (pulled[L * (kmax + 1):] != 0)))[0]
    if len(bad):
        # the pseudo-inverse (numpy's default cutoff, 1e-15 of the
        # largest singular value), each padded diagonal set to the leaf's
        # constant diagonal (its sum of hessians, at most its largest
        # singular value), so the cutoff is that of the leaf's own system
        bi = torch.from_numpy(bad).to(dev)
        Ab = A[bi].clone()
        j = np.arange(kmax + 1)[None, :]
        pad = torch.from_numpy((j >= ks[bad][:, None]) & (j < kmax)).to(dev)
        d = torch.diagonal(Ab, dim1=1, dim2=2)
        d.copy_(torch.where(pad, Ab[:, kmax, kmax][:, None], d))
        cb = torch.linalg.pinv(Ab, rtol=1e-15) @ b[bi][:, :, None]
        coeffs[bad] = -cb[:, :, 0].cpu().numpy()
    for leaf in range(L):
        k = int(ks[leaf])
        if not fit[leaf]:
            _keep_constant(tree, leaf)
            continue
        _set_leaf(tree, leaf, feats_of[leaf],
                  list(coeffs[leaf, :k]) + [coeffs[leaf, kmax]], k,
                  inner_index)
    return LinearFitStats(int(fit.sum()), int(L - fit.sum()), len(bad),
                          float(ks[fit].mean()) if fit.any() else 0.0)


def linear_tables(tree, zero_col: int):
    """The fitted tree's leaf models as dense tables: features [L, k]
    (padded with `zero_col`), coefficients [L, k] float64, constants
    and leaf values [L] float64."""
    L = tree.num_leaves
    k = max((len(f) for f in tree.leaf_features[:L]), default=0)
    feats = np.full((L, k), zero_col, np.int64)
    coef = np.zeros((L, k))
    for leaf in range(L):
        fl = tree.leaf_features[leaf]
        feats[leaf, :len(fl)] = fl
        coef[leaf, :len(fl)] = tree.leaf_coeff[leaf]
    return (feats, coef, np.asarray(tree.leaf_const[:L], np.float64),
            np.asarray(tree.leaf_value[:L], np.float64))


def linear_outputs(tree, raw_dev: torch.Tensor,
                   leaf_id: torch.Tensor) -> torch.Tensor:
    """Each row's output of the linear tree, float64 on the device:
    const[leaf] + sum_j coeff[leaf, j] * x[feat[leaf, j]], or the leaf's
    value when one of its features is NaN in the row (Tree.predict's
    rule, ref: tree.cpp:133).  `leaf_id` [n] are the rows' leaves."""
    dev = raw_dev.device
    feats, coef, const, value = (torch.from_numpy(a).to(dev) for a in
                                 linear_tables(tree, raw_dev.shape[1] - 1))
    lid = leaf_id.to(torch.int64)
    out = const[lid]
    if feats.shape[1] == 0:
        return out
    rows = torch.arange(lid.shape[0], device=dev)
    X = raw_dev[rows[:, None], feats[lid]].to(torch.float64)
    nan = torch.isnan(X).any(1)
    out = out + (X * coef[lid]).sum(1)
    return torch.where(nan, value[lid], out)


def raw_to_device(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    """The raw matrix [n, F] on the device with a zero column appended:
    float32 when every value is a float32 (a float32 input upcasts to
    float64 exactly), else float64."""
    raw = np.asarray(raw)
    r32 = raw.astype(np.float32)
    exact = bool(np.all((r32 == raw) | np.isnan(raw)))
    src = r32 if exact else np.asarray(raw, np.float64)
    out = torch.zeros((raw.shape[0], raw.shape[1] + 1), dtype=(
        torch.float32 if exact else torch.float64), device=device)
    out[:, :raw.shape[1]] = torch.from_numpy(np.ascontiguousarray(src)).to(
        device)
    return out
