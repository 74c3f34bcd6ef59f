"""Plotting utilities (the PyTorch port's copy of
`lightgbm_tpu/plotting.py`; ref: python-package/lightgbm/plotting.py):
plot_importance, plot_metric, plot_split_value_histogram, and
graphviz-based tree rendering.  matplotlib and graphviz are imported
inside the functions, so importing the package needs neither."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .basic import Booster
from .utils import log


def _check_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError:  # pragma: no cover
        log.fatal("matplotlib is required for plotting")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """Horizontal bar chart of feature importances
    (ref: plotting.py:37 plot_importance)."""
    plt = _check_matplotlib()
    if isinstance(booster, Booster):
        if importance_type == "auto":
            importance_type = "split"
        importance = booster.feature_importance(importance_type)
        names = booster.feature_name()
    else:  # sklearn estimator
        if importance_type == "auto":
            importance_type = booster.importance_type
        importance = booster.booster_.feature_importance(importance_type)
        names = booster.booster_.feature_name()
    pairs = [(n, v) for n, v in zip(names, importance)
             if not (ignore_zero and v == 0)]
    pairs.sort(key=lambda t: t[1])
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    labels, values = ([p[0] for p in pairs], [p[1] for p in pairs])
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                f"{x:.{precision}f}" if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names=None, ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations",
                ylabel: str = "@metric@", figsize=None, dpi=None,
                grid: bool = True):
    """Plot recorded eval history (ref: plotting.py:231 plot_metric).
    `booster` is the dict produced by the record_evaluation callback."""
    plt = _check_matplotlib()
    if isinstance(booster, dict):
        eval_results = booster
    else:
        log.fatal("plot_metric needs the eval history dict recorded by "
                  "the record_evaluation callback")
    if not eval_results:
        log.fatal("eval results are empty")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    names = list(dataset_names or eval_results.keys())
    first = eval_results[names[0]]
    if metric is None:
        metric = next(iter(first.keys()))
    for name in names:
        ax.plot(eval_results[name][metric], label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_title(title.replace("@metric@", metric))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel.replace("@metric@", metric))
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None,
                               ylim=None,
                               title="Split value histogram for "
                                     "feature with @index/name@ @feature@",
                               xlabel="Feature split value",
                               ylabel="Count", figsize=None, dpi=None,
                               grid: bool = True):
    """Histogram of a feature's split thresholds across the model
    (ref: plotting.py:141)."""
    plt = _check_matplotlib()
    b = booster if isinstance(booster, Booster) else booster.booster_
    names = b.feature_name()
    fidx = (names.index(feature) if isinstance(feature, str)
            else int(feature))
    values = []
    for tree in b._gbdt.models_:
        ni = max(tree.num_leaves - 1, 0)
        for i in range(ni):
            if (tree.split_feature[i] == fidx
                    and not (tree.decision_type[i] & 1)):
                values.append(float(tree.threshold[i]))
    if not values:
        log.fatal(f"Feature {feature} was not used in splitting")
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    hist, edges = np.histogram(values, bins=bins or "auto")
    centers = (edges[:-1] + edges[1:]) / 2
    ax.bar(centers, hist,
           width=width_coef * (edges[1] - edges[0]))
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    kind = "name" if isinstance(feature, str) else "index"
    ax.set_title(title.replace("@index/name@", kind)
                 .replace("@feature@", str(feature)))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, **kwargs):
    """Graphviz Digraph of one tree (ref: plotting.py:404)."""
    try:
        import graphviz
    except ImportError:
        log.fatal("graphviz is required for tree plotting")
    b = booster if isinstance(booster, Booster) else booster.booster_
    tree = b._gbdt.models_[tree_index]
    names = b.feature_name()
    g = graphviz.Digraph(**kwargs)

    def add(node):
        if node < 0:
            leaf = ~node
            g.node(f"leaf{leaf}",
                   label=f"leaf {leaf}: "
                         f"{tree.leaf_value[leaf]:.{precision}f}")
            return f"leaf{leaf}"
        f = int(tree.split_feature[node])
        fname = names[f] if f < len(names) else f"Column_{f}"
        if tree.decision_type[node] & 1:  # categorical membership
            cats = "||".join(str(c) for c in tree._cats_of_node(node))
            label = f"{fname} in {{{cats}}}"
        else:
            label = f"{fname} <= {tree.threshold[node]:.{precision}f}"
        g.node(f"split{node}", label=label)
        left = add(int(tree.left_child[node]))
        right = add(int(tree.right_child[node]))
        g.edge(f"split{node}", left, label="yes")
        g.edge(f"split{node}", right, label="no")
        return f"split{node}"

    if tree.num_leaves > 1:
        add(0)
    else:
        g.node("leaf0", label=f"leaf 0: {tree.leaf_value[0]:.{precision}f}")
    return g


def plot_tree(booster, tree_index: int = 0, ax=None, figsize=None,
              dpi=None, **kwargs):
    """Render one tree via graphviz into a matplotlib axes
    (ref: plotting.py:560)."""
    plt = _check_matplotlib()
    graph = create_tree_digraph(booster, tree_index=tree_index, **kwargs)
    from io import BytesIO
    import matplotlib.image as mpimg
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    s = BytesIO(graph.pipe(format="png"))
    ax.imshow(mpimg.imread(s))
    ax.axis("off")
    return ax
