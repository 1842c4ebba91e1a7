"""Plotting utilities (host only).

Port of ``lightgbm_tpu/plotting.py``, API-shaped after the reference's
python-package/lightgbm/plotting.py (plot_importance,
plot_split_value_histogram, plot_metric, plot_tree,
create_tree_digraph). Matplotlib/graphviz are imported lazily and gated —
the module degrades to clear errors when they're absent.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .basic import Booster
from .sklearn import LGBMModel


def _check_not_tuple_of_2_elements(obj, obj_name: str) -> None:
    if not isinstance(obj, tuple) or len(obj) != 2:
        raise TypeError("%s must be a tuple of 2 elements." % obj_name)


def _to_booster(booster) -> Booster:
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be a Booster or LGBMModel instance")


def _import_matplotlib():
    try:
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise ImportError(
            "You must install matplotlib and restart your session to "
            "use plotting.") from e


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim=None, ylim=None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "auto",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: int = 3, **kwargs):
    """reference: plotting.py plot_importance."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)
    if importance_type == "auto":
        importance_type = "split"
    importance = booster.feature_importance(importance_type)
    feature_name = booster.feature_name()
    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("Cannot plot trees with zero importance")
    labels, values = zip(*tuples)
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        ax.text(x + 1, y,
                _float2str(x, precision) if importance_type == "gain"
                else str(int(x)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _check_not_tuple_of_2_elements(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _check_not_tuple_of_2_elements(ylim, "ylim")
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def _float2str(value, precision: Optional[int] = None) -> str:
    if precision is not None:
        return "{0:.{1}f}".format(value, precision)
    return str(value)


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None, ax=None,
                xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize=None, dpi=None, grid: bool = True):
    """reference: plotting.py plot_metric — plots recorded eval results
    (from ``record_evaluation`` or ``LGBMModel.evals_result_``)."""
    plt = _import_matplotlib()
    if isinstance(booster, LGBMModel):
        eval_results = dict(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = booster
    else:
        raise TypeError(
            "booster must be a dict from record_evaluation or a fitted "
            "LGBMModel instance")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")
    if ax is None:
        if figsize is not None:
            _check_not_tuple_of_2_elements(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    name_first = dataset_names[0]
    metrics_for_one = eval_results[name_first]
    if metric is None:
        if len(metrics_for_one) > 1:
            raise ValueError(
                "to avoid ambiguity, specify metric to plot")
        metric = list(metrics_for_one.keys())[0]
    for name in dataset_names:
        results = eval_results[name][metric]
        ax.plot(range(1, len(results) + 1), results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    if title:
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(metric if ylabel == "auto" else ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8, xlim=None,
                               ylim=None,
                               title="Split value histogram for "
                                     "feature with @index/name@ @feature@",
                               xlabel="Feature split value",
                               ylabel="Count", figsize=None, dpi=None,
                               grid: bool = True, **kwargs):
    """reference: plotting.py plot_split_value_histogram."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)
    if isinstance(feature, str):
        feature_idx = booster.feature_name().index(feature)
    else:
        feature_idx = int(feature)
    values = []
    for tree in booster.inner.models:
        ni = tree.num_internal
        for j in range(ni):
            if tree.split_feature[j] == feature_idx and \
                    not (tree.decision_type[j] & 1):
                values.append(tree.threshold[j])
    if not values:
        raise ValueError(
            "Cannot plot split value histogram, "
            "because feature {} was not used in splitting".format(feature))
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    hist, bin_edges = np.histogram(values, bins=bins or 10)
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    width = width_coef * (bin_edges[1] - bin_edges[0])
    ax.bar(centers, hist, width=width, **kwargs)
    if title:
        title = title.replace("@feature@", str(feature)).replace(
            "@index/name@",
            "name" if isinstance(feature, str) else "index")
        ax.set_title(title)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: int = 3, orientation: str = "horizontal",
                        **kwargs):
    """reference: plotting.py create_tree_digraph (graphviz-gated)."""
    try:
        import graphviz
    except ImportError as e:
        raise ImportError(
            "You must install graphviz and restart your session to plot "
            "a tree.") from e
    booster = _to_booster(booster)
    tree = booster.inner.models[tree_index]
    feature_names = booster.feature_name()
    graph = graphviz.Digraph(**kwargs)
    graph.attr(rankdir="LR" if orientation == "horizontal" else "TB")

    def add(node, parent=None, decision=None):
        if node < 0:
            leaf = ~node
            name = "leaf%d" % leaf
            label = "leaf %d: %s" % (
                leaf, _float2str(tree.leaf_value[leaf], precision))
            graph.node(name, label=label)
        else:
            name = "split%d" % node
            f = tree.split_feature[node]
            fname = (feature_names[f]
                     if f < len(feature_names) else "Column_%d" % f)
            label = "%s <= %s" % (
                fname, _float2str(tree.threshold[node], precision))
            graph.node(name, label=label)
            add(int(tree.left_child[node]), name, "yes")
            add(int(tree.right_child[node]), name, "no")
        if parent is not None:
            graph.edge(parent, name, decision)

    if tree.num_leaves > 1:
        add(0)
    else:
        add(~0)
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None,
              dpi=None, show_info=None, precision: int = 3,
              orientation: str = "horizontal", **kwargs):
    """reference: plotting.py plot_tree (renders the digraph into a
    matplotlib axes)."""
    plt = _import_matplotlib()
    graph = create_tree_digraph(booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    import io
    try:
        from PIL import Image
        s = graph.pipe(format="png")
        img = Image.open(io.BytesIO(s))
        ax.imshow(img)
    except Exception as e:
        raise ImportError("plot_tree needs graphviz + PIL") from e
    ax.axis("off")
    return ax
