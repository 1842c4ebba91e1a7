"""lightgbm_tpu_torch — the PyTorch/CUDA port of ``lightgbm_tpu``.

Same API shape as ``lightgbm_tpu`` (and the reference LightGBM Python
package): ``Dataset``, ``Booster``, ``train``, ``cv`` and ``CVBooster``,
the callbacks, the scikit-learn estimators and the plot functions
(``io/streaming.py`` and ``io/binary_io.py`` build and cache binned
datasets). Training runs on an NVIDIA GPU (``device_type="cuda"``, the
default) with the histogram as a hand-written CUDA kernel
(``csrc/histogram.cu``), or on the CPU when the caller passes
``device_type="cpu"``. ``predict`` sends
batches of 256 rows or more on the card through the stacked forest
(``serve/``: raw rows quantized against the model's thresholds, all
trees walked in one pass), and smaller ones through the host walk.

This package imports torch, numpy and scipy (scikit-learn's bases when
it is installed; matplotlib and graphviz only inside a plot call) —
never jax and nothing of ``lightgbm_tpu``.

    import lightgbm_tpu_torch as lgb
    bst = lgb.train({"objective": "binary"}, lgb.Dataset(X, label=y))
    pred = bst.predict(X)
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import CVBooster, cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError

__all__ = [
    "Dataset", "Booster", "LightGBMError", "Config",
    "train", "cv", "CVBooster",
    "early_stopping", "log_evaluation", "record_evaluation",
    "reset_parameter", "EarlyStopException",
    "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
    "plot_importance", "plot_metric", "plot_split_value_histogram",
    "plot_tree", "create_tree_digraph",
]
