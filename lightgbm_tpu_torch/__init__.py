"""lightgbm_tpu_torch — the PyTorch/CUDA port of ``lightgbm_tpu``.

Same API shape as ``lightgbm_tpu`` (and the reference LightGBM Python
package): ``Dataset``, ``Booster``, ``train`` and the callbacks. Training
runs on an NVIDIA GPU (``device_type="cuda"``, the default) with the
histogram as a hand-written CUDA kernel (``csrc/histogram.cu``), or on
the CPU when the caller passes ``device_type="cpu``; prediction walks
the trees on the host.

This package imports torch, numpy and scipy only — never jax and nothing
of ``lightgbm_tpu``.

    import lightgbm_tpu_torch as lgb
    bst = lgb.train({"objective": "binary"}, lgb.Dataset(X, label=y))
    pred = bst.predict(X)
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, log_evaluation,
                       record_evaluation)
from .config import Config
from .engine import train
from .utils.log import LightGBMError

__all__ = ["Booster", "Dataset", "train", "Config", "LightGBMError",
           "EarlyStopException", "early_stopping", "log_evaluation",
           "record_evaluation"]
