"""User-facing ``Dataset`` and ``Booster``.

Port of ``lightgbm_tpu/basic.py`` (API after the reference's
python-package/lightgbm/basic.py): these classes adapt parameters and
NumPy/pandas inputs and delegate to :mod:`lightgbm_tpu_torch.boosting`.
A training ``Booster`` runs on ``device_type`` (``cuda`` unless the
params ask for ``cpu``); prediction walks the trees on the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .boosting.gbdt import GBDT
from .config import Config, resolve_device
from .io.dataset import BinnedDataset
from .metric import create_metric, resolve_metric_names
from .utils.log import LightGBMError


def _to_2d_float(data) -> np.ndarray:
    if hasattr(data, "values") and not isinstance(data, np.ndarray):
        data = data.values             # pandas
    arr = np.asarray(data)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    return arr


class Dataset:
    """Lazily constructed training data (reference: basic.py
    ``Dataset``, constructed at first use)."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._handle: Optional[BinnedDataset] = None

    def construct(self) -> "Dataset":
        if self._handle is not None:
            return self
        if self.reference is not None:
            self.reference.construct()
        config = Config.from_params(self.params)
        cat = self.categorical_feature
        if cat not in ("auto", None, "", []):
            config.categorical_feature = cat
        if hasattr(self.data, "tocsc"):
            data = self.data             # from_matrix raises for sparse
        else:
            data = _to_2d_float(self.data)
        feature_names = None
        if isinstance(self.feature_name, (list, tuple)):
            feature_names = list(self.feature_name)
        elif hasattr(self.data, "columns"):
            feature_names = [str(c) for c in self.data.columns]
        self._handle = BinnedDataset.from_matrix(
            data, config, label=self.label, weights=self.weight,
            group=self.group, init_score=self.init_score,
            feature_names=feature_names,
            reference=(self.reference._handle
                       if self.reference is not None else None))
        if self.free_raw_data:
            self.data = None
        return self

    @property
    def handle(self) -> BinnedDataset:
        self.construct()
        return self._handle


class Booster:
    """reference: basic.py ``Booster``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.config = Config.from_params(self.params)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._valid_names: List[str] = []
        if train_set is not None:
            if train_set._handle is None:
                train_set.params = dict(self.params,
                                        **(train_set.params or {}))
            train_set.construct()
            self.inner = GBDT(self.config, train_set.handle,
                              resolve_device(self.config))
        elif model_file is not None or model_str is not None:
            if model_str is None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self.inner = GBDT(self.config)
            self.inner.load_model_from_string(model_str)
        else:
            raise LightGBMError(
                "Booster needs train_set, model_file or model_str")

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self.inner.add_valid_data(data.handle)
        self._valid_names.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training should stop."""
        return self.inner.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self.inner.current_iteration

    def num_model_per_iteration(self) -> int:
        return self.inner.num_tree_per_iteration

    # ------------------------------------------------------------------
    def eval_train(self) -> List[Tuple]:
        inner = self.inner
        if not inner.train_metrics:
            for mname in resolve_metric_names(inner.config,
                                              inner.config.objective):
                m = create_metric(mname, inner.config)
                if m is not None:
                    m.init(inner.train_data.metadata, inner.num_data)
                    inner.train_metrics.append(m)
        score = inner.train_score.cpu().numpy().astype(np.float64)
        return self._eval("training", inner.train_metrics, score)

    def eval_valid(self) -> List[Tuple]:
        out = []
        for i, vd in enumerate(self.inner.valid_data):
            name = (self._valid_names[i] if i < len(self._valid_names)
                    else "valid_%d" % i)
            out.extend(self._eval(name, vd.metrics, vd.scores))
        return out

    def _eval(self, name: str, metrics, score: np.ndarray) -> List[Tuple]:
        """(data name, metric name, value, is_higher_better) of every
        value of every metric; ``score`` is [n, K] (a single column is
        passed on as [n])."""
        if score.shape[1] == 1:
            score = score[:, 0]
        return [(name, mname, v, m.factor_to_bigger_better > 0)
                for m in metrics
                for mname, v in zip(m.name,
                                    m.eval(score, self.inner.objective))]

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                **kwargs) -> np.ndarray:
        """Host walk over raw feature values (the device walk is ROADMAP
        item 9)."""
        X = _to_2d_float(data)
        n_feat = self.inner.max_feature_idx + 1
        no_check = bool(kwargs.pop("predict_disable_shape_check",
                                   self.config.predict_disable_shape_check))
        if X.shape[1] != n_feat and not no_check:
            raise ValueError(
                "The number of features in data (%d) is not the same as "
                "it was in training data (%d). You can set "
                "predict_disable_shape_check=true to discard this "
                "error, but please be aware what you are doing."
                % (X.shape[1], n_feat))
        ni = -1 if num_iteration is None else int(num_iteration)
        if ni <= 0 and self.best_iteration > 0:
            ni = self.best_iteration
        if pred_leaf:
            return self.inner.predict_leaf_index(X, start_iteration, ni)
        return self.inner.predict(X, raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=ni, **kwargs)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        ni = -1 if num_iteration is None else int(num_iteration)
        return self.inner.save_model_to_string(start_iteration, ni)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text: a temporary file renamed into place, so
        a crash never leaves a truncated model."""
        import os
        tmp = filename + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration))
        os.replace(tmp, filename)
        return self
