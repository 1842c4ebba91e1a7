"""User-facing ``Dataset`` and ``Booster``.

Port of ``lightgbm_tpu/basic.py`` (API after the reference's
python-package/lightgbm/basic.py): these classes adapt parameters and
NumPy/pandas inputs and delegate to :mod:`lightgbm_tpu_torch.boosting`.
A ``Booster`` runs on ``device_type`` (``cuda`` unless the params ask
for ``cpu``). ``Booster.predict`` sends batches of 256 rows or more on
the card through the stacked forest (``serve/``), and the rest through
the host walk; ``predict_on_device`` forces either.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .boosting.gbdt import GBDT
from .config import Config, resolve_device
from .io.dataset import BinnedDataset, Metadata
from .metric import create_metric, resolve_metric_names
from .utils import log
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

    # ------------------------------------------------------------------
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._handle is not None and label is not None:
            self._handle.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weights(weight)
        return self

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_group(group)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(init_score)
        return self

    def get_label(self):
        if self._handle is not None:
            return self._handle.metadata.label
        return self.label

    def get_weight(self):
        if self._handle is not None:
            return self._handle.metadata.weights
        return self.weight

    def get_group(self):
        if self._handle is not None and \
                self._handle.metadata.query_boundaries is not None:
            return np.diff(self._handle.metadata.query_boundaries)
        return self.group

    def num_data(self) -> int:
        return self.handle.num_data

    def num_feature(self) -> int:
        return self.handle.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.handle.feature_names)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mappers
        (reference: Dataset.create_valid)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices`` of this dataset, sharing its bin
        mappers (reference: Dataset.subset)."""
        self.construct()
        idx = np.asarray(used_indices, dtype=np.int64)
        src = self._handle
        sub = Dataset(None, reference=self, params=params or self.params,
                      feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature)
        h = BinnedDataset()
        h.bins = src.bins[idx]
        h.bin_mappers = src.bin_mappers
        h.used_feature_map = src.used_feature_map
        h.num_total_features = src.num_total_features
        h.feature_names = src.feature_names
        h.num_bin_per_feature = src.num_bin_per_feature
        h.max_num_bin = src.max_num_bin
        md = Metadata(len(idx))
        md.set_label(np.asarray(src.metadata.label)[idx])
        if src.metadata.weights is not None:
            md.set_weights(np.asarray(src.metadata.weights)[idx])
        if src.metadata.init_score is not None:
            isc = np.asarray(src.metadata.init_score).reshape(
                -1, src.metadata.num_data)
            md.set_init_score(isc[:, idx].reshape(-1))
        if src.metadata.query_boundaries is not None:
            # group sizes from the subset rows' query ids (runs of equal
            # ids; folds that keep queries whole rebuild the groups)
            qb = np.asarray(src.metadata.query_boundaries)
            qid = np.searchsorted(qb, idx, side="right") - 1
            change = np.concatenate([[True], qid[1:] != qid[:-1]])
            starts = np.flatnonzero(change)
            md.set_group(np.diff(np.concatenate([starts, [len(idx)]])))
        h.metadata = md
        sub._handle = h
        return sub


class _FevalDataset:
    """What a custom ``feval`` receives: the evaluated data's labels,
    weights and groups (like the reference's Dataset)."""

    def __init__(self, binned: BinnedDataset):
        self._b = binned

    def get_label(self):
        return np.asarray(self._b.metadata.label)

    def get_weight(self):
        w = self._b.metadata.weights
        return None if w is None else np.asarray(w)

    def get_group(self):
        qb = self._b.metadata.query_boundaries
        return None if qb is None else np.diff(qb)


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
        self._train_set = train_set
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
            self._load(model_str)
        else:
            raise LightGBMError(
                "Booster needs train_set, model_file or model_str")

    def _load(self, model_str: str) -> None:
        """A prediction-only model from its text; its device is resolved
        at its first device predict (:meth:`_device`)."""
        self.inner = GBDT(self.config)
        self.inner.load_model_from_string(model_str)

    def _device(self):
        """The booster's device: the training device, or, for a model
        loaded from text, ``resolve_device(config)`` (the card unless the
        params ask for the CPU)."""
        if self.inner.device is None:
            self.inner.device = resolve_device(self.config)
        return self.inner.device

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self.inner.add_valid_data(data.handle)
        self._valid_names.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when training should stop.
        ``fobj(preds, train_set) -> (grad, hess)`` is a custom objective
        (reference: basic.py:264; preds are the f32 training scores,
        [N] or [N, K], and grad/hess N or K * N class-major values)."""
        if train_set is not None and train_set is not self._train_set:
            log.fatal("Booster.update takes the Booster's own training "
                      "set; make a new Booster for other data")
        if fobj is None:
            return self.inner.train_one_iter()
        preds = self.inner.train_score.cpu().numpy().squeeze()
        grad, hess = fobj(preds, self._train_set)
        return self.inner.train_one_iter(np.asarray(grad), np.asarray(hess))

    def rollback_one_iter(self) -> "Booster":
        self.inner.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """New parameters between iterations (reference:
        Booster.reset_parameter -> GBDT::ResetConfig): the learning
        rate, bagging, the split parameters and the depth limit take
        effect at the next tree."""
        self.params.update(params)
        self.config = Config.from_params(self.params)
        self.inner.reset_config(self.config)
        return self

    @property
    def current_iteration(self) -> int:
        return self.inner.current_iteration

    def num_trees(self) -> int:
        return len(self.inner.models)

    def num_model_per_iteration(self) -> int:
        return self.inner.num_tree_per_iteration

    # ------------------------------------------------------------------
    def eval_train(self, feval=None) -> List[Tuple]:
        inner = self.inner
        if not inner.train_metrics:
            for mname in resolve_metric_names(inner.config,
                                              inner.config.objective):
                m = create_metric(mname, inner.config)
                if m is not None:
                    m.init(inner.train_data.metadata, inner.num_data)
                    inner.train_metrics.append(m)
        score = inner.train_score.cpu().numpy().astype(np.float64)
        return self._eval("training", inner.train_metrics, score,
                          inner.train_data, feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out = []
        for i, vd in enumerate(self.inner.valid_data):
            name = (self._valid_names[i] if i < len(self._valid_names)
                    else "valid_%d" % i)
            out.extend(self._eval(name, vd.metrics, vd.scores, vd.dataset,
                                  feval))
        return out

    def _eval(self, name: str, metrics, score: np.ndarray,
              data: BinnedDataset, feval=None) -> List[Tuple]:
        """(data name, metric name, value, is_higher_better) of every
        value of every metric, then of every ``feval(preds, data)``;
        ``score`` is [n, K] (a single column is passed on as [n])."""
        if score.shape[1] == 1:
            score = score[:, 0]
        out = [(name, mname, v, m.factor_to_bigger_better > 0)
               for m in metrics
               for mname, v in zip(m.name,
                                   m.eval(score, self.inner.objective))]
        for fe in (feval if isinstance(feval, (list, tuple))
                   else [feval] if feval is not None else []):
            res = fe(score, _FevalDataset(data))
            for mname, v, is_higher in ([res] if isinstance(res, tuple)
                                        else res):
                out.append((name, mname, v, is_higher))
        return out

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Predictions of ``data`` (reference: basic.py:375). On the
        card, batches of 256 rows or more go through the stacked forest
        (:meth:`_predict_stacked`), the others through the host walk;
        ``predict_on_device=True`` / ``False`` forces one of them.
        ``pred_early_stop*`` apply to the host walk."""
        X = _to_2d_float(data)
        n_feat = self.inner.max_feature_idx + 1
        no_check = bool(kwargs.get("predict_disable_shape_check",
                                   self.config.predict_disable_shape_check))
        if X.shape[1] != n_feat and not no_check:
            raise ValueError(
                "The number of features in data (%d) is not the same as "
                "it was in training data (%d). You can set "
                "predict_disable_shape_check=true to discard this "
                "error, but please be aware what you are doing."
                % (X.shape[1], n_feat))
        if pred_contrib:
            log.unsupported("predict(pred_contrib=True) (SHAP values)",
                            "item 18b")
        ni = -1 if num_iteration is None else int(num_iteration)
        if ni <= 0 and self.best_iteration > 0:
            ni = self.best_iteration
        kind = ("leaf" if pred_leaf else
                "raw" if raw_score or self.inner.objective is None
                else "value")
        out = self._predict_stacked(X, start_iteration, ni, kind, kwargs)
        if out is not None:
            return out
        if pred_leaf:
            return self.inner.predict_leaf_index(X, start_iteration, ni)
        return self.inner.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=ni,
            pred_early_stop=kwargs.get("pred_early_stop"),
            pred_early_stop_freq=kwargs.get("pred_early_stop_freq"),
            pred_early_stop_margin=kwargs.get("pred_early_stop_margin"))

    # batches below this take the host walk in auto mode
    _kDeviceMinRows = 256

    @staticmethod
    def _decline(reason: str) -> None:
        """The stacked path was asked for (or chosen) and cannot run:
        say so, never quietly (reference: the ``perf_warning`` event of
        ``_host_walk_warning``; the event log is ROADMAP item 23)."""
        log.warning("predict on the device declined to the host walk: %s"
                    % reason)

    def _predict_stacked(self, X: np.ndarray, start_iteration: int,
                         num_iteration: int, kind: str,
                         kwargs: Dict) -> Optional[np.ndarray]:
        """One pass of the stacked forest on the booster's device
        (reference: basic.py:427), through a ``BucketedPredictor`` kept
        until the model slice or its leaf values change. Returns None
        for the host walk: when ``predict_on_device`` is False; in auto
        mode when ``config.predict_on_device`` is off, the batch has
        fewer than 256 rows or the booster's device is not ``cuda``; and,
        with a warning, when the stacked path cannot give the host
        walk's bytes (``pred_early_stop``, a feature-count mismatch, a
        model that cannot stack)."""
        forced = kwargs.get("predict_on_device")
        if forced is not None and not forced:
            return None
        if forced is None and (not self.config.predict_on_device
                               or X.shape[0] < self._kDeviceMinRows
                               or self._device().type != "cuda"):
            return None
        if kind != "leaf" and kwargs.get("pred_early_stop",
                                         self.config.pred_early_stop):
            self._decline("pred_early_stop is a host-loop contract")
            return None
        inner = self.inner
        models = inner._used_models(start_iteration, num_iteration)
        if not models:
            return None
        if X.shape[1] != inner.max_feature_idx + 1:
            self._decline("feature count %d != the model's %d"
                          % (X.shape[1], inner.max_feature_idx + 1))
            return None
        # keyed on the leaf values' bytes, not on object identity: leaf
        # values can change in place
        fp = hashlib.blake2b(digest_size=8)
        for t in models:
            fp.update(t.leaf_value[:t.num_leaves].tobytes())
        key = (len(inner.models), fp.hexdigest(), start_iteration,
               num_iteration)
        cached = getattr(self, "_stacked_cache", None)
        if cached is None or cached[0] != key:
            from .serve import BucketedPredictor, StackedForest
            try:
                forest = StackedForest.from_gbdt(inner, start_iteration,
                                                 num_iteration)
            except ValueError as e:
                self._stacked_cache = (key, None, str(e))
            else:
                self._stacked_cache = (key, BucketedPredictor(
                    forest.place(self._device()), model_version=key), None)
            cached = self._stacked_cache
        if cached[1] is None:
            self._decline("the model cannot stack: %s" % cached[2])
            return None
        return cached[1].predict(X, output_kind=kind)

    # ------------------------------------------------------------------
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

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> dict:
        """The model as a JSON-serializable dict (reference:
        Booster.dump_model -> GBDT::DumpModel)."""
        if num_iteration is None:
            num_iteration = self.best_iteration
        ni = int(num_iteration) if num_iteration > 0 else -1
        return self.inner.dump_model(start_iteration, ni, importance_type)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        return self.inner.feature_importance(
            importance_type, -1 if iteration is None else iteration)

    def feature_name(self) -> List[str]:
        return list(self.inner.feature_names)

    def num_feature(self) -> int:
        return self.inner.max_feature_idx + 1

    # pickled through the model text (reference: basic.py:582-601)
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_model_str"] = self.model_to_string(num_iteration=-1)
        for k in ("inner", "_train_set", "_stacked_cache"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        model_str = state.pop("_model_str")
        self.__dict__.update(state)
        self._train_set = None
        self._load(model_str)
