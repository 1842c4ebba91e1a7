"""scikit-learn estimator wrappers.

Port of ``lightgbm_tpu/sklearn.py`` (API after the reference's
python-package/lightgbm/sklearn.py: ``LGBMModel`` :364,
``LGBMRegressor`` :989, ``LGBMClassifier`` :1035, ``LGBMRanker``
:1212). ``fit`` maps the estimator's parameters onto ``lgb.train``'s
and trains on ``device_type`` (``cuda`` unless a ``device_type="cpu"``
keyword asks for the CPU; such keywords ride in ``**kwargs`` and
survive ``get_params`` and ``clone``). scikit-learn is optional: without
it the estimators have plain bases.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config
from .engine import train as _train
from .objective import create_objective

# Inherit scikit-learn's bases when available so the estimators carry
# proper tags/clone semantics and pass sklearn's conformance machinery
# (reference: python-package/lightgbm/compat.py _LGBMModelBase — the
# reference's estimators do exactly this behind a compat shim).
try:  # pragma: no cover - import guard
    from sklearn.base import (BaseEstimator as _LGBMModelBase,
                              ClassifierMixin as _LGBMClassifierBase,
                              RegressorMixin as _LGBMRegressorBase)
except ImportError:  # pragma: no cover
    class _LGBMModelBase:  # type: ignore
        pass

    class _LGBMClassifierBase:  # type: ignore
        pass

    class _LGBMRegressorBase:  # type: ignore
        pass


class LGBMModel(_LGBMModelBase):
    """Base estimator (reference: sklearn.py:364)."""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: int = -1, importance_type: str = "split",
                 **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        # sklearn contract: __init__ sets ONLY parameters; fitted state
        # appears in fit() (check_no_attributes_set_in_init)
        self._other_params = dict(kwargs)

    # underscore-prefixed state created lazily (not in __init__)
    _Booster: Optional[Booster] = None
    _evals_result: Optional[Dict] = None
    _best_iteration = -1

    def __sklearn_tags__(self):
        """reference: sklearn.py LGBMModel._more_tags — NaN is a
        first-class missing value and scipy sparse inputs are accepted
        (binned via the sparse-until-binning path)."""
        tags = super().__sklearn_tags__()
        tags.input_tags.allow_nan = True
        tags.input_tags.sparse = True
        tags.non_deterministic = False
        return tags

    # ------------------------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {
            "boosting_type": self.boosting_type,
            "num_leaves": self.num_leaves, "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "n_estimators": self.n_estimators,
            "subsample_for_bin": self.subsample_for_bin,
            "objective": self.objective,
            "class_weight": self.class_weight,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "subsample": self.subsample,
            "subsample_freq": self.subsample_freq,
            "colsample_bytree": self.colsample_bytree,
            "reg_alpha": self.reg_alpha, "reg_lambda": self.reg_lambda,
            "random_state": self.random_state, "n_jobs": self.n_jobs,
            "importance_type": self.importance_type,
        }
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    # ------------------------------------------------------------------
    def _default_objective(self) -> str:
        return "regression"

    def _process_params(self) -> Dict[str, Any]:
        params = self.get_params()
        params.pop("importance_type", None)
        params.pop("n_estimators", None)
        params.pop("class_weight", None)
        # fit-time overrides (e.g. multiclass promotion) live outside the
        # constructor params so fit never mutates them
        # (check_estimators_overwrite_params)
        override = dict(getattr(self, "_fit_params_override", {}) or {})
        objective = params.pop("objective", None)
        ov_obj = override.pop("objective", None)
        if ov_obj is not None:
            # fit-time promotion (e.g. >2 classes -> multiclass) WINS
            # over the constructor objective, matching the pre-override
            # behavior of forcing multiclass
            objective = ov_obj
        elif objective is None:
            objective = self._default_objective()
        params["objective"] = objective
        params.update(override)
        params["boosting"] = params.pop("boosting_type", "gbdt")
        if params.get("random_state") is None:
            params.pop("random_state", None)
        else:
            params["seed"] = params.pop("random_state")
        params.pop("n_jobs", None)
        params.pop("silent", None)
        params.setdefault("verbosity", -1)
        return params

    @staticmethod
    def _validate_fit_input(X, y, sample_weight=None):
        """Input sanity errors sklearn's conformance machinery expects
        (ValueError on empty / complex / NaN-y / mismatched data)."""
        if y is None:
            raise ValueError(
                "This estimator requires y to be passed, but the "
                "target y is None")
        shape = getattr(X, "shape", None)
        if shape is None:
            X = np.asarray(X)
            shape = X.shape
        if len(shape) != 2:
            raise ValueError(
                "Expected 2D array, got array with shape %s instead"
                % (tuple(shape),))
        if shape[1] == 0:
            raise ValueError(
                "0 feature(s) (shape=(%d, 0)) while a minimum of 1 is "
                "required." % shape[0])
        if shape[0] == 0:
            raise ValueError(
                "0 sample(s) (shape=(0, %d)) while a minimum of 1 is "
                "required." % shape[1])
        if shape[0] == 1:
            raise ValueError(
                "Cannot fit a GBDT on 1 sample; at least 2 samples are "
                "required")
        if np.iscomplexobj(X) or np.iscomplexobj(np.asarray(y)):
            raise ValueError("Complex data not supported")
        y_arr = np.asarray(y)
        if y_arr.dtype.kind not in ("U", "S", "O", "b"):
            # numeric targets must be finite (string/object labels are
            # the classifier's to encode)
            y_num = y_arr.astype(np.float64)
            if not np.all(np.isfinite(y_num)):
                raise ValueError(
                    "Input y contains NaN, infinity or a value too "
                    "large")
        if y_arr.shape[0] != shape[0]:
            raise ValueError(
                "Found input variables with inconsistent numbers of "
                "samples: [%d, %d]" % (shape[0], y_arr.shape[0]))
        if sample_weight is not None:
            w = np.asarray(sample_weight)
            if w.ndim != 1 or w.shape[0] != shape[0]:
                raise ValueError(
                    "sample_weight.shape == %s, expected (%d,)"
                    % (w.shape, shape[0]))
            if w.shape[0] > 0 and not np.any(w > 0):
                raise ValueError(
                    "No training samples: all sample_weight values are "
                    "zero or negative")

    @staticmethod
    def _ensure_1d_y(y):
        """Column-vector y → 1-D with sklearn's conversion warning
        (check_supervised_y_2d contract)."""
        if y is None:
            return None  # the validator raises the requires-y error
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            import warnings
            try:
                from sklearn.exceptions import DataConversionWarning
            except ImportError:  # pragma: no cover
                DataConversionWarning = UserWarning
            warnings.warn(
                "A column-vector y was passed when a 1d array was "
                "expected. Please change the shape of y to "
                "(n_samples,), for example using ravel().",
                DataConversionWarning)
            y = y.ravel()
        return y

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            feature_name="auto", categorical_feature="auto",
            callbacks=None) -> "LGBMModel":
        y = self._ensure_1d_y(y)
        self._validate_fit_input(X, y, sample_weight)
        params = self._process_params()
        feval = None
        if eval_metric is not None:
            metrics = (eval_metric if isinstance(eval_metric, (list, tuple))
                       else [eval_metric])
            str_metrics = [m for m in metrics if isinstance(m, str)]
            fn_metrics = [m for m in metrics if callable(m)]
            if str_metrics:
                params["metric"] = str_metrics
            if fn_metrics:
                # sklearn-style callables take (y_true, y_pred)
                # (reference: sklearn.py _EvalFunctionWrapper); adapt to
                # the engine's feval(preds, eval_data) contract. For
                # built-in objectives the reference hands the callable
                # TRANSFORMED predictions (probabilities), raw margins
                # only under a custom objective — mirror that.
                transform = None
                if not callable(params.get("objective")):
                    cfg = Config.from_params(params)
                    if cfg.objective != "custom":
                        transform = create_objective(
                            cfg.objective, cfg).convert_output

                def _wrap(fn):
                    def feval_fn(preds, ds):
                        p = transform(preds) if transform is not None \
                            else preds
                        return fn(ds.get_label(), p)
                    return feval_fn
                feval = [_wrap(f) for f in fn_metrics]
        if self.class_weight is not None:
            sample_weight = _apply_class_weight(
                self.class_weight, y, sample_weight)
        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature)
        valid_sets = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vw = (eval_sample_weight[i]
                      if eval_sample_weight else None)
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(Dataset(
                    vx, label=vy, weight=vw, group=vg, init_score=vi,
                    reference=train_set, params=params))
        self._evals_result = {}
        callbacks = list(callbacks or [])
        if valid_sets:
            callbacks.append(
                callback_mod.record_evaluation(self._evals_result))
        self._Booster = _train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets, valid_names=eval_names,
            feval=feval, callbacks=callbacks)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = train_set.num_feature()
        self.n_features_in_ = self._n_features
        self.fitted_ = True
        return self

    # ------------------------------------------------------------------
    def predict(self, X, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        self._check_fitted()
        self._check_n_features(X)
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)

    def _check_fitted(self):
        if not getattr(self, "fitted_", False):
            try:
                from sklearn.exceptions import NotFittedError
            except ImportError:
                NotFittedError = ValueError
            raise NotFittedError(
                "Estimator not fitted, call fit before exploiting the "
                "model.")

    def _check_n_features(self, X):
        shape = getattr(X, "shape", None)
        if shape is None:
            shape = np.asarray(X).shape
        if len(shape) == 1:
            raise ValueError(
                "Expected 2D array, got 1D array instead. Reshape your "
                "data either using array.reshape(-1, 1) or "
                "array.reshape(1, -1).")
        n_in = getattr(self, "n_features_in_", None)
        if len(shape) == 2 and n_in is not None and shape[1] != n_in:
            raise ValueError(
                "X has %d features, but %s is expecting %d features as "
                "input" % (shape[1], type(self).__name__, n_in))

    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._best_iteration

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()


class LGBMRegressor(_LGBMRegressorBase, LGBMModel):
    """reference: sklearn.py:989."""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(_LGBMClassifierBase, LGBMModel):
    """reference: sklearn.py:1035."""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs):
        y = self._ensure_1d_y(y)
        self._validate_fit_input(X, y)
        y = np.asarray(y)
        if y.dtype.kind == "f" and not np.all(y == np.floor(y)):
            raise ValueError(
                "Unknown label type: continuous. Classification targets "
                "must be discrete")
        if y.dtype.kind == "O":
            # normalize MIXED-type object labels to strings so np.unique
            # + searchsorted order deterministically; homogeneous object
            # arrays (e.g. pandas int columns) keep their label type
            if len({type(v) for v in y}) > 1:
                y = y.astype(str)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        self._fit_params_override = {}
        if self._n_classes > 2:
            # promote string objectives to multiclass; custom callable
            # objectives keep supplying their own gradients
            if self.objective is None or (
                    isinstance(self.objective, str)
                    and self.objective not in ("multiclass",
                                               "multiclassova")):
                self._fit_params_override["objective"] = "multiclass"
            self._fit_params_override["num_class"] = self._n_classes
        y_enc = np.searchsorted(self._classes, y).astype(np.float64)
        super().fit(X, y_enc, **kwargs)
        return self

    def _default_objective_multiclass(self):
        return "multiclass"

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        result = self.predict_proba(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim > 1:
            idx = np.argmax(result, axis=1)
        else:
            idx = (result > 0.5).astype(int)
        return self._classes[idx]

    def predict_proba(self, X, raw_score: bool = False,
                      start_iteration: int = 0,
                      num_iteration: Optional[int] = None,
                      pred_leaf: bool = False, pred_contrib: bool = False,
                      **kwargs):
        self._check_fitted()
        self._check_n_features(X)
        result = self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            return np.vstack([1.0 - result, result]).T
        return result

    @property
    def classes_(self) -> np.ndarray:
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return self._n_classes


class LGBMRanker(LGBMModel):
    """reference: sklearn.py:1212."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)


def _apply_class_weight(class_weight, y, sample_weight):
    y = np.asarray(y)
    if class_weight == "balanced":
        classes, counts = np.unique(y, return_counts=True)
        weight_map = {c: len(y) / (len(classes) * cnt)
                      for c, cnt in zip(classes, counts)}
    elif isinstance(class_weight, dict):
        weight_map = class_weight
    else:
        raise ValueError("class_weight must be 'balanced' or a dict")
    cw = np.array([weight_map.get(v, 1.0) for v in y])
    if sample_weight is not None:
        cw = cw * np.asarray(sample_weight)
    return cw
