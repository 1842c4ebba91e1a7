"""Objective function factory (port of ``lightgbm_tpu/objective``).

Every objective of the reference's ``_OBJECTIVES`` table (reference:
src/objective/objective_function.cpp:69-104). A custom objective (a
Python callable passed as ``objective``, with ``objective=none`` in the
config) has no object here: its gradients reach
``GBDT.train_one_iter`` from ``Booster.update(fobj=...)``.
"""
from __future__ import annotations

import dataclasses

from ..utils import log
from .base import ObjectiveFunction, weighted_percentile
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (RegressionFair, RegressionGamma, RegressionHuber,
                         RegressionL1, RegressionL2, RegressionMAPE,
                         RegressionPoisson, RegressionQuantile,
                         RegressionTweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}

#: model-file parameters of an objective line (``multiclass num_class:7``,
#: ``quantile alpha:0.9``) and their types
_STRING_PARAMS = {"sigmoid": float, "num_class": int, "alpha": float}


def create_objective(name: str, config) -> ObjectiveFunction:
    if name == "custom":
        log.fatal("objective=none has no objective object: its gradients "
                  "come from a callable objective (Booster.update(fobj=...)"
                  "; ROADMAP item 18a)")
    if name not in _OBJECTIVES:
        log.fatal("Unknown objective type name: %s" % name)
    return _OBJECTIVES[name](config)


def load_objective_from_string(s: str, config) -> ObjectiveFunction:
    """Re-create an objective from its model-file line, e.g.
    ``binary sigmoid:1``, ``multiclass num_class:7`` or
    ``regression sqrt``."""
    parts = s.strip().split()
    name = parts[0] if parts else ""
    kv = {}
    for tok in parts[1:]:
        k, _, v = tok.partition(":")
        kv[k] = v if v else True
    changes = {k: typ(kv[k]) for k, typ in _STRING_PARAMS.items()
               if k in kv}
    if name == "regression" and kv.get("sqrt"):
        changes["reg_sqrt"] = True
    return create_objective(name, dataclasses.replace(config, **changes))


__all__ = ["ObjectiveFunction", "create_objective",
           "load_objective_from_string", "weighted_percentile",
           "BinaryLogloss", "MulticlassSoftmax", "MulticlassOVA",
           "LambdarankNDCG", "RankXENDCG", "RegressionL2", "RegressionL1",
           "RegressionHuber", "RegressionFair", "RegressionPoisson",
           "RegressionQuantile", "RegressionMAPE", "RegressionGamma",
           "RegressionTweedie", "CrossEntropy", "CrossEntropyLambda"]
