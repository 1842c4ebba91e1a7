"""Objective function factory (port of ``lightgbm_tpu/objective``).

This slice carries ``binary`` and ``regression`` (L2); the other
objectives are ROADMAP item 10 and raise.
"""
from __future__ import annotations

import dataclasses

from ..utils.log import unsupported
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .regression import RegressionL2

_OBJECTIVES = {"binary": BinaryLogloss, "regression": RegressionL2}


def create_objective(name: str, config) -> ObjectiveFunction:
    if name not in _OBJECTIVES:
        unsupported("objective=%s" % name, "item 10")
    return _OBJECTIVES[name](config)


def load_objective_from_string(s: str, config) -> ObjectiveFunction:
    """Re-create an objective from its model-file line, e.g.
    ``binary sigmoid:1`` or ``regression sqrt``."""
    parts = s.strip().split()
    name = parts[0] if parts else ""
    kv = {}
    for tok in parts[1:]:
        k, _, v = tok.partition(":")
        kv[k] = v if v else True
    cfg = config
    if "sigmoid" in kv:
        cfg = dataclasses.replace(cfg, sigmoid=float(kv["sigmoid"]))
    if name == "regression" and kv.get("sqrt"):
        cfg = dataclasses.replace(cfg, reg_sqrt=True)
    return create_objective(name, cfg)


__all__ = ["ObjectiveFunction", "BinaryLogloss", "RegressionL2",
           "create_objective", "load_objective_from_string"]
