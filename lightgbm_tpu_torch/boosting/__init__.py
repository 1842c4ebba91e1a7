"""Boosting layer: the GBDT, DART and RF boosting loops and the sampling
strategies (port of ``lightgbm_tpu/boosting``; reference
``Boosting::CreateBoosting``, include/LightGBM/boosting.h:314)."""
from __future__ import annotations

from ..utils import log
from .dart import DART
from .gbdt import GBDT
from .rf import RF


def create_boosting(config, train_data=None, device=None) -> GBDT:
    """``boosting`` in {gbdt, dart, rf} (the config resolves the aliases
    gbrt, random_forest and the legacy goss)."""
    name = config.boosting
    if name == "gbdt":
        return GBDT(config, train_data, device)
    if name == "dart":
        return DART(config, train_data, device)
    if name == "rf":
        return RF(config, train_data, device)
    log.fatal("Unknown boosting type %s" % name)


__all__ = ["GBDT", "DART", "RF", "create_boosting"]
