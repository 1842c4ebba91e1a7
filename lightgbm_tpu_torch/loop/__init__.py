"""Closed-loop continuous model refresh.

Port of ``lightgbm_tpu/loop``. ``RefreshController`` keeps a model fresh
under live traffic: stream a window through the spill path, train with
checkpoints, publish into a live :class:`~lightgbm_tpu_torch.serve.PredictServer`;
then, every cycle, re-attach the spill (no re-binning), resume training
from the newest checkpoint, refit leaf values on the newest window on the
booster's device (``Booster.refit``), and canary-publish the refreshed
model while generated traffic keeps flowing. The ``refresh_slo`` watchdog
rule (``obs/health.py``) and the unified chaos schedule (``loop/chaos.py``)
make the loop's reliability claims falsifiable every cycle. See
``docs/REFRESH.md``.
"""
from .chaos import (ChaosLeg, SERVE_SITES, TRAIN_SITES,  # noqa: F401
                    expected_rollbacks, refresh_schedule,
                    validate_schedule)
from .controller import RefreshController, TrafficGenerator  # noqa: F401

__all__ = ["RefreshController", "TrafficGenerator", "ChaosLeg",
           "refresh_schedule", "expected_rollbacks",
           "validate_schedule", "TRAIN_SITES", "SERVE_SITES"]
