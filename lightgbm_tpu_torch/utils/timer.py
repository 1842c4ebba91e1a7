"""The stage timer under its old name.

Port of ``lightgbm_tpu/utils/timer.py``: the ``Timer`` / ``global_timer``
API (reference: ``Common::Timer`` / ``FunctionTimer``,
include/LightGBM/utils/common.h:973,1037) is the metrics registry's
stage timer, :mod:`lightgbm_tpu_torch.obs.registry`. ``global_timer``
here IS the registry's timer: enabling or printing through either name
observes the same aggregation.
"""
from __future__ import annotations

from ..obs.registry import (StageTimer as Timer,  # noqa: F401
                            registry, start_device_trace,
                            stop_device_trace)

global_timer = registry.timer
