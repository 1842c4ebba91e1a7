"""A fixture that pins the SLO watchdog's thresholds to their defaults.

``lightgbm_tpu_torch/obs/health.py`` reads every threshold from a
``LIGHTGBM_TPU_WATCH_*`` environment variable when its rules are built.
A test that asserts which rules fire must not depend on what an earlier
test left in ``os.environ`` (some of the JAX package's tests set these
variables and never unset them), so a port test that builds a
``Watchdog`` or the default rules imports :func:`watch_env_defaults`,
which removes every such variable for the test's duration.
"""
import inspect
import re

import pytest

from lightgbm_tpu_torch.obs import health

#: every ``LIGHTGBM_TPU_WATCH_*`` name the port's health module reads
WATCH_ENV_NAMES = tuple(sorted(set(re.findall(
    r"LIGHTGBM_TPU_WATCH_[A-Z0-9_]+", inspect.getsource(health)))))


@pytest.fixture(autouse=True)
def watch_env_defaults(monkeypatch):
    for name in WATCH_ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    yield
