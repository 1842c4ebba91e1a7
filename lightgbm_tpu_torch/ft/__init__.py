"""Fault-tolerant training plane.

Port of ``lightgbm_tpu/ft``. A production run measured in hours must be
restartable by construction: a SIGKILL, an OOM kill or a preempted host
must cost at most one checkpoint interval, never the run.

- :mod:`checkpoint` — atomically finalized checkpoint directories
  capturing the FULL resume state (trees, iteration and early-stop
  bookkeeping, every RNG sequence position, the training scores bit
  for bit), wired into ``lgb.train(checkpoint_dir=, checkpoint_freq=,
  resume=True)`` and ``GBDT.save_checkpoint`` / ``load_checkpoint``.

Its failure-path siblings live where their call sites are:
``utils/retry.py`` (bounded seeded retry/backoff) and ``obs/faults.py``
(deterministic fault injection).
"""
from . import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
