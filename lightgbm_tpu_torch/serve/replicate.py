"""Replication for serving: per-device placement and a row-sharded
dispatch over every replica device.

Port of ``lightgbm_tpu/serve/replicate.py``.

- **Replica placement** (what PredictServer uses): ``ReplicatedForest``
  places one ``StackedForest``'s tensors on every device
  (``StackedForest.place``, cached per device) and per-replica dispatch
  workers drain one admission queue.
- **Row-sharded dispatch**: ``predict_raw_sharded`` pads the rows to a
  bucket that divides evenly across the D devices
  (:func:`sharded_bucket`), cuts it into D equal row blocks, walks each
  block on its own device and concatenates the results in device order.

Per-row traversal is independent, so the sharded result is
bit-identical to one device's ``predict_raw_device`` (pinned in
``tests/test_torch_serve_fleet.py``).

The JAX package's ``compile_predict_with_plan`` builds one jit/pjit
(or ``shard_map``) program over a device mesh; eager PyTorch has no
compiled program to build, so it has no counterpart here: the blocks
are dispatched one per device, each on its device's current stream.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..utils import next_pow2
from .forest import StackedForest


def sharded_bucket(n_rows: int, n_devices: int,
                   min_bucket: int = 16) -> int:
    """Padded row count for a sharded dispatch: the power-of-two bucket
    rounded UP to a multiple of the device count, so the rows always
    divide evenly across the devices (a bare power of two does not for
    3 or 6 devices)."""
    D = max(int(n_devices), 1)
    bucket = max(next_pow2(max(n_rows, 1)), next_pow2(min_bucket))
    return ((bucket + D - 1) // D) * D


class ReplicatedForest:
    """One ``StackedForest`` across a list of devices.

    ``replica(k)`` returns the forest placed on device k (the
    PredictServer workers' view); ``predict_raw_sharded`` splits one
    padded batch's rows across all of them. ``devices`` defaults to
    every visible card."""

    def __init__(self, forest: StackedForest,
                 devices: Optional[Sequence] = None):
        self.base = forest
        if not devices:
            from ..utils.log import LightGBMError
            if not torch.cuda.is_available():
                raise LightGBMError("ReplicatedForest: no CUDA device is "
                                    "visible; pass devices=['cpu', ...] "
                                    "to replicate on the CPU")
            devices = ["cuda:%d" % k
                       for k in range(torch.cuda.device_count())]
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]

    @property
    def num_replicas(self) -> int:
        return len(self.devices)

    def replica(self, k: int) -> StackedForest:
        """The forest placed on device ``k`` (cached per device)."""
        return self.base.place(self.devices[k % len(self.devices)])

    def predict_raw_sharded(self, X, min_bucket: int = 16) -> np.ndarray:
        """[n, K] f32 raw scores: the rows padded to
        :func:`sharded_bucket`, one equal block per device through its
        replica's ``predict_raw_device``, concatenated (bit-identical to
        one device's ``predict_raw_device`` of the same rows)."""
        D = self.num_replicas
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        X = np.ascontiguousarray(X, dtype=np.float32)
        n = X.shape[0]
        bucket = sharded_bucket(n, D, min_bucket)
        if n < bucket:
            X = np.concatenate(
                [X, np.zeros((bucket - n, X.shape[1]), X.dtype)], axis=0)
        block = bucket // D
        # launch every block before reading any back, so the devices
        # walk their blocks at the same time
        outs = [self.replica(k).predict_raw_device(
            X[k * block:(k + 1) * block], dd=False) for k in range(D)]
        host = [self.replica(k)._to_host(o) for k, o in enumerate(outs)]
        return np.concatenate(host, axis=0)[:n]
