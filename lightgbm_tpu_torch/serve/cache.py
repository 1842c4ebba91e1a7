"""Row-bucketed dispatch of stacked-forest prediction.

Port of ``lightgbm_tpu/serve/cache.py``. Batches are padded with zero
rows up to a power-of-two row bucket (``min_bucket`` .. ``max_bucket``),
dispatched, and the pad is sliced off; larger batches stream through in
``max_bucket`` chunks (``kDDBucketCap`` for double-double batches, whose
quantizer broadcasts a [rows, used features, thresholds] compare). So a
model version sees at most ``log2(max_bucket / min_bucket) + 1`` shapes
per output kind. The reference pads for XLA's compile cache; here every
dispatch runs eagerly, and the buckets keep the shapes a later captured
CUDA graph per bucket would need.

``entries`` counts dispatches per ``(model_version, bucket, kind[,
"dd"])``; ``bucket_hits`` and ``bucket_new`` count dispatches to a key
seen before and to a new one (plain attributes: the metrics registry is
ROADMAP item 23).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from ..utils import next_pow2
from .forest import StackedForest, f32_exact

_KINDS = ("value", "raw", "leaf", "raw_device")

# the dd quantizer's lexicographic pair count broadcasts an
# [rows, used features, thresholds] boolean compare before it reduces:
# dd chunks stay at most this many rows, so it stays tens of MB
kDDBucketCap = 4096


class BucketedPredictor:
    """Pads batches to power-of-two row buckets around a StackedForest;
    ``swap`` replaces the forest (the bucket policy and counts stay)."""

    def __init__(self, forest: StackedForest, model_version=0,
                 min_bucket: int = 16, max_bucket: int = 1 << 16,
                 output_kind: str = "value"):
        if output_kind not in _KINDS:
            raise ValueError("output_kind must be one of %s" % (_KINDS,))
        self.forest = forest
        self.model_version = model_version
        self.min_bucket = max(int(min_bucket), 1)
        self.max_bucket = max(int(max_bucket), self.min_bucket)
        self.output_kind = output_kind
        self.entries: Dict[tuple, int] = {}
        self._lock = threading.Lock()
        self.bucket_hits = 0
        self.bucket_new = 0

    def swap(self, forest: StackedForest, model_version) -> None:
        """Serve ``forest`` as ``model_version`` from now on; the keys of
        other versions leave ``entries``."""
        self.forest = forest
        self.model_version = model_version
        with self._lock:
            for k in [k for k in self.entries if k[0] != model_version]:
                del self.entries[k]

    def bucket_for(self, n_rows: int) -> int:
        return min(next_pow2(max(n_rows, self.min_bucket)),
                   self.max_bucket)

    # ------------------------------------------------------------------
    def _dispatch(self, kind: str, X: np.ndarray, dd: bool):
        # the dd decision was made once for the whole batch and is passed
        # down, so a chunk whose rows happen to be f32-exact runs the
        # program its bucket key names
        if kind == "value":
            return self.forest.predict(X, dd=dd)
        if kind == "raw":
            return self.forest.predict_raw(X, dd=dd)
        if kind == "leaf":
            return self.forest.leaves(X, dd=dd)
        return self.forest._to_host(self.forest.predict_raw_device(X, dd=dd))

    def predict(self, X, output_kind: Optional[str] = None) -> np.ndarray:
        """Predict with bucket padding. f64 batches that the f32
        quantizer cannot hold exactly keep their dtype and run the
        double-double path (their own bucket keys); the rest are cast to
        f32, exactly."""
        kind = output_kind or self.output_kind
        if kind not in _KINDS:
            raise ValueError("output_kind must be one of %s" % (_KINDS,))
        X = np.asarray(X)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        dd = X.dtype == np.float64 and not f32_exact(X)
        if not dd:
            X = np.ascontiguousarray(X, dtype=np.float32)
        n = X.shape[0]
        max_chunk = (min(self.max_bucket, kDDBucketCap) if dd
                     else self.max_bucket)
        outs = []
        for lo in range(0, max(n, 1), max_chunk):
            chunk = X[lo:lo + max_chunk]
            m = chunk.shape[0]
            bucket = min(self.bucket_for(m), max_chunk)
            if m < bucket:
                pad = np.zeros((bucket - m, X.shape[1]), dtype=X.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            key = (self.model_version, bucket, kind) + (("dd",) if dd
                                                        else ())
            with self._lock:
                if key in self.entries:
                    self.bucket_hits += 1
                else:
                    self.bucket_new += 1
                self.entries[key] = self.entries.get(key, 0) + 1
            outs.append(self._dispatch(kind, chunk, dd)[:m])
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    @property
    def stats(self) -> Dict:
        return {"entries": dict(self.entries), "hits": self.bucket_hits,
                "new": self.bucket_new}
