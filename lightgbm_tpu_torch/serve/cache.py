"""Row-bucketed dispatch of stacked-forest prediction.

Port of ``lightgbm_tpu/serve/cache.py``. Batches are padded with zero
rows up to a power-of-two row bucket (``min_bucket`` .. ``max_bucket``),
dispatched, and the pad is sliced off; larger batches stream through in
``max_bucket`` chunks (``dd_chunk_rows`` for double-double batches, whose
quantizer broadcasts a [rows, used features, thresholds] compare). So a
model version sees at most ``log2(max_bucket / min_bucket) + 1`` shapes
per output kind. The reference pads for XLA's compile cache; here every
dispatch runs eagerly, and the buckets keep the shapes a later captured
CUDA graph per bucket would need.

``entries`` counts dispatches per ``(model_version, bucket, kind[,
"dd"])``. The metrics registry counts dispatches to a key seen before
(``serve/bucket_hit``) and to a new one (``serve/bucket_compile``: the
JAX package's compile of a new shape), and gauges the key count
(``serve/compile_cache_size``). An optional
:class:`~lightgbm_tpu_torch.obs.quality.QualityMonitor` adds each
dispatched chunk to its drift window on the forest's device.

A server with several replicas passes one ``entries`` dict and one
``entries_lock`` to every replica's predictor, so the fleet keeps one
bucket policy (reference ``server.py:565-584``); a swap purges only the
versions that no replica serves any more (``keep_versions``).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..obs.registry import registry as obs
from ..utils import locktrace, next_pow2
from .forest import StackedForest, f32_exact

_KINDS = ("value", "raw", "leaf", "raw_device")

# the dd quantizer's lexicographic pair count broadcasts an
# [rows, used features, thresholds] boolean compare before it reduces:
# dd chunks stay at most this many rows, and at most kDDCompareCap
# compare elements (4096 rows of 28 used features with 256 thresholds
# each, a max_bin 255 model's), so it stays tens of MB; a wide-bin
# model, with up to max_bin thresholds per feature, takes shorter chunks
kDDBucketCap = 4096
kDDCompareCap = kDDBucketCap * 28 * 256


def dd_chunk_rows(forest) -> int:
    """Rows per double-double chunk of ``forest``: a power of two, at
    most kDDBucketCap, whose compare holds at most kDDCompareCap
    elements (at least one row)."""
    used, most = forest._qt_dd.thr_hi.shape
    rows = max(kDDCompareCap // max(used * most, 1), 1)
    return min(kDDBucketCap, 1 << (rows.bit_length() - 1))


class BucketedPredictor:
    """Pads batches to power-of-two row buckets around a StackedForest;
    ``swap`` replaces the forest (the bucket policy and counts stay).
    Pass a shared ``entries`` dict (and its ``entries_lock``) to make
    several predictors, one per replica, share one bucket policy.
    ``pinned`` stages rows through pinned memory on the card (a
    server's dispatches; see ``StackedForest._to_device``)."""

    def __init__(self, forest: StackedForest, model_version=0,
                 min_bucket: int = 16, max_bucket: int = 1 << 16,
                 output_kind: str = "value",
                 entries: Optional[Dict[Tuple, int]] = None,
                 entries_lock=None, quality=None, pinned: bool = False):
        if output_kind not in _KINDS:
            raise ValueError("output_kind must be one of %s" % (_KINDS,))
        self.forest = forest
        self.model_version = model_version
        self.min_bucket = max(int(min_bucket), 1)
        self.max_bucket = max(int(max_bucket), self.min_bucket)
        self.output_kind = output_kind
        self.pinned = bool(pinned)
        # an obs.quality.QualityMonitor: each dispatched chunk also adds
        # one scatter-add into its drift window on the device
        self.quality = quality
        # (model_version, bucket, kind[, "dd"]) -> dispatch count; shared
        # by a server's replicas together with one lock, since insert,
        # increment and purge are read-modify-writes
        self.entries: Dict[Tuple, int] = \
            entries if entries is not None else {}
        self._entries_lock = (entries_lock if entries_lock is not None
                              else threading.Lock())
        locktrace.maybe_trace(self)

    def swap(self, forest: StackedForest, model_version,
             keep_versions=None) -> None:
        """Serve ``forest`` as ``model_version`` from now on. The keys of
        versions outside ``keep_versions`` (by default only the new
        version) leave ``entries`` in place: a server with replicas
        passes the versions its other replicas still serve (a canary
        keeps replica 0 on another version than the rest), so a swap
        never drops a sibling's keys."""
        self.forest = forest
        self.model_version = model_version
        keep = set(keep_versions) if keep_versions is not None else set()
        keep.add(model_version)
        with self._entries_lock:
            for k in [k for k in self.entries if k[0] not in keep]:
                self.entries.pop(k, None)
            size = len(self.entries)
        obs.gauge("serve/compile_cache_size", size)

    def bucket_for(self, n_rows: int) -> int:
        return min(next_pow2(max(n_rows, self.min_bucket)),
                   self.max_bucket)

    # ------------------------------------------------------------------
    def _dispatch(self, kind: str, X: np.ndarray, dd: bool):
        # the dd decision was made once for the whole batch and is passed
        # down, so a chunk whose rows happen to be f32-exact runs the
        # program its bucket key names
        pinned = self.pinned
        if kind == "value":
            return self.forest.predict(X, dd=dd, pinned=pinned)
        if kind == "raw":
            return self.forest.predict_raw(X, dd=dd, pinned=pinned)
        if kind == "leaf":
            return self.forest.leaves(X, dd=dd, pinned=pinned)
        return self.forest._to_host(
            self.forest.predict_raw_device(X, dd=dd, pinned=pinned))

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
        max_chunk = (min(self.max_bucket, dd_chunk_rows(self.forest)) if dd
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
            with self._entries_lock:
                fresh = key not in self.entries
                self.entries[key] = self.entries.get(key, 0) + 1
                size = len(self.entries)
            if fresh:
                obs.inc("serve/bucket_compile")
                obs.gauge("serve/compile_cache_size", size)
            else:
                obs.inc("serve/bucket_hit")
            if self.quality is not None:
                self.quality.accumulate(chunk, m,
                                        device=self.forest._device)
            outs.append(self._dispatch(kind, chunk, dd)[:m])
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    @property
    def stats(self) -> Dict:
        return {"entries": dict(self.entries),
                "hits": obs.count("serve/bucket_hit"),
                "compiles": obs.count("serve/bucket_compile")}
