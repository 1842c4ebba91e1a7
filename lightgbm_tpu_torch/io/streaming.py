"""Streaming / chunked dataset construction.

Port of ``lightgbm_tpu/io/streaming.py`` (reference: LGBM_DatasetInit
Streaming / LGBM_DatasetPushRowsWithMetadata, include/LightGBM/c_api.h:
176-299; ChunkedArray, include/LightGBM/utils/chunked_array.hpp): rows
arrive in chunks whose total may be unknown up front, their metadata
with them, and the binned dataset is made once, at ``finalize``. Chunks
are staged on the host in a :class:`ChunkedBuffer` (no copy of earlier
chunks on growth); ``finalize`` coalesces them and bins them with
``BinnedDataset.from_matrix``, so the bins are those of the same rows
given at once. The out-of-core route (``spill_dir``,
``spill_threshold_rows``) is ROADMAP item 21 and raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .dataset import BinnedDataset


class ChunkedBuffer:
    """Append-only chunked 2-D float buffer (reference: ChunkedArray<T>:
    fixed chunks, O(1) append, one coalesce at the end)."""

    def __init__(self, num_cols: int, chunk_rows: int = 1 << 16,
                 dtype=np.float64):
        self.num_cols = int(num_cols)
        self.chunk_rows = int(chunk_rows)
        self.dtype = dtype
        self._chunks: List[np.ndarray] = []
        self._fill = 0  # rows used in the last chunk

    def __len__(self) -> int:
        if not self._chunks:
            return 0
        return (len(self._chunks) - 1) * self.chunk_rows + self._fill

    def append_rows(self, rows: np.ndarray) -> None:
        rows = np.atleast_2d(np.asarray(rows, dtype=self.dtype))
        if rows.shape[1] != self.num_cols:
            log.fatal("pushed chunk has %d columns, expected %d"
                      % (rows.shape[1], self.num_cols))
        pos, n = 0, rows.shape[0]
        while pos < n:
            if not self._chunks or self._fill == self.chunk_rows:
                self._chunks.append(np.empty(
                    (self.chunk_rows, self.num_cols), dtype=self.dtype))
                self._fill = 0
            take = min(n - pos, self.chunk_rows - self._fill)
            self._chunks[-1][self._fill:self._fill + take] = \
                rows[pos:pos + take]
            self._fill += take
            pos += take

    def coalesce(self) -> np.ndarray:
        """One contiguous [n, num_cols] array (reference:
        ChunkedArray::coalesce_to)."""
        if not self._chunks:
            return np.empty((0, self.num_cols), dtype=self.dtype)
        parts = self._chunks[:-1] + [self._chunks[-1][:self._fill]]
        return np.concatenate(parts, axis=0)


def _no_spill(spill_dir, spill_threshold_rows) -> None:
    if spill_dir is not None or spill_threshold_rows is not None:
        log.unsupported("StreamingDataset spill_dir / "
                        "spill_threshold_rows (out-of-core shards)",
                        "item 21")


class StreamingDataset:
    """Push-mode dataset construction (reference:
    LGBM_DatasetInitStreaming -> PushRows*WithMetadata ->
    LGBM_DatasetMarkFinished).

    >>> sd = StreamingDataset(num_features=28, params={...})
    >>> for chunk_X, chunk_y in stream:
    ...     sd.push_rows(chunk_X, label=chunk_y)
    >>> ds = sd.finalize()            # a BinnedDataset
    """

    def __init__(self, num_features: int,
                 params: Optional[dict] = None,
                 chunk_rows: int = 1 << 16,
                 has_weight: bool = False,
                 has_init_score: bool = False,
                 has_group: bool = False,
                 spill_dir: Optional[str] = None,
                 spill_threshold_rows: Optional[int] = None):
        _no_spill(spill_dir, spill_threshold_rows)
        self.config = Config.from_params(dict(params or {}))
        self.num_features = int(num_features)
        self._X = ChunkedBuffer(num_features, chunk_rows)
        self._label = ChunkedBuffer(1, chunk_rows)
        self._weight = ChunkedBuffer(1, chunk_rows) if has_weight else None
        self._init_score = (ChunkedBuffer(1, chunk_rows)
                            if has_init_score else None)
        self._group: Optional[List[int]] = [] if has_group else None
        self._finished = False

    @property
    def num_pushed(self) -> int:
        return len(self._X)

    def push_rows(self, X: np.ndarray,
                  label: Optional[Sequence[float]] = None,
                  weight: Optional[Sequence[float]] = None,
                  init_score: Optional[Sequence[float]] = None,
                  group: Optional[Sequence[int]] = None) -> None:
        """Append a chunk of rows and their metadata (reference:
        LGBM_DatasetPushRowsByCSRWithMetadata: the metadata comes with
        the rows)."""
        if self._finished:
            log.fatal("push_rows after finalize()")
        self._X.append_rows(np.atleast_2d(np.asarray(X, dtype=np.float64)))
        for what, values, buf in (("label", label, self._label),
                                  ("weight", weight, self._weight),
                                  ("init_score", init_score,
                                   self._init_score)):
            if values is None:
                continue
            if buf is None:
                log.fatal("%s pushed but has_%s=False" % (what, what))
            buf.append_rows(
                np.asarray(values, dtype=np.float64).reshape(-1, 1))
        if group is not None:
            if self._group is None:
                log.fatal("group pushed but has_group=False")
            self._group.extend(int(g) for g in np.atleast_1d(group))

    def finalize(self, reference: Optional[BinnedDataset] = None,
                 spill_dir: Optional[str] = None, **kw) -> BinnedDataset:
        """Find the bin mappers and bin the pushed rows (reference:
        LGBM_DatasetMarkFinished -> FinishLoad): the coalesced rows
        through ``BinnedDataset.from_matrix`` (``kw`` goes to it)."""
        _no_spill(spill_dir, None)
        if self._finished:
            log.fatal("finalize() called twice")
        self._finished = True
        n = len(self._X)
        if n == 0:
            log.fatal("no rows pushed before finalize()")

        def aligned(buf, what):
            if buf is None or not len(buf):
                return None
            vals = buf.coalesce()[:, 0]
            if len(vals) != n:
                log.fatal("pushed %d %s values for %d rows"
                          % (len(vals), what, n))
            return vals

        group = (np.asarray(self._group, dtype=np.int32)
                 if self._group else None)
        if group is not None and int(group.sum()) != n:
            log.fatal("pushed query sizes sum to %d for %d rows"
                      % (int(group.sum()), n))
        return BinnedDataset.from_matrix(
            self._X.coalesce(), self.config,
            label=aligned(self._label, "label"),
            weights=aligned(self._weight, "weight"),
            init_score=aligned(self._init_score, "init_score"),
            group=group, reference=reference, **kw)
