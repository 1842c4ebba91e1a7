"""Streaming / chunked dataset construction.

Port of ``lightgbm_tpu/io/streaming.py`` (reference: LGBM_DatasetInit
Streaming / LGBM_DatasetPushRowsWithMetadata, include/LightGBM/c_api.h:
176-299; ChunkedArray, include/LightGBM/utils/chunked_array.hpp): rows
arrive in chunks whose total may be unknown up front, their metadata
with them, and the binned dataset is made once, at ``finalize``. Chunks
are staged on the host in a :class:`ChunkedBuffer` (no copy of earlier
chunks on growth); ``finalize`` coalesces them and bins them with
``BinnedDataset.from_matrix``, so the bins are those of the same rows
given at once. With a ``spill_dir`` (optionally gated on
``spill_threshold_rows``), ``finalize`` bins chunk by chunk into
memory-mapped shards instead, with no f64 coalesce and the same mappers
(the known row count lets the sharded construction draw ``from_matrix``'s
own bin-construction sample), and returns a
:class:`~.shards.ShardedBinnedDataset`.
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
        self.config = Config.from_params(dict(params or {}))
        self.num_features = int(num_features)
        self._X = ChunkedBuffer(num_features, chunk_rows)
        self._label = ChunkedBuffer(1, chunk_rows)
        self._weight = ChunkedBuffer(1, chunk_rows) if has_weight else None
        self._init_score = (ChunkedBuffer(1, chunk_rows)
                            if has_init_score else None)
        self._group: Optional[List[int]] = [] if has_group else None
        self._finished = False
        # out-of-core routing (io/shards.py): with a spill_dir, finalize()
        # bins chunk by chunk into memory-mapped shards (the f64 rows are
        # never coalesced) and returns a ShardedBinnedDataset;
        # spill_threshold_rows gates it on size
        self.spill_dir = spill_dir
        self.spill_threshold_rows = spill_threshold_rows

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

    def _chunk_source(self):
        """Views of the pushed chunks as a re-iterable (X, y, w) chunk
        source for the sharded construction (the X and metadata buffers share
        ``chunk_rows``, so their chunks align row for row), and the row
        count."""
        n = len(self._X)
        has_label = bool(len(self._label))
        has_weight = self._weight is not None and bool(len(self._weight))
        if has_label and len(self._label) != n:
            log.fatal("pushed %d label values for %d rows"
                      % (len(self._label), n))
        if has_weight and len(self._weight) != n:
            log.fatal("pushed %d weight values for %d rows"
                      % (len(self._weight), n))

        def source():
            chunks = self._X._chunks
            for i, xc in enumerate(chunks):
                hi = (self._X._fill if i == len(chunks) - 1
                      else self._X.chunk_rows)
                y = self._label._chunks[i][:hi, 0] if has_label else None
                w = self._weight._chunks[i][:hi, 0] if has_weight else None
                yield xc[:hi], y, w
        return source, n

    def finalize(self, reference: Optional[BinnedDataset] = None,
                 spill_dir: Optional[str] = None,
                 shard_rows: Optional[int] = None, **kw):
        """Find the bin mappers and bin the pushed rows (reference:
        LGBM_DatasetMarkFinished -> FinishLoad): the coalesced rows
        through ``BinnedDataset.from_matrix`` (``kw`` goes to it), or,
        with a ``spill_dir`` (here or at construction) and at least
        ``spill_threshold_rows`` rows, through
        ``ShardedBinnedDataset.from_chunk_source`` into shards of
        ``shard_rows`` rows."""
        if self._finished:
            log.fatal("finalize() called twice")
        self._finished = True
        n = len(self._X)
        if n == 0:
            log.fatal("no rows pushed before finalize()")
        spill_dir = spill_dir if spill_dir is not None else self.spill_dir
        thr = self.spill_threshold_rows
        if spill_dir is not None and (thr is None or n >= thr):
            if reference is not None:
                log.fatal("sharded finalize cannot align to a "
                          "reference dataset")
            if self._init_score is not None and len(self._init_score):
                log.fatal("init_score is not supported on the sharded "
                          "spill path")
            if self._group:
                log.fatal("query groups are not supported on the "
                          "sharded spill path")
            if kw.get("keep_raw_data"):
                log.fatal("keep_raw_data/linear_tree needs the "
                          "coalesced matrix; not supported on the "
                          "sharded spill path")
            from .shards import ShardedBinnedDataset
            source, total = self._chunk_source()
            return ShardedBinnedDataset.from_chunk_source(
                source, self.config, spill_dir, shard_rows=shard_rows,
                feature_names=kw.get("feature_names"),
                categorical_feature=kw.get("categorical_feature"),
                total_rows=total)

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
