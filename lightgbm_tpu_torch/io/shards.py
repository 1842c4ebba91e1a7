"""Out-of-core sharded data plane: stream-binned shards and device staging.

Port of ``lightgbm_tpu/io/shards.py``. Histograms are additive over row
blocks, so neither the raw matrix in host memory nor the binned matrix
on the card has to exist whole.

:class:`ShardedBinnedDataset` never holds the whole dataset on either
side of the PCIe link:

- **Construction** is two-pass and chunk-at-a-time. Pass 1 feeds chunks
  into a bounded row sample and finds the bin mappers on it (the same
  ``BinMapper.find_bin`` as the in-memory path). Pass 2 applies the
  mappers per chunk and spills each binned uint8/uint16 shard to a file
  loaded back memory-mapped, plus per-shard label/weight slices; the
  training-grid reference profile (``obs/quality.py``
  ``ProfileBuilder``) is counted from each shard as it spills. Peak host
  memory is O(chunk + sample), not O(dataset).
- **Training** stages one shard at a time into device memory.
  :class:`ShardPrefetcher` double-buffers: while shard *k* computes, a
  worker thread copies shard *k+1* from its memory map into a pinned
  host buffer and from there to the card with a non-blocking copy on a
  copy stream, recording an event the compute stream waits on (obs
  scope ``io::shard_stage``); the host never waits for a shard that is
  ready. Time the consumer spends blocked on a shard that is not staged
  yet lands on the ``io/prefetch_stall_ms`` counter that the
  ``prefetch_stall`` rule in ``obs/health.py`` reads.

The training side lives in ``treelearner/sharded.py``: per-leaf
histograms accumulate shard by shard through the histogram kernel (the
plain version on the CPU, continuing its row-order adds from the
running sums). Per-row O(1)-width state (scores, gradients, the
row->leaf partition) stays on the device: O(N) words where the bins
are O(N F) bytes.

On-disk layout under ``spill_dir`` (plain ``.npy`` files, the JAX
package's layout)::

    manifest.json             # rows, shard sizes, dtype, mappers, hashes
    shard_0000.bins.npy       # [n_0, F_used] uint8/uint16, memmapped
    shard_0000.label.npy      # [n_0] f32 (when labels were provided)
    shard_0000.weight.npy     # [n_0] f32 (when weights were provided)
    shard_0001.bins.npy ...

Not supported on the sharded path (raised at construction or learner
setup): EFB bundling, linear trees / raw-data retention, sparse input,
query groups, init scores, and alignment to a reference dataset.
"""
from __future__ import annotations

import concurrent.futures
import errno
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, resolve_device
from ..obs import events as obs_events
from ..obs import faults
from ..obs import quality as obs_quality
from ..obs.registry import registry as obs
from ..utils import log
from ..utils.atomic import atomic_write, sha256_file
from ..utils.retry import retry_call
from .binning import BinMapper
from .dataset import (BinnedDataset, Metadata, _Columns, _find_mappers,
                      _resolve_categorical)

# default rows per spilled shard when the caller does not size them
DEFAULT_SHARD_ROWS = 1 << 18

# ENOSPC mid-spill falls back to holding the REMAINING shards resident
# in host RAM when they fit this budget (else: fatal, telemetry
# flushed) — a long build survives a full disk at the cost of the
# O(chunk) memory contract for the un-spilled tail
_ENV_RESIDENT_BUDGET = "LIGHTGBM_TPU_SPILL_RESIDENT_BUDGET_MB"
# upper bound on one blocking wait for a staged shard: a wedged device
# runtime must become a fatal health event, not an indefinite hang
_ENV_STAGE_TIMEOUT = "LIGHTGBM_TPU_STAGE_TIMEOUT_S"


def _is_enospc(e: BaseException) -> bool:
    return getattr(e, "errno", None) == errno.ENOSPC


def _normalize_chunk(chunk) -> Tuple[np.ndarray, Optional[np.ndarray],
                                     Optional[np.ndarray]]:
    """A source chunk is ``X`` or ``(X,)`` or ``(X, y)`` or
    ``(X, y, w)``; returns dense f64 X plus optional f32 y/w."""
    if isinstance(chunk, tuple):
        X = chunk[0]
        y = chunk[1] if len(chunk) > 1 else None
        w = chunk[2] if len(chunk) > 2 else None
    else:
        X, y, w = chunk, None, None
    if hasattr(X, "tocsc"):
        log.fatal("sharded construction requires dense chunks")
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    if y is not None:
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        if len(y) != X.shape[0]:
            log.fatal("chunk has %d rows but %d labels"
                      % (X.shape[0], len(y)))
    if w is not None:
        w = np.asarray(w, dtype=np.float32).reshape(-1)
        if len(w) != X.shape[0]:
            log.fatal("chunk has %d rows but %d weights"
                      % (X.shape[0], len(w)))
    return X, y, w


class _SampleCollector:
    """Pass-1 row sample for bin-mapper construction, O(sample) memory.

    With ``total_rows`` known up front (the StreamingDataset route) the
    sample replicates ``BinnedDataset.from_matrix`` EXACTLY —
    ``sort(rng.choice(n, sample_cnt))`` on the same
    ``data_random_seed`` — so the mappers (and therefore the binned
    rows and the trained trees) are bit-identical to the in-memory
    path. With unknown ``total_rows`` a uniform reservoir stands in:
    statistically equivalent, and still exactly the full row set (hence
    exactly from_matrix's mappers) whenever ``bin_construct_sample_cnt``
    covers the data."""

    def __init__(self, sample_cnt: int, num_features: int, seed: int,
                 total_rows: Optional[int]):
        self.cap = int(sample_cnt)
        self.rng = np.random.RandomState(seed)
        self.total_rows = total_rows
        # preallocated to the (known) sample bound and filled by slice:
        # per-chunk concatenation would re-copy the whole accumulated
        # sample every chunk — O(num_chunks x sample_bytes) memmove at
        # exactly the scale this module targets
        self.rows = np.empty((self.cap, num_features), dtype=np.float64)
        self.idx = np.empty(self.cap, dtype=np.int64)
        self.fill = 0
        self.seen = 0
        self._target_idx = None
        if total_rows is not None and self.cap < total_rows:
            self._target_idx = np.sort(self.rng.choice(
                total_rows, self.cap, replace=False))

    def add(self, X: np.ndarray) -> None:
        m = X.shape[0]
        lo = self.seen
        self.seen += m
        if self._target_idx is not None:
            # exact from_matrix sample: gather the pre-drawn indices
            # falling inside this chunk
            a = np.searchsorted(self._target_idx, lo)
            b = np.searchsorted(self._target_idx, lo + m)
            if b > a:
                self.rows[self.fill:self.fill + b - a] = \
                    X[self._target_idx[a:b] - lo]
                self.idx[self.fill:self.fill + b - a] = \
                    self._target_idx[a:b]
                self.fill += b - a
            return
        if self.fill < self.cap:
            take = min(self.cap - self.fill, m)
            self.rows[self.fill:self.fill + take] = X[:take]
            self.idx[self.fill:self.fill + take] = \
                np.arange(lo, lo + take)
            self.fill += take
            if take == m:
                return
            X = X[take:]
            lo += take
            m -= take
        # vectorized reservoir tail: row t replaces a random slot with
        # probability cap/t (within-chunk slot collisions keep the
        # later row — still a uniform sample)
        t = np.arange(lo + 1, lo + m + 1, dtype=np.float64)
        slots = (self.rng.rand(m) * t).astype(np.int64)
        hit = slots < self.cap
        if hit.any():
            self.rows[slots[hit]] = X[hit]
            self.idx[slots[hit]] = np.arange(lo, lo + m)[hit]

    def finish(self) -> Tuple[np.ndarray, int]:
        """(sample rows in ascending row order, effective count)."""
        rows, idx = self.rows[:self.fill], self.idx[:self.fill]
        order = np.argsort(idx, kind="stable")
        return rows[order], self.fill


class ShardedBinnedDataset:
    """Binned training data spilled to memory-mapped shards.

    Duck-types the :class:`~.dataset.BinnedDataset` surface the boosting
    and tree-learner layers read (mappers, metadata, feature maps) but
    deliberately has NO ``bins`` attribute: any code path that needs the
    full resident matrix (DART/rollback score recomputation, EFB, linear
    trees) fails loudly instead of silently materializing the dataset.
    """

    def __init__(self) -> None:
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: List[int] = []
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.max_num_bin: int = 0
        self.num_bin_per_feature: np.ndarray = np.zeros(0, dtype=np.int32)
        self.monotone_constraints: Optional[np.ndarray] = None
        self.bundle = None          # EFB never bundles on this path
        self.raw_data = None        # linear trees unsupported
        self.spill_dir: str = ""
        self.shard_sizes: List[int] = []
        self.shard_offsets: List[int] = []
        self.bins_dtype = np.uint8
        self.has_weights = False
        # ENOSPC degradation: shards the spill could not write stay
        # host-resident here and shard_bins_host serves them directly
        self._resident_shards: Dict[int, np.ndarray] = {}
        # manifest file table (name -> {sha256, bytes}) checked on
        # every reopen: size per open, full content hash on the first
        self._file_meta: Dict[str, dict] = {}
        self._verified_shards: set = set()
        # training-grid reference profile (obs/quality.py) captured at
        # spill time; None on spills written before the quality plane
        self.quality_profile = None

    # ------------------------------------------------------------------
    @classmethod
    def from_chunk_source(cls, source: Callable[[], Iterable],
                          config: Config, spill_dir: str,
                          shard_rows: Optional[int] = None,
                          feature_names: Optional[List[str]] = None,
                          categorical_feature=None,
                          total_rows: Optional[int] = None,
                          device=None) -> "ShardedBinnedDataset":
        """Two-pass, chunk-at-a-time construction.

        Parameters
        ----------
        source : zero-argument callable returning a FRESH iterator of
            chunks — each ``X`` / ``(X, y)`` / ``(X, y, w)`` — called
            exactly twice (pass 1: sampling, pass 2: bin + spill).
        spill_dir : directory for the shard files (created if missing).
        shard_rows : rows per spilled shard; sizes the device staging unit.
        total_rows : when known (e.g. the StreamingDataset route), the
            pass-1 sample replicates ``from_matrix`` bit-exactly.
        device : where the reference profile is counted during the
            spill (``config``'s device by default: the card unless
            ``device_type="cpu"``).
        """
        config.check_slice()
        device = (resolve_device(config) if device is None
                  else torch.device(device))
        self = cls()
        self.spill_dir = str(spill_dir)
        os.makedirs(self.spill_dir, exist_ok=True)
        # spilled shards are live training data reopened memmapped on
        # every sweep — refuse to clobber an existing spill (the PR-6
        # trace-segment rule: on-disk artifacts are evidence, never
        # overwritten; stale higher-numbered shards from a previous
        # larger build would also survive next to a fresh manifest)
        existing = [f for f in os.listdir(self.spill_dir)
                    if f == "manifest.json" or f.startswith("shard_")]
        if existing:
            log.fatal("spill_dir %s already holds a spilled dataset "
                      "(%s, ...); use a fresh directory"
                      % (self.spill_dir, sorted(existing)[0]))
        shard_rows = int(shard_rows or DEFAULT_SHARD_ROWS)
        if shard_rows <= 0:
            log.fatal("shard_rows must be positive")

        # ---- pass 1: stream chunks into the mapper sample ------------
        sampler = None
        num_total_features = 0
        with obs.scope("io::find_bins"):
            for chunk in source():
                X, _, _ = _normalize_chunk(chunk)
                if sampler is None:
                    num_total_features = X.shape[1]
                    sampler = _SampleCollector(
                        min(config.bin_construct_sample_cnt,
                            total_rows if total_rows is not None
                            else config.bin_construct_sample_cnt),
                        num_total_features, config.data_random_seed,
                        total_rows)
                elif X.shape[1] != num_total_features:
                    log.fatal("chunk has %d columns, expected %d"
                              % (X.shape[1], num_total_features))
                sampler.add(X)
            if sampler is None or sampler.seen == 0:
                log.fatal("no rows in chunk source")
            if total_rows is not None and sampler.seen != total_rows:
                log.fatal("chunk source yielded %d rows, expected %d"
                          % (sampler.seen, total_rows))
            n = sampler.seen
            sample_X, sample_cnt_eff = sampler.finish()
            self.num_total_features = num_total_features
            self.feature_names = list(feature_names) if feature_names \
                else ["Column_%d" % i for i in range(num_total_features)]
            self._build_mappers(sample_X, sample_cnt_eff, config,
                                categorical_feature)
        if config.enable_bundle and self.num_features > 1:
            log.info("EFB bundling is disabled on the sharded "
                     "out-of-core path (dense shard layout)")

        # ---- pass 2: bin per chunk, spill shard files ----------------
        self.bins_dtype = (np.uint8 if self.max_num_bin <= 256
                           else np.uint16)
        F_used = self.num_features
        buf = np.empty((shard_rows, max(F_used, 1)), dtype=self.bins_dtype)
        lbuf = np.empty(shard_rows, dtype=np.float32)
        wbuf = np.empty(shard_rows, dtype=np.float32)
        fill = 0
        shard_no = 0
        labels: List[np.ndarray] = []
        weights: List[np.ndarray] = []
        any_label = False
        any_weight = False

        try:
            resident_budget_mb = float(os.environ.get(
                _ENV_RESIDENT_BUDGET, 512))
        except ValueError:
            resident_budget_mb = 512.0
        degraded = False
        profiler = obs_quality.ProfileBuilder(
            self.bin_mappers, self.used_feature_map, self.feature_names,
            device=device)

        def _cleanup_partial(k: int) -> None:
            for p in (self._bins_path(k), self._label_path(k),
                      self._weight_path(k)):
                try:
                    os.unlink(p)
                except OSError:
                    pass

        def flush():
            nonlocal fill, shard_no, degraded
            if fill == 0:
                return
            if not degraded:
                def _write():
                    faults.check("spill_write", shard=shard_no)
                    np.save(self._bins_path(shard_no), buf[:fill])
                    if any_label:
                        np.save(self._label_path(shard_no), lbuf[:fill])
                    if any_weight:
                        np.save(self._weight_path(shard_no),
                                wbuf[:fill])
                try:
                    retry_call(_write, site="spill_write",
                               no_retry=_is_enospc)
                    for p in [self._bins_path(shard_no)] \
                            + ([self._label_path(shard_no)]
                               if any_label else []) \
                            + ([self._weight_path(shard_no)]
                               if any_weight else []):
                        self._file_meta[os.path.basename(p)] = {
                            "sha256": sha256_file(p),
                            "bytes": os.path.getsize(p)}
                except OSError as e:
                    # a retried write may have left a truncated file —
                    # never leave it next to the manifest
                    _cleanup_partial(shard_no)
                    if not _is_enospc(e):
                        log.fatal("spilling shard %d under %s failed "
                                  "after retries: %r"
                                  % (shard_no, self.spill_dir, e))
                    # ENOSPC: the disk will not get emptier — degrade
                    # to resident shards when the un-spilled remainder
                    # fits the budget, else die with telemetry flushed
                    remaining = n - sum(self.shard_sizes)
                    row_bytes = (max(F_used, 1) * buf.itemsize
                                 + 4 * (int(any_label)
                                        + int(any_weight)))
                    est_mb = remaining * row_bytes / 2.0**20
                    if est_mb > resident_budget_mb:
                        log.fatal(
                            "disk full spilling shard %d and the "
                            "remaining ~%.0f MB exceed %s=%.0f; free "
                            "space or raise the budget"
                            % (shard_no, est_mb, _ENV_RESIDENT_BUDGET,
                               resident_budget_mb))
                    degraded = True
                    obs.inc("ft/spill_degraded")
                    msg = ("disk full (ENOSPC) spilling shard %d; "
                           "keeping the remaining ~%.0f MB of shards "
                           "resident in host RAM (budget %s=%.0f) — "
                           "the O(chunk) construction-memory contract "
                           "is suspended for this build"
                           % (shard_no, est_mb, _ENV_RESIDENT_BUDGET,
                              resident_budget_mb))
                    obs_events.emit("perf_warning",
                                    component="io.shards", message=msg)
                    obs_events.flush()
                    log.warning_always(msg)
            if degraded:
                self._resident_shards[shard_no] = buf[:fill].copy()
                obs.inc("io/shards_resident")
            else:
                obs.inc("io/shards_spilled")
            if any_label:
                labels.append(lbuf[:fill].copy())
                profiler.add_labels(lbuf[:fill])
            if any_weight:
                weights.append(wbuf[:fill].copy())
            # the reference profile rides the spill: one scatter-add on
            # the device over the shard buffer binned above
            profiler.add_block(buf, fill)
            self.shard_sizes.append(fill)
            shard_no += 1
            fill = 0

        with obs.scope("io::apply_bins"):
            first = True
            for chunk in source():
                X, y, w = _normalize_chunk(chunk)
                if first:
                    any_label = y is not None
                    any_weight = w is not None
                    first = False
                if (y is not None) != any_label or \
                        (w is not None) != any_weight:
                    log.fatal("chunk source must carry labels/weights "
                              "on every chunk or on none")
                binned = np.empty((X.shape[0], max(F_used, 1)),
                                  dtype=self.bins_dtype)
                for j in range(F_used):
                    f = self.used_feature_map[j]
                    binned[:, j] = self.bin_mappers[j].value_to_bin(
                        X[:, f]).astype(self.bins_dtype)
                pos = 0
                m = X.shape[0]
                while pos < m:
                    take = min(m - pos, shard_rows - fill)
                    buf[fill:fill + take] = binned[pos:pos + take]
                    if any_label:
                        lbuf[fill:fill + take] = y[pos:pos + take]
                    if any_weight:
                        wbuf[fill:fill + take] = w[pos:pos + take]
                    fill += take
                    pos += take
                    if fill == shard_rows:
                        flush()
            flush()

        if sum(self.shard_sizes) != n:
            log.fatal("pass 2 yielded %d rows, pass 1 saw %d"
                      % (sum(self.shard_sizes), n))
        self.shard_offsets = list(
            np.concatenate([[0], np.cumsum(self.shard_sizes)[:-1]])
            .astype(int))
        self.has_weights = any_weight
        self.metadata = Metadata(n)
        if any_label:
            self.metadata.set_label(np.concatenate(labels))
        if any_weight:
            self.metadata.set_weights(np.concatenate(weights))
        self.quality_profile = profiler.finalize()
        manifest = {
            "num_data": n,
            "num_features_used": F_used,
            "num_total_features": self.num_total_features,
            "shard_sizes": self.shard_sizes,
            "bins_dtype": np.dtype(self.bins_dtype).name,
            "has_label": any_label, "has_weight": any_weight,
            "max_num_bin": self.max_num_bin,
            # per-file content hashes: a truncated or poisoned shard
            # is rejected loudly by name at reopen, never trained on
            "files": self._file_meta,
            "resident_shards": sorted(self._resident_shards),
            # the full quantizer state: attach() reopens this spill
            # without the source data and without re-binning
            "feature_names": self.feature_names,
            "used_feature_map": self.used_feature_map,
            "mappers": [m.to_dict() for m in self.bin_mappers],
            # training-grid reference profile (obs/quality.py): the
            # drift baseline reloads with the spill, no source data
            # needed
            "quality_profile": self.quality_profile.to_dict(),
        }
        try:
            atomic_write(os.path.join(self.spill_dir, "manifest.json"),
                         json.dumps(manifest))
        except OSError as e:
            if not degraded:
                log.fatal("writing spill manifest under %s failed: %r"
                          % (self.spill_dir, e))
            # the degraded (disk-full) build still works from memory;
            # only the on-disk forensics record is lost
            log.warning_always("spill manifest write failed on the "
                               "degraded build: %r" % e)
        obs_events.emit(
            "dataset", num_data=n, num_features=self.num_features,
            num_total_features=self.num_total_features,
            max_num_bin=self.max_num_bin, bundled=False,
            aligned_to_reference=False, sharded=True,
            num_shards=self.num_shards, shard_rows=shard_rows)
        return self

    # ------------------------------------------------------------------
    @classmethod
    def attach(cls, spill_dir: str,
               config: Optional[Config] = None) -> "ShardedBinnedDataset":
        """Reopen an existing spill dir WITHOUT the source data and
        without re-binning: the manifest carries the full quantizer
        state (bin mappers, feature maps), shard files stay on disk and
        reopen memory-mapped exactly as after construction. Labels and
        weights reload from the per-shard aux files, each verified
        against the manifest's content hash before use.

        This is the refresh loop's cheap data plane for cycle N+1 (and
        the elastic-resume primitive): training from an attached
        dataset is bit-identical to training from the dataset that
        spilled it. ``config`` resolves the constraint/penalty vectors
        (monotone_constraints, feature_penalty) — pass the training
        config; defaults to ``Config()`` (no constraints).
        """
        self = cls()
        self.spill_dir = str(spill_dir)
        mpath = os.path.join(self.spill_dir, "manifest.json")
        try:
            with open(mpath) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            log.fatal("cannot attach spill dir %s: manifest unreadable "
                      "(%r)" % (self.spill_dir, e))
        if "mappers" not in manifest:
            log.fatal("spill manifest under %s predates mapper "
                      "serialization; rebuild via from_chunk_source"
                      % self.spill_dir)
        if manifest.get("resident_shards"):
            # a degraded (ENOSPC) build kept shards in RAM only — they
            # were never written, so this spill cannot be reattached
            log.fatal("spill under %s is degraded (shards %s were "
                      "host-resident, never spilled); it cannot be "
                      "reattached" % (self.spill_dir,
                                      manifest["resident_shards"]))
        n = int(manifest["num_data"])
        self.num_total_features = int(manifest["num_total_features"])
        self.feature_names = list(manifest["feature_names"])
        self.bin_mappers = [BinMapper.from_dict(d)
                            for d in manifest["mappers"]]
        self.used_feature_map = [int(i)
                                 for i in manifest["used_feature_map"]]
        if (len(self.bin_mappers) != int(manifest["num_features_used"])
                or len(self.used_feature_map) != len(self.bin_mappers)):
            log.fatal("spill manifest under %s is inconsistent: %d "
                      "mappers, %d used features, used map of %d"
                      % (self.spill_dir, len(self.bin_mappers),
                         int(manifest["num_features_used"]),
                         len(self.used_feature_map)))
        self.num_bin_per_feature = np.asarray(
            [m.num_bin for m in self.bin_mappers], dtype=np.int32)
        self.max_num_bin = int(manifest["max_num_bin"])
        derived = int(self.num_bin_per_feature.max()) \
            if len(self.num_bin_per_feature) else 1
        if derived != self.max_num_bin:
            log.fatal("spill manifest under %s is inconsistent: "
                      "max_num_bin %d but mappers peak at %d"
                      % (self.spill_dir, self.max_num_bin, derived))
        self.bins_dtype = np.dtype(manifest["bins_dtype"]).type
        self.shard_sizes = [int(s) for s in manifest["shard_sizes"]]
        if sum(self.shard_sizes) != n:
            log.fatal("spill manifest under %s is inconsistent: shard "
                      "sizes sum to %d, num_data is %d"
                      % (self.spill_dir, sum(self.shard_sizes), n))
        self.shard_offsets = list(
            np.concatenate([[0], np.cumsum(self.shard_sizes)[:-1]])
            .astype(int))
        self.has_weights = bool(manifest["has_weight"])
        # drift baseline: absent on spills written before the quality
        # plane (tolerated — drift monitoring is then simply off); a
        # malformed one is rejected loudly like any other manifest rot
        if manifest.get("quality_profile") is not None:
            try:
                self.quality_profile = obs_quality.ReferenceProfile \
                    .from_dict(manifest["quality_profile"])
            except (KeyError, TypeError, ValueError) as e:
                log.fatal("spill manifest under %s carries a malformed "
                          "quality_profile: %r" % (self.spill_dir, e))
        self._file_meta = {str(k): dict(v)
                           for k, v in manifest["files"].items()}
        # every manifest-listed file must exist at its recorded size
        # BEFORE any training starts (content hashes verify lazily on
        # first open, same as after construction)
        for name, meta in self._file_meta.items():
            path = os.path.join(self.spill_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError as e:
                log.fatal("attach: shard file %s under %s is missing "
                          "or unreadable: %r"
                          % (name, self.spill_dir, e))
            if size != int(meta["bytes"]):
                log.fatal("attach: shard file %s is truncated: %d "
                          "bytes on disk, manifest records %d"
                          % (name, size, int(meta["bytes"])))
        BinnedDataset._set_constraints(self, config or Config())
        self.metadata = Metadata(n)
        if manifest["has_label"]:
            self.metadata.set_label(np.concatenate(
                [self._load_aux(self._label_path(k))
                 for k in range(self.num_shards)]))
        if self.has_weights:
            self.metadata.set_weights(np.concatenate(
                [self._load_aux(self._weight_path(k))
                 for k in range(self.num_shards)]))
        obs_events.emit(
            "dataset_attach", spill_dir=self.spill_dir, num_data=n,
            num_features=self.num_features,
            num_shards=self.num_shards,
            max_num_bin=self.max_num_bin)
        return self

    def _load_aux(self, path: str) -> np.ndarray:
        """Load one label/weight shard file, content-verified against
        the manifest hash (aux files are [n_k] f32 — small enough to
        hash eagerly on attach, unlike the lazily-verified bins)."""
        name = os.path.basename(path)
        meta = self._file_meta.get(name)
        if meta is None:
            log.fatal("attach: %s is not in the spill manifest under %s"
                      % (name, self.spill_dir))
        digest = sha256_file(path)
        if digest != meta["sha256"]:
            log.fatal("attach: %s under %s failed content verification "
                      "(sha256 %s..., manifest records %s...)"
                      % (name, self.spill_dir, digest[:12],
                         meta["sha256"][:12]))
        return np.load(path)

    # ------------------------------------------------------------------
    def _build_mappers(self, sample_X: np.ndarray, sample_cnt_eff: int,
                       config: Config, categorical_feature) -> None:
        """Mapper construction over the pass-1 sample: the in-memory
        path's own ``_find_mappers`` over the sampled rows (which are
        the whole sample, so it samples nothing again), the same knobs,
        the same trivial-feature filtering."""
        if categorical_feature is None and config.categorical_feature:
            categorical_feature = config.categorical_feature
        cat_set = _resolve_categorical(categorical_feature,
                                       self.feature_names)
        mappers, _ = _find_mappers(_Columns(sample_X, False),
                                   int(sample_cnt_eff), config, cat_set)
        self.bin_mappers = [m for m in mappers if not m.is_trivial]
        self.used_feature_map = [i for i, m in enumerate(mappers)
                                 if not m.is_trivial]
        self.num_bin_per_feature = np.asarray(
            [m.num_bin for m in self.bin_mappers], dtype=np.int32)
        self.max_num_bin = int(self.num_bin_per_feature.max()) \
            if len(self.num_bin_per_feature) else 1
        # the monotone vector: the in-memory dataset's resolution (it
        # reads only the mappers and the used-feature map)
        BinnedDataset._set_constraints(self, config)

    # ------------------------------------------------------------------
    # shard access
    # ------------------------------------------------------------------
    def _bins_path(self, k: int) -> str:
        return os.path.join(self.spill_dir, "shard_%04d.bins.npy" % k)

    def _label_path(self, k: int) -> str:
        return os.path.join(self.spill_dir, "shard_%04d.label.npy" % k)

    def _weight_path(self, k: int) -> str:
        return os.path.join(self.spill_dir, "shard_%04d.weight.npy" % k)

    @property
    def num_shards(self) -> int:
        return len(self.shard_sizes)

    def shard_bins_host(self, k: int) -> np.ndarray:
        """[n_k, F_used] bin matrix of shard ``k``: host-resident when
        the spill degraded on ENOSPC, else memory-mapped (touching it
        faults pages in, it never loads the file whole). Every reopen
        checks the file size against the manifest and the first open
        additionally verifies the content hash — a truncated or
        poisoned shard fails loudly by name instead of silently
        corrupting the run; transient open errors retry with backoff
        (utils/retry.py)."""
        if k in self._resident_shards:
            return self._resident_shards[k]
        path = self._bins_path(k)
        name = os.path.basename(path)
        meta = self._file_meta.get(name)
        if meta is not None:
            try:
                size = os.path.getsize(path)
            except OSError as e:
                log.fatal("shard %s under %s is unreadable: %r"
                          % (name, self.spill_dir, e))
            if size != int(meta["bytes"]):
                log.fatal("shard %s is truncated: %d bytes on disk, "
                          "manifest records %d"
                          % (name, size, int(meta["bytes"])))
            # full content hash once per shard (first open). The hash
            # read costs one pass over bytes the first sweep is about
            # to stage anyway (page-cache warm); very large runs that
            # would rather skip it set LIGHTGBM_TPU_SHARD_VERIFY=0 —
            # the per-open size check above always stays on
            if k not in self._verified_shards \
                    and os.environ.get("LIGHTGBM_TPU_SHARD_VERIFY",
                                       "1") != "0":
                if sha256_file(path) != meta["sha256"]:
                    log.fatal("shard %s fails its manifest content "
                              "hash (truncated or poisoned spill); "
                              "rebuild the spill directory" % name)
                self._verified_shards.add(k)

        def _open():
            faults.check("shard_open", shard=name)
            return np.load(path, mmap_mode="r")

        return retry_call(_open, site="shard_open")

    def assemble_bins(self) -> np.ndarray:
        """Concatenate every shard into one [N, F_used] host matrix.
        O(dataset) memory — for tests and small-data debugging ONLY."""
        return np.concatenate([np.asarray(self.shard_bins_host(k))
                               for k in range(self.num_shards)])

    # ------------------------------------------------------------------
    # BinnedDataset surface (duck-typed subset)
    # ------------------------------------------------------------------
    @property
    def num_data(self) -> int:
        return int(sum(self.shard_sizes))

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def real_threshold(self, feature: int, bin_idx: int) -> float:
        return self.bin_mappers[feature].bin_to_value(bin_idx)

    def real_feature_index(self, inner_feature: int) -> int:
        return self.used_feature_map[inner_feature]

    def inner_feature_index(self, real_feature: int) -> int:
        try:
            return self.used_feature_map.index(real_feature)
        except ValueError:
            return -1

    def feature_infos(self) -> List[str]:
        infos = ["none"] * self.num_total_features
        for f, bm in zip(self.used_feature_map, self.bin_mappers):
            infos[f] = bm.feature_info()
        return infos


class _Staged:
    """One shard on the device: its bins and, on the card, the event
    after its copy (the compute stream waits on it before reading)."""
    __slots__ = ("bins", "ready")

    def __init__(self, bins: torch.Tensor, ready=None):
        self.bins = bins
        self.ready = ready


class ShardPrefetcher:
    """Double-buffered shard staging for an ordered shard sweep.

    ``sweep()`` yields ``(k, device_bins)`` for every shard in order.
    While the consumer computes on shard *k*, one worker thread is
    already staging shard *k+1* (``io::shard_stage`` scope). On the
    card it copies the shard from its memory map into one of two pinned
    host buffers (waiting, in the worker, for that buffer's previous
    copy to finish), then to the card with ``non_blocking=True`` on a
    copy stream, and records an event; the consumer makes its current
    stream wait on that event and marks the tensor as used there
    (``record_stream``), so the caching allocator never hands the buffer
    out while the compute stream still reads it. The host never waits
    for a staged shard. Time blocked on a shard not staged yet lands on
    the ``io/prefetch_stall_ms`` counter (the ``prefetch_stall`` rule of
    ``obs/health.py``).

    A staged shard is ``[n_k, pad_cols]``: the column pad is the
    learner's feature padding (zero bins of pad features, which never
    win a split). The JAX package adds a zero row as the fill target of
    its fixed-width gather; the port's learner hands the kernel a row
    list with its count, and needs none.

    With ``num_shards <= 2`` both staged shards fit the double buffer
    anyway, so they are kept across sweeps (staged once). Beyond that,
    references are dropped after each shard's use so the allocator
    recycles the memory (at most two shards resident).
    """

    def __init__(self, dataset: ShardedBinnedDataset, pad_cols: int,
                 device=None):
        import threading
        self.dataset = dataset
        self.pad_cols = int(pad_cols)
        self.device = torch.device("cpu" if device is None else device)
        self._resident = {} if dataset.num_shards <= 2 else None
        try:
            t = float(os.environ.get(_ENV_STAGE_TIMEOUT, 600))
        except ValueError:
            t = 600.0
        # <= 0 disables the bound; a negative value must never become an
        # instantly-expiring fut.result(timeout<0)
        self._stage_timeout = t if t > 0 else None
        self._cuda = self.device.type == "cuda"
        self._copy_stream = None
        self._pinned: List[Optional[torch.Tensor]] = [None, None]
        self._pinned_done: List = [None, None]
        self._slot = 0
        self._slot_lock = threading.Lock()
        import weakref
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="shard-prefetch")
        # a learner holds its prefetcher for life; reclaim the worker
        # thread when the learner goes away, not at interpreter exit
        self._finalizer = weakref.finalize(self, self._pool.shutdown,
                                           False)

    def _host_rows(self, k: int) -> np.ndarray:
        """Shard ``k``'s bins as [n_k, pad_cols] host rows (a fresh
        array on the CPU path)."""
        ds = self.dataset
        host = np.zeros((ds.shard_sizes[k], self.pad_cols),
                        dtype=ds.bins_dtype)
        host[:, :ds.num_features] = ds.shard_bins_host(k)
        return host

    def _stage_cuda(self, k: int) -> _Staged:
        """Shard ``k`` through a pinned buffer to the card (worker
        thread): the shard's contiguous [n_k, F] bytes are copied from
        its memory map into one of two pinned buffers by a torch copy
        (threaded, the GIL released), sent up on the copy stream, and
        spread into the zero-padded [n_k, pad_cols] rows by a copy on the
        card (a host copy into padded rows would write row by row). The
        bytes travel as uint8 and are viewed as the bins' dtype on the
        card (torch's uint16 is a limited dtype)."""
        import warnings
        ds = self.dataset
        n_k = ds.shard_sizes[k]
        item = np.dtype(ds.bins_dtype).itemsize
        width = self.pad_cols * item
        used = ds.num_features * item
        with self._slot_lock:
            slot, self._slot = self._slot, self._slot ^ 1
        done = self._pinned_done[slot]
        if done is not None:
            done.synchronize()   # the buffer's previous copy has run
        buf = self._pinned[slot]
        if buf is None:
            buf = torch.empty(max(ds.shard_sizes) * used,
                              dtype=torch.uint8, pin_memory=True)
            self._pinned[slot] = buf
        src = np.ascontiguousarray(ds.shard_bins_host(k)).reshape(-1)
        with warnings.catch_warnings():
            # a read-only memory map: torch warns that it could write
            # through the tensor; this one is only read
            warnings.simplefilter("ignore", UserWarning)
            buf[:n_k * used].copy_(torch.from_numpy(src.view(np.uint8)))
        with torch.cuda.device(self.device):
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                raw = buf[:n_k * used].to(self.device, non_blocking=True)
                dev = torch.zeros((n_k, width), dtype=torch.uint8,
                                  device=self.device)
                dev[:, :used].copy_(raw.view(n_k, used))
                ready = torch.cuda.Event()
                ready.record(self._copy_stream)
        self._pinned_done[slot] = ready
        bins_dtype = torch.uint8 if item == 1 else torch.uint16
        return _Staged(dev.view(bins_dtype), ready)

    def _load_and_stage(self, k: int) -> _Staged:
        with obs.scope("io::shard_stage"):
            def _stage():
                faults.check("prefetch_device_put", shard=k)
                if self._cuda:
                    return self._stage_cuda(k)
                return _Staged(torch.from_numpy(self._host_rows(k)))

            # transient staging failures (a busy runtime, an I/O
            # hiccup re-reading the memmap) retry with seeded backoff;
            # exhaustion re-raises and sweep() turns the worker's
            # exception into a fatal on the CONSUMER thread
            staged = retry_call(_stage, site="prefetch_device_put",
                                retry_on=(OSError, RuntimeError))
            obs.inc("io/shards_staged")
            return staged

    def _await(self, fut, k: int) -> _Staged:
        """Blocking wait for a staged shard, bounded and loud: a worker
        exception re-raises HERE (the consuming thread) as a fatal with
        telemetry flushed, and a wedged staging hop becomes a fatal
        ``health`` event after ``LIGHTGBM_TPU_STAGE_TIMEOUT_S`` instead
        of an indefinite hang."""
        try:
            return fut.result(timeout=self._stage_timeout)
        except concurrent.futures.TimeoutError:
            obs_events.emit("health", rule="prefetch_hang",
                            severity="fatal", shard=k,
                            timeout_s=self._stage_timeout,
                            detail="shard staging did not complete")
            obs_events.flush()
            log.fatal("staging shard %d did not complete within %.0f s "
                      "(%s); the prefetch worker is wedged"
                      % (k, self._stage_timeout, _ENV_STAGE_TIMEOUT))
        except Exception as e:
            log.fatal("staging shard %d failed after retries: %r"
                      % (k, e))

    def _submit(self, k: int):
        if self._resident is not None and k in self._resident:
            return self._resident[k]
        return self._pool.submit(self._load_and_stage, k)

    def _consume(self, staged: _Staged) -> torch.Tensor:
        """The staged bins, ready for the current stream to read."""
        if staged.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.ready)
            staged.bins.record_stream(cur)
        return staged.bins

    def sweep(self):
        """Ordered iterator over all shards, prefetching one ahead.
        Staging of shard 0 begins at the CALL, not at the first
        iteration — so a caller can start the next sweep before its
        own device read-back and the worker stages through that sync
        window instead of sitting idle."""
        fut0 = self._submit(0)

        def _iter(fut):
            n = self.dataset.num_shards
            for k in range(n):
                nxt = self._submit(k + 1) if k + 1 < n else None
                if isinstance(fut, concurrent.futures.Future):
                    t0 = time.perf_counter()
                    stalled = not fut.done()
                    staged = self._await(fut, k)
                    if stalled:
                        obs.inc("io/prefetch_stall_ms", max(int(
                            (time.perf_counter() - t0) * 1000), 1))
                    if self._resident is not None:
                        self._resident[k] = staged
                else:
                    staged = fut          # resident cache hit
                yield k, self._consume(staged)
                del staged            # drop the consumer-side reference
                fut = nxt

        return _iter(fut0)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._resident = {} if self._resident is not None else None
