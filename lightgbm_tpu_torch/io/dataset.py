"""Binned dataset + metadata for lightgbm_tpu_torch.

Port of ``lightgbm_tpu/io/dataset.py`` (reference:
include/LightGBM/dataset.h:426,46; construction after
DatasetLoader::ConstructFromSampleData, src/io/dataset_loader.cpp:593):

  sample rows -> BinMapper.find_bin per feature (numerical or
  categorical) -> drop trivial features -> EFB bundles of mostly-zero
  columns (``io/efb.py``, on by default as in the reference) ->
  value_to_bin over the full columns -> one row-major uint8 matrix
  (uint16 when a feature or a bundle has more than 256 bins),
  [N, G] bundle columns when bundled, [N, F] features otherwise.

Dense arrays and scipy sparse matrices are taken; sparse input stays
CSC and every per-column pass is O(nnz) (implicit zeros take the
feature's zero bin). The matrix stays on the host here; the learner
copies it to the device once.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..config import Config
from ..obs import events as obs_events
from ..obs.registry import registry as obs
from ..utils import log
from .binning import BinMapper, BinType, MissingType
from .efb import BundleLayout, build_layout, bundle_columns, find_groups


class Metadata:
    """Labels / weights / query boundaries / init score (reference:
    dataset.h:46)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label = np.zeros(num_data, dtype=np.float32)
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Sequence[float]) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            log.fatal("Length of label (%d) != num_data (%d)"
                      % (len(label), self.num_data))
        self.label = label

    def set_weights(self, weights: Optional[Sequence[float]]) -> None:
        if weights is None:
            self.weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if len(weights) != self.num_data:
            log.fatal("Length of weights (%d) != num_data (%d)"
                      % (len(weights), self.num_data))
        self.weights = weights

    def set_group(self, group: Optional[Sequence[int]]) -> None:
        """Group sizes -> query boundaries (reference:
        Metadata::SetQuery, src/io/metadata.cpp:456)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        if group.sum() != self.num_data:
            log.fatal("Sum of group sizes (%d) != num_data (%d)"
                      % (int(group.sum()), self.num_data))
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(group)]).astype(np.int32)

    def set_init_score(self, init_score: Optional[Sequence[float]]) -> None:
        """num_data values, or num_class * num_data class-major (all of
        class 0, then class 1, ...) for multiclass models."""
        if init_score is None:
            self.init_score = None
            return
        init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)
        if len(init_score) % max(self.num_data, 1) != 0:
            log.fatal("Length of init_score (%d) must be a multiple of "
                      "num_data (%d)" % (len(init_score), self.num_data))
        self.init_score = init_score

    @property
    def num_queries(self) -> int:
        return (0 if self.query_boundaries is None
                else len(self.query_boundaries) - 1)


class BinnedDataset:
    """Quantized training data.

    bins : np.ndarray uint8 (uint16 past 256 bins), [num_data,
        num_used_features], or the
        bundled [num_data, num_groups] matrix when ``bundle`` is set
    bin_mappers : one BinMapper per *used* (non-trivial) feature
    used_feature_map : original column index per used feature
    bundle : the EFB layout (``io/efb.py`` BundleLayout) or None
    monotone_constraints : int8 [num_used_features] (-1, 0, +1) of the
        used features, or None when the config sets none
    raw_data : the dense input matrix, kept for linear trees (or None)
    """

    def __init__(self) -> None:
        self.bins: np.ndarray = np.zeros((0, 0), dtype=np.uint8)
        self.bin_mappers: List[BinMapper] = []
        self.used_feature_map: List[int] = []
        self.num_total_features: int = 0
        self.feature_names: List[str] = []
        self.metadata: Metadata = Metadata(0)
        self.max_num_bin: int = 0
        self.num_bin_per_feature: np.ndarray = np.zeros(0, dtype=np.int32)
        self.bundle: Optional[BundleLayout] = None
        self.monotone_constraints: Optional[np.ndarray] = None
        self.raw_data: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, data, config: Config,
                    label: Optional[Sequence[float]] = None,
                    weights: Optional[Sequence[float]] = None,
                    group: Optional[Sequence[int]] = None,
                    init_score: Optional[Sequence[float]] = None,
                    feature_names: Optional[List[str]] = None,
                    categorical_feature: Optional[
                        Sequence[Union[int, str]]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    mappers: Optional[List[BinMapper]] = None,
                    bundle: Optional[BundleLayout] = None,
                    keep_raw_data: bool = False
                    ) -> "BinnedDataset":
        """Bin a dense float matrix or a scipy sparse matrix.

        categorical_feature : column indices or names of categorical
            columns (``config.categorical_feature`` when None)
        group : query sizes, summing to the rows (ranking objectives).
        reference : a training dataset whose bin mappers and bundle
            layout this one reuses (validation sets; reference:
            dataset_loader.cpp:299).
        mappers : one BinMapper per column, used instead of finding bins
            (``convert.bin_mappers_from_numpy`` carries another
            package's mappers across this way); with them the data is
            bundled by ``bundle`` (``convert.bundle_layout_from_numpy``)
            and left unbundled when that is None.
        keep_raw_data : keep the dense matrix as ``raw_data`` (linear
            trees fit and predict over raw values); sparse input is
            fatal with it, as in the reference.
        """
        is_sparse = hasattr(data, "tocsc")
        if is_sparse:
            data = data.tocsc()
            if not data.has_canonical_format:
                # duplicate (row, col) entries sum, as in a dense matrix;
                # copy first: tocsc() may alias the caller's matrix
                data = data.copy()
                data.sum_duplicates()
            if keep_raw_data:
                log.fatal("keep_raw_data/linear_tree requires dense input")
        else:
            data = np.asarray(data)
            if data.dtype not in (np.float32, np.float64):
                data = data.astype(np.float64)
            if data.ndim != 2:
                log.fatal("Training data must be 2-dimensional")
        n, num_total_features = data.shape
        config.check_slice()
        columns = _Columns(data, is_sparse)

        self = cls()
        self.num_total_features = num_total_features
        self.feature_names = list(feature_names) if feature_names else [
            f"Column_{i}" for i in range(num_total_features)]

        if reference is not None:
            self.bin_mappers = reference.bin_mappers
            self.used_feature_map = reference.used_feature_map
            self.num_bin_per_feature = reference.num_bin_per_feature
            self.max_num_bin = reference.max_num_bin
            self.bundle = reference.bundle
            self.monotone_constraints = reference.monotone_constraints
        else:
            if categorical_feature is None and config.categorical_feature:
                categorical_feature = config.categorical_feature
            cat_set = _resolve_categorical(categorical_feature,
                                           self.feature_names)
            sample_bin_cols: List[np.ndarray] = []
            if mappers is None:
                with obs.scope("io::find_bins"):
                    mappers, sample_bin_cols = _find_mappers(
                        columns, n, config, cat_set)
            elif len(mappers) != num_total_features:
                log.fatal("%d bin mappers for %d columns"
                          % (len(mappers), num_total_features))
            self.bin_mappers = [m for m in mappers if not m.is_trivial]
            self.used_feature_map = [i for i, m in enumerate(mappers)
                                     if not m.is_trivial]
            if not self.bin_mappers:
                log.warning("There are no meaningful features which "
                            "satisfy the provided configuration. "
                            "Decreasing Dataset parameters min_data_in_bin "
                            "or min_data_in_leaf and re-constructing "
                            "Dataset might resolve this warning.")
            self.num_bin_per_feature = np.asarray(
                [m.num_bin for m in self.bin_mappers], dtype=np.int32)
            self.max_num_bin = int(self.num_bin_per_feature.max()) if len(
                self.num_bin_per_feature) else 1
            self._set_constraints(config)
            if bundle is not None:
                self.bundle = bundle
            elif (sample_bin_cols and config.enable_bundle
                  and len(self.bin_mappers) > 1):
                with obs.scope("io::efb_bundle"):
                    self._find_bundles(sample_bin_cols, config)

        def binned_col(j: int) -> np.ndarray:
            return columns.binned(self.used_feature_map[j],
                                  self.bin_mappers[j], n)

        # uint8 bins while every feature (or bundle) has at most 256
        # bins, else uint16 (reference io/dataset.py:261-269)
        with obs.scope("io::apply_bins"):
            if self.bundle is not None:
                zero_bins = np.asarray(
                    [m.default_bin for m in self.bin_mappers],
                    dtype=np.int32)
                dtype = (np.uint8 if self.bundle.num_bundled_bins <= 256
                         else np.uint16)
                self.bins = bundle_columns(binned_col, self.bundle,
                                           zero_bins, n, dtype)
            else:
                dtype = np.uint8 if self.max_num_bin <= 256 else np.uint16
                bins = np.empty((n, len(self.bin_mappers)), dtype=dtype)
                for j in range(len(self.bin_mappers)):
                    bins[:, j] = binned_col(j)
                self.bins = bins

        if keep_raw_data:
            self.raw_data = data

        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weights(weights)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        obs_events.emit(
            "dataset", num_data=n, num_features=self.num_features,
            num_total_features=num_total_features,
            max_num_bin=self.max_num_bin,
            bundled=self.bundle is not None,
            aligned_to_reference=reference is not None)
        return self

    def _set_constraints(self, config: Config) -> None:
        """``monotone_constraints`` (one value per column) mapped to the
        used features (reference ``_set_constraints``)."""
        if config.monotone_constraints:
            mc = np.zeros(len(self.bin_mappers), dtype=np.int8)
            for j, f in enumerate(self.used_feature_map):
                if f < len(config.monotone_constraints):
                    mc[j] = config.monotone_constraints[f]
            self.monotone_constraints = mc

    # ------------------------------------------------------------------
    def _find_bundles(self, sample_bin_cols: List[np.ndarray],
                      config: Config) -> None:
        """Greedy EFB over the sampled binned columns (reference:
        Dataset::FindGroups, src/io/dataset.cpp:107). Only numerical,
        non-NaN-missing, mostly-zero features are candidates."""
        sample_cnt = len(sample_bin_cols[0])
        zero_bins = np.asarray([m.default_bin for m in self.bin_mappers],
                               dtype=np.int32)
        masks: List[Optional[np.ndarray]] = []
        for j, m in enumerate(self.bin_mappers):
            if (m.bin_type == BinType.CATEGORICAL
                    or m.missing_type == MissingType.NAN
                    or m.num_bin < 2):
                masks.append(None)
                continue
            nz = sample_bin_cols[j] != zero_bins[j]
            # bundling pays off on sparse columns only (reference:
            # kSparseThreshold, include/LightGBM/bin.h:39)
            masks.append(nz if nz.mean() <= 0.3 else None)
        if all(mk is None for mk in masks):
            return
        max_bundle_bins = max(self.max_num_bin, min(config.max_bin + 1, 256))
        groups = find_groups(masks, self.num_bin_per_feature, sample_cnt,
                             max_bundle_bins)
        if all(len(g) == 1 for g in groups):
            return
        self.bundle = build_layout(groups, self.num_bin_per_feature,
                                   zero_bins, self.max_num_bin)
        log.info("EFB: bundled %d features into %d columns"
                 % (len(self.bin_mappers), self.bundle.num_groups))

    def feature_bin_column(self, j: int) -> np.ndarray:
        """The bin column of used feature j, unbundled where needed."""
        if self.bundle is None:
            return self.bins[:, j]
        lay = self.bundle
        g = int(lay.group_of[j])
        col = self.bins[:, g].astype(np.int64)
        zb = self.bin_mappers[j].default_bin
        return np.where(lay.member[g][col] == j, lay.unmap[g][col],
                        zb).astype(self.bins.dtype)

    def feature_bins(self) -> np.ndarray:
        """[N, F] per-feature bin matrix (made when bundled)."""
        if self.bundle is None:
            return self.bins
        out = np.empty((self.bins.shape[0], len(self.bin_mappers)),
                       dtype=self.bins.dtype)
        for j in range(len(self.bin_mappers)):
            out[:, j] = self.feature_bin_column(j)
        return out

    # ------------------------------------------------------------------
    @property
    def num_data(self) -> int:
        return self.bins.shape[0]

    @property
    def num_features(self) -> int:
        return len(self.bin_mappers)

    def real_threshold(self, feature: int, bin_idx: int) -> float:
        """Bin index -> real-valued split threshold for model storage."""
        return self.bin_mappers[feature].bin_to_value(bin_idx)

    def real_feature_index(self, inner_feature: int) -> int:
        return self.used_feature_map[inner_feature]

    def inner_feature_index(self, real_feature: int) -> int:
        """The inner index of original column ``real_feature``, -1 when
        the column is not used (reference ``inner_feature_index``,
        lightgbm_tpu/io/dataset.py:382)."""
        try:
            return self.used_feature_map.index(real_feature)
        except ValueError:
            return -1

    def feature_infos(self) -> List[str]:
        infos = ["none"] * self.num_total_features
        for f, bm in zip(self.used_feature_map, self.bin_mappers):
            infos[f] = bm.feature_info()
        return infos


class _Columns:
    """Column access to a dense matrix or a CSC matrix: a sparse column
    is its (row indices, values) pair, never a dense vector."""

    def __init__(self, data, is_sparse: bool):
        self.data = data
        self.is_sparse = is_sparse

    def nonzero(self, f: int):
        d = self.data
        sl = slice(int(d.indptr[f]), int(d.indptr[f + 1]))
        return d.indices[sl], np.asarray(d.data[sl], dtype=np.float64)

    def sample(self, f: int, sample_idx: Optional[np.ndarray]):
        """(sampled values, their positions in the sample): every value
        of a dense column, the stored values of a sparse one (the
        reference's sample keeps the non-zeros and a sample count,
        DatasetLoader::SampleTextData)."""
        if not self.is_sparse:
            col = self.data[:, f]
            return (col if sample_idx is None else col[sample_idx]), None
        rows, vals = self.nonzero(f)
        if sample_idx is None:
            return vals, rows
        pos = np.searchsorted(sample_idx, rows)
        ok = pos < len(sample_idx)
        ok[ok] &= sample_idx[pos[ok]] == rows[ok]
        return vals[ok], pos[ok]

    def binned(self, f: int, bm: BinMapper, n: int) -> np.ndarray:
        if not self.is_sparse:
            return bm.value_to_bin(self.data[:, f])
        rows, vals = self.nonzero(f)
        out = np.full(n, bm.default_bin, dtype=np.int32)
        out[rows] = bm.value_to_bin(vals)
        return out


def _find_mappers(columns: _Columns, n: int, config: Config,
                  cat_set: set):
    """Sampling pass (bin_construct_sample_cnt, config.h:641) and one
    ``find_bin`` per column, with the reference's knobs. Returns the
    mappers and the sampled bin column of each non-trivial one (what
    EFB groups by)."""
    num_total_features = columns.data.shape[1]
    sample_cnt = min(config.bin_construct_sample_cnt, n)
    rng = np.random.RandomState(config.data_random_seed)
    sample_idx = (np.sort(rng.choice(n, sample_cnt, replace=False))
                  if sample_cnt < n else None)
    max_bin_by_feature = config.max_bin_by_feature or []
    if max_bin_by_feature:
        if len(max_bin_by_feature) != num_total_features:
            log.fatal("Length of max_bin_by_feature (%d) != number of "
                      "features (%d)" % (len(max_bin_by_feature),
                                         num_total_features))
        if min(max_bin_by_feature) <= 1:
            log.fatal("Each entry of max_bin_by_feature must be > 1")
    forced_bounds = _load_forced_bounds(config)
    mappers: List[BinMapper] = []
    sample_bin_cols: List[np.ndarray] = []
    for f in range(num_total_features):
        sample_col, sample_rows = columns.sample(f, sample_idx)
        bm = BinMapper()
        bm.find_bin(
            sample_col, total_sample_cnt=sample_cnt,
            max_bin=(max_bin_by_feature[f] if max_bin_by_feature
                     else config.max_bin),
            min_data_in_bin=config.min_data_in_bin,
            min_split_data=config.min_data_in_leaf,
            pre_filter=config.feature_pre_filter,
            bin_type=(BinType.CATEGORICAL if f in cat_set
                      else BinType.NUMERICAL),
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
            forced_upper_bounds=forced_bounds.get(f))
        mappers.append(bm)
        if bm.is_trivial:
            continue
        if sample_rows is None:
            sample_bin_cols.append(
                bm.value_to_bin(sample_col).astype(np.int32))
        else:
            sb = np.full(sample_cnt, bm.default_bin, dtype=np.int32)
            sb[sample_rows] = bm.value_to_bin(sample_col)
            sample_bin_cols.append(sb)
    return mappers, sample_bin_cols


def _load_forced_bounds(config) -> dict:
    """forcedbins_filename (config.h:740): a JSON list of
    {"feature": i, "bin_upper_bound": [...]} entries."""
    forced_bounds: dict = {}
    if config.forcedbins_filename:
        import json
        try:
            with open(config.forcedbins_filename) as fh:
                for entry in json.load(fh):
                    forced_bounds[int(entry["feature"])] = [
                        float(v) for v in entry["bin_upper_bound"]]
        except (OSError, ValueError, KeyError, TypeError) as e:
            log.warning("Cannot load forced bins from %s: %s"
                        % (config.forcedbins_filename, e))
    return forced_bounds


def _resolve_categorical(categorical_feature, feature_names) -> set:
    """Column indices of ``categorical_feature``: indices, or names of
    ``feature_names``, as a list or a comma-separated string."""
    cats: set = set()
    if categorical_feature is None or categorical_feature == "auto":
        return cats
    if isinstance(categorical_feature, str):
        categorical_feature = [c for c in categorical_feature.split(",")
                               if c]
    for c in categorical_feature:
        if isinstance(c, str) and not c.lstrip("-").isdigit():
            if c in feature_names:
                cats.add(feature_names.index(c))
            else:
                log.warning("Unknown categorical feature name: %s" % c)
        else:
            cats.add(int(c))
    return cats
