"""Binned dataset + metadata for lightgbm_tpu_torch.

Port of the dense numerical path of ``lightgbm_tpu/io/dataset.py``
(reference: include/LightGBM/dataset.h:426,46; construction after
DatasetLoader::ConstructFromSampleData, src/io/dataset_loader.cpp:593):

  sample rows -> BinMapper.find_bin per feature -> value_to_bin over the
  full column -> drop trivial features -> one row-major uint8 matrix.

The matrix stays on the host here; the learner copies it to the device
once. Sparse input, categorical features and EFB bundles are later
slices: a dataset whose sparse columns would bundle raises.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..config import Config
from ..utils import log
from .binning import BinMapper, BinType, MissingType


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

    bins : np.ndarray [num_data, num_used_features] uint8
    bin_mappers : one BinMapper per *used* (non-trivial) feature
    used_feature_map : original column index per used feature
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

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix(cls, data: np.ndarray, config: Config,
                    label: Optional[Sequence[float]] = None,
                    weights: Optional[Sequence[float]] = None,
                    group: Optional[Sequence[int]] = None,
                    init_score: Optional[Sequence[float]] = None,
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["BinnedDataset"] = None,
                    mappers: Optional[List[BinMapper]] = None
                    ) -> "BinnedDataset":
        """Bin a dense float matrix.

        group : query sizes, summing to the rows (ranking objectives).
        reference : a training dataset whose bin mappers this one reuses
            (validation sets; reference: dataset_loader.cpp:299).
        mappers : one BinMapper per column, used instead of finding bins
            (``convert.bin_mappers_from_numpy`` carries another
            package's mappers across this way).
        """
        if hasattr(data, "tocsc"):
            log.unsupported("sparse input", "item 11")
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.float64):
            data = data.astype(np.float64)
        if data.ndim != 2:
            log.fatal("Training data must be 2-dimensional")
        n, num_total_features = data.shape
        config.check_slice()

        self = cls()
        self.num_total_features = num_total_features
        self.feature_names = list(feature_names) if feature_names else [
            f"Column_{i}" for i in range(num_total_features)]

        if reference is not None:
            self.bin_mappers = reference.bin_mappers
            self.used_feature_map = reference.used_feature_map
            self.num_bin_per_feature = reference.num_bin_per_feature
            self.max_num_bin = reference.max_num_bin
        else:
            if mappers is None:
                mappers = _find_mappers(data, config)
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
            if self.max_num_bin > 256:
                log.unsupported("more than 256 bins per feature", "item 26")

        bins = np.empty((n, len(self.bin_mappers)), dtype=np.uint8)
        for j, (f, bm) in enumerate(zip(self.used_feature_map,
                                        self.bin_mappers)):
            bins[:, j] = bm.value_to_bin(data[:, f])
        self.bins = bins

        self.metadata = Metadata(n)
        if label is not None:
            self.metadata.set_label(label)
        self.metadata.set_weights(weights)
        self.metadata.set_group(group)
        self.metadata.set_init_score(init_score)
        return self

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

    def feature_infos(self) -> List[str]:
        infos = ["none"] * self.num_total_features
        for f, bm in zip(self.used_feature_map, self.bin_mappers):
            infos[f] = bm.feature_info()
        return infos


def _find_mappers(data: np.ndarray, config: Config) -> List[BinMapper]:
    """Sampling pass (bin_construct_sample_cnt, config.h:641) and one
    ``find_bin`` per column, with the reference's knobs. Raises when the
    sampled sparse columns would form EFB bundles (a later slice)."""
    n, num_total_features = data.shape
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
    sample_bin_cols: List[Optional[np.ndarray]] = []
    for f in range(num_total_features):
        col = data[:, f]
        sample_col = col if sample_idx is None else col[sample_idx]
        bm = BinMapper()
        bm.find_bin(
            sample_col, total_sample_cnt=sample_cnt,
            max_bin=(max_bin_by_feature[f] if max_bin_by_feature
                     else config.max_bin),
            min_data_in_bin=config.min_data_in_bin,
            min_split_data=config.min_data_in_leaf,
            pre_filter=config.feature_pre_filter,
            bin_type=BinType.NUMERICAL,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing,
            forced_upper_bounds=forced_bounds.get(f))
        mappers.append(bm)
        sample_bin_cols.append(None if bm.is_trivial
                               else bm.value_to_bin(sample_col))
    if config.enable_bundle and _bundles_would_form(
            [m for m in mappers if not m.is_trivial],
            [c for c in sample_bin_cols if c is not None], sample_cnt,
            config):
        log.unsupported("EFB bundling of sparse columns (set "
                        "enable_bundle=false to train unbundled)",
                        "item 11")
    return mappers


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


def _bundles_would_form(mappers: List[BinMapper],
                        sample_bin_cols: List[np.ndarray],
                        sample_cnt: int, config: Config) -> bool:
    """Whether the reference's greedy EFB (``io/efb.py find_groups``,
    after Dataset::FindGroups, src/io/dataset.cpp:107) would put two
    features into one bundle on this sample: only mostly-zero,
    non-NaN-missing numerical features are candidates; each goes into
    the first group whose conflict count and bin budget allow it."""
    if len(mappers) < 2:
        return False
    num_bins = np.asarray([m.num_bin for m in mappers], dtype=np.int32)
    masks = []
    for m, col in zip(mappers, sample_bin_cols):
        if m.missing_type == MissingType.NAN or m.num_bin < 2:
            continue
        nz = col != m.default_bin
        if nz.mean() <= 0.3:
            masks.append((nz, int(m.num_bin) - 1))
    if len(masks) < 2:
        return False
    max_bundle_bins = max(int(num_bins.max()), min(config.max_bin + 1, 256))
    max_conflict = int(1e-4 * sample_cnt)
    masks.sort(key=lambda mb: -int(mb[0].sum()))
    groups = []                    # [union mask, conflicts, bins]
    for mask, extra_bins in masks:
        for g in groups:
            if g[2] + extra_bins > max_bundle_bins:
                continue
            if g[1] + int((g[0] & mask).sum()) <= max_conflict:
                return True
        groups.append([mask.copy(), 0, 1 + extra_bins])
    return False
