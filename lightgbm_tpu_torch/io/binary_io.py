"""Binned-dataset binary cache.

Port of ``lightgbm_tpu/io/binary_io.py`` (reference: Dataset::
SaveBinaryFile, include/LightGBM/dataset.h:623; DatasetLoader::
LoadFromBinFile, src/io/dataset_loader.cpp:417): bin once, load again
without binning. The container is npz with a pickled block of the bin
mappers and the EFB layout. That block names this package's classes, so
a file of ``lightgbm_tpu`` and one of this package are not
interchangeable; each has its own magic string, and loading the other's
raises. The port's ``BinnedDataset`` keeps its bins on the host (the
learner copies them to its device), so a loaded set is where the saved
one was.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils import log
from .dataset import BinnedDataset, Metadata

_MAGIC = "lightgbm_tpu_torch.binned.v1"


def save_binary(dataset: BinnedDataset, path: str) -> None:
    """Write ``dataset`` to ``path`` (npz: ``np.savez`` adds ``.npz``
    when the name has no such suffix)."""
    meta = {
        "magic": _MAGIC,
        "bin_mappers": dataset.bin_mappers,
        "used_feature_map": dataset.used_feature_map,
        "num_total_features": dataset.num_total_features,
        "feature_names": dataset.feature_names,
        "max_num_bin": dataset.max_num_bin,
        "monotone_constraints": dataset.monotone_constraints,
        "bundle": dataset.bundle,
    }
    md = dataset.metadata
    empty = np.zeros(0)
    np.savez_compressed(
        path, bins=dataset.bins,
        num_bin_per_feature=dataset.num_bin_per_feature,
        label=md.label,
        weights=md.weights if md.weights is not None else empty,
        query_boundaries=(md.query_boundaries
                          if md.query_boundaries is not None else empty),
        init_score=md.init_score if md.init_score is not None else empty,
        raw_data=(dataset.raw_data if dataset.raw_data is not None
                  else empty),
        meta=np.frombuffer(pickle.dumps(meta), dtype=np.uint8))


def load_binary(path: str) -> BinnedDataset:
    """A dataset written by :func:`save_binary` (``path`` with or
    without its ``.npz``); another container raises."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    meta = pickle.loads(z["meta"].tobytes())
    if not isinstance(meta, dict) or meta.get("magic") != _MAGIC:
        log.fatal("Not a lightgbm_tpu_torch binary dataset: %s" % path)
    ds = BinnedDataset()
    ds.bins = z["bins"]
    ds.num_bin_per_feature = z["num_bin_per_feature"]
    for key in ("bin_mappers", "used_feature_map", "num_total_features",
                "feature_names", "max_num_bin", "monotone_constraints",
                "bundle"):
        setattr(ds, key, meta[key])
    if len(z["raw_data"]):
        ds.raw_data = z["raw_data"]
    md = Metadata(ds.bins.shape[0])
    md.set_label(z["label"])
    if len(z["weights"]):
        md.set_weights(z["weights"])
    if len(z["query_boundaries"]):
        md.query_boundaries = z["query_boundaries"]
    if len(z["init_score"]):
        md.set_init_score(z["init_score"])
    ds.metadata = md
    return ds
