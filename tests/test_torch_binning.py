"""The port's binning against the JAX package's, at level (a): the bin
upper bounds, missing types and the binned matrix are byte-equal.

The reference sends columns with more than 512 distinct values to its
native ``GreedyFindBin`` when that library is built (else to the same
NumPy loop the port carries); the fixtures include such a column.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu.config as ref_config
import lightgbm_tpu.io.dataset as ref_dataset
import lightgbm_tpu_torch.config as port_config
import lightgbm_tpu_torch.io.dataset as port_dataset
from lightgbm_tpu_torch.convert import bin_mappers_from_numpy

torch.set_num_threads(1)


def _fixture(kind: str, seed: int = 0):
    rng = np.random.RandomState(seed)
    n = 3000
    X = np.empty((n, 5))
    X[:, 0] = rng.randn(n)                              # > 512 distinct
    X[:, 1] = rng.randint(0, 40, size=n) / 4.0          # few distinct
    X[:, 2] = np.round(rng.randn(n) * 3)                # many zeros
    X[:, 3] = rng.exponential(size=n)                   # positive only
    X[:, 4] = -rng.exponential(size=n)                  # negative only
    if kind in ("nan", "nan_zero_as_missing"):
        X[rng.rand(n) < 0.1, 0] = np.nan
        X[rng.rand(n) < 0.05, 2] = np.nan
    params = {"verbose": -1, "enable_bundle": False}
    if kind == "nan_zero_as_missing":
        params["zero_as_missing"] = True
    if kind == "max_bin_63":
        params.update(max_bin=63, min_data_in_bin=5)
    if kind == "sampled":
        params["bin_construct_sample_cnt"] = 1000
    return X, params


def _both(X, params):
    ref = ref_dataset.BinnedDataset.from_matrix(
        X, ref_config.Config.from_params(params), label=np.zeros(len(X)))
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params(dict(params, device_type="cpu")),
        label=np.zeros(len(X)))
    return ref, port


@pytest.mark.parametrize("kind", ["plain", "nan", "nan_zero_as_missing",
                                  "max_bin_63", "sampled"])
def test_bins_byte_equal(kind):
    X, params = _fixture(kind)
    ref, port = _both(X, params)
    assert ref.used_feature_map == port.used_feature_map
    assert len(np.unique(X[:, 0][~np.isnan(X[:, 0])])) > 512
    for a, b in zip(ref.bin_mappers, port.bin_mappers):
        assert a.num_bin == b.num_bin
        assert a.missing_type == b.missing_type
        assert a.default_bin == b.default_bin
        assert a.bin_upper_bound.tobytes() == b.bin_upper_bound.tobytes()
        assert a.feature_info() == b.feature_info()
    assert ref.bins.dtype == port.bins.dtype == np.uint8
    assert ref.bins.tobytes() == port.bins.tobytes()


def test_validation_set_aligns_to_reference_bins():
    X, params = _fixture("nan")
    Xv, _ = _fixture("nan", seed=1)
    ref, port = _both(X, params)
    rv = ref_dataset.BinnedDataset.from_matrix(
        Xv, ref_config.Config.from_params(params), reference=ref)
    pv = port_dataset.BinnedDataset.from_matrix(
        Xv, port_config.Config.from_params(dict(params, device_type="cpu")),
        reference=port)
    assert pv.bin_mappers is port.bin_mappers
    assert rv.bins.tobytes() == pv.bins.tobytes()


def test_bin_mappers_carried_across_bin_identically():
    """``convert.bin_mappers_from_numpy`` takes the reference's
    ``BinMapper.to_dict()`` output; binning with those mappers gives the
    reference's matrix byte for byte."""
    X, params = _fixture("nan", seed=3)
    ref, _ = _both(X, params)
    dicts = [None] * X.shape[1]
    for j, f in enumerate(ref.used_feature_map):
        dicts[f] = ref.bin_mappers[j].to_dict()
    mappers = bin_mappers_from_numpy(dicts)
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params({"device_type": "cpu"}),
        mappers=mappers)
    assert port.bins.tobytes() == ref.bins.tobytes()


def test_bundles_that_would_form_raise():
    """Two mutually exclusive sparse columns form an EFB bundle in the
    reference and in the port alike (the old item-11 raise is gone):
    the same layout and the bundled matrix byte-equal (level a); with
    bundling off, the unbundled matrix byte-equal too. A bundle wider
    than 256 bins (item 26, which raised before the port had it) forms
    in both as a uint16 bundle column, byte-equal: two sparse columns
    of 150 bins each beside a dense one of ~400 (max_bin 511) bundle
    into one column of more than 256 bins."""
    rng = np.random.RandomState(0)
    n = 2000
    X = rng.randn(n, 3)
    X[:, 1] = 0.0
    X[:, 2] = 0.0
    X[:200, 1] = rng.rand(200) + 1
    X[200:400, 2] = rng.rand(200) + 1
    ref = ref_dataset.BinnedDataset.from_matrix(
        X, ref_config.Config.from_params({"verbose": -1}))
    port = port_dataset.BinnedDataset.from_matrix(
        X, port_config.Config.from_params({"device_type": "cpu",
                                           "verbose": -1}))
    assert ref.bundle is not None and port.bundle is not None
    assert port.bundle.groups == ref.bundle.groups
    assert port.bins.tobytes() == ref.bins.tobytes()
    params = {"verbose": -1, "enable_bundle": False}
    ref, port = _both(X, params)
    assert port.bundle is None
    assert ref.bins.tobytes() == port.bins.tobytes()
    X = rng.randn(n, 3)
    X[:, 0] = 0.0
    X[:, 1] = 0.0
    X[:150, 0] = np.arange(1, 151)
    X[150:300, 1] = np.arange(1, 151)
    X[:, 2] = rng.randint(0, 400, n)
    ref, port = _both(X, {"verbose": -1, "max_bin": 511,
                          "min_data_in_bin": 1})
    assert ref.bundle is not None and port.bundle is not None
    assert port.bundle.groups == ref.bundle.groups
    assert port.bundle.num_bundled_bins == ref.bundle.num_bundled_bins > 256
    assert ref.bins.dtype == port.bins.dtype == np.uint16
    assert ref.bins.tobytes() == port.bins.tobytes()