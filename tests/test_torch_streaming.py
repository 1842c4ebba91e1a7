"""The streaming dataset and the binary dataset cache of the port (ROADMAP
item 18b), on the CPU.

- ``ChunkedBuffer``: appends across chunks, the empty buffer, an exact
  chunk boundary, a column mismatch;
- ``StreamingDataset``: rows pushed in chunks with label, weight,
  init_score and query groups bin byte-equal (a) to the JAX package's
  ``StreamingDataset`` on the same chunks and to the port's
  ``from_matrix`` on the whole matrix; its misuses raise; the
  out-of-core route (``spill_dir``) spills shards whose bins are the
  in-memory ones (item 21);
- ``save_binary`` / ``load_binary``: bins, mappers' bounds and metadata
  byte-equal after the round trip (a), a model trained on the loaded
  set text-equal to one trained on the original; the two packages'
  files are not interchangeable.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu.io.streaming import StreamingDataset as RefStreaming
from lightgbm_tpu.io import binary_io as ref_binary_io
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io import binary_io
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.streaming import ChunkedBuffer, StreamingDataset
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


def test_chunked_buffer_appends_across_chunks():
    cb = ChunkedBuffer(3, chunk_rows=10)
    rng = np.random.RandomState(0)
    parts = [rng.randn(n, 3) for n in (4, 10, 17, 1)]
    for part in parts:
        cb.append_rows(part)
    want = np.concatenate(parts)
    assert len(cb) == want.shape[0] == 32
    np.testing.assert_array_equal(cb.coalesce(), want)


def test_chunked_buffer_empty_and_exact_boundary():
    empty = ChunkedBuffer(2)
    assert len(empty) == 0
    assert empty.coalesce().shape == (0, 2)
    cb = ChunkedBuffer(1, chunk_rows=8)
    cb.append_rows(np.arange(16, dtype=float).reshape(16, 1))
    assert len(cb) == 16 and len(cb._chunks) == 2
    np.testing.assert_array_equal(cb.coalesce()[:, 0], np.arange(16))
    cb.append_rows(np.array([[16.0]]))
    assert len(cb) == 17 and len(cb._chunks) == 3
    with pytest.raises(LightGBMError, match="columns"):
        cb.append_rows(np.zeros((2, 3)))


def _rows(n=1200, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[rng.rand(n) < 0.1, 2] = np.nan
    X[rng.rand(n) < 0.7, 4] = 0.0
    y = (X[:, 0] - X[:, 1] > 0).astype(float)
    w = rng.uniform(0.5, 2.0, n)
    init = 0.1 * rng.randn(n)
    group = np.full(n // 20, 20)
    return X, y, w, init, group


def _stream(cls, params, X, y, w, init, group, chunk=300):
    sd = cls(num_features=X.shape[1], params=params, chunk_rows=256,
             has_weight=True, has_init_score=True, has_group=True)
    for lo in range(0, len(X), chunk):
        sd.push_rows(X[lo:lo + chunk], label=y[lo:lo + chunk],
                     weight=w[lo:lo + chunk], init_score=init[lo:lo + chunk],
                     group=group[lo // 20:(lo + chunk) // 20])
    assert sd.num_pushed == len(X)
    return sd.finalize()


@pytest.mark.parametrize("params", [{}, {"max_bin": 400}],
                         ids=["uint8", "uint16"])
def test_streamed_bins_equal_reference_and_from_matrix(params):
    X, y, w, init, group = _rows()
    params = dict(params, objective="lambdarank", verbose=-1)
    port = _stream(StreamingDataset, dict(params, device_type="cpu"),
                   X, y, w, init, group)
    ref = _stream(RefStreaming, params, X, y, w, init, group)
    whole = BinnedDataset.from_matrix(X, Config.from_params(params), label=y,
                                      weights=w, init_score=init,
                                      group=group)
    for other in (ref, whole):
        assert port.bins.dtype == other.bins.dtype
        np.testing.assert_array_equal(port.bins, other.bins)
        np.testing.assert_array_equal(port.num_bin_per_feature,
                                      other.num_bin_per_feature)
        assert port.used_feature_map == list(other.used_feature_map)
        for a, b in zip(port.bin_mappers, other.bin_mappers):
            np.testing.assert_array_equal(a.bin_upper_bound,
                                          b.bin_upper_bound)
        for key in ("label", "weights", "init_score", "query_boundaries"):
            np.testing.assert_array_equal(getattr(port.metadata, key),
                                          getattr(other.metadata, key))
    assert port.bins.dtype == (np.uint16 if "max_bin" in params
                               else np.uint8)


def test_streaming_misuse_raises():
    X, y, _, _, _ = _rows(100)
    sd = StreamingDataset(num_features=6, params={"device_type": "cpu"})
    with pytest.raises(LightGBMError, match="has_weight"):
        sd.push_rows(X[:10], label=y[:10], weight=np.ones(10))
    with pytest.raises(LightGBMError, match="columns"):
        sd.push_rows(X[:10, :5], label=y[:10])
    sd.push_rows(X[:50], label=y[:50])
    sd.push_rows(X[50:], label=y[50:80])
    with pytest.raises(LightGBMError, match="label values"):
        sd.finalize()
    with pytest.raises(LightGBMError, match="after finalize"):
        sd.push_rows(X[:10], label=y[:10])
    with pytest.raises(LightGBMError, match="no rows"):
        StreamingDataset(num_features=6).finalize()


@pytest.mark.parametrize("where", ["init", "finalize", "threshold"])
def test_spill_raises_naming_item_21(where, tmp_path):
    """Item 21 landed: the out-of-core route no longer raises. A
    ``spill_dir`` given at construction or to ``finalize`` routes the
    rows into a ShardedBinnedDataset whose bins are byte-equal (a) to
    ``from_matrix``'s; ``spill_threshold_rows`` without a ``spill_dir``
    keeps the in-memory dataset."""
    from lightgbm_tpu_torch.io.shards import ShardedBinnedDataset
    X, y, _, _, _ = _rows(100)
    params = {"verbosity": -1, "device_type": "cpu"}
    kw = {}
    if where == "init":
        kw["spill_dir"] = str(tmp_path)
    if where == "threshold":
        kw["spill_threshold_rows"] = 10
    sd = StreamingDataset(num_features=6, params=params, chunk_rows=32,
                          **kw)
    sd.push_rows(X, label=y)
    ds = (sd.finalize(spill_dir=str(tmp_path), shard_rows=40)
          if where == "finalize" else sd.finalize())
    mem = BinnedDataset.from_matrix(X, Config.from_params(params), label=y)
    if where == "threshold":
        assert isinstance(ds, BinnedDataset)
        assert np.array_equal(ds.bins, mem.bins)
        return
    assert isinstance(ds, ShardedBinnedDataset)
    assert np.array_equal(ds.assemble_bins(), mem.bins)
    np.testing.assert_array_equal(ds.metadata.label, mem.metadata.label)


def _train_on(handle, params, rounds=4):
    ds = lgb.Dataset(None, params=params)
    ds._handle = handle
    return lgb.train(params, ds, num_boost_round=rounds)


def test_streamed_dataset_trains_like_the_whole_matrix():
    X, y, w, _, _ = _rows()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device_type": "cpu"}
    sd = StreamingDataset(num_features=6, params=params, chunk_rows=128,
                          has_weight=True)
    for lo in range(0, 1200, 250):
        sd.push_rows(X[lo:lo + 250], label=y[lo:lo + 250],
                     weight=w[lo:lo + 250])
    streamed = _train_on(sd.finalize(), params)
    whole = lgb.train(params, lgb.Dataset(X, label=y, weight=w),
                      num_boost_round=4)
    assert streamed.model_to_string() == whole.model_to_string()


@pytest.mark.parametrize("kind", ["dense", "bundled", "wide", "ranking"])
def test_binary_cache_round_trip(kind, tmp_path):
    X, y, w, init, group = _rows()
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "device_type": "cpu"}
    kw = {"label": y, "weight": w}
    if kind == "bundled":
        # eight mutually exclusive sparse columns: EFB bundles them
        rng = np.random.RandomState(1)
        onehot = np.zeros((len(X), 8))
        onehot[np.arange(len(X)), rng.randint(0, 8, len(X))] = \
            rng.uniform(1, 2, len(X))
        X = np.hstack([X, onehot])
    if kind == "wide":
        params["max_bin"] = 600
    if kind == "ranking":
        params["objective"] = "lambdarank"
        kw.update(group=group, init_score=init)
        y = np.floor(np.abs(X[:, 0]) * 2).clip(0, 3)
        kw["label"] = y
    ds = lgb.Dataset(X, params=params, **kw).construct()
    src = ds.handle
    path = str(tmp_path / "train.bin")
    binary_io.save_binary(src, path)
    loaded = binary_io.load_binary(path)
    assert loaded.bins.dtype == src.bins.dtype
    np.testing.assert_array_equal(loaded.bins, src.bins)
    np.testing.assert_array_equal(loaded.num_bin_per_feature,
                                  src.num_bin_per_feature)
    assert (loaded.bundle is None) == (src.bundle is None)
    for key in ("label", "weights", "init_score", "query_boundaries"):
        a, b = getattr(loaded.metadata, key), getattr(src.metadata, key)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert _train_on(loaded, params).model_to_string() == \
        lgb.train(params, ds, num_boost_round=4).model_to_string()
    if kind == "bundled":
        assert src.bundle is not None


def test_binary_files_are_not_interchangeable(tmp_path):
    X, y, _, _, _ = _rows(300)
    ds = lgb.Dataset(X, label=y, params={"device_type": "cpu"}).construct()
    path = str(tmp_path / "port.bin")
    binary_io.save_binary(ds.handle, path)
    with pytest.raises(Exception, match="Not a lightgbm_tpu binary"):
        ref_binary_io.load_binary(path + ".npz")
    import lightgbm_tpu as ref_lgb
    rds = ref_lgb.Dataset(X, label=y).construct()
    ref_path = str(tmp_path / "ref.bin")
    ref_binary_io.save_binary(rds.handle, ref_path)
    with pytest.raises(LightGBMError, match="lightgbm_tpu_torch binary"):
        binary_io.load_binary(ref_path)
