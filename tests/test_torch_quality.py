"""The port's quality plane (``lightgbm_tpu_torch/obs/quality.py``)
against the JAX package's on the CPU.

- ``psi`` and ``js_divergence`` equal the reference's (level a: the
  same f64 NumPy) on random, empty, all-zero and sparse count vectors;
- ``ProfileBuilder`` counts from the same binned rows, fed in padded
  blocks, are byte-equal to the reference's (level a), NaN, zero and
  categorical bins included; the profile's JSON round-trips;
- the projection of a training-grid profile onto a model's serving
  grid equals the reference's for the same model text;
- a ``BucketedPredictor`` with a ``QualityMonitor`` on the same rows, a
  clean window then a shifted one, drains the reference's drift report
  and ``quality/...`` gauges.
"""
import json

import numpy as np
import pytest

import lightgbm_tpu as ref_lgb
from lightgbm_tpu.obs import quality as ref_quality
from lightgbm_tpu.obs.registry import MetricsRegistry as RefRegistry
from lightgbm_tpu.serve import BucketedPredictor as RefBucketed
from lightgbm_tpu.serve import StackedForest as RefForest

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs import quality
from lightgbm_tpu_torch.obs.registry import MetricsRegistry
from lightgbm_tpu_torch.serve import BucketedPredictor, StackedForest
from _torch_watch_env import watch_env_defaults  # noqa: F401

kRows = 900
kParams = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
           "verbosity": -1, "min_data_in_leaf": 10,
           "bin_construct_sample_cnt": kRows, "categorical_feature": [4]}


def _data():
    """A NaN-heavy column, an exact-zero-heavy column and a categorical
    column: every sentinel lane."""
    rng = np.random.default_rng(17)
    X = rng.normal(size=(kRows, 6))
    X[rng.random(kRows) < 0.12, 2] = np.nan
    X[rng.random(kRows) < 0.55, 3] = 0.0
    X[:, 4] = rng.integers(0, 7, kRows)
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1])
         > 0.2).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def both():
    X, y = _data()
    ref_ds = ref_lgb.Dataset(X, label=y, params=dict(kParams))
    ref_ds.construct()
    port_ds = lgb.Dataset(X, label=y, params=dict(kParams,
                                                  device_type="cpu"))
    port_ds.construct()
    bst = ref_lgb.train(dict(kParams), ref_lgb.Dataset(X, label=y),
                        num_boost_round=3)
    text = bst.model_to_string()
    return X, y, ref_ds.handle, port_ds.handle, text


def _profile(mod, ds, y, **kw):
    """Blocks of 256 rows, the last one zero-padded (as a spill pass
    feeds fixed-shape buffers)."""
    pb = mod.ProfileBuilder(ds.bin_mappers, ds.used_feature_map, **kw)
    bins = np.asarray(ds.bins)
    for lo in range(0, bins.shape[0], 256):
        blk = bins[lo:lo + 256]
        n = blk.shape[0]
        if n < 256:
            blk = np.concatenate(
                [blk, np.zeros((256 - n, blk.shape[1]), blk.dtype)])
        pb.add_block(blk, n)
    pb.add_labels(y)
    return pb.finalize()


@pytest.mark.parametrize("seed", range(4))
def test_psi_and_js_match_reference(seed):
    rng = np.random.RandomState(seed)
    ref_c = rng.randint(0, 50, 40)
    live = rng.randint(0, 50, 40)
    live[rng.rand(40) < 0.3] = 0
    for a, b in ((ref_c, live), (ref_c, ref_c), (ref_c, np.zeros(40)),
                 (np.zeros(3), live[:3]), ([1, 0, 0], [0, 0, 1])):
        assert quality.psi(a, b) == ref_quality.psi(a, b)
        assert quality.js_divergence(a, b) == \
            ref_quality.js_divergence(a, b)
    assert quality.histogram_edges(live, 32) == \
        ref_quality.histogram_edges(live, 32)
    edges = quality.histogram_edges(live, 8)
    np.testing.assert_array_equal(quality.fixed_histogram(live, edges),
                                  ref_quality.fixed_histogram(live, edges))


def test_profile_counts_byte_equal_to_reference(both, tmp_path):
    X, y, ref_ds, port_ds, _ = both
    np.testing.assert_array_equal(np.asarray(port_ds.bins),
                                  np.asarray(ref_ds.bins))
    port = _profile(quality, port_ds, y, device="cpu")
    ref = _profile(ref_quality, ref_ds, y)
    assert port.num_rows == ref.num_rows == kRows
    assert len(port.counts) == len(ref.counts)
    for a, b in zip(port.counts, ref.counts):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # as JSON text: the NaN bound of a NaN-missing feature is not equal
    # to itself as a float
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    path = str(tmp_path / "profile.json")
    port.dump(path)
    assert json.dumps(quality.ReferenceProfile.load(path).to_dict()) == \
        json.dumps(port.to_dict())


def _monitor_pair(both):
    X, y, ref_ds, port_ds, text = both
    profile = _profile(quality, port_ds, y, device="cpu")
    ref_profile = _profile(ref_quality, ref_ds, y)
    port_bst = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    ref_bst = ref_lgb.Booster(model_str=text)
    scores = ref_bst.predict(X)
    profile.attach_scores(scores)
    ref_profile.attach_scores(scores)
    port_forest = StackedForest.from_gbdt(port_bst)
    ref_forest = RefForest.from_gbdt(ref_bst)
    return (quality.QualityMonitor(port_forest, profile=profile),
            ref_quality.QualityMonitor(ref_forest, profile=ref_profile),
            port_forest, ref_forest)


def test_serving_grid_projection_matches_reference(both):
    mon, ref_mon, _, _ = _monitor_pair(both)
    assert mon._width == ref_mon._width
    np.testing.assert_array_equal(mon._used, ref_mon._used)
    np.testing.assert_array_equal(mon._ref, ref_mon._ref)
    np.testing.assert_array_equal(mon._ref_valid, ref_mon._ref_valid)


def _shifted(X):
    return np.ascontiguousarray(
        X + 2.5 * np.nanstd(X, axis=0, keepdims=True) + 0.5,
        dtype=np.float32)


def test_bucketed_predictor_monitor_gives_the_references_drift(both):
    X = both[0]
    mon, ref_mon, forest, ref_forest = _monitor_pair(both)
    pred = BucketedPredictor(forest, min_bucket=16, max_bucket=256,
                             quality=mon)
    ref_pred = RefBucketed(ref_forest, min_bucket=16, max_bucket=256,
                           quality=ref_mon)
    reg, ref_reg = MetricsRegistry(), RefRegistry()
    reports = []
    for rows in (np.ascontiguousarray(X[:600], dtype=np.float32),
                 _shifted(X[:600])):
        out = pred.predict(rows)
        ref_out = ref_pred.predict(rows)
        np.testing.assert_array_equal(out, ref_out)
        mon.observe_scores(out)
        ref_mon.observe_scores(ref_out)
        reports.append((mon.drain(reg), ref_mon.drain(ref_reg)))
    for port, ref in reports:
        assert port == ref
    assert reports[0][0]["rows"] == 600 and not reports[0][0]["carried"]
    assert reports[0][0]["psi_max"] < 0.25
    assert reports[1][0]["psi_max"] >= 0.25
    assert reg.snapshot()["gauges"] == ref_reg.snapshot()["gauges"]
    assert reg.snapshot()["counters"] == ref_reg.snapshot()["counters"]


def test_under_filled_window_is_carried(both):
    mon, _, _, _ = _monitor_pair(both)
    mon.min_window_rows = 100
    X = both[0]
    reg = MetricsRegistry()
    mon.accumulate(np.ascontiguousarray(X[:40], dtype=np.float32), 40,
                   device="cpu")
    rep = mon.drain(reg)
    assert rep["carried"] and rep["pending_rows"] == 40
    mon.accumulate(np.ascontiguousarray(X[40:100], dtype=np.float32), 60,
                   device="cpu")
    rep = mon.drain(reg)
    assert not rep["carried"] and rep["rows"] == 100
