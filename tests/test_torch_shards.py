"""The port's out-of-core data plane (``io/shards.py``) and shard-sweep
learner (``treelearner/sharded.py``) on the CPU.

- the spill: the files of every shard, labels and weights are byte-equal
  (a) to the JAX package's spill of the same chunks, and the manifests
  are equal (mappers, hashes, sizes, the reference profile counted
  during the spill); the pass-1 sample is the reference's; a spill
  refuses a used directory; ``attach`` restores the dataset and refuses
  a mapperless, degraded, truncated, poisoned or missing spill;
- the prefetcher: shards in order, each [n_k, pad_cols] with zero pad
  columns, stalls counted, two shards or fewer staged once;
- sharded trees: text-equal (a) to the port's in-memory learner's, and
  training scores bit-equal, f32 and quantized, bagged, multiclass,
  with feature_fraction, extra_trees and basic monotone constraints,
  over 1, 3 and uneven shards and any frontier width (on the CPU the
  plain histogram continues its row-order adds from the running sums,
  so f32 is exact too); level (b) against the JAX package's in-memory
  learner (its own sharded-parity tests fail, so the in-memory learner
  is the anchor); the refused modes raise;
- a checkpoint resume over an attached spill gives the uninterrupted
  run's trees (a), its score check replaying the trees shard by shard;
- ``mask_gh`` and the accumulating histogram against the reference.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu.io.shards import ShardedBinnedDataset as RefSharded
from lightgbm_tpu.io.shards import _SampleCollector as RefSampler
from lightgbm_tpu.ops.histogram import mask_gh as ref_mask_gh
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.shards import (ShardedBinnedDataset,
                                          ShardPrefetcher, _SampleCollector)
from lightgbm_tpu_torch.obs import faults
from lightgbm_tpu_torch.obs.registry import registry
from lightgbm_tpu_torch.ops.histogram import (build_histogram,
                                              histogram_plain, mask_gh)
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
        "bin_construct_sample_cnt": 1000, "min_data_in_leaf": 5,
        "device_type": "cpu"}


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    yield
    faults.reset()


def _data(n=1000, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] - np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(np.float64)
    return X, y


def _source(X, y, chunk=300, w=None):
    def src():
        for lo in range(0, X.shape[0], chunk):
            part = (X[lo:lo + chunk], y[lo:lo + chunk].astype(np.float32))
            if w is not None:
                part += (w[lo:lo + chunk].astype(np.float32),)
            yield part
    return src


def _spill(tmp_path, X, y, params=BASE, shard_rows=400, w=None,
           chunk=300, sub="sp"):
    return ShardedBinnedDataset.from_chunk_source(
        _source(X, y, chunk, w), Config.from_params(dict(params)),
        str(tmp_path / sub), shard_rows=shard_rows, total_rows=len(X))


def _train(ds, params, iters=5):
    booster = create_boosting(
        Config.from_params(dict(params, num_iterations=iters)), ds, CPU)
    for _ in range(iters):
        booster.train_one_iter()
    return booster


# ----------------------------------------------------------------------
# the spill
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shard_rows,weights", [(400, False), (1000, False),
                                                (256, True)])
def test_spill_is_byte_equal_to_the_references(tmp_path, shard_rows,
                                               weights):
    X, y = _data()
    w = np.random.RandomState(1).uniform(0.5, 2, len(X)) if weights \
        else None
    port = _spill(tmp_path, X, y, shard_rows=shard_rows, w=w, sub="port")
    ref_params = {k: v for k, v in BASE.items() if k != "device_type"}
    ref = RefSharded.from_chunk_source(
        _source(X, y, 300, w), RefConfig.from_params(ref_params),
        str(tmp_path / "ref"), shard_rows=shard_rows, total_rows=len(X))
    assert port.shard_sizes == ref.shard_sizes
    assert port.shard_offsets == ref.shard_offsets
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        if name.endswith(".npy"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "ref" / name).read_bytes(), name
    mp = json.loads((tmp_path / "port" / "manifest.json").read_text())
    mr = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert mp == mr
    mem = BinnedDataset.from_matrix(X, Config.from_params(dict(BASE)),
                                    label=y)
    assert np.array_equal(port.assemble_bins(), mem.bins)
    mm = port.shard_bins_host(0)
    assert isinstance(mm, np.memmap)


def test_spill_refuses_a_used_directory(tmp_path):
    X, y = _data(400)
    _spill(tmp_path, X, y, shard_rows=200)
    with pytest.raises(LightGBMError, match="already holds"):
        _spill(tmp_path, X, y, shard_rows=200)


@pytest.mark.parametrize("total", [None, 1000])
@pytest.mark.parametrize("cap", [100, 1000])
def test_pass_one_sample_is_the_references(total, cap):
    parts = [np.random.RandomState(k).randn(m, 3)
             for k, m in enumerate((400, 350, 250))]
    out = []
    for cls in (_SampleCollector, RefSampler):
        sc = cls(cap, 3, seed=1, total_rows=total)
        for p in parts:
            sc.add(p)
        out.append(sc.finish())
    assert out[0][1] == out[1][1]
    assert np.array_equal(out[0][0], out[1][0])


def test_subsampled_mappers_match_from_matrix(tmp_path):
    """A known row count draws from_matrix's own sample, so the mappers
    (and bins) are exact even when the sample is smaller than the
    data."""
    X, y = _data(3000)
    params = dict(BASE, bin_construct_sample_cnt=500)
    ds = _spill(tmp_path, X, y, params=params, shard_rows=1000)
    mem = BinnedDataset.from_matrix(X, Config.from_params(dict(params)),
                                    label=y)
    assert np.array_equal(ds.assemble_bins(), mem.bins)


def test_spill_profile_is_the_in_memory_profile(tmp_path):
    from lightgbm_tpu_torch.obs.quality import ProfileBuilder
    X, y = _data()
    ds = _spill(tmp_path, X, y)
    mem = BinnedDataset.from_matrix(X, Config.from_params(dict(BASE)),
                                    label=y)
    pb = ProfileBuilder(mem.bin_mappers, mem.used_feature_map,
                        mem.feature_names, device="cpu")
    pb.add_labels(y.astype(np.float32))
    pb.add_block(mem.bins, len(X))
    want = pb.finalize().to_dict()
    # json text: NaN bounds compare equal as text, not as floats
    assert json.dumps(ds.quality_profile.to_dict()) == json.dumps(want)
    bst = lgb.train(BASE, lgb.Dataset(ds), num_boost_round=1)
    assert bst.inner.quality_profile is ds.quality_profile


# ----------------------------------------------------------------------
# attach
# ----------------------------------------------------------------------

def test_attach_restores_the_spill(tmp_path):
    X, y = _data(900)
    w = np.random.RandomState(9).uniform(0.5, 2.0, 900)
    ds = _spill(tmp_path, X, y, shard_rows=300, w=w)
    att = ShardedBinnedDataset.attach(str(tmp_path / "sp"),
                                      Config.from_params(dict(BASE)))
    assert att.num_data == ds.num_data and att.has_weights
    assert np.array_equal(att.assemble_bins(), ds.assemble_bins())
    np.testing.assert_array_equal(att.metadata.label, ds.metadata.label)
    np.testing.assert_allclose(att.metadata.weights, w.astype(np.float32))
    assert json.dumps([m.to_dict() for m in att.bin_mappers]) == \
        json.dumps([m.to_dict() for m in ds.bin_mappers])
    assert _train(att, BASE, 3).save_model_to_string() == \
        _train(ds, BASE, 3).save_model_to_string()


def _edit_manifest(tmp_path, fn):
    mpath = tmp_path / "sp" / "manifest.json"
    m = json.loads(mpath.read_text())
    fn(m)
    mpath.write_text(json.dumps(m))


@pytest.mark.parametrize("damage,match", [
    ("mapperless", "mapper"), ("degraded", "degraded"),
    ("truncated", "truncated"), ("missing", "manifest"),
    ("inconsistent", "inconsistent")])
def test_attach_refuses_a_damaged_spill(tmp_path, damage, match):
    X, y = _data(600)
    _spill(tmp_path, X, y, shard_rows=200)
    if damage == "mapperless":
        _edit_manifest(tmp_path, lambda m: m.pop("mappers"))
    elif damage == "degraded":
        _edit_manifest(tmp_path, lambda m: m.update(resident_shards=[1]))
    elif damage == "inconsistent":
        _edit_manifest(tmp_path, lambda m: m.update(num_data=601))
    elif damage == "truncated":
        path = tmp_path / "sp" / "shard_0001.bins.npy"
        path.write_bytes(path.read_bytes()[:-8])
    else:
        os.unlink(tmp_path / "sp" / "manifest.json")
    with pytest.raises(LightGBMError, match=match):
        ShardedBinnedDataset.attach(str(tmp_path / "sp"))


def test_poisoned_shard_fails_its_first_open(tmp_path):
    X, y = _data(600)
    _spill(tmp_path, X, y, shard_rows=200)
    path = tmp_path / "sp" / "shard_0002.bins.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    att = ShardedBinnedDataset.attach(str(tmp_path / "sp"))
    att.shard_bins_host(0)
    with pytest.raises(LightGBMError, match="content hash"):
        att.shard_bins_host(2)


# ----------------------------------------------------------------------
# fault sites of the data plane
# ----------------------------------------------------------------------

@pytest.mark.parametrize("site", ["spill_write", "shard_open",
                                  "prefetch_device_put"])
def test_fault_sites_retry_through_their_callers(tmp_path, site):
    """One injected fault at each site is retried (``ft/retries/<site>``)
    and the spill and its sweep come out whole."""
    X, y = _data(600)
    faults.configure("%s:nth:1" % site)
    base = registry.count("ft/retries/" + site)
    ds = _spill(tmp_path, X, y, shard_rows=200)
    pf = ShardPrefetcher(ds, pad_cols=8)
    got = [bins.numpy()[:, :ds.num_features].copy()
           for _, bins in pf.sweep()]
    pf.close()
    assert registry.count("ft/retries/" + site) - base == 1
    assert np.array_equal(np.concatenate(got), ds.assemble_bins())
    assert registry.count("ft/faults_injected/" + site) >= 1


def test_spill_write_exhaustion_is_fatal_and_leaves_no_partial(tmp_path):
    X, y = _data(400)
    faults.configure("spill_write:always")
    with pytest.raises(LightGBMError, match="after retries"):
        _spill(tmp_path, X, y, shard_rows=200)
    left = [f for f in os.listdir(tmp_path / "sp") if f.startswith("shard")]
    assert left == []


# ----------------------------------------------------------------------
# the prefetcher
# ----------------------------------------------------------------------

def test_prefetcher_order_padding_and_stalls(tmp_path, monkeypatch):
    X, y = _data(800)
    ds = _spill(tmp_path, X, y, shard_rows=200, chunk=250)
    staged = []
    real = ShardPrefetcher._host_rows

    def slow(self, k):
        time.sleep(0.05)
        staged.append(k)
        return real(self, k)

    monkeypatch.setattr(ShardPrefetcher, "_host_rows", slow)
    stall0 = registry.count("io/prefetch_stall_ms")
    staged0 = registry.count("io/shards_staged")
    pf = ShardPrefetcher(ds, pad_cols=8)
    for _ in range(2):
        seen = []
        for k, bins in pf.sweep():
            seen.append(k)
            host = bins.numpy()
            assert host.shape == (ds.shard_sizes[k], 8)
            assert np.array_equal(host[:, :ds.num_features],
                                  np.asarray(ds.shard_bins_host(k)))
            assert (host[:, ds.num_features:] == 0).all()
        assert seen == [0, 1, 2, 3]
    pf.close()
    assert staged == [0, 1, 2, 3] * 2
    assert registry.count("io/prefetch_stall_ms") > stall0
    assert registry.count("io/shards_staged") - staged0 == 8


def test_two_shards_stay_resident(tmp_path, monkeypatch):
    X, y = _data(400)
    ds = _spill(tmp_path, X, y, shard_rows=200)
    calls = []
    real = ShardPrefetcher._host_rows
    monkeypatch.setattr(ShardPrefetcher, "_host_rows",
                        lambda self, k: calls.append(k) or real(self, k))
    pf = ShardPrefetcher(ds, pad_cols=8)
    for _ in range(3):
        assert [k for k, _ in pf.sweep()] == [0, 1]
    pf.close()
    assert calls == [0, 1]


def test_next_trees_root_sweep_is_started_across_iterations(tmp_path):
    X, y = _data()
    params = dict(BASE, num_leaves=7)
    ds = _spill(tmp_path, X, y, params=params, shard_rows=250, chunk=250)
    booster = create_boosting(
        Config.from_params(dict(params, num_iterations=4)), ds, CPU)
    pool = booster.learner.prefetcher._pool

    def staged():
        pool.submit(lambda: None).result(timeout=60)
        return registry.count("io/shards_staged")

    per_iter = []
    for _ in range(4):
        before = staged()
        booster.train_one_iter()
        per_iter.append(staged() - before)
        assert booster.learner._next_sweep is not None
    assert per_iter[1] == per_iter[2] == per_iter[3]
    booster.learner.release_prefetch()
    assert booster.learner._next_sweep is None
    mem = _train(BinnedDataset.from_matrix(
        X, Config.from_params(dict(params)), label=y), params, 4)
    assert booster.save_model_to_string() == mem.save_model_to_string()


# ----------------------------------------------------------------------
# sharded trees
# ----------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    {}, {"use_quantized_grad": True},
    {"use_quantized_grad": True, "quant_grad_bits": 16},
    {"bagging_fraction": 0.7, "bagging_freq": 1},
    {"feature_fraction": 0.7, "extra_trees": True},
    {"monotone_constraints": [1, 0, -1, 0, 0, 0]},
    {"tpu_frontier_splits": 1}, {"tpu_frontier_splits": 3},
    {"max_depth": 3, "num_leaves": 31},
], ids=["f32", "quantized8", "quantized16", "bagging", "ff_extra",
        "monotone", "k1", "k3", "depth"])
@pytest.mark.parametrize("shard_rows", [334, 256, 1000],
                         ids=["3shards", "uneven4", "1shard"])
def test_sharded_trees_text_equal_to_in_memory(tmp_path, extra,
                                               shard_rows):
    X, y = _data()
    params = dict(BASE, **extra)
    mem = _train(BinnedDataset.from_matrix(
        X, Config.from_params(dict(params)), label=y), params)
    ds = _spill(tmp_path, X, y, params=params, shard_rows=shard_rows)
    sh = _train(ds, params)
    assert sh.save_model_to_string() == mem.save_model_to_string()
    a = sh.train_score.numpy().view(np.uint32)
    b = mem.train_score.numpy().view(np.uint32)
    assert np.array_equal(a, b)
    st = sh.learner.grow_stats
    splits = sum(t.num_leaves - 1 for t in sh.models)
    assert st["steps"] == splits
    # one root pass per tree, and every speculated slot a pass
    assert st["hist_passes"] == st["roots"] + splits + st["rejected"]


def test_multiclass_sharded_text_equal(tmp_path):
    rng = np.random.RandomState(5)
    X = rng.randn(900, 5)
    y = np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
    params = dict(BASE, objective="multiclass", num_class=3,
                  bin_construct_sample_cnt=900)
    mem = _train(BinnedDataset.from_matrix(
        X, Config.from_params(dict(params)), label=y), params, 3)
    sh = _train(_spill(tmp_path, X, y, params=params, chunk=250), params, 3)
    assert sh.save_model_to_string() == mem.save_model_to_string()


@pytest.mark.parametrize("extra", [{}, {"use_quantized_grad": True}],
                         ids=["f32", "quantized8"])
def test_sharded_trees_hold_level_b_against_the_reference(tmp_path,
                                                          extra):
    """The JAX package's in-memory learner is the anchor: the same
    splits and leaf counts, leaf values within f32 tolerance."""
    X, y = _data()
    params = dict(BASE, **extra)
    sh = lgb.train(params, lgb.Dataset(_spill(tmp_path, X, y,
                                              params=params)),
                   num_boost_round=4)
    ref_params = {k: v for k, v in params.items() if k != "device_type"}
    ref = ref_lgb.train(ref_params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=4)
    assert len(ref.inner.models) == len(sh.inner.models)
    for a, b in zip(ref.inner.models, sh.inner.models):
        ni = a.num_internal
        assert (a.num_leaves, a.split_feature[:ni].tolist(),
                a.threshold[:ni].tolist(),
                a.leaf_count[:a.num_leaves].tolist()) == \
            (b.num_leaves, b.split_feature[:ni].tolist(),
             b.threshold[:ni].tolist(),
             b.leaf_count[:b.num_leaves].tolist())
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("bad", [
    {"linear_tree": True}, {"cegb_penalty_split": 0.1},
    {"interaction_constraints": [[0, 1]]},
    {"feature_fraction_bynode": 0.5},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0],
     "monotone_constraints_method": "intermediate"},
    {"forcedsplits_filename": "forced.json"}],
    ids=["linear", "cegb", "interaction", "bynode", "intermediate",
         "forced"])
def test_refused_modes_raise(tmp_path, bad):
    X, y = _data(400)
    ds = _spill(tmp_path, X, y, shard_rows=200)
    with pytest.raises(LightGBMError):
        create_boosting(Config.from_params(
            dict(BASE, num_iterations=2, **bad)), ds, CPU)


def test_resident_row_operations_and_valid_sets_raise(tmp_path):
    X, y = _data(400)
    ds = _spill(tmp_path, X, y, shard_rows=200)
    b = create_boosting(Config.from_params(
        dict(BASE, num_iterations=2)), ds, CPU)
    with pytest.raises(LightGBMError, match="validation"):
        b.add_valid_data(ds)
    b.train_one_iter()
    with pytest.raises(LightGBMError, match="sharded"):
        b.rollback_one_iter()
    with pytest.raises(LightGBMError, match="sharded"):
        _train(ds, dict(BASE, boosting="dart"), 3)
    # the score replay runs shard by shard: the in-memory learner's
    # replay of the same trees deviates by the same bits
    mem = _train(BinnedDataset.from_matrix(
        X, Config.from_params(dict(BASE)), label=y), BASE, 1)
    assert b.recheck_scores("test") == mem.recheck_scores("test")


def test_checkpoint_resume_over_an_attached_spill(tmp_path):
    from lightgbm_tpu_torch.io.streaming import StreamingDataset
    X, y = _data(1200)
    sd = StreamingDataset(6, params=BASE, chunk_rows=256,
                          spill_dir=str(tmp_path / "sp"))
    sd.push_rows(X, label=y)
    full = lgb.train(BASE, lgb.Dataset(sd.finalize(shard_rows=300)),
                     num_boost_round=6)

    def attached():
        return lgb.Dataset(ShardedBinnedDataset.attach(
            str(tmp_path / "sp"), Config.from_params(dict(BASE))))

    seen = []
    from lightgbm_tpu_torch.obs import events
    events.register_event_callback(seen.append)
    try:
        lgb.train(BASE, attached(), num_boost_round=3,
                  checkpoint_dir=str(tmp_path / "ck"), checkpoint_freq=1)
        resumed = lgb.train(BASE, attached(), num_boost_round=6,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_freq=1, resume=True)
    finally:
        events.register_event_callback(None)
    assert resumed.model_to_string() == full.model_to_string()
    res = [e for e in seen if e["event"] == "checkpoint_resumed"]
    assert [(e["iter"], e["score_replay"]) for e in res] == [(3, "ok")]
    assert res[0]["score_replay_max_abs_diff"] == 0.0


# ----------------------------------------------------------------------
# the ops this path adds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int8, np.int16])
def test_mask_gh_matches_reference(dtype):
    rng = np.random.RandomState(0)
    gh = (rng.randn(50, 4) * 20).astype(dtype)
    keep = rng.rand(50) > 0.4
    for k in (keep, True, False):
        got = mask_gh(torch.from_numpy(gh), torch.as_tensor(k)).numpy()
        want = np.asarray(ref_mask_gh(gh, k))
        assert got.dtype == want.dtype == gh.dtype
        assert np.array_equal(got, want)


@pytest.mark.parametrize("gh_dtype", [torch.float32, torch.int8])
def test_accumulating_histogram_equals_one_pass(gh_dtype):
    """Row blocks added in order into a running histogram give the
    bytes of one pass over all the rows (the CPU's plain version)."""
    g = torch.Generator().manual_seed(0)
    bins = torch.randint(0, 64, (900, 8), dtype=torch.uint8, generator=g)
    if gh_dtype.is_floating_point:
        gh = torch.randn(900, 4, generator=g)
    else:
        gh = torch.randint(-100, 100, (900, 4), generator=g).to(gh_dtype)
    idx = torch.nonzero(torch.rand(900, generator=g) > 0.3).view(-1).to(
        torch.int32)
    whole = histogram_plain(bins, gh, 64, idx)
    acc = None
    for lo in range(0, 900, 250):
        part = idx[(idx >= lo) & (idx < lo + 250)] - lo
        cnt = torch.tensor([part.numel()], dtype=torch.int32)
        if acc is None:
            acc = torch.zeros_like(whole)
        out = build_histogram(bins[lo:lo + 250], gh[lo:lo + 250], 64,
                              torch.cat([part, part[:1]]), cnt, into=acc)
        assert out is acc
    assert torch.equal(acc, whole)
    with pytest.raises(LightGBMError, match="f64"):
        build_histogram(bins, gh.float(), 64, f64=True, into=acc.float())
