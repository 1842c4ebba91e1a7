"""The port's mesh learners (``lightgbm_tpu_torch/parallel/``) on the
CPU, against the JAX package's and the port's own serial learner.

Against the JAX package (level b): the same seeded rows go through the
reference's data-, feature- and voting-parallel learners on
``make_mesh(8)`` of the forced host devices (tests/conftest.py) and the
port's on ``make_mesh(8, "cpu")``: the same split features, thresholds
and default directions, the same leaf counts, leaf values within rtol
1e-5 (the reference holds its own mesh learners to serial at rtol 2e-3,
tests/test_data_parallel.py:76-78). Cases: uneven rows, bagging,
max_depth and EFB bundles for the data learner, and the capability
matrix of tests/test_data_parallel.py:120 through it; more shards than
features for the feature learner; a vote covering every feature and a
small ``top_k`` for voting.

Against the port's serial learner: 8-bit and 16-bit trees of every mesh
learner and f32 feature-parallel trees text-equal (level a: integer sums
are exact, and the plain histogram adds each feature's rows in row
order on both); f32 data- and voting-parallel trees at level (b); a
one-shard mesh text-equal in f32 too; batched iterations on the data
learner equal to its looped trees. The data learner's split step makes
no host read. ``lgb.train`` trains with every ``tree_learner`` spelling.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu.io.dataset import BinnedDataset as RefDataset
from lightgbm_tpu.parallel import DataParallelTreeLearner as RefData
from lightgbm_tpu.parallel import FeatureParallelTreeLearner as RefFeature
from lightgbm_tpu.parallel import VotingParallelTreeLearner as RefVoting
from lightgbm_tpu.parallel import make_mesh as ref_make_mesh
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as RefSerial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.parallel import (DataParallelTreeLearner,
                                         FeatureParallelTreeLearner, Mesh,
                                         VotingParallelTreeLearner,
                                         data_parallel, make_mesh)
from lightgbm_tpu_torch.treelearner import create_tree_learner
from lightgbm_tpu_torch.treelearner.serial import SerialTreeLearner
from lightgbm_tpu_torch.utils.log import LightGBMError
from chip_smoke import REL_TOL, chain_rows
from test_efb import _sparse_onehot_data
from test_torch_fused_growth import _NoHostRead

torch.set_num_threads(1)

CPU = torch.device("cpu")
PORT = {"data": DataParallelTreeLearner,
        "feature": FeatureParallelTreeLearner,
        "voting": VotingParallelTreeLearner}
REF = {"data": RefData, "feature": RefFeature, "voting": RefVoting}


def _data(n=777, f=6, seed=0):
    """tests/test_data_parallel.py's rows and constant-magnitude
    gradients."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 > 0.3).astype(np.float64)
    grad = np.where(y > 0, -0.5, 0.5).astype(np.float32)
    hess = np.full(n, 0.25, dtype=np.float32)
    return X, y, grad, hess


def _grads(y, seed=1):
    """Gradients of varied magnitude (f32 sums that round)."""
    rng = np.random.RandomState(seed)
    grad = (rng.rand(len(y)) - y).astype(np.float32)
    hess = (0.1 + rng.rand(len(y))).astype(np.float32)
    return grad, hess


def _tree_arrays(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold_in_bin[:ni].tolist(),
            (tree.decision_type[:ni] & 2).tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _assert_level_b(ref_tree, port_tree):
    assert _tree_arrays(ref_tree) == _tree_arrays(port_tree)
    np.testing.assert_allclose(port_tree.leaf_value[:port_tree.num_leaves],
                               ref_tree.leaf_value[:ref_tree.num_leaves],
                               rtol=1e-5, atol=1e-7)


def _assert_level_a(a, b):
    assert _tree_arrays(a) == _tree_arrays(b)
    assert a.leaf_value[:a.num_leaves].tolist() == \
        b.leaf_value[:b.num_leaves].tolist()


def _both(kind, params, X, grad, hess, bag=None, y=None):
    """One tree of the reference's mesh learner on 8 host devices and
    one of the port's on 8 CPU shards, from the same rows."""
    rcfg = RefConfig.from_params(dict(params, verbosity=-1))
    rds = RefDataset.from_matrix(X, rcfg, label=y)
    ref = REF[kind](rcfg, rds, ref_make_mesh(8))
    pcfg = Config.from_params(dict(params, verbosity=-1, device_type="cpu"))
    pds = BinnedDataset.from_matrix(X, pcfg, label=y)
    port = PORT[kind](pcfg, pds, CPU, make_mesh(8, "cpu"))
    rt, rp = ref.train(jnp.asarray(grad), jnp.asarray(hess),
                       None if bag is None else jnp.asarray(bag))
    pt, pp = port.train(torch.from_numpy(grad), torch.from_numpy(hess),
                        None if bag is None else torch.from_numpy(bag))
    return (rt, np.asarray(rp)), (pt, pp.numpy()), port


BASE = {"num_leaves": 15, "min_data_in_leaf": 5}


@pytest.mark.parametrize("case", [
    "matches", "uneven", "bagging", "max_depth", "bundled"])
def test_data_learner_matches_reference(case):
    X, y, grad, hess = _data(n=1001 if case == "uneven" else 777)
    params, bag = dict(BASE), None
    if case == "uneven":
        params["num_leaves"] = 8
    if case == "bagging":
        bag = (np.random.RandomState(0).rand(len(X)) < 0.7).astype(
            np.float32)
    if case == "max_depth":
        params.update(num_leaves=31, max_depth=3)
    if case == "bundled":
        X, y = _sparse_onehot_data(n=1600)
        grad = np.where(y > 0, -0.5, 0.5).astype(np.float32)
        hess = np.full(len(y), 0.25, dtype=np.float32)
    (rt, rp), (pt, pp), port = _both("data", params, X, grad, hess, bag, y)
    _assert_level_b(rt, pt)
    np.testing.assert_array_equal(pp, rp[:len(X)])
    assert (pp >= 0).all() and len(pp) == len(X)
    assert port._bundled == (case == "bundled")
    if case == "max_depth":
        assert pt.num_leaves <= 8


@pytest.mark.parametrize("name,extra", [
    ("extra_trees", {"extra_trees": True, "extra_seed": 13}),
    ("monotone_basic_penalty", {"monotone_constraints": [1, -1, 0, 0, 0, 0],
                                "monotone_penalty": 1.0}),
    ("cegb", {"cegb_tradeoff": 0.9, "cegb_penalty_split": 1e-4}),
    ("interaction_constraints",
     {"interaction_constraints": [[0, 1, 2], [3, 4, 5]]}),
    ("monotone_intermediate",
     {"monotone_constraints": [1, -1, 0, 0, 0, 0],
      "monotone_constraints_method": "intermediate"}),
    ("monotone_advanced",
     {"monotone_constraints": [1, -1, 0, 0, 0, 0],
      "monotone_constraints_method": "advanced"}),
    ("bynode", {"feature_fraction_bynode": 0.5}),
    ("quantized8", {"use_quantized_grad": True}),
])
def test_data_learner_capability_matrix(name, extra):
    """tests/test_data_parallel.py:120's matrix through the data
    learner."""
    X, y, grad, hess = _data(n=900)
    (rt, rp), (pt, pp), _ = _both("data", dict(BASE, **extra), X, grad,
                                  hess)
    _assert_level_b(rt, pt)
    np.testing.assert_array_equal(pp, rp[:len(X)])


@pytest.mark.parametrize("case", ["matches", "more_shards_than_features"])
def test_feature_learner_matches_reference(case):
    X, y, grad, hess = _data(f=5 if case == "more_shards_than_features"
                             else 6)
    (rt, rp), (pt, pp), port = _both("feature", BASE, X, grad, hess)
    _assert_level_b(rt, pt)
    np.testing.assert_array_equal(pp, rp)
    assert port.Fp % 8 == 0 and port.Fp >= 8 * port._fs
    assert all(b.shape[1] % 8 == 0 for b in port._blocks)


@pytest.mark.parametrize("top_k", [6, 1])
def test_voting_learner_matches_reference(top_k):
    """top_k 6 of 6 features: every feature voted; top_k 1: two voted
    features per child, and the tree still learns."""
    X, y, grad, hess = _data(n=900 if top_k == 1 else 777)
    (rt, rp), (pt, pp), port = _both("voting", dict(BASE, top_k=top_k), X,
                                     grad, hess)
    _assert_level_b(rt, pt)
    np.testing.assert_array_equal(pp, rp[:len(X)])
    assert port.n_voted == min(2 * top_k, 6)
    if top_k == 1:
        assert pt.num_leaves > 2


@pytest.mark.parametrize("kind", ["data", "feature", "voting"])
def test_mesh_learners_match_reference_serial_with_varied_gradients(kind):
    """Gradients of varied magnitude, whose f32 sums round: the port's
    mesh learner on 8 CPU shards against the JAX package's serial
    learner. The same splits, thresholds, default directions, leaf
    counts and partition; feature-parallel leaf values equal (it sums
    each feature's rows in row order, as the serial learner does); data
    and voting leaf values within the f32 bound of the rows whose
    rounding their sums carry, the bound ``chip_smoke.py`` holds the
    card's trees to. At rtol 1e-5 one leaf of 15 misses (1.41e-5 for
    both; the JAX package's own mesh learners read 1.75e-5 against its
    serial learner on these rows; ROADMAP queue 3)."""
    X, y = _data()[:2]
    grad, hess = _grads(y)
    params = dict(BASE, top_k=6, verbosity=-1)
    rcfg = RefConfig.from_params(params)
    ref = RefSerial(rcfg, RefDataset.from_matrix(X, rcfg, label=y))
    rt, rp = ref.train(jnp.asarray(grad), jnp.asarray(hess))
    pcfg = Config.from_params(dict(params, device_type="cpu"))
    port = PORT[kind](pcfg, BinnedDataset.from_matrix(X, pcfg, label=y),
                      CPU, make_mesh(8, "cpu"))
    pt, pp = port.train(torch.from_numpy(grad), torch.from_numpy(hess))
    assert _tree_arrays(rt) == _tree_arrays(pt)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(rp)[:len(X)])
    n = pt.num_leaves
    assert n == BASE["num_leaves"]
    got, want = pt.leaf_value[:n], rt.leaf_value[:n]
    if kind == "feature":
        assert got.tolist() == want.tolist()
        return
    rows = (chain_rows(pt, subtracts=kind == "data")
            + chain_rows(rt, subtracts=True))
    bound = REL_TOL * (rows * np.abs(grad).max() / rt.leaf_weight[:n]
                       + np.abs(want))
    assert (np.abs(got - want) <= bound).all()
    assert not np.array_equal(got, want)   # the sums did round


def _port_pair(kind, extra, n_shards=8, data=None, seed=0):
    """One tree of the port's serial learner and one of its ``kind``
    mesh learner, from the same rows and varied gradients."""
    X, y = (data or _data)(seed=seed)[:2]
    grad, hess = _grads(y, seed)
    cfg = Config.from_params(dict(BASE, verbosity=-1, device_type="cpu",
                                  **extra))
    ds = BinnedDataset.from_matrix(X, cfg, label=y)
    g, h = torch.from_numpy(grad), torch.from_numpy(hess)
    serial = SerialTreeLearner(cfg, ds, CPU).train(g, h)
    mesh = PORT[kind](cfg, ds, CPU, make_mesh(n_shards, "cpu"))
    return serial, mesh.train(g, h), mesh


@pytest.mark.parametrize("kind", ["data", "feature", "voting"])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_mesh_equals_serial(kind, bits):
    (st, sp), (mt, mp), _ = _port_pair(
        kind, {"use_quantized_grad": True, "quant_grad_bits": bits,
               "top_k": 6})
    _assert_level_a(st, mt)
    assert torch.equal(sp, mp)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("extra", [{}, {"extra_trees": True},
                                   {"feature_fraction_bynode": 0.5}],
                         ids=["plain", "extra_trees", "bynode"])
def test_feature_mesh_f32_equals_serial(n_shards, extra):
    (st, sp), (mt, mp), _ = _port_pair("feature", extra, n_shards)
    _assert_level_a(st, mt)
    assert torch.equal(sp, mp)


@pytest.mark.parametrize("kind", ["data", "voting"])
def test_f32_data_and_voting_mesh_match_serial(kind):
    (st, sp), (mt, mp), _ = _port_pair(kind, {"top_k": 6})
    assert _tree_arrays(st) == _tree_arrays(mt)
    np.testing.assert_allclose(mt.leaf_value[:mt.num_leaves],
                               st.leaf_value[:st.num_leaves], rtol=1e-5)
    assert torch.equal(sp, mp)


@pytest.mark.parametrize("extra", [{}, {"tpu_fused_tree": False},
                                   {"data": "bundled"}],
                         ids=["whole_tree", "per_split", "bundled"])
def test_one_shard_mesh_is_serial(extra):
    extra = dict(extra)
    data = (lambda seed: _sparse_onehot_data(n=1600, seed=seed)) \
        if extra.pop("data", None) else None
    (st, sp), (mt, mp), mesh = _port_pair("data", extra, 1, data)
    _assert_level_a(st, mt)
    assert torch.equal(sp, mp)
    assert mesh._bundled == (data is not None)


def test_batched_iterations_equal_looped_on_the_data_learner():
    """tests/test_torch_batched.py's contract on a 4-shard data learner:
    tpu_batch_iterations=4 gives the looped trees, text-equal."""
    X, y = _data(n=1200)[:2]
    params = {"objective": "binary", "device_type": "cpu", "verbose": -1,
              "num_leaves": 15, "tree_learner": "data",
              "mesh_shape": "data=4", "learning_rate": 0.3}
    looped = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=9)
    batched = lgb.train(dict(params, tpu_batch_iterations=4),
                        lgb.Dataset(X, label=y), num_boost_round=9)
    assert isinstance(batched.inner.learner, DataParallelTreeLearner)
    assert batched.inner.learner.grow_stats["record_reads"] < \
        looped.inner.learner.grow_stats["record_reads"]
    trees = [b.model_to_string().split("end of trees")[0]
             for b in (batched, looped)]
    assert trees[0] == trees[1]


@pytest.mark.parametrize("spelling", ["data", "data_parallel", "feature",
                                      "feature_parallel", "voting",
                                      "voting_parallel"])
def test_train_with_every_tree_learner_spelling(spelling):
    X, y = _data(n=600)[:2]
    bst = lgb.train({"objective": "binary", "device_type": "cpu",
                     "verbose": -1, "num_leaves": 7, "tree": spelling,
                     "mesh_shape": "data=2"},
                    lgb.Dataset(X, label=y), num_boost_round=3)
    learner = bst.inner.learner
    assert type(learner) is PORT[spelling.split("_")[0]]
    assert learner.mesh.size == 2
    text = bst.model_to_string()
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))


@pytest.mark.parametrize("kind", ["data", "voting"])
def test_mesh_split_step_makes_no_host_read(monkeypatch, kind):
    X, y = _data(n=1001)[:2]
    grad, hess = _grads(y)
    cfg = Config.from_params(dict(BASE, verbosity=-1, device_type="cpu",
                                  top_k=2))
    learner = PORT[kind](cfg, BinnedDataset.from_matrix(X, cfg), CPU,
                         make_mesh(4, "cpu"))
    g = torch.from_numpy(grad)
    gh = torch.stack([g, torch.from_numpy(hess), torch.ones_like(g),
                      torch.ones_like(g)], dim=1)
    buf = learner._fused_buffers(gh)
    learner._root(buf.state)
    real = data_parallel.build_histogram

    def hist(*args, **kwargs):
        # the plain CPU version trims the row list on the host; the
        # kernel reads its length on the device
        with _disable_current_modes():
            return real(*args, **kwargs)
    monkeypatch.setattr(data_parallel, "build_histogram", hist)
    with _NoHostRead() as mode:
        for _ in range(learner.L + 2):
            learner._step(buf)
    assert mode.reads == []
    assert int(buf.state.step) > 0


def test_row_lists_are_each_shards_rows():
    """The step's per-shard lists hold exactly each shard's rows of the
    child, in ascending local order, with their counts on the device."""
    X, y = _data(n=1003)[:2]
    cfg = Config.from_params(dict(BASE, verbosity=-1, device_type="cpu"))
    learner = DataParallelTreeLearner(cfg, BinnedDataset.from_matrix(X, cfg),
                                      CPU, make_mesh(3, "cpu"))
    assert [s.size for s in learner.shards] == [335, 334, 334]
    assert [s.offset for s in learner.shards] == [0, 335, 669]
    gh = torch.ones((1003, 4))
    buf = learner._fused_buffers(gh)
    lor = torch.from_numpy(np.random.RandomState(0).randint(0, 3, 1003)
                           .astype(np.int32))
    buf.state.leaf_of_row.copy_(lor)
    learner._child_parts(buf, torch.tensor([1]), torch.tensor(True))
    for k, sh in enumerate(learner.shards):
        rows = np.nonzero(lor[sh.offset:sh.offset + sh.size].numpy() == 1)[0]
        assert int(buf.count[k]) == len(rows)
        assert buf.idx[k, :len(rows)].tolist() == rows.tolist()


@pytest.mark.parametrize("kind", ["data", "voting"])
def test_shards_on_other_devices_match_shards_on_the_learners(kind):
    """Shards on devices other than the learner's (``cpu:1``, ``cpu:2``
    stand for other cards: the learner copies to them) give the trees
    of shards on the learner's device; each tree's rows are copied to
    them once, at its root."""
    X, y = _data()[:2]
    grad, hess = _grads(y)
    cfg = Config.from_params(dict(BASE, top_k=6, verbosity=-1,
                                  device_type="cpu"))
    ds = BinnedDataset.from_matrix(X, cfg, label=y)
    g, h = torch.from_numpy(grad), torch.from_numpy(hess)
    here = PORT[kind](cfg, ds, CPU, make_mesh(3, "cpu"))
    away = PORT[kind](cfg, ds, CPU, Mesh(["cpu", "cpu:1", "cpu:2"]))
    assert not away._captures_steps() and here._captures_steps()
    handed = []
    shard_gh = away._shard_gh
    away._shard_gh = lambda gh, k: handed.append(
        (k, id(shard_gh(gh, k)))) or shard_gh(gh, k)
    for _ in range(2):
        handed.clear()
        (ht, hp), (at, ap) = here.train(g, h), away.train(g, h)
        _assert_level_a(ht, at)
        assert torch.equal(hp, ap)
        # one copy per other shard, handed to every launch of the tree
        assert {k: {i for kk, i in handed if kk == k} for k in (1, 2)} \
            == {k: {id(away._gh_copies[k])} for k in (1, 2)}
    assert [away._gh_copies[k].shape[0] for k in (1, 2)] == \
        [sh.size for sh in away.shards[1:]]


def test_mesh_construction():
    assert make_mesh(3, "cpu").devices == (CPU,) * 3
    assert make_mesh(device_type="cpu").size == 1
    with pytest.raises(LightGBMError, match="one type"):
        Mesh(["cpu", "meta"])
    with pytest.raises(LightGBMError, match="at least one"):
        make_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(LightGBMError, match="no CUDA device"):
            make_mesh(1, "cuda")
    else:
        with pytest.raises(LightGBMError, match="visible"):
            make_mesh(torch.cuda.device_count() + 1, "cuda")


def test_factory_reads_mesh_shape_and_ignores_forced_splits(tmp_path):
    X, y = _data(n=300)[:2]
    forced = tmp_path / "forced.json"
    forced.write_text('{"feature": 1, "threshold": 0.0}')
    cfg = Config.from_params({"tree_learner": "voting", "verbose": -1,
                              "mesh_shape": "data=5", "device_type": "cpu",
                              "forcedsplits_filename": str(forced)})
    learner = create_tree_learner(cfg, BinnedDataset.from_matrix(X, cfg),
                                  CPU)
    assert isinstance(learner, VotingParallelTreeLearner)
    assert learner.mesh.size == 5 and learner._forced is None
    bad = Config.from_params({"tree_learner": "data", "mesh_shape": "x",
                              "device_type": "cpu"})
    with pytest.raises(LightGBMError, match="mesh_shape"):
        create_tree_learner(bad, BinnedDataset.from_matrix(X, bad), CPU)


@pytest.mark.parametrize("kind", ["data", "feature", "voting"])
def test_unset_mesh_shape_gives_the_learners_own_device(kind):
    """Without ``mesh_shape`` the mesh is the learner's device alone (on
    the card too: a mesh over several cards is asked for, never
    implied)."""
    X = _data(n=300)[0]
    cfg = Config.from_params({"tree_learner": kind, "verbose": -1,
                              "device_type": "cpu"})
    learner = create_tree_learner(cfg, BinnedDataset.from_matrix(X, cfg),
                                  CPU)
    assert learner.mesh.devices == (CPU,)


def test_voting_degrades_intermediate_monotone_to_basic(capsys):
    X, y = _data(n=500)[:2]
    bst = lgb.train({"objective": "binary", "device_type": "cpu",
                     "num_leaves": 7, "tree_learner": "voting",
                     "mesh_shape": "data=2",
                     "monotone_constraints": [1, 0, 0, 0, 0, 0],
                     "monotone_constraints_method": "intermediate"},
                    lgb.Dataset(X, label=y), num_boost_round=2)
    assert bst.inner.learner._mono_tracker is None
    assert "degrades to 'basic'" in capsys.readouterr().err
