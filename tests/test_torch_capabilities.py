"""The per-node feature filters and CEGB of the port against the JAX
package's, on the CPU: ``feature_fraction_bynode``,
``interaction_constraints`` and cost-effective gradient boosting.

- The node masks drawn over a sequence of feature paths equal the
  reference learner's ``_node_mask`` from the same RNG (level a), and
  so does the whole sequence a training run draws.
- Every root-to-leaf path of an interaction-constrained tree stays
  inside one group (the walk of tests/test_advanced_features.py:40).
- bynode and interaction-constrained trees make the reference's splits
  (level b), through the per-split loop with one record read per split.
- The CEGB penalty equals the reference's ``_cegb_penalty`` (level a),
  and CEGB trees (split penalty only, coupled, lazy) hold level (b);
  the lazy fetched state marks exactly the rows that passed a node on
  each feature.
- A penalty vector of the wrong length is fatal; CEGB with extra_trees
  warns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu.ops.split import SplitParams as RefSplitParams
from lightgbm_tpu.treelearner import serial as ref_serial
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.ops import split as S
from lightgbm_tpu_torch.treelearner import serial
from lightgbm_tpu_torch.utils import log
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "verbose": -1}


def _data(n=1500, seed=0, F=10):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    y = X[:, 0] * X[:, 1] + X[:, 2] + 0.5 * X[:, 5] + 0.05 * rng.randn(n)
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _train_both(extra, rounds=3, data=_data):
    X, y = data()
    params = dict(BASE, **extra)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=rounds)
    port = lgb.train(dict(params, device_type="cpu"),
                     lgb.Dataset(X, label=y), num_boost_round=rounds)
    return ref, port


def _assert_level_b(ref, port):
    assert len(ref.inner.models) == len(port.inner.models)
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-4, atol=1e-6)


def _per_split_contract(port):
    """Per-node masks and CEGB take the per-split loop: one record read
    per split, plus one for a tree that ends before num_leaves."""
    stats = port.inner.learner.grow_stats
    trees = port.inner.models
    splits = sum(t.num_leaves - 1 for t in trees)
    assert stats["record_reads"] == 0
    assert splits <= stats["split_reads"] <= splits + len(trees)
    assert stats["steps"] == splits


# ----------------------------------------------------------------------
# node masks
# ----------------------------------------------------------------------
IC = [[0, 1], [2, 3, 4], [4, 5, 6, 7, 8, 9]]


def _learners(params):
    X, y = _data(n=300)
    ref = ref_lgb.Booster(params, ref_lgb.Dataset(X, label=y)) \
        .inner.learner
    port = lgb.Booster(dict(params, device_type="cpu"),
                       lgb.Dataset(X, label=y)).inner.learner
    return ref, port


@pytest.mark.parametrize("extra", [
    {"feature_fraction_bynode": 0.5},
    {"interaction_constraints": IC},
    {"interaction_constraints": IC, "feature_fraction_bynode": 0.4,
     "feature_fraction": 0.8},
], ids=["bynode", "constraints", "both"])
def test_node_mask_sequence_byte_equal(extra):
    ref, port = _learners(dict(BASE, feature_fraction_seed=4, **extra))
    assert ref._needs_per_node_masks() and port._needs_per_node_masks()
    assert ref._constraint_groups == port._constraint_groups
    want_tree = np.asarray(ref._sample_features())
    got_tree = port._sample_features()
    assert np.array_equal(want_tree, got_tree)
    port._set_tree_mask(got_tree)
    paths = [frozenset(), frozenset({0}), frozenset({4}),
             frozenset({4, 5}), frozenset({0, 2}), frozenset({3}),
             frozenset({9, 6, 4})]
    for path in paths * 2:
        want = ref._node_mask(jnp.asarray(want_tree), path)
        got = port._node_mask(port.feature_mask, path)
        assert np.array_equal(np.asarray(want), got.numpy()), path


def _record_node_masks(cls, monkeypatch):
    seen = []
    orig = cls._node_mask

    def record(self, tree_mask, path):
        out = orig(self, tree_mask, path)
        seen.append((sorted(path), np.asarray(out).copy()))
        return out
    monkeypatch.setattr(cls, "_node_mask", record)
    return seen


def test_training_draws_the_reference_node_masks(monkeypatch):
    extra = {"feature_fraction_bynode": 0.5, "interaction_constraints": IC}
    want = _record_node_masks(ref_serial.SerialTreeLearner, monkeypatch)
    got = _record_node_masks(serial.SerialTreeLearner, monkeypatch)
    ref, port = _train_both(extra, rounds=2)
    assert len(want) == len(got) > 20
    for (pa, ma), (pb, mb) in zip(want, got):
        assert pa == pb and np.array_equal(ma, mb)
    _assert_level_b(ref, port)


def _walk_groups(tree, groups):
    def walk(node, path):
        if node < 0:
            return
        newp = path | {int(tree.split_feature[node])}
        assert any(newp <= set(g) for g in groups), newp
        walk(int(tree.left_child[node]), newp)
        walk(int(tree.right_child[node]), newp)
    if tree.num_leaves > 1:
        walk(0, set())


def test_interaction_constraint_paths():
    """tests/test_advanced_features.py:40 on the port's trees."""
    rng = np.random.RandomState(0)
    X = rng.randn(800, 4)
    y = X[:, 0] * X[:, 1] + X[:, 2] + 0.05 * rng.randn(800)
    bst = lgb.train({"objective": "regression", "verbosity": -1,
                     "device_type": "cpu",
                     "interaction_constraints": [[0, 1], [2, 3]]},
                    lgb.Dataset(X, label=y), num_boost_round=10)
    assert all(t.num_leaves > 1 for t in bst.inner.models)
    for t in bst.inner.models:
        _walk_groups(t, [{0, 1}, {2, 3}])


def test_interaction_constraints_text_form():
    """Upstream's text form: bracketed groups; text without one sets no
    constraint."""
    assert Config.from_params({"interaction_constraints":
                               "[0,1],[2, 3,4]"}).interaction_constraints \
        == [[0, 1], [2, 3, 4]]
    assert Config.from_params({"interaction_constraints": "0,1"}) \
        .interaction_constraints == []
    X, y = _data(n=800)
    bst = lgb.train(dict(BASE, device_type="cpu",
                         interaction_constraints="[0,1],[2,3,4]"),
                    lgb.Dataset(X, label=y), num_boost_round=3)
    for t in bst.inner.models:
        _walk_groups(t, [{0, 1}, {2, 3, 4}])


@pytest.mark.parametrize("extra", [
    {"feature_fraction_bynode": 0.5},
    {"interaction_constraints": IC},
    {"interaction_constraints": IC, "extra_trees": True},
    {"feature_fraction_bynode": 0.6, "feature_fraction": 0.8,
     "tpu_fused_tree": False},
], ids=["bynode", "constraints", "constraints_extra_trees",
        "bynode_ff_per_split"])
def test_per_node_trees_match_reference(extra):
    ref, port = _train_both(extra)
    _assert_level_b(ref, port)
    _per_split_contract(port)
    if "interaction_constraints" in extra:
        for t in port.inner.models:
            _walk_groups(t, IC)


# ----------------------------------------------------------------------
# CEGB
# ----------------------------------------------------------------------
def test_cegb_penalty_byte_equal():
    rng = np.random.RandomState(3)
    params = {"cegb_tradeoff": 0.7, "cegb_penalty_split": 0.013}
    ref_p = RefSplitParams.from_config(RefConfig.from_params(params))
    port_p = S.SplitParams.from_config(Config.from_params(params),
                                       torch.device("cpu"))
    Fp = 16
    for _ in range(5):
        count = np.float32(rng.randint(1, 100000))
        used = rng.rand(Fp) < 0.5
        coupled = rng.rand(Fp).astype(np.float32) * 3
        lazy = rng.rand(Fp).astype(np.float32)
        unfetched = rng.randint(0, 100000, Fp).astype(np.float32)
        for lz, uf in ((None, None), (lazy, unfetched)):
            want = ref_serial._cegb_penalty(
                ref_p, jnp.float32(count), jnp.asarray(used),
                jnp.asarray(coupled),
                None if uf is None else jnp.asarray(uf),
                None if lz is None else jnp.asarray(lz))
            got = S.cegb_penalty(
                port_p, torch.tensor(count), torch.from_numpy(used),
                torch.from_numpy(coupled),
                None if uf is None else torch.from_numpy(uf),
                None if lz is None else torch.from_numpy(lz))
            assert np.array_equal(np.asarray(want).view(np.uint32),
                                  got.numpy().view(np.uint32))


CEGB_CASES = {
    "split": {"cegb_penalty_split": 0.05},
    "coupled": {"cegb_penalty_feature_coupled":
                [5.0, 0.0, 1.0, 40.0, 0.0, 2.0, 0.0, 3.0, 0.0, 9.0],
                "cegb_tradeoff": 0.5},
    "lazy": {"cegb_penalty_feature_lazy":
             [0.01, 0.002, 0.0, 0.05, 0.01, 0.0, 0.02, 0.0, 0.01, 0.03],
             "cegb_penalty_split": 0.01},
}


@pytest.mark.parametrize("case", sorted(CEGB_CASES))
def test_cegb_trees_match_reference(case):
    ref, port = _train_both(CEGB_CASES[case])
    _assert_level_b(ref, port)
    _per_split_contract(port)
    plain = lgb.train(dict(BASE, device_type="cpu"),
                      lgb.Dataset(*_data()), num_boost_round=3)
    assert [_splits(t) for t in plain.inner.models] != \
        [_splits(t) for t in port.inner.models]


def test_cegb_lazy_fetched_marks_the_rows_of_each_node():
    """After one tree, row r has fetched feature f iff r passed a node
    that splits on f, by the tree's own walk of the binned rows."""
    X, y = _data()
    bst = lgb.train(dict(BASE, device_type="cpu", **CEGB_CASES["lazy"]),
                    lgb.Dataset(X, label=y), num_boost_round=1)
    learner = bst.inner.learner
    tree = bst.inner.models[0]
    fetched = learner._cegb_fetched.numpy()
    bins = learner.bins.numpy()
    want = np.zeros_like(fetched)
    for r in range(X.shape[0]):
        node = 0
        while node >= 0:
            f = int(tree.split_feature_inner[node])
            want[r, f] = True
            b = int(bins[r, f])
            node = int(tree.left_child[node]
                       if b <= tree.threshold_in_bin[node]
                       else tree.right_child[node])
    assert np.array_equal(fetched, want)
    used = learner._cegb_used.numpy()
    assert used.sum() == len(set(
        tree.split_feature_inner[:tree.num_internal].tolist()))


def test_cegb_penalty_length_mismatch_is_fatal():
    X, y = _data(n=300)
    with pytest.raises(LightGBMError, match="same size as feature number"):
        lgb.train(dict(BASE, device_type="cpu",
                       cegb_penalty_feature_coupled=[1.0, 2.0]),
                  lgb.Dataset(X, label=y), num_boost_round=1)


def test_cegb_with_extra_trees_warns(monkeypatch):
    warned = []
    monkeypatch.setattr(log, "warning",
                        lambda msg, *a: warned.append(msg % a if a else msg))
    X, y = _data(n=300)
    lgb.train(dict(BASE, device_type="cpu", extra_trees=True,
                   cegb_penalty_split=0.01),
              lgb.Dataset(X, label=y), num_boost_round=1)
    assert any("extra_trees is ignored" in m for m in warned)
