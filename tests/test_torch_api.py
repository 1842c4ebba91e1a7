"""The rest of the main-path API of the port against the JAX package, on
the CPU: ``Booster.predict``'s keywords, pickling, ``train``'s arguments,
the ``Dataset`` setters and getters, a callable objective, ``feval``,
``init_model``, ``rollback_one_iter``, ``reset_parameter`` and
``dump_model``.

The same numpy inputs go through both packages (the port with
``device_type="cpu"``). Levels (ROADMAP): ``dump_model`` of the same
trees is byte-equal (a); trees grown by both are held to the same splits
and leaf counts (b), leaf values within 1e-5; metrics within 1e-5 (c).
Also the matching cases of tests/test_python_api.py,
tests/test_boosting.py and tests/test_model_export.py.
"""
import inspect
import os
import json
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.boosting.gbdt import GBDT
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _binary(n=1000, seed=0, nan=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + X[:, 1] - 0.5 * X[:, 3] > 0).astype(float)
    if nan:
        X[rng.rand(n) < 0.1, 2] = np.nan
    return X, y


def _reg(n=1200, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    y = X[:, 0] * 2.0 + np.sin(X[:, 1]) + 0.05 * rng.randn(n)
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _same_trees(ref_trees, port_trees):
    """Level (b): the same splits and leaf counts, leaf values within
    1e-5 relative."""
    assert len(ref_trees) == len(port_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves],
                                   rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def binary_booster():
    X, y = _binary(nan=True)
    bst = lgb.train(dict(CPU, objective="binary", num_leaves=15,
                         verbose=-1), lgb.Dataset(X, label=y),
                    num_boost_round=4)
    return X, y, bst


# ----------------------------------------------------------------------
# repairs: predict's keywords, pickling, train's arguments
# ----------------------------------------------------------------------
def test_predict_takes_the_reference_keywords(binary_booster):
    X, _, bst = binary_booster
    host = bst.predict(X)
    np.testing.assert_array_equal(bst.predict(X, pred_contrib=False), host)
    np.testing.assert_array_equal(bst.predict(X, predict_on_device=True),
                                  host)
    np.testing.assert_array_equal(bst.predict(X, predict_on_device=False),
                                  host)
    # pred_contrib (item 18b) gives the JAX package's SHAP values of the
    # same model text
    ref = ref_lgb.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(bst.predict(X[:50], pred_contrib=True),
                               ref.predict(X[:50], pred_contrib=True),
                               rtol=0, atol=1e-12)
    ref_params = list(inspect.signature(ref_lgb.Booster.predict).parameters)
    assert list(inspect.signature(lgb.Booster.predict).parameters) == \
        ref_params
    # the predict layer reads predict_on_device and pred_early_stop*; the
    # host walk takes only its own arguments
    assert list(inspect.signature(GBDT.predict_raw).parameters) == [
        "self", "X", "start_iteration", "num_iteration", "pred_early_stop",
        "pred_early_stop_freq", "pred_early_stop_margin"]


def test_pickle_round_trip_predicts_the_same(binary_booster):
    X, _, bst = binary_booster
    back = pickle.loads(pickle.dumps(bst))
    np.testing.assert_array_equal(back.predict(X), bst.predict(X))
    np.testing.assert_array_equal(back.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))
    np.testing.assert_array_equal(back.predict(X, pred_leaf=True),
                                  bst.predict(X, pred_leaf=True))
    assert back.model_to_string() == bst.model_to_string()
    assert back.best_iteration == bst.best_iteration


def test_train_takes_the_reference_arguments_in_order():
    assert list(inspect.signature(lgb.train).parameters) == \
        list(inspect.signature(ref_lgb.train).parameters)


@pytest.mark.parametrize("kwargs", [{"checkpoint_dir": "ckpt"},
                                    {"checkpoint_freq": 5},
                                    {"resume": True}])
def test_checkpoint_arguments_raise_naming_item_19(kwargs, tmp_path):
    """Item 19 is ported: the checkpoint arguments no longer raise. Each
    one alone trains the run it would without it, as in the JAX package
    (a ``checkpoint_freq`` or ``resume`` without a directory does
    nothing); a directory gets the final checkpoint in both packages."""
    X, y = _binary(n=200)
    kwargs = {k: (str(tmp_path / v) if k == "checkpoint_dir" else v)
              for k, v in kwargs.items()}
    params = dict(objective="binary", verbose=-1)
    bst = lgb.train(dict(CPU, **params), lgb.Dataset(X, label=y),
                    num_boost_round=1, **kwargs)
    plain = lgb.train(dict(CPU, **params), lgb.Dataset(X, label=y),
                      num_boost_round=1)
    assert bst.model_to_string() == plain.model_to_string()
    if "checkpoint_dir" in kwargs:
        ref_dir = str(tmp_path / "ref")
        ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                      num_boost_round=1, checkpoint_dir=ref_dir)
        assert sorted(os.listdir(kwargs["checkpoint_dir"])) == \
            sorted(os.listdir(ref_dir)) == ["ckpt-00000001"]


# ----------------------------------------------------------------------
# Dataset
# ----------------------------------------------------------------------
def test_dataset_setters_getters_subset_and_create_valid():
    X, y = _binary(n=600)
    names = ["f%d" % i for i in range(6)]
    w = np.linspace(0.5, 1.5, 600)
    port = lgb.Dataset(X, label=y, feature_name=names, free_raw_data=False)
    ref = ref_lgb.Dataset(X, label=y, feature_name=names,
                          free_raw_data=False)
    assert port._handle is None
    for ds in (port, ref):
        ds.set_weight(w)
        ds.construct()
        ds.set_init_score(np.full(600, 0.25))
    assert port.num_data() == ref.num_data() == 600
    assert port.num_feature() == ref.num_feature() == 6
    assert port.get_feature_name() == ref.get_feature_name() == names
    np.testing.assert_array_equal(port.get_label(), ref.get_label())
    np.testing.assert_array_equal(port.get_weight(), ref.get_weight())
    assert port.get_group() is None and ref.get_group() is None
    port.set_label(1.0 - y)
    np.testing.assert_array_equal(port.get_label(), 1.0 - y)
    port.set_label(y)
    idx = np.arange(0, 600, 3)
    sub, rsub = port.subset(idx), ref.subset(idx)
    assert sub.num_data() == rsub.num_data() == 200
    np.testing.assert_array_equal(sub.get_label(), rsub.get_label())
    np.testing.assert_array_equal(sub.get_weight(), rsub.get_weight())
    np.testing.assert_array_equal(sub.handle.bins, np.asarray(rsub.handle.bins))
    np.testing.assert_array_equal(sub.handle.metadata.init_score,
                                  np.full(200, 0.25))
    Xv, yv = _binary(n=300, seed=5)
    valid = port.create_valid(Xv, label=yv)
    assert valid.reference is port
    np.testing.assert_array_equal(
        valid.handle.bins,
        np.asarray(ref.create_valid(Xv, label=yv).handle.bins))


def test_dataset_groups():
    X, y = _binary(n=120)
    group = [30, 50, 40]
    port = lgb.Dataset(X, label=y, group=group).construct()
    np.testing.assert_array_equal(port.get_group(), group)
    port.set_group([60, 60])
    np.testing.assert_array_equal(port.get_group(), [60, 60])
    sub = port.subset(np.arange(30, 90))
    np.testing.assert_array_equal(sub.get_group(), [30, 30])


# ----------------------------------------------------------------------
# a callable objective, feval, update(fobj)
# ----------------------------------------------------------------------
def _l2_obj(y):
    def l2_obj(score, dataset):
        return score - y, np.ones_like(score)
    return l2_obj


def _mae_feval(score, dataset):
    return "mae", float(np.abs(score - dataset.get_label()).mean()), False


def test_callable_objective_and_feval_match_the_reference():
    X, y = _reg()
    params = {"num_leaves": 15, "metric": "none", "verbosity": -1}
    results = {}
    for pkg, extra in ((ref_lgb, {}), (lgb, CPU)):
        ds = pkg.Dataset(X, label=y)
        ev = {}
        bst = pkg.train(dict(params, objective=_l2_obj(y), **extra), ds,
                        num_boost_round=8, valid_sets=[ds],
                        feval=_mae_feval,
                        callbacks=[pkg.record_evaluation(ev)])
        results[pkg] = (bst, ev["training"]["mae"])
    (ref, ref_mae), (port, port_mae) = results[ref_lgb], results[lgb]
    _same_trees(ref.inner.models, port.inner.models)
    np.testing.assert_allclose(port_mae, ref_mae, rtol=1e-5)
    assert port_mae[-1] < port_mae[0]
    # the matching case of tests/test_python_api.py
    assert np.abs(port.predict(X, raw_score=True) - y).mean() < 1.0


def test_update_with_fobj_and_eval_with_feval():
    X, y = _reg(n=600)
    ds = lgb.Dataset(X, label=y)
    bst = lgb.Booster(dict(CPU, objective="none", num_leaves=7,
                           verbose=-1), ds)
    vs = lgb.Dataset(X[:200], label=y[:200], reference=ds)
    bst.add_valid(vs, "head")
    for _ in range(3):
        bst.update(fobj=_l2_obj(y))
    assert bst.num_trees() == 3 and bst.current_iteration == 3
    (name, metric, value, higher), = bst.eval_valid(_mae_feval)
    assert (name, metric, higher) == ("head", "mae", False)
    np.testing.assert_allclose(
        value, np.abs(bst.predict(X[:200]) - y[:200]).mean(), rtol=1e-5)
    assert bst.eval_train(_mae_feval)[0][:2] == ("training", "mae")
    assert bst.feature_name() == ["Column_%d" % i for i in range(8)]
    assert bst.num_feature() == 8
    with pytest.raises(LightGBMError, match="item 18"):
        bst.update()        # objective=none needs a callable objective
    with pytest.raises(LightGBMError, match="own training set"):
        bst.update(train_set=vs, fobj=_l2_obj(y))


# ----------------------------------------------------------------------
# init_model, rollback_one_iter, reset_parameter
# ----------------------------------------------------------------------
def test_init_model_continues_like_the_reference(tmp_path):
    X, y = _reg()
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1}
    first = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                          num_boost_round=5)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=5, init_model=path)
    port = lgb.train(dict(params, **CPU), lgb.Dataset(X, label=y),
                     num_boost_round=5, init_model=path)
    assert port.num_trees() == ref.num_trees() == 10
    _same_trees(ref.inner.models[5:], port.inner.models[5:])
    np.testing.assert_allclose(port.inner.train_score.numpy(),
                               np.asarray(ref.inner.train_score),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.predict(X), ref.predict(X),
                               rtol=1e-5, atol=1e-6)
    # the matching case of tests/test_python_api.py: a port Booster as
    # init_model, and the error falls
    b1 = lgb.train(dict(params, **CPU), lgb.Dataset(X, label=y),
                   num_boost_round=10)
    b2 = lgb.train(dict(params, **CPU), lgb.Dataset(X, label=y),
                   num_boost_round=10, init_model=b1)
    assert b2.num_trees() == 20
    assert np.mean((b2.predict(X) - y) ** 2) < \
        np.mean((b1.predict(X) - y) ** 2)


def test_rollback_one_iter_matches_the_reference():
    X, y = _binary(n=800)
    Xv, yv = _binary(n=300, seed=3)
    params = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    boosters = {}
    for pkg, extra in ((ref_lgb, {}), (lgb, CPU)):
        ds = pkg.Dataset(X, label=y)
        bst = pkg.train(dict(params, **extra), ds, num_boost_round=4,
                        valid_sets=[pkg.Dataset(Xv, label=yv,
                                                reference=ds)])
        before = np.asarray(bst.inner.train_score).copy()
        bst.rollback_one_iter()
        assert len(bst.inner.models) == 3 and bst.current_iteration == 3
        assert not np.allclose(np.asarray(bst.inner.train_score), before)
        boosters[pkg] = bst
    ref, port = boosters[ref_lgb], boosters[lgb]
    _same_trees(ref.inner.models, port.inner.models)
    np.testing.assert_allclose(port.inner.train_score.numpy(),
                               np.asarray(ref.inner.train_score),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.inner.valid_data[0].scores,
                               ref.inner.valid_data[0].scores,
                               rtol=1e-5, atol=1e-6)
    three = lgb.train(dict(params, **CPU), lgb.Dataset(X, label=y),
                      num_boost_round=3)
    np.testing.assert_allclose(port.inner.train_score.numpy(),
                               three.inner.train_score.numpy(), atol=1e-6)


def test_reset_parameter_callback_matches_the_reference():
    X, y = _reg()
    params = {"objective": "regression", "num_leaves": 15, "verbosity": -1}
    sched = dict(learning_rate=[0.1, 0.05, 0.05, 0.2],
                 max_depth=[-1, 2, 2, 3])
    runs = {}
    for pkg, extra in ((ref_lgb, {}), (lgb, CPU)):
        runs[pkg] = pkg.train(dict(params, **extra),
                              pkg.Dataset(X, label=y), num_boost_round=4,
                              callbacks=[pkg.reset_parameter(**sched)])
    port = runs[lgb]
    _same_trees(runs[ref_lgb].inner.models, port.inner.models)
    trees = port.inner.models
    assert [t.shrinkage for t in trees] == pytest.approx(
        sched["learning_rate"])
    assert trees[0].structure_depth() > 3
    assert [t.structure_depth() for t in trees[1:]] == [2, 2, 3]


def test_reset_parameter_takes_effect_at_the_next_tree():
    X, y = _reg(n=600)
    bst = lgb.train(dict(CPU, objective="regression", num_leaves=15,
                         verbose=-1), lgb.Dataset(X, label=y),
                    num_boost_round=2)
    bst.reset_parameter({"learning_rate": 0.5, "max_depth": 1,
                         "min_data_in_leaf": 50})
    bst.update()
    last = bst.inner.models[-1]
    assert last.num_leaves == 2 and last.shrinkage == 0.5
    assert last.leaf_count[:2].min() >= 50
    assert bst.inner.learner.max_depth == 1
    # monotone constraints belong to the dataset: set between
    # iterations they leave the next tree as the reference leaves it
    # (unconstrained here), level (b)
    params = {"objective": "regression", "num_leaves": 15, "verbose": -1}
    ref = ref_lgb.train(params, ref_lgb.Dataset(X, label=y),
                        num_boost_round=1)
    bst = lgb.train(dict(CPU, **params), lgb.Dataset(X, label=y),
                    num_boost_round=1)
    for b in (ref, bst):
        b.reset_parameter({"monotone_constraints": [1] + [0] * 7})
        b.update()
    assert not bst.inner.learner._has_mono
    a, b = ref.inner.models[-1], bst.inner.models[-1]
    assert _splits(a) == _splits(b)
    np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                               a.leaf_value[:a.num_leaves],
                               rtol=1e-4, atol=1e-6)


# ----------------------------------------------------------------------
# dump_model
# ----------------------------------------------------------------------
def test_dump_model_equals_the_reference():
    X, y = _binary(n=800, nan=True)
    ref = ref_lgb.train({"objective": "binary", "num_leaves": 15,
                         "min_data_in_leaf": 20, "verbosity": -1},
                        ref_lgb.Dataset(X, label=y), num_boost_round=5)
    port = lgb.Booster(model_str=ref.model_to_string(), params=CPU)
    for kw in ({}, {"importance_type": "gain"},
               {"num_iteration": 2, "start_iteration": 1}):
        assert port.dump_model(**kw) == ref.dump_model(**kw)
    # the matching case of tests/test_model_export.py
    d = port.dump_model()
    assert d["name"] == "tree" and d["num_class"] == 1
    assert d["objective"].startswith("binary")
    assert len(d["tree_info"]) == 5
    root = d["tree_info"][0]["tree_structure"]
    assert root["decision_type"] == "<="
    assert json.loads(json.dumps(d))["max_feature_idx"] == 5

    def leaf_counts(node):
        if "leaf_index" in node:
            return node["leaf_count"]
        return (leaf_counts(node["left_child"])
                + leaf_counts(node["right_child"]))
    assert leaf_counts(root) == 800


def test_dump_model_of_a_port_trained_booster(binary_booster):
    X, _, bst = binary_booster
    d = bst.dump_model()
    assert len(d["tree_info"]) == bst.num_trees() == 4
    again = lgb.Booster(model_str=bst.model_to_string(), params=CPU)
    assert again.dump_model()["tree_info"] == d["tree_info"]
