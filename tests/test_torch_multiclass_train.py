"""Multiclass training of the port against the JAX package's, on the CPU.

Softmax and one-vs-all, 3 classes, 3000 rows x 10, 15 leaves, 10
rounds (K = 3 trees per iteration), with f32 gradients and with 8-bit
quantized gradients (the tree counter that keys each tree's rounding
advances once per class tree, as the reference's does):

- every one of the 30 trees makes the same splits with the same leaf
  counts (level b);
- the held-out multi_logloss of every round agrees within 1e-6
  relative, multi_error exactly (level c);
- the model text round-trips: the loaded booster predicts the same
  [n, K] probabilities, and its text is the same;
- a multiclass model text trained by the reference, loaded into the
  port, predicts identically, raw, converted and leaf indices (level a).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb

torch.set_num_threads(1)


def _data(seed, n):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    f = X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] ** 2 + 0.3 * rng.randn(n)
    return X, np.digitize(f, [-0.5, 0.5]).astype(np.float64)


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


QUANT = {"use_quantized_grad": True, "quant_grad_bits": 8}
CASES = {
    "softmax": ("multiclass", {}),
    "softmax_quant8": ("multiclass", QUANT),
    "ova": ("multiclassova", {}),
    "ova_quant8": ("multiclassova", QUANT),
}


def _train(pkg, params, X, y, Xv, yv, extra=None):
    hist = {}
    ds = pkg.Dataset(X, label=y)
    bst = pkg.train(dict(params, **(extra or {})), ds, num_boost_round=10,
                    valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)],
                    callbacks=[pkg.record_evaluation(hist)])
    return bst, hist["valid_0"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_multiclass_flow_matches_reference(case):
    objective, extra = CASES[case]
    X, y = _data(0, 3000)
    Xv, yv = _data(1, 1000)
    params = dict(extra, objective=objective, num_class=3, num_leaves=15,
                  metric="multi_logloss,multi_error", verbose=-1)
    ref, ref_eval = _train(ref_lgb, params, X, y, Xv, yv)
    port, port_eval = _train(lgb, params, X, y, Xv, yv,
                             {"device_type": "cpu"})
    assert port.num_model_per_iteration() == 3
    assert len(port.inner.models) == len(ref.inner.models) == 30
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    np.testing.assert_allclose(port_eval["multi_logloss"],
                               ref_eval["multi_logloss"], rtol=1e-6)
    assert port_eval["multi_error"] == ref_eval["multi_error"]
    pred = port.predict(Xv)
    assert pred.shape == (1000, 3)
    np.testing.assert_allclose(pred, ref.predict(Xv), rtol=1e-5, atol=1e-7)
    # the text round-trip
    text = port.model_to_string()
    assert "num_class=3" in text and "num_tree_per_iteration=3" in text
    again = lgb.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(again.predict(Xv), pred)
    assert again.current_iteration == 10
    assert again.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]


def test_reference_multiclass_model_text_predicts_identically():
    X, y = _data(2, 2000)
    Xq, _ = _data(3, 500)
    Xq[::9, 1] = np.nan
    ref = ref_lgb.train({"objective": "multiclass", "num_class": 3,
                         "num_leaves": 7, "verbose": -1},
                        ref_lgb.Dataset(X, label=y), num_boost_round=6)
    port = lgb.Booster(model_str=ref.model_to_string(),
                       params={"device_type": "cpu"})
    assert port.inner.num_tree_per_iteration == 3
    assert port.current_iteration == 6
    np.testing.assert_array_equal(port.predict(Xq), ref.predict(Xq))
    np.testing.assert_array_equal(port.predict(Xq, raw_score=True),
                                  ref.predict(Xq, raw_score=True))
    np.testing.assert_array_equal(port.predict(Xq, pred_leaf=True),
                                  ref.predict(Xq, pred_leaf=True))
    np.testing.assert_array_equal(
        port.predict(Xq, num_iteration=2, raw_score=True),
        ref.predict(Xq, num_iteration=2, raw_score=True))
    # the multiclass margin of prediction early stopping (top1 - top2)
    kw = {"pred_early_stop": True, "pred_early_stop_freq": 2,
          "pred_early_stop_margin": 1.0}
    np.testing.assert_array_equal(port.predict(Xq, raw_score=True, **kw),
                                  ref.predict(Xq, raw_score=True, **kw))


def test_init_score_is_class_major():
    """An [n * K] init_score (all of class 0, then class 1, ...) starts
    the K score columns, in training and in the validation scores."""
    X, y = _data(4, 1500)
    rng = np.random.RandomState(5)
    init = rng.randn(3 * 1500) * 0.1
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "verbose": -1}
    ref = ref_lgb.Booster(params, ref_lgb.Dataset(X, label=y,
                                                  init_score=init))
    port = lgb.Booster(dict(params, device_type="cpu"),
                       lgb.Dataset(X, label=y, init_score=init))
    np.testing.assert_array_equal(port.inner.train_score.numpy(),
                                  np.asarray(ref.inner.train_score))
    ds = lgb.Dataset(X, label=y, init_score=init)
    port = lgb.train(dict(params, device_type="cpu"), ds,
                     num_boost_round=3,
                     valid_sets=[lgb.Dataset(X, label=y, init_score=init,
                                             reference=ds)])
    # the same rows: the validation walk gives the training scores
    np.testing.assert_array_equal(port.inner.valid_data[0].scores_dev
                                  .numpy(), port.inner.train_score.numpy())
