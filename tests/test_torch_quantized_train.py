"""Quantized-gradient training and bagging of the port against the JAX
package's, on the CPU, on the verify-skill flow (2000 x 10, binary, 15
leaves, 20 rounds).

- The root histogram of tree 1 is byte-equal (level a): the learner's
  integer histogram equals the reference's quantizer and segment-sum on
  the same gradients.
- The bag indicator equals the reference's ``bag_draw`` byte for byte
  (level a), plain and balanced.
- Every tree makes the same splits with the same leaf counts (level b)
  and the per-round held-out AUC agrees within 1e-4 (level c, the
  tolerance of tests/test_torch_train.py): the integer sums are equal,
  and the split scan's prefix sums add in the reference's order; the
  rest of the scan rounds within a few ulps of the reference's jitted
  step (ROADMAP queue 3).

Levels (b) and (c) hold only where no split gain and no leaf output
lies within those few ulps of a rival. The two ``*_near_tie`` cases
broke them while the scan summed in torch's order (a gain tie at 1.3e-6
relative; four pure leaves within 4e-6 of each other).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.boosting.sample_strategy import bag_draw as ref_bag_draw
from lightgbm_tpu.ops import quantize as RQ
from lightgbm_tpu.ops.histogram import _segment_histogram
from lightgbm_tpu_torch.treelearner import serial

torch.set_num_threads(1)


def _verify_data(seed=0, n=2000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 10)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


QUANT = {"use_quantized_grad": True}
CASES = {
    "quant8": dict(QUANT, quant_grad_bits=8),
    "quant16": dict(QUANT, quant_grad_bits=16),
    "quant8_bagging": dict(QUANT, quant_grad_bits=8, bagging_fraction=0.7,
                           bagging_freq=2),
    "quant8_balanced": dict(QUANT, quant_grad_bits=8,
                            pos_bagging_fraction=0.6,
                            neg_bagging_fraction=0.8, bagging_freq=1),
    "quant16_bagging": dict(QUANT, quant_grad_bits=16,
                            bagging_fraction=0.7, bagging_freq=2),
    "quant8_balanced_near_tie": dict(QUANT, quant_grad_bits=8,
                                     pos_bagging_fraction=0.7,
                                     neg_bagging_fraction=0.9,
                                     bagging_freq=1),
    "quant16_balanced_near_tie": dict(QUANT, quant_grad_bits=16,
                                      pos_bagging_fraction=0.6,
                                      neg_bagging_fraction=0.8,
                                      bagging_freq=1),
    "exact_bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flow_matches_reference(case):
    X, y = _verify_data()
    Xv, yv = _verify_data(seed=1, n=1000)
    params = dict(CASES[case], objective="binary", metric="auc",
                  num_leaves=15, verbose=-1)
    ref_hist, port_hist = {}, {}
    rd = ref_lgb.Dataset(X, label=y)
    ref = ref_lgb.train(params, rd, num_boost_round=20,
                        valid_sets=[ref_lgb.Dataset(Xv, label=yv,
                                                    reference=rd)],
                        callbacks=[ref_lgb.record_evaluation(ref_hist)])
    pd = lgb.Dataset(X, label=y)
    port = lgb.train(dict(params, device_type="cpu"), pd,
                     num_boost_round=20,
                     valid_sets=[lgb.Dataset(Xv, label=yv, reference=pd)],
                     callbacks=[lgb.record_evaluation(port_hist)])
    assert len(port.inner.models) == len(ref.inner.models) == 20
    for i, (a, b) in enumerate(zip(ref.inner.models, port.inner.models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    np.testing.assert_allclose(port_hist["valid_0"]["auc"],
                               ref_hist["valid_0"]["auc"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("bits", [8, 16])
def test_root_histogram_byte_equal(bits, monkeypatch):
    """Tree 1's root histogram inside the port's learner equals the
    reference's quantize_gh + segment-sum on the same gradients and key
    (seed 7 -> fold_in(PRNGKey(7), 1))."""
    X, y = _verify_data(seed=2)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "device_type": "cpu", "seed": 7, "use_quantized_grad": True,
              "quant_grad_bits": bits}
    seen = {}
    build = serial.build_histogram

    def capture(bins, gh, num_bins, idx=None, count=None, **kw):
        out = build(bins, gh, num_bins, idx, count, **kw)
        if idx is None and "root" not in seen:
            seen.update(root=out, bins=bins, gh=gh)
        return out
    orig_stage = serial.SerialTreeLearner._quantize_stage

    def stage(self, grad, hess, ind, tree_no):
        if tree_no == 1:
            seen.update(grad=grad.numpy().copy(), hess=hess.numpy().copy(),
                        ind=ind.numpy().copy(), qmax=self._qmax)
        return orig_stage(self, grad, hess, ind, tree_no)
    monkeypatch.setattr(serial, "build_histogram", capture)
    monkeypatch.setattr(serial.SerialTreeLearner, "_quantize_stage", stage)
    lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=1)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 1)
    ref_gh, _ = RQ.quantize_gh(jnp.asarray(seen["grad"]),
                               jnp.asarray(seen["hess"]),
                               jnp.asarray(seen["ind"]), key, seen["qmax"],
                               RQ.quant_dtype(bits))
    assert np.array_equal(seen["gh"].numpy(), np.asarray(ref_gh))
    B = seen["root"].shape[1]
    ref = np.asarray(_segment_histogram(jnp.asarray(seen["bins"].numpy()),
                                        ref_gh, B))
    assert seen["root"].dtype == torch.int32 and ref.dtype == np.int32
    assert np.array_equal(seen["root"].numpy(), ref)


@pytest.mark.parametrize("balanced", [False, True])
def test_bag_indicator_equals_reference(balanced):
    X, y = _verify_data(seed=3)
    params = {"objective": "binary", "verbose": -1, "device_type": "cpu",
              "bagging_freq": 3, "bagging_seed": 11}
    if balanced:
        params.update(pos_bagging_fraction=0.5, neg_bagging_fraction=0.9)
        frac = jnp.asarray(np.where(y > 0, np.float32(0.5),
                                    np.float32(0.9)).astype(np.float32))
    else:
        params.update(bagging_fraction=0.6)
        frac = jnp.float32(0.6)
    bst = lgb.Booster(params=params, train_set=lgb.Dataset(X, label=y))
    strategy = bst.inner.sample_strategy
    base = jax.random.PRNGKey(11)
    for it in range(7):
        _, _, bag = strategy.bagging(it, None, None)
        want = np.asarray(ref_bag_draw(base, jnp.int32(it // 3), frac,
                                       len(y)))
        assert bag.dtype == torch.float32
        assert np.array_equal(bag.numpy(), want), it


def test_quantized_training_is_deterministic():
    """Integer histograms do not depend on summation order: two runs
    give the same model text."""
    X, y = _verify_data(seed=4)
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "device_type": "cpu", "use_quantized_grad": True,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    a = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    b = lgb.train(params, lgb.Dataset(X, label=y), num_boost_round=5)
    assert a.model_to_string() == b.model_to_string()
