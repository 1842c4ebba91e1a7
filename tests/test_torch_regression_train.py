"""The regression family's training in the port against the JAX
package's, on the CPU: l1, huber, fair, poisson, quantile, mape, gamma
and tweedie, 3000 rows x 8, 15 leaves, 3 rounds, unweighted and
weighted, plus l1 with bagging (renewal over the in-bag rows only).

- Every tree makes the same splits with the same leaf counts (level b).
- For l1, quantile and mape the leaf outputs are renewed on the host
  from percentiles of the residuals over the same partition, so tree 1's
  leaf values are byte-equal (level a), as they are for huber, whose
  gradients and hessians are byte-equal and whose leaf sums are exact.
- The default metric of each objective agrees within 1e-6 relative in
  every round (level c).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb

torch.set_num_threads(1)

RENEWED = {"regression_l1", "quantile", "mape"}


def _data(seed=0, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    f = X[:, 0] + 0.5 * X[:, 1] ** 2
    counts = rng.poisson(np.exp(0.4 * f)).astype(np.float64)
    labels = {
        "regression_l1": f + rng.randn(n) * 0.3,
        "huber": f + rng.randn(n) * 0.3,
        "fair": f + rng.randn(n) * 0.3,
        "poisson": counts,
        "quantile": f + rng.randn(n) * 0.3,
        "mape": 10 + 3 * f + rng.randn(n),
        "gamma": np.exp(0.3 * f) * rng.gamma(2.0, 0.5, n),
        "tweedie": counts * rng.gamma(2.0, 0.5, n),
    }
    return X, labels, rng.rand(n) + 0.5


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


CASES = [(name, w, {}) for name in sorted(_data(n=10)[1])
         for w in (False, True)]
CASES.append(("regression_l1", False,
              {"bagging_fraction": 0.7, "bagging_freq": 1}))
CASES.append(("quantile", True, {"alpha": 0.2}))


@pytest.mark.parametrize("name,weighted,extra", CASES)
def test_regression_flow_matches_reference(name, weighted, extra):
    X, labels, w = _data()
    y = labels[name]
    weight = w if weighted else None
    params = dict(extra, objective=name, num_leaves=15, verbose=-1)
    evals, models = [], []
    for pkg, dev in ((ref_lgb, {}), (lgb, {"device_type": "cpu"})):
        hist = {}
        ds = pkg.Dataset(X, label=y, weight=weight)
        bst = pkg.train(dict(params, **dev), ds, num_boost_round=3,
                        valid_sets=[ds], callbacks=[
                            pkg.record_evaluation(hist)])
        evals.append(hist["training"])
        models.append(bst.inner.models)
    ref_models, port_models = models
    assert len(port_models) == len(ref_models) == 3
    for i, (a, b) in enumerate(zip(ref_models, port_models)):
        assert _splits(a) == _splits(b), "tree %d differs" % i
    a, b = ref_models[0], port_models[0]
    if name in RENEWED or name == "huber":
        np.testing.assert_array_equal(b.leaf_value[:b.num_leaves],
                                      a.leaf_value[:a.num_leaves])
    else:
        np.testing.assert_allclose(b.leaf_value[:b.num_leaves],
                                   a.leaf_value[:a.num_leaves], rtol=1e-4,
                                   atol=1e-6)
    assert evals[0].keys() == evals[1].keys()
    for k in evals[0]:
        np.testing.assert_allclose(evals[1][k], evals[0][k], rtol=1e-6)
