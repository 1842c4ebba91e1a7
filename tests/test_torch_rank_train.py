"""Learning-to-rank training of the port against the JAX package's, on
the CPU: lambdarank and rank_xendcg over 150 queries of 2-60 docs (query
groups through ``Dataset(group=)``), 15 leaves, 10 rounds.

- Tree 1 makes the same splits with the same leaf counts (level b);
  the lambdas agree to 1e-5 x each query's sum of |lambda|
  (tests/test_torch_objective.py), and rank_xendcg draws the same
  uniforms.
- The held-out ndcg@1, @3 and @5 of every round agree within 1e-6
  (level c).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb

torch.set_num_threads(1)


def _rank_data(seed, num_queries):
    rng = np.random.RandomState(seed)
    group = rng.randint(2, 61, size=num_queries)
    n = int(group.sum())
    X = rng.randn(n, 8)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.5 * rng.randn(n)
    return X, np.clip(np.floor(rel + 1.5), 0, 4), group


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


CASES = {
    "lambdarank": {"objective": "lambdarank"},
    "lambdarank_truncated": {"objective": "lambdarank",
                             "lambdarank_truncation_level": 10,
                             "lambdarank_norm": False},
    "rank_xendcg": {"objective": "rank_xendcg"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_flow_matches_reference(case):
    X, y, group = _rank_data(0, 150)
    Xv, yv, gv = _rank_data(1, 50)
    params = dict(CASES[case], num_leaves=15, eval_at="1,3,5",
                  metric="ndcg", verbose=-1)
    evals = []
    models = []
    for pkg, extra in ((ref_lgb, {}), (lgb, {"device_type": "cpu"})):
        hist = {}
        ds = pkg.Dataset(X, label=y, group=group)
        bst = pkg.train(dict(params, **extra), ds, num_boost_round=10,
                        valid_sets=[pkg.Dataset(Xv, label=yv, group=gv,
                                                reference=ds)],
                        callbacks=[pkg.record_evaluation(hist)])
        evals.append(hist["valid_0"])
        models.append(bst.inner.models)
    ref_models, port_models = models
    assert len(port_models) == len(ref_models) == 10
    assert _splits(port_models[0]) == _splits(ref_models[0])
    for k in ("ndcg@1", "ndcg@3", "ndcg@5"):
        np.testing.assert_allclose(evals[1][k], evals[0][k], rtol=0,
                                   atol=1e-6)
    assert evals[1]["ndcg@5"][-1] > evals[1]["ndcg@5"][0]


def test_group_boundaries_and_errors():
    X, y, group = _rank_data(2, 20)
    ds = lgb.Dataset(X, label=y, group=group).construct()
    qb = ds.handle.metadata.query_boundaries
    np.testing.assert_array_equal(qb, np.concatenate([[0],
                                                      np.cumsum(group)]))
    assert ds.handle.metadata.num_queries == 20
    with pytest.raises(lgb.LightGBMError, match="query information"):
        lgb.train({"objective": "lambdarank", "device_type": "cpu",
                   "verbose": -1}, lgb.Dataset(X, label=y),
                  num_boost_round=1)
    with pytest.raises(lgb.LightGBMError, match="group sizes"):
        lgb.Dataset(X, label=y, group=group[:-1]).construct()


@pytest.mark.parametrize("first_metric_only", [False, True])
def test_early_stopping_over_ndcg_at_k(first_metric_only):
    """Early stopping reads every ``ndcg@k`` value (or the first one
    only) and stops where the reference stops."""
    X, y, group = _rank_data(3, 120)
    Xv, yv, gv = _rank_data(4, 40)
    params = {"objective": "lambdarank", "num_leaves": 31,
              "learning_rate": 0.5, "eval_at": "1,3", "metric": "ndcg",
              "early_stopping_round": 3,
              "first_metric_only": first_metric_only, "verbose": -1}
    out = []
    for pkg, extra in ((ref_lgb, {}), (lgb, {"device_type": "cpu"})):
        ds = pkg.Dataset(X, label=y, group=group)
        bst = pkg.train(dict(params, **extra), ds, num_boost_round=40,
                        valid_sets=[pkg.Dataset(Xv, label=yv, group=gv,
                                                reference=ds)])
        out.append((bst.best_iteration, bst.current_iteration,
                    sorted(bst.best_score["valid_0"])))
    assert out[1] == out[0]
    assert out[1][1] < 40
