"""The scikit-learn estimators of the port (ROADMAP item 18b) on the CPU.

- ``fit`` is ``lgb.train`` with the estimator's parameters mapped to
  LightGBM's: the model text of an estimator equals that of
  ``lgb.train`` with the mapped parameters written out by hand (a);
- against the JAX package's estimators on the same rows: the same
  splits and leaf counts, predictions within 1e-4 (b; binary and
  multiclass go through XLA's ``exp``, ROADMAP queue 3);
- scikit-learn's protocol: get/set params, ``clone``, pickling,
  ``device_type`` through ``**kwargs``; the estimators also import and
  fit where scikit-learn is missing (the GPU machine has none).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}

# LGBMModel's defaults under LightGBM's own names
MAPPED = {"boosting": "gbdt", "num_leaves": 31, "max_depth": -1,
          "learning_rate": 0.1, "subsample_for_bin": 200000,
          "min_split_gain": 0.0, "min_child_weight": 1e-3,
          "min_child_samples": 20, "subsample": 1.0, "subsample_freq": 0,
          "colsample_bytree": 1.0, "reg_alpha": 0.0, "reg_lambda": 0.0,
          "verbosity": -1}


def _binary(n=800, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(int)
    return X, y


def _multi(n=900, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = np.argmax(X[:, :3] + 0.3 * rng.randn(n, 3), axis=1)
    return X, y


def _splits(tree):
    ni = tree.num_internal
    return (tree.num_leaves, tree.split_feature[:ni].tolist(),
            tree.threshold[:ni].tolist(),
            tree.leaf_count[:tree.num_leaves].tolist())


def _same_trees(ref_bst, port_bst):
    assert len(ref_bst.inner.models) == len(port_bst.inner.models)
    for a, b in zip(ref_bst.inner.models, port_bst.inner.models):
        assert _splits(a) == _splits(b)


def test_regressor_is_train_with_the_mapped_params():
    """Level (a): the regressor's model text is lgb.train's with the
    mapped parameters; predictions equal."""
    rng = np.random.RandomState(2)
    X = rng.randn(700, 5)
    y = X[:, 0] * 2 + np.sin(X[:, 1]) + 0.1 * rng.randn(700)
    est = lgb.LGBMRegressor(n_estimators=6, num_leaves=15,
                            device_type="cpu").fit(X, y)
    bst = lgb.train(dict(MAPPED, objective="regression", num_leaves=15,
                         **CPU), lgb.Dataset(X, label=y), num_boost_round=6)
    assert est.booster_.model_to_string() == bst.model_to_string()
    np.testing.assert_array_equal(est.predict(X), bst.predict(X))
    ref = ref_lgb.LGBMRegressor(n_estimators=6, num_leaves=15).fit(X, y)
    _same_trees(ref.booster_, est.booster_)
    np.testing.assert_allclose(est.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert est.n_features_in_ == 5 and est.feature_importances_.sum() > 0


@pytest.mark.parametrize("labels", ["int", "string", "class_weight"])
def test_binary_classifier(labels):
    """Binary labels (0/1, strings, with class_weight): the text of
    lgb.train on the encoded labels and weights (a); the JAX package's
    classifier at level (b); predict_proba rows sum to 1."""
    X, y = _binary()
    kw = {}
    weight = None
    if labels == "string":
        y = np.where(y > 0, "yes", "no")
    if labels == "class_weight":
        kw["class_weight"] = "balanced"
        counts = np.bincount(y)
        weight = np.array([len(y) / (2.0 * counts[v]) for v in y])
    est = lgb.LGBMClassifier(n_estimators=5, num_leaves=15,
                             device_type="cpu", **kw).fit(X, y)
    enc = np.searchsorted(np.unique(y), y).astype(float)
    bst = lgb.train(dict(MAPPED, objective="binary", num_leaves=15, **CPU),
                    lgb.Dataset(X, label=enc, weight=weight),
                    num_boost_round=5)
    assert est.booster_.model_to_string() == bst.model_to_string()
    proba = est.predict_proba(X)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0)
    np.testing.assert_array_equal(proba[:, 1], bst.predict(X))
    assert list(est.classes_) == sorted(set(y))
    assert set(est.predict(X)) <= set(y)
    ref = ref_lgb.LGBMClassifier(n_estimators=5, num_leaves=15,
                                 **kw).fit(X, y)
    _same_trees(ref.booster_, est.booster_)
    np.testing.assert_allclose(proba, ref.predict_proba(X), atol=1e-4)
    assert (est.predict(X) == ref.predict(X)).mean() > 0.99


def test_multiclass_classifier():
    """Three classes promote to multiclass (num_class 3): lgb.train's
    text (a), the JAX package's at level (b)."""
    X, y = _multi()
    est = lgb.LGBMClassifier(n_estimators=4, num_leaves=7,
                             device_type="cpu").fit(X, y)
    bst = lgb.train(dict(MAPPED, objective="multiclass", num_class=3,
                         num_leaves=7, **CPU),
                    lgb.Dataset(X, label=y.astype(float)), num_boost_round=4)
    assert est.booster_.model_to_string() == bst.model_to_string()
    assert est.n_classes_ == 3 and est.predict_proba(X).shape == (900, 3)
    ref = ref_lgb.LGBMClassifier(n_estimators=4, num_leaves=7).fit(X, y)
    _same_trees(ref.booster_, est.booster_)
    np.testing.assert_allclose(est.predict_proba(X), ref.predict_proba(X),
                               atol=1e-4)


def test_ranker_and_eval_set():
    """The ranker with query groups and an eval set: lambdarank's text
    of lgb.train (a); evals_result_ per round within 1e-6 of the JAX
    package's (c)."""
    rng = np.random.RandomState(3)
    group = rng.randint(5, 30, size=40)
    n = int(group.sum())
    X = rng.randn(n, 6)
    y = np.clip(np.floor(X[:, 0] + 0.5 * rng.randn(n) + 1.5), 0, 3)
    Xv, yv = X[:300], y[:300]
    gv = [100, 100, 100]
    fit_kw = dict(group=group, eval_set=[(Xv, yv)], eval_group=[gv],
                  eval_metric="ndcg")
    est = lgb.LGBMRanker(n_estimators=4, num_leaves=7,
                         device_type="cpu").fit(X, y, **fit_kw)
    tr = lgb.Dataset(X, label=y, group=group)
    bst = lgb.train(dict(MAPPED, objective="lambdarank", num_leaves=7,
                         metric=["ndcg"], **CPU), tr, num_boost_round=4,
                    valid_sets=[lgb.Dataset(Xv, label=yv, group=gv,
                                            reference=tr)])
    assert est.booster_.model_to_string() == bst.model_to_string()
    ref = ref_lgb.LGBMRanker(n_estimators=4, num_leaves=7).fit(X, y,
                                                               **fit_kw)
    _same_trees(ref.booster_, est.booster_)
    res, ref_res = est.evals_result_["valid_0"], ref.evals_result_["valid_0"]
    assert sorted(res) == sorted(ref_res)
    for key in res:
        np.testing.assert_allclose(res[key], ref_res[key], atol=1e-6)
    with pytest.raises(ValueError, match="group"):
        lgb.LGBMRanker(device_type="cpu").fit(X, y)


def test_eval_metric_callable_sees_probabilities():
    """A callable eval_metric gets (y_true, probabilities) under the
    binary objective, as the reference's wrapper gives them."""
    X, y = _binary()
    seen = []

    def metric(y_true, p):
        seen.append((y_true.copy(), p.copy()))
        return "my_err", float(np.mean((p > 0.5) != y_true)), False
    est = lgb.LGBMClassifier(n_estimators=3, num_leaves=7,
                             device_type="cpu")
    est.fit(X, y, eval_set=[(X[:200], y[:200])], eval_metric=metric)
    assert len(seen) == 3 and seen[-1][1].min() >= 0 \
        and seen[-1][1].max() <= 1
    assert len(est.evals_result_["valid_0"]["my_err"]) == 3


def test_params_clone_and_pickle():
    """get/set params, sklearn's clone and pickling; device_type and
    other LightGBM keywords ride in **kwargs and survive them."""
    from sklearn.base import clone
    est = lgb.LGBMClassifier(n_estimators=3, num_leaves=7,
                             device_type="cpu", min_data_in_bin=5)
    p = est.get_params()
    assert p["device_type"] == "cpu" and p["min_data_in_bin"] == 5
    est.set_params(num_leaves=5, bagging_seed=3)
    assert est.num_leaves == 5 and est.get_params()["bagging_seed"] == 3
    twin = clone(est)
    assert twin.get_params() == est.get_params()
    X, y = _binary()
    twin.fit(X, y)
    again = pickle.loads(pickle.dumps(twin))
    np.testing.assert_array_equal(again.predict_proba(X),
                                  twin.predict_proba(X))
    assert again.booster_.model_to_string() == \
        twin.booster_.model_to_string()


def test_fit_without_cpu_asks_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    X, y = _binary(200)
    with pytest.raises(LightGBMError, match="no CUDA device"):
        lgb.LGBMClassifier(n_estimators=1).fit(X, y)


def test_predict_before_fit_and_input_errors():
    est = lgb.LGBMRegressor(device_type="cpu")
    with pytest.raises(Exception, match="not fitted"):
        est.predict(np.zeros((2, 3)))
    with pytest.raises(ValueError, match="1 sample"):
        est.fit(np.zeros((1, 3)), [1.0])
    with pytest.raises(ValueError, match="continuous"):
        lgb.LGBMClassifier(device_type="cpu").fit(np.zeros((4, 2)),
                                                  [0.5, 1.5, 0.5, 1.5])


def test_estimators_without_sklearn():
    """Where scikit-learn is missing (the GPU machine), the estimators
    import with plain bases and still fit and predict."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'sklearn' or name.startswith('sklearn.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, lightgbm_tpu_torch as lgb\n"
        "assert 'sklearn' not in sys.modules\n"
        "assert lgb.LGBMModel.__mro__[1].__module__ == "
        "'lightgbm_tpu_torch.sklearn'\n"
        "rng = np.random.RandomState(0)\n"
        "X = rng.randn(300, 4); y = (X[:, 0] > 0).astype(int)\n"
        "est = lgb.LGBMClassifier(n_estimators=2, num_leaves=4,\n"
        "                         device_type='cpu').fit(X, y)\n"
        "assert est.predict_proba(X).shape == (300, 2)\n"
        "try:\n"
        "    lgb.LGBMClassifier().predict(X)\n"
        "except ValueError as e:\n"
        "    print('OK', e)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK Estimator not fitted" in out.stdout
