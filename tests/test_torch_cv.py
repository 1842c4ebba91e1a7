"""``cv`` and ``CVBooster`` of the port (ROADMAP item 18b) against the
JAX package, on the CPU.

- the folds: row indices byte-equal to the reference's
  ``_make_n_folds`` (a), plain, stratified, grouped by query, and from a
  scikit-learn splitter;
- the result: the same keys, per-round means within 1e-4 of the JAX
  package's (c: binary goes through XLA's ``exp``, ROADMAP queue 3);
- ``return_cvbooster``: fold 0's booster has the text of ``lgb.train``
  on the same subset (a); early stopping cuts every list at the same
  best iteration as the JAX package's.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.engine import _make_n_folds as ref_make_n_folds
from lightgbm_tpu_torch.engine import _make_n_folds

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _binary(n=900, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.4 * rng.randn(n) > 0).astype(float)
    return X, y


def _ranking(seed=1):
    rng = np.random.RandomState(seed)
    group = rng.randint(5, 25, size=30)
    n = int(group.sum())
    X = rng.randn(n, 5)
    y = np.clip(np.floor(X[:, 0] + rng.randn(n) + 1.5), 0, 3)
    return X, y, group


def _folds_both(make_ds, folds=None, nfold=4, stratified=False,
                shuffle=True, seed=7):
    out = []
    for pkg, fn in ((lgb, _make_n_folds), (ref_lgb, ref_make_n_folds)):
        out.append(fn(make_ds(pkg), folds, nfold, {}, seed, stratified,
                      shuffle))
    return out


@pytest.mark.parametrize("kind", ["plain", "plain-noshuffle", "stratified",
                                  "grouped", "kfold", "group-kfold"])
def test_folds_equal_reference(kind):
    X, y = _binary()
    Xr, yr, group = _ranking()
    folds = None
    if kind in ("grouped", "group-kfold"):
        def make_ds(pkg):
            return pkg.Dataset(Xr, label=yr, group=group)
        if kind == "group-kfold":
            from sklearn.model_selection import GroupKFold
            folds = GroupKFold(n_splits=3)
    else:
        def make_ds(pkg):
            return pkg.Dataset(X, label=y)
        if kind == "kfold":
            from sklearn.model_selection import KFold
            folds = KFold(n_splits=3, shuffle=True, random_state=1)
    port, ref = _folds_both(make_ds, folds=folds,
                            stratified=kind == "stratified",
                            shuffle=kind != "plain-noshuffle")
    assert len(port) == len(ref) > 1
    for (pt, pv), (rt, rv) in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(pt), np.asarray(rt))
        np.testing.assert_array_equal(np.asarray(pv), np.asarray(rv))
        assert len(np.intersect1d(pt, pv)) == 0


def test_folds_reject_a_non_iterable():
    X, y = _binary(100)
    with pytest.raises(AttributeError, match="folds"):
        _make_n_folds(lgb.Dataset(X, label=y), 3, 3, {}, 0, False, True)


def test_cv_result_equals_reference():
    """Binary, 3 stratified folds, 5 rounds, two metrics and the train
    metric: the same keys, means and stdevs within 1e-4 (c)."""
    X, y = _binary()
    params = {"objective": "binary", "metric": ["auc", "binary_logloss"],
              "num_leaves": 7, "verbose": -1}
    port = lgb.cv(dict(params, **CPU), lgb.Dataset(X, label=y),
                  num_boost_round=5, nfold=3, eval_train_metric=True)
    ref = ref_lgb.cv(params, ref_lgb.Dataset(X, label=y),
                     num_boost_round=5, nfold=3, eval_train_metric=True)
    assert sorted(port) == sorted(ref)
    assert "valid auc-mean" in port
    assert "training binary_logloss-stdv" in port
    for key in ref:
        assert len(port[key]) == len(ref[key]) == 5
        np.testing.assert_allclose(port[key], ref[key], atol=1e-4)


def test_cv_regression_metrics_argument():
    """``metrics=`` overrides the params' metric; a regression objective
    takes plain (unstratified) folds."""
    rng = np.random.RandomState(4)
    X = rng.randn(600, 5)
    y = X[:, 0] + 0.1 * rng.randn(600)
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1}
    port = lgb.cv(dict(params, **CPU), lgb.Dataset(X, label=y),
                  num_boost_round=4, nfold=3, metrics="l1")
    ref = ref_lgb.cv(params, ref_lgb.Dataset(X, label=y),
                     num_boost_round=4, nfold=3, metrics="l1")
    assert sorted(port) == sorted(ref) == ["valid l1-mean", "valid l1-stdv"]
    np.testing.assert_allclose(port["valid l1-mean"], ref["valid l1-mean"],
                               rtol=1e-5)


def test_cvbooster_fold_is_train_on_its_subset():
    """return_cvbooster: fold 0's booster is lgb.train on the subset of
    fold 0's training rows, text for text (a); the CVBooster calls a
    method on every fold."""
    X, y = _binary()
    params = dict(CPU, objective="binary", num_leaves=7, verbose=-1)
    ds = lgb.Dataset(X, label=y)
    res = lgb.cv(params, ds, num_boost_round=4, nfold=3,
                 return_cvbooster=True)
    cvb = res["cvbooster"]
    assert isinstance(cvb, lgb.CVBooster) and len(cvb.boosters) == 3
    train_idx, _ = _make_n_folds(ds, None, 3, params, 0, True, True)[0]
    alone = lgb.train(params, ds.subset(train_idx), num_boost_round=4)
    assert cvb.boosters[0].model_to_string() == alone.model_to_string()
    preds = cvb.predict(X[:10])
    assert len(preds) == 3
    np.testing.assert_array_equal(preds[0], alone.predict(X[:10]))


def test_cv_early_stopping_equals_reference():
    """Early stopping on the mean of the folds: every list cut at the
    best iteration, the JAX package's."""
    X, y = _binary(1200, seed=3)
    params = {"objective": "binary", "metric": "binary_logloss",
              "num_leaves": 15, "learning_rate": 0.5, "verbose": -1}
    out = []
    for pkg, extra in ((lgb, CPU), (ref_lgb, {})):
        out.append(pkg.cv(dict(params, **extra), pkg.Dataset(X, label=y),
                          num_boost_round=60, nfold=3, return_cvbooster=True,
                          callbacks=[pkg.early_stopping(3, verbose=False)]))
    port, ref = out
    assert port["cvbooster"].best_iteration == \
        ref["cvbooster"].best_iteration < 60
    assert len(port["valid binary_logloss-mean"]) == \
        port["cvbooster"].best_iteration
    np.testing.assert_allclose(port["valid binary_logloss-mean"],
                               ref["valid binary_logloss-mean"], atol=1e-4)


def test_cv_on_ranking_groups():
    """lambdarank folds keep whole queries; ndcg keys equal the JAX
    package's."""
    X, y, group = _ranking()
    params = {"objective": "lambdarank", "num_leaves": 7, "verbose": -1,
              "eval_at": "1,3"}
    port = lgb.cv(dict(params, **CPU), lgb.Dataset(X, label=y, group=group),
                  num_boost_round=3, nfold=3)
    ref = ref_lgb.cv(params, ref_lgb.Dataset(X, label=y, group=group),
                     num_boost_round=3, nfold=3)
    assert sorted(port) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(port[key], ref[key], atol=1e-4)
