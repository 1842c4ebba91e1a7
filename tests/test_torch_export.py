"""SHAP contributions, the C++ export and the plots of the port (ROADMAP
item 18b), held against the JAX package on the same model text, on the
CPU.

One model text per case (binary with NaN-missing and zero-heavy
columns, regression, multiclass, categorical, linear), trained by the
port, is loaded into both packages:

- ``predict(pred_contrib=True)`` equal within 1e-12 (both are the same
  host TreeSHAP); each row's contributions sum to its raw score within
  1e-9 (not for linear trees, whose SHAP values, as the reference's,
  attribute the constant leaf values);
- ``model_to_cpp`` byte-equal (a); the source compiled with ``g++``
  gives ``predict``'s raw scores, values and leaf indices within 1e-12;
- ``plot_importance`` bars and ``plot_metric`` lines equal to the
  reference's (matplotlib's Agg backend); ``create_tree_digraph`` the
  same graph source where the graphviz module is installed.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu as ref_lgb
import lightgbm_tpu_torch as lgb
from lightgbm_tpu.models.codegen import model_to_cpp as ref_model_to_cpp
from lightgbm_tpu_torch.models.codegen import model_to_cpp

torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _mixed(n=800, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    X[rng.rand(n) < 0.15, 0] = np.nan
    X[rng.rand(n) < 0.6, 1] = 0.0
    X[:, 2] = rng.randint(0, 8, n)
    score = np.nan_to_num(X[:, 0]) + X[:, 1] + (X[:, 2] % 3 == 0) \
        - 0.3 * X[:, 3]
    return X, score


def _case(name):
    """(port model text, rows) of one case."""
    X, score = _mixed()
    params = dict(CPU, num_leaves=15, min_data_in_leaf=20, verbose=-1)
    kw = {}
    if name == "binary":
        params["objective"] = "binary"
        y = (score > 0).astype(float)
    elif name == "regression":
        params["objective"] = "regression"
        y = score
    elif name == "multiclass":
        params.update(objective="multiclass", num_class=3, num_leaves=7)
        y = np.digitize(score, [-0.5, 0.8]).astype(float)
    elif name == "categorical":
        params["objective"] = "binary"
        kw["categorical_feature"] = [2]
        y = (score > 0).astype(float)
    else:
        params.update(objective="regression", linear_tree=True,
                      num_leaves=7)
        X = np.nan_to_num(X)
        y = 2.0 * X[:, 0] + np.where(X[:, 3] > 0, 3.0, -1.0) * X[:, 4]
    bst = lgb.train(params, lgb.Dataset(X, label=y, **kw),
                    num_boost_round=6)
    return bst.model_to_string(), X


CASES = ["binary", "regression", "multiclass", "categorical", "linear"]


@pytest.fixture(scope="module", params=CASES)
def loaded(request):
    text, X = _case(request.param)
    port = lgb.Booster(model_str=text, params=CPU)
    ref = ref_lgb.Booster(model_str=text)
    return request.param, port, ref, X


def test_pred_contrib_equals_reference_and_adds_up(loaded):
    name, port, ref, X = loaded
    rows = X[:120]
    got = port.predict(rows, pred_contrib=True)
    want = ref.predict(rows, pred_contrib=True)
    K = port.num_model_per_iteration()
    assert got.shape == (120, K * (X.shape[1] + 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if name != "linear":
        raw = port.predict(rows, raw_score=True).reshape(120, K)
        sums = got.reshape(120, K, -1).sum(axis=2)
        np.testing.assert_allclose(sums, raw, rtol=0, atol=1e-9)


def test_cpp_source_byte_equal(loaded):
    _, port, ref, _ = loaded
    assert model_to_cpp(port.inner) == ref_model_to_cpp(ref.inner)


def _compile(cpp_path, tmp_path):
    so_path = str(tmp_path / "model.so")
    subprocess.check_call(["g++", "-O1", "-shared", "-fPIC", "-o", so_path,
                           cpp_path])
    lib = ctypes.CDLL(so_path)
    for fn in (lib.Predict, lib.PredictRaw, lib.PredictLeafIndex):
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
    return lib


def _run(lib, fn_name, X, width):
    fn = getattr(lib, fn_name)
    out = np.zeros((X.shape[0], width))
    Xc = np.ascontiguousarray(X, dtype=np.float64)
    ptr = ctypes.POINTER(ctypes.c_double)
    for i in range(X.shape[0]):
        fn(Xc[i].ctypes.data_as(ptr), out[i].ctypes.data_as(ptr))
    return out


def test_compiled_cpp_predicts_like_the_booster(loaded, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    _, port, _, X = loaded
    cpp = str(tmp_path / "model.cpp")
    port.save_model_to_cpp(cpp)
    lib = _compile(cpp, tmp_path)
    K = port.num_model_per_iteration()
    rows = X[:200]
    kw = {"predict_on_device": False}
    np.testing.assert_allclose(
        _run(lib, "PredictRaw", rows, K),
        port.predict(rows, raw_score=True, **kw).reshape(200, K),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        _run(lib, "Predict", rows, K),
        port.predict(rows, **kw).reshape(200, K), rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        _run(lib, "PredictLeafIndex", rows, port.num_trees()).astype(int),
        port.predict(rows, pred_leaf=True, **kw))


@pytest.fixture(scope="module")
def trained_pair():
    """The same rows and params trained by both packages, with a
    recorded validation metric."""
    X, score = _mixed(600)
    y = (score > 0).astype(float)
    out = []
    for pkg, extra in ((lgb, CPU), (ref_lgb, {})):
        hist = {}
        tr = pkg.Dataset(X, label=y)
        bst = pkg.train(dict({"objective": "binary", "num_leaves": 7,
                              "verbose": -1, "metric": "binary_logloss"},
                             **extra), tr, num_boost_round=5,
                        valid_sets=[tr], valid_names=["train"],
                        callbacks=[pkg.record_evaluation(hist)])
        out.append((bst, hist))
    return out


def test_plot_importance_and_metric_equal_reference(trained_pair):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    (port, port_hist), (ref, ref_hist) = trained_pair
    for kind in ("split", "gain"):
        axes = [mod.plot_importance(bst, importance_type=kind)
                for mod, bst in ((lgb, port), (ref_lgb, ref))]
        widths = [[p.get_width() for p in ax.patches] for ax in axes]
        labels = [[t.get_text() for t in ax.get_yticklabels()]
                  for ax in axes]
        assert labels[0] == labels[1] and len(labels[0]) > 0
        np.testing.assert_allclose(widths[0], widths[1], rtol=1e-4)
    axes = [mod.plot_metric(hist, metric="binary_logloss")
            for mod, hist in ((lgb, port_hist), (ref_lgb, ref_hist))]
    lines = [ax.lines[0].get_ydata() for ax in axes]
    assert len(lines[0]) == 5
    np.testing.assert_allclose(lines[0], lines[1], rtol=1e-5)
    feat = port.feature_importance().argmax()
    ax = lgb.plot_split_value_histogram(port, int(feat))
    assert sum(p.get_height() for p in ax.patches) == \
        port.feature_importance()[feat]
    plt.close("all")
    with pytest.raises(TypeError):
        lgb.plot_importance("not a booster")


def test_tree_digraph_equals_reference():
    """The same model text in both packages gives the same graph
    source."""
    graphviz = pytest.importorskip("graphviz")
    text, _ = _case("categorical")
    graphs = [mod.create_tree_digraph(bst, tree_index=1, precision=4)
              for mod, bst in ((lgb, lgb.Booster(model_str=text,
                                                  params=CPU)),
                               (ref_lgb, ref_lgb.Booster(model_str=text)))]
    assert isinstance(graphs[0], graphviz.Digraph)
    assert graphs[0].source == graphs[1].source
    assert "split0" in graphs[0].source


def test_save_model_to_cpp_is_atomic(tmp_path, monkeypatch):
    """The export goes through ``atomic_write``: a write that fails at
    the rename leaves the previous file and no temporary behind."""
    from lightgbm_tpu_torch.utils import atomic
    text, _ = _case("regression")
    bst = lgb.Booster(model_str=text, params=CPU)
    path = tmp_path / "m.cpp"
    path.write_text("previous")

    def fail(src, dst):
        raise OSError("rename failed")
    monkeypatch.setattr(atomic.os, "replace", fail)
    with pytest.raises(OSError, match="rename failed"):
        bst.save_model_to_cpp(str(path))
    assert path.read_text() == "previous"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.cpp"]
