"""The port's native host components (``lightgbm_tpu_torch/native/``) on
the CPU: the C++ text parser and ``GreedyFindBin`` (``parser.cpp``), and
the C inference ABI (``capi.cpp`` / ``capi.h``, ``native/capi.py``).

- every case of the JAX package's ``tests/test_native_parser.py`` and
  ``tests/test_c_api.py``, over the port's libraries (built with ``g++``
  into ``lightgbm_tpu_torch/_build/``) and port-trained models
  (``device_type="cpu"``); the C example (``examples/c_api/main.c``)
  compiled against the port's ``capi.cpp`` and run on a model of the
  port's CLI; the reference-binary case skips without
  ``LGBM_TPU_REFERENCE_BIN``;
- cross-checks against the JAX package: ``parse_dense``,
  ``parse_libsvm`` and ``greedy_find_bin`` give its results byte for
  byte, and its ``_capi.so`` and the port's predict one model text to
  the same bytes;
- no fallback: a missing ``g++`` and a failing build raise
  ``LightGBMError``; only a file the parser declines (a ragged row)
  returns None, for the caller's NumPy path.
"""
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.native import (greedy_find_bin, parse_dense,
                                       parse_libsvm)
from lightgbm_tpu_torch.native.capi import (C_API_PREDICT_CONTRIB,
                                            C_API_PREDICT_LEAF_INDEX,
                                            C_API_PREDICT_NORMAL,
                                            C_API_PREDICT_RAW_SCORE,
                                            NativeBooster, load_lib)
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device_type": "cpu"}


# ---------------------------------------------------------------------------
# the parser (tests/test_native_parser.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "data.csv"
    rng = np.random.RandomState(0)
    arr = rng.randn(200, 7)
    np.savetxt(p, arr, delimiter=",", fmt="%.10g")
    return str(p), arr


def test_parse_dense_matches_numpy(csv_file):
    path, arr = csv_file
    got = parse_dense(path, ",", 0)
    assert got is not None
    np.testing.assert_allclose(got, arr, rtol=1e-9)


def test_parse_dense_missing_and_header(tmp_path):
    p = tmp_path / "x.tsv"
    p.write_text("a\tb\tc\n1\t\t3\n4\t5\tnan\n\n7\t8\t9\n")
    got = parse_dense(str(p), "\t", 1)
    assert got is not None
    assert got.shape == (3, 3)
    assert np.isnan(got[0, 1]) and np.isnan(got[1, 2])
    np.testing.assert_allclose(got[2], [7, 8, 9])


def test_parse_libsvm(tmp_path):
    p = tmp_path / "x.svm"
    p.write_text("1 0:1.5 3:2.5\n0 1:-3\n2\n")
    parsed = parse_libsvm(str(p))
    assert parsed is not None
    X, y = parsed
    assert X.shape == (3, 4)
    np.testing.assert_allclose(y, [1, 0, 2])
    np.testing.assert_allclose(X[0], [1.5, 0, 0, 2.5])
    np.testing.assert_allclose(X[1], [0, -3, 0, 0])
    np.testing.assert_allclose(X[2], [0, 0, 0, 0])


def test_cli_uses_native_parser(tmp_path):
    """The CLI's text path gives the rows the file holds."""
    import lightgbm_tpu_torch.application as app
    from lightgbm_tpu_torch.config import Config
    p = tmp_path / "train.csv"
    rng = np.random.RandomState(1)
    arr = np.column_stack([rng.randint(0, 2, 300).astype(float),
                           rng.randn(300, 4)])
    np.savetxt(p, arr, delimiter=",", fmt="%.10g")
    X, y, w, g = app._load_tabular(str(p), Config.from_params({}))
    np.testing.assert_allclose(y, arr[:, 0])
    np.testing.assert_allclose(X, arr[:, 1:], rtol=1e-9)


def test_parse_dense_comments_and_edge_fields(tmp_path):
    """Comment lines skip like genfromtxt; whitespace-only fields must
    not swallow the next line's number (strtod skips newlines)."""
    p = tmp_path / "c.csv"
    p.write_text("# a comment line\n1,2, \n3,4,5\n")
    got = parse_dense(str(p), ",", 0)
    assert got is not None
    assert got.shape == (2, 3)
    assert np.isnan(got[0, 2])
    np.testing.assert_allclose(got[1], [3, 4, 5])


def test_parse_dense_ragged_row_fails_to_fallback(tmp_path):
    """The parser declines a ragged file (None): the CLI's NumPy path
    reads it and names the bad line."""
    import lightgbm_tpu_torch.application as app
    from lightgbm_tpu_torch.config import Config
    p = tmp_path / "r.csv"
    p.write_text("1,2\n3,4,5\n")
    assert parse_dense(str(p), ",", 0) is None
    with pytest.raises(ValueError, match="Line #2"):
        app._load_tabular(str(p), Config.from_params({}))


def test_parse_libsvm_truncated_pair(tmp_path):
    p = tmp_path / "t.svm"
    p.write_text("1 3:\n0.5 1:2\n")
    parsed = parse_libsvm(str(p))
    assert parsed is not None
    X, y = parsed
    np.testing.assert_allclose(y, [1, 0.5])
    assert X[0].sum() == 0.0  # the dangling "3:" contributed nothing
    np.testing.assert_allclose(X[1, 1], 2.0)


def _bin_cases():
    rng = np.random.RandomState(0)
    cases = []
    for n, kind in ((3000, "normal"), (600, "heavy"), (10000, "uniform"),
                    (40, "tiny"), (255, "exact")):
        if kind == "heavy":
            v = np.sort(np.unique(np.round(rng.randn(n) * 3)))
        elif kind == "uniform":
            v = np.sort(np.unique(rng.rand(n)))
        else:
            v = np.sort(np.unique(rng.randn(n)))
        c = rng.randint(1, 50, len(v)).astype(np.float64)
        cases.append((v, c))
    return cases


def test_greedy_find_bin_matches_python():
    """Native GreedyFindBin gives the port's binning search's bounds
    bit for bit over assorted distributions (the port bins with its
    search; the JAX package dispatches wide columns to the native
    one)."""
    from lightgbm_tpu_torch.io import binning
    for v, c in _bin_cases():
        for max_bin, mdib in ((255, 3), (63, 1), (16, 10)):
            total = int(c.sum())
            got = greedy_find_bin(v, c, max_bin, total, mdib)
            py = binning._greedy_find_bin(v, c, max_bin, total, mdib)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(py))


def test_parser_and_bins_equal_the_reference_bytes(tmp_path, csv_file):
    """The port's parser library and the JAX package's give the same
    bytes on the same files and bin inputs."""
    import lightgbm_tpu.native as ref_native
    path, _ = csv_file
    tsv = tmp_path / "x.tsv"
    tsv.write_text("a\tb\tc\n1\t\t3\n4\t5\tnan\n\n7\t8\t9\n-1e-300\t2e300\t"
                   "0.1\n")
    svm = tmp_path / "x.svm"
    svm.write_text("1 0:1.5 3:2.5\n0 1:-3\n2\n1 3:\n0.5 7:2e-7\n")
    for a, b in ((parse_dense(path, ",", 0),
                  ref_native.parse_dense(path, ",", 0)),
                 (parse_dense(str(tsv), "\t", 1),
                  ref_native.parse_dense(str(tsv), "\t", 1))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    (X, y), (rX, ry) = parse_libsvm(str(svm)), \
        ref_native.parse_libsvm(str(svm))
    assert X.tobytes() == rX.tobytes() and y.tobytes() == ry.tobytes()
    for v, c in _bin_cases():
        for max_bin, mdib in ((255, 3), (63, 1), (16, 10)):
            got = greedy_find_bin(v, c, max_bin, int(c.sum()), mdib)
            ref = ref_native.greedy_find_bin(v, c, max_bin, int(c.sum()),
                                             mdib)
            assert got.tobytes() == np.asarray(ref).tobytes()


def test_sources_are_the_reference_copies():
    """parser.cpp, capi.cpp and capi.h are the JAX package's files,
    unchanged."""
    for name in ("parser.cpp", "capi.cpp", "capi.h"):
        with open(os.path.join(ROOT, "lightgbm_tpu", "native", name),
                  "rb") as a, open(native.source_path(name), "rb") as b:
            assert a.read() == b.read(), name


def test_library_builds_into_the_build_dir():
    lib = load_lib()
    path = native.library_path("capi.cpp", "_capi.so")
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path) and lib is load_lib()
    assert not os.path.exists(os.path.join(ROOT, "lightgbm_tpu_torch",
                                           "native", "_capi.so"))


def test_missing_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(LightGBMError, match="g\\+\\+ not found"):
        parse_dense(str(tmp_path / "any.csv"), ",", 0)
    with pytest.raises(LightGBMError, match="g\\+\\+ not found"):
        load_lib()


def test_failing_build_raises(tmp_path, monkeypatch):
    (tmp_path / "parser.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(LightGBMError, match="g\\+\\+ failed to build"):
        greedy_find_bin(np.arange(3.0), np.ones(3), 2, 3, 1)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".tmp")]


# ---------------------------------------------------------------------------
# the C ABI (tests/test_c_api.py)
# ---------------------------------------------------------------------------

def _train(params, X, y, rounds=15, **ds_kw):
    p = {"verbosity": -1, "min_data_in_leaf": 5, "device_type": "cpu"}
    p.update(params)
    return lgb.train(p, lgb.Dataset(X, label=y, **ds_kw),
                     num_boost_round=rounds)


@pytest.fixture(scope="module")
def binary_model():
    rng = np.random.RandomState(0)
    X = rng.randn(500, 6)
    y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(500) > 0).astype(float)
    return _train({"objective": "binary"}, X, y), X


@pytest.mark.parametrize("objective,extra,make_y", [
    ("binary", {}, lambda X, rng: (X[:, 0] > 0).astype(float)),
    ("regression", {}, lambda X, rng: X[:, 0] * 2 + X[:, 1]),
    ("regression", {"reg_sqrt": True},
     lambda X, rng: np.abs(X[:, 0] * 3)),
    ("poisson", {}, lambda X, rng: rng.poisson(np.exp(
        np.clip(X[:, 0], -2, 2))).astype(float)),
    ("quantile", {"alpha": 0.7}, lambda X, rng: X[:, 0] + rng.randn(
        len(X)) * 0.1),
    ("multiclass", {"num_class": 3},
     lambda X, rng: np.argmax(X[:, :3], axis=1).astype(float)),
    ("multiclassova", {"num_class": 3},
     lambda X, rng: np.argmax(X[:, :3], axis=1).astype(float)),
    ("cross_entropy", {}, lambda X, rng: 1.0 / (1 + np.exp(-X[:, 0]))),
])
def test_predict_matches_python(objective, extra, make_y):
    """A NativeBooster over a port-trained model equals the port's host
    predict within 1e-12."""
    rng = np.random.RandomState(7)
    X = rng.randn(400, 5)
    y = make_y(X, rng)
    bst = _train(dict({"objective": objective}, **extra), X, y, rounds=12)
    nb = NativeBooster(model_str=bst.model_to_string())
    Xt = rng.randn(80, 5)
    for pt, kwargs in ((C_API_PREDICT_NORMAL, {}),
                       (C_API_PREDICT_RAW_SCORE, {"raw_score": True})):
        ours = np.asarray(bst.predict(Xt, **kwargs))
        theirs = nb.predict(Xt, predict_type=pt)
        np.testing.assert_allclose(
            theirs.reshape(ours.shape), ours, rtol=1e-12, atol=1e-12,
            err_msg="%s predict_type=%d" % (objective, pt))


def test_metadata(binary_model):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    assert nb.num_classes == 1
    assert nb.num_features == 6
    assert nb.num_iterations == 15
    assert nb.feature_names() == ["Column_%d" % i for i in range(6)]


def test_leaf_index_matches(binary_model):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    ours = np.asarray(bst.predict(X[:50], pred_leaf=True))
    theirs = nb.predict(X[:50], predict_type=C_API_PREDICT_LEAF_INDEX)
    np.testing.assert_array_equal(theirs.astype(np.int64),
                                  ours.reshape(theirs.shape))


def test_contrib_matches_python(binary_model):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    ours = np.asarray(bst.predict(X[:40], pred_contrib=True))
    theirs = nb.predict(X[:40], predict_type=C_API_PREDICT_CONTRIB)
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-9, atol=1e-9)
    # additivity: contribs sum to the raw score
    raw = np.asarray(bst.predict(X[:40], raw_score=True))
    np.testing.assert_allclose(theirs.sum(axis=1), raw, atol=1e-9)


def test_contrib_multiclass():
    rng = np.random.RandomState(3)
    X = rng.randn(300, 4)
    y = np.argmax(X[:, :3], axis=1).astype(float)
    bst = _train({"objective": "multiclass", "num_class": 3}, X, y, 8)
    nb = NativeBooster(model_str=bst.model_to_string())
    ours = np.asarray(bst.predict(X[:30], pred_contrib=True))
    theirs = nb.predict(X[:30], predict_type=C_API_PREDICT_CONTRIB)
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-9, atol=1e-9)


def test_missing_and_categorical():
    rng = np.random.RandomState(5)
    X = rng.randn(600, 5)
    X[:, 2] = rng.randint(0, 8, size=600)  # categorical
    X[rng.rand(600, 5) < 0.1] = np.nan     # missing holes
    y = ((np.nan_to_num(X[:, 0]) > 0) ^ (X[:, 2] == 3)).astype(float)
    bst = _train({"objective": "binary"}, X, y, 12,
                 categorical_feature=[2])
    nb = NativeBooster(model_str=bst.model_to_string())
    Xt = X[rng.permutation(600)[:100]]
    ours = np.asarray(bst.predict(Xt))
    theirs = nb.predict(Xt)
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-12, atol=1e-12)


def test_linear_trees():
    rng = np.random.RandomState(6)
    X = rng.randn(500, 4)
    y = 3 * X[:, 0] + X[:, 1] + 0.05 * rng.randn(500)
    bst = _train({"objective": "regression", "linear_tree": True}, X, y)
    nb = NativeBooster(model_str=bst.model_to_string())
    Xt = rng.randn(60, 4)
    Xt[rng.rand(60, 4) < 0.1] = np.nan  # NaN rows fall back to constants
    ours = np.asarray(bst.predict(Xt))
    theirs = nb.predict(Xt)
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-12, atol=1e-12)


def test_rf_average_output():
    rng = np.random.RandomState(8)
    X = rng.randn(500, 5)
    y = (X[:, 0] + X[:, 1] > 0).astype(float)
    bst = _train({"objective": "binary", "boosting": "rf",
                  "bagging_freq": 1, "bagging_fraction": 0.7,
                  "feature_fraction": 0.8}, X, y, rounds=10)
    nb = NativeBooster(model_str=bst.model_to_string())
    ours = np.asarray(bst.predict(X[:50]))
    theirs = nb.predict(X[:50])
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-12, atol=1e-12)


def test_csr_matches_dense(binary_model):
    import scipy.sparse as sp
    bst, X = binary_model
    Xs = X[:50].copy()
    Xs[np.abs(Xs) < 0.5] = 0.0
    csr = sp.csr_matrix(Xs)
    nb = NativeBooster(model_str=bst.model_to_string())
    dense = nb.predict(Xs)
    sparse = nb.predict_csr(csr.indptr, csr.indices, csr.data,
                            num_col=Xs.shape[1])
    np.testing.assert_allclose(sparse, dense, rtol=1e-15)


def test_model_file_roundtrip(binary_model, tmp_path):
    bst, X = binary_model
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    nb = NativeBooster(model_file=path)
    ours = np.asarray(bst.predict(X[:20]))
    np.testing.assert_allclose(nb.predict(X[:20]).reshape(ours.shape),
                               ours, rtol=1e-12)
    # verbatim save round-trip
    out = str(tmp_path / "model2.txt")
    assert nb._lib.LGBM_BoosterSaveModel(nb._handle, 0, -1, 0,
                                         out.encode()) == 0
    with open(path) as f1, open(out) as f2:
        assert f1.read() == f2.read()
    with open(path) as f1:
        assert nb.save_model_to_string() == f1.read()


def test_iteration_slicing(binary_model):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    ours = np.asarray(bst.predict(X[:30], raw_score=True,
                                  start_iteration=3, num_iteration=5))
    theirs = nb.predict(X[:30], predict_type=C_API_PREDICT_RAW_SCORE,
                        start_iteration=3, num_iteration=5)
    np.testing.assert_allclose(theirs.reshape(ours.shape), ours,
                               rtol=1e-12, atol=1e-14)


def test_reference_model_loads(tmp_path):
    """A model file written by the reference LightGBM binary predicts
    identically through the port's C library (when the binary is
    available)."""
    ref = os.environ.get("LGBM_TPU_REFERENCE_BIN")
    if not ref or not os.path.exists(ref):
        pytest.skip("reference binary not available")
    rng = np.random.RandomState(11)
    X = rng.randn(300, 4)
    y = (X[:, 0] > 0).astype(float)
    train = str(tmp_path / "train.csv")
    np.savetxt(train, np.column_stack([y, X]), delimiter=",")
    conf = str(tmp_path / "train.conf")
    model = str(tmp_path / "model.txt")
    with open(conf, "w") as f:
        f.write("task=train\nobjective=binary\ndata=%s\n"
                "label_column=0\noutput_model=%s\nnum_trees=10\n"
                "verbosity=-1\nheader=false\n" % (train, model))
    subprocess.check_call([ref, "config=%s" % conf],
                          stdout=subprocess.DEVNULL)
    nb = NativeBooster(model_file=model)
    bst = lgb.Booster(model_file=model, params=CPU)
    ours = np.asarray(bst.predict(X))
    np.testing.assert_allclose(nb.predict(X).reshape(ours.shape),
                               ours, rtol=1e-12, atol=1e-12)


def test_single_row_matches_batch(binary_model):
    bst, X = binary_model
    lib = load_lib()
    nb = NativeBooster(model_str=bst.model_to_string())
    row = np.ascontiguousarray(X[7], dtype=np.float64)
    out = np.empty(1, dtype=np.float64)
    out_len = ctypes.c_int64()
    rc = lib.LGBM_BoosterPredictForMatSingleRow(
        nb._handle, row.ctypes.data_as(ctypes.c_void_p), 1,
        row.shape[0], 1, C_API_PREDICT_NORMAL, 0, -1, b"",
        ctypes.byref(out_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0 and out_len.value == 1
    batch = nb.predict(X[7:8])
    assert out[0] == batch[0, 0]


def compile_c_example(out_path: str) -> None:
    """``examples/c_api/main.c`` built against the port's ``capi.cpp``
    (its include of the JAX package's ``capi.h``, the same file, points
    at the port's copy)."""
    with open(os.path.join(ROOT, "examples", "c_api", "main.c")) as fh:
        text = fh.read()
    include = '#include "../../lightgbm_tpu/native/capi.h"'
    assert include in text
    src = out_path + ".c"
    with open(src, "w") as fh:
        fh.write(text.replace(include, '#include "capi.h"'))
    subprocess.check_call(
        ["g++", "-O2", "-std=c++17", "-I", os.path.dirname(
            native.source_path("capi.h")), "-o", out_path, src,
         native.source_path("capi.cpp"), "-lm"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def test_c_example_end_to_end(tmp_path):
    """The C host of examples/c_api compiles against the port's
    capi.cpp, loads a model of the port's CLI, and its predictions
    match the port's predictor (the steps of examples/c_api/run.sh)."""
    from lightgbm_tpu_torch.application import run
    rng = np.random.RandomState(0)
    for name, n in (("binary.train", 1500), ("binary.test", 300)):
        X = rng.randn(n, 8)
        y = (X[:, 0] - X[:, 1] + 0.3 * rng.randn(n) > 0).astype(int)
        np.savetxt(tmp_path / name, np.column_stack([y, X]),
                   delimiter="\t", fmt="%.10g")
    model = str(tmp_path / "model.txt")
    assert run(["task=train", "objective=binary", "device_type=cpu",
                "data=%s" % (tmp_path / "binary.train"),
                "output_model=" + model, "num_trees=20", "num_leaves=31",
                "verbosity=-1"]) == 0
    rows = np.loadtxt(tmp_path / "binary.test", delimiter="\t")
    np.savetxt(tmp_path / "features.csv", rows[:, 1:], delimiter=",",
               fmt="%.10g")
    exe = str(tmp_path / "c_api_example")
    compile_c_example(exe)
    with open(tmp_path / "preds_c.txt", "w") as fh:
        subprocess.check_call([exe, model, str(tmp_path / "features.csv")],
                              stdout=fh, stderr=subprocess.DEVNULL)
    preds_c = np.loadtxt(tmp_path / "preds_c.txt")
    feats = np.loadtxt(tmp_path / "features.csv", delimiter=",")
    bst = lgb.Booster(model_file=model, params=CPU)
    np.testing.assert_allclose(preds_c, np.asarray(bst.predict(feats)),
                               rtol=1e-10)


def test_csc_matches_dense(binary_model):
    import scipy.sparse as sp
    bst, X = binary_model
    Xs = X[:40].copy()
    Xs[np.abs(Xs) < 0.5] = 0.0
    csc = sp.csc_matrix(Xs)
    nb = NativeBooster(model_str=bst.model_to_string())
    dense = nb.predict(Xs)
    out = np.empty(40, dtype=np.float64)
    out_len = ctypes.c_int64()
    col_ptr = np.ascontiguousarray(csc.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(csc.indices, dtype=np.int32)
    data = np.ascontiguousarray(csc.data, dtype=np.float64)
    rc = nb._lib.LGBM_BoosterPredictForCSC(
        nb._handle, col_ptr.ctypes.data_as(ctypes.c_void_p), 3,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        data.ctypes.data_as(ctypes.c_void_p), 1, len(col_ptr),
        len(data), 40, C_API_PREDICT_NORMAL, 0, -1, b"",
        ctypes.byref(out_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    assert rc == 0
    np.testing.assert_allclose(out, dense[:, 0], rtol=1e-15)


def test_leaf_value_get_set(binary_model):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    v = ctypes.c_double()
    assert nb._lib.LGBM_BoosterGetLeafValue(
        nb._handle, 0, 1, ctypes.byref(v)) == 0
    assert v.value == bst.inner.models[0].leaf_value[1]
    # out-of-range errors, not crashes
    assert nb._lib.LGBM_BoosterGetLeafValue(
        nb._handle, 9999, 0, ctypes.byref(v)) != 0
    # external leaf refit: set, predict reflects it, verbatim save gone
    before = nb.predict(X[:5], predict_type=C_API_PREDICT_RAW_SCORE)
    assert nb._lib.LGBM_BoosterSetLeafValue(
        nb._handle, 0, 1, v.value + 1.0) == 0
    after = nb.predict(X[:5], predict_type=C_API_PREDICT_RAW_SCORE)
    leaf0 = nb.predict(X[:5], predict_type=C_API_PREDICT_LEAF_INDEX)[:, 0]
    delta = np.where(leaf0 == 1, 1.0, 0.0)
    np.testing.assert_allclose(after[:, 0] - before[:, 0], delta,
                               atol=1e-12)
    with pytest.raises(Exception):
        nb.save_model_to_string()


def test_predict_for_file(binary_model, tmp_path):
    """C-only deployment pipeline: predict straight from a CSV file
    (label column in front, CLI convention) and from LibSVM, no Python
    in the loop."""
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    expect = np.asarray(bst.predict(X[:50]))
    data = tmp_path / "rows.csv"
    np.savetxt(data, np.hstack([np.zeros((50, 1)), X[:50]]), delimiter=",",
               fmt="%.10g")
    out = tmp_path / "preds.txt"
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(data).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        b"", str(out).encode()) == 0
    np.testing.assert_allclose(np.loadtxt(out), expect, rtol=1e-12)
    # LibSVM (narrower than the model pads with zeros)
    svm = tmp_path / "rows.svm"
    with open(svm, "w") as f:
        for i in range(50):
            feats = " ".join("%d:%.10g" % (j, X[i, j])
                             for j in range(4) if X[i, j] != 0.0)
            f.write("0 %s\n" % feats)
    Xp = X[:50].copy()
    Xp[:, 4:] = 0.0
    expect_svm = np.asarray(bst.predict(Xp))
    out2 = tmp_path / "preds2.txt"
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(svm).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        b"", str(out2).encode()) == 0
    np.testing.assert_allclose(np.loadtxt(out2), expect_svm, rtol=1e-12)


def test_predict_for_file_parameters(binary_model, tmp_path):
    bst, X = binary_model
    nb = NativeBooster(model_str=bst.model_to_string())
    expect = np.asarray(bst.predict(X[:20]))
    # features-only file needs no_label=true
    data = tmp_path / "feat.csv"
    np.savetxt(data, X[:20], delimiter=",", fmt="%.10g")
    out = tmp_path / "p.txt"
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(data).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        b"no_label=true", str(out).encode()) == 0
    np.testing.assert_allclose(np.loadtxt(out), expect, rtol=1e-12)
    # without the parameter, the width mismatch is a loud error
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(data).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        b"", str(out).encode()) != 0
    # label in the last column
    data2 = tmp_path / "tail.csv"
    np.savetxt(data2, np.hstack([X[:20], np.zeros((20, 1))]),
               delimiter=",", fmt="%.10g")
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(data2).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        ("label_column=%d" % X.shape[1]).encode(),
        str(out).encode()) == 0
    np.testing.assert_allclose(np.loadtxt(out), expect, rtol=1e-12)
    # unsupported parameters are rejected, not silently dropped
    assert nb._lib.LGBM_BoosterPredictForFile(
        nb._handle, str(data).encode(), 0, C_API_PREDICT_NORMAL, 0, -1,
        b"two_round=true", str(out).encode()) != 0


def test_dump_model_matches_python():
    rng = np.random.RandomState(17)
    X = rng.randn(500, 6)
    X[:, 3] = rng.randint(0, 6, 500)
    y = ((X[:, 0] > 0) ^ (X[:, 3] == 2)).astype(float)
    bst = _train({"objective": "binary",
                  "monotone_constraints": [1, 0, 0, 0, 0, 0]}, X, y, 6,
                 categorical_feature=[3])
    nb = NativeBooster(model_str=bst.model_to_string())
    # identical schema and values, feature_infos included (floats
    # compare exactly: both sides write round-trip representations)
    assert nb.dump_model() == bst.dump_model()


def test_dump_model_linear_matches_python():
    rng = np.random.RandomState(19)
    X = rng.randn(500, 4)
    y = 2 * X[:, 0] + X[:, 1] + 0.05 * rng.randn(500)
    bst = _train({"objective": "regression", "linear_tree": True}, X, y, 4)
    nb = NativeBooster(model_str=bst.model_to_string())
    assert nb.dump_model() == bst.dump_model()


@pytest.mark.parametrize("predict_type", [
    C_API_PREDICT_NORMAL, C_API_PREDICT_RAW_SCORE, C_API_PREDICT_LEAF_INDEX,
    C_API_PREDICT_CONTRIB])
def test_port_and_reference_libraries_predict_the_same_bytes(
        binary_model, predict_type):
    """The JAX package's ``_capi.so`` and the port's, on one model
    text, give the same bytes for every predict type."""
    from lightgbm_tpu.native.capi import NativeBooster as RefNativeBooster
    bst, X = binary_model
    text = bst.model_to_string()
    ours = NativeBooster(model_str=text).predict(X, predict_type)
    theirs = RefNativeBooster(model_str=text).predict(X, predict_type)
    assert ours.shape == theirs.shape
    assert ours.tobytes() == theirs.tobytes()
