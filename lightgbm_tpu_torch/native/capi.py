"""ctypes loader for the C inference library (``capi.cpp``).

Port of ``lightgbm_tpu/native/capi.py``. The shared object is the
external-engine ABI (``capi.h``, the JAX package's header, unchanged):
a C, R or Java host loads a model text and predicts with no Python.
This module is its in-repo consumer, used by the tests to hold the C
predictor against the Python one, and a way for Python hosts to predict
natively without the GIL. It builds at first use with ``g++`` into
``lightgbm_tpu_torch/_build/`` (``native/__init__.py``); a missing or
failing toolchain raises ``LightGBMError``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import load

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3


def _bind(lib: ctypes.CDLL) -> None:
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def load_lib() -> ctypes.CDLL:
    """Build (once) and open the C API library."""
    return load("capi.cpp", "_capi.so", _bind)


_p = ctypes.POINTER
_SIGNATURES = {
    "LGBM_BoosterCreateFromModelfile":
        [ctypes.c_char_p, _p(ctypes.c_int), _p(ctypes.c_void_p)],
    "LGBM_BoosterLoadModelFromString":
        [ctypes.c_char_p, _p(ctypes.c_int), _p(ctypes.c_void_p)],
    "LGBM_BoosterFree": [ctypes.c_void_p],
    "LGBM_BoosterGetNumClasses": [ctypes.c_void_p, _p(ctypes.c_int)],
    "LGBM_BoosterGetNumFeature": [ctypes.c_void_p, _p(ctypes.c_int)],
    "LGBM_BoosterGetCurrentIteration": [ctypes.c_void_p, _p(ctypes.c_int)],
    "LGBM_BoosterCalcNumPredict":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, _p(ctypes.c_int64)],
    "LGBM_BoosterPredictForMat":
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
         ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_int64),
         _p(ctypes.c_double)],
    "LGBM_BoosterPredictForCSR":
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         _p(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_int64),
         _p(ctypes.c_double)],
    "LGBM_BoosterPredictForMatSingleRow":
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_char_p, _p(ctypes.c_int64), _p(ctypes.c_double)],
    "LGBM_BoosterPredictForCSRSingleRow":
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         _p(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_int64),
         _p(ctypes.c_double)],
    "LGBM_BoosterPredictForCSC":
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         _p(ctypes.c_int32), ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_char_p, _p(ctypes.c_int64),
         _p(ctypes.c_double)],
    "LGBM_BoosterGetNumPredict":
        [ctypes.c_void_p, ctypes.c_int, _p(ctypes.c_int64)],
    "LGBM_BoosterGetLeafValue":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         _p(ctypes.c_double)],
    "LGBM_BoosterSetLeafValue":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double],
    "LGBM_BoosterPredictForFile":
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p],
    "LGBM_BoosterDumpModel":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int64, _p(ctypes.c_int64), ctypes.c_char_p],
    "LGBM_BoosterSaveModel":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_char_p],
    "LGBM_BoosterSaveModelToString":
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int64, _p(ctypes.c_int64), ctypes.c_char_p],
    "LGBM_BoosterGetFeatureNames":
        [ctypes.c_void_p, ctypes.c_int, _p(ctypes.c_int), ctypes.c_size_t,
         _p(ctypes.c_size_t), _p(ctypes.c_char_p)],
}


class NativeBoosterError(RuntimeError):
    pass


def _check(lib, rc: int) -> None:
    if rc != 0:
        raise NativeBoosterError(lib.LGBM_GetLastError().decode())


class NativeBooster:
    """Thin handle over the C API — the same call sequence an external
    C/R/Java host performs, here driven from the tests."""

    def __init__(self, model_str: Optional[str] = None,
                 model_file: Optional[str] = None):
        lib = load_lib()
        self._lib = lib
        self._handle = ctypes.c_void_p()
        n_iter = ctypes.c_int()
        if model_file is not None:
            _check(lib, lib.LGBM_BoosterCreateFromModelfile(
                model_file.encode(), ctypes.byref(n_iter),
                ctypes.byref(self._handle)))
        else:
            _check(lib, lib.LGBM_BoosterLoadModelFromString(
                model_str.encode(), ctypes.byref(n_iter),
                ctypes.byref(self._handle)))
        self.num_iterations = n_iter.value

    def close(self) -> None:
        if self._handle:
            self._lib.LGBM_BoosterFree(self._handle)
            self._handle = ctypes.c_void_p()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------
    @property
    def num_classes(self) -> int:
        v = ctypes.c_int()
        _check(self._lib, self._lib.LGBM_BoosterGetNumClasses(
            self._handle, ctypes.byref(v)))
        return v.value

    @property
    def num_features(self) -> int:
        v = ctypes.c_int()
        _check(self._lib, self._lib.LGBM_BoosterGetNumFeature(
            self._handle, ctypes.byref(v)))
        return v.value

    def feature_names(self) -> list:
        n = ctypes.c_int()
        width = ctypes.c_size_t()
        _check(self._lib, self._lib.LGBM_BoosterGetFeatureNames(
            self._handle, 0, ctypes.byref(n), 0, ctypes.byref(width), None))
        bufs = [ctypes.create_string_buffer(width.value + 1)
                for _ in range(n.value)]
        arr = (ctypes.c_char_p * n.value)(
            *[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
        _check(self._lib, self._lib.LGBM_BoosterGetFeatureNames(
            self._handle, n.value, ctypes.byref(n), width.value + 1,
            ctypes.byref(width), arr))
        return [b.value.decode() for b in bufs]

    # ------------------------------------------------------------------
    def predict(self, X: np.ndarray, predict_type: int = 0,
                start_iteration: int = 0,
                num_iteration: int = -1) -> np.ndarray:
        X = np.ascontiguousarray(X)
        if X.dtype == np.float32:
            dtype = C_API_DTYPE_FLOAT32
        else:
            X = X.astype(np.float64, copy=False)
            dtype = C_API_DTYPE_FLOAT64
        nrow, ncol = X.shape
        total = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterCalcNumPredict(
            self._handle, nrow, predict_type, start_iteration,
            num_iteration, ctypes.byref(total)))
        out = np.empty(total.value, dtype=np.float64)
        out_len = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterPredictForMat(
            self._handle, X.ctypes.data_as(ctypes.c_void_p), dtype,
            nrow, ncol, 1, predict_type, start_iteration, num_iteration,
            b"", ctypes.byref(out_len),
            out.ctypes.data_as(_p(ctypes.c_double))))
        assert out_len.value == total.value
        return out.reshape(nrow, -1)

    def predict_csr(self, indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, num_col: int,
                    predict_type: int = 0, start_iteration: int = 0,
                    num_iteration: int = -1) -> np.ndarray:
        indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
        indices32 = np.ascontiguousarray(indices, dtype=np.int32)
        data64 = np.ascontiguousarray(data, dtype=np.float64)
        nrow = len(indptr64) - 1
        total = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterCalcNumPredict(
            self._handle, nrow, predict_type, start_iteration,
            num_iteration, ctypes.byref(total)))
        out = np.empty(total.value, dtype=np.float64)
        out_len = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterPredictForCSR(
            self._handle, indptr64.ctypes.data_as(ctypes.c_void_p),
            C_API_DTYPE_INT64,
            indices32.ctypes.data_as(_p(ctypes.c_int32)),
            data64.ctypes.data_as(ctypes.c_void_p), C_API_DTYPE_FLOAT64,
            len(indptr64), len(data64), num_col, predict_type,
            start_iteration, num_iteration, b"", ctypes.byref(out_len),
            out.ctypes.data_as(_p(ctypes.c_double))))
        return out.reshape(nrow, -1)

    def dump_model(self) -> dict:
        import json
        n = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterDumpModel(
            self._handle, 0, -1, 0, 0, ctypes.byref(n), None))
        buf = ctypes.create_string_buffer(n.value)
        _check(self._lib, self._lib.LGBM_BoosterDumpModel(
            self._handle, 0, -1, 0, n.value, ctypes.byref(n), buf))
        return json.loads(buf.value.decode())

    def save_model_to_string(self) -> str:
        n = ctypes.c_int64()
        _check(self._lib, self._lib.LGBM_BoosterSaveModelToString(
            self._handle, 0, -1, 0, 0, ctypes.byref(n), None))
        buf = ctypes.create_string_buffer(n.value)
        _check(self._lib, self._lib.LGBM_BoosterSaveModelToString(
            self._handle, 0, -1, 0, n.value, ctypes.byref(n), buf))
        return buf.value.decode()
