"""Native (C++) host components, loaded with ctypes.

Port of ``lightgbm_tpu/native``. The reference keeps its data-loading
runtime in C++ (src/io/parser.cpp, src/io/dataset_loader.cpp); this
package holds the port's copies of the JAX package's native sources,
unchanged: ``parser.cpp`` (CSV/TSV/LibSVM parsing and ``GreedyFindBin``)
and ``capi.cpp`` / ``capi.h`` (the C inference ABI, ``native/capi.py``).

Each source compiles at first use with the system ``g++`` (plain C ABI,
no pybind11) into ``lightgbm_tpu_torch/_build/`` (listed in
``.gitignore``), never next to the source. The library's file name
carries a hash of its source and flags, so an edited source builds anew.
A build writes a temporary file and renames it, so two processes that
build at once never open a half-written library. A missing or failing
``g++`` raises :class:`LightGBMError`: there is no NumPy fallback for a
broken toolchain. A file the parser declines (a ragged row) is the one
case that returns None: the caller parses it with NumPy, as in the JAX
package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def source_path(src_name: str) -> str:
    return os.path.join(_HERE, src_name)


def library_path(src_name: str, so_name: str) -> str:
    """``_build/<so stem>-<hash of source and flags>.so``."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(source_path(src_name), "rb") as fh:
        h.update(fh.read())
    stem = so_name[:-3] if so_name.endswith(".so") else so_name
    return os.path.join(BUILD_DIR, "%s-%s.so" % (stem, h.hexdigest()[:12]))


def compile_and_load(src_name: str, so_name: str) -> ctypes.CDLL:
    """Compile ``src_name`` of this directory into ``_build/`` (once per
    source content) and open it. Raises :class:`LightGBMError` when
    ``g++`` is missing or the build fails."""
    so = library_path(src_name, so_name)
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            raise LightGBMError(
                "g++ not found: the native %s of lightgbm_tpu_torch is "
                "built at first use and needs a C++17 compiler on PATH"
                % src_name)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (so, os.getpid())
        proc = subprocess.run([gxx] + GXX_FLAGS
                              + ["-o", tmp, source_path(src_name)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise LightGBMError("g++ failed to build %s:\n%s"
                                % (src_name, proc.stdout))
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def load(src_name: str, so_name: str, bind) -> ctypes.CDLL:
    """The library of ``src_name``, built and opened once per process,
    with ``bind(lib)`` setting its signatures at the first opening."""
    with _LOCK:
        lib = _LIBS.get(src_name)
        if lib is None:
            lib = compile_and_load(src_name, so_name)
            bind(lib)
            _LIBS[src_name] = lib
        return lib


def _bind_parser(lib: ctypes.CDLL) -> None:
    lib.ParseDense.restype = ctypes.c_int
    lib.ParseDense.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long)]
    lib.ParseLibSVM.restype = ctypes.c_int
    lib.ParseLibSVM.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long)]
    lib.FreeBuffer.restype = None
    lib.FreeBuffer.argtypes = [ctypes.c_void_p]
    lib.GreedyFindBin.restype = ctypes.c_int
    lib.GreedyFindBin.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double)]


def parser_lib() -> ctypes.CDLL:
    return load("parser.cpp", "_parser.so", _bind_parser)


def parse_dense(path: str, delim: str, skip_rows: int
                ) -> Optional[np.ndarray]:
    """Parse a CSV/TSV file into a row-major float64 array, or None when
    the parser declines the file (a ragged row): the caller then parses
    it with NumPy, which names the bad line."""
    lib = parser_lib()
    out = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.ParseDense(path.encode(), delim.encode(), skip_rows,
                        ctypes.byref(out), ctypes.byref(rows),
                        ctypes.byref(cols))
    if rc != 0:
        if rc == 1:
            raise OSError("cannot read %s" % path)
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
        return arr.reshape(rows.value, cols.value)
    finally:
        lib.FreeBuffer(out)


def greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                    max_bin: int, total_cnt: int,
                    min_data_in_bin: int) -> np.ndarray:
    """Native GreedyFindBin (reference: src/io/bin.cpp:78): the bin
    upper bounds."""
    lib = parser_lib()
    dv = np.ascontiguousarray(distinct_values, dtype=np.float64)
    cn = np.ascontiguousarray(counts, dtype=np.float64)
    out = np.empty(max(max_bin, 1) + 1, dtype=np.float64)
    n = lib.GreedyFindBin(
        dv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cn.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(len(dv)), ctypes.c_int(int(max_bin)),
        ctypes.c_double(float(total_cnt)),
        ctypes.c_int(int(min_data_in_bin)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out[:n].copy()


def parse_libsvm(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a LibSVM file into (dense X, labels), or None when the
    parser declines the file."""
    lib = parser_lib()
    out = ctypes.POINTER(ctypes.c_double)()
    labels = ctypes.POINTER(ctypes.c_double)()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    rc = lib.ParseLibSVM(path.encode(), ctypes.byref(out),
                         ctypes.byref(labels), ctypes.byref(rows),
                         ctypes.byref(cols))
    if rc != 0:
        if rc == 1:
            raise OSError("cannot read %s" % path)
        return None
    try:
        n = rows.value * cols.value
        X = np.ctypeslib.as_array(out, shape=(n,)).copy() \
            .reshape(rows.value, cols.value)
        y = np.ctypeslib.as_array(labels, shape=(rows.value,)).copy()
        return X, y
    finally:
        lib.FreeBuffer(out)
        lib.FreeBuffer(labels)
