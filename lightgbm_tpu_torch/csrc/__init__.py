"""Hand-written CUDA kernels and their loader.

Each ``<name>.cu`` here has a plain C interface. :func:`load` compiles it
at first use with ``nvcc`` for ``sm_90a`` into a shared library under
``lightgbm_tpu_torch/_build/`` (listed in ``.gitignore``) and opens it
with ``ctypes``. The library's file name carries a hash of every source
in this directory (``histogram_u16.cu`` includes ``histogram.cu``), so
an edited source builds anew and a stale library is never loaded.

Nothing is compiled or loaded when this module is imported: the CPU
tests import every module on a machine without ``nvcc``. Each build
counts under ``kernel_build/<name>`` with a ``kernel_build`` event
carrying its ``nvcc`` seconds, and each opening of a library under
``kernel_load/<name>`` (``obs/compile.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

from ..obs import compile as obs_compile
from ..utils.log import LightGBMError

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise LightGBMError("nvcc not found: the CUDA kernels of "
                        "lightgbm_tpu_torch are built at first use and need "
                        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> List[str]:
    """Names of the kernel sources (``<name>.cu``) in this directory."""
    return sorted(f[:-3] for f in os.listdir(_HERE) if f.endswith(".cu"))


def library_path(name: str) -> str:
    h = hashlib.sha1(name.encode() + " ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(_HERE)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_HERE, f), "rb") as fh:
                h.update(fh.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def build(names: Sequence[str],
          extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile each ``<name>.cu`` whose library does not exist yet, one
    ``nvcc`` per source, all started together; returns each built
    source's compiler output. A compile writes a temporary file and
    renames it, so an interrupted build never leaves a half-written
    library."""
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        [nvcc] + NVCC_FLAGS + list(extra_flags)
        + ["-o", library_path(n) + ".tmp", os.path.join(_HERE, n + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in todo}
    outputs, failed = {}, []
    for n, proc in procs.items():
        outputs[n], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s.cu:\n%s" % (n, outputs[n]))
        else:
            os.replace(library_path(n) + ".tmp", library_path(n))
            # the builds run together: each one's seconds run from the
            # common start to its own end
            obs_compile.record_kernel_build(n, time.perf_counter() - t0)
    if failed:
        raise LightGBMError("nvcc failed to build " + "\n".join(failed))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and open the kernel library ``name``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
            obs_compile.record_kernel_load(name)
        return lib
