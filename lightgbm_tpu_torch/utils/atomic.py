"""Crash-consistent file writes: tmp + fsync + rename.

Port of ``lightgbm_tpu/utils/atomic.py``: a file written through
:func:`atomic_write` is either its previous content or the complete new
one after a crash at any point (a same-directory temporary name, fsync,
``os.replace`` over the final name). The model text
(``Booster.save_model``) and the C++ export
(``GBDT.save_model_to_cpp``) are written this way.
:func:`sha256_file` is the content hash of the checkpoint manifests
(``ft/checkpoint.py``).
"""
from __future__ import annotations

import hashlib
import os
from typing import Union


def sha256_file(path: str) -> str:
    """Streamed sha256 of a file: an artifact that does not hash to its
    manifest entry is rejected by name instead of trained on."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def fsync_dir(dirpath: str) -> None:
    """Flush a directory entry (the rename itself) to disk;
    best-effort — not every filesystem supports fsync on a dir fd."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, data: Union[str, bytes]) -> None:
    """Write ``data`` so ``path`` is either its previous content or the
    complete new content — never a truncated mix. The temp file lives in
    the target's directory (rename is only atomic within a filesystem)
    and is removed on any failure. The file and, best-effort, the
    directory entry are fsynced so the rename survives power loss, not
    just process death."""
    path = str(path)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    mode = "wb" if isinstance(data, bytes) else "w"
    try:
        with open(tmp, mode) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(os.path.abspath(path)))
