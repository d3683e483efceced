"""ctypes binding of the port's native host I/O (``csrc/host_io.cpp``).

Copy of qmf_tpu/data/native.py: the same functions (``available``,
``read_dataset``, ``write_factors``) and errors (``IOError`` when the file
cannot be opened or grew while it was read, ``ValueError`` with the line
number on a parse error). The library is the port's own copy of
qmf_tpu/_native/qmf_native.cpp, built at first use with the host's ``g++``
(the flags of qmf_tpu/_native/Makefile) into ``qmf_tpu_torch/_build/``,
under the CUDA build's file lock and stamped with a hash of the source and
the flags, so an edited source is rebuilt and concurrent processes build
once. qmf_tpu's own ``libqmf_native.so`` is never loaded.

``data.dataset.read_dataset`` and ``data.factor_io.save_factors`` take this
path first and fall back to numpy and Python only where the library cannot
be built or loaded, logging the path taken and why. ``last_path`` records
which path the last read and the last write took.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "host_io.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_NAME = "libqmf_host_io.so"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

# Which path the last read and the last write took: "native", or the
# fallback's "numpy" / "python" for a read and "python" for a write.
last_path = {"read": None, "write": None}

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library is unavailable
_load_attempted = False


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile the library if it is missing or its stamp is stale; returns
    its path. Raises RuntimeError when there is no ``g++`` or it fails."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _source_hash()
    stamp = lib_path + ".sha256"
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if os.path.exists(lib_path) and os.path.exists(stamp):
            with open(stamp) as f:
                if f.read().strip() == digest:
                    return lib_path
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler: g++ is not on PATH")
        # a process that opens the library never sees a half-linked file
        tmp = f"{lib_path}.tmp{os.getpid()}"
        cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        with open(stamp, "w") as f:
            f.write(digest)
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _error = " ".join(str(e).split())[:1000] or repr(e)  # one line
        return None

    lib.qmf_count_lines.argtypes = [ctypes.c_char_p]
    lib.qmf_count_lines.restype = ctypes.c_longlong

    lib.qmf_read_dataset.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # user_ids out
        ctypes.POINTER(ctypes.c_longlong),  # item_ids out
        ctypes.POINTER(ctypes.c_double),  # values out
        ctypes.c_longlong,  # capacity
        ctypes.POINTER(ctypes.c_longlong),  # err_line out (parse errors)
    ]
    lib.qmf_read_dataset.restype = ctypes.c_longlong

    lib.qmf_write_factors.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_longlong),  # ids
        ctypes.POINTER(ctypes.c_double),  # factors (row-major)
        ctypes.POINTER(ctypes.c_double),  # biases (nullable)
        ctypes.c_longlong,  # nelems
        ctypes.c_longlong,  # nfactors
    ]
    lib.qmf_write_factors.restype = ctypes.c_int

    _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and loaded (built at the first call
    of this process)."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`available` is False (the build's or the loader's error),
    or None."""
    _load()
    return _error


def read_dataset(path: str):
    from qmf_tpu_torch.data.dataset import Dataset

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host I/O unavailable: {_error}")
    path_b = path.encode()
    n = lib.qmf_count_lines(path_b)
    if n < 0:
        raise IOError(f"native reader failed to open {path}")
    users = np.empty(n, dtype=np.int64)
    items = np.empty(n, dtype=np.int64)
    values = np.empty(n, dtype=np.float64)
    err_line = ctypes.c_longlong(0)
    got = lib.qmf_read_dataset(
        path_b,
        users.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        items.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        ctypes.byref(err_line),
    )
    if got == -1:  # QMF_ERR_OPEN
        raise IOError(f"native reader failed to open {path}")
    if got == -2:  # QMF_ERR_CAPACITY: file grew between count and read
        raise IOError(
            f"{path} changed while being read (more lines than counted)"
        )
    if got == -3:  # QMF_ERR_PARSE
        raise ValueError(
            f"the file format is incorrect: {path} (line {err_line.value})"
        )
    if got < 0:
        raise IOError(f"native reader failed for {path} (code {got})")
    return Dataset(users[:got], items[:got], values[:got])


def write_factors(
    path: str,
    ids: np.ndarray,
    factors: np.ndarray,
    biases: Optional[np.ndarray],
) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native host I/O unavailable: {_error}")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    factors = np.ascontiguousarray(factors, dtype=np.float64)
    if factors.ndim != 2 or len(ids) != factors.shape[0]:
        raise ValueError(f"{len(ids)} ids for factors of shape "
                         f"{factors.shape}")
    if biases is not None:
        biases = np.ascontiguousarray(biases, dtype=np.float64)
        if biases.shape != (factors.shape[0],):
            raise ValueError(f"biases of shape {biases.shape} for "
                             f"{factors.shape[0]} rows")
    rc = lib.qmf_write_factors(
        path.encode(),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        factors.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        None if biases is None
        else biases.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        factors.shape[0],
        factors.shape[1],
    )
    if rc != 0:
        raise IOError(f"native factor writer failed for {path}")
