"""ctypes loader of the native text-matrix reader and writer (fastio.cpp,
a copy of gp_tpu's).

Nothing is built at import.  The first call builds the library with g++
into gp_tpu_torch/_build/ (git-ignored), named by a hash of the source and
the flags, and loads it.  Without g++, or when the build fails, the
functions return None / False and the callers (utils/io.py) take NumPy's
reader and writer, which give the same values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._build import BUILD_DIR

_SRC = Path(__file__).resolve().with_name("fastio.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++11")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libgpfastio-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError):
        return False
    os.replace(tmp, out)
    return True


def _load():
    """The loaded library, built first if missing; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = library_path()
        if not out.exists() and not _build(out):
            return None
        lib = ctypes.CDLL(str(out))
        lib.gp_read_matrix.restype = ctypes.POINTER(ctypes.c_double)
        lib.gp_read_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long)]
        lib.gp_free.restype = None
        lib.gp_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.gp_write_matrix.restype = ctypes.c_int
        lib.gp_write_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_long, ctypes.c_int]
        _lib = lib
        return _lib


def read_matrix(path: str):
    """Parse a text matrix natively: an ndarray, or None when the library
    is unavailable or the file does not parse (unreadable, ragged,
    empty)."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = ctypes.c_long(0), ctypes.c_long(0)
    ptr = lib.gp_read_matrix(os.fsencode(path), ctypes.byref(rows),
                             ctypes.byref(cols))
    if not ptr:
        return None
    try:
        n = rows.value * cols.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        return arr.reshape(rows.value, cols.value)
    finally:
        lib.gp_free(ptr)


def write_matrix(path: str, m, digits: int = 17) -> bool:
    """Write a text matrix natively; False when the library is unavailable
    or the write failed."""
    lib = _load()
    if lib is None:
        return False
    m = np.ascontiguousarray(m, dtype=np.float64)
    if m.ndim == 1:
        m = m[:, None]
    ptr = m.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    return lib.gp_write_matrix(os.fsencode(path), ptr, m.shape[0],
                               m.shape[1], digits) == 0
