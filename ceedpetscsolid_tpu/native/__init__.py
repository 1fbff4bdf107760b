"""ctypes bindings for the native C++ components (csrc/).

The shared library is compiled from csrc/amg.cpp with g++ on first use into
<repo>/.build/, named by a hash of the source, so a changed source always
gets a fresh build and a fresh checkout never trusts a stale binary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "csrc" / "amg.cpp"
_BUILD = _ROOT / ".build"


def _ensure_built() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD / f"libamg-{digest}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            f"g++ not found: it is needed to build {lib.name} from {_SRC}")
    _BUILD.mkdir(exist_ok=True)
    # build under a private name, then rename: concurrent first uses (test
    # workers) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.check_call([cxx, "-O3", "-shared", "-fPIC", "-std=c++17",
                               "-o", tmp, str(_SRC)])
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(_ensure_built()))
        L.amg_setup.restype = ctypes.c_void_p
        L.amg_setup.argtypes = [
            ctypes.c_int, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64),
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ]
        L.amg_refresh.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)
        ]
        L.amg_num_levels.restype = ctypes.c_int
        L.amg_num_levels.argtypes = [ctypes.c_void_p]
        L.amg_level_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_int, np.ctypeslib.ndpointer(np.int64)
        ]
        L.amg_get_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.float64),
        ]
        L.amg_get_prolongator.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.float64),
        ]
        L.amg_coarse_dense.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.float64)
        ]
        L.amg_free.argtypes = [ctypes.c_void_p]
        _lib = L
    return _lib
