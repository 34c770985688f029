"""ctypes bindings for the native C++ IO runtime (cpp/fastio.cpp) (the port's
own copy of ``ocean_model_arch_tpu/io/native.py``).

Compiled on demand with g++ into build/libfastio.so and cached; every
entry point has a pure-Python fallback (io/mask_io.py, io/grads.py), so
the framework runs with or without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "cpp", "fastio.cpp")
_SO = os.path.join(_REPO, "build", "libfastio.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
           "-std=c++17", _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def get_lib():
    """The loaded library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.fastio_read_mask.restype = ctypes.c_int
        lib.fastio_read_mask.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
        lib.fastio_pack_interior.restype = None
        lib.fastio_pack_interior.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float)]
        lib.fastio_write_record.restype = ctypes.c_int
        lib.fastio_write_record.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float]
        lib.fastio_read_record.restype = ctypes.c_int
        lib.fastio_read_record.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        _lib = lib
        return _lib


def read_mask(path: str, nx: int, ny: int):
    """Native mask parse; None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((nx, ny), np.int32)
    rc = lib.fastio_read_mask(
        path.encode(), nx, ny,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise IOError(f"fastio_read_mask({path}) failed rc={rc}")
    return out


def write_record(path: str, nrec: int, field, lu, undef: float):
    """Native interior pack + record write; False if unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    field = np.ascontiguousarray(field, np.float64)
    lu = np.ascontiguousarray(lu, np.float32)
    nx, ny = field.shape
    rec = np.empty((ny - 4) * (nx - 4), np.float32)
    lib.fastio_pack_interior(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lu.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, np.float32(undef),
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rc = lib.fastio_write_record(
        path.encode(), nrec,
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rec.size, np.float32(undef))
    if rc != 0:
        raise IOError(f"fastio_write_record({path}) failed rc={rc}")
    return True


def read_record(path: str, nrec: int, recl: int):
    """Native record read; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    rec = np.empty(recl, np.float32)
    rc = lib.fastio_read_record(
        path.encode(), nrec,
        rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), recl)
    if rc != 0:
        raise IOError(f"fastio_read_record({path}) failed rc={rc}")
    return rec
