"""ctypes bindings for the native PLY codec (native/splatply.cpp).

The hot part of scene loading — de-interleaving a multi-hundred-MB vertex blob
into column arrays (and the inverse on export) — runs in multi-threaded C++,
mirroring how the reference keeps its PLY layer native (ref: src/ply.cpp).
The library is built from source at first use (``native/build.sh`` does the
same by hand) into ``native/build/``, which git ignores. Falls back to numpy
transparently when it cannot be built.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "splatply.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libsplatply.so")

_TYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.uint8): 2,
    np.dtype(np.int32): 3,
}


class _Column(ctypes.Structure):
    _fields_ = [("src_offset", ctypes.c_int32), ("type", ctypes.c_int32)]


def _build() -> bool:
    """Compile native/splatply.cpp -> _LIB_PATH (atomic: concurrent
    processes may race to build; each writes its own temp file)."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
             "-o", tmp, _SRC_PATH],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    stale = (os.path.exists(_SRC_PATH) and (
        not os.path.exists(_LIB_PATH)
        or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH)))
    if stale and not _build():
        return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.splatply_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(_Column), ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.splatply_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(_Column), ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.splatply_version.restype = ctypes.c_int32
        assert lib.splatply_version() == 1
        return lib
    except OSError:
        return None


_LIB = _load()


def available() -> bool:
    return _LIB is not None


def _columns_meta(vertices: np.ndarray, names):
    fields = vertices.dtype.fields
    cols = (_Column * len(names))()
    for i, name in enumerate(names):
        dt, offset = fields[name][0], fields[name][1]
        base = dt.newbyteorder("=")
        if base not in _TYPE_CODES or dt.byteorder == ">":
            return None  # unsupported layout -> numpy fallback
        cols[i].src_offset = offset
        cols[i].type = _TYPE_CODES[base]
    return cols


def decode_columns(vertices: np.ndarray, names) -> np.ndarray:
    """Structured array -> [N, len(names)] float32 (native if possible)."""
    if _LIB is not None and vertices.flags["C_CONTIGUOUS"]:
        cols = _columns_meta(vertices, names)
        if cols is not None:
            n = vertices.shape[0]
            out = np.empty((n, len(names)), np.float32)
            _LIB.splatply_decode(
                vertices.ctypes.data, n, vertices.dtype.itemsize,
                cols, len(names), out.ctypes.data,
            )
            return out
    return np.stack([vertices[nm].astype(np.float32) for nm in names], axis=-1)


def encode_columns(values: np.ndarray, vertices: np.ndarray, names) -> None:
    """[N, len(names)] float32 -> the named fields of a structured array."""
    values = np.ascontiguousarray(values, np.float32)
    if _LIB is not None and vertices.flags["C_CONTIGUOUS"]:
        cols = _columns_meta(vertices, names)
        if cols is not None:
            _LIB.splatply_encode(
                values.ctypes.data, vertices.shape[0], vertices.dtype.itemsize,
                cols, len(names), vertices.ctypes.data,
            )
            return
    for i, nm in enumerate(names):
        vertices[nm] = values[:, i].astype(vertices.dtype.fields[nm][0])
