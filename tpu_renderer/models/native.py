"""ctypes bindings for the native (C++) asset loader.

The hot compute path is JAX/XLA; the host-side runtime around it —
here, asset parsing — is native C++ (native/obj_loader.cpp), compiled on
first use with the system toolchain and cached next to the package. Falls
back to the pure-Python parser transparently when no compiler is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["load_obj_native", "native_available"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "obj_loader.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libobjloader.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return _LIB_PATH
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", _LIB_PATH, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _LIB_PATH
    except (OSError, subprocess.SubprocessError):
        return None


def _get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.obj_load.restype = ctypes.c_void_p
        lib.obj_load.argtypes = [ctypes.c_char_p]
        for name in ("obj_n_vertices", "obj_n_uv", "obj_n_normals",
                     "obj_n_faces"):
            getattr(lib, name).restype = ctypes.c_int
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name, ctype in (("obj_vertices", ctypes.c_float),
                            ("obj_uv", ctypes.c_float),
                            ("obj_normals", ctypes.c_float),
                            ("obj_faces", ctypes.c_int)):
            getattr(lib, name).restype = ctypes.POINTER(ctype)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("obj_mtllib", "obj_groups"):
            getattr(lib, name).restype = ctypes.c_char_p
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.obj_free.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def load_obj_native(path):
    """Parse an OBJ with the C++ loader.

    Returns (vertices (N,4) f32, uv (T,3) f32 | None, normals (M,3) f32 | None,
    faces (F,3,4) i32, mtllib str | None, material_group list[str]) with the
    exact array layouts of the Python parser, or None when the native library
    is unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    handle = lib.obj_load(os.fspath(path).encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        def arr(fn, n, cols, dtype):
            if n == 0:
                return None
            ptr = fn(handle)
            return np.ctypeslib.as_array(
                ptr, shape=(n, cols)).astype(dtype, copy=True)

        vertices = arr(lib.obj_vertices, lib.obj_n_vertices(handle), 4,
                       np.float32)
        uv = arr(lib.obj_uv, lib.obj_n_uv(handle), 3, np.float32)
        normals = arr(lib.obj_normals, lib.obj_n_normals(handle), 3,
                      np.float32)
        n_faces = lib.obj_n_faces(handle)
        faces = (np.ctypeslib.as_array(lib.obj_faces(handle),
                                       shape=(n_faces, 3, 4))
                 .astype(np.int32, copy=True) if n_faces else
                 np.zeros((0, 3, 4), np.int32))
        mtllib = lib.obj_mtllib(handle).decode() or None
        groups = lib.obj_groups(handle).decode().split("\n")
        return vertices, uv, normals, faces, mtllib, groups
    finally:
        lib.obj_free(handle)
