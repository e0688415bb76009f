"""ctypes bindings for the native batch-assembly kernels (gather.cc).

Compiled on first use with g++ into ``build/libmimo_gather-<hash>.so``,
keyed on a hash of gather.cc so that only a build of this very source is
ever loaded; falls back to pure numpy silently if no toolchain is
available.  See gather.cc for why
this exists: the host batch-slicing memcpy is the input pipeline's hot path
and numpy does it single-threaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "gather.cc")


def _lib_path() -> str:
    # build/ is not a package: keeps pkgutil/import machinery from mistaking
    # the plain-C library for a CPython extension module
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "build", f"libmimo_gather-{digest}.so")


_lock = threading.Lock()
_lib = None
_tried = False

DEFAULT_THREADS = min(os.cpu_count() or 1, 16)


def _build(path: str) -> Optional[str]:
    """Compile gather.cc to ``path`` (via a temporary name, so a
    concurrent loader never sees a half-written library)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-o", tmp, _SRC,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path):
            path = _build(path)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.mimo_gather_rows.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.mimo_gather_patches.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _char_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def gather_rows(
    src: np.ndarray, idx: np.ndarray, num_threads: int = DEFAULT_THREADS
) -> Optional[np.ndarray]:
    """dst[i] = src[idx[i]] with a thread pool.  None -> caller falls back.

    Only worthwhile with real parallelism: on a single-core host numpy's
    fancy indexing is at parity or better, so we decline and let the caller
    fall back (None).
    """
    lib = get_lib()
    if lib is None or not src.flags.c_contiguous or num_threads <= 1:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    n = idx.shape[0]
    row_bytes = int(src.dtype.itemsize * np.prod(src.shape[1:], dtype=np.int64))
    dst = np.empty((n,) + src.shape[1:], dtype=src.dtype)
    lib.mimo_gather_rows(
        _char_ptr(src), _i64_ptr(idx), _char_ptr(dst),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes), ctypes.c_int(num_threads),
    )
    return dst


def gather_patches(
    tiles: np.ndarray,
    tile_idx: np.ndarray,
    ys: np.ndarray,
    xs: np.ndarray,
    ph: int,
    pw: int,
    num_threads: int = DEFAULT_THREADS,
) -> Optional[np.ndarray]:
    """dst[i] = tiles[tile_idx[i], ys[i]:ys[i]+ph, xs[i]:xs[i]+pw, :]."""
    lib = get_lib()
    if lib is None or not tiles.flags.c_contiguous or tiles.ndim != 4:
        return None
    t, th, tw, c = tiles.shape
    tile_idx = np.ascontiguousarray(tile_idx, dtype=np.int64)
    ys = np.ascontiguousarray(ys, dtype=np.int64)
    xs = np.ascontiguousarray(xs, dtype=np.int64)
    n = tile_idx.shape[0]
    dst = np.empty((n, ph, pw, c), dtype=tiles.dtype)
    lib.mimo_gather_patches(
        _char_ptr(tiles), ctypes.c_int64(th), ctypes.c_int64(tw),
        ctypes.c_int64(c), ctypes.c_int64(tiles.dtype.itemsize),
        _i64_ptr(tile_idx), _i64_ptr(ys), _i64_ptr(xs), ctypes.c_int64(n),
        ctypes.c_int64(ph), ctypes.c_int64(pw), _char_ptr(dst),
        ctypes.c_int(num_threads),
    )
    return dst
