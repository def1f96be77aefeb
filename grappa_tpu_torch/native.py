"""ctypes bindings for the native (C++) graph-preprocessing library.

Counterpart of `grappa_tpu.native`. The source is the repo's
`native/graph_preproc.cpp`; this package builds its own copy with g++ at
first use into `grappa_tpu_torch/build/` (named by a hash of the source, so
an edited source rebuilds), and never loads or writes the library under
`native/`. Every entry point has a pure-Python fallback: the native path
speeds up protein-sized molecules on the host and is not a dependency. Set
GRAPPA_TPU_NO_NATIVE=1 to force the Python implementations.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / 'native' / 'graph_preproc.cpp'
_BUILD_DIR = Path(__file__).resolve().parent / 'build'
_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Optional[Path]:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes() + ' '.join(_FLAGS).encode())
    return _BUILD_DIR / f'libgraph_preproc_{digest.hexdigest()[:16]}.so'


def _build(target: Path) -> bool:
    """g++ into a temporary file, then an atomic rename: processes that
    build at the same time never load a half-written library."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(['g++', *_FLAGS, str(_SRC), '-o', tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get('GRAPPA_TPU_NO_NATIVE') == '1':
        return None
    path = _lib_path()
    if path is None or (not path.exists() and not _build(path)):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.enumerate_tuples.argtypes = [i32p, ctypes.c_int64, i64p, i64p,
                                     i32p, i32p]
    lib.enumerate_tuples.restype = None
    lib.neighbor_list.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, i32p, u8p]
    lib.neighbor_list.restype = ctypes.c_int32
    lib.ring_encoding.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, f32p]
    lib.ring_encoding.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _as_i32(arr, n_atoms: Optional[int] = None) -> np.ndarray:
    bonds = np.ascontiguousarray(
        np.asarray(arr, dtype=np.int32)).reshape(-1, 2)
    # the C++ side indexes without bounds checks: malformed input raises
    # here (as the Python path's IndexError) instead of corrupting the heap
    if bonds.size:
        if bonds.min() < 0:
            raise IndexError(f"negative bond index: {bonds.min()}")
        if n_atoms is not None and bonds.max() >= n_atoms:
            raise IndexError(
                f"bond index {bonds.max()} >= n_atoms ({n_atoms})")
    return bonds


def enumerate_tuples(bonds) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(angles (A,3), propers (P,4)) as int32 index arrays, or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bonds = _as_i32(bonds)
    n_bonds = ctypes.c_int64(len(bonds))
    na, np_ = ctypes.c_int64(0), ctypes.c_int64(0)
    null = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
    lib.enumerate_tuples(_ptr(bonds, ctypes.c_int32), n_bonds,
                         ctypes.byref(na), ctypes.byref(np_), null, null)
    angles = np.zeros((na.value, 3), np.int32)
    propers = np.zeros((np_.value, 4), np.int32)
    lib.enumerate_tuples(_ptr(bonds, ctypes.c_int32), n_bonds,
                         ctypes.byref(na), ctypes.byref(np_),
                         _ptr(angles, ctypes.c_int32),
                         _ptr(propers, ctypes.c_int32))
    return angles, propers


def neighbor_list(bonds, n_atoms: int, max_neighbors: int
                  ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = get_lib()
    if lib is None:
        return None
    bonds = _as_i32(bonds, n_atoms)
    neighbors = np.zeros((n_atoms, max_neighbors), np.int32)
    mask = np.zeros((n_atoms, max_neighbors), np.uint8)
    rc = lib.neighbor_list(_ptr(bonds, ctypes.c_int32),
                           ctypes.c_int64(len(bonds)),
                           ctypes.c_int64(n_atoms),
                           ctypes.c_int64(max_neighbors),
                           _ptr(neighbors, ctypes.c_int32),
                           _ptr(mask, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(
            f"atom degree exceeds MAX_NEIGHBORS={max_neighbors}")
    return neighbors, mask.astype(bool)


def ring_encoding(bonds, n_atoms: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    bonds = _as_i32(bonds, n_atoms)
    out = np.zeros((n_atoms, 7), np.float32)
    lib.ring_encoding(_ptr(bonds, ctypes.c_int32), ctypes.c_int64(len(bonds)),
                      ctypes.c_int64(n_atoms), _ptr(out, ctypes.c_float))
    return out
