"""ctypes binding of the port's C++ HNSW (``src/hnsw_native.cpp``; port of
``grafp_tpu.native.hnsw_native``).

The source is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first
use into ``grafp_tpu_torch/_build/libhnsw_native-<hash>.so``, the hash
covering the source and the command, so an edited source is rebuilt and a
stale library is never loaded; nothing is built at import time and nothing
is written outside ``_build/``. A failed build raises
:class:`NativeUnavailable`: ``retrieval/hnsw.py`` does not fall back to
its Python backend unless that is asked for by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "src" / "hnsw_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


class NativeUnavailable(RuntimeError):
    """The C++ HNSW could not be built, loaded or run."""


def _lib_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libhnsw_native-{tag.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        log = getattr(e, "stderr", "") or ""
        raise NativeUnavailable(f"hnsw native build failed ({' '.join(cmd)}): {e}\n{log}") from e
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The compiled library, built first when missing."""
    out = _lib_path()
    with _lock:
        if out in _libs:
            return _libs[out]
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        fp = ctypes.POINTER(ctypes.c_float)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.hnsw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
        lib.hnsw_create.restype = ctypes.c_void_p
        lib.hnsw_destroy.argtypes = [ctypes.c_void_p]
        lib.hnsw_ntotal.argtypes = [ctypes.c_void_p]
        lib.hnsw_ntotal.restype = ctypes.c_long
        lib.hnsw_add.argtypes = [ctypes.c_void_p, fp, ctypes.c_long]
        lib.hnsw_add.restype = ctypes.c_int
        lib.hnsw_search.argtypes = [ctypes.c_void_p, fp, ctypes.c_long, ctypes.c_int,
                                    ctypes.c_int, fp, lp]
        lib.hnsw_search.restype = ctypes.c_int
        lib.hnsw_reconstruct.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, fp]
        lib.hnsw_reconstruct.restype = ctypes.c_int
        _libs[out] = lib
        return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class HNSWNative:
    """One C++ index; freed with the object."""

    def __init__(self, d: int, m: int = 16, ef_construction: int = 80, seed: int = 0):
        self._lib = load()
        self.d = int(d)
        self._h = self._lib.hnsw_create(self.d, int(m), int(ef_construction),
                                        ctypes.c_uint(seed))
        if not self._h:
            raise NativeUnavailable("hnsw_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.hnsw_destroy(h)
            self._h = None

    @property
    def ntotal(self) -> int:
        return int(self._lib.hnsw_ntotal(self._h))

    def add(self, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data, np.float32)
        if data.ndim != 2 or data.shape[1] != self.d:
            raise ValueError(f"rows of shape {data.shape}, the index has d={self.d}")
        if self._lib.hnsw_add(self._h, _ptr(data, ctypes.c_float), len(data)) != 0:
            raise NativeUnavailable("hnsw_add failed")

    def search(self, q: np.ndarray, k: int, ef_search: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries of shape {q.shape}, the index has d={self.d}")
        out_d = np.empty((len(q), k), np.float32)
        out_i = np.empty((len(q), k), np.int64)
        rc = self._lib.hnsw_search(self._h, _ptr(q, ctypes.c_float), len(q), int(k),
                                   int(ef_search), _ptr(out_d, ctypes.c_float),
                                   _ptr(out_i, ctypes.c_long))
        if rc != 0:
            raise NativeUnavailable("hnsw_search failed")
        return out_d, out_i

    def reconstruct_n(self, start: int, n: int) -> np.ndarray:
        out = np.empty((n, self.d), np.float32)
        if self._lib.hnsw_reconstruct(self._h, int(start), int(n),
                                      _ptr(out, ctypes.c_float)) != 0:
            raise NativeUnavailable("hnsw_reconstruct failed")
        return out
