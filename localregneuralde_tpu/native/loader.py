"""ctypes bindings for the native prefetching batch loader.

The shared library is built on first use with g++ (plain C ABI +
ctypes) into ``build/<hash>/`` next to this file, where ``<hash>`` is the
SHA-256 of ``dataloader.cpp``: a library is reused only when it was built
from exactly this source, never because of a file's timestamp.
``NativeDataloader`` mirrors the Python ``harness.Dataloader``
iterator contract; callers can fall back transparently when no toolchain is
available (``native_available()``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dataloader.cpp")
_lib = None
_lock = threading.Lock()


def library_path(src: str = _SRC) -> str:
    """Where the library built from ``src`` lives: a build directory
    named after the source's SHA-256."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "build", digest, "libnativeloader.so")


def _build() -> Optional[str]:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # build under a per-process name, then rename: a concurrent builder
    # never loads a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [
                "g++", "-O3", "-fPIC", "-shared", "-std=c++17", _SRC,
                "-o", tmp, "-lpthread",
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.CalledProcessError) as e:
        warnings.warn(f"native loader build failed: {e}")
        return None


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_uint64,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int64,
        ]
        lib.dl_next.restype = ctypes.c_int64
        lib.dl_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.dl_batches_per_epoch.restype = ctypes.c_int64
        lib.dl_batches_per_epoch.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class NativeDataloader:
    """Drop-in (iterator-compatible) native replacement for
    ``harness.Dataloader``: shuffling, bounded-queue prefetch, cycle mode."""

    def __init__(
        self,
        arrays: Tuple[np.ndarray, ...],
        batch_size: int,
        *,
        shuffle: bool = False,
        cycle: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        drop_last: bool = True,
        skip_batches: int = 0,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        self.arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        self.batch_size = batch_size
        n = self.arrays[0].shape[0]
        self.n_batches = (
            n // batch_size if drop_last else -(-n // batch_size)
        )
        self._row_bytes = [
            a.nbytes // a.shape[0] for a in self.arrays
        ]
        ptrs = (ctypes.c_void_p * len(self.arrays))(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays]
        )
        rb = (ctypes.c_int64 * len(self.arrays))(*self._row_bytes)
        self._handle = lib.dl_create(
            len(self.arrays), ptrs, rb, n, batch_size, int(shuffle),
            seed, prefetch, int(drop_last), int(cycle), int(skip_batches),
        )
        self._dst = None

    def __len__(self):
        return self.n_batches

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        while True:
            out = tuple(
                np.empty((self.batch_size,) + a.shape[1:], a.dtype)
                for a in self.arrays
            )
            ptrs = (ctypes.c_void_p * len(out))(
                *[o.ctypes.data_as(ctypes.c_void_p).value for o in out]
            )
            rows = self._lib.dl_next(self._handle, ptrs)
            if rows < 0:
                return
            if rows < self.batch_size:
                out = tuple(o[:rows] for o in out)
            yield out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
