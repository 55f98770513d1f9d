"""ctypes binding for the native asynchronous snapshot writer (port of
``niwqg_tpu/io_native.py``).

``native/async_writer.cpp`` is compiled by ``g++`` at first use into
``_build/libasyncwriter-<hash>.so``, where the hash covers the source and
the flags (an edited source never loads a stale library), and loaded with
``ctypes``. :class:`AsyncSnapshotWriter` takes numpy arrays from the step
loop and writes them as ``.npy`` files on background threads; the C++
side copies each buffer, so the caller's array may change at once.
Without a compiler :func:`available` is False and the writer raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import io as _io
import os
import shutil
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(PKG_DIR, "native", "async_writer.cpp")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libasyncwriter-{digest.hexdigest()[:16]}.so")


def _build():
    """The library's path, compiled if missing; None without ``g++`` or
    when the compile fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"  # concurrent builders each rename
    try:
        subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return None
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.aw_create.restype = ctypes.c_void_p
        lib.aw_create.argtypes = [ctypes.c_int]
        lib.aw_submit.restype = ctypes.c_int
        lib.aw_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_void_p, ctypes.c_uint64]
        lib.aw_pending.restype = ctypes.c_int
        lib.aw_pending.argtypes = [ctypes.c_void_p]
        lib.aw_errors.restype = ctypes.c_long
        lib.aw_errors.argtypes = [ctypes.c_void_p]
        lib.aw_drain.restype = None
        lib.aw_drain.argtypes = [ctypes.c_void_p]
        lib.aw_destroy.restype = None
        lib.aw_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class AsyncSnapshotWriter:
    """Background-thread file sink (a C++ worker pool)."""

    def __init__(self, n_threads: int = 2):
        lib = _load()
        if lib is None:
            raise RuntimeError("native async writer unavailable (no g++?)")
        self._lib = lib
        self._h = lib.aw_create(n_threads)

    def submit_npy(self, path: str, array: np.ndarray) -> int:
        """Serialise ``array`` to .npy bytes and queue the write; returns
        the queue's depth."""
        buf = _io.BytesIO()
        np.save(buf, np.ascontiguousarray(array))
        data = buf.getbuffer()
        return self._lib.aw_submit(
            self._h, path.encode(),
            (ctypes.c_char * len(data)).from_buffer(data), len(data))

    def pending(self) -> int:
        return self._lib.aw_pending(self._h)

    def errors(self) -> int:
        """Failed writes so far (cumulative)."""
        return self._lib.aw_errors(self._h)

    def drain(self):
        """Block until every queued write has finished."""
        self._lib.aw_drain(self._h)

    def close(self):
        if self._h:
            self._lib.aw_drain(self._h)
            self._lib.aw_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
