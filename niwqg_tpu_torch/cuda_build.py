"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``, then loaded
with ``ctypes``. The file name carries a hash of the source and the flags,
so an edited source never loads a stale library. Nothing is built when a
module is imported: the first launch builds, or a caller builds every
source with :func:`build_all`.

``nvcc`` is looked up as ``$NVCC``, then on ``PATH``, then under
``$CUDA_HOME`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def sources() -> list:
    """Names of every CUDA source of the port (``csrc/*.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=None) -> dict:
    """Compile every missing library; return ``{name: path}``.

    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, n + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        with open(path + ".log", "w") as fh:
            fh.write(proc.stdout)
        os.replace(tmp, path)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name])
        _loaded[name] = lib
    return lib
