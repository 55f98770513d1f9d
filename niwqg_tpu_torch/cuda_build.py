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

from .utils.profiling import count, span

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


def _flags(defines=()) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines=()) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(_flags(defines)).encode())
    tag = "".join(f"-{d}" for d in defines)
    return os.path.join(BUILD_DIR,
                        f"lib{name}{tag}-{digest.hexdigest()[:16]}.so")


def build_all(names=None, defines=()) -> dict:
    """Compile every missing library; return ``{name: path}``.

    ``defines`` are preprocessor macros for every source of this call (a
    probe build, such as ``A2A_STAMPS``); the library's name carries them.
    The compiler's resource report (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n, defines) for n in names}
    procs = {}
    for n, path in paths.items():  # one nvcc per source, all started together
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc_path(), *_flags(defines), "-o", tmp,
             os.path.join(CSRC_DIR, n + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        with open(paths[n] + ".log", "w") as fh:
            fh.write(out)
        os.replace(tmp, paths[n])
        count("cuda_build.built")
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    key = (name, tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        with span("cuda_build.load"):
            lib = ctypes.CDLL(build_all([name], defines)[name])
        _loaded[key] = lib
    return lib
