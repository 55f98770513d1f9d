"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C interface and is compiled
by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so``, then loaded
with ``ctypes``. The file name carries a hash of the source and the flags,
so an edited source never loads a stale library. Nothing is built when a
module is imported: the first launch builds, or a caller builds every
source with :func:`build_all`.

``nvcc`` is looked up as ``$NVCC``, then on ``PATH``, then under
``$CUDA_HOME`` (default ``/usr/local/cuda``).

A module that launches the kernels of a source declares it once as a
:class:`Family`: the library, its C signatures, the names of its launch
counters and of its plain versions. The family binds the signatures,
keeps the counters on each card, launches on the current stream and
raises on a refused launch, counts the calls its plain versions serve on
the host, and makes the workspace of a kernel that sums over its blocks.
:func:`field` describes a tensor that a kernel reads in its own strides.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from .utils.profiling import count, span

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
# blocks of a summing kernel's workspace a card, per SM (such a kernel
# takes as many blocks as fit on the card at once, at most these)
BLOCKS_PER_SM = 16


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


def field(z) -> tuple:
    """(address, row stride, column stride) of a 2-D tensor, which a kernel
    reads in its own strides; zeros for None."""
    if z is None:
        return (0, 0, 0)
    if z.dim() != 2:
        raise ValueError(f"a kernel's field is 2-D, not {z.dim()}-D")
    return (z.data_ptr(),) + tuple(z.stride())


class Family:
    """The kernels of ``csrc/<name>.cu``, as their module declares them.

    ``signatures`` maps each C function the module calls to its argument
    types (each returns an ``int``, a CUDA error code for a launch); the
    source's ``error`` function turns a code into its message. ``keys``
    name the launch counters: int64 in device memory, one set a card, made
    by the card's first call (outside a capture: a tensor made there would
    live in the graph's pool). A kernel adds one to its counter as it runs
    (thread 0 of one block), so a launch replayed from a CUDA graph counts
    as one from the host does, and a capture, which runs nothing, counts
    none. ``plain`` name the plain versions, whose calls on host tensors
    are counted on the host."""

    def __init__(self, name, signatures, keys, plain, error=None):
        self.name = name
        self.signatures = signatures
        self.keys = tuple(keys)
        self.error = error or name + "_error_string"
        self._cards = {}                    # card index -> counters
        self._plain = dict.fromkeys(plain, 0)

    def library(self) -> ctypes.CDLL:
        """The loaded library, its signatures bound."""
        lib = load(self.name)
        err = getattr(lib, self.error)
        if err.argtypes is None:
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, ctypes.c_int
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        return lib

    def counters(self, device) -> torch.Tensor:
        """The card's launch counters, made at its first call."""
        c = self._cards.get(device.index)
        if c is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.name}: the launch counters of a "
                                   "card cannot be made inside a CUDA graph "
                                   "capture")
            c = self._cards[device.index] = torch.zeros(
                len(self.keys), dtype=torch.int64, device=device)
        return c

    def counter(self, device, key) -> int:
        """The address of counter ``key`` on the card, for the C side."""
        c = self.counters(device)
        return c.data_ptr() + c.element_size() * self.keys.index(key)

    def check(self, lib, err, what):
        """Raise with the library's message where ``err`` is not 0."""
        if err != 0:
            raise RuntimeError(f"{self.name}: {what} failed: "
                               + getattr(lib, self.error)(err).decode())

    def launch(self, fn, device, *args, key=None):
        """``fn(*args, counter, stream)`` on the card's current stream, a
        tensor among ``args`` passed as its address; counted by counter
        ``key`` (default: ``fn``); raises if the launch is refused."""
        lib = self.library()
        args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
        counter = self.counter(device, key or fn)
        with torch.cuda.device(device):
            err = getattr(lib, fn)(
                *args, counter, torch.cuda.current_stream(device).cuda_stream)
        self.check(lib, err, f"{fn} launch")

    def workspace(self, device, sums):
        """``(partials, arrivals, blocks)`` on ``device`` for a kernel of
        this family that sums over its blocks: room for ``blocks`` blocks'
        ``sums`` partial sums (float64) and the count of blocks done
        (int32, 0 between launches: the last block resets it). Made with
        the kernel object and the card's launch counters, outside any
        capture; its launches, one after another on a stream, share it."""
        self.counters(device)
        blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(
            device).multi_processor_count
        return (torch.zeros(blocks * sums, dtype=torch.float64,
                            device=device),
                torch.zeros(1, dtype=torch.int32, device=device), blocks)

    def plain_call(self, key):
        """One call served by plain version ``key`` on host tensors."""
        self._plain[key] += 1

    def plain_calls(self, key=None) -> int:
        """The calls plain version ``key`` served (all, by default)."""
        return (sum(self._plain.values()) if key is None
                else self._plain[key])

    def counts(self) -> dict:
        """Each counter's launches on every card (read after a synchronise
        of the card, so that every launch queued has run) and
        ``cpu_calls``, the calls of every plain version."""
        out = dict.fromkeys(self.keys, 0)
        for index, c in self._cards.items():
            torch.cuda.synchronize(index)
            for key, n in zip(self.keys, c.tolist()):
                out[key] += n
        out["cpu_calls"] = self.plain_calls()
        return out

    def reset(self):
        """Set every count of :meth:`counts` to 0."""
        for index, c in self._cards.items():
            torch.cuda.synchronize(index)
            c.zero_()
            torch.cuda.synchronize(index)
        self._plain = dict.fromkeys(self._plain, 0)
