"""HDF5 output and checkpoints (port of ``niwqg_tpu/io.py``).

Output keeps the JAX package's layout: ``setup.h5`` with the grid arrays,
one ``snapshots/{t:015.0f}.h5`` per snapshot with the requested fields
(or, with ``snapshot_format='npy-async'``, one
``snapshots/{t:015.0f}.{field}.npy`` per field, written on background
threads by :mod:`.io_native`), and ``diagnostics.h5`` with one dataset per
accumulated series.

Checkpoints keep the JAX package's file layout: a ``state/`` group whose
datasets carry ``attrs["kind"]`` (the ``Derived`` fields under
``state/d/``; a complex field of the state as a group of ``re`` and
``im`` arrays, one under ``d`` as stacked ``[re, im]`` of kind
``"cpair"``; an empty optional slot, ``Derived.p``, not written; ``t`` in
the model dtype and ``tc`` a 0-d int32), a ``diagnostics/`` group of the
stacked series, ``attrs["model"]``, ``attrs["nx"]`` and an optional
``extra/`` group.
They come in two layers:

- :func:`checkpoint_tree` and :func:`restore_tree` turn a model into a
  dict of numpy arrays (complex fields as complex arrays) and back, with
  no h5py: a checkpoint can be held in memory where h5py is absent;
- :func:`save_checkpoint` and :func:`load_checkpoint` write that dict to
  one HDF5 file and read it back.

Restoring goes through :func:`..convert.state_from_numpy`, which maps the
q-side spectra between the full and the ``q_half`` layouts and fills or
drops ``Derived.p`` as the loading kernel needs, so a JAX file loads into
either of the port's wave kernels. The JAX reader converts nothing: a
file the port writes loads into JAX only under a JAX kernel with the same
q-side layout (faithful with faithful, fast with fast and the same
``q_half``).

h5py is imported by the file functions only, so the package imports and
runs without it; ``save_to_disk=True`` then raises an ``ImportError``
(``setup.h5`` and ``diagnostics.h5`` are HDF5), while a :class:`Saver`
used for ``npy-async`` snapshots alone still works.

On a mesh every function here is collective: every rank gathers the
global fields and only rank 0 writes a file, and an error on rank 0
raises on every rank. Every rank reads a checkpoint file and keeps its
own shard.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .convert import state_from_numpy, state_to_numpy

logger = logging.getLogger(__name__)


def require_h5py():
    """The h5py module; an ImportError naming it where it is missing."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "h5py is not installed: save_to_disk=True and checkpoint files "
            "need it (checkpoint_tree/restore_tree hold a checkpoint in "
            "memory without it)") from exc
    return h5py


def _on_rank0(mesh, fn, what: str):
    """Run ``fn`` on rank 0 only; an error there raises on every rank."""
    err = None
    if mesh is None or mesh.rank == 0:
        try:
            fn()
        except Exception as exc:  # re-raised below, and flagged to the mesh
            err = exc
    if mesh is not None and mesh.nP > 1:
        flag = torch.tensor([0.0 if err is None else 1.0], device=mesh.device)
        if mesh.all_reduce(flag).item() and err is None:
            raise RuntimeError(f"{what} failed on rank 0")
    if err is not None:
        raise err


def _file_exist(fno: str, overwrite: bool = True):
    """Remove ``fno`` if it exists, or raise ``IOError`` when
    ``overwrite`` is False."""
    if os.path.exists(fno):
        if overwrite:
            os.remove(fno)
        else:
            raise IOError("File exists: {0}".format(fno))


class Saver:
    """A model's output: ``setup.h5``, snapshots and ``diagnostics.h5``
    under ``path``. On a mesh only rank 0 writes; every rank must take
    part in each call, since the fields are gathered. ``setup.h5`` and
    ``diagnostics.h5`` need h5py (:meth:`save_setup` raises without it);
    ``npy-async`` snapshots do not."""

    def __init__(self, path: str, save_to_disk: bool, overwrite: bool = True,
                 snapshot_format: str = "h5", mesh=None):
        if snapshot_format not in ("h5", "npy-async"):
            raise ValueError(f"snapshot_format must be 'h5' or 'npy-async', "
                             f"got {snapshot_format!r}")
        self.path = path
        self.save_to_disk = save_to_disk
        self.overwrite = overwrite
        self.snapshot_format = snapshot_format
        self.mesh = mesh
        self._writes = save_to_disk and (mesh is None or mesh.rank == 0)
        self._async_writer = None
        self._errors_raised = 0
        self._last_stem = None
        if self._writes:
            os.makedirs(os.path.join(path, "snapshots"), exist_ok=True)
            if snapshot_format == "npy-async":
                from .io_native import AsyncSnapshotWriter

                self._async_writer = AsyncSnapshotWriter(n_threads=2)

    def save_setup(self, model):
        if not self.save_to_disk:
            return
        require_h5py()  # on every rank: setup.h5 is HDF5 in either format

        def write():
            fno = os.path.join(self.path, "setup.h5")
            _file_exist(fno, overwrite=self.overwrite)
            g = model.grid
            with require_h5py().File(fno, "w") as h5file:
                h5file.create_dataset("grid/nx", data=g.nx, dtype=int)
                h5file.create_dataset("grid/x", data=g.x_np)
                h5file.create_dataset("grid/y", data=g.y_np)
                h5file.create_dataset("grid/wv", data=g.wv_np)
                h5file.create_dataset("grid/k", data=g.kk_np)
                h5file.create_dataset("grid/l", data=g.ll_np)

        _on_rank0(self.mesh, write, "writing setup.h5")

    def save_snapshot(self, model, fields: List[str]):
        """Write one snapshot named by the zero-padded time; the caller
        keeps the cadence."""
        if not self.save_to_disk:
            return
        t = float(model.t)
        values = {f: model.get_field(f) for f in fields}  # gathers: all ranks
        _on_rank0(self.mesh, lambda: self._write_snapshot(t, values),
                  "writing a snapshot")

    def _write_snapshot(self, t: float, values: Dict[str, object]):
        stem = "{:015.0f}".format(t)
        if stem == self._last_stem:
            # successive snapshots less than one time unit apart round to
            # the same stem and overwrite each other
            logger.warning(
                "snapshot stem %s repeats (dt < 1 time unit between "
                "snapshots?): overwriting the previous snapshot file", stem)
        self._last_stem = stem
        if self._async_writer is not None:
            for field, value in values.items():
                fno = os.path.join(self.path, "snapshots",
                                   f"{stem}.{field}.npy")
                self._async_writer.submit_npy(fno, np.asarray(value))
            return
        fno = os.path.join(self.path, "snapshots", stem + ".h5")
        _file_exist(fno)
        with require_h5py().File(fno, "w") as h5file:
            for field, value in values.items():
                h5file.create_dataset(field, data=value)

    def save_diagnostics(self, diagnostics: Dict[str, dict]):
        if not self.save_to_disk:
            return
        self.drain()  # finish queued snapshot writes, raise their errors

        def write():
            fno = os.path.join(self.path, "diagnostics.h5")
            _file_exist(fno, overwrite=self.overwrite)
            with require_h5py().File(fno, "w") as h5file:
                for key, entry in diagnostics.items():
                    h5file.create_dataset(key, data=entry["value"])

        _on_rank0(self.mesh, write, "writing diagnostics.h5")

    def drain(self, raise_errors: bool = True):
        """Wait for the queued snapshot writes. Failed writes not reported
        before raise ``IOError`` (each failure is reported once); on a
        mesh this is collective, and rank 0's failure raises on every
        rank. With ``raise_errors=False`` they are logged instead, on
        this rank alone, so that an exception already propagating is not
        masked."""
        if not self.save_to_disk:
            return
        if raise_errors:
            _on_rank0(self.mesh, self._drain, "writing the snapshots")
        else:
            self._drain(raise_errors=False)

    def _drain(self, raise_errors: bool = True):
        if self._async_writer is None:
            return
        self._async_writer.drain()
        n = self._async_writer.errors()
        new, self._errors_raised = n - self._errors_raised, n
        if not new:
            return
        msg = (f"{new} async snapshot write(s) failed (disk full / "
               f"unwritable path?): output under {self.path!r} is "
               f"incomplete")
        if raise_errors:
            raise IOError(msg)
        logger.error(msg)


# ----------------------------------------------------------------------
# checkpoints: the in-memory layer (no h5py)
# ----------------------------------------------------------------------
def checkpoint_tree(model, extra: Optional[Dict] = None) -> dict:
    """The model's full state, diagnostic series and identity as numpy:
    ``{"state": {...}, "diagnostics": {name: series}, "model": str,
    "nx": int}`` (and ``"extra"`` when given). ``state`` has the model
    state's field names (a wave state's ``Derived`` fields under ``"d"``,
    ``Derived.p`` left out when the state holds none), ``t`` in the model
    dtype and ``tc`` a 0-d int32. Collective on a mesh: every rank gets
    the global tree."""
    state = state_to_numpy(model.state, getattr(model, "_mesh", None))
    state["tc"] = np.asarray(state["tc"], dtype=np.int32)
    if "d" in state and state["d"]["p"] is None:
        del state["d"]["p"]
    tree = {"state": state,
            "diagnostics": {name: np.hstack([np.asarray(v) for v in series])
                            for name, series in model._diag_acc.series.items()
                            if series},
            "model": model.model, "nx": int(model.nx)}
    if extra:
        tree["extra"] = {k: np.asarray(v) for k, v in extra.items()}
    return tree


def restore_tree(model, tree: dict):
    """Load a :func:`checkpoint_tree` (or a file's tree) into ``model`` in
    place: the state, converted to the model kernel's layout and cut to
    this rank's shard, and each stored series of a diagnostic the model
    has."""
    model.state = state_from_numpy(model.kernel, tree["state"])
    for name, series in tree.get("diagnostics", {}).items():
        if name in model._diag_acc.series:
            model._diag_acc.series[name] = [np.asarray(series)]
    return model


# ----------------------------------------------------------------------
# checkpoints: the file layer
# ----------------------------------------------------------------------
def _write_state(grp, tree: dict, top: bool = True):
    """The state's datasets under ``grp``, each marked ``attrs["kind"]``.
    The JAX package writes its re/im pair type as a sub-tree where it is
    a field of the state itself and as one stacked dataset where it sits
    inside ``Derived``, so a complex field of the state becomes a group
    of ``re`` and ``im`` arrays and one under ``d`` a ``[re, im]``
    ``"cpair"``."""
    for name, value in tree.items():
        if isinstance(value, dict):
            _write_state(grp.create_group(name), value, top=False)
            continue
        if value is None:  # an empty optional slot is not written
            continue
        value = np.asarray(value)
        if np.iscomplexobj(value) and top:
            _write_state(grp.create_group(name),
                         {"re": value.real, "im": value.imag}, top=False)
            continue
        kind = "array"
        if np.iscomplexobj(value):
            value, kind = np.stack([value.real, value.imag]), "cpair"
        grp.create_dataset(name, data=value)
        grp[name].attrs["kind"] = kind


def _complex(re, im):
    """A complex array with exactly these parts."""
    z = np.empty(np.shape(re), dtype=np.result_type(re, np.complex64))
    z.real, z.imag = re, im
    return z


def _read_state(grp, h5py) -> dict:
    out = {}
    for name, node in grp.items():
        if isinstance(node, h5py.Group):
            sub = _read_state(node, h5py)
            out[name] = (_complex(sub["re"], sub["im"])
                         if sub.keys() == {"re", "im"} else sub)
        elif node.attrs.get("kind") == "cpair":
            data = node[()]
            out[name] = _complex(data[0], data[1])
        else:
            out[name] = node[()]
    return out


def save_checkpoint(path: str, model, extra: Optional[Dict] = None):
    """Write the model's full state and diagnostic series to one HDF5
    file (collective on a mesh; rank 0 writes)."""
    tree = checkpoint_tree(model, extra)
    mesh = getattr(model, "_mesh", None)
    _on_rank0(mesh, lambda: write_checkpoint(path, tree),
              f"writing the checkpoint {path!r}")


def write_checkpoint(path: str, tree: dict):
    """Write a :func:`checkpoint_tree` to ``path``."""
    h5py = require_h5py()
    with h5py.File(path, "w") as f:
        _write_state(f.create_group("state"), tree["state"])
        dgrp = f.create_group("diagnostics")
        for name, series in tree["diagnostics"].items():
            dgrp.create_dataset(name, data=series)
        f.attrs["model"] = tree["model"]
        f.attrs["nx"] = tree["nx"]
        if tree.get("extra"):
            egrp = f.create_group("extra")
            for k, v in tree["extra"].items():
                egrp.create_dataset(k, data=np.asarray(v))


def read_checkpoint(path: str) -> dict:
    """A checkpoint file (the port's or the JAX package's) as the tree of
    :func:`checkpoint_tree`."""
    h5py = require_h5py()
    with h5py.File(path, "r") as f:
        tree = {name: _read_state(f[name], h5py)
                for name in ("state", "diagnostics", "extra") if name in f}
        tree["model"] = f.attrs.get("model")
        tree["nx"] = f.attrs.get("nx")
    return tree


def load_checkpoint(path: str, model):
    """Restore the state and diagnostic series into ``model`` in place
    (on a mesh every rank reads the file and keeps its shard)."""
    return restore_tree(model, read_checkpoint(path))
