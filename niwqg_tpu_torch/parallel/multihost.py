"""Process bootstrap for a distributed run (port of
``niwqg_tpu/parallel/multihost.py``).

A distributed run is: :func:`initialize` in every process, ONE mesh over
all ranks (:func:`global_mesh`), the model built with ``mesh=``, and the
initial condition handed to ``set_q``/``set_phi``/``set_c`` either as the
global array on every rank (each keeps its block) or, so that no rank ever
holds the whole field, as :func:`make_global_field` of this process's row
block (:func:`host_local_rows`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.profiling import span
from .mesh import RowBlock, make_mesh

# set once this module has brought the process group up (the JAX version
# recognises a repeated call by the text of the exception it raises)
_initialized = False


@span("mesh.init")
def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: Optional[float] = None) -> None:
    """``dist.init_process_group`` with environment fallbacks; a no-op when
    already initialised or single-process.

    ``coordinator_address`` is ``host:port``; missing arguments fall back
    to ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. A bare
    call with none of them set stays single-process, silently: that is the
    ordinary one-process run. With any explicit argument a failure to
    bring the group up is raised, since a silently local "distributed" run
    would compute one wrong answer per process.

    The backend is NCCL where every rank has a card of its own and gloo
    otherwise (``device="cpu"``, or more ranks than cards: NCCL refuses
    two ranks on one card). ``timeout_s`` bounds every collective (the
    library's default is half an hour)."""
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [n for n, v in (("coordinator_address", coordinator_address),
                              ("num_processes", num_processes),
                              ("process_id", process_id)) if v is None]
    if missing:
        if explicit:
            raise ValueError(
                "initialize: no value for " + ", ".join(missing)
                + " (pass it, or set MASTER_ADDR/MASTER_PORT, WORLD_SIZE, "
                "RANK)")
        return  # bare single-process call
    on_host = device is not None and torch.device(device).type == "cpu"
    own_card = (not on_host and torch.cuda.is_available()
                and num_processes <= torch.cuda.device_count())
    backend = "nccl" if own_card else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    _initialized = True


def shutdown() -> None:
    """Tear the process group down (the end of a worker process), after
    dropping every model's captured step graphs (``graphs.release_all``):
    on NCCL they launch the communicator's kernels."""
    global _initialized
    if dist.is_initialized():
        from ..graphs import release_all

        release_all()
        dist.destroy_process_group()
    _initialized = False


@span("mesh.init")
def global_mesh(device=None):
    """1-D mesh over every rank of the job."""
    return make_mesh(device=device)


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_local_rows(nx: int) -> slice:
    """The row range of the global ``(ny, nx)`` grid owned by this process
    under the row-sharded physical layout.

    ``nx`` must be divisible by the process count: the pencil layout has
    no ragged-row mode. Fail loudly rather than drop trailing rows."""
    n_proc, rank = _world()
    if nx % n_proc:
        raise ValueError(
            f"nx={nx} is not divisible by the process count {n_proc}; "
            "the row-sharded host layout would drop trailing rows. Pick "
            "nx as a multiple of the process count.")
    rows = nx // n_proc
    return slice(rank * rows, (rank + 1) * rows)


def make_global_field(mesh, field_local, nx: int) -> RowBlock:
    """The global ``(nx, nx)`` field whose row block
    :func:`host_local_rows` this process passes as ``field_local``: what
    ``set_q``, ``set_phi`` and ``set_c`` take in place of the global array.
    Nothing is gathered; each rank keeps its block. ``mesh`` is the
    model's mesh (``None`` or a one-rank mesh for a one-process run)."""
    n_proc, _ = _world()
    if mesh is not None and mesh.nP != n_proc:
        raise ValueError(f"the mesh has {mesh.nP} ranks, the job "
                         f"{n_proc} processes")
    if nx % n_proc:
        raise ValueError(
            f"nx={nx} is not divisible by the process count {n_proc} "
            "(see host_local_rows)")
    expect_rows = nx // n_proc
    shape = getattr(field_local, "shape", ())
    if len(shape) != 2 or shape[0] != expect_rows:
        raise ValueError(
            f"host-local block has {shape[0] if shape else 0} rows, "
            f"expected {expect_rows} (= nx/process_count)")
    if shape[1] != nx:
        raise ValueError(f"host-local block has {shape[1]} columns, "
                         f"expected nx={nx}")
    return RowBlock(field_local, host_local_rows(nx), nx)
