"""One rank of the PyTorch port's distributed tests (gloo, CPU, f64).

Launched by ``tests/test_torch_pfft.py`` and ``tests/test_torch_sharded.py``
as ``NRANKS`` subprocesses. Every rank builds the same inputs from a numpy
seed, runs one suite of checks on the mesh, and rank 0 writes what it
gathered to ``<out>.npz`` for the parent to hold against JAX.

Usage: python _torch_sharded_worker.py <port> <rank> <nranks> <suite> <out.npz>
Suites: ``pfft`` (the pencil transform), ``model`` (the sharded
CoupledModel), ``misc`` (bootstrap, layouts, conversion).
"""

import os
import shutil
import sys
import warnings

port, rank, nranks, suite, out = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4], sys.argv[5])

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

from niwqg_tpu_torch.parallel import multihost

from _torch_sharded_common import (DIAGS, MODEL_CONFIGS, NX, coupled,  # noqa: E402
                                    pfft_inputs)


def suite_pfft(mesh):
    from niwqg_tpu_torch.parallel.pfft import PencilTransform

    z, z3, x, x3 = pfft_inputs()
    res = {}
    rows = lambda a: torch.as_tensor(np.ascontiguousarray(mesh.rows(a)))
    for name, kw in (("base", {}), ("chunks2", {"overlap_chunks": 2}),
                     ("chunks4", {"overlap_chunks": 4}),
                     ("k2", {"pallas_a2a": True, "overlap_chunks": 2})):
        tr = PencilTransform(NX, np.float64, mesh, **kw)
        zh = tr.fft2(rows(z))
        res[f"{name}_fft2"] = mesh.gather_cols(zh).numpy()
        res[f"{name}_ifft2"] = mesh.gather_rows(tr.ifft2(zh)).numpy()
        zh3 = tr.fft2(rows(z3))
        res[f"{name}_fft2_3"] = mesh.gather_cols(zh3).numpy()
        res[f"{name}_ifft2_3"] = mesh.gather_rows(tr.ifft2(zh3)).numpy()
        rh = tr.rfft2(rows(x))
        res[f"{name}_rfft2"] = mesh.gather_cols(rh).numpy()
        res[f"{name}_irfft2"] = mesh.gather_rows(tr.irfft2(rh)).numpy()
        rh3 = tr.rfft2(rows(x3))
        res[f"{name}_irfft2_3"] = mesh.gather_rows(tr.irfft2(rh3)).numpy()
        res[f"{name}_pad"] = tr.rfft_pad
        # Hermitian spectra of real fields, 3 (a pair and a single) and 2
        xh3 = tr.fft2_real(rows(x3))
        res[f"{name}_pairs3"] = mesh.gather_rows(
            tr.ifft2_real_pairs(xh3)).numpy()
        res[f"{name}_pairs2"] = mesh.gather_rows(
            tr.ifft2_real_pairs(xh3[:2])).numpy()
    res["clamp_5"] = PencilTransform(NX, np.float64, mesh,
                                     overlap_chunks=5).overlap_chunks
    return res


def suite_model(mesh):
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic

    res = {}
    for name, kw in MODEL_CONFIGS.items():
        m = coupled(CoupledModel, ic, mesh=mesh, device="cpu", **kw)
        # collectives: every rank takes part
        res[f"{name}_q"], res[f"{name}_phi"] = m.q, m.phi
        res[f"{name}_Ke"] = m.Ke
        res[f"{name}_qh"], res[f"{name}_phih"] = m.qh, m.phih
        for d in DIAGS:
            res[f"{name}_{d}"] = m.diagnostics[d]["value"]
        res[f"{name}_local_q_shape"] = tuple(m.state.d.q.shape)
        res[f"{name}_local_qh_shape"] = tuple(m.state.qh.shape)
    return res


def suite_misc(mesh):
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.convert import state_from_numpy, state_to_numpy
    from niwqg_tpu_torch.ops.spectral import _refl
    from niwqg_tpu_torch.parallel.mesh import reflect_spectrum

    res = {}
    # a repeated initialize is a no-op
    multihost.initialize(f"localhost:{port}", nranks, rank, device="cpu")
    multihost.initialize()
    res["world"] = torch.distributed.get_world_size()
    rows = multihost.host_local_rows(NX)
    res["rows"] = (rows.start, rows.stop)
    try:
        multihost.host_local_rows(NX + 2)
        res["indivisible_raises"] = False
    except ValueError:
        res["indivisible_raises"] = True

    # the reflection Z(-k,-l) across ranks against the one-rank flip
    z = pfft_inputs()[1]
    zt = torch.as_tensor(z)
    got = mesh.gather_cols(reflect_spectrum(
        mesh.cols(zt).contiguous(), mesh))
    res["reflect_equal"] = bool(torch.equal(got, _refl(zt)))

    # conversion round trip of a sharded state: out to global numpy, back
    # to shards, and on for two more steps beside the uninterrupted run
    for fast in (False, True):
        a = coupled(CoupledModel, ic, nsteps=3, mesh=mesh, device="cpu",
                    fast=fast)
        host = state_to_numpy(a.state, mesh)
        b = coupled(CoupledModel, ic, nsteps=0, mesh=mesh, device="cpu",
                    fast=fast)
        b.state = state_from_numpy(b.kernel, host)
        res[f"convert_global_shape_{fast}"] = host["qh"].shape
        res[f"convert_local_shape_{fast}"] = tuple(b.state.qh.shape)
        a.run_steps(2)
        b.run_steps(2)
        res[f"convert_dq_{fast}"] = float(np.abs(a.q - b.q).max())
        res[f"convert_dke_{fast}"] = abs(a.Ke - b.Ke)
        res[f"convert_tc_{fast}"] = b.tc
    res.update(checkpoints(mesh, os.path.dirname(out)))
    return res


def checkpoints(mesh, d):
    """Checkpoints of the sharded state: a resume bitwise against the
    uninterrupted mesh run, files moving between the one-rank layout
    (``q_half=False``) and the mesh, and the Saver's files on a mesh
    (rank 0 writes; every path is given per rank, so that a write by
    another rank would show)."""
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic

    res = {}
    fields = ("q", "phi", "Ke", "Pw", "Kw")
    for fast in (False, True):
        # 4 steps, checkpoint (a collective), 4 more; a fresh mesh model
        # loads the file and takes the same 4
        a = coupled(CoupledModel, ic, nsteps=4, mesh=mesh, device="cpu",
                    fast=fast)
        ck = os.path.join(d, f"mesh_{fast}.h5")
        a.save_checkpoint(ck)
        a.save_checkpoint(os.path.join(d, f"who_{fast}_{rank}.h5"))
        a.run_steps(4)
        b = coupled(CoupledModel, ic, nsteps=0, mesh=mesh, device="cpu",
                    fast=fast)
        b.load_checkpoint(ck)
        res[f"ckpt_tc_{fast}"] = b.tc
        b.run_steps(4)
        for k in fields:  # collectives: every rank
            res[f"ckpt_{k}_equal_{fast}"] = bool(np.array_equal(
                getattr(a, k), getattr(b, k)))
        res[f"ckpt_series_equal_{fast}"] = all(
            np.array_equal(a.diagnostics[k]["value"],
                           b.diagnostics[k]["value"]) for k in a.diagnostics)
        res[f"ckpt_series_len_{fast}"] = len(b.diagnostics["ke_qg"]["value"])
        res[f"ckpt_local_qh_shape_{fast}"] = tuple(b.state.qh.shape)

    # one rank -> mesh: every rank runs the one-rank model, rank 0 writes
    one = coupled(CoupledModel, ic, nsteps=4, device="cpu", fast=True,
                  q_half=False)
    f1 = os.path.join(d, "one_rank.h5")
    if rank == 0:
        one.save_checkpoint(f1)
    mesh.barrier()
    c = coupled(CoupledModel, ic, nsteps=0, mesh=mesh, device="cpu",
                fast=True)
    c.load_checkpoint(f1)
    one.run_steps(4)
    c.run_steps(4)
    res["one_to_mesh_dq"] = float(np.abs(c.q - one.q).max()
                                  / np.abs(one.q).max())
    res["one_to_mesh_dphi"] = float(np.abs(c.phi - one.phi).max()
                                    / np.abs(one.phi).max())
    # mesh -> one rank: the mesh file after 4 steps into a one-rank model
    # on every rank, beside the mesh run (a, fast) after 8
    p = coupled(CoupledModel, ic, nsteps=0, device="cpu", fast=True,
                q_half=False)
    p.load_checkpoint(os.path.join(d, "mesh_True.h5"))
    p.run_steps(4)
    aq = a.q  # a collective
    res["mesh_to_one_dq"] = float(np.abs(p.q - aq).max() / np.abs(aq).max())
    res["mesh_to_one_tc"] = p.tc

    # run() with save_to_disk on the mesh: only rank 0's path is written
    coupled(CoupledModel, ic, nsteps=4, mesh=mesh, device="cpu", fast=True,
            save_to_disk=True, tsave_snapshots=2,
            path=os.path.join(d, f"mesh_out_{rank}"))

    # npy-async on the mesh with rank 0's snapshots directory gone: the
    # failed writes raise on every rank at the end of run_with_snapshots
    # (a rank that returned would wait at its next collective)
    if shutil.which("g++"):
        m = CoupledModel.Model(nx=NX, use_filter=False, tmax=2 * 10000.0,
                               mesh=mesh, device="cpu", fast=True,
                               save_to_disk=True, tsave_snapshots=1,
                               snapshot_format="npy-async",
                               path=os.path.join(d, f"mesh_async_{rank}"))
        if rank == 0:
            shutil.rmtree(os.path.join(d, "mesh_async_0", "snapshots"))
        raised = 0.0
        try:
            for _ in m.run_with_snapshots(tsnapint=10000.0):
                pass
        except (IOError, RuntimeError):
            raised = 1.0
        res["async_fail_raised_on"] = float(
            mesh.all_reduce(torch.tensor([raised])).item())
        res["async_fail_tc"] = m.tc
    return res


def main():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        multihost.initialize()  # bare, single-process: silent no-op
        bare_warned = [str(w.message) for w in caught
                       if "niwqg" in str(w.filename)]
    assert not torch.distributed.is_initialized()
    multihost.initialize(f"localhost:{port}", nranks, rank, device="cpu",
                         timeout_s=180)
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.rank, mesh.nP) == (rank, nranks)
    res = {"pfft": suite_pfft, "model": suite_model,
           "misc": suite_misc}[suite](mesh)
    res["bare_warnings"] = len(bare_warned)
    res["out_path"] = out
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    multihost.shutdown()
    print(f"WORKER{rank} OK", flush=True)


if __name__ == "__main__":
    main()
