"""One rank of the PyTorch port's distributed tests (gloo, CPU, f64).

Launched by ``tests/test_torch_pfft.py``, ``tests/test_torch_sharded.py``,
``tests/test_torch_sharded_models.py`` and ``tests/test_torch_mxu_mesh.py``
as ``NRANKS`` subprocesses. Every rank builds the same inputs from a numpy
seed, runs one suite of checks on the mesh, and rank 0 writes what it
gathered to ``<out>.npz`` for the parent to hold against JAX.

Usage: python _torch_sharded_worker.py <port> <rank> <nranks> <suite> <out.npz>
Suites: ``pfft`` (the pencil transform), ``model`` (the sharded
CoupledModel), ``misc`` (bootstrap, layouts, conversion), ``family`` (the
UnCoupled, QL, YBJ and QG models on the mesh, their checkpoints, K2's
launches per step and ``make_global_field``), ``mxu`` (the matmul-DFT on
the mesh: its transforms, the five models, the K1 configuration, and
checkpoints moving to and from the JAX package's mxu-mesh file),
``mesh_graph`` (K2's all_reduce and reflection exchange, their plain
versions against ``torch.distributed``; each model's run() and run_steps
on the K2 route and on the default route; K2's, K1's and the library's
calls in one step of each kind, A and B, of ``chip_smoke.py``'s mesh
configurations; no host value in a default-route step), ``derive_card``
(on the card, ranks sharing it: the fused derive's kernels against its
plain chain on the pencil mesh, K2's route and the default one, and on the
matmul-DFT's mesh; every rank's gaps gathered to rank 0), ``stage_card``
(the same for the fused stage epilogue, ``chip_smoke.stage_gaps``).
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

from _torch_sharded_common import (DEFAULT_OPTS, DIAGS,  # noqa: E402
                                    FAMILY_CONFIGS, FAMILY_DIAGS,
                                    FAMILY_FIELDS, HostValues, K2_OPTS,
                                    K1_MESH_NX, K1_MESH_STEPS, MODEL_CONFIGS,
                                    MESH_GRAPH_CASES, MESH_ROUTES, MXU_CASES,
                                    MXU_HELD, MXU_OPTION_SETS, NX, SEED,
                                    SEED_K1, coupled, family,
                                    mxu_case, mxu_coupled_ckpt, pfft_inputs)


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


def suite_family(mesh):
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.parallel import a2a

    from niwqg_tpu_torch.ops import spectral

    res = {}
    plain = a2a.FAMILY.plain_calls
    launches = lambda: sum(a2a.counts()[k] for k in a2a.KINDS)
    # the Hermitian projections' exchanges of mirror columns (each one
    # all_to_all_single, on every route)
    reflections = [0]
    reflect = spectral.reflect_spectrum

    def counted(*a, **k):
        reflections[0] += 1
        return reflect(*a, **k)

    spectral.reflect_spectrum = counted
    for name, (kind, kw) in FAMILY_CONFIGS.items():
        m = family(pkg, ic, kind, mesh=mesh, device="cpu", **kw)
        for k in FAMILY_FIELDS[kind]:  # collectives: every rank
            res[f"{name}_{k}"] = getattr(m, k)
        for d in FAMILY_DIAGS[kind]:
            res[f"{name}_{d}"] = m.diagnostics[d]["value"]
        spec = "qh" if kind == "qg" else "phih"
        res[f"{name}_{spec}"] = getattr(m, spec)
        res[f"{name}_local_spec_shape"] = tuple(getattr(m.state, spec).shape)
        res[f"{name}_local_phys_shape"] = tuple(
            (m.state.q if kind == "qg" else m.state.d.q).shape)
        if kind == "qg":
            # the padded columns stay exactly zero through the steps
            pad = m.kernel.grid.pad
            res[f"{name}_pad"] = pad
            res[f"{name}_pad_max"] = max(
                float(torch.abs(mesh.gather_cols(getattr(m.state, f))
                                [:, NX // 2 + 1:]).max())
                for f in ("qh", "ch", "ph"))
        # one step's transposes and reflections, counted on the host
        n0 = (plain("fwd"), plain("inv"), launches(), reflections[0])
        m.run_steps(1)
        res[f"{name}_per_step"] = (plain("fwd") - n0[0],
                                   plain("inv") - n0[1],
                                   launches() - n0[2],
                                   reflections[0] - n0[3])
    spectral.reflect_spectrum = reflect

    res.update(family_checkpoints(mesh, pkg, ic, os.path.dirname(out)))
    res.update(global_field(mesh, pkg, ic))
    return res


def family_checkpoints(mesh, pkg, ic, d):
    """Each model's checkpoint on the mesh (a collective, rank 0 writes):
    4 steps, the file, 4 more; a fresh mesh model loads the file and takes
    the same 4, which must give the same bits. QG's file stays for the
    parent, which holds its layout to JAX's sharded file."""
    res = {}
    for name in ("uncoupled_faithful", "ql_fast", "ybj_faithful", "qg"):
        kind, kw = FAMILY_CONFIGS[name]
        a = family(pkg, ic, kind, nsteps=4, mesh=mesh, device="cpu", **kw)
        ck = os.path.join(d, f"family_{name}.h5")
        a.save_checkpoint(ck)
        a.run_steps(4)
        b = family(pkg, ic, kind, nsteps=0, mesh=mesh, device="cpu", **kw)
        b.load_checkpoint(ck)
        res[f"ckpt_{name}_tc"] = b.tc
        b.run_steps(4)
        for k in FAMILY_FIELDS[kind]:  # collectives: every rank
            res[f"ckpt_{name}_{k}_equal"] = bool(np.array_equal(
                getattr(a, k), getattr(b, k)))
        res[f"ckpt_{name}_series_equal"] = all(
            np.array_equal(a.diagnostics[k]["value"],
                           b.diagnostics[k]["value"]) for k in a.diagnostics)

    # QG's two spectral widths: a one-rank file (nx/2+1 columns) resumes
    # on the mesh, and the mesh's file (padded columns) on one rank
    one = family(pkg, ic, "qg", nsteps=4, device="cpu")
    f1 = os.path.join(d, "family_qg_one_rank.h5")
    if rank == 0:
        one.save_checkpoint(f1)
    mesh.barrier()
    c = family(pkg, ic, "qg", nsteps=0, mesh=mesh, device="cpu")
    c.load_checkpoint(f1)
    one.run_steps(4)
    c.run_steps(4)
    res["qg_one_to_mesh_dq"] = float(np.abs(c.q - one.q).max()
                                     / np.abs(one.q).max())
    res["qg_one_to_mesh_dcvar"] = abs(c.cvar - one.cvar) / abs(one.cvar)
    p = family(pkg, ic, "qg", nsteps=0, device="cpu")
    p.load_checkpoint(os.path.join(d, "family_qg.h5"))
    p.run_steps(4)
    aq = a.q  # the mesh run after 8 steps (a collective)
    res["qg_mesh_to_one_dq"] = float(np.abs(p.q - aq).max()
                                     / np.abs(aq).max())
    res["qg_mesh_to_one_qh_shape"] = tuple(p.state.qh.shape)
    return res


def global_field(mesh, pkg, ic):
    """``make_global_field`` on the mesh: this rank's block, the refusal of
    a block of the wrong height, and ``set_q``/``set_c``/``set_phi`` taking
    its result as they take the global array."""
    res = {}
    rng = np.random.default_rng(7)
    full = rng.standard_normal((NX, NX))
    rows = multihost.host_local_rows(NX)
    blk = multihost.make_global_field(mesh, full[rows], NX)
    res["mgf_shape"] = blk.shape
    res["mgf_rows"] = (blk.rows.start, blk.rows.stop)
    res["mgf_local_equal"] = bool(np.array_equal(blk.local, full[rows]))
    try:
        multihost.make_global_field(mesh, np.zeros((3, NX)), NX)
        res["mgf_bad_block"] = ""
    except ValueError as exc:
        res["mgf_bad_block"] = str(exc)

    def build(kind, via_block):
        m = family(pkg, ic, kind, nsteps=0, mesh=mesh, device="cpu")
        k0 = 10 * (2 * np.pi / m.L)
        q = ic.LambDipole(m, U=0.05, R=2 * np.pi / k0)
        second = (np.real(ic.PlaneWave(m, k=k0, l=k0)) if kind == "qg"
                  else ic.WavePacket(m, k=k0, l=k0, R=m.L / 8, x0=m.L / 3,
                                     y0=m.L / 2))
        if via_block:
            q = multihost.make_global_field(mesh, q[rows], NX)
            second = multihost.make_global_field(mesh, second[rows], NX)
        m.set_q(q)
        (m.set_c if kind == "qg" else m.set_phi)(second)
        m.run_steps(2)
        return m

    for kind in ("qg", "uncoupled"):
        a, b = build(kind, False), build(kind, True)
        other = "c" if kind == "qg" else "phi"
        res[f"mgf_{kind}_equal"] = all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for k in ("q", other, "Ke"))
    return res


def suite_mxu(mesh):
    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch import io as nio
    from niwqg_tpu_torch.parallel.mfft import MatmulPencilTransform

    res = {}
    # (i) the provider's transforms, every option set, 3 fields a call
    _, z3, _, x3 = pfft_inputs()
    rows = lambda a: torch.as_tensor(np.ascontiguousarray(mesh.rows(a)))
    for name, opts in MXU_OPTION_SETS.items():
        tr = MatmulPencilTransform(NX, np.float64, mesh, **opts)
        zh3 = tr.fft2(rows(z3))
        res[f"tr_{name}_fft2"] = mesh.gather_cols(zh3).numpy()
        res[f"tr_{name}_ifft2"] = mesh.gather_rows(tr.ifft2(zh3)).numpy()
        res[f"tr_{name}_ifft2_real"] = mesh.gather_rows(
            tr.ifft2_real(zh3)).numpy()
        rh3 = tr.rfft2(rows(x3))
        res[f"tr_{name}_rfft2"] = mesh.gather_cols(rh3).numpy()
        res[f"tr_{name}_irfft2"] = mesh.gather_rows(tr.irfft2(rh3)).numpy()
        xh3 = tr.fft2_real(rows(x3))
        res[f"tr_{name}_fft2_real"] = mesh.gather_cols(xh3).numpy()
        res[f"tr_{name}_pairs3"] = mesh.gather_rows(
            tr.ifft2_real_pairs(xh3)).numpy()
        res[f"tr_{name}_resolved"] = repr((tr.mm.factors, tr.mm.realpath,
                                           tr.mm.gauss, tr.mm.formulation,
                                           tr.mm.max_batch, tr.pallas_a2a))

    # (ii) JAX's seven mxu-mesh cases, (iv) the q side's layout
    for name, (model, *_) in MXU_CASES.items():
        m = mxu_case(pkg, ic, name, mesh=mesh, device="cpu")
        fields, series = MXU_HELD[model]
        for k in fields:  # collectives: every rank
            res[f"{name}_{k}"] = getattr(m, k)
        res[f"{name}_{series}"] = m.diagnostics[series]["value"]
        res[f"{name}_q_half"] = bool(getattr(m.kernel, "q_half", False))
        res[f"{name}_local_qh_shape"] = tuple(m.state.qh.shape)
        tree = nio.checkpoint_tree(m)  # a collective
        res[f"{name}_tree_qh_shape"] = tree["state"]["qh"].shape
        res[f"{name}_user_qh_shape"] = m.qh.shape
        qh = mesh.gather_cols(m.state.qh)
        if qh.shape[-1] != NX:  # the half layout: its padded columns
            res[f"{name}_pad_max"] = float(qh[..., NX // 2 + 1:].abs().max())

    res.update(mxu_k1(mesh, pkg, ic))
    res.update(mxu_k2(mesh, pkg, ic))
    res.update(mxu_global_field(mesh, pkg, ic))
    res.update(mxu_checkpoints(mesh, pkg, ic, os.path.dirname(out)))
    return res


def mxu_k2(mesh, pkg, ic):
    """K2's calls (forward, inverse; its plain version on the host) in one
    step of each model as ``chip_smoke.py`` phase 12 builds it: the
    flagship's physics in its default quirk mode, the wave packet on the
    three other wave models, QG with its scalar, JAX's default options
    with the phase's ``transform_opts``."""
    from chip_smoke import MXU_MESH_MODEL, flagship, qg_flagship
    from niwqg_tpu_torch.parallel import a2a

    plain = a2a.FAMILY.plain_calls
    res = {}
    for name in ("CoupledModel", "UnCoupledModel", "QLModel", "YBJModel",
                 "QGModel"):
        kw = dict(MXU_MESH_MODEL, dtype=np.float64, mesh=mesh, device="cpu")
        m = (qg_flagship(pkg.QGModel, ic, nx=NX, **kw) if name == "QGModel"
             else flagship(getattr(pkg, name), ic, nx=NX,
                           packet=name != "CoupledModel", **kw))
        launches = lambda: sum(a2a.counts()[k] for k in a2a.KINDS)
        n0 = (plain("fwd"), plain("inv"), launches())
        m.run_steps(1)
        res[f"k2_{name}"] = (plain("fwd") - n0[0], plain("inv") - n0[1],
                             launches() - n0[2])
    return res


def mxu_k1(mesh, pkg, ic):
    """(iii) The K1 configuration on the mesh: its transforms of seeded
    fields; the Coupled flagship's K1 calls of one step by shape (its
    plain version on the host) and its fields after K1_MESH_STEPS
    steps."""
    from collections import Counter

    from chip_smoke import K1_MESH_MODEL, flagship
    from niwqg_tpu_torch.ops import fft as tfft

    from niwqg_tpu_torch.parallel.mfft import MatmulPencilTransform

    res = {}
    # its transforms alone, for the parent to hold to the one-card ones
    rng = np.random.default_rng(SEED_K1)
    x = rng.standard_normal((2, K1_MESH_NX, K1_MESH_NX)).astype(np.float32)
    zr = rng.standard_normal((2, K1_MESH_NX, K1_MESH_NX)).astype(np.float32)
    rows = lambda a: torch.as_tensor(np.ascontiguousarray(mesh.rows(a)))
    tr = MatmulPencilTransform(K1_MESH_NX, np.float32, mesh,
                               precision=K1_MESH_MODEL["precision"],
                               **K1_MESH_MODEL["transform_opts"])
    zh = tr.fft2(torch.complex(rows(x), rows(zr)))
    res["k1_fft2"] = mesh.gather_cols(zh).numpy()
    res["k1_ifft2"] = mesh.gather_rows(tr.ifft2(zh)).numpy()
    xh = tr.rfft2(rows(x))
    res["k1_rfft2"] = mesh.gather_cols(xh).numpy()
    res["k1_irfft2"] = mesh.gather_rows(tr.irfft2(xh)).numpy()

    calls = []
    orig = tfft.csplit_matmul_prepared

    def counted(ar, ai, b):
        calls.append(tuple(ar.shape))
        return orig(ar, ai, b)

    tfft.csplit_matmul_prepared = counted
    try:
        m = flagship(pkg.CoupledModel, ic, nx=K1_MESH_NX, packet=True,
                     mesh=mesh, device="cpu", **K1_MESH_MODEL)
        del calls[:]
        m.run_steps(1)
        per_step = Counter(calls)
        m.run_steps(K1_MESH_STEPS - 1)
    finally:
        tfft.csplit_matmul_prepared = orig
    res.update({"k1_calls": [(M, K, n) for (M, K), n in
                             sorted(per_step.items())],
                "k1_q_half": m.kernel.q_half, "k1_q": m.q, "k1_phi": m.phi,
                "k1_Ke": m.Ke})
    return res


def mxu_global_field(mesh, pkg, ic):
    """``set_q`` with ``set_phi`` (Coupled) or ``set_c`` (QG) on the mxu
    mesh given ``make_global_field`` blocks: the same 2 steps, bitwise, as
    with the global arrays."""
    rows = multihost.host_local_rows(NX)
    res = {}
    for name in ("coupled", "qg"):
        def build(via_block):
            m = mxu_case(pkg, ic, name, nsteps=0, mesh=mesh, device="cpu")
            k0 = 10 * (2 * np.pi / m.L)
            q = ic.LambDipole(m, U=0.05, R=2 * np.pi / k0)
            second = (np.real(ic.PlaneWave(m, k=k0, l=k0)) if name == "qg"
                      else ic.WavePacket(m, k=k0, l=k0, R=m.L / 8,
                                         x0=m.L / 3, y0=m.L / 2))
            if via_block:
                q = multihost.make_global_field(mesh, q[rows], NX)
                second = multihost.make_global_field(mesh, second[rows], NX)
            m.set_q(q)
            (m.set_c if name == "qg" else m.set_phi)(second)
            m.run_steps(2)
            return m

        a, b = build(False), build(True)
        other = "c" if name == "qg" else "phi"
        res[f"mgf_{name}_equal"] = all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for k in ("q", other, "Ke"))
    return res


def mxu_checkpoints(mesh, pkg, ic, d):
    """Checkpoints on the mxu mesh: the port's Coupled and QG files resume
    bitwise; JAX's mxu-mesh Coupled file (written beside ``out`` by the
    parent, after 4 of 8 steps) resumes here; the port's file after 4
    steps stays for the parent, which resumes it in JAX and compares its
    layout with JAX's."""
    res = {}
    kw = dict(mesh=mesh, device="cpu")
    for name, fields in (("coupled", ("q", "phi", "Ke", "Pw", "Kw")),
                         ("qg", ("q", "Ke"))):
        # 4 steps, the file (rank 0 writes), 4 more; a fresh mesh model
        # loads the file and takes the same 4
        if name == "coupled":
            a = mxu_coupled_ckpt(pkg, ic, 8, **kw)
            a.run_steps(4)
        else:
            a = mxu_case(pkg, ic, "qg", nsteps=4, **kw)
        ck = os.path.join(d, f"mxu_{name}.h5")
        a.save_checkpoint(ck)
        a.run_steps(4)
        b = (mxu_coupled_ckpt(pkg, ic, 8, **kw) if name == "coupled"
             else mxu_case(pkg, ic, "qg", nsteps=0, **kw))
        b.load_checkpoint(ck)
        res[f"ckpt_{name}_tc"] = b.tc
        b.run_steps(4)
        for k in fields:  # collectives: every rank
            res[f"ckpt_{name}_{k}_equal"] = bool(np.array_equal(
                getattr(a, k), getattr(b, k)))
        res[f"ckpt_{name}_series_equal"] = all(
            np.array_equal(a.diagnostics[k]["value"],
                           b.diagnostics[k]["value"]) for k in a.diagnostics)
    # JAX's file after 4 steps, resumed here for 4 more
    c = mxu_coupled_ckpt(pkg, ic, 8, **kw)
    c.load_checkpoint(os.path.join(d, "jax_mxu_coupled.h5"))
    res["from_jax_tc"] = c.tc
    c.run_steps(4)
    res["from_jax_q"], res["from_jax_phi"] = c.q, c.phi
    res["from_jax_Ke"] = c.Ke
    return res


def suite_mesh_graph(mesh):
    import torch.distributed as dist

    import niwqg_tpu_torch as pkg
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch.parallel import a2a
    from niwqg_tpu_torch.parallel.mesh import (all_max, all_sum,
                                               reflect_spectrum)

    res = {}
    # (i) the plain versions of K2's all_reduce and reflection exchange
    # against torch.distributed, f64: dyadic values sum exactly in any order
    group = a2a.PeerGroup(mesh)
    k2 = mesh.with_group(group)
    rng = np.random.default_rng(SEED + 7 * mesh.rank)
    v = torch.as_tensor(rng.integers(-2**20, 2**20, 5) / 1024.0)
    want = v.clone()
    dist.all_reduce(want)
    res["sum_dyadic_equal"] = torch.equal(all_sum(v, k2), want)
    w = torch.as_tensor(rng.standard_normal(7))
    got = all_sum(w, k2)
    want = w.clone()
    dist.all_reduce(want)
    res["sum_rel"] = float((got - want).abs().max() / want.abs().max())
    res["sum_rank_order"] = torch.equal(
        got, sum(mesh.all_gather(w)[1:], mesh.all_gather(w)[0]))
    res["sum_same_on_every_rank"] = all(
        torch.equal(o, got) for o in mesh.all_gather(got))
    want = w.clone()
    dist.all_reduce(want, op=dist.ReduceOp.MAX)
    res["max_equal"] = torch.equal(all_max(w, k2), want)
    x0 = torch.tensor(float(mesh.rank) + 0.5, dtype=torch.float64)
    res["scalar_sum"] = all_sum(x0, k2)
    zg = np.random.default_rng(SEED).standard_normal((2, 3, NX, NX, 2))
    zg = torch.as_tensor(zg[..., 0] + 1j * zg[..., 1])
    zb = mesh.cols(zg).contiguous()
    got = reflect_spectrum(zb, k2)
    res["reflect_equal"] = torch.equal(got, reflect_spectrum(zb, mesh))
    res["reflect_global"] = mesh.gather_cols(got).numpy()
    res["reflect_input"] = zg.numpy()
    res["plain_calls"] = (a2a.FAMILY.plain_calls("gather"),
                          a2a.FAMILY.plain_calls("reflect"))

    # (ii) each model's run() and run_steps on each route: the reductions
    # of run() through K2, and the library's (sums and maxima)
    from chip_smoke import count_collectives

    for route, opts in MESH_ROUTES.items():
        pre = "" if route == "k2" else f"{route}_"
        for name in MESH_GRAPH_CASES:
            model = MXU_CASES[name][0]
            fields, series = MXU_HELD[model]
            kw = dict(mesh=mesh, device="cpu", transform_opts=dict(opts))
            calls = a2a.FAMILY.plain_calls("gather")
            with count_collectives() as lib:
                m = mxu_case(pkg, ic, name, **kw)
            res[f"run_{pre}{name}_reductions"] = (
                a2a.FAMILY.plain_calls("gather") - calls,
                lib["sum"] + lib["max"])
            for k in fields:  # collectives: every rank
                res[f"run_{pre}{name}_{k}"] = getattr(m, k)
            res[f"run_{pre}{name}_{series}"] = m.diagnostics[series]["value"]
            m = mxu_case(pkg, ic, name, run=False, **kw)
            m.run_steps(MXU_CASES[name][2])
            for k in fields:
                res[f"steps_{pre}{name}_{k}"] = getattr(m, k)

    res.update(graph_pins(mesh, pkg, ic))
    return res


def graph_pins(mesh, pkg, ic):
    """K2's calls (forward, inverse, all_reduce, reflection), K1's and the
    library's collectives (``chip_smoke.LIB_KINDS``, counted by wrapping
    the mesh's) in one step without a diagnostics sample (graph A) and one
    with (B), at a sample every step, of each of ``chip_smoke.py``'s mesh
    configurations on both routes: phase 7's flagship and family rows,
    phase 12's rows (the K1 configuration at K1_MESH_NX, in f32; the
    others in f64: the counts do not depend on the type); then, on the
    default route, a step with a sample under ``HostValues``."""
    from chip_smoke import (DEFAULT_FAMILY_MESH_RUNS, DEFAULT_FLAGSHIP,
                            DEFAULT_MXU_MESH_RUNS, FAMILY_MESH_RUNS,
                            LIB_KINDS, MXU_MESH_RUNS, PENCIL_FLAGSHIP,
                            build_model, count_collectives)
    from niwqg_tpu_torch.ops import csplit_mm
    from niwqg_tpu_torch.parallel import a2a

    def plain():
        """The plain versions' calls: K2's by kind, then K1's."""
        return [a2a.FAMILY.plain_calls(k) for k in a2a.KINDS] + [
            csplit_mm.FAMILY.plain_calls()]

    res = {}
    for run in ((PENCIL_FLAGSHIP,) + FAMILY_MESH_RUNS + MXU_MESH_RUNS
                + (DEFAULT_FLAGSHIP,) + DEFAULT_FAMILY_MESH_RUNS
                + DEFAULT_MXU_MESH_RUNS):
        kw = {k: dict(v) if isinstance(v, dict) else v
              for k, v in run.build.items()}
        if "k1" in (run.key, run.base):
            kw["nx"] = K1_MESH_NX
        else:
            kw.update(nx=NX, dtype=np.float64)
        m = build_model(pkg, ic, run.name, mesh=mesh, device="cpu",
                        tdiags=1, **kw)
        m.run_steps(1)
        for graph, diags in (("A", False), ("B", True)):
            n0 = plain()
            with count_collectives() as lib:
                m._runner.advance(1, diags=diags)
            res[f"pin_{run.key}_{graph}"] = [b - a for a, b in
                                             zip(n0, plain())] + [
                lib[k] for k in LIB_KINDS]
        if run.base is not None:
            K = m.kernel
            s0 = m.state
            with HostValues() as mode:
                s = K.step(s0)
                m._diag_fn(s, s0.t)
                if m._stale_grads:
                    K.refresh_phi_gradients(s)
            res[f"host_values_{run.key}"] = mode.hits
    return res


def suite_derive_card(mesh):
    import torch.distributed as dist

    from chip_smoke import derive_gaps
    from niwqg_tpu_torch.ops import derive_fused

    import niwqg_tpu_torch as pkg

    runs = {"coupled_k2": ("CoupledModel", K2_OPTS, "native"),
            "coupled_default": ("CoupledModel", DEFAULT_OPTS, "native"),
            "ql_k2": ("QLModel", K2_OPTS, "native"),
            "uncoupled_quirks_default": ("UnCoupledModel", DEFAULT_OPTS,
                                         "native"),
            "coupled_mxu_k2": ("CoupledModel", K2_OPTS, "mxu")}
    gaps = {}
    derive_fused.reset_counts()
    for key, (mod, opts, backend) in runs.items():
        kw = {"faithful_quirks": True} if mod == "UnCoupledModel" else {}
        m = getattr(pkg, mod).Model(nx=256, dtype=np.float32, fast=True,
                                    mesh=mesh, backend=backend,
                                    transform_opts=dict(opts), **kw)
        for what, v in derive_gaps(torch, m.kernel, seed=SEED).items():
            gaps[f"gap_{mesh.rank}_{key}_{what}"] = v
        del m
    every = [None] * mesh.nP
    dist.all_gather_object(every, gaps)
    res = {k: v for g in every for k, v in g.items()}
    res["launches_project_pack"] = derive_fused.counts()[
        "derive_project_pack"]
    return res


def suite_stage_card(mesh):
    import torch.distributed as dist

    from chip_smoke import stage_gaps
    from niwqg_tpu_torch.ops import stage_fused

    import niwqg_tpu_torch as pkg

    runs = {"coupled_k2": ("CoupledModel", K2_OPTS, "native"),
            "coupled_default": ("CoupledModel", DEFAULT_OPTS, "native"),
            "ql_k2": ("QLModel", K2_OPTS, "native"),
            "uncoupled_quirks_default": ("UnCoupledModel", DEFAULT_OPTS,
                                         "native"),
            "coupled_mxu_k2": ("CoupledModel", K2_OPTS, "mxu")}
    gaps = {}
    stage_fused.reset_counts()
    for key, (mod, opts, backend) in runs.items():
        kw = {"faithful_quirks": True} if mod == "UnCoupledModel" else {}
        m = getattr(pkg, mod).Model(nx=256, dtype=np.float32, fast=True,
                                    mesh=mesh, backend=backend,
                                    transform_opts=dict(opts), **kw)
        for what, v in stage_gaps(torch, m.kernel, seed=SEED).items():
            gaps[f"gap_{mesh.rank}_{key}_{what}"] = v
        del m
    every = [None] * mesh.nP
    dist.all_gather_object(every, gaps)
    res = {k: v for g in every for k, v in g.items()}
    c = stage_fused.counts()
    res["launches_stage"], res["launches_sources"] = c["stage"], c["sources"]
    return res


def main():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        multihost.initialize()  # bare, single-process: silent no-op
        bare_warned = [str(w.message) for w in caught
                       if "niwqg" in str(w.filename)]
    assert not torch.distributed.is_initialized()
    device = "cuda" if suite in ("derive_card", "stage_card") else "cpu"
    multihost.initialize(f"localhost:{port}", nranks, rank, device=device,
                         timeout_s=180)
    mesh = multihost.global_mesh(device=None if device == "cuda" else "cpu")
    assert (mesh.rank, mesh.nP) == (rank, nranks)
    res = {"pfft": suite_pfft, "model": suite_model,
           "misc": suite_misc, "family": suite_family,
           "mxu": suite_mxu, "mesh_graph": suite_mesh_graph,
           "derive_card": suite_derive_card,
           "stage_card": suite_stage_card}[suite](mesh)
    res["bare_warnings"] = len(bare_warned)
    res["out_path"] = out
    if rank == 0:
        np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    multihost.shutdown()
    print(f"WORKER{rank} OK", flush=True)


if __name__ == "__main__":
    main()
