"""The PyTorch port's pencil-distributed CoupledModel on 4 gloo ranks (CPU,
f64) against the JAX package's sharded run on the 4-device virtual mesh
(``tests/test_sharding.py:98-133``) and against the port's own unsharded
run; then the kernel's refusals, the process bootstrap and the conversion
of a sharded state."""

import shutil
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from niwqg_tpu import CoupledModel as JCoupled  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from niwqg_tpu_torch import CoupledModel as TCoupled  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.api import CoupledModel as TCoupledModel  # noqa: E402
from niwqg_tpu_torch.models.coupled import CoupledPhysics  # noqa: E402
from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel  # noqa: E402
from niwqg_tpu_torch.models.kernel import KernelParams  # noqa: E402
from niwqg_tpu_torch.ops.fft import NativeTransform  # noqa: E402
from niwqg_tpu_torch.parallel import multihost  # noqa: E402
from niwqg_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

from _torch_sharded_common import (DIAGS, MODEL_CONFIGS, NRANKS, NX,  # noqa: E402
                                    coupled, run_suite)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every configuration's sharded run from one spawn of 4 ranks."""
    return run_suite("model", tmp_path_factory.mktemp("model"))


@pytest.fixture(scope="module")
def misc(tmp_path_factory):
    return run_suite("misc", tmp_path_factory.mktemp("misc"))


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < NRANKS:
        pytest.skip("needs >= 4 devices")
    return jmake_mesh(NRANKS)


def _hold(port, name, ref):
    """q and phi to 1e-12 relative, Ke to 1e-12, three diagnostic series
    to 1e-10 (reordered reductions and transposes, same arithmetic)."""
    q, phi = np.asarray(ref.q), np.asarray(ref.phi)
    assert port[f"{name}_q"].shape == (NX, NX)
    assert np.abs(port[f"{name}_q"] - q).max() <= 1e-12 * np.abs(q).max()
    assert np.abs(port[f"{name}_phi"] - phi).max() <= 1e-12 * np.abs(phi).max()
    assert abs(float(port[f"{name}_Ke"]) - ref.Ke) <= 1e-12 * abs(ref.Ke)
    for d in DIAGS:
        va, vb = port[f"{name}_{d}"], ref.diagnostics[d]["value"]
        assert va.shape == vb.shape == (5,)
        assert np.abs(va - vb).max() <= 1e-10 * (np.abs(vb).max() + 1e-300), d


def _unsharded_kw(kw):
    """The one-rank run a sharded configuration is held against: the mesh
    keeps the q side full-spectrum, so a fast run compares with
    ``q_half=False``; transform options are the mesh's alone."""
    kw = {k: v for k, v in kw.items() if k != "transform_opts"}
    if kw.get("fast") and not kw.get("pair_inverse"):
        kw["q_half"] = False
    return kw


@pytest.mark.parametrize("name", ["faithful", "fast", "pair_inverse"])
def test_sharded_matches_jax_sharded(port, jmesh, name):
    """Faithful and fast kernel on the default route, and the pair-packed
    inverse, against the JAX run on its own 4-device mesh."""
    j = coupled(JCoupled, jic, mesh=jmesh, **MODEL_CONFIGS[name])
    _hold(port, name, j)


@pytest.mark.parametrize("name", list(MODEL_CONFIGS))
def test_sharded_matches_own_unsharded(port, name):
    """Every sharded configuration (both kernels, ``overlap_chunks=2``,
    ``pair_inverse``, the K2 route on its plain version) against the
    port's one-rank run."""
    t = coupled(TCoupled, tic, device="cpu",
                **_unsharded_kw(MODEL_CONFIGS[name]))
    _hold(port, name, t)
    assert np.abs(port[f"{name}_qh"] - t.qh).max() \
        <= 1e-12 * np.abs(t.qh).max()
    assert np.abs(port[f"{name}_phih"] - t.phih).max() \
        <= 1e-12 * np.abs(t.phih).max()


@pytest.mark.parametrize("name", list(MODEL_CONFIGS))
def test_sharded_state_is_local_blocks(port, name):
    """Physical fields are row blocks, spectral fields column blocks."""
    assert tuple(port[f"{name}_local_q_shape"]) == (NX // NRANKS, NX)
    assert tuple(port[f"{name}_local_qh_shape"]) == (NX, NX // NRANKS)
    assert port[f"{name}_qh"].shape == (NX, NX)


def test_routes_give_the_same_state(port):
    a, b = port["fast_q"], port["k2_route_q"]
    assert np.abs(a - b).max() <= 1e-13 * np.abs(a).max()


def test_multihost_bootstrap(misc):
    """``initialize()`` twice in one process and bare without a warning;
    ``host_local_rows`` and its refusal of an indivisible nx."""
    assert int(misc["world"]) == NRANKS
    assert int(misc["bare_warnings"]) == 0
    assert tuple(misc["rows"]) == (0, NX // NRANKS)
    assert bool(misc["indivisible_raises"])


def test_bare_initialize_is_silent_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        multihost.initialize()
        multihost.initialize()
    assert not torch.distributed.is_initialized()
    rows = multihost.host_local_rows(NX)
    assert (rows.start, rows.stop) == (0, NX)
    # an explicit but incomplete bootstrap is an error, not a local run
    with pytest.raises(ValueError, match="no value for"):
        multihost.initialize(num_processes=4)


def test_reflection_across_ranks(misc):
    """Z(-k,-l) of a column-sharded spectrum equals the one-rank flip."""
    assert bool(misc["reflect_equal"])


@pytest.mark.parametrize("fast", [False, True])
def test_convert_round_trip_sharded(misc, fast):
    """A sharded state out to global numpy and back to shards continues
    the same trajectory."""
    assert tuple(misc[f"convert_global_shape_{fast}"]) == (NX, NX)
    assert tuple(misc[f"convert_local_shape_{fast}"]) == (NX, NX // NRANKS)
    assert int(misc[f"convert_tc_{fast}"]) == 5
    assert float(misc[f"convert_dq_{fast}"]) == 0.0
    assert float(misc[f"convert_dke_{fast}"]) == 0.0


@pytest.mark.parametrize("fast", [False, True])
def test_sharded_checkpoint_resumes_bitwise(misc, fast):
    """4 steps on the mesh, a checkpoint (a collective that rank 0
    writes), a fresh mesh model loads it and takes 4 more steps: q, phi,
    the budgets and the diagnostic series equal the uninterrupted mesh
    run's bitwise (JAX's sharded bound is 1e-14), and the state is this
    rank's column block again."""
    assert int(misc[f"ckpt_tc_{fast}"]) == 4
    for k in ("q", "phi", "Ke", "Pw", "Kw", "series"):
        assert bool(misc[f"ckpt_{k}_equal_{fast}"]), k
    assert int(misc[f"ckpt_series_len_{fast}"]) == 4
    assert tuple(misc[f"ckpt_local_qh_shape_{fast}"]) == (NX, NX // NRANKS)


def test_checkpoint_moves_between_one_rank_and_mesh(misc):
    """A file of the one-rank port (``q_half=False``) resumes on the mesh,
    and a mesh file on one rank, each within 1e-12 of the run it left
    (the mesh and one rank sum in other orders)."""
    assert float(misc["one_to_mesh_dq"]) <= 1e-12
    assert float(misc["one_to_mesh_dphi"]) <= 1e-12
    assert int(misc["mesh_to_one_tc"]) == 8
    assert float(misc["mesh_to_one_dq"]) <= 1e-12


def test_mesh_saver_writes_on_rank_0_only(misc, tmp_path):
    """``run()`` with ``save_to_disk`` on the mesh (every rank given its
    own path): rank 0's path holds the one-rank run's files, the same
    datasets to 1e-12 (the diagnostic series to 1e-10, as ``_hold``), and
    no other rank wrote a file; a checkpoint is written by rank 0 alone
    too."""
    import os

    import h5py

    d = os.path.dirname(str(misc["out_path"]))
    assert sorted(f for f in os.listdir(d) if f.startswith("mesh_out_")) \
        == ["mesh_out_0"]
    assert sorted(f for f in os.listdir(d) if f.startswith("who_")) \
        == ["who_False_0.h5", "who_True_0.h5"]
    one = str(tmp_path / "one")
    coupled(TCoupled, tic, nsteps=4, device="cpu", fast=True, q_half=False,
            save_to_disk=True, tsave_snapshots=2, path=one)
    mesh_out = os.path.join(d, "mesh_out_0")
    rel = lambda p: sorted(os.path.relpath(os.path.join(r, f), p)
                           for r, _, fs in os.walk(p) for f in fs)
    assert rel(mesh_out) == rel(one)
    assert "diagnostics.h5" in rel(one) and len(rel(one)) == 5
    for f in rel(one):
        rtol = 1e-10 if f == "diagnostics.h5" else 1e-12
        with h5py.File(os.path.join(one, f)) as a, \
                h5py.File(os.path.join(mesh_out, f)) as b:
            names = []
            a.visit(names.append)
            for n in names:
                if isinstance(a[n], h5py.Dataset):
                    x, y = b[n][()], a[n][()]
                    assert x.shape == y.shape and x.dtype == y.dtype, n
                    assert np.abs(x - y).max(initial=0.0) \
                        <= rtol * np.abs(y).max(initial=0.0), (f, n)


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="g++ (the native writer's compiler) is not "
                           "installed")
def test_mesh_snapshot_write_failure_raises_on_every_rank(misc):
    """``snapshot_format="npy-async"`` on the mesh with rank 0's
    snapshots directory removed: the drain at the end of
    ``run_with_snapshots`` raises on all four ranks, not on rank 0 alone
    (the others would then hang at their next collective)."""
    assert float(misc["async_fail_raised_on"]) == 4.0
    assert int(misc["async_fail_tc"]) == 2


def test_pair_inverse_refusals():
    """``pair_inverse``'s three refusals: ``q_half``, odd nx, physics that
    do not project."""
    p = KernelParams(nx=16)
    ok = FastWaveKernel(p, CoupledPhysics(), pair_inverse=True, device="cpu")
    assert ok.pair_inverse and not ok.q_half
    with pytest.raises(ValueError, match="q_half=False"):
        FastWaveKernel(p, CoupledPhysics(), pair_inverse=True, q_half=True,
                       device="cpu")
    with pytest.raises(ValueError, match="even nx"):
        FastWaveKernel(KernelParams(nx=15), CoupledPhysics(),
                       pair_inverse=True, device="cpu")

    class NoPairs(NativeTransform):
        ifft2_real_pairs = property()  # hasattr() is False

    with pytest.raises(ValueError, match="ifft2_real_pairs"):
        FastWaveKernel(p, CoupledPhysics(), pair_inverse=True, device="cpu",
                       transform=NoPairs(16))

    class Unprojected(CoupledPhysics):
        hermitian_ph = False

    with pytest.raises(ValueError, match="Hermitian-projecting"):
        FastWaveKernel(p, Unprojected(), pair_inverse=True, device="cpu")
    # the shell refuses it on the faithful kernel
    with pytest.raises(ValueError, match="fast=True"):
        TCoupledModel(nx=16, device="cpu", fast=False, pair_inverse=True)


def test_pair_inverse_matches_jax_unsharded():
    """One rank: the pair-packed inverse against JAX's, 5 steps at nx=64."""
    t = coupled(TCoupled, tic, device="cpu", fast=True, pair_inverse=True)
    j = coupled(JCoupled, jic, fast=True, pair_inverse=True)
    assert t.kernel.pair_inverse and j.kernel.pair_inverse
    assert np.abs(t.q - j.q).max() <= 1e-12 * np.abs(j.q).max()
    assert np.abs(t.phi - np.asarray(j.phi)).max() <= 1e-12
    assert abs(t.Ke - j.Ke) <= 1e-12 * abs(j.Ke)


def test_mesh_model_rules(monkeypatch):
    """A one-rank mesh runs with no process group; a mesh model goes to the
    card unless the CPU is asked for, and refuses what a mesh cannot run."""
    mesh = make_mesh(device="cpu")
    m = coupled(TCoupled, tic, nsteps=2, mesh=mesh, device="cpu", fast=True)
    ref = coupled(TCoupled, tic, nsteps=2, device="cpu", fast=True,
                  q_half=False)
    assert not m.kernel.q_half
    assert np.abs(m.q - ref.q).max() <= 1e-13 * np.abs(ref.q).max()
    with pytest.raises(ValueError, match="q_half is not available"):
        TCoupledModel(nx=16, mesh=mesh, device="cpu", fast=True, q_half=True)
    with pytest.raises(TypeError, match="Mesh"):
        TCoupledModel(nx=16, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mxu"):
        TCoupledModel(nx=16, mesh=mesh, device="cpu", backend="mxu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCoupledModel(nx=16, mesh=mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_unknown_transform_opts_warn(caplog):
    import logging

    mesh = make_mesh(device="cpu")
    # the shell's logger does not propagate: listen on it directly
    logger = logging.getLogger("niwqg_tpu_torch.api")
    logger.addHandler(caplog.handler)
    try:
        TCoupledModel(nx=16, mesh=mesh, device="cpu",
                      transform_opts={"overlap_chunks": 2, "factors": None})
    finally:
        logger.removeHandler(caplog.handler)
    assert "transform_opts ignored by the pencil provider: ['factors']" \
        in caplog.text
