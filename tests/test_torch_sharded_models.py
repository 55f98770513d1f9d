"""The PyTorch port's UnCoupled, QL, YBJ and QG (+scalar) models on 4 gloo
ranks (CPU, f64, nx=64, 5 steps) against the JAX package's sharded runs on
its 4-device virtual mesh (``tests/test_sharding.py:136-250``) and against
the port's own one-rank runs; their checkpoints on the mesh (QG's file
against JAX's sharded file, ``tests/test_checkpoint_sharded.py:78``), K2's
launches per step against JAX's trace, and ``make_global_field``
(``tests/test_multihost.py:53-56,116-130``)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import niwqg_tpu  # noqa: E402
import niwqg_tpu_torch  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu.parallel import pallas_a2a as jk2  # noqa: E402
from niwqg_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.api import QGModel as TQGModel  # noqa: E402
from niwqg_tpu_torch.parallel import multihost  # noqa: E402
from niwqg_tpu_torch.parallel.mesh import RowBlock, make_mesh  # noqa: E402

from _torch_sharded_common import (FAMILY_CONFIGS, FAMILY_DIAGS,  # noqa: E402
                                    FAMILY_FIELDS, K2_OPTS, NRANKS, NX,
                                    family, run_suite)
from chip_smoke import K2_PER_STEP_FAMILY  # noqa: E402

# the configurations JAX runs on its pencil mesh (it has no pencil-mesh QL)
JAX_CONFIGS = [n for n, (kind, kw) in FAMILY_CONFIGS.items()
               if kind != "ql" and "transform_opts" not in kw]
# Hermitian projections of a full-spectrum ph per step (each one exchange
# of mirror columns, reflect_spectrum, through K2's reflect kind on the K2
# route): one per derive where the fast kernel projects ph (UnCoupled),
# one per stage's Parseval budget sources where the physics leaves ph
# unprojected (QL); none on QG's half spectrum
REFLECTIONS_PER_STEP = {"uncoupled_k2": 4, "ql_k2": 4, "qg_k2": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """Every configuration's sharded run from one spawn of 4 ranks."""
    return run_suite("family", tmp_path_factory.mktemp("family"))


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < NRANKS:
        pytest.skip("needs >= 4 devices")
    return jmake_mesh(NRANKS)


def _hold(fam, name, ref):
    """The kind's fields to 1e-12 relative and its three diagnostic series
    to 1e-10 (reordered reductions and transposes, same arithmetic)."""
    kind = FAMILY_CONFIGS[name][0]
    for k in FAMILY_FIELDS[kind]:
        got, want = fam[f"{name}_{k}"], np.asarray(getattr(ref, k))
        assert got.shape == want.shape, k
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), k
    for d in FAMILY_DIAGS[kind]:
        va, vb = fam[f"{name}_{d}"], ref.diagnostics[d]["value"]
        assert va.shape == vb.shape and len(vb) >= 2, d
        assert np.abs(va - vb).max() <= 1e-10 * (np.abs(vb).max() + 1e-300), d


def _unsharded_kw(kind, kw):
    """The one-rank run a sharded configuration is held against: the mesh
    keeps a wave model's q side full-spectrum, so a fast run compares with
    ``q_half=False``; transform options are the mesh's alone."""
    kw = {k: v for k, v in kw.items() if k != "transform_opts"}
    if kw.get("fast") and kind != "ybj":
        kw["q_half"] = False
    return kw


@pytest.mark.parametrize("name", JAX_CONFIGS)
def test_family_matches_jax_sharded(fam, jmesh, name):
    """UnCoupled (both quirk modes, both kernels), YBJ (both modes) and QG
    with its scalar against JAX's run on its own 4-device pencil mesh."""
    kind, kw = FAMILY_CONFIGS[name]
    _hold(fam, name, family(niwqg_tpu, jic, kind, mesh=jmesh, **kw))


@pytest.mark.parametrize("name", list(FAMILY_CONFIGS))
def test_family_matches_own_unsharded(fam, name):
    """Every sharded configuration (QL in both modes on both kernels, the
    K2 route on its plain version) against the port's one-rank run, with
    the spectrum a user reads (QG: cut to nx/2+1 columns)."""
    kind, kw = FAMILY_CONFIGS[name]
    t = family(niwqg_tpu_torch, tic, kind, device="cpu",
               **_unsharded_kw(kind, kw))
    _hold(fam, name, t)
    spec = "qh" if kind == "qg" else "phih"
    want = getattr(t, spec)
    assert fam[f"{name}_{spec}"].shape == want.shape
    assert np.abs(fam[f"{name}_{spec}"] - want).max() \
        <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("name", list(FAMILY_CONFIGS))
def test_family_state_is_local_blocks(fam, name):
    """Physical fields are row blocks, spectral fields column blocks (QG's
    of the padded width: 33 + 3 columns over 4 ranks)."""
    kind = FAMILY_CONFIGS[name][0]
    width = (NX // 2 + 1 + 3) if kind == "qg" else NX
    assert tuple(fam[f"{name}_local_phys_shape"]) == (NX // NRANKS, NX)
    assert tuple(fam[f"{name}_local_spec_shape"]) == (NX, width // NRANKS)


@pytest.mark.parametrize("name", ["qg", "qg_k2"])
def test_qg_padded_columns_stay_zero(fam, name):
    """The pencil rfft's 3 padded columns hold exactly zero in qh, ch and
    ph after 5 steps."""
    assert int(fam[f"{name}_pad"]) == 3
    assert float(fam[f"{name}_pad_max"]) == 0.0


@pytest.mark.parametrize("name", ["qg", "uncoupled", "ql"])
def test_k2_route_matches_default_route(fam, name):
    """The transposes are copies: the K2 route (its plain version here)
    and the default route agree to rounding."""
    kind = FAMILY_CONFIGS[f"{name}_k2"][0]
    base = {"qg": "qg", "uncoupled": "uncoupled_faithful_fast",
            "ql": "ql_fast"}[name]
    for k in FAMILY_FIELDS[kind]:
        a, b = fam[f"{name}_k2_{k}"], fam[f"{base}_{k}"]
        assert np.abs(a - b).max() <= 1e-13 * np.abs(b).max(), k


def _jax_k2_per_step(monkeypatch, jmesh, kind):
    """JAX's calls of its K2 wrappers in one traced step of the model on
    its pencil mesh with ``pallas_a2a`` (the fast kernel for a wave
    model)."""
    calls = {"fwd": 0, "inv": 0}
    fwd, inv = jk2.all_to_all_fwd, jk2.all_to_all_inv

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jk2, "all_to_all_fwd", counting("fwd", fwd))
    monkeypatch.setattr(jk2, "all_to_all_inv", counting("inv", inv))
    mod = {"qg": niwqg_tpu.QGModel, "uncoupled": niwqg_tpu.UnCoupledModel}
    kw = dict(passive_scalar=True) if kind == "qg" else dict(fast=True)
    K = mod[kind].Model(nx=NX, mesh=jmesh, transform_opts=K2_OPTS,
                        **kw).kernel
    jax.make_jaxpr(K.step)(K.zero_state())
    return calls["fwd"], calls["inv"]


@pytest.mark.parametrize("kind,model", [("qg", "QGModel"),
                                        ("uncoupled", "UnCoupledModel")])
def test_k2_launches_per_step_pinned_to_jax(fam, jmesh, monkeypatch, kind,
                                            model):
    """The port's K2 calls in one step (its plain version on the host,
    counted by ``a2a.FAMILY.plain_calls``; no launch) equal JAX's calls of
    its Pallas all-to-all in one traced step, and the table
    ``chip_smoke.py`` holds the card to."""
    fwd, inv, launches, _ = (int(x) for x in fam[f"{kind}_k2_per_step"])
    assert launches == 0
    assert (fwd, inv) == _jax_k2_per_step(monkeypatch, jmesh, kind) \
        == K2_PER_STEP_FAMILY[model]


@pytest.mark.parametrize("name", list(REFLECTIONS_PER_STEP))
def test_reflections_per_step(fam, name):
    """The mirror-column exchanges a step makes on the K2 route (K2's
    reflect kind, its plain version here; not counted among the
    transposes)."""
    assert int(fam[f"{name}_per_step"][3]) == REFLECTIONS_PER_STEP[name]


@pytest.mark.parametrize("name", ["uncoupled_faithful", "ql_fast",
                                  "ybj_faithful", "qg"])
def test_family_checkpoint_resumes_bitwise(fam, name):
    """4 steps on the mesh, a checkpoint file (rank 0 writes), a fresh mesh
    model loads it and takes 4 more: the fields and every diagnostic
    series equal the uninterrupted run's bitwise."""
    kind = FAMILY_CONFIGS[name][0]
    assert int(fam[f"ckpt_{name}_tc"]) == 4
    for k in FAMILY_FIELDS[kind] + ("series",):
        assert bool(fam[f"ckpt_{name}_{k}_equal"]), k


def _layout(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(
            n, (getattr(o, "shape", None), str(getattr(o, "dtype", "")),
                dict(o.attrs))))
        out["/"] = {k: str(v) for k, v in f.attrs.items()}
    return out


def test_qg_checkpoint_file_matches_jax_sharded(fam, jmesh, tmp_path):
    """The mesh QG file holds JAX's sharded QG file's datasets (name,
    shape, dtype, kind): the spectra keep the pencil padding, nx/2+1+3
    columns, as JAX writes them; the values agree to 1e-12."""
    import h5py

    port = os.path.join(os.path.dirname(str(fam["out_path"])),
                        "family_qg.h5")
    j = family(niwqg_tpu, jic, "qg", nsteps=4, mesh=jmesh)
    jf = str(tmp_path / "jax_qg.h5")
    j.save_checkpoint(jf)
    assert _layout(port) == _layout(jf)
    assert _layout(port)["state/qh/re"][0] == (NX, NX // 2 + 1 + 3)
    with h5py.File(port) as a, h5py.File(jf) as b:
        for name in ("qh/re", "qh/im", "ch/re", "q", "c", "Ke", "cvar"):
            x, y = a["state/" + name][()], b["state/" + name][()]
            assert np.abs(x - y).max() <= 1e-12 * np.abs(y).max(), name


def test_qg_checkpoint_moves_between_one_rank_and_mesh(fam):
    """A one-rank QG file (nx/2+1 columns) resumes on the mesh and the
    mesh's padded file on one rank, within 1e-12 of the run it left."""
    assert float(fam["qg_one_to_mesh_dq"]) <= 1e-12
    assert float(fam["qg_one_to_mesh_dcvar"]) <= 1e-12
    assert float(fam["qg_mesh_to_one_dq"]) <= 1e-12
    assert tuple(fam["qg_mesh_to_one_qh_shape"]) == (NX, NX // 2 + 1)


def test_make_global_field(fam):
    """Each rank's block of the global field, as ``host_local_rows`` cuts
    it; nothing is gathered."""
    assert tuple(fam["mgf_shape"]) == (NX, NX)
    assert tuple(fam["mgf_rows"]) == (0, NX // NRANKS)
    assert bool(fam["mgf_local_equal"])


def test_make_global_field_rejects_bad_block(fam):
    """A wrong local row count fails loudly, not silently mis-tiled."""
    msg = str(fam["mgf_bad_block"])
    assert "rows" in msg and "expected 16" in msg
    with pytest.raises(ValueError, match="rows"):
        multihost.make_global_field(None, np.zeros((3, NX)), NX)


@pytest.mark.parametrize("kind", ["qg", "uncoupled"])
def test_set_fields_take_make_global_field(fam, kind):
    """``set_q`` with ``set_c`` (QG) or ``set_phi`` (UnCoupled) given
    ``make_global_field`` blocks run the same 2 steps, bitwise, as with the
    global arrays."""
    assert bool(fam[f"mgf_{kind}_equal"])


def test_row_block_of_another_rank_is_refused():
    """A block whose rows are not this rank's raises, on one rank too."""
    m = TQGModel(nx=32, device="cpu", mesh=make_mesh(device="cpu"))
    q = np.zeros((32, 32))
    whole = multihost.make_global_field(None, q, 32)
    assert isinstance(whole, RowBlock) and whole.shape == (32, 32)
    m.set_q(whole)
    with pytest.raises(ValueError, match="rows 8:16"):
        m.set_q(RowBlock(q[8:16], slice(8, 16), 32))
    with pytest.raises(ValueError, match="columns"):
        multihost.make_global_field(None, np.zeros((32, 16)), 32)
