"""Checkpoints of the PyTorch port against the JAX package, for each of the
five models in its default quirk mode (and the CoupledModel on both
kernels, ``q_half`` both ways): a JAX file resumes in the port and a port
file in JAX, each within 1e-12 of JAX's uninterrupted run; the port
resumes its own file bitwise; the port's file holds JAX's datasets; and a
JAX file moves between the full and the ``q_half`` q-side layouts.

Inputs come from a numpy seed, in f64 at nx=32, 10 steps with a checkpoint
after 5. Each configuration is run once (a module-scoped fixture), so that
each JAX model compiles its step once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import niwqg_tpu as jpkg  # noqa: E402
import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.io import read_checkpoint  # noqa: E402

from _torch_common import rel as _rel  # noqa: E402

NX, DT, N1, N2 = 32, 10000.0, 5, 5

# name: (module, keywords); each model in its default quirk mode, the
# CoupledModel on the faithful kernel and on the fast one with q_half both
# ways
CONFIGS = {
    "coupled": ("CoupledModel", dict(fast=False)),
    "coupled_fast": ("CoupledModel", dict(fast=True)),
    "coupled_fast_full": ("CoupledModel", dict(fast=True, q_half=False)),
    "uncoupled": ("UnCoupledModel", {}),
    "ql": ("QLModel", {}),
    "ybj": ("YBJModel", {}),
    "qg": ("QGModel", {}),
}
WAVE_FIELDS = ("q", "phi", "Ke", "Pw", "Kw")
QG_FIELDS = ("q", "c", "Ke", "cvar")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, ic, name, **extra):
    """The configuration's model through ``pkg``: McWilliams q and a wave
    packet in phi (QG: a plane-wave scalar), tdiags=1."""
    mod, kw = CONFIGS[name]
    kw = dict(kw, **extra)
    common = dict(L=2 * np.pi * 200e3, nx=NX, dt=DT, tmax=DT * (N1 + N2),
                  use_filter=True, tdiags=1, twrite=1000)
    if mod == "QGModel":
        m = getattr(pkg, mod).Model(nu4=5e10, beta=1e-11, U=-0.05,
                                    passive_scalar=True, **common, **kw)
        k0 = 10 * (2 * np.pi / m.L)
        m.set_q(ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=21))
        m.set_c(np.real(np.asarray(ic.PlaneWave(m, k=k0, l=k0))) * 1e-2)
        return m
    m = getattr(pkg, mod).Model(m=1.0 / 325, N=0.005, f=1e-4, nu4=5e10,
                                nu4w=5e10, **common, **kw)
    m.set_q(ic.McWilliams1984(m, k0=6, E=2.5e-4, seed=22))
    m.set_phi(np.asarray(ic.WavePacket(m, k=2 * np.pi / m.L * 4, R=m.L / 6,
                                       x0=m.L / 2, y0=m.L / 2)) * 0.05)
    return m


def _steps(m, n):
    """``n`` steps with the diagnostics cadence (both packages' per-step
    loop)."""
    for _ in range(n):
        m._step_forward()


def _snap(m):
    fields = QG_FIELDS if hasattr(m, "cvar") else WAVE_FIELDS
    out = {k: np.asarray(getattr(m, k)) for k in fields}
    out["tc"] = m.tc
    out["diags"] = {k: np.asarray(v["value"])
                    for k, v in m.diagnostics.items()}
    out["get_diagnostic"] = {k: np.asarray(m.get_diagnostic(k))
                             for k in m.diagnostics}
    return out


def _layout(path):
    """Every group and dataset of an HDF5 file: name -> (shape, dtype,
    attrs), and the file's attrs."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(
            n, (getattr(o, "shape", None), str(getattr(o, "dtype", "")),
                dict(o.attrs))))
        out["/"] = {k: str(v) for k, v in f.attrs.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per configuration, computed on first use: JAX's uninterrupted run
    (checkpoint after N1 steps), the port's (the same), the port resuming
    its own file and JAX's, and JAX resuming the port's."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        d = tmp_path_factory.mktemp(name)
        fj, ft = str(d / "jax.h5"), str(d / "port.h5")
        r = {"fj": fj, "ft": ft}
        j = _build(jpkg, jic, name)
        _steps(j, N1)
        j.save_checkpoint(fj)
        _steps(j, N2)
        r["jax"] = _snap(j)
        t = _build(tpkg, tic, name, device="cpu")
        _steps(t, N1)
        t.save_checkpoint(ft)
        _steps(t, N2)
        r["port"] = _snap(t)
        b = _build(tpkg, tic, name, device="cpu")
        b.load_checkpoint(ft)
        r["port_from_port_tc"] = b.tc
        b.run()
        r["port_from_port"] = _snap(b)
        b.load_checkpoint(fj)
        r["port_from_jax_tc"] = b.tc
        b.run()
        r["port_from_jax"] = _snap(b)
        j.load_checkpoint(ft)  # the same kernel, so the same q-side layout
        _steps(j, N2)
        r["jax_from_port"] = _snap(j)
        cache[name] = r
        return r

    return get


def _hold(got, want, rtol, series_rtol):
    """Fields to ``rtol`` of their scale, every diagnostic series to
    ``series_rtol`` of its scale."""
    assert got["tc"] == want["tc"] == N1 + N2
    for k, v in want.items():
        if k in ("tc", "diags", "get_diagnostic"):
            continue
        assert _rel(got[k], v) <= rtol, k
    assert sorted(got["diags"]) == sorted(want["diags"])
    for k, v in want["diags"].items():
        assert got["diags"][k].shape == v.shape == (N1 + N2,), k
        err = np.abs(got["diags"][k] - v).max()
        assert err <= series_rtol * np.abs(v).max() + 1e-20, k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_resumes_jax_checkpoint(runs, name):
    """A JAX file after 5 steps, 5 more in the port: fields within 1e-12
    of JAX's uninterrupted 10 steps, the series within 1e-10 of their
    scale (the first 5 samples come from the file)."""
    r = runs(name)
    assert r["port_from_jax_tc"] == N1
    _hold(r["port_from_jax"], r["jax"], 1e-12, 1e-10)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_resumes_port_checkpoint(runs, name):
    """The reverse: the port's file after 5 steps, 5 more in JAX under the
    same kernel, within 1e-12 of JAX's uninterrupted run."""
    _hold(runs(name)["jax_from_port"], runs(name)["jax"], 1e-12, 1e-10)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_resumes_own_checkpoint_bitwise(runs, name):
    """The port's file resumes to the same bits as the uninterrupted run:
    fields, budgets, and every diagnostic series through both
    ``diagnostics`` and ``get_diagnostic`` (the file's stacked series
    followed by the new samples)."""
    r = runs(name)
    assert r["port_from_port_tc"] == N1
    got, want = r["port_from_port"], r["port"]
    assert got["tc"] == want["tc"] == N1 + N2
    for k, v in want.items():
        if isinstance(v, dict):
            assert sorted(got[k]) == sorted(v), k
            for name_, series in v.items():
                assert series.shape == (N1 + N2,), name_
                assert np.array_equal(got[k][name_], series), (k, name_)
        elif k != "tc":
            assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_checkpoint_file_holds_jax_datasets(runs, name):
    """The port's file has the JAX file's groups and datasets, with the
    same shapes, dtypes and kinds (``tc`` a 0-d int32, complex fields of
    the state as re/im groups and those of ``Derived`` as cpairs, no
    ``Derived.p`` where the kernel drops it) and the same attributes."""
    r = runs(name)
    assert _layout(r["ft"]) == _layout(r["fj"])
    assert _layout(r["ft"])["state/tc"][:2] == ((), "int32")


def test_port_tree_matches_jax_file_values(runs):
    """Both packages' files after 5 steps of the faithful CoupledModel
    hold the same values to 1e-12."""
    r = runs("coupled")
    a, b = read_checkpoint(r["ft"]), read_checkpoint(r["fj"])
    assert int(a["state"]["tc"]) == int(b["state"]["tc"]) == N1
    for k in ("qh", "phih"):
        assert _rel(a["state"][k], b["state"][k]) <= 1e-12, k
    for k, v in b["state"]["d"].items():
        assert _rel(a["state"]["d"][k], v) <= 1e-12, k
    assert a["model"] == b["model"] and int(a["nx"]) == int(b["nx"]) == NX


@pytest.mark.parametrize("src,dst", [("coupled", "coupled_fast"),
                                     ("coupled_fast", "coupled"),
                                     ("coupled_fast", "coupled_fast_full")])
def test_jax_checkpoint_changes_layout_in_the_port(runs, src, dst):
    """A JAX file of one kernel loads into another of the port's kernels
    through ``convert.state_from_numpy`` (the q side expanded or
    projected, ``Derived.p`` filled or dropped) and runs on: within 1e-10
    of JAX's uninterrupted run of the file's kernel (two kernels of the
    same physics, different rounding; ``test_convert_between_layouts``'s
    bound)."""
    r = runs(src)
    m = _build(tpkg, tic, dst, device="cpu")
    m.load_checkpoint(r["fj"])
    assert m.tc == N1
    assert (m.state.d.p is None) == m.kernel._drop_p
    m.run()
    got, want = _snap(m), r["jax"]
    for k in WAVE_FIELDS:
        assert _rel(got[k], want[k]) <= 1e-10, k


def test_extra_group_round_trips(tmp_path):
    """``extra=`` is written under ``extra/`` and read back."""
    from niwqg_tpu_torch.io import save_checkpoint

    m = _build(tpkg, tic, "qg", device="cpu")
    path = str(tmp_path / "x.h5")
    save_checkpoint(path, m, extra={"seed": 22, "note": np.arange(3.0)})
    tree = read_checkpoint(path)
    assert int(tree["extra"]["seed"]) == 22
    np.testing.assert_array_equal(tree["extra"]["note"], np.arange(3.0))
    assert "p" in tree["state"] and "d" not in tree["state"]
