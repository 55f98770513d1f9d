"""The PyTorch port's output layer, run loop and host helpers against the
JAX package: the files of ``save_to_disk`` (``setup.h5``, the snapshots in
both formats, ``diagnostics.h5``), the ``Saver``'s guards and its two
departures from JAX, ``run_with_snapshots``' times, the import without
h5py, ``fft``/``ifft``/``spec_var``/``isotropic_spectrum``, the profiling
helpers and the ported restart example. Inputs come from a numpy seed, in
f64 unless stated, at nx=16-32."""

import glob
import logging
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402  (the JAX package runs on the CPU, x64)

import niwqg_tpu as jpkg  # noqa: E402
import niwqg_tpu_torch as tpkg  # noqa: E402
from niwqg_tpu import InitialConditions as jic  # noqa: E402
from niwqg_tpu.utils import profiling as jprofiling  # noqa: E402
from niwqg_tpu.utils.spectrum import spectrum_2d as jspectrum_2d  # noqa: E402
from niwqg_tpu_torch import InitialConditions as tic  # noqa: E402
from niwqg_tpu_torch.io_native import AsyncSnapshotWriter, available  # noqa: E402
from niwqg_tpu_torch.utils import profiling  # noqa: E402
from niwqg_tpu_torch.utils.spectrum import spectrum_2d  # noqa: E402

from _torch_common import rel as _rel  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 10000.0
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ (the native writer's compiler) "
                                      "is not installed")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(pkg, ic, mod, nx=32, nsteps=4, dt=DT, **kw):
    """A small run of ``mod`` through ``pkg``: a Lamb dipole, a constant
    phi (QG: a plane-wave scalar), no filter."""
    U0 = 0.05
    kw = dict(dict(nx=nx, use_filter=False, U=-U0, tmax=nsteps * dt, dt=dt,
                   twrite=1000), **kw)
    if mod == "QGModel":
        kw["passive_scalar"] = True
    m = getattr(pkg, mod).Model(**kw)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    if mod == "QGModel":
        m.set_c(np.real(np.asarray(ic.PlaneWave(m, k=k0, l=k0))) * 1e-2)
    else:
        m.set_phi((np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2))
    return m


def _h5_items(path):
    """name -> array of every dataset of an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
    return out


def _same(a, b, rtol):
    """The same dataset names, shapes and dtypes; values within ``rtol``
    of each dataset's scale."""
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        x, y = np.asarray(a[k]), np.asarray(v)
        assert (x.shape, x.dtype) == (y.shape, y.dtype), k
        assert np.abs(x - y).max(initial=0.0) \
            <= rtol * np.abs(y).max(initial=0.0) + 1e-300, k


# ----------------------------------------------------------------------
# the files of save_to_disk
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod,fmt", [
    ("CoupledModel", "h5"),
    pytest.param("CoupledModel", "npy-async", marks=needs_gxx),
    ("QGModel", "h5")])
def test_output_files_match_jax(tmp_path, mod, fmt):
    """``run()`` with ``save_to_disk`` (4 steps, a snapshot every 2, a
    diagnostics sample every step): both packages write the same files,
    holding the same datasets with the same shapes and dtypes; the values
    agree to 1e-12 of each dataset's scale, the diagnostic series to 1e-10
    (a series that is a difference of near-equal terms, such as
    ``ike_niw = ke_niw - cke_niw``, keeps fewer digits: 5e-12 here)."""
    kw = dict(save_to_disk=True, tsave_snapshots=2, tdiags=1)
    if mod != "QGModel":
        kw["snapshot_format"] = fmt
    out = {}
    for name, pkg, ic, extra in (("jax", jpkg, jic, {}),
                                 ("port", tpkg, tic, {"device": "cpu"})):
        path = str(tmp_path / name)
        m = _build(pkg, ic, mod, path=path, **kw, **extra)
        m.run()
        m.saver.drain()
        out[name] = path
    j, t = out["jax"], out["port"]
    names = lambda p: sorted(os.listdir(os.path.join(p, "snapshots")))
    assert names(t) == names(j)
    want = (["000000000000000", "000000000020000", "000000000040000"])
    if fmt == "h5":
        assert names(t) == [s + ".h5" for s in want]
        for f in names(j):
            _same(_h5_items(os.path.join(t, "snapshots", f)),
                  _h5_items(os.path.join(j, "snapshots", f)), 1e-12)
    else:
        assert names(t) == sorted(f"{s}.{f}.npy" for s in want
                                  for f in ("t", "q", "phi"))
        for f in names(j):
            _same({"x": np.load(os.path.join(t, "snapshots", f))},
                  {"x": np.load(os.path.join(j, "snapshots", f))}, 1e-12)
    for f, rtol in (("setup.h5", 1e-12), ("diagnostics.h5", 1e-10)):
        _same(_h5_items(os.path.join(t, f)), _h5_items(os.path.join(j, f)),
              rtol)


@pytest.mark.parametrize("mod", ["CoupledModel", "UnCoupledModel", "QLModel",
                                 "YBJModel", "QGModel"])
def test_every_model_saves_to_disk(tmp_path, mod):
    """``save_to_disk=True`` on each of the five models: ``run()`` writes
    ``setup.h5``, a snapshot of JAX's fields (``_snapshot_fields``) every
    ``tsave_snapshots`` steps and ``diagnostics.h5`` with every series."""
    m = _build(tpkg, tic, mod, nx=16, nsteps=2, device="cpu",
               save_to_disk=True, path=str(tmp_path), tsave_snapshots=1,
               tdiags=1)
    m.run()
    scalar = {"passive_scalar": True} if mod == "QGModel" else {}
    fields = getattr(jpkg, mod).Model(nx=16, **scalar)._snapshot_fields()
    assert m._snapshot_fields() == fields
    snaps = sorted(os.listdir(tmp_path / "snapshots"))
    assert snaps == ["000000000000000.h5", "000000000010000.h5",
                     "000000000020000.h5"]
    last = _h5_items(str(tmp_path / "snapshots" / snaps[-1]))
    assert sorted(last) == sorted(fields)
    np.testing.assert_array_equal(last["q"], m.q)
    diags = _h5_items(str(tmp_path / "diagnostics.h5"))
    assert sorted(diags) == sorted(m.diagnostics)
    assert all(v.shape == (2,) for v in diags.values())
    assert os.path.exists(tmp_path / "setup.h5")


def test_overwrite_false_raises(tmp_path):
    """A second model on the same path with ``overwrite=False`` meets
    ``setup.h5`` and raises ``IOError``, as in JAX."""
    kw = dict(device="cpu", save_to_disk=True, path=str(tmp_path))
    tpkg.QGModel.Model(nx=16, **kw)
    assert os.path.exists(tmp_path / "setup.h5")
    with pytest.raises(IOError, match="File exists"):
        tpkg.QGModel.Model(nx=16, overwrite=False, **kw)
    with pytest.raises(ValueError, match="snapshot_format"):
        tpkg.CoupledModel.Model(nx=16, snapshot_format="npz", **kw)


def test_stem_repeat_warns(tmp_path, caplog):
    """Snapshots less than one time unit apart share a file stem: the
    Saver warns that it overwrites."""
    m = tpkg.QGModel.Model(nx=16, dt=0.25, tmax=1.0, tsave_snapshots=1,
                           device="cpu", save_to_disk=True,
                           path=str(tmp_path))
    m.set_q(np.zeros((16, 16)))
    with caplog.at_level(logging.WARNING, logger="niwqg_tpu_torch.io"):
        m.run()
    assert "snapshot stem 000000000000000 repeats" in caplog.text
    assert sorted(os.listdir(tmp_path / "snapshots")) == [
        "000000000000000.h5", "000000000000001.h5"]


@needs_gxx
def test_async_writer_round_trip(tmp_path):
    """Arrays through the native writer come back bitwise, and the writer
    was built into the port's own ``_build/``."""
    from niwqg_tpu_torch import io_native

    assert available()
    assert os.path.exists(io_native.library_path())
    assert os.path.dirname(io_native.library_path()) == os.path.join(
        ROOT, "niwqg_tpu_torch", "_build")
    w = AsyncSnapshotWriter()
    rng = np.random.default_rng(3)
    arrays = {f"a{i}": rng.standard_normal((32, 32)) for i in range(4)}
    arrays["z"] = (rng.standard_normal((8, 8))
                   + 1j * rng.standard_normal((8, 8))).astype(np.complex64)
    for name, a in arrays.items():
        w.submit_npy(str(tmp_path / f"{name}.npy"), a)
    w.drain()
    assert w.errors() == 0 and w.pending() == 0
    for name, a in arrays.items():
        back = np.load(tmp_path / f"{name}.npy")
        assert back.dtype == a.dtype and np.array_equal(back, a)
    w.close()


@needs_gxx
def test_drain_raises_each_failure_once(tmp_path):
    """Departure from JAX: ``Saver.drain`` raises only failures it has not
    raised before (JAX re-raises the cumulative count on every drain)."""
    m = _build(tpkg, tic, "CoupledModel", nx=16, device="cpu",
               save_to_disk=True, path=str(tmp_path / "out"),
               snapshot_format="npy-async")
    shutil.rmtree(tmp_path / "out" / "snapshots")  # every write now fails
    m.saver.save_snapshot(m, ["t", "q", "phi"])
    with pytest.raises(IOError, match="^3 async snapshot write"):
        m.saver.drain()
    m.saver.drain()  # nothing new: no error
    m.saver.save_snapshot(m, ["q"])
    with pytest.raises(IOError, match="^1 async snapshot write"):
        m.saver.drain()


@needs_gxx
def test_run_with_snapshots_keeps_the_propagating_error(tmp_path, caplog):
    """Departure from JAX: the generator's final drain does not mask an
    exception already propagating (here the CFL guard; JAX's ``finally``
    drain would raise its ``IOError`` over it). The writer's failure is
    logged instead."""
    m = _build(tpkg, tic, "CoupledModel", nx=16, device="cpu",
               save_to_disk=True, path=str(tmp_path / "out"),
               snapshot_format="npy-async", dt=1e7, twrite=2,
               tsave_snapshots=1)
    shutil.rmtree(tmp_path / "out" / "snapshots")
    with caplog.at_level(logging.ERROR, logger="niwqg_tpu_torch.io"):
        with pytest.raises(AssertionError, match="CFL"):
            for _ in m.run_with_snapshots(tsnapint=1e7):
                pass
    assert "async snapshot write(s) failed" in caplog.text
    assert m.tc == 2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_run_with_snapshots_times_match_jax(dtype):
    """``tsnapint`` that ``dt`` does not divide and ``tsnapstart > 0``:
    the port yields JAX's times, in f32 and f64 (the model dtype's
    ``t += dt`` rounding), and stops at JAX's step."""
    dt = 1000.3
    kw = dict(nx=16, dt=dt, tmax=12.5 * dt, dtype=dtype, tdiags=1000)
    runs = {}
    for name, pkg, extra in (("jax", jpkg, {}),
                             ("port", tpkg, {"device": "cpu"})):
        m = pkg.QGModel.Model(passive_scalar=False, **kw, **extra)
        m.set_q(np.zeros((16, 16)))
        runs[name] = (list(m.run_with_snapshots(tsnapstart=3.5 * dt,
                                                tsnapint=2.5 * dt)), m.tc)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == 13 and len(runs["port"][0]) == 3


def test_run_with_snapshots_on_the_wave_models():
    """Every model has the generator; a wave model yields at the same
    counters as QG, from ``t == tsnapstart`` on."""
    m = _build(tpkg, tic, "UnCoupledModel", nx=16, nsteps=6, device="cpu")
    ts = m.run_with_snapshots(tsnapstart=2 * DT, tsnapint=2 * DT)
    assert [round(t / DT) for t in ts] == [2, 4, 6]


def test_k1_launches_per_diagnostics_sample_match_jax(monkeypatch):
    """A diagnostics sample of the coupled model in the K1 configuration
    (nx=256, f32) makes as many K1 contractions in the port as JAX traces
    through its Pallas kernel: ``chip_smoke.K1_PER_DIAG``, which phase 9
    holds the card to on top of the 40 a step."""
    from niwqg_tpu.ops import pallas_mm
    from niwqg_tpu_torch.ops import csplit_mm

    from chip_smoke import K1_PER_DIAG
    from _torch_common import K1_OPTS

    kw = dict(nx=256, backend="mxu", dtype=np.float32, precision="split")
    t = _build(tpkg, tic, "CoupledModel", device="cpu",
               transform_opts=K1_OPTS, **kw)
    counter = csplit_mm.FAMILY
    calls0 = counter.plain_calls()
    t._diag_fn(t.state, t.state.t)
    traced = []
    orig = pallas_mm.csplit_matmul

    def counting(*a, **k):
        traced.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(pallas_mm, "csplit_matmul", counting)
    j = jpkg.CoupledModel.Model(
        transform_opts=dict(K1_OPTS, pallas_interpret=True), **kw)
    jax.make_jaxpr(j._diag_fn)(j.kernel.zero_state(), 0.0)
    assert counter.plain_calls() - calls0 == len(traced) == K1_PER_DIAG


def test_imports_and_runs_without_h5py():
    """With h5py hidden the port imports and steps, ``save_to_disk=True``
    raises an ``ImportError`` that names h5py, and neither JAX nor the JAX
    package is loaded."""
    code = """
import sys
sys.modules["h5py"] = None
import numpy as np
import niwqg_tpu_torch
from niwqg_tpu_torch import CoupledModel, io
m = CoupledModel.Model(nx=16, device="cpu")
m.set_q(np.zeros((16, 16))); m.set_phi(np.ones((16, 16)) * 0.1 + 0j)
m.run_steps(2)
tree = io.checkpoint_tree(m)
io.restore_tree(CoupledModel.Model(nx=16, device="cpu"), tree)
assert m.tc == 2
try:
    CoupledModel.Model(nx=16, device="cpu", save_to_disk=True,
                       path=sys.argv[1])
except ImportError as exc:
    assert "h5py" in str(exc), exc
else:
    raise SystemExit("save_to_disk did not raise")
bad = [k for k in sys.modules if k.split(".")[0] in
       ("jax", "jaxlib", "niwqg_tpu")]
assert not bad, bad
print("OK")
"""
    out = os.path.join(ROOT, "output_noh5py_unused")
    res = subprocess.run([sys.executable, "-c", code, out],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0 and "OK" in res.stdout, \
        res.stdout + res.stderr
    assert not os.path.exists(out)


@needs_gxx
def test_npy_snapshots_without_h5py(tmp_path):
    """With h5py hidden an ``io.Saver`` with ``npy-async`` snapshots alone
    (what the card's smoke phase 9 drives) takes the step loop's
    snapshots: the files hold the live fields bitwise, and only
    ``save_setup`` asks for h5py."""
    code = """
import os, sys
sys.modules["h5py"] = None
import numpy as np
from niwqg_tpu_torch import CoupledModel, io
out = sys.argv[1]
m = CoupledModel.Model(nx=16, device="cpu", tsave_snapshots=2,
                       tmax=4 * 10000.0)
m.set_q(np.random.default_rng(3).standard_normal((16, 16)) * 1e-6)
m.set_phi(np.ones((16, 16)) * 0.1 + 0j)
m.saver = io.Saver(out, True, snapshot_format="npy-async")
assert list(m.run_with_snapshots(tsnapint=2 * 10000.0)) == [20000.0, 40000.0]
stem = "{:015.0f}".format(m.t)
for name in ("q", "phi"):
    snap = np.load(os.path.join(out, "snapshots", f"{stem}.{name}.npy"))
    assert np.array_equal(snap, getattr(m, name)), name
assert len(os.listdir(os.path.join(out, "snapshots"))) == 6
try:
    m.saver.save_setup(m)
except ImportError as exc:
    assert "h5py" in str(exc), exc
else:
    raise SystemExit("save_setup did not raise")
print("OK")
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert res.returncode == 0 and "OK" in res.stdout, \
        res.stdout + res.stderr


# ----------------------------------------------------------------------
# host helpers and utilities
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mod", ["CoupledModel", "QGModel"])
def test_host_helpers_match_jax(mod):
    """``fft``, ``ifft``, ``spec_var`` and ``isotropic_spectrum`` of the
    full-spectrum Coupled and the half-spectrum QG model, and
    ``spectrum_2d``, equal JAX's to 1e-12 on seeded fields."""
    j = getattr(jpkg, mod).Model(nx=32, use_filter=False)
    t = getattr(tpkg, mod).Model(nx=32, use_filter=False, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 32))
    xh_t, xh_j = t.fft(x), j.fft(x)
    assert xh_t.shape == xh_j.shape == ((32, 17) if mod == "QGModel"
                                        else (32, 32))
    assert _rel(xh_t, xh_j) <= 1e-12
    assert _rel(t.ifft(xh_t), j.ifft(xh_j)) <= 1e-12
    assert _rel(np.real(t.ifft(xh_t)), x) <= 1e-12
    assert abs(t.spec_var(xh_t) - j.spec_var(xh_j)) \
        <= 1e-12 * j.spec_var(xh_j)
    assert abs(t.spec_var(xh_t) - np.var(x)) <= 1e-12 * np.var(x)
    st, sj = t.isotropic_spectrum(x), j.isotropic_spectrum(x)
    for k in ("spec", "ispec", "ki", "kx", "ky"):
        assert _rel(getattr(st, k), getattr(sj, k)) <= 1e-12, k
    z = x + 1j * rng.standard_normal((32, 32))
    a, b = spectrum_2d(z, 0.5, 0.25), jspectrum_2d(z, 0.5, 0.25)
    for k in ("spec", "ispec", "ki", "kx", "ky"):
        assert _rel(getattr(a, k), getattr(b, k)) <= 1e-12, k


def test_isotropic_spectrum_of_a_field_name():
    """A field's name reads the model attribute: the peak of a plane wave
    at 3 k0."""
    m = tpkg.CoupledModel.Model(nx=32, use_filter=False, device="cpu")
    k0 = 2 * np.pi / m.L * 2
    m.set_q(np.real(tic.PlaneWave(m, k=3 * k0, l=0)))
    sp = m.isotropic_spectrum("q")
    assert abs(sp.ki[np.argmax(sp.ispec)] / k0 - 3.0) < 0.2
    assert m.get_field("t") == 0.0
    np.testing.assert_array_equal(m.get_field("q"), m.q)


def test_step_timer_has_jax_keys():
    t, j = profiling.StepTimer(64), jprofiling.StepTimer(64)
    for timer in (t, j):
        for _ in range(3):
            with timer:
                sum(range(1000))
    assert sorted(t.summary()) == sorted(j.summary())
    assert t.steps == 3 and t.summary()["grid_point_steps_per_s"] > 0
    assert profiling.StepTimer(64).summary() == {}


def test_trace_writes_a_file(tmp_path):
    m = tpkg.QGModel.Model(nx=16, device="cpu")
    m.set_q(np.zeros((16, 16)))
    with profiling.trace(str(tmp_path)):
        m.run_steps(1)
    files = glob.glob(str(tmp_path / "*.json"))
    assert files and os.path.getsize(files[0]) > 0


def test_restart_example_runs():
    """``examples/torch/Restart.py`` on the host reaches its bitwise
    asserts."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch",
                                      "Restart.py"),
         "--device", "cpu", "--nx", "32"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "resume is bit-exact" in res.stdout
