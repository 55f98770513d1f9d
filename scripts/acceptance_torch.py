"""Production-size energy-budget acceptance of the PyTorch port.

The configurations of ``scripts/acceptance_r5.py`` (``build``: the coupled
Lamb dipole with a wave packet in phi, filter off so that the integrated
Ke/Kw/Pw budgets close exactly; ``build_qg``: QG with a passive scalar
blob), copied here because that file drives the JAX package. Each
invocation runs one leg through ``niwqg_tpu_torch`` and writes the same
npz layout (``rows``, ``nx``, ``dt``, ``dtype``, ``backend`` and the
endpoint fields), so that ``acceptance_r5.py compare`` (numpy only)
anchors an f32 leg against an f64 twin.

Each leg applies ``acceptance_r5.py``'s closure check: the worst relative
gap between the integrated budgets and the instantaneous energies, 5e-3
in f32 and 2e-5 in f64.

Usage (on the card; ``--device cpu`` on the host)::

  NIWQG_ACC_NX=2048 NIWQG_ACC_STEPS=300 python scripts/acceptance_torch.py \\
      run acceptance_mxu_leg.npz --backend mxu --dtype float32
  python scripts/acceptance_torch.py run acceptance_f64_leg.npz \\
      --backend native --dtype float64
  python scripts/acceptance_r5.py compare acceptance_mxu_leg.npz \\
      acceptance_f64_leg.npz

``--backend mxu`` with no ``--transform-opts`` is the matmul-DFT with the
JAX package's defaults (the configuration of its TPU leg); ``native`` is
cuFFT. ``NIWQG_ACC_NX``, ``NIWQG_ACC_STEPS``, ``NIWQG_ACC_CHUNK`` and
``NIWQG_ACC_CFL`` work as in ``acceptance_r5.py``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(nx, nsteps, **model_kw):
    """``acceptance_r5.build`` on the port."""
    from niwqg_tpu_torch import CoupledModel
    from niwqg_tpu_torch import InitialConditions as ic

    U0 = 0.05
    L = 2 * np.pi * 200e3
    k0 = 10 * (2 * np.pi / L)
    A = 5 * U0  # packet amplitude (the reference example's phi scale)
    dx = L / nx
    cfl_target = float(os.environ.get("NIWQG_ACC_CFL", "0.4"))
    dt = cfl_target * dx / A
    s = 128.0 / nx
    m = CoupledModel.Model(
        L=L, nx=nx, tmax=nsteps * dt, dt=dt, m=2 * np.pi / 280, N=0.01,
        f=1e-4, nu4=5e11 * s**3, nu4w=5e11 * s**3, nu=20.0 * s**2,
        nuw=50.0 * s**2, use_filter=False, U=-U0, tdiags=nsteps + 1,
        **model_kw)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    phi = np.asarray(ic.WavePacket(m, k=2 * k0, l=0, R=2 * np.pi / k0,
                                   x0=m.L / 2, y0=m.L / 2)) * A
    # phi first: set_q seeds the integrated Ke from an inversion with the
    # current phi (acceptance_r5.build)
    m.set_phi(phi)
    m.set_q(q)
    return m


def build_qg(nx, nsteps, **model_kw):
    """``acceptance_r5.build_qg`` on the port."""
    from niwqg_tpu_torch import InitialConditions as ic
    from niwqg_tpu_torch import QGModel

    U0 = 0.05
    L = 2 * np.pi * 200e3
    k0 = 10 * (2 * np.pi / L)
    dx = L / nx
    cfl_target = float(os.environ.get("NIWQG_ACC_CFL", "0.4"))
    dt = cfl_target * dx / U0
    s = 128.0 / nx
    m = QGModel.Model(
        L=L, nx=nx, dt=dt, tmax=nsteps * dt, beta=1e-11, use_filter=False,
        nu4=5e11 * s**3, nu=20.0 * s**2, passive_scalar=True,
        nu4c=5e11 * s**3, nuc=20.0 * s**2, U=-U0, tdiags=nsteps + 1,
        **model_kw)
    m.set_q(ic.LambDipole(m, U=U0, R=2 * np.pi / k0))
    x, y = m.x, m.y
    r2 = (x - m.L / 2) ** 2 + (y - m.L / 2) ** 2
    m.set_c(np.exp(-r2 / (2 * np.pi / k0) ** 2))
    return m


def _budgets(m, qg):
    """One row of the leg's table after a chunk, and its closure: the
    integrated budgets against the instantaneous energies (QG: each
    quantity to its own scale; coupled: to the largest energy)."""
    K, s = m.kernel, m.state
    if qg:
        ke_i, c2_i = float(K.ke_qg(s.ph)), float(K.spec_var(s.ch))
        Ke, cv = float(s.Ke), float(s.cvar)
        rel = max(abs(Ke - ke_i) / abs(ke_i), abs(cv - c2_i) / abs(c2_i))
        return (Ke, ke_i, cv, c2_i, rel), (
            f"Ke={Ke:.6e} (inst {ke_i:.6e}) cvar={cv:.6e} (C2 {c2_i:.6e})")
    ke_i = float(K.ke_qg(s.d.ph))
    kw_i = float(K.ke_niw(s.d.phi))
    pw_i = float(K.pe_niw(s.phih))
    Ke, Kw, Pw = float(s.Ke), float(s.Kw), float(s.Pw)
    scale = max(abs(ke_i), abs(kw_i), abs(pw_i))
    rel = max(abs(Ke - ke_i), abs(Kw - kw_i), abs(Pw - pw_i)) / scale
    return (Ke, ke_i, Kw, kw_i, Pw, pw_i, rel), (
        f"Ke={Ke:.6e} (inst {ke_i:.6e}) Kw={Kw:.6e} (inst {kw_i:.6e}) "
        f"Pw={Pw:.6e} (inst {pw_i:.6e})")


def run_leg(out_path, qg, backend, dtype, device, transform_opts):
    import torch

    nx = int(os.environ.get("NIWQG_ACC_NX", "2048"))
    nsteps = int(os.environ.get("NIWQG_ACC_STEPS", "300"))
    chunk = min(int(os.environ.get("NIWQG_ACC_CHUNK", "25")), nsteps)
    nsteps = (nsteps // chunk) * chunk  # whole chunks only
    label = "ACCEPTANCE(QG)" if qg else "ACCEPTANCE"

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t_build0 = time.time()
    m = (build_qg if qg else build)(
        nx, nsteps, backend=backend, dtype=np.dtype(dtype), device=device,
        transform_opts=transform_opts)
    sync()
    K = m.kernel
    where = m.device.type
    if where == "cuda":
        import subprocess
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    print(f"build: {time.time() - t_build0:.0f}s nx={nx} dt={m.dt:.1f}s "
          f"dtype={K.dtype} backend={backend} transform_opts="
          f"{transform_opts} model={'qg' if qg else 'coupled'} on {where}",
          flush=True)
    if backend == "mxu":
        from chip_smoke import resolved_options

        print(f"matmul-DFT: {resolved_options(K.tr)}", flush=True)

    rows = []
    t0 = time.time()
    t_first = None
    for i in range(nsteps // chunk):
        m.run_steps(chunk)
        row, text = _budgets(m, qg)  # the fetches synchronise
        step = (i + 1) * chunk
        rows.append((step,) + row)
        print(f"step {step:4d}: {text} closure={row[-1]:.2e} "
              f"[{time.time() - t0:.0f}s]", flush=True)
        if t_first is None:
            t_first = time.time()  # the first chunk holds the captures
        if not np.isfinite(row[-1]):
            print(f"NON-FINITE at step <= {step}", flush=True)
            break
    wall = time.time() - t0
    nsteady = max(0, len(rows) * chunk - chunk)
    sps = nsteady / (time.time() - t_first) if (t_first and nsteady) else 0.0
    print(f"{nx}^2 x {len(rows) * chunk} steps in {wall:.1f}s "
          f"(steady {sps:.2f} steps/s, budgets fetched every {chunk})",
          flush=True)
    assert int(m.tc) == len(rows) * chunk, (m.tc, len(rows), chunk)

    rows = np.asarray(rows)
    fields = ({"q": np.asarray(m.q, dtype=np.float64),
               "c": np.asarray(m.c, dtype=np.float64)} if qg else
              {"q": np.asarray(m.q, dtype=np.float64),
               "phi": np.asarray(m.phi, dtype=np.complex128)})
    np.savez_compressed(out_path, rows=rows, nx=nx, dt=float(m.dt),
                        dtype=str(K.dtype),
                        backend=f"{m.device.type}:{backend}", **fields)
    print(f"wrote {out_path}", flush=True)
    if not len(rows):
        print(f"{label}: FAIL (no steps run)")
        return 1
    worst = (float(np.max(rows[:, -1])) if np.all(np.isfinite(rows[:, -1]))
             else float("nan"))
    tol = 5e-3 if K.dtype == np.float32 else 2e-5
    ok = (bool(np.isfinite(worst)) and worst < tol
          and len(rows) * chunk >= nsteps)
    print(f"worst closure over {len(rows) * chunk} steps: {worst:.2e} "
          f"(tol {tol:.0e})")
    print(f"{label}:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("run", "run-qg"))
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("--backend", choices=("mxu", "native"), default="mxu")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--transform-opts", default="{}",
                    help="the model's transform_opts, as JSON")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the host; default the first card")
    args = ap.parse_args(argv)
    qg = args.mode == "run-qg"
    out = args.out or ("acceptance_qg_leg.npz" if qg
                       else "acceptance_leg.npz")
    sys.path.insert(0, ROOT)
    # the ETDRK4 tables are built, not cached: write only the npz
    os.environ.setdefault("NIWQG_TORCH_TABLE_CACHE", "0")
    return run_leg(out, qg, args.backend, args.dtype, args.device,
                   json.loads(args.transform_opts) or None)


if __name__ == "__main__":
    sys.exit(main())
