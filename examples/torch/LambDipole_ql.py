"""Quasilinear NIW-QG: a wave packet on a Lamb dipole, QLModel, on the
PyTorch port (``niwqg_tpu_torch``; the JAX package's
``examples/LambDipole_ql.py``).

The reference ships ``niwqg/QLModel.py`` unconstructible, so it has no
example. This runs the port's QLModel in both modes:

  - default: the intended quasilinear physics (waves advected by the
    vortex flow only; the reference's ``1j`` wave-PV transcription bug
    corrected);
  - ``faithful_quirks=True``: the repaired reference reproduced bug for
    bug.

Run, on the card or on the host:
  python examples/torch/LambDipole_ql.py
  python examples/torch/LambDipole_ql.py --device cpu --nx 64
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from niwqg_tpu_torch import InitialConditions as ic  # noqa: E402
from niwqg_tpu_torch import QLModel  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="'cpu' for the host; default: the first CUDA card")
ap.add_argument("--nx", type=int, default=128)
args = ap.parse_args()

U0 = 0.05
dt = 1000.0   # CFL-safe for the O(1 m/s) wave packet (dx ~ 3.9 km at 128)
nsteps = 50

runs = {}
for faithful in (False, True):
    m = QLModel.Model(nx=args.nx, use_filter=False, U=-U0, tdiags=5,
                      tmax=nsteps * dt, dt=dt, twrite=25,
                      faithful_quirks=faithful, save_to_disk=False,
                      device=args.device)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    # scale the unit-amplitude packet to wave speeds comparable with the
    # dipole flow so neither component dominates the dynamics
    phi = 2 * U0 * np.asarray(ic.WavePacket(m, k=2 * k0, l=0,
                                            R=2 * np.pi / k0,
                                            x0=m.L / 2, y0=m.L / 2))
    m.set_q(q)
    m.set_phi(phi)
    m.run()
    runs[faithful] = m
    label = "faithful (repaired reference)" if faithful else "intended"
    print(f"QL [{label}]: Ke={m.Ke:.6e}  Kw={m.Kw:.6e}  Pw={m.Pw:.3e}")

a, b = runs[False], runs[True]
d = np.abs(a.phih - b.phih).max()
print(f"max |phih_intended - phih_faithful| = {d:.3e} "
      f"(the quirks are dynamically significant)")
ke = a.diagnostics["ke_qg"]["value"]
print(f"intended-mode ke_qg series ({len(ke)} samples): "
      f"{ke[0]:.4e} -> {ke[-1]:.4e}, finite={np.all(np.isfinite(ke))}")
