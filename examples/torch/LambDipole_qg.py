"""Lamb dipole in the standalone barotropic QG model with a passive scalar,
on the PyTorch port (``niwqg_tpu_torch``; the reference's
``examples/LambDipole_qg.py``).

Run, on the card or on the host:
  python examples/torch/LambDipole_qg.py
  python examples/torch/LambDipole_qg.py --device cpu --nx 64 --steps 400
"""

import argparse
import os
import sys
import timeit

start = timeit.default_timer()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from niwqg_tpu_torch import InitialConditions as ic  # noqa: E402
from niwqg_tpu_torch import QGModel as Model  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="'cpu' for the host; default: the first CUDA card")
ap.add_argument("--nx", type=int, default=128)
ap.add_argument("--steps", type=int, default=None,
                help="steps to run; default: the reference's tmax, 300 Te")
args = ap.parse_args()

# parameters
nx = args.nx
L = 2 * np.pi * 200e3
k0 = 10 * (2 * np.pi / L)

U = 1.0e-1
Te = (U * k0) ** -1

dt = 0.05 * Te
tmax = 300 * Te if args.steps is None else (args.steps - 0.5) * dt

m = Model.Model(
    L=L, nx=nx, tmax=tmax, dt=dt, twrite=500,
    nu4=5e11, use_filter=True, U=-U, tdiags=10,
    passive_scalar=True, save_to_disk=False, device=args.device,
)

q = ic.LambDipole(m, U=U, R=2 * np.pi / k0)
c = np.real(ic.PlaneWave(m, k=k0, l=k0)) * np.abs(q).max()

m.set_q(q)
m.set_c(c)
var0 = np.var(m.c)
m.run()

time = m.diagnostics["time"]["value"]
KE = m.diagnostics["ke_qg"]["value"]
C2 = m.diagnostics["C2"]["value"]
cvar = m.diagnostics["cvar"]["value"]

stop = timeit.default_timer()
print("Time elapsed: %3.2f seconds" % (stop - start))
print("KE: %.3e -> %.3e" % (KE[0], KE[-1]))
print("tracer variance closure max rel err:",
      np.abs(C2 - cvar).max() / np.abs(C2).max())
print("variance of c: %.6e by spec_var(ch), %.6e by np.var(c)"
      % (m.spec_var(m.ch), np.var(m.c)))
print("variance of c: %.6e at the start, %.6e after %d steps"
      % (var0, np.var(m.c), m.tc))
