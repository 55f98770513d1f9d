"""Laterally coherent near-inertial oscillation coupled with a Lamb dipole,
on the PyTorch port (``niwqg_tpu_torch``).

The reference's flagship example (``examples/LambDipole.py``): the same
physical setup through the reference-compatible API. Prints the
energy-budget closure residuals and the peak of the isotropic spectrum
of q (``isotropic_spectrum``, the replacement for the external
``pyspec``), and draws the budget figure when matplotlib is present.

Run, on the card or on the host:
  python examples/torch/LambDipole.py
  python examples/torch/LambDipole.py --device cpu --nx 64
"""

import argparse
import os
import sys
import timeit

start = timeit.default_timer()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from niwqg_tpu_torch import CoupledModel as Model  # noqa: E402
from niwqg_tpu_torch import InitialConditions as ic  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default=None,
                help="'cpu' for the host; default: the first CUDA card")
ap.add_argument("--nx", type=int, default=128)
args = ap.parse_args()

# parameters
nx = args.nx
f0 = 1.0e-4
N = 0.01
L = 2 * np.pi * 200e3
lamz = 280
mz = 2 * np.pi / lamz

# eddy parameters
k0 = 10 * (2 * np.pi / L)

# initial conditions
U = 1.0e-1
phi0 = 2 * U
U0 = U
u0 = phi0

# simulation parameters
Te = (U0 * k0) ** -1  # eddy turn-over time scale
Tf = 2 * np.pi / f0

dt = 0.025 * Te
tmax = 10 * Te
m = Model.Model(
    L=L, nx=nx, tmax=tmax, dt=dt,
    m=mz, N=N, f=f0, twrite=int(1 * Tf / dt),
    nu4=5e11, nu4w=0e10, nu=20, nuw=50e0, mu=0.0, muw=0.0,
    use_filter=False, U=-U, tdiags=1, save_to_disk=False, dealias=False,
    device=args.device,
)

q = ic.LambDipole(m, U=U, R=2 * np.pi / k0)
phi = (np.ones_like(q) + 1j) * u0 / np.sqrt(2)

m.set_q(q)
m.set_phi(phi)
m.run()

# diagnostics
time = m.diagnostics["time"]["value"]
KE_qg = m.diagnostics["ke_qg"]["value"]
PE_niw = m.diagnostics["pe_niw"]["value"]
KE_niw = m.diagnostics["ke_niw"]["value"]
ENS_qg = m.diagnostics["ens"]["value"]
g1 = m.diagnostics["gamma_r"]["value"]
g2 = m.diagnostics["gamma_a"]["value"]
x1 = m.diagnostics["xi_r"]["value"]
x2 = m.diagnostics["xi_a"]["value"]
ep_psi = m.diagnostics["ep_psi"]["value"]
chi_phi = m.diagnostics["chi_phi"]["value"]

dts = time[1] - time[0]
dPE = np.gradient(PE_niw, dts)
dKE = np.gradient(KE_qg, dts)

res_ke = dKE - (-g1 - g2 + x1 + x2 + ep_psi)
res_pe = dPE - g1 - g2 - chi_phi

spec = m.isotropic_spectrum("q")
stop = timeit.default_timer()
print("Time elapsed: %3.2f seconds" % (stop - start))
print("max |KE budget residual| / KE0:", np.abs(res_ke).max() / KE_qg[0])
print("max |PE budget residual| / KE0:", np.abs(res_pe).max() / KE_qg[0])
print("isotropic spectrum of q peaks at k/k0 = %.2f"
      % (spec.ki[np.argmax(spec.ispec)] / k0))

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    plt = None
if plt is not None:
    fig = plt.figure(figsize=(16, 9))
    lw, alp = 3.0, 0.5
    KE0 = KE_qg[0]

    ax = fig.add_subplot(221)
    ax.plot(time / Te, KE_qg / KE0, label="KE QG", linewidth=lw, alpha=alp)
    ax.plot(time / Te, KE_niw / KE_niw[0], label="KE NIW", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, ENS_qg / ENS_qg[0], label="ENS QG", linewidth=lw,
            alpha=alp)
    ax.set_ylabel(r"$E/E_0$, $Z/Z_0$")
    ax.legend(loc=3)

    ax = fig.add_subplot(222)
    ax.plot(time / Te, (KE_qg - KE0) / KE0, label="KE QG", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, (PE_niw - PE_niw[0]) / KE0, label="PE NIW",
            linewidth=lw, alpha=alp)
    ax.plot(time / Te, (KE_niw - KE_niw[0]) / KE0, label="KE NIW",
            linewidth=lw, alpha=alp)
    ax.legend(loc=3)

    ax = fig.add_subplot(223)
    ax.plot(time / Te, Te * g1 / KE0, label=r"$\Gamma_r$", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, Te * g2 / KE0, label=r"$\Gamma_a$", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, Te * chi_phi / KE0, label=r"$\chi_\phi$",
            linewidth=lw, alpha=alp)
    ax.plot(time / Te, Te * dPE / KE0, "k--", label=r"$\dot P_w$",
            linewidth=lw, alpha=alp)
    ax.legend(loc=1, ncol=2)
    ax.set_xlabel(r"$t\,U_0 k_0$")

    ax = fig.add_subplot(224)
    ax.plot(time / Te, -Te * g1 / KE0, label=r"$-\Gamma_r$", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, -Te * g2 / KE0, label=r"$-\Gamma_a$", linewidth=lw,
            alpha=alp)
    ax.plot(time / Te, Te * ep_psi / KE0, label=r"$\epsilon_\psi$",
            linewidth=lw, alpha=alp)
    ax.plot(time / Te, Te * dKE / KE0, "k--", label=r"$\dot K_e$",
            linewidth=lw, alpha=alp)
    ax.set_xlabel(r"$t\,U_0 k_0$")
    ax.legend(loc=4)

    fig.savefig("energy_budget.png", dpi=100)
    print("wrote energy_budget.png")
