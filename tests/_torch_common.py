"""Shared by the test files that hold the PyTorch port's models against
the JAX package: the K1 configuration's transform options, the relative
difference they are held to, the flagship's physics, a JAX wave state
rebuilt from the port's numpy state, and the matmul-DFT's K1
configurations with a recorder of K1's calls in both packages."""

import jax.numpy as jnp
import numpy as np

from niwqg_tpu.carray import C
from niwqg_tpu.models import kernel as jkernel

K1_OPTS = dict(use_pallas=True, formulation="swap", factors=None,
               half_factors=None)


def rel(a, b):
    """Largest absolute difference over the largest magnitude of ``b``."""
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def flagship(mod, ic, nx, packet=False, **kw):
    """The flagship's physics (``__graft_entry__._build_coupled``): Lamb
    dipole q and a constant phi, through either package's ``mod.Model``.
    ``packet`` adds ``chip_smoke.flagship``'s wave packet to phi, so that
    the wave gradients are not zero."""
    U0 = 0.05
    m = mod.Model(L=2 * np.pi * 200e3, nx=nx, dt=157.0, tmax=157.0 * 100,
                  m=1.0 / 325, N=0.005, f=1e-4, use_filter=True, nu4=7.5e9,
                  nu4w=7.5e9, **kw)
    k0 = 10 * (2 * np.pi / m.L)
    q = ic.LambDipole(m, U=U0, R=2 * np.pi / k0)
    m.set_q(q)
    phi = (np.ones_like(q) + 1j) * 5 * U0 / np.sqrt(2)
    if packet:
        phi = phi + 5 * U0 * ic.WavePacket(m, k=2 * k0, l=k0, R=m.L / 6,
                                           x0=m.L / 2, y0=m.L / 2)
    m.set_phi(phi)
    return m


def jax_wave_state(d):
    """A JAX ``WaveState`` from ``niwqg_tpu_torch.convert.state_to_numpy``'s
    dict."""
    def leaf(v):
        if v is None:
            return None
        return C.from_complex(v) if np.iscomplexobj(v) else jnp.asarray(v)

    return jkernel.WaveState(
        t=jnp.asarray(d["t"]), tc=jnp.asarray(d["tc"], jnp.int32),
        qh=leaf(d["qh"]), phih=leaf(d["phih"]),
        d=jkernel.Derived(**{k: leaf(v) for k, v in d["d"].items()}),
        Ke=jnp.asarray(d["Ke"]), Pw=jnp.asarray(d["Pw"]),
        Kw=jnp.asarray(d["Kw"]))


# K1's configurations of the matmul-DFT at nx=512 in f32 ('split',
# use_pallas): JAX's dotgen default with dense passes, then with the
# even/odd real path over a dense half-length DFT (K = N = nx/2), dotgen
# and swap
K1_CONFIGS = {
    "dotgen-dense": dict(formulation="dotgen", factors=None,
                         half_factors=None),
    "dotgen-evenodd": dict(formulation="dotgen", factors=None,
                           half_factors=None, evenodd=True),
    "swap-evenodd": dict(formulation="swap", factors=None,
                         half_factors=None, evenodd=True),
}
K1_NX = 512


def record_k1_calls(monkeypatch):
    """Record the shapes (rows, K) of JAX's traced Pallas calls and of the
    port's K1 calls while a test runs; returns the two lists."""
    from niwqg_tpu.ops import pallas_mm
    from niwqg_tpu_torch.ops import fft as tfft

    jax_calls, port_calls = [], []
    jorig = pallas_mm.csplit_matmul
    torig = tfft.csplit_matmul_prepared

    def jcount(*a, **k):
        jax_calls.append(tuple(a[0].shape))
        return jorig(*a, **k)

    def tcount(ar, ai, b):
        port_calls.append(tuple(ar.shape))
        return torig(ar, ai, b)

    monkeypatch.setattr(pallas_mm, "csplit_matmul", jcount)
    monkeypatch.setattr(tfft, "csplit_matmul_prepared", tcount)
    return jax_calls, port_calls
