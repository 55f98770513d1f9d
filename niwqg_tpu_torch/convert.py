"""Carry a model state between the JAX package and this port.

The JAX package's ``WaveState`` read out as numpy (``jax.tree.map
(np.asarray, state)``: the same named fields, complex fields as ``re``/``im``
pairs, the dropped streamfunction as ``None``) goes into
:func:`state_from_numpy`; :func:`state_to_numpy` gives the port's state
back as a dict of numpy arrays (complex fields as complex arrays) in the
same field layout. Tables are rebuilt from the parameters by the kernel,
so the state is the only thing carried.

Both the full-spectrum q side and the fast kernel's ``q_half`` layout are
taken; a q-side spectrum in the other layout than the kernel's is
converted (Hermitian expansion or projection).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.kernel import Derived, WaveKernel, WaveState
from .ops.spectral import expand_half_to_full, project_full_to_half

_Q_SIDE = ("qh", "ph", "qwh")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _host_complex(x):
    """A complex numpy array from a complex array or a re/im pair."""
    if hasattr(x, "re") and hasattr(x, "im"):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.array(x)


def state_from_numpy(kernel: WaveKernel, s) -> WaveState:
    """A port ``WaveState`` for ``kernel`` from a numpy-valued state."""
    dev, rd, cd = kernel.device, kernel.rdtype, kernel.cdtype
    half = getattr(kernel, "q_half", False)
    nk_half = kernel.params.nx // 2 + 1

    def real(x):
        return torch.as_tensor(np.array(x)).to(device=dev, dtype=rd)

    def cplx(x, q_side=False):
        z = torch.as_tensor(_host_complex(x)).to(device=dev, dtype=cd)
        if q_side and half and z.shape[-1] != nk_half:
            z = project_full_to_half(z)
        elif q_side and not half and z.shape[-1] == nk_half:
            z = expand_half_to_full(z)
        return z

    d = _get(s, "d")
    fields = {}
    for name in Derived._fields:
        v = _get(d, name)
        if name == "p" and (v is None or kernel._drop_p):
            fields[name] = None if kernel._drop_p else kernel._inv_real(
                fields["ph"])
        elif name in ("ph", "qwh", "phi", "phix", "phiy"):
            fields[name] = cplx(v, q_side=name in _Q_SIDE)
        else:
            fields[name] = real(v)
    return WaveState(t=real(_get(s, "t")), tc=int(np.asarray(_get(s, "tc"))),
                     qh=cplx(_get(s, "qh"), q_side=True),
                     phih=cplx(_get(s, "phih")), d=Derived(**fields),
                     Ke=real(_get(s, "Ke")), Pw=real(_get(s, "Pw")),
                     Kw=real(_get(s, "Kw")))


def state_to_numpy(s: WaveState) -> dict:
    """The port's state as numpy: ``{"t", "tc", "qh", "phih", "Ke", "Pw",
    "Kw", "d": {Derived field: array or None}}``."""
    def host(x):
        return None if x is None else x.detach().cpu().numpy()

    return {"t": host(s.t), "tc": int(s.tc), "qh": host(s.qh),
            "phih": host(s.phih), "Ke": host(s.Ke), "Pw": host(s.Pw),
            "Kw": host(s.Kw),
            "d": {k: host(getattr(s.d, k)) for k in Derived._fields}}
