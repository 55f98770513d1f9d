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
converted (Hermitian expansion or projection). The same two functions
carry every wave model's state (Coupled, UnCoupled, QL — whose q side is
always full-spectrum — and YBJ with its frozen flow fields) and the QG
model's ``QGState`` (half-spectrum ``qh``/``ch``/``ph``; pass a
``QGKernel``).

On a mesh the numpy side stays global: :func:`state_from_numpy` cuts the
global state to this rank's shards (every rank is handed the same global
arrays), and :func:`state_to_numpy` with ``mesh=`` gathers the shards, a
collective that every rank calls.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.kernel import Derived, WaveState
from .models.qg import QGKernel, QGState
from .ops.spectral import expand_half_to_full, project_full_to_half
from .parallel.mesh import gather_wave_state, map_state, shard_wave_state

_Q_SIDE = ("qh", "ph", "qwh")


def _get(obj, name, optional=False):
    """``obj[name]`` of a dict (None for a missing ``optional`` key, as an
    empty slot that a checkpoint file does not hold), else the attribute."""
    if isinstance(obj, dict):
        return obj.get(name) if optional else obj[name]
    return getattr(obj, name)


def _host_complex(x):
    """A complex numpy array from a complex array or a re/im pair."""
    if hasattr(x, "re") and hasattr(x, "im"):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.array(x)


def _qg_state_from_numpy(kernel: QGKernel, s) -> QGState:
    dev, rd, cd = kernel.device, kernel.rdtype, kernel.cdtype
    fields = {}
    for name in QGState._fields:
        v = _get(s, name)
        if name == "tc":
            fields[name] = int(np.asarray(v))
        elif name in ("qh", "ch", "ph"):
            fields[name] = torch.as_tensor(_host_complex(v)).to(dev, cd)
        else:
            fields[name] = torch.as_tensor(np.array(v)).to(dev, rd)
    return QGState(**fields)


def state_from_numpy(kernel, s):
    """A port state for ``kernel`` (a ``WaveState``, or a ``QGState`` for
    a ``QGKernel``) from a numpy-valued state."""
    if isinstance(kernel, QGKernel):
        return _qg_state_from_numpy(kernel, s)
    dev, rd, cd = kernel.device, kernel.rdtype, kernel.cdtype
    half = getattr(kernel, "q_half", False)
    nk_half = kernel.params.nx // 2 + 1

    def real(x):
        return torch.as_tensor(np.array(x)).to(rd)

    def cplx(x, q_side=False):
        z = torch.as_tensor(_host_complex(x)).to(cd)
        if q_side and half and z.shape[-1] != nk_half:
            z = project_full_to_half(z)
        elif q_side and not half and z.shape[-1] == nk_half:
            z = expand_half_to_full(z)
        return z

    d = _get(s, "d")
    fields = {}
    for name in Derived._fields:
        v = _get(d, name, optional=name == "p")
        if name == "p":
            fields[name] = None if v is None or kernel._drop_p else real(v)
        elif name in ("ph", "qwh", "phi", "phix", "phiy"):
            fields[name] = cplx(v, q_side=name in _Q_SIDE)
        else:
            fields[name] = real(v)
    # the global state on the host, cut to this rank's shards, to the device
    state = WaveState(t=real(_get(s, "t")), tc=int(np.asarray(_get(s, "tc"))),
                      qh=cplx(_get(s, "qh"), q_side=True),
                      phih=cplx(_get(s, "phih")), d=Derived(**fields),
                      Ke=real(_get(s, "Ke")), Pw=real(_get(s, "Pw")),
                      Kw=real(_get(s, "Kw")))
    state = shard_wave_state(state, kernel.mesh)
    to_dev = lambda x: x.to(dev)
    state = map_state(state, to_dev, to_dev)._replace(
        t=to_dev(state.t), Ke=to_dev(state.Ke), Pw=to_dev(state.Pw),
        Kw=to_dev(state.Kw))
    if state.d.p is None and not kernel._drop_p:
        state = state._replace(
            d=state.d._replace(p=kernel._inv_real(state.d.ph)))
    return state


def state_to_numpy(s, mesh=None) -> dict:
    """The port's state as numpy: ``{"t", "tc", "qh", "phih", "Ke", "Pw",
    "Kw", "d": {Derived field: array or None}}``, with ``mesh=`` the
    global state gathered from every rank's shards; a ``QGState`` gives
    ``{field: array}`` with ``tc`` an int. The arrays are copies, also of
    a state on the host: later steps cannot change them."""
    def host(x):
        return None if x is None else x.detach().to("cpu", copy=True).numpy()

    if isinstance(s, QGState):
        return {k: (int(v) if k == "tc" else host(v))
                for k, v in s._asdict().items()}
    s = gather_wave_state(s, mesh)

    return {"t": host(s.t), "tc": int(s.tc), "qh": host(s.qh),
            "phih": host(s.phih), "Ke": host(s.Ke), "Pw": host(s.Pw),
            "Kw": host(s.Kw),
            "d": {k: host(getattr(s.d, k)) for k in Derived._fields}}
