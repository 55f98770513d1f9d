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
``QGKernel``). A QG spectrum comes in either of two widths: the one-rank
layout's ``nx//2+1`` columns, or a mesh's, padded with zero columns to a
multiple of the mesh size (``PencilTransform.rfft_pad``; the JAX
package's sharded QG checkpoint holds that layout); it is cut or padded
to the loading kernel's. So is a wave model's ``q_half`` q side, which is
padded on the matmul-DFT's mesh (``parallel/mfft.py``). That provider's
padding is internal, as GSPMD's is in JAX: :func:`state_to_numpy` with
``nk=nx//2+1`` cuts it, so that the state leaves in JAX's layout.

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
from .parallel.mesh import (gather_qg_state, gather_wave_state,
                            map_qg_state, map_state, shard_qg_state,
                            shard_wave_state)

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
    g = kernel.grid
    nk_half = kernel.params.nx // 2 + 1
    fields = {}
    for name in QGState._fields:
        v = _get(s, name)
        if name == "tc":
            fields[name] = int(np.asarray(v))
        elif name in ("qh", "ch", "ph"):
            # either width in, the kernel's (padded on a mesh) out
            z = torch.as_tensor(_host_complex(v)).to(kernel.cdtype)
            z = z[..., :nk_half]
            fields[name] = torch.nn.functional.pad(z, (0, g.nk - nk_half))
        else:
            fields[name] = torch.as_tensor(np.array(v)).to(kernel.rdtype)
    # the global state on the host, cut to this rank's shards, to the device
    state = shard_qg_state(QGState(**fields), kernel.mesh)
    to_dev = lambda x: x.to(kernel.device)
    return map_qg_state(state, to_dev, to_dev)._replace(
        t=to_dev(state.t), Ke=to_dev(state.Ke), cvar=to_dev(state.cvar))


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

    nx = kernel.params.nx

    def cplx(x, q_side=False):
        z = torch.as_tensor(_host_complex(x)).to(cd)
        if q_side and half:
            if z.shape[-1] == nx:
                z = project_full_to_half(z)
            # either half width in, the kernel's (padded on a mesh) out
            z = torch.nn.functional.pad(z[..., :nk_half], (0, kernel.layout.pad))
        elif q_side and not half and z.shape[-1] != nx:
            z = expand_half_to_full(z[..., :nk_half])
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


def state_to_numpy(s, mesh=None, nk=None) -> dict:
    """The port's state as numpy: ``{"t", "tc", "qh", "phih", "Ke", "Pw",
    "Kw", "d": {Derived field: array or None}}``, with ``mesh=`` the
    global state gathered from every rank's shards; a ``QGState`` gives
    ``{field: array}`` with ``tc`` an int. Half spectra (QG's, a
    ``q_half`` q side) keep a mesh's padded columns, as JAX's pencil-mesh
    checkpoint holds them, unless ``nk`` cuts them to that many columns
    (the matmul-DFT's mesh, whose padding is internal as GSPMD's is in
    JAX). The arrays are copies, also of a state on the host: later steps
    cannot change them."""
    def host(x):
        return None if x is None else x.detach().to("cpu", copy=True).numpy()

    if isinstance(s, QGState):
        s = gather_qg_state(s, mesh)
        out = {k: (int(v) if k == "tc" else host(v))
               for k, v in s._asdict().items()}
        if nk is not None:
            out.update({k: out[k][..., :nk] for k in ("qh", "ch", "ph")})
        return out
    s = gather_wave_state(s, mesh)

    def q_side(x):
        x = host(x)
        # a half-spectrum q side is narrower than the full phi side
        if nk is not None and x.shape[-1] != s.phih.shape[-1]:
            x = x[..., :nk]
        return x

    return {"t": host(s.t), "tc": int(s.tc), "qh": q_side(s.qh),
            "phih": host(s.phih), "Ke": host(s.Ke), "Pw": host(s.Pw),
            "Kw": host(s.Kw),
            "d": {k: (q_side if k in _Q_SIDE else host)(getattr(s.d, k))
                  for k in Derived._fields}}
