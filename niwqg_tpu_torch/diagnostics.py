"""Scalar diagnostics registry (port of ``niwqg_tpu/diagnostics.py``).

The registry maps names to metadata plus a function
``fn(kernel, state, aux) -> scalar tensor``; every active function of a
model is evaluated together and appended to host-side series. Users see
the reference's ``model.diagnostics[name]['value']`` dict of dicts. Every
function reduces through its kernel's mesh-aware sums and means, so on a
mesh every rank appends the same global values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch


@dataclasses.dataclass
class Diagnostic:
    description: str
    units: str
    types: str = "scalar"
    active: bool = True
    function: Callable = None


class Registry:
    def __init__(self):
        self.entries: Dict[str, Diagnostic] = {}

    def add(self, name: str, description=None, units=None, types="scalar",
            function=None):
        if not callable(function):
            raise TypeError(f"diagnostic {name!r} needs a callable function")
        self.entries[name] = Diagnostic(description, units, types, True,
                                        function)

    def names(self):
        return list(self.entries.keys())

    def evaluate(self, kernel, state, aux) -> Dict[str, Any]:
        """Evaluate every active diagnostic; returns a dict of 0-d
        tensors."""
        return {
            name: d.function(kernel, state, aux)
            for name, d in self.entries.items()
            if d.active
        }

    def describe(self) -> str:
        lines = ["NAME               | DESCRIPTION", 80 * "-"]
        for k in sorted(self.entries):
            lines.append(f"{k:<18} | {self.entries[k].description}")
        return "\n".join(lines)

    def set_active(self, names):
        """Keep only ``names`` active."""
        for name, d in self.entries.items():
            d.active = name in names


class SeriesAccumulator:
    """Host-side growing series, one per diagnostic. ``fetches`` counts
    the transfers from the device: one per :meth:`append` and one per
    :meth:`append_rows`, whatever its number of samples."""

    def __init__(self, registry: Registry):
        self.registry = registry
        self.series: Dict[str, list] = {k: [] for k in registry.entries}
        self.fetches = 0

    def append(self, values: Dict[str, Any]):
        """Append one sample of each value; tensors are fetched from the
        device in one transfer."""
        names = list(values)
        self.append_rows(names, torch.stack(
            [torch.as_tensor(values[k]).reshape(()) for k in names])[None])

    def append_rows(self, names, rows: torch.Tensor):
        """Append the samples of a ``(samples, len(names))`` tensor, column
        ``j`` to the series of ``names[j]``, fetched in one transfer; the
        series come out as :meth:`append` builds them, one sample at a
        time."""
        host = rows.cpu().numpy()
        self.fetches += 1
        for row in host:
            for k, v in zip(names, row):
                self.series[k].append(np.asarray(v))

    def as_reference_dict(self) -> Dict[str, dict]:
        """Reference-compatible ``model.diagnostics`` structure."""
        out = {}
        for name, d in self.registry.entries.items():
            vals = self.series[name]
            out[name] = {
                "description": d.description,
                "units": d.units,
                "active": d.active,
                "count": len(vals),
                "type": d.types,
                "value": np.hstack(vals) if vals else np.array([]),
            }
        return out


# ----------------------------------------------------------------------
# wave-kernel diagnostics
# ----------------------------------------------------------------------
def wave_kernel_registry() -> Registry:
    r = Registry()
    add = r.add
    add("time", "Time", "seconds",
        function=lambda K, s, aux: aux["time"])
    add("Ke", "Quasigeostrophic Kinetic Energy, from energy equation",
        r"m^2 s^{-2}", function=lambda K, s, aux: s.Ke)
    add("Pw", "NIW Potential Energy, from energy equation", r"m^2 s^{-2}",
        function=lambda K, s, aux: s.Pw)
    add("Kw", "NIW Kinetic Energy, from energy equation", r"m^2 s^{-2}",
        function=lambda K, s, aux: s.Kw)
    add("ke_qg", "Quasigeostrophic Kinetic Energy", r"m^2 s^{-2}",
        function=lambda K, s, aux: K.ke_qg(s.d.ph))
    add("ens", "Quasigeostrophic Potential Enstrophy", r"s^{-2}",
        function=lambda K, s, aux: K.ens(s.d.q))
    add("ke_niw", "Near-inertial Kinetic Energy", r"m^2 s^{-2}",
        function=lambda K, s, aux: K.ke_niw(s.d.phi))
    add("cke_niw", "Kinetic Energy of Laterally Coherent Near-Inertial Waves",
        r"m^2 s^{-2}", function=lambda K, s, aux: K.cke_niw(s.d.phi))
    add("ike_niw", "Kinetic Energy of Laterally Incoherent Near-Inertial Waves",
        r"m^2 s^{-2}",
        function=lambda K, s, aux: K.ke_niw(s.d.phi) - K.cke_niw(s.d.phi))
    add("pe_niw", "Near-inertial Potential Energy", r"m^2 s^{-2}",
        function=lambda K, s, aux: K.pe_niw(s.phih))
    add("conc_niw", "Correlation between relative vorticity and near-inertial KE",
        "unitless", function=lambda K, s, aux: K.conc_niw(s.d.phi, s.d.q_psi))
    add("skew", "Skewness", "unitless",
        function=lambda K, s, aux: K.skewness(s.d.q_psi))
    add("gamma_r", "The energy conversion due to refraction", r"$m^2 s^{-3}$",
        function=lambda K, s, aux: aux["src"].gamma1)
    add("gamma_a", "The energy conversion due to advection", r"$m^2 s^{-3}$",
        function=lambda K, s, aux: aux["src"].gamma2)
    add("xi_r", "The QG energy generation due to wave dissipation, vorticity",
        r"$m^2 s^{-3}$", function=lambda K, s, aux: aux["src"].xi1)
    add("xi_a", "The QG energy generation due to wave dissipation, advection",
        r"$m^2 s^{-3}$", function=lambda K, s, aux: aux["src"].xi2)
    add("pi", "The NIW kinetic energy conversion from coherent to incoherent",
        r"$m^2 s^{-3}$", function=lambda K, s, aux: aux["src"].pi)
    add("ep_phi", "The hyperviscous dissipation of NIW kinetic energy",
        r"$m^2 s^{-3}$", function=lambda K, s, aux: aux["src"].ep_phi)
    add("ep_psi", "The hyperviscous dissipation of QG kinetic energy",
        r"$m^2 s^{-3}$", function=lambda K, s, aux: aux["src"].ep_psi)
    add("chi_q", "The hyperviscous dissipation of QG kinetic energy",
        r"$s^{-3}$", function=lambda K, s, aux: K.chi_q(s.qh))
    add("chi_phi", "The hyperviscous dissipation of NIW potential energy",
        r"$s^{-3}$", function=lambda K, s, aux: aux["src"].chi_phi)
    return r


def coupled_registry() -> Registry:
    """Kernel diagnostics + CoupledModel KE decomposition."""
    r = wave_kernel_registry()
    r.add("ke_qg_q", "Quasigeostrophic Kinetic Energy, q-flow", r"m^2 s^{-2}",
          function=lambda K, s, aux: aux["ke_qg_q"])
    r.add("ke_qg_w", "Quasigeostrophic Kinetic Energy, w-flow", r"m^2 s^{-2}",
          function=lambda K, s, aux: aux["ke_qg_w"])
    r.add("ke_qg_qw", "Quasigeostrophic Kinetic Energy, cross-term q-w",
          r"m^2 s^{-2}", function=lambda K, s, aux: aux["ke_qg_qw"])
    return r


# ----------------------------------------------------------------------
# QG-model diagnostics
# ----------------------------------------------------------------------
def qg_registry() -> Registry:
    r = Registry()
    add = r.add
    add("time", "Time", "seconds", function=lambda K, s, aux: aux["time"])
    add("ke_qg", "Quasigeostrophic Kinetic Energy", r"m^2 s^{-2}",
        function=lambda K, s, aux: K.ke_qg(s.ph))
    add("Ke", "Quasigeostrophic Kinetic Energy, from energy equation",
        r"m^2 s^{-2}", function=lambda K, s, aux: s.Ke)
    add("ens", "Quasigeostrophic Potential Enstrophy", r"s^{-2}",
        function=lambda K, s, aux: K.ens(s.q))
    add("ep_psi", "The hyperviscous dissipation of QG kinetic energy",
        r"$m^2 s^{-3}$",
        function=lambda K, s, aux: K.ep_psi(s.q, s.p, s.qh, s.ph))
    add("chi_q", "The hyperviscous dissipation of QG kinetic energy",
        r"$s^{-3}$", function=lambda K, s, aux: K.chi_q(s.qh))
    add("C2", "Passive tracer variance", r"[scalar]^2",
        function=lambda K, s, aux: aux["C2"])
    add("cvar", "Passive tracer variance, from variance equation",
        r"[scalar]^2", function=lambda K, s, aux: s.cvar)
    add("gradC2", "Gradient of Passive tracer variance", r"[scalar]^2 / m^2",
        function=lambda K, s, aux: aux["gradC2"])
    add("Gamma_c", "Rate of generation of passive tracer gradient variance",
        r"[scalar]^2 / (m^2 s)", function=lambda K, s, aux: aux["Gamma_c"])
    add("ep_c", "The dissipation of tracer variance", r"$s^{-3}$",
        function=lambda K, s, aux: aux["ep_c"])
    add("chi_c", "The dissipation of tracer gradient variance", r"$s^{-3}$",
        function=lambda K, s, aux: aux["chi_c"])
    return r
