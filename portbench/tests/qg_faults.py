"""Faults planted in the QG model for the tests (``Job.prepare`` runs one
before the model is built): each changes what the program computes, so a
run with it must come out not correct."""

import dataclasses

import torch


def beta_dropped():
    """q's linear operator built without the beta term."""
    from niwqg_tpu_torch.models import qg

    operator = qg.linear_operator_q

    def without_beta(grid, U, nu4, nu, mu, beta=0.0):
        return operator(grid, U, nu4, nu, mu)

    qg.linear_operator_q = without_beta


def scalar_advection_dropped():
    """Every stage's ``J(psi, c)`` left out of the scalar's right-hand
    side."""
    from niwqg_tpu_torch.models.qg import QGKernel

    orig = QGKernel._stage_rhs

    def stage_rhs(self, ph, qh, ch):
        jac_q, jac_c, u, v = orig(self, ph, qh, ch)
        return jac_q, torch.zeros_like(jac_c), u, v

    QGKernel._stage_rhs = stage_rhs


def nu4c_for_nu4():
    """The kernel's hyperviscosity taken from the scalar's ``nu4c``."""
    from niwqg_tpu_torch.models.qg import QGKernel

    orig = QGKernel.__init__

    def init(self, params, *args, **kwargs):
        orig(self, dataclasses.replace(params, nu4=params.nu4c), *args,
             **kwargs)

    QGKernel.__init__ = init


def cvar_weights_uniform():
    """``cvar`` integrated with uniform weights, ``dt (c1 + c2 + c3 +
    c4) / 4``, in place of RK4's ``(1, 2, 2, 1) / 6``."""
    from niwqg_tpu_torch.models.qg import QGKernel

    step, source = QGKernel.step, QGKernel.ep_c_stage

    def uniform(self, s):
        sources = []
        self.ep_c_stage = lambda ch: sources.append(source(self, ch)) or \
            sources[-1]
        try:
            out = step(self, s)
        finally:
            del self.ep_c_stage
        return out._replace(cvar=s.cvar + self._dt * sum(sources) / 4.0)

    QGKernel.step = uniform
