"""Faults planted in the program for the tests (``Job.prepare`` runs one
in every rank before the model is built): each run must come out not
correct."""

import torch


def step_unchanged():
    """A step that returns its state unchanged (the clock advances)."""
    from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel

    def step(self, s):
        return s._replace(t=s.t + self._dt, tc=s.tc + 1)

    FastWaveKernel.step = step


def answer_altered():
    """Every step's q altered where it is produced: one coefficient of
    the new state's spectrum moved by 1% of the spectrum's largest."""
    from niwqg_tpu_torch.models.fast_kernel import FastWaveKernel

    orig = FastWaveKernel.step

    def step(self, s):
        out = orig(self, s)
        qh = out.qh.clone()
        qh[1, 1] += 0.01 * qh.abs().max()
        return out._replace(qh=qh)

    FastWaveKernel.step = step


def exchange_left_out():
    """The exchange between ranks left out: every K2 call on the host
    gets nothing from its peers (their blocks read as zeros)."""
    from niwqg_tpu_torch.parallel import a2a

    def exchange(fn, ref, kind, z, group, chunks, check):
        mesh = group.mesh
        blocks = [z if r == mesh.rank else torch.zeros_like(z)
                  for r in range(mesh.nP)]
        return ref(blocks)[mesh.rank]

    a2a._exchange = exchange
