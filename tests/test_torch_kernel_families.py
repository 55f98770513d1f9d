"""The launch-and-count helper of the port's hand-written kernels
(``niwqg_tpu_torch/cuda_build.py``'s ``Family``), as each family declares
it: K1 (``ops/csplit_mm.py``), K2 (``parallel/a2a.py``), the fused derive
(``ops/derive_fused.py``), the fused stage epilogue
(``ops/stage_fused.py``) and the QG model's fused stage gaps
(``ops/qg_fused.py``).

On a host without a card each module's ``counts()`` returns its keys, all
0; one call of a plain version moves ``cpu_calls`` (and the family's count
of that plain version) by one and no launch counter; ``reset_counts()``
sets them to 0 again. This file imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import niwqg_tpu_torch as pkg  # noqa: E402
from niwqg_tpu_torch.ops import csplit_mm, derive_fused, qg_fused  # noqa: E402,E501
from niwqg_tpu_torch.ops import stage_fused  # noqa: E402
from niwqg_tpu_torch.parallel import a2a  # noqa: E402


def _k1():
    z = torch.ones((4, 4), dtype=torch.float32)
    csplit_mm.csplit_matmul(z, z, z, z, z, z)
    return "csplit_matmul"


def _k2():
    group = a2a.PeerGroup.local(["cpu", "cpu"])
    a2a.all_to_all_fwd([torch.zeros((2, 4), dtype=torch.complex64)] * 2,
                       group)
    return "fwd"


def _kernel():
    K = pkg.CoupledModel.Model(nx=16, fast=True, device="cpu").kernel
    qh = torch.zeros(K._qshape, dtype=K.cdtype)
    phih = torch.zeros(K.grid.spec_shape, dtype=K.cdtype)
    return K, qh, phih


def _derive(K, qh, phih):
    d = K.derive(qh, phih)

    def call():
        K._invert_core(qh, d.phi, d.phix, d.phiy)
        return "invert"
    return call


def _stage(K, qh, phih):
    d = K.derive(qh, phih)

    def call():
        K.nonlinear(qh, d)
        return "epilogue"
    return call


def _qg():
    K = pkg.QGModel.Model(nx=16, passive_scalar=True, device="cpu").kernel
    s = K.zero_state()

    def call():
        K._stage_rhs(s.ph, s.qh, s.ch)
        return "stage"
    return call


FAMILIES = {
    "k1": (csplit_mm, lambda: _k1,
           {"launches", "launches_tc", "launches_f32"}),
    "k2": (a2a, lambda: _k2,
           {f"{k}_{p}" for k in a2a.KINDS for p in a2a.PATHS}
           | set(a2a.KINDS)),
    "derive": (derive_fused, lambda: _derive(*_kernel()),
               set(derive_fused.KERNELS)),
    "stage": (stage_fused, lambda: _stage(*_kernel()),
              set(stage_fused.USES)),
    "qg": (qg_fused, _qg, set(qg_fused.USES)),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_counts_on_a_host_without_a_card(name):
    mod, setup, launches = FAMILIES[name]
    call = setup()  # whatever the set-up calls is not counted below
    mod.reset_counts()
    zero = dict.fromkeys(launches | {"cpu_calls"}, 0)
    assert mod.counts() == zero
    key = call()
    assert mod.counts() == dict(zero, cpu_calls=1)
    assert mod.FAMILY.plain_calls(key) == mod.FAMILY.plain_calls() == 1
    mod.reset_counts()
    assert mod.counts() == zero
    assert mod.FAMILY.plain_calls(key) == 0
