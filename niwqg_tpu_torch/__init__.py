"""niwqg_tpu_torch — the NIW–QG pseudospectral framework on PyTorch and CUDA.

A port of ``niwqg_tpu`` (the JAX package, which stays the reference) to
PyTorch on an NVIDIA Hopper card: the Xie & Vanneste (2015) coupled model
of near-inertial waves on barotropic QG flow, its uncoupled, quasilinear
and YBJ variants, and the standalone QG(+passive scalar) model, on an
ETDRK4 pseudospectral core, with the matmul-DFT's complex-split product as
a hand-written CUDA kernel (``csrc/csplit_mm.cu``). Import-compatible with
the reference package layout::

    from niwqg_tpu_torch import CoupledModel
    m = CoupledModel.Model(L=2*np.pi*200e3, nx=512, ...)   # on the card
    m = CoupledModel.Model(..., device="cpu")              # on the host
    m.set_q(q); m.set_phi(phi); m.run()
"""

__version__ = "0.1.0"

from . import CoupledModel, QGModel, QLModel, UnCoupledModel, YBJModel
from . import diagnostics as Diagnostics
from . import initial_conditions as InitialConditions
from .grid import Grid
