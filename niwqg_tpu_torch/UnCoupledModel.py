"""Import-parity shim: ``from niwqg_tpu_torch import UnCoupledModel; UnCoupledModel.Model``."""
from .api import UnCoupledModel as Model  # noqa: F401
