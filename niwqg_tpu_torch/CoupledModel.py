"""Import-parity shim: ``from niwqg_tpu_torch import CoupledModel; CoupledModel.Model``."""
from .api import CoupledModel as Model  # noqa: F401
