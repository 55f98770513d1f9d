"""Import-parity shim: ``from niwqg_tpu_torch import QGModel; QGModel.Model``."""
from .api import QGModel as Model  # noqa: F401
