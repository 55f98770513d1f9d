"""Import-parity shim: ``from niwqg_tpu_torch import YBJModel; YBJModel.Model``."""
from .api import YBJModel as Model  # noqa: F401
