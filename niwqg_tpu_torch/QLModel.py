"""Import-parity shim: ``from niwqg_tpu_torch import QLModel; QLModel.Model``."""
from .api import QLModel as Model  # noqa: F401
