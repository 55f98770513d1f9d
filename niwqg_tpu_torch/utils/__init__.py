from . import spectrum  # noqa: F401
