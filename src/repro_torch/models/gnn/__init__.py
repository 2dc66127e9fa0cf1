from . import nequip, sampler  # noqa: F401
