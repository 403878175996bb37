"""Distribution substrate of the port (``repro.distributed``):
logical-axis sharding rules, the active mesh, and sharded storage on a
lane mesh."""
from . import sharding
from .sharding import (
    constrain, param_pspecs, param_shardings, resolve, use_mesh,
)

__all__ = ["sharding", "constrain", "param_pspecs", "param_shardings",
           "resolve", "use_mesh"]
