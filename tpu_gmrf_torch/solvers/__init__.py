# The backends are imported on first use (module __getattr__), not here:
# the kernels' plain versions import `solvers.prefix`, and the backends
# import the kernels.
import importlib

from .base import DENSE_AUTO_MAX, SolverSpec, factorize
from .prefix import linear_recurrence, mobius_recurrence

_BACKENDS = {
    "DenseFactor": "dense", "dense_factorize": "dense",
    "TridiagFactor": "tridiag", "tridiag_factorize": "tridiag",
    "BandedFactor": "banded", "banded_factorize": "banded", "banded_plan": "banded",
    "SupernodalFactor": "supernodal", "supernodal_factorize": "supernodal", "supernodal_plan": "supernodal",
}

__all__ = ["SolverSpec", "factorize", "DENSE_AUTO_MAX", "linear_recurrence", "mobius_recurrence", *_BACKENDS]


def __getattr__(name):
    if name in _BACKENDS:
        return getattr(importlib.import_module(f".{_BACKENDS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
