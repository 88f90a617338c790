# The backends are imported on first use (module __getattr__), not here:
# the kernels' plain versions import `solvers.prefix`, and the backends
# import the kernels.
import importlib

from .base import DENSE_AUTO_MAX, CGFactor, SolverSpec, factorize
from .prefix import linear_recurrence, mobius_recurrence

_BACKENDS = {
    "DenseFactor": "dense", "dense_factorize": "dense",
    "TridiagFactor": "tridiag", "tridiag_factorize": "tridiag",
    "BandedFactor": "banded", "banded_factorize": "banded", "banded_plan": "banded",
    "SupernodalFactor": "supernodal", "supernodal_factorize": "supernodal", "supernodal_plan": "supernodal",
    "rbmc_var": "rbmc", "block_rbmc_var": "rbmc",
    "cg_solve": "cg", "jacobi_preconditioner": "cg", "block_jacobi_preconditioner": "cg",
    "temporal_block_gauss_seidel_preconditioner": "cg", "full_cholesky_preconditioner": "cg",
}

__all__ = ["SolverSpec", "factorize", "CGFactor", "DENSE_AUTO_MAX", "linear_recurrence", "mobius_recurrence", *_BACKENDS]


def __getattr__(name):
    if name in _BACKENDS:
        return getattr(importlib.import_module(f".{_BACKENDS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
