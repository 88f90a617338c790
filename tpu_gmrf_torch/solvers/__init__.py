# The tridiagonal backend lives in `solvers.tridiag`; it is not imported
# here because the kernels' plain versions import `solvers.prefix`.
from .base import DENSE_AUTO_MAX, SolverSpec, factorize
from .prefix import linear_recurrence, mobius_recurrence

__all__ = ["SolverSpec", "factorize", "DENSE_AUTO_MAX", "linear_recurrence", "mobius_recurrence"]
