"""GMRF distribution core.

Counterpart of ``tpu_gmrf.gmrf``. A `GMRF` holds (mean, sparse precision Q,
factorization); the factorization is computed at construction and reused by
every statistic. A batch of B GMRFs over one pattern has Q.data (B, nnz) and
mean (n,) or (B, n); statistics then return one value per chain.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .solvers.base import SolverSpec, factorize
from .sparse.matrix import SparseMatrix

__all__ = ["GMRF"]

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class GMRF:
    """Gaussian with sparse precision: x ~ N(mean, Q⁻¹)."""

    mean: torch.Tensor  # (n,) or (B, n)
    Q: SparseMatrix
    factor: object  # backend factorization (TridiagFactor)
    solver: SolverSpec = SolverSpec()

    # ---- construction ------------------------------------------------------

    @staticmethod
    def from_precision(mean, Q: SparseMatrix, solver: SolverSpec = SolverSpec()) -> "GMRF":
        mean = torch.as_tensor(mean, dtype=Q.dtype, device=Q.device)
        return GMRF(mean=mean, Q=Q, factor=factorize(Q, solver), solver=solver)

    # ---- distribution interface -------------------------------------------

    def __len__(self):
        return self.Q.shape[0]

    @property
    def n(self):
        return self.Q.shape[0]

    @property
    def dtype(self):
        return self.Q.data.dtype

    def precision_matrix(self) -> SparseMatrix:
        return self.Q

    def information_vector(self) -> torch.Tensor:
        return self.Q.matvec(self.mean)

    def logdet_precision(self) -> torch.Tensor:
        return self.factor.logdet()

    def logdetcov(self) -> torch.Tensor:
        return -self.factor.logdet()

    def sqmahal(self, x: torch.Tensor) -> torch.Tensor:
        return self.Q.quad(x - self.mean)

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * (self.n * _LOG2PI - self.factor.logdet() + self.sqmahal(x))

    def gradlogpdf(self, x: torch.Tensor) -> torch.Tensor:
        return -self.Q.matvec(x - self.mean)

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        """x = μ + L⁻ᵀ z, z ~ N(0, I): shape (*shape, *batch, n)."""
        batch = tuple(self.factor.batch_shape)
        z = torch.randn(
            (*shape, *batch, self.n), generator=generator, dtype=self.dtype, device=self.Q.device
        )
        k = math.prod(shape)
        zk = z.reshape((k, *batch, self.n)).movedim(0, -1)  # (*batch, n, k)
        with torch.no_grad():
            x = self.factor.backward_solve(zk.contiguous())
        return self.mean + x.movedim(-1, 0).reshape(z.shape)

    def var(self) -> torch.Tensor:
        return self.factor.selinv_diag()

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var())

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        return self.factor.solve(b)

    def cov(self):
        raise NotImplementedError(
            "dense covariance deliberately unavailable (reference src/gmrf.jl:90); "
            "use var()/std()/selinv"
        )
