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

__all__ = ["GMRF", "logpdf", "sample", "gradlogpdf", "information_vector"]

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class GMRF:
    """Gaussian with sparse precision: x ~ N(mean, Q⁻¹)."""

    mean: torch.Tensor  # (n,) or (B, n)
    Q: SparseMatrix
    factor: object  # backend factorization (TridiagFactor, SupernodalFactor, CGFactor, ...)
    solver: SolverSpec = SolverSpec()

    # ---- construction ------------------------------------------------------

    @staticmethod
    def from_precision(mean, Q: SparseMatrix, solver: SolverSpec = SolverSpec()) -> "GMRF":
        mean = torch.as_tensor(mean, dtype=Q.dtype, device=Q.device)
        return GMRF(mean=mean, Q=Q, factor=factorize(Q, solver), solver=solver)

    @staticmethod
    def from_information(info, Q: SparseMatrix, solver: SolverSpec = SolverSpec()) -> "GMRF":
        """Construct from the information vector b = Qμ — solves Qμ = b once
        (reference `InformationVector` constructor, src/gmrf.jl:144-156); the
        mean carries the gradient to Q and the information vector."""
        factor = factorize(Q, solver)
        info = torch.as_tensor(info, dtype=Q.dtype, device=Q.device)
        mean = factor.solve(info)
        return GMRF(mean=mean, Q=Q, factor=factor, solver=solver)

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
        """x = μ + L⁻ᵀ z, z ~ N(0, I): shape (*shape, *batch, n). L⁻ᵀz has no
        backward: this raises while a gradient is asked of Q."""
        batch = tuple(self.factor.batch_shape)
        z = torch.randn(
            (*shape, *batch, self.n), generator=generator, dtype=self.dtype, device=self.Q.device
        )
        k = math.prod(shape)
        zk = z.reshape((k, *batch, self.n)).movedim(0, -1)  # (*batch, n, k)
        x = self.factor.backward_solve(zk.contiguous())
        return self.mean + x.movedim(-1, 0).reshape(z.shape)

    def var(self) -> torch.Tensor:
        """diag Q⁻¹; no backward: raises while a gradient is asked of Q."""
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

    # ---- elementary arithmetic (reference src/arithmetic/elementary.jl) ----

    def __add__(self, v):
        """Shift by a deterministic vector: (x + v) ~ N(μ + v, Q⁻¹)."""
        return dataclasses.replace(self, mean=self.mean + torch.as_tensor(v, dtype=self.dtype, device=self.Q.device))

    __radd__ = __add__

    def __sub__(self, v):
        return dataclasses.replace(self, mean=self.mean - torch.as_tensor(v, dtype=self.dtype, device=self.Q.device))


# Functional aliases


def logpdf(g: GMRF, x) -> torch.Tensor:
    return g.logpdf(x)


def gradlogpdf(g: GMRF, x) -> torch.Tensor:
    return g.gradlogpdf(x)


def sample(generator: torch.Generator, g: GMRF, shape: tuple = ()) -> torch.Tensor:
    return g.sample(generator, shape)


def information_vector(g: GMRF) -> torch.Tensor:
    return g.information_vector()
