"""Hard linear equality constraints via conditioning-by-Kriging.

Counterpart of ``tpu_gmrf.constrained``. `ConstrainedGMRF` represents
x | Ax = e for x ~ N(μ, Q⁻¹), with the Rue & Held (2005, §2.3.3) density
correction. The precomputations (Ãᵀ = Q⁻¹Aᵀ through the base factor's
solve, L_c = chol(A Ãᵀ), the constrained mean, the log correction) happen at
construction and are reused by every statistic. The m × m algebra is small
dense work, as the reference leaves it to XLA outside any kernel, and runs
on ``torch.linalg``.

A is a dense (m, n) matrix and e (m,), shared by every chain: no model's
constraints depend on θ. The base may be a batch of B GMRFs over one
pattern (Q data (B, nnz)); then Ãᵀ is (B, n, m) from one batched solve of
the m right-hand sides, L_c (B, m, m), the constrained mean (B, n) and the
log correction (B,). The reference reaches that batch by ``vmap``.
"""

from __future__ import annotations

import dataclasses

import torch

from .gmrf import GMRF, _LOG2PI

__all__ = ["ConstrainedGMRF"]


def _cho_solve(L: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ r for r (..., m) and L (*batch, m, m), the batch axes broadcast."""
    L = L.expand(torch.broadcast_shapes(r.shape[:-1], L.shape[:-2]) + L.shape[-2:])
    return torch.cholesky_solve(r.expand(L.shape[:-1])[..., None], L)[..., 0]


def _times(M: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """M w for M (*batch, n, m) and w (..., m), the batch axes broadcast."""
    return (M @ w[..., None])[..., 0]


@dataclasses.dataclass(frozen=True)
class ConstrainedGMRF:
    """x | Ax = e for x ~ base. Degenerate on the constraint manifold."""

    base: GMRF
    A: torch.Tensor  # (m, n) dense constraint matrix
    e: torch.Tensor  # (m,)
    A_tilde_T: torch.Tensor  # (*batch, n, m) = Q⁻¹Aᵀ
    L_c: torch.Tensor  # (*batch, m, m) lower Cholesky of A Q⁻¹ Aᵀ
    constrained_mean: torch.Tensor  # (*batch, n)
    log_correction: torch.Tensor  # (*batch,)

    @staticmethod
    def create(base: GMRF, A, e) -> "ConstrainedGMRF":
        dev = base.Q.device
        A = torch.atleast_2d(torch.as_tensor(A, dtype=base.dtype, device=dev))
        e = torch.as_tensor(e, dtype=base.dtype, device=dev)
        m, n = A.shape
        if n != base.n or e.shape != (m,):
            raise ValueError(f"constraint shapes A{tuple(A.shape)}, e{tuple(e.shape)} incompatible with n={base.n}")
        batch = tuple(base.factor.batch_shape)
        A_tilde_T = base.factor.solve(A.T.expand(batch + (n, m)).contiguous())  # (*batch, n, m)
        AAt = A @ A_tilde_T  # (*batch, m, m), SPD
        L_c = torch.linalg.cholesky(AAt)
        mu = base.mean.expand(batch + (n,))
        resid = mu @ A.T - e
        w = _cho_solve(L_c, resid)
        mean_c = mu - _times(A_tilde_T, w)
        # Rue-Held §2.3.3: ½(m·log2π + logdet(AQ⁻¹Aᵀ) + residᵀ(AQ⁻¹Aᵀ)⁻¹resid)
        #                  − ½ logdet(AAᵀ)
        logdet_Lc = 2.0 * torch.sum(torch.log(torch.diagonal(L_c, dim1=-2, dim2=-1)), -1)
        quad = (resid * w).sum(-1)
        gram = A @ A.T
        logdet_gram = 2.0 * torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(gram))))
        log_corr = 0.5 * (m * _LOG2PI + logdet_Lc + quad) - 0.5 * logdet_gram
        return ConstrainedGMRF(base, A, e, A_tilde_T, L_c, mean_c, log_corr)

    # ---- distribution interface -------------------------------------------

    def __len__(self):
        return self.base.n

    @property
    def n(self):
        return self.base.n

    @property
    def mean(self):
        return self.constrained_mean

    @property
    def Q(self):
        """Precision of the *unconstrained* base (reference convention:
        src/arithmetic/constrained.jl `precision_map`)."""
        return self.base.Q

    @property
    def factor(self):
        return self.base.factor

    @property
    def n_constraints(self):
        return self.A.shape[0]

    def precision_matrix(self):
        return self.base.Q

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.logpdf(x) + self.log_correction

    def gradlogpdf(self, x: torch.Tensor) -> torch.Tensor:
        return self.base.gradlogpdf(x)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Kriging projection of points (..., n) onto the constraint manifold;
        the axes before n end with the chain axis of a batch."""
        return x - _times(self.A_tilde_T, _cho_solve(self.L_c, x @ self.A.T - self.e))

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> torch.Tensor:
        x = self.base.sample(generator, shape)
        return self.project(x)

    def var(self) -> torch.Tensor:
        """σ_c = σ_base − rowsums(B²), B = Ãᵀ L_c⁻ᵀ
        (reference src/arithmetic/constrained.jl:195-215)."""
        sigma = self.base.var()
        B_T = torch.linalg.solve_triangular(self.L_c, self.A_tilde_T.mT, upper=False)  # (*batch, m, n)
        corr = torch.sum(B_T * B_T, dim=-2)
        return torch.clamp_min(sigma - corr, 0.0)

    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var())

    def logdet_precision(self):
        return self.base.logdet_precision()

    def sqmahal(self, x):
        return self.base.sqmahal(x)
