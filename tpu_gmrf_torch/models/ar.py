"""Stationary autoregressive latent models.

Counterpart of ``tpu_gmrf.models.ar``. AR(1) builds the tridiagonal
precision τ·tridiag(1, 1+ρ², …, 1+ρ², 1; −ρ) directly; with τ and ρ of
shape (B,) it returns B precisions over one pattern. AR(P≥2) needs the
sparse product L ᵀ D L and the dense backend, neither ported yet.
"""

from __future__ import annotations

import torch

from ..sparse.matrix import SparseMatrix, sp_tridiag
from .base import LatentModel, process_constraint

__all__ = ["ARModel", "AR1Model"]


class ARModel(LatentModel):
    """AR(P) of length n. Hyperparameters: P=1 → (tau, rho);
    P≥2 → (tau, pacf1..pacfP)."""

    def __init__(self, n: int, order: int = 1, constraint=None, solver=None):
        if order < 1:
            raise ValueError("AR order must be >= 1")
        if order >= 2:
            raise NotImplementedError(
                "AR(P>=2) needs sp_matmul and the dense backend, not ported yet "
                "(ROADMAP queue 1, item 3; queue 2, item 2.5)"
            )
        self._n = n
        self.order = order
        self.constraint = process_constraint(constraint, n)
        if solver is not None:
            self.solver = solver
        self.name = "ar1"

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ("tau", "rho")

    def precision(self, tau, rho) -> SparseMatrix:
        n = self._n
        tau = torch.as_tensor(tau)
        rho = torch.as_tensor(rho, dtype=tau.dtype, device=tau.device)
        interior = (1.0 + rho**2) * tau
        main = torch.cat(
            [tau[..., None], interior[..., None].expand(*interior.shape, n - 2), tau[..., None]], -1
        )
        off = (-rho * tau)[..., None].expand(*tau.shape, n - 1)
        return sp_tridiag(main, off)

    def constraints(self):
        return self.constraint


def AR1Model(n: int, constraint=None, solver=None) -> ARModel:
    return ARModel(n, order=1, constraint=constraint, solver=solver)
