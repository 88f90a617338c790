"""Stationary autoregressive latent models (PACF parameterization).

Counterpart of ``tpu_gmrf.models.ar``. AR(1) builds the tridiagonal
precision τ·tridiag(1, 1+ρ², …, 1+ρ², 1; −ρ) directly. AR(P≥2) maps the
partial autocorrelations to AR coefficients by the Durbin-Levinson
recursion (unrolled: P is static), fills the unit lower-triangular L of
bandwidth P (its first P rows with the AR(t) coefficients of the
stationary start) and the diagonal D, and forms Q = τ·Lᵀ(D L) by the
SpGEMM on K5. With θ of shape (B,) it returns B precisions over one
pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..sparse.matrix import SparseMatrix, sp_tridiag, spdiag
from ..sparse.pattern import SparsePattern
from .base import LatentModel, process_constraint

__all__ = ["ARModel", "AR1Model", "durbin_levinson"]


def durbin_levinson(pacf):
    """PACF → AR coefficients; returns (phi, history) where history[k] is the
    AR(k+1) coefficient vector (needed for boundary rows). Each entry of
    `pacf` is a scalar tensor or (B,); phi stacks on a new last axis."""
    P = len(pacf)
    phi = [pacf[0]]
    history = [torch.stack([pacf[0]], -1)]
    for k in range(1, P):
        prev = phi
        phi = [prev[j] - pacf[k] * prev[k - 1 - j] for j in range(k)] + [pacf[k]]
        history.append(torch.stack(phi, -1))
    return torch.stack(phi, -1), history


class ARModel(LatentModel):
    """AR(P) of length n. Hyperparameters: P=1 → (tau, rho);
    P≥2 → (tau, pacf1..pacfP)."""

    def __init__(self, n: int, order: int = 1, constraint=None, solver=None):
        if order < 1:
            raise ValueError("AR order must be >= 1")
        if order >= 2 and n <= order:
            raise ValueError(f"AR{order} requires n > {order}")
        self._n = n
        self.order = order
        self.constraint = process_constraint(constraint, n)
        if solver is not None:
            self.solver = solver
        self.name = "ar1" if order == 1 else f"ar{order}"
        if order >= 2:
            rows = [np.arange(n)] + [np.arange(k, n) for k in range(1, order + 1)]
            cols = [np.arange(n)] + [np.arange(0, n - k) for k in range(1, order + 1)]
            self._L_pattern = SparsePattern(np.concatenate(rows), np.concatenate(cols), (n, n))

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        if self.order == 1:
            return ("tau", "rho")
        return ("tau",) + tuple(f"pacf{k}" for k in range(1, self.order + 1))

    def precision(self, tau, rho=None, **pacf_kwargs) -> SparseMatrix:
        n = self._n
        tau = as_tensor(tau)
        if self.order >= 2:
            return self._precision_p(tau, [pacf_kwargs[f"pacf{k}"] for k in range(1, self.order + 1)])
        rho = torch.as_tensor(rho, dtype=tau.dtype, device=tau.device)
        interior = (1.0 + rho**2) * tau
        main = torch.cat(
            [tau[..., None], interior[..., None].expand(*interior.shape, n - 2), tau[..., None]], -1
        )
        off = (-rho * tau)[..., None].expand(*tau.shape, n - 1)
        return sp_tridiag(main, off)

    def _precision_p(self, tau, pacf) -> SparseMatrix:
        n, P = self._n, self.order
        pacf = [torch.as_tensor(p, dtype=tau.dtype, device=tau.device) for p in pacf]
        batch = torch.broadcast_shapes(tau.shape, *(p.shape for p in pacf))
        pacf = [p.expand(batch) for p in pacf]
        phi, history = durbin_levinson(pacf)
        # D[0] = Π(1-θ_k²), D[t] = Π_{k>t}(1-θ_k²) for t<P, else 1
        one_minus = torch.stack([1.0 - p**2 for p in pacf])  # (P, *batch)
        d_head = torch.stack([torch.prod(one_minus[t:], 0) for t in range(P)], -1)
        D = torch.cat([d_head, d_head.new_ones(batch + (n - P,))], -1)
        # L values in the pattern's build order: diag ones, then band k, whose
        # boundary rows t0 in [k, P-1] take the AR(t0) coefficients
        vals = [phi.new_ones(batch + (n,))]
        for k in range(1, P + 1):
            head = [-history[t0 - 1][..., k - 1] for t0 in range(k, min(P, n))]
            rest = (-phi[..., k - 1])[..., None].expand(batch + (n - k - len(head),))
            vals.append(torch.cat([torch.stack(head, -1), rest], -1) if head else rest)
        pat = self._L_pattern
        order = torch.as_tensor(pat.sort_order, device=tau.device)
        L = SparseMatrix(torch.cat(vals, -1)[..., order], pat)
        return (L.T @ (spdiag(D) @ L)) * tau

    def constraints(self):
        return self.constraint


def AR1Model(n: int, constraint=None, solver=None) -> ARModel:
    return ARModel(n, order=1, constraint=constraint, solver=solver)
