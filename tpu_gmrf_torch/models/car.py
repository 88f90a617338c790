"""Conditional autoregressive (CAR) model.

Counterpart of ``tpu_gmrf.models.car``: Q = (D − ρW)/σ from an
adjacency/weight matrix, 0 ≤ ρ < 1, on the fixed pattern of D + W.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .._device import as_tensor
from ..gmrf import GMRF
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix
from .base import LatentModel, host_sparse, like

__all__ = ["CARModel", "generate_car_model"]


class CARModel(LatentModel):
    """Proper CAR. Hyperparameters: rho (0 ≤ rho < 1), sigma (scale)."""

    name = "car"

    def __init__(self, W, solver=None):
        W = sp.csr_matrix(W).astype(np.float64)
        n = W.shape[0]
        deg = np.asarray(W.sum(axis=1)).ravel()
        D_mat = sp.diags(deg)
        self._pattern, _ = host_sparse((D_mat + W).tocoo())
        _, self._d = host_sparse(sp.coo_matrix(D_mat), self._pattern)
        _, self._w = host_sparse(sp.coo_matrix(W), self._pattern)
        self._n = n
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ("rho", "sigma")

    def precision(self, rho, sigma=1.0) -> SparseMatrix:
        rho = as_tensor(rho)
        sigma = torch.as_tensor(sigma, dtype=rho.dtype, device=rho.device)
        data = (like(self, "d", self._d, rho) - rho[..., None] * like(self, "w", self._w, rho)) / sigma[..., None]
        return SparseMatrix(data, self._pattern)


def generate_car_model(W, rho, sigma=1.0, mu=None, solver=SolverSpec()) -> GMRF:
    """Materialize a CAR GMRF directly (reference car.jl API)."""
    model = CARModel(W)
    Q = model.precision(rho=rho, sigma=sigma)
    mu = torch.zeros(model.n, dtype=Q.dtype, device=Q.device) if mu is None else mu
    return GMRF.from_precision(mu, Q, solver)
