"""IID and fixed-effects latent models.

Counterpart of ``tpu_gmrf.models.iid``: Q = τI with an optional constraint,
and the ridge Q = λI (λ = 1e-6 by default, no hyperparameters). With τ of
shape (B,) the data is (B, n). The fixed-effects ridge has no θ to take a
dtype from: it is float64 on the default device.
"""

from __future__ import annotations

import torch

from .._device import as_tensor, default_device
from ..sparse.matrix import SparseMatrix, spdiag
from .base import LatentModel, process_constraint

__all__ = ["IIDModel", "FixedEffectsModel"]


class IIDModel(LatentModel):
    name = "iid"

    def __init__(self, n: int, constraint=None, levels=None, solver=None):
        if n <= 0:
            raise ValueError("n must be positive")
        self._n = n
        self.levels = levels
        self.constraint = process_constraint(constraint, n)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ("tau",)

    def precision(self, tau) -> SparseMatrix:
        tau = as_tensor(tau)
        return spdiag(torch.ones(self._n, dtype=tau.dtype, device=tau.device) * tau[..., None])

    def constraints(self):
        return self.constraint


class FixedEffectsModel(LatentModel):
    name = "fixed"

    def __init__(self, n: int, lam: float = 1e-6, constraint=None, solver=None):
        if n < 0:
            raise ValueError("n must be nonnegative")
        if lam <= 0:
            raise ValueError("lam must be positive")
        self._n = n
        self.lam = float(lam)
        self.constraint = process_constraint(constraint, n)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ()

    def precision(self, **_) -> SparseMatrix:
        return spdiag(torch.full((self._n,), self.lam, dtype=torch.float64, device=default_device()))

    def constraints(self):
        return self.constraint
