"""Latent model protocol.

Counterpart of ``tpu_gmrf.models.base``. A `LatentModel` is a static
host-side object; ``precision(**theta)`` / ``mean(**theta)`` map
hyperparameter tensors (scalars, or (B,) for B chains) to fixed-pattern
data. ``model(**theta)`` returns a `GMRF`. The reference wraps that call in
a per-instance jit cache; PyTorch runs eagerly and needs none.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..gmrf import GMRF
from ..solvers.base import SolverSpec

__all__ = ["LatentModel", "process_constraint"]


class LatentModel:
    """Base class. Subclasses define `n`, `name`, `hyperparameters`,
    `precision`, and optionally `mean` / `constraints`."""

    name: str = "latent"
    solver: SolverSpec = SolverSpec()

    def __len__(self):
        return self.n

    @property
    def n(self) -> int:
        raise NotImplementedError

    @property
    def hyperparameters(self) -> tuple:
        """Hyperparameter names, in canonical order."""
        return ()

    def precision(self, **theta):
        raise NotImplementedError

    def mean(self, **theta):
        t = next(iter(theta.values()), None)
        t = as_tensor(0.0 if t is None else t)
        return torch.zeros(self.n, dtype=t.dtype, device=t.device)

    def constraints(self):
        """Returns (A (m,n) ndarray, e (m,) ndarray) or None. θ-independent."""
        return None

    def __call__(self, **theta):
        if self.constraints() is not None:
            raise NotImplementedError(
                "a constrained latent model's GMRF (a ConstrainedGMRF from LatentModel.__call__) is not wired "
                "yet (ROADMAP queue 1, item 2)"
            )
        return GMRF.from_precision(self.mean(**theta), self.precision(**theta), self.solver)

    def __repr__(self):
        hp = ", ".join(self.hyperparameters)
        return f"{type(self).__name__}(n={self.n}, hyperparameters=[{hp}])"


def process_constraint(constraint, n: int):
    """Normalize a user constraint spec: None | 'sumtozero' | (A, e)."""
    if constraint is None:
        return None
    if constraint == "sumtozero":
        return np.ones((1, n)), np.zeros(1)
    A, e = constraint
    A = np.atleast_2d(np.asarray(A, dtype=np.float64))
    e = np.atleast_1d(np.asarray(e, dtype=np.float64))
    if A.shape != (e.shape[0], n):
        raise ValueError(f"constraint A{A.shape} / e{e.shape} incompatible with n={n}")
    return A, e

