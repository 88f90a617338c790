"""Latent model protocol.

Counterpart of ``tpu_gmrf.models.base``. A `LatentModel` is a static
host-side object; ``precision(**theta)`` / ``mean(**theta)`` map
hyperparameter tensors (scalars, or (B,) for B chains) to fixed-pattern
data. ``model(**theta)`` returns a `GMRF`, or a `ConstrainedGMRF` when the
model has constraints. The reference wraps that call in a per-instance jit
cache; PyTorch runs eagerly and needs none.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import as_tensor
from ..constrained import ConstrainedGMRF
from ..gmrf import GMRF
from ..solvers.base import SolverSpec

__all__ = ["LatentModel", "process_constraint", "stack_constraints"]


def host_sparse(mat, pattern=None):
    """(pattern, float64 NumPy data) of a scipy matrix, duplicates summed, as
    ``from_scipy`` orders them; on `pattern` (a super-pattern, zeros where
    `mat` has no entry) when one is given."""
    from ..sparse.pattern import SparsePattern

    coo = mat.tocoo()
    coo.sum_duplicates()
    own = SparsePattern(coo.row, coo.col, coo.shape)
    data = np.asarray(coo.data, np.float64)[own.sort_order]
    if pattern is None or pattern == own:
        return own, data
    out = np.zeros(pattern.nnz)
    out[pattern.scatter_map(own)] = data
    return pattern, out


def like(model, key: str, array, ref: torch.Tensor) -> torch.Tensor:
    """The model's host array `array` as a tensor with `ref`'s dtype and
    device, kept on the model per (key, dtype, device)."""
    cache = model.__dict__.setdefault("_tensors", {})
    k = (key, ref.dtype, str(ref.device))
    t = cache.get(k)
    if t is None:
        t = cache[k] = torch.as_tensor(np.asarray(array), dtype=ref.dtype, device=ref.device)
    return t


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
        base = GMRF.from_precision(self.mean(**theta), self.precision(**theta), self.solver)
        cons = self.constraints()
        if cons is None:
            return base
        A, e = cons
        return ConstrainedGMRF.create(base, A, e)

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



def stack_constraints(*specs):
    """Stack optional (A, e) pairs; returns None if all None."""
    present = [s for s in specs if s is not None]
    if not present:
        return None
    A = np.vstack([np.atleast_2d(s[0]) for s in present])
    e = np.concatenate([np.atleast_1d(s[1]) for s in present])
    return A, e
