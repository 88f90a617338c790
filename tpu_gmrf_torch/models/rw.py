"""Random walk (intrinsic) latent models.

Counterpart of ``tpu_gmrf.models.rw``: Q = τ·DₖᵀDₖ (k-th order difference
operator), rank n−k, polynomial null-space constraints, diagonal
regularization 1e-5, optional Sørbye & Rue (2014) variance scaling so the
geometric-mean constrained marginal variance is 1.

The scaling's variances come from ``ConstrainedGMRF(...).var()`` in float64,
under ``no_grad``, once per construction, on the default device. The
reference asks the dense backend; the port's stops at n = 4096, so this
asks ``SolverSpec()``: ``auto`` resolves to the tridiagonal backend for RW1,
to dense up to n = 4096 (as the reference) and to banded or supernodal
above, whose selected inverse gives the same diagonal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .._device import as_tensor, default_device
from ..constrained import ConstrainedGMRF
from ..gmrf import GMRF
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix
from .base import LatentModel, host_sparse, like, process_constraint, stack_constraints

__all__ = ["RWModel", "RW1Model", "RW2Model", "geomean"]

_RW_SCALE_REG = 1.0e-5


def difference_operator(n: int, order: int):
    """k-th order difference operator D_k of shape (n-k, n)."""
    D = sp.diags([-np.ones(n - 1), np.ones(n - 1)], [0, 1], shape=(n - 1, n))
    for _ in range(1, order):
        m = D.shape[0]
        D1 = sp.diags([-np.ones(m - 1), np.ones(m - 1)], [0, 1], shape=(m - 1, m))
        D = D1 @ D
    return D.tocsr()


def geomean(x):
    """exp(mean(log x)) over the last axis."""
    x = torch.as_tensor(x)
    return torch.exp(torch.mean(torch.log(x), -1))


def _rw_nullspace(n: int, order: int):
    """Polynomial null space of DₖᵀDₖ: rows jᵈ, d = 0..k-1 (1-based j)."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return np.stack([j**d for d in range(order)])


def constrained_variances(pattern, data: np.ndarray, A: np.ndarray) -> torch.Tensor:
    """diag of the covariance of N(0, Q⁻¹) | Ax = 0 (Q on `pattern` with
    float64 `data`; A (m, n), m may be 0), computed with ``SolverSpec()`` on
    the default device, float64, without a graph."""
    with torch.no_grad():
        dev = default_device()
        Q = SparseMatrix(torch.as_tensor(data, dtype=torch.float64, device=dev), pattern)
        g = GMRF.from_precision(torch.zeros(pattern.shape[0], dtype=torch.float64, device=dev), Q, SolverSpec())
        if A.shape[0] == 0:
            return g.var()
        return ConstrainedGMRF.create(g, A, np.zeros(A.shape[0])).var()


class RWModel(LatentModel):
    """Random walk of given order. Hyperparameter: tau."""

    def __init__(
        self,
        n: int,
        order: int = 1,
        regularization: float = 1e-5,
        additional_constraints=None,
        scale_model: bool = False,
        solver=None,
    ):
        if n <= order:
            raise ValueError(f"RW{order} requires n > {order}")
        if additional_constraints == "sumtozero":
            raise ValueError(
                "RWModel already includes null-space constraints; "
                "use additional_constraints only for extras"
            )
        self._n = n
        self.order = order
        self.regularization = float(regularization)
        self.name = f"rw{order}"
        if solver is not None:
            self.solver = solver
        self.additional = process_constraint(additional_constraints, n)
        D = difference_operator(n, order)
        self._pattern, self._qdata = host_sparse(D.T @ D)
        self._diag = np.zeros(self._pattern.nnz)
        self._diag[self._pattern.diag_positions] = 1.0
        self._A_null = _rw_nullspace(n, order)
        self.scale_factor = float(self._compute_scale_factor()) if scale_model else 1.0

    def _compute_scale_factor(self):
        """Sørbye-Rue: geomean of the constrained marginal variances of the
        unscaled intrinsic model."""
        var = constrained_variances(self._pattern, self._qdata + _RW_SCALE_REG * self._diag, self._A_null)
        return geomean(var)

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ("tau",)

    def precision(self, tau) -> SparseMatrix:
        tau = as_tensor(tau)
        data = (self.scale_factor * tau)[..., None] * like(self, "q", self._qdata, tau)
        return SparseMatrix(data + self.regularization * like(self, "diag", self._diag, tau), self._pattern)

    def constraints(self):
        null = (self._A_null, np.zeros(self.order))
        return stack_constraints(null, self.additional)


def RW1Model(n: int, **kw) -> RWModel:
    return RWModel(n, order=1, **kw)


def RW2Model(n: int, **kw) -> RWModel:
    return RWModel(n, order=2, **kw)
