"""Separable (Kronecker) space-time models.

Counterpart of ``tpu_gmrf.models.separable``: Q = Q₁ ⊗ … ⊗ Q_N (the
rightmost factor varies fastest, R-INLA's order) by `sp_kron`, constraints
expanded as I_before ⊗ A_i ⊗ I_after with QR-based redundancy removal (on
the host, scipy), and the regularization re-added when two or more factors
are intrinsic.
"""

from __future__ import annotations

import numpy as np

from ..sparse.matrix import SparseMatrix, sp_kron
from .base import LatentModel, like
from .combined import _cast, _component_names, _split_theta, _theta_dtype

__all__ = ["SeparableModel"]


def _remove_redundant_constraints(A, e, tol=1e-10):
    """Drop linearly dependent rows (QR with column pivoting on Aᵀ)."""
    from scipy.linalg import qr

    m = A.shape[0]
    _, R, piv = qr(A.T, mode="economic", pivoting=True)
    diag = np.abs(np.diag(R))
    rank = int(np.sum(diag > tol * max(diag.max(), 1e-300)))
    if rank == m:
        return A, e
    keep = np.sort(piv[:rank])
    return A[keep], e[keep]


class SeparableModel(LatentModel):
    name = "separable"

    def __init__(self, *components, solver=None):
        if len(components) == 1 and isinstance(components[0], (list, tuple)):
            components = tuple(components[0])
        if len(components) < 2:
            raise ValueError("SeparableModel requires at least 2 components")
        self.components = components
        self.component_names = _component_names(components)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        out = 1
        for c in self.components:
            out *= c.n
        return out

    @property
    def hyperparameters(self):
        out = []
        for comp, cname in zip(self.components, self.component_names):
            out.extend(f"{p}_{cname}" for p in comp.hyperparameters)
        return tuple(out)

    def precision(self, **theta):
        per_comp = _split_theta(self, theta)
        Qs = _cast([c.precision(**sub) for c, sub in zip(self.components, per_comp)], _theta_dtype(per_comp))
        Q = Qs[0]
        for Qi in Qs[1:]:
            Q = sp_kron(Q, Qi)
        # re-regularize the joint null space when ≥2 components are intrinsic
        n_constrained = sum(c.constraints() is not None for c in self.components)
        if n_constrained >= 2:
            regs = [getattr(c, "regularization") for c in self.components if hasattr(c, "regularization")]
            if regs:
                diag = np.zeros(Q.nnz)
                diag[Q.pattern.diag_positions] = 1.0
                Q = SparseMatrix(Q.data + max(regs) * like(self, ("diag", Q.pattern), diag, Q.data), Q.pattern)
        return Q

    def mean(self, **theta):
        per_comp = _split_theta(self, theta)
        means = [c.mean(**sub) for c, sub in zip(self.components, per_comp)]
        dtype = _theta_dtype(per_comp)
        out = means[0] if dtype is None else means[0].to(dtype)
        for m in means[1:]:
            out = (out[..., :, None] * m.to(out.dtype)[..., None, :]).flatten(-2)
        return out

    def constraints(self):
        sizes = [c.n for c in self.components]
        A_parts, e_parts = [], []
        for i, comp in enumerate(self.components):
            cc = comp.constraints()
            if cc is None:
                continue
            A_i, e_i = cc
            n_before = int(np.prod(sizes[:i])) if i > 0 else 1
            n_after = int(np.prod(sizes[i + 1 :])) if i < len(sizes) - 1 else 1
            A_full = np.kron(np.kron(np.eye(n_before), A_i), np.eye(n_after))
            # e rows follow the kron row ordering of A_full
            e_full = np.kron(np.ones(n_before), np.kron(e_i, np.ones(n_after)))
            A_parts.append(A_full)
            e_parts.append(e_full)
        if not A_parts:
            return None
        A = np.vstack(A_parts)
        e = np.concatenate(e_parts)
        return _remove_redundant_constraints(A, e)
