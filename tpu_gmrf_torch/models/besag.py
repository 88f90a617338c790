"""Besag (ICAR) and BYM2 spatial latent models.

Counterpart of ``tpu_gmrf.models.besag``: the graph-Laplacian intrinsic
precision τ(D−W) with 1e-5 regularization, per-connected-component
sum-to-zero constraints, the singleton policy, and the geometric-mean
variance normalization per component; BYM2 (Riebler 2016) is the 2n-dim
stack [u*; v*] with blockdiag [τ/(1−φ)·Q*, τ/φ·I].

The normalization's variances are computed once per construction, in
float64 under ``no_grad`` on the default device, by ``SolverSpec()``
(`models.rw.constrained_variances`): the reference asks the dense backend,
which the port has up to n = 4096; above that ``auto`` resolves to banded
or supernodal, and their selected inverse gives the same diagonal.
`normalization_backend` records the kind it resolved to.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

from .._device import as_tensor
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix, sp_block_diag, spdiag
from ..sparse.pattern import diag_pattern, union_patterns
from .base import LatentModel, host_sparse, like, process_constraint, stack_constraints
from .iid import IIDModel
from .rw import constrained_variances, geomean

__all__ = ["BesagModel", "BYM2Model"]


class BesagModel(LatentModel):
    """Intrinsic CAR on a graph. Hyperparameter: tau."""

    name = "besag"

    def __init__(
        self,
        adjacency,
        regularization: float = 1e-5,
        normalize_var: bool = True,
        singleton_policy: str = "gaussian",
        additional_constraints=None,
        solver=None,
    ):
        W = sp.csr_matrix(adjacency).astype(np.float64)
        n = W.shape[0]
        if W.shape[1] != n:
            raise ValueError("adjacency must be square")
        if (abs(W - W.T)).nnz != 0:
            raise ValueError("adjacency must be symmetric")
        if W.diagonal().any():
            raise ValueError("adjacency must have zero diagonal")
        if regularization <= 0:
            raise ValueError("regularization must be positive")
        if singleton_policy not in ("gaussian", "degenerate"):
            raise ValueError("singleton_policy must be 'gaussian' or 'degenerate'")
        if additional_constraints == "sumtozero":
            raise ValueError(
                "BesagModel already includes sum-to-zero constraints; "
                "use additional_constraints only for extras"
            )
        self._n = n
        self.regularization = float(regularization)
        self.singleton_policy = singleton_policy
        if solver is not None:
            self.solver = solver
        self.additional = process_constraint(additional_constraints, n)

        ncomp, labels = connected_components(W, directed=False)
        self.components = [np.nonzero(labels == c)[0] for c in range(ncomp)]

        deg = np.asarray(W.sum(axis=1)).ravel()
        Q = sp.diags(deg) - W
        if singleton_policy == "gaussian":
            for comp in self.components:
                if len(comp) == 1:
                    Q = Q.tolil()
                    Q[comp[0], comp[0]] = 1.0
            Q = Q.tocsr()
        # every diagonal entry stored, also for degenerate singletons
        own, _ = host_sparse(Q)
        self._pattern, self._qdata = host_sparse(Q, union_patterns(own, diag_pattern(n)))
        self._diag = np.zeros(self._pattern.nnz)
        self._diag[self._pattern.diag_positions] = 1.0
        self.normalization_backend = SolverSpec().resolve(self._pattern).kind if normalize_var else None
        self._norms = np.asarray(self._compute_normalization()) if normalize_var else np.ones(n)

    def _constraint_matrix(self):
        comps = self.components
        if self.singleton_policy == "gaussian":
            comps = [c for c in comps if len(c) > 1]
        A = np.zeros((len(comps), self._n))
        for i, comp in enumerate(comps):
            A[i, comp] = 1.0
        return A

    def _compute_normalization(self):
        """Per-component geomean marginal variance of the constrained
        unscaled model (reference besag.jl `_compute_normalization`)."""
        var = constrained_variances(self._pattern, self._qdata + 1e-5 * self._diag, self._constraint_matrix())
        var = var.cpu().numpy()
        norms = np.ones(self._n)
        for comp in self.components:
            if len(comp) > 1:
                norms[comp] = float(geomean(torch.as_tensor(var[comp])))
        return norms

    @property
    def n(self):
        return self._n

    @property
    def hyperparameters(self):
        return ("tau",)

    def precision(self, tau) -> SparseMatrix:
        tau = as_tensor(tau)
        scaled = like(self, "norms", self._norms[self._pattern.rows], tau) * tau[..., None]
        data = scaled * like(self, "q", self._qdata, tau)
        return SparseMatrix(data + self.regularization * like(self, "diag", self._diag, tau), self._pattern)

    def constraints(self):
        A = self._constraint_matrix()
        builtin = (A, np.zeros(A.shape[0])) if A.shape[0] > 0 else None
        return stack_constraints(builtin, self.additional)


class BYM2Model(LatentModel):
    """Riebler (2016) BYM2: x = [u* (spatial, normalized Besag); v* (iid)].
    Hyperparameters: tau (overall precision), phi (mixing, 0<phi<1)."""

    name = "bym2"

    def __init__(self, adjacency, regularization: float = 1e-5, iid_constraint=None, solver=None, **besag_kw):
        self.besag = BesagModel(adjacency, regularization=regularization, normalize_var=True, **besag_kw)
        self._half = self.besag.n
        self.iid = IIDModel(self._half, constraint=iid_constraint)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return 2 * self._half

    @property
    def hyperparameters(self):
        return ("tau", "phi")

    def precision(self, tau, phi) -> SparseMatrix:
        tau = as_tensor(tau)
        phi = torch.as_tensor(phi, dtype=tau.dtype, device=tau.device)
        Q_star = self.besag.precision(tau=torch.ones((), dtype=tau.dtype, device=tau.device))
        Q_spatial = Q_star * (tau / (1.0 - phi))
        Q_unstruct = spdiag(torch.ones(self._half, dtype=tau.dtype, device=tau.device) * (tau / phi)[..., None])
        return sp_block_diag([Q_spatial, Q_unstruct])

    def constraints(self):
        half = self._half
        parts = []
        bc = self.besag.constraints()
        if bc is not None:
            A, e = bc
            A_full = np.zeros((A.shape[0], 2 * half))
            A_full[:, :half] = A
            parts.append((A_full, e))
        ic = self.iid.constraints()
        if ic is not None:
            A, e = ic
            A_full = np.zeros((A.shape[0], 2 * half))
            A_full[:, half:] = A
            parts.append((A_full, e))
        return stack_constraints(*parts)
