"""Barrier Matérn model (Bakka et al. 2019), batched over chains.

Counterpart of ``tpu_gmrf.fem.barrier``: a non-stationary ν=1 Matérn in
which correlation does not flow across designated barrier triangles; barrier
triangles get a small fixed range.

Precision (unscaled by τ):
    Q = (2/π) · Aᵀ C̃⁻¹ A
    A  = diag(C) + Σ_k (r_k²/8) G_k     (C = full lumped mass)
    C̃  = diag(Σ_k r_k² c_k)             (range²-weighted lumped mass)
with per-region stiffness G_k and region-restricted lumped mass c_k.
With a uniform range this reduces to the stationary ν=1 Matérn.

τ and range are scalars or (B,) tensors. A's data is a fixed-pattern
combination of the two regions' stiffness data; AᵀC̃⁻¹A is two SpGEMMs
(``sp_matmul``, K5), so Q's pattern does not depend on θ and Q is
differentiable in θ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import as_tensor
from ..models.base import LatentModel, like, process_constraint
from ..sparse.matrix import SparseMatrix, spdiag
from ..sparse.pattern import diag_pattern, union_patterns
from .discretization import FEMDiscretization, assemble_coo

__all__ = ["BarrierModel"]


class BarrierModel(LatentModel):
    """Hyperparameters: (tau, range); barrier triangles use
    `range_fraction * range`."""

    name = "barrier"

    def __init__(
        self,
        disc: FEMDiscretization,
        barrier_elements,
        range_fraction: float = 0.01,
        constraint=None,
        solver=None,
    ):
        if disc.intrinsic_dim != 2:
            raise ValueError("BarrierModel supports 2D discretizations only")
        self.disc = disc
        self.range_fraction = float(range_fraction)
        barrier = np.zeros(disc.mesh.n_elements, bool)
        barrier[np.asarray(barrier_elements, dtype=np.int64)] = True
        self.barrier_mask = barrier
        n = disc.ndofs
        tris = disc.mesh.triangles
        areas = disc.areas
        grads = disc.grads

        def region_matrices(mask):
            if not mask.any():
                G = assemble_coo([0], [0], [0.0], (n, n))
                c = np.zeros(n)
                return G, c
            t = tris[mask]
            A = areas[mask]
            g = grads[mask]
            Ge = np.einsum("mkd,mld->mkl", g, g) * A[:, None, None]
            rows = np.repeat(t, 3, axis=1).ravel()
            cols = np.tile(t, (1, 3)).ravel()
            G = assemble_coo(rows, cols, Ge.ravel(), (n, n))
            c = np.zeros(n)
            for k in range(3):
                np.add.at(c, t[:, k], A / 3.0)
            return G, c

        self.G_normal, self.c_normal = region_matrices(~barrier)
        self.G_barrier, self.c_barrier = region_matrices(barrier)
        self.C_diag = self.c_normal + self.c_barrier
        # fixed A-pattern: diag ∪ G_normal ∪ G_barrier
        self.A_pattern = union_patterns(diag_pattern(n), self.G_normal.pattern, self.G_barrier.pattern)
        self._Gn = self.G_normal.pad_to(self.A_pattern).data.numpy()
        self._Gb = self.G_barrier.pad_to(self.A_pattern).data.numpy()
        self._C_pad = np.zeros(self.A_pattern.nnz)
        self._C_pad[self.A_pattern.diag_positions] = self.C_diag
        self.constraint = process_constraint(constraint, n)
        if solver is not None:
            self.solver = solver

    @property
    def n(self):
        return self.disc.ndofs

    @property
    def hyperparameters(self):
        return ("tau", "range")

    def precision(self, tau, range) -> SparseMatrix:
        r1 = as_tensor(range)
        tau = torch.as_tensor(tau, dtype=r1.dtype, device=r1.device)
        r2 = self.range_fraction * r1
        w1, w2 = (r1**2)[..., None], (r2**2)[..., None]
        A_data = (w1 / 8.0) * like(self, "Gn", self._Gn, r1) + (w2 / 8.0) * like(self, "Gb", self._Gb, r1)
        A = SparseMatrix(A_data + like(self, "C", self._C_pad, r1), self.A_pattern)
        ctilde = w1 * like(self, "cn", self.c_normal, r1) + w2 * like(self, "cb", self.c_barrier, r1)
        Q = A.T @ (spdiag(1.0 / ctilde) @ A)
        Q = Q * ((2.0 / math.pi) * tau)
        return Q.symmetrize() if Q.pattern.is_symmetric else Q

    def constraints(self):
        return self.constraint
