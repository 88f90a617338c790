"""Joint GMRF of x₁ and x₂ = A·x₁ + b + ε.

Counterpart of ``tpu_gmrf.inference.joint`` (reference
src/arithmetic/joint.jl:24-40): the 2×2 block precision
[[Q₁ + AᵀQ_εA, −AᵀQ_ε], [−Q_εA, Q_ε]], its products on K5's SpGEMM and
its sum on K5. One GMRF (Q data (nnz,)) or a batch over one pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gmrf import GMRF
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix, _broadcast_data, _index, from_dense
from ..sparse.pattern import SparsePattern
from .linear_condition import _qeps_as_operator

__all__ = ["joint_gmrf", "sp_bmat"]


def sp_bmat(blocks) -> SparseMatrix:
    """Assemble a sparse matrix from a grid of optional SparseMatrix blocks
    (entries across blocks must not collide); chain axes broadcast."""
    row_sizes = [next(b for b in row if b is not None).shape[0] for row in blocks]
    col_sizes = [next(row[j] for row in blocks if row[j] is not None).shape[1] for j in range(len(blocks[0]))]
    r_off = np.concatenate([[0], np.cumsum(row_sizes)])
    c_off = np.concatenate([[0], np.cumsum(col_sizes)])
    rows, cols, mats = [], [], []
    for i, row in enumerate(blocks):
        for j, b in enumerate(row):
            if b is None:
                continue
            rows.append(b.pattern.rows.astype(np.int64) + int(r_off[i]))
            cols.append(b.pattern.cols.astype(np.int64) + int(c_off[j]))
            mats.append(b)
    pat = SparsePattern(np.concatenate(rows), np.concatenate(cols), (int(r_off[-1]), int(c_off[-1])))
    data = torch.cat(_broadcast_data(mats), -1)
    return SparseMatrix(data[..., _index(pat, "sort", pat.sort_order, data.device)], pat)


def joint_gmrf(x1: GMRF, A, Q_eps, b=None, solver: SolverSpec | None = None) -> GMRF:
    dtype, dev = x1.dtype, x1.Q.device
    if not isinstance(A, SparseMatrix):
        A = from_dense(torch.as_tensor(A, dtype=dtype, device=dev))
    m = A.shape[0]
    Qe = _qeps_as_operator(Q_eps, m, dtype, dev)
    QeA = Qe @ A
    Q11 = x1.Q + (A.T @ QeA)
    Q21 = QeA * -1.0
    Q_joint = sp_bmat([[Q11, Q21.T], [Q21, Qe]])
    mu2 = A.matvec(x1.mean)
    if b is not None:
        mu2 = mu2 + torch.as_tensor(b, dtype=dtype, device=dev)
    mu1 = x1.mean.expand(mu2.shape[:-1] + x1.mean.shape[-1:])
    mu = torch.cat([mu1, mu2], -1)
    return GMRF.from_precision(mu, Q_joint.symmetrize(), solver if solver is not None else x1.solver)
