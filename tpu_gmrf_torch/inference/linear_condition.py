"""Conjugate linear conditioning.

Counterpart of ``tpu_gmrf.inference.linear_condition`` (reference spec:
src/arithmetic/condition/linear.jl:46-102): for y = A·x + b + ε,
ε ~ N(0, Q_ε⁻¹),
  Q_post   = Q + Aᵀ Q_ε A
  info_post = Qμ + Aᵀ Q_ε (y − b)
solved once via the information-vector constructor. ConstrainedGMRF priors
are conditioned on their base and re-constrained. A sparse A (any m × n
pattern) multiplies on K4 and forms AᵀQ_εA on K5's SpGEMM; the scatter of
observations given by `indices` is a K5 sum over a host plan (no atomics).
The identity and `indices` paths take a batch of B GMRFs (Q data (B, nnz))
and Q_ε per chain (a diagonal `SparseMatrix` with data (B, m)), as the
Laplace approximation's conjugate shortcut gives them; the dense-A path
takes one GMRF and one Q_ε.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constrained import ConstrainedGMRF
from ..gmrf import GMRF
from ..kernels import SegPlan, gather_segsum
from ..solvers.base import SolverSpec
from ..sparse.matrix import SparseMatrix, from_dense, spdiag
from ..sparse.pattern import SparsePattern, union_patterns

__all__ = ["linear_condition"]


def _qeps_as_operator(Q_eps, m, dtype, device):
    """Normalize Q_ε: scalar → scaled identity, vector → diagonal,
    SparseMatrix/dense → as-is."""
    if isinstance(Q_eps, SparseMatrix):
        return Q_eps
    Q_eps = torch.as_tensor(Q_eps, dtype=dtype, device=device)
    if Q_eps.ndim == 0:
        return spdiag(torch.full((m,), 1.0, dtype=dtype, device=device) * Q_eps)
    if Q_eps.ndim == 1:
        return spdiag(Q_eps)
    return from_dense(Q_eps)


def linear_condition(
    gmrf,
    y,
    Q_eps,
    A=None,
    b=None,
    indices=None,
    solver: SolverSpec | None = None,
):
    """Condition on y = A x + b + ε. `A` may be a SparseMatrix, a dense
    matrix, or None (identity / index selection via `indices`)."""
    if isinstance(gmrf, ConstrainedGMRF):
        post = linear_condition(
            gmrf.base, y, Q_eps, A=A, b=b, indices=indices, solver=solver
        )
        return ConstrainedGMRF.create(post, gmrf.A, gmrf.e)

    dtype, dev = gmrf.dtype, gmrf.Q.device
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    m = y.shape[-1]
    n = gmrf.n
    solver = solver if solver is not None else gmrf.solver
    resid = y if b is None else y - torch.as_tensor(b, dtype=dtype, device=dev)
    Qe = _qeps_as_operator(Q_eps, m, dtype, dev)

    if A is None:
        if indices is None and m != n:
            raise ValueError("y length must equal n when A and indices are None")
        if indices is None:
            contrib = Qe  # already n×n diagonal/sparse
            info_obs = Qe.matvec(resid)
        else:
            idx = indices.cpu().numpy() if torch.is_tensor(indices) else np.asarray(indices)
            # Aᵀ Q_ε A for a selection matrix = scatter of Q_ε into (idx, idx)
            if Qe.pattern.rows.shape[0] != m or not np.array_equal(
                Qe.pattern.rows, Qe.pattern.cols
            ):
                raise ValueError("indices path requires diagonal Q_eps")
            rows = idx[Qe.pattern.rows]
            pat = SparsePattern(rows, rows, (n, n))
            # Q_ε's values follow the new pattern's (sorted) order
            contrib = SparseMatrix(Qe.data[..., torch.as_tensor(pat.sort_order, device=dev)], pat)
            plan = SegPlan.grouped(idx, np.arange(m), n)
            v = Qe.matvec(resid)
            info_obs = gather_segsum(plan, v.reshape(-1, m)).reshape(v.shape[:-1] + (n,))
    elif isinstance(A, SparseMatrix):
        contrib = A.T @ (Qe @ A)
        info_obs = A.rmatvec(Qe.matvec(resid))
    else:
        if gmrf.Q.data.ndim != 1 or Qe.data.ndim != 1:
            raise ValueError("linear_condition with a dense A takes one GMRF (Q data (nnz,)) and one Q_eps")
        A = torch.as_tensor(A, dtype=dtype, device=dev)
        AtQ = A.T @ Qe.todense()
        contrib = from_dense(AtQ @ A)
        info_obs = AtQ @ resid

    pat = union_patterns(gmrf.Q.pattern, contrib.pattern)
    Q_post = gmrf.Q.pad_to(pat) + contrib.pad_to(pat)
    info_post = gmrf.information_vector() + info_obs
    return GMRF.from_information(info_post, Q_post, solver)
