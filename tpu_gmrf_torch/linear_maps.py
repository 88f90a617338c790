"""Lazy structured linear operators (matvec closures over torch tensors).

Counterpart of ``tpu_gmrf.linear_maps`` (reference `src/linear_maps/`:
SymmetricBlockTridiagonalMap, SSMBidiagonalMap, OuterProductMap, ZeroMap,
CholeskySqrt/LinearMapWithSqrt). An operator is an object with a `matvec`;
these never materialize the full matrix. The AD-based maps of the reference
(`ADJacobianMap`, `sparse_jacobian_map`, `sparse_hessian_map`) are not
ported yet.

Block convention: a block-tridiagonal map over Nt time slices of size ns
stores diag blocks as (Nt, ns, ns) and off-diagonal (sub) blocks as
(Nt-1, ns, ns); vectors are flattened time-major (slice t occupies
x[t*ns:(t+1)*ns]), matching the reference's R-INLA Kronecker layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SymmetricBlockTridiagonalMap",
    "SSMBidiagonalMap",
    "OuterProductMap",
    "ZeroMap",
    "CholeskySqrtMap",
    "block_tridiag_to_sparse",
]


class _BlockMap:
    @property
    def nt(self):
        return self.diag.shape[0]

    @property
    def ns(self):
        return self.diag.shape[1]

    @property
    def shape(self):
        n = self.nt * self.ns
        return (n, n)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class SymmetricBlockTridiagonalMap(_BlockMap):
    """Q = blocktridiag(sub, diag, subᵀ); diag (Nt,ns,ns), sub (Nt-1,ns,ns)
    where sub[t] = Q[t+1, t] (block below the diagonal).

    Reference: src/linear_maps/symmetric_block_tridiagonal.jl:19-71.
    """

    diag: torch.Tensor
    sub: torch.Tensor

    def matvec(self, x):
        xb = x.reshape(self.nt, self.ns)
        y = torch.einsum("tij,tj->ti", self.diag, xb)
        y[1:] += torch.einsum("tij,tj->ti", self.sub, xb[:-1])  # contributes to row t+1
        y[:-1] += torch.einsum("tji,tj->ti", self.sub, xb[1:])  # subᵀ contributes to row t
        return y.reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class SSMBidiagonalMap(_BlockMap):
    """Lower block-bidiagonal square root of an SSM joint precision:
    row t has diag block D[t] and subdiag block E[t-1] (so L z stacks
    D[0]z0, E[0]z0+D[1]z1, ...). Q = L Lᵀ. Used to sample joint state-space
    GMRFs without factorizing (reference src/linear_maps/ssm_bidiagonal.jl).
    """

    diag: torch.Tensor  # (Nt, ns, ns)
    sub: torch.Tensor  # (Nt-1, ns, ns)

    def matvec(self, z):
        zb = z.reshape(self.nt, self.ns)
        y = torch.einsum("tij,tj->ti", self.diag, zb)
        y[1:] += torch.einsum("tij,tj->ti", self.sub, zb[:-1])
        return y.reshape(z.shape)


@dataclasses.dataclass(frozen=True)
class OuterProductMap:
    """A = B M Bᵀ for tall B (n,k) and small symmetric M (k,k)
    (reference src/linear_maps/outer_product.jl)."""

    B: torch.Tensor
    M: torch.Tensor

    @property
    def shape(self):
        return (self.B.shape[0], self.B.shape[0])

    def matvec(self, x):
        return self.B @ (self.M @ (self.B.T @ x))

    def __matmul__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class ZeroMap:
    """The zero operator (reference src/linear_maps/zero_map.jl)."""

    n: int = 0

    @property
    def shape(self):
        return (self.n, self.n)

    def matvec(self, x):
        return torch.zeros_like(x)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclasses.dataclass(frozen=True)
class CholeskySqrtMap:
    """Wraps a factorized GMRF backend as the square-root operator
    L (Q = L Lᵀ): `matvec(z)` = L z and `rsolve(z)` = L⁻ᵀ z — the sampling
    primitive x = μ + L⁻ᵀ z (reference src/linear_maps/cholesky_sqrt.jl).
    """

    factor: object

    def matvec(self, z):
        return self.factor.sqrt_matvec(z)

    def rsolve(self, z):
        return self.factor.backward_solve(z)

    def __matmul__(self, z):
        return self.matvec(z)


def block_tridiag_to_sparse(m: SymmetricBlockTridiagonalMap):
    """Materialize a SymmetricBlockTridiagonalMap into a SparseMatrix
    (dense per-block storage scattered into BSR-like COO). Host-side;
    used when a direct factorization of the joint is wanted."""
    from .sparse.matrix import SparseMatrix
    from .sparse.pattern import SparsePattern

    nt, ns = m.nt, m.ns
    n = nt * ns
    rows, cols, vals = [], [], []
    ii, jj = np.meshgrid(np.arange(ns), np.arange(ns), indexing="ij")
    for t in range(nt):
        rows.append((t * ns + ii).ravel())
        cols.append((t * ns + jj).ravel())
        vals.append(m.diag[t].reshape(-1))
    for t in range(nt - 1):
        rows.append(((t + 1) * ns + ii).ravel())
        cols.append((t * ns + jj).ravel())
        vals.append(m.sub[t].reshape(-1))
        rows.append((t * ns + ii).ravel())
        cols.append(((t + 1) * ns + jj).ravel())
        vals.append(m.sub[t].mT.reshape(-1))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = torch.cat(vals)
    order = np.lexsort((cols, rows))
    pattern = SparsePattern(rows=rows[order], cols=cols[order], shape=(n, n))
    return SparseMatrix(data[torch.as_tensor(order, device=data.device)], pattern)
