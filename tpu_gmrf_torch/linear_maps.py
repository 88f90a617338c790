"""Lazy structured linear operators (matvec closures over torch tensors).

Counterpart of ``tpu_gmrf.linear_maps`` (reference `src/linear_maps/`:
SymmetricBlockTridiagonalMap, SSMBidiagonalMap, OuterProductMap, ZeroMap,
CholeskySqrt/LinearMapWithSqrt). An operator is an object with a `matvec`;
these never materialize the full matrix. The AD-based maps
(`ADJacobianMap`, `sparse_jacobian_map`, `sparse_hessian_map`) use
``torch.func``: the function is written for one chain, and a batch of
points x (B, n) is mapped with ``vmap``.

Block convention: a block-tridiagonal map over Nt time slices of size ns
stores diag blocks as (Nt, ns, ns) and off-diagonal (sub) blocks as
(Nt-1, ns, ns); vectors are flattened time-major (slice t occupies
x[t*ns:(t+1)*ns]), matching the reference's R-INLA Kronecker layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, jvp, vjp, vmap

__all__ = [
    "SymmetricBlockTridiagonalMap",
    "SSMBidiagonalMap",
    "OuterProductMap",
    "ZeroMap",
    "CholeskySqrtMap",
    "ADJacobianMap",
    "sparse_jacobian_map",
    "sparse_hessian_map",
    "pattern_column_coloring",
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


@dataclasses.dataclass(frozen=True)
class ADJacobianMap:
    """Lazy Jacobian J = ∂f/∂x at x_ref as a linear operator (reference
    src/linear_maps/ad_jacobian.jl): `matvec` is one `jvp`, `rmatvec` one
    `vjp`; the Jacobian is never materialized. f maps (n,) to (m,); x_ref
    is (n,) or (B, n), one Jacobian per chain."""

    f: object
    x_ref: torch.Tensor

    @property
    def shape(self):
        x0 = self.x_ref if self.x_ref.ndim == 1 else self.x_ref[0]
        return (int(self.f(x0).numel()), int(x0.shape[0]))

    def _apply(self, one, v):
        """one(x, v) per chain of x_ref and of v (each (…,) or (B, …))."""
        if self.x_ref.ndim == 1 and v.ndim == 1:
            return one(self.x_ref, v)
        return vmap(one, in_dims=(0 if self.x_ref.ndim == 2 else None, 0 if v.ndim == 2 else None))(self.x_ref, v)

    def matvec(self, v):
        return self._apply(lambda x, t: jvp(self.f, (x,), (t,))[1], v)

    def rmatvec(self, w):
        return self._apply(lambda x, t: vjp(self.f, x)[1](t)[0], w)

    def __matmul__(self, v):
        return self.matvec(v)


_COLOR_CACHE: dict = {}


def pattern_column_coloring(pattern, n: int):
    """Greedy distance-2 column coloring of `pattern` (columns conflict when
    they touch a common row), in column order, each column taking the least
    colour no column sharing a row with it has. Host NumPy, cached per
    pattern. Returns (color (n,), ncolors)."""
    key = (pattern, n)
    cached = _COLOR_CACHE.get(key)
    if cached is not None:
        return cached
    cols = np.asarray(pattern.cols, np.int64)
    order = np.argsort(cols, kind="stable")
    rows_by_col = np.split(np.asarray(pattern.rows, np.int64)[order], np.cumsum(np.bincount(cols, minlength=n))[:-1])
    used = [set() for _ in range(pattern.shape[0])]  # colours already taken at each row
    color = np.full(n, -1, dtype=np.int64)
    for c in range(n):
        rows = rows_by_col[c]
        forbidden = set().union(*(used[r] for r in rows)) if len(rows) else set()
        k = 0
        while k in forbidden:
            k += 1
        color[c] = k
        for r in rows:
            used[r].add(k)
    ncolors = int(color.max()) + 1 if n else 0
    _COLOR_CACHE[key] = (color, ncolors)
    return color, ncolors


def _jacobian_data(f, x, pattern) -> torch.Tensor:
    """The entries of ∂f/∂x at one point x (n,) on `pattern`, (nnz,): one
    jvp per colour of the column coloring, the seeds' passes vmapped."""
    n = x.shape[-1]
    color, ncolors = pattern_column_coloring(pattern, n)
    seeds = np.zeros((ncolors, n))
    seeds[color, np.arange(n)] = 1.0
    seeds = torch.as_tensor(seeds, dtype=x.dtype, device=x.device)
    jv = vmap(lambda s: jvp(f, (x,), (s,))[1])(seeds)  # (ncolors, m)
    if jv.ndim == 1:
        jv = jv[:, None]
    # entry (r, c) lives in the pass of color[c] at output row r
    sel = torch.as_tensor(color[pattern.cols], device=x.device)
    return jv[sel, torch.as_tensor(pattern.rows.astype(np.int64), device=x.device)]


def sparse_jacobian_map(f, x_ref, pattern):
    """Sparse Jacobian of `f` at `x_ref` restricted to a known `pattern`:
    column-colored forward mode, structurally independent columns (no shared
    output row) sharing one jvp, so the passes number the pattern's
    chromatic number rather than n. f maps (n,) to (m,); x_ref is (n,) or
    (B, n). Returns a `SparseMatrix` on `pattern`, data (nnz,) or (B, nnz)."""
    from .sparse.matrix import SparseMatrix

    one = lambda x: _jacobian_data(f, x, pattern)
    return SparseMatrix(one(x_ref) if x_ref.ndim == 1 else vmap(one)(x_ref), pattern)


def sparse_hessian_map(g, x_ref, pattern):
    """Sparse Hessian of scalar `g` at `x_ref` restricted to symmetric
    `pattern`, by colored forward-over-reverse HVPs: the columns of ∇²g
    sharing a colour are probed by one jvp of the gradient, so the cost is
    the chromatic number of HVPs instead of n, and no n×n array is made."""
    return sparse_jacobian_map(grad(g), x_ref, pattern)


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
