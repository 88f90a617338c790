"""Dense Cholesky backend with Jacobi equilibration, batched over chains.

Counterpart of ``tpu_gmrf.solvers.dense``. Q is densified, symmetrically
prescaled by its diagonal (Q' = S Q S, S = diag(q_ii)^-1/2) and factored,
with the reference's per-chain ridge rescue: a chain whose factor breaks
down is refactored as Q' + δI (δ = 2e-6·n), then Q' + 500δI; a genuinely
indefinite input still gives NaN. The effective factor is Q = L Lᵀ with
L = S⁻¹L'. Factorization and logdet run on K9 (`dense_chol`), the solves
on K10 (`dense_trsv`), Σ = Q⁻¹ at the entries wanted (diagonal, a
pattern) on K10's second entry (`dense_selinv`), whose sums for
`selinv_dot` are K5's; `sqrt_matvec`'s L·z is a plain matrix product. The
logdet is differentiable through `DenseLogdet`, whose backward is Σ on Q's
pattern; `solve` through `FactorSolve` (K10 forward and backward). The
other solves and Σ have no backward and raise while a gradient is asked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import SOLVE_BOTH, SOLVE_L, SOLVE_LT, DenseTables, dense_chol, dense_selinv, dense_trsv, gather_segsum
from ..kernels.dense import DENSE_MAX_N
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import DirectFactor, no_double_backward
from .supernodal import _sum_plans

__all__ = ["DenseFactor", "DenseLogdet", "dense_factorize"]

_TABLES: dict = {}
_ENTRIES: dict = {}


def _tables(pattern: SparsePattern) -> DenseTables:
    t = _TABLES.get(pattern)
    if t is None:
        t = _TABLES[pattern] = DenseTables(pattern)
    return t


def _entries(pattern: SparsePattern | int, device):
    """int32 (rows, cols) of `pattern`'s entries, or of the diagonal of an
    n×n matrix for an int n, on `device` (cached)."""
    key = (pattern, str(device))
    got = _ENTRIES.get(key)
    if got is None:
        rc = (np.arange(pattern),) * 2 if isinstance(pattern, int) else (pattern.rows, pattern.cols)
        got = _ENTRIES[key] = tuple(torch.tensor(np.asarray(a), dtype=torch.int32, device=device) for a in rc)
    return got


def _sigma(L: torch.Tensor, s: torch.Tensor, pattern: SparsePattern | int) -> torch.Tensor:
    """Σ = Q⁻¹ at `pattern`'s entries (or the diagonal, for an int n), (B, m)."""
    n = L.shape[-1]
    if not isinstance(pattern, int) and tuple(pattern.shape) != (n, n):
        raise ValueError(f"pattern of shape {pattern.shape} does not match a factor of {n} x {n}")
    return dense_selinv(L, s, *_entries(pattern, L.device))


class DenseLogdet(torch.autograd.Function):
    """logdet of B precisions (data (B, nnz)) by K9, with the factor
    (L, s, level) as non-differentiable outputs.

    Backward: ∂logdet/∂data_p = Σ_{row p, col p}, as JAX's Cholesky rule
    gives it (the reference symmetrizes its input, so each stored entry of
    a symmetric pair gets Σ_ij); Σ on the pattern from the saved factor by
    `dense_selinv`, no refactorization."""

    @staticmethod
    def forward(ctx, data, tables):
        L, s, level, logdet = dense_chol(data.contiguous(), tables)
        ctx.mark_non_differentiable(L, s, level)
        ctx.save_for_backward(L, s)
        ctx.tables = tables
        return logdet, L, s, level

    @staticmethod
    def backward(ctx, glogdet, _gL, _gs, _glevel):
        no_double_backward("the dense logdet")
        L, s = ctx.saved_tensors
        t = ctx.tables.on(L.device)
        return glogdet[:, None] * dense_selinv(L, s, t["rows"], t["cols"]), None


@dataclasses.dataclass(frozen=True)
class DenseFactor(DirectFactor):
    """Equilibrated Cholesky of B chains: Q = (S⁻¹L')(S⁻¹L')ᵀ with L' (B, n, n)
    = chol(S·Q·S), s (B, n); ``level`` (B,) is the ridge rescue each chain
    needed (0 none, 1 δ, 2 500δ)."""

    L: torch.Tensor
    s: torch.Tensor
    level: torch.Tensor
    logdet_: torch.Tensor
    batch_shape: tuple
    data: torch.Tensor = dataclasses.field(repr=False, compare=False)  # (B, nnz) factored
    pattern: SparsePattern = dataclasses.field(repr=False, compare=False)

    @property
    def n(self):
        return self.L.shape[-1]

    def _rhs(self, b: torch.Tensor) -> torch.Tensor:
        """b (*batch, n) or (*batch, n, k) as (B, n, k)."""
        n, bs = self.n, tuple(self.batch_shape)
        if b.shape[: len(bs) + 1] != bs + (n,) or b.ndim not in (len(bs) + 1, len(bs) + 2):
            raise ValueError(f"rhs of shape {tuple(b.shape)} does not match a factor of {bs} x {n}")
        k = 1 if b.ndim == len(bs) + 1 else b.shape[-1]
        return b.reshape(self.L.shape[0], n, k).contiguous()

    def _solve(self, b: torch.Tensor, mode: int) -> torch.Tensor:
        return dense_trsv(self.L, self.s, self._rhs(b), mode).reshape(b.shape)

    def _solve_both(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b (K10, both triangles in one launch)."""
        return self._solve(b, SOLVE_BOTH)

    def forward_solve(self, b: torch.Tensor) -> torch.Tensor:
        """L x = b with L = S⁻¹L' (whitening of residuals)."""
        return self._solve(b, SOLVE_L)

    def backward_solve(self, z: torch.Tensor) -> torch.Tensor:
        """Lᵀ x = z: maps N(0, I) noise to N(0, Q⁻¹) samples."""
        return self._solve(z, SOLVE_LT)

    def sqrt_matvec(self, z: torch.Tensor) -> torch.Tensor:
        """L z with L = S⁻¹L': maps N(0, I) to N(0, Q)."""
        return ((self.L @ self._rhs(z)) / self.s[..., None]).reshape(z.shape)

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def selinv_diag(self) -> torch.Tensor:
        return _sigma(self.L, self.s, self.n).reshape(tuple(self.batch_shape) + (self.n,))

    def selinv(self, pattern: SparsePattern) -> SparseMatrix:
        """Entries of Q⁻¹ on `pattern` (used for ∂logdet(Q)/∂Q)."""
        z = _sigma(self.L, self.s, pattern)
        return SparseMatrix(z.reshape(tuple(self.batch_shape) + (pattern.nnz,)), pattern)

    def selinv_dot(self, other: SparseMatrix) -> torch.Tensor:
        """tr(Q⁻¹ · other) per chain, for other on any pattern: two K5 sums
        of Σ's values times other's."""
        z = _sigma(self.L, self.s, other.pattern)
        y = other.data if other.data.ndim == 1 else other.data.reshape(-1, other.nnz)
        chunks, total = _sum_plans(other.nnz, dot=True)
        return gather_segsum(total, gather_segsum(chunks, z, y=y))[:, 0].reshape(tuple(self.batch_shape))


def dense_factorize(Q: SparseMatrix) -> DenseFactor:
    """Factorize Q (data (nnz,) or (B, nnz)), n ≤ 4096. A non-symmetric
    pattern is first made symmetric as (Q + Qᵀ)/2, which is what the
    reference's Cholesky reads of it."""
    if Q.shape[0] > DENSE_MAX_N:
        raise ValueError(f"dense backend: n={Q.shape[0]} is above {DENSE_MAX_N}")
    if Q.data.ndim > 2:
        raise ValueError("data must be (nnz,) or (B, nnz)")
    if not Q.pattern.is_symmetric:
        Q = (Q + Q.T) * 0.5
    batch = tuple(Q.data.shape[:-1])
    data = Q.data.reshape(-1, Q.nnz)
    logdet, L, s, level = DenseLogdet.apply(data, _tables(Q.pattern))
    return DenseFactor(L, s, level, logdet.reshape(batch), batch, data, Q.pattern)
