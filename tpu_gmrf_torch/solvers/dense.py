"""Dense Cholesky backend with Jacobi equilibration, batched over chains.

Counterpart of ``tpu_gmrf.solvers.dense``. Q is densified, symmetrically
prescaled by its diagonal (Q' = S Q S, S = diag(q_ii)^-1/2) and factored,
with the reference's per-chain ridge rescue: a chain whose factor breaks
down is refactored as Q' + δI (δ = 2e-6·n), then Q' + 500δI; a genuinely
indefinite input still gives NaN. The effective factor is Q = L Lᵀ with
L = S⁻¹L'. Factorization and logdet run on K9 (`dense_chol`), which also
gives the inverted diagonal tiles of L' (kept on the factor as ``Dinv``),
the solves on K10 (`dense_trsv`, by those tiles), Σ = Q⁻¹ at the entries
wanted (diagonal, a pattern) on K10's second entry (`dense_selinv`), whose
sum for `selinv_dot` is K5's; `sqrt_matvec`'s L·z is a plain matrix product. The
logdet is differentiable through `DenseLogdet`, whose backward is Σ on Q's
pattern, `solve` through `FactorSolve` (K10 forward and backward), and Σ
through `SelectedInverse`: its tangent −Σ·sym(T)·Σ takes Σ in full from K10
on the identity and two matrix products (which the reference also leaves
to XLA). The triangular solves and ``sqrt_matvec`` go through
`FactorTriangular`: the Cholesky's adjoint Q̄ = sym(L⁻ᵀΦ(LᵀL̄)L⁻¹) is two
K10 solves on n right-hand sides and torch products (no kernel of its own),
its tangent L̇ = L·Φ(L⁻¹Q̇L⁻ᵀ) the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import SOLVE_BOTH, SOLVE_L, SOLVE_LT, DenseTables, dense_chol, dense_selinv, dense_trsv
from ..kernels.dense import DENSE_MAX_N
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import TRI_L, TRI_LINV, TRI_LINVT, DirectFactor, SelectedInverse

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


def _sigma(L: torch.Tensor, s: torch.Tensor, Dinv, pattern: SparsePattern | int) -> torch.Tensor:
    """Σ = Q⁻¹ at `pattern`'s entries (or the diagonal, for an int n), (B, m)."""
    n = L.shape[-1]
    if not isinstance(pattern, int) and tuple(pattern.shape) != (n, n):
        raise ValueError(f"pattern of shape {pattern.shape} does not match a factor of {n} x {n}")
    return dense_selinv(L, s, *_entries(pattern, L.device), Dinv=Dinv)


class DenseLogdet(torch.autograd.Function):
    """logdet of B precisions (data (B, nnz)) by K9, with the factor
    (L, s, level, Dinv) as non-differentiable outputs.

    Backward: ∂logdet/∂data_p = Σ_{row p, col p}, as JAX's Cholesky rule
    gives it (the reference symmetrizes its input, so each stored entry of
    a symmetric pair gets Σ_ij); Σ on the pattern from the saved factor by
    `SelectedInverse` (`dense_selinv`, no refactorization), differentiable in
    data. jvp: Σ_p Σ_{row p, col p} data̅'s tangent_p."""

    @staticmethod
    def forward(ctx, data, tables, pattern):
        L, s, level, logdet, Dinv = dense_chol(data.contiguous(), tables)
        ctx.mark_non_differentiable(*(x for x in (L, s, level, Dinv) if x is not None))
        ctx.save_for_backward(data, L, s, Dinv)
        ctx.save_for_forward(data, L, s, Dinv)
        ctx.pattern = pattern
        return logdet, L, s, level, Dinv

    @staticmethod
    def _factor(ctx):
        data, L, s, Dinv = ctx.saved_tensors
        return DenseFactor(L, s, None, None, (L.shape[0],), data, ctx.pattern, Dinv)

    @staticmethod
    def backward(ctx, glogdet, _gL, _gs, _glevel, _gDinv):
        f = DenseLogdet._factor(ctx)
        return glogdet[:, None] * SelectedInverse.apply(f, f.pattern, f.data), None, None

    @staticmethod
    def jvp(ctx, ddata, _tables, _pattern):
        f = DenseLogdet._factor(ctx)
        return (f._sigma(f.pattern) * ddata).sum(-1), None, None, None, None


@dataclasses.dataclass(frozen=True)
class DenseFactor(DirectFactor):
    """Equilibrated Cholesky of B chains: Q = (S⁻¹L')(S⁻¹L')ᵀ with L' (B, n, n)
    = chol(S·Q·S), s (B, n); ``level`` (B,) is the ridge rescue each chain
    needed (0 none, 1 δ, 2 500δ); ``Dinv`` (B, ⌈n/64⌉·64·64) holds the
    inverted 64 × 64 diagonal tiles of L' for K10 (None on CPU tensors)."""

    L: torch.Tensor
    s: torch.Tensor
    level: torch.Tensor
    logdet_: torch.Tensor
    batch_shape: tuple
    data: torch.Tensor = dataclasses.field(repr=False, compare=False)  # (B, nnz) factored
    pattern: SparsePattern = dataclasses.field(repr=False, compare=False)
    Dinv: torch.Tensor | None = dataclasses.field(default=None, repr=False, compare=False)

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
        return dense_trsv(self.L, self.s, self._rhs(b), mode, Dinv=self.Dinv).reshape(b.shape)

    def _solve_both(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b (K10, both triangles in one launch)."""
        return self._solve(b, SOLVE_BOTH)

    def _tri(self, op: int, z: torch.Tensor) -> torch.Tensor:
        """op(L) z with L = S⁻¹L' (`FactorTriangular`): the solves on K10, L z
        and Lᵀ z plain matrix products."""
        if op == TRI_LINV:
            return self._solve(z, SOLVE_L)
        if op == TRI_LINVT:
            return self._solve(z, SOLVE_LT)
        if op == TRI_L:
            return ((self.L @ self._rhs(z)) / self.s[..., None]).reshape(z.shape)
        return (self.L.mT @ (self._rhs(z) / self.s[..., None])).reshape(z.shape)

    def _dense_data(self, t: torch.Tensor) -> torch.Tensor:
        """sym(T) (B, n, n) for T given by t (B, nnz) on the pattern."""
        B, n = self.L.shape[0], self.n
        r, c = (torch.tensor(a, dtype=torch.long, device=t.device) for a in (self.pattern.rows, self.pattern.cols))
        T = t.new_zeros(B, n, n).index_put_((torch.arange(B, device=t.device)[:, None], r, c), t.reshape(B, -1),
                                            accumulate=True)
        return 0.5 * (T + T.mT)

    def _factor_adjoint(self, U: torch.Tensor, V: torch.Tensor) -> tuple:
        """data̅ for L̄ = P_L(U Vᵀ): with M = LᵀL̄, Q̄ = sym(L⁻ᵀΦ(M)L⁻¹) =
        ½L⁻ᵀ(Φ(M) + Φ(M)ᵀ)L⁻¹ by two K10 solves on n right-hand sides, at the
        pattern's entries."""
        Lbar = torch.tril(self._rhs(U) @ self._rhs(V).mT)
        M = torch.tril((self.L / self.s[..., None]).mT @ Lbar)
        Y = M + M.mT - torch.diag_embed(torch.diagonal(M, dim1=-2, dim2=-1))  # Φ(M) + Φ(M)ᵀ
        W = dense_trsv(self.L, self.s, Y, SOLVE_LT, Dinv=self.Dinv)
        Z = dense_trsv(self.L, self.s, W.mT.contiguous(), SOLVE_LT, Dinv=self.Dinv)
        r, c = (torch.tensor(a, dtype=torch.long, device=Z.device) for a in (self.pattern.rows, self.pattern.cols))
        return (0.25 * (Z[:, r, c] + Z[:, c, r]),)

    def _factor_tangent(self, dinputs) -> "DenseFactor":
        """The factor whose L' is L̇' = L'·Φ(L⁻¹Q̇L⁻ᵀ) (L = S⁻¹L'), by two K10 solves."""
        Qd = self._dense_data(self._tangent_data(dinputs))
        X = dense_trsv(self.L, self.s, Qd, SOLVE_L, Dinv=self.Dinv)
        Y = dense_trsv(self.L, self.s, X.mT.contiguous(), SOLVE_L, Dinv=self.Dinv)
        F = torch.tril(Y) - 0.5 * torch.diag_embed(torch.diagonal(Y, dim1=-2, dim2=-1))
        return dataclasses.replace(self, L=self.L @ F)

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def _sigma(self, where) -> torch.Tensor:
        """Σ at the entries `where` (an int n: the diagonal; a pattern), (B, m) (K10's `dense_selinv`)."""
        return _sigma(self.L, self.s, self.Dinv, where)

    def _sigma_full(self) -> torch.Tensor:
        """Σ = Q⁻¹ in full, (B, n, n): K10 on the identity."""
        B, n = self.L.shape[0], self.n
        eye = torch.eye(n, dtype=self.L.dtype, device=self.L.device).expand(B, n, n).contiguous()
        return dense_trsv(self.L, self.s, eye, SOLVE_BOTH, Dinv=self.Dinv)

    def _sigma_tangent(self, t: torch.Tensor, p_in, p_out) -> torch.Tensor:
        """−Σ·sym(T)·Σ at p_out's entries for T given by t (B, m) on p_in's:
        Σ in full, then two matrix products."""
        B, n = self.L.shape[0], self.n
        Sig = self._sigma_full()
        if isinstance(p_in, int):
            T = torch.diag_embed(t)
        else:
            r, c = (torch.tensor(a, dtype=torch.long, device=t.device) for a in (p_in.rows, p_in.cols))
            T = t.new_zeros(B, n, n).index_put_((torch.arange(B, device=t.device)[:, None], r, c), t.reshape(B, -1),
                                                accumulate=True)
            T = 0.5 * (T + T.mT)
        M = Sig @ T @ Sig
        if isinstance(p_out, int):
            return -torch.diagonal(M, dim1=-2, dim2=-1)
        r, c = (torch.tensor(a, dtype=torch.long, device=t.device) for a in (p_out.rows, p_out.cols))
        return -M[:, r, c]


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
    logdet, L, s, level, Dinv = DenseLogdet.apply(data, _tables(Q.pattern), Q.pattern)
    return DenseFactor(L, s, level, logdet.reshape(batch), batch, data, Q.pattern, Dinv)
