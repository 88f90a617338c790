"""Tridiagonal Cholesky backend (AR1 / RW1 precisions), batched over chains.

Counterpart of ``tpu_gmrf.solvers.tridiag``. A `TridiagFactor` holds the
bidiagonal Cholesky factor Q = L Lᵀ of B tridiagonal matrices at once:
diagonal ``d`` (..., n) and subdiagonal ``e`` (..., n-1). Factorization,
solves and the Takahashi recursion run on the kernels K1-K3
(``tpu_gmrf_torch.kernels``); the logdet is differentiable through
`TridiagLogdet`, whose backward is the selected inverse, `solve` through
`FactorSolve` (K2 forward and backward), and the selected inverse through
`TridiagSelinv` (K3), whose backward and jvp are K19's tangent pass. Each
backward is differentiable once more, so a Hessian reaches K19. The
triangular solves and ``sqrt_matvec`` go through `FactorTriangular`: their
data cotangent is K23's reverse sweep of K1 (`tridiag_factor_adjoint`), the
factor's tangent K2's forward scan on the pivots' tangent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import (SOLVE_BOTH, SOLVE_L, SOLVE_LT, tridiag_factor, tridiag_factor_adjoint, tridiag_selinv,
                       tridiag_selinv_tangent, tridiag_solve)
from .base import TRI_L, TRI_LINV, TRI_LINVT, DirectFactor, no_double_backward
from ..sparse.matrix import SparseMatrix, _index
from ..sparse.pattern import SparsePattern

__all__ = ["TridiagFactor", "TridiagLogdet", "TridiagSelinv", "tridiag_factorize"]


def _rows(t: torch.Tensor, n_last: int):
    """Flatten the chain axes of a (..., m) tensor to (B, m)."""
    return t.reshape(-1, n_last).contiguous()


def _or_zeros(t, like):
    return torch.zeros_like(like) if t is None else t.contiguous()


class TridiagSelinv(torch.autograd.Function):
    """Σ on the tridiagonal, (zdiag (B, n), zoff (B, n-1)), zoff_k = Σ_{k+1,k},
    of tridiag(a, c) from its factor (d, e) by K3; differentiable in a and c.

    apply(a, c, d, e). Backward: K19's tangent pass in the direction
    (ȧ, ċ) = (z̄diag, z̄off/2), sym(S) for the cotangent S, gives
    (ā, c̄) = (Σ̇diag, 2 Σ̇off): c sits at (k+1, k) and (k, k+1). jvp: K19 in
    the direction (ȧ, ċ). The backward is not differentiable again."""

    @staticmethod
    def forward(ctx, a, c, d, e):
        zdiag, zoff = tridiag_selinv(d, e)
        ctx.save_for_backward(d, e, zdiag)
        ctx.save_for_forward(d, e, zdiag)
        return zdiag, zoff

    @staticmethod
    def backward(ctx, gzd, gzo):
        no_double_backward("the selected inverse's derivative")
        d, e, zdiag = ctx.saved_tensors
        dzd, dzo = tridiag_selinv_tangent(d, e, zdiag, _or_zeros(gzd, d), 0.5 * _or_zeros(gzo, e))
        return dzd, 2.0 * dzo, None, None

    @staticmethod
    def jvp(ctx, da, dc, _dd, _de):
        d, e, zdiag = ctx.saved_tensors
        return tridiag_selinv_tangent(d, e, zdiag, _or_zeros(da, d), _or_zeros(dc, e))


class TridiagLogdet(torch.autograd.Function):
    """logdet of tridiag(a, c) by K1, with the factor as non-differentiable outputs.

    Backward: ∂/∂a_k = Σ_kk and ∂/∂c_k = 2 Σ_{k+1,k}, Σ by `TridiagSelinv`
    (K3; differentiable in a and c through K19). jvp: Σ_k Σ_kk ȧ_k + 2 Σ_{k+1,k} ċ_k."""

    @staticmethod
    def forward(ctx, a, c):
        d, e, logdet = tridiag_factor(a, c)
        ctx.mark_non_differentiable(d, e)
        ctx.save_for_backward(a, c, d, e)
        ctx.save_for_forward(d, e)
        return logdet, d, e

    @staticmethod
    def backward(ctx, glogdet, _gd, _ge):
        a, c, d, e = ctx.saved_tensors
        zdiag, zoff = TridiagSelinv.apply(a, c, d, e)
        g = glogdet[:, None]
        return g * zdiag, 2.0 * g * zoff

    @staticmethod
    def jvp(ctx, da, dc):
        d, e = ctx.saved_tensors
        zdiag, zoff = tridiag_selinv(d, e)
        return (zdiag * _or_zeros(da, d)).sum(-1) + 2.0 * (zoff * _or_zeros(dc, e)).sum(-1), None, None


@dataclasses.dataclass(frozen=True)
class TridiagFactor(DirectFactor):
    """Q = L Lᵀ with L lower bidiagonal: diag d (..., n), subdiag e (..., n-1),
    the differentiable log-determinant computed with them (K1), and the rows
    a (B, n), c (B, n-1) of tridiag(a, c) = Q they were factored from."""

    d: torch.Tensor
    e: torch.Tensor
    logdet_: torch.Tensor
    a: torch.Tensor = dataclasses.field(repr=False, compare=False)
    c: torch.Tensor = dataclasses.field(repr=False, compare=False)

    @property
    def n(self):
        return self.d.shape[-1]

    @property
    def batch_shape(self):
        return self.d.shape[:-1]

    def _solve(self, b: torch.Tensor, mode: int) -> torch.Tensor:
        """b (*batch, n) or (*batch, n, k)."""
        n, bs = self.n, self.batch_shape
        if b.shape[: len(bs) + 1] != bs + (n,) or b.ndim not in (len(bs) + 1, len(bs) + 2):
            raise ValueError(f"rhs of shape {tuple(b.shape)} does not match a factor of {tuple(bs)} x {n}")
        rhs = b.reshape((-1, n) + b.shape[len(bs) + 1:]).contiguous()
        out = tridiag_solve(_rows(self.d, n), _rows(self.e, n - 1), rhs, mode)
        return out.reshape(b.shape)

    def _solve_both(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b, both triangular solves fused in one launch (K2)."""
        return self._solve(b, SOLVE_BOTH)

    @property
    def grad_inputs(self):
        return (self.a, self.c)

    def _input_grads(self, gb: torch.Tensor, x: torch.Tensor):
        """ā_k = −Σ b̄_k x_k and c̄_k = −Σ (b̄_{k+1} x_k + b̄_k x_{k+1}): c sits at
        (k+1, k) and (k, k+1), as in `TridiagLogdet`'s backward."""
        B, n = self.a.shape
        gb, x = gb.reshape(B, n, -1), x.reshape(B, n, -1)
        ga = -(gb * x).sum(-1)
        gc = -(gb[:, 1:] * x[:, :-1] + gb[:, :-1] * x[:, 1:]).sum(-1)
        return ga, gc

    def _tangent_matvec(self, dinputs, x: torch.Tensor) -> torch.Tensor:
        """Q̇ x for the tangents (ȧ, ċ) of the rows: ȧ_k x_k + ċ_{k-1} x_{k-1} + ċ_k x_{k+1}."""
        B, n = self.a.shape
        da, dc = (_or_zeros(t, like) for t, like in zip(dinputs, (self.a, self.c)))
        xr = x.reshape(B, n, -1)
        y = da[..., None] * xr
        y = y + torch.cat([torch.zeros_like(xr[:, :1]), dc[..., None] * xr[:, :-1]], 1)
        y = y + torch.cat([dc[..., None] * xr[:, 1:], torch.zeros_like(xr[:, :1])], 1)
        return y.reshape(x.shape)

    def _tri(self, op: int, z: torch.Tensor) -> torch.Tensor:
        """op(L) z (`FactorTriangular`): the solves on K2, L z and Lᵀ z by torch
        products with the two diagonals; z (*batch, n) or (*batch, n, k)."""
        if op == TRI_LINV:
            return self._solve(z, SOLVE_L)
        if op == TRI_LINVT:
            return self._solve(z, SOLVE_LT)
        nb = len(self.batch_shape)
        extra = (1,) * (z.ndim - nb - 1)
        d = self.d.reshape(self.d.shape + extra)
        e = self.e.reshape(self.e.shape + extra)
        main = d * z
        if op == TRI_L:
            lower = e * z.narrow(nb, 0, self.n - 1)
            return main + torch.cat([torch.zeros_like(main.narrow(nb, 0, 1)), lower], nb)
        upper = e * z.narrow(nb, 1, self.n - 1)
        return main + torch.cat([upper, torch.zeros_like(main.narrow(nb, 0, 1))], nb)

    def _factor_adjoint(self, U: torch.Tensor, V: torch.Tensor) -> tuple:
        """(ā, c̄) for L̄ = P_L(U Vᵀ): d̄_j = Σ U_j V_j, ē_j = Σ U_{j+1} V_j over the
        right-hand sides, then K23."""
        B, n = self.a.shape
        U, V = U.reshape(B, n, -1), V.reshape(B, n, -1)
        gd = (U * V).sum(-1)
        ge = (U[:, 1:] * V[:, :-1]).sum(-1)
        return tridiag_factor_adjoint(_rows(self.d, n), _rows(self.e, n - 1), gd.contiguous(), ge.contiguous())

    def _factor_tangent(self, dinputs) -> "TridiagFactor":
        """The factor (ḋ, ė) in the direction (ȧ, ċ): the pivots' tangent
        δ̇_k = r²_{k-1} δ̇_{k-1} + ȧ_k − 2 r_{k-1} ċ_{k-1} (r = e/d) by K2's
        forward scan on the unit bidiagonal with subdiagonal −r², then
        ḋ = δ̇/(2d) and ė = (ċ − e ḋ)/d."""
        B, n = self.a.shape
        da, dc = (_or_zeros(t, like) for t, like in zip(dinputs, (self.a, self.c)))
        d, e = _rows(self.d, n), _rows(self.e, n - 1)
        r = e / d[:, :-1]
        rhs = da - torch.cat([torch.zeros_like(da[:, :1]), 2.0 * r * dc], 1)
        ddelta = tridiag_solve(torch.ones_like(d), (-r * r).contiguous(), rhs.contiguous(), SOLVE_L)
        dd = ddelta / (2.0 * d)
        de = (dc - e * dd[:, :-1]) / d[:, :-1]
        return dataclasses.replace(self, d=dd.reshape(self.d.shape), e=de.reshape(self.e.shape))

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def selinv_tridiag(self):
        """Takahashi recursion (K3): (Zdiag (..., n), Zoff (..., n-1)) of Q⁻¹,
        differentiable in the rows a and c through `TridiagSelinv`."""
        n = self.n
        zdiag, zoff = TridiagSelinv.apply(self.a, self.c, _rows(self.d, n), _rows(self.e, n - 1))
        return zdiag.reshape(self.d.shape), zoff.reshape(self.e.shape)

    def _selected(self, where):
        zdiag, zoff = self.selinv_tridiag()
        zdiag, zoff = zdiag.reshape(-1, self.n), zoff.reshape(-1, self.n - 1)
        if isinstance(where, int):
            return zdiag
        pattern = where
        off = pattern.rows.astype(np.int64) - pattern.cols
        if np.any(np.abs(off) > 1):
            raise ValueError("tridiag selinv only supports tridiagonal patterns")
        dev = self.d.device
        lower = np.minimum(np.minimum(pattern.rows, pattern.cols), max(self.n - 2, 0))
        return torch.where(
            _index(pattern, "ondiag", off == 0, dev, torch.bool),
            zdiag[..., _index(pattern, "rows", pattern.rows, dev)],
            zoff[..., _index(pattern, "lower", lower, dev)],
        )


def _sub_positions(pat: SparsePattern) -> np.ndarray:
    """Entry index of Q[i+1, i] for each i, or -1 where the pattern lacks it."""
    n = pat.shape[0]
    sub_mask = pat.rows == pat.cols + 1
    sub_pos = np.full(n - 1, -1, dtype=np.int64)
    sub_pos[pat.cols[sub_mask]] = np.nonzero(sub_mask)[0]
    return sub_pos


def tridiag_factorize(Q: SparseMatrix) -> TridiagFactor:
    """Factor B tridiagonal matrices (data (nnz,) or (B, nnz)) with K1.

    As in the reference, Q is first averaged with its transpose, so the
    gradient of the logdet splits evenly over both stored triangle entries;
    a missing subdiagonal entry is a zero that receives no gradient."""
    if Q.pattern.is_symmetric:
        Q = Q.symmetrize()
    pat = Q.pattern
    n = pat.shape[0]
    dev = Q.data.device
    a = Q.diagonal()
    sub_pos = _sub_positions(pat)
    present = sub_pos >= 0
    if np.all(present):
        c = Q.data[..., _index(pat, "subpos", sub_pos, dev)]
    else:
        c = Q.data.new_zeros(Q.data.shape[:-1] + (n - 1,))
        where = torch.as_tensor(np.nonzero(present)[0], device=dev)
        c = c.index_copy(-1, where, Q.data[..., torch.as_tensor(sub_pos[present], device=dev)])
    batch = a.shape[:-1]
    a_rows, c_rows = _rows(a, n), _rows(c, n - 1)
    logdet, d, e = TridiagLogdet.apply(a_rows, c_rows)
    return TridiagFactor(d.reshape(a.shape), e.reshape(c.shape), logdet.reshape(batch), a_rows, c_rows)
