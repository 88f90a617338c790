"""Tridiagonal Cholesky backend (AR1 / RW1 precisions), batched over chains.

Counterpart of ``tpu_gmrf.solvers.tridiag``. A `TridiagFactor` holds the
bidiagonal Cholesky factor Q = L Lᵀ of B tridiagonal matrices at once:
diagonal ``d`` (..., n) and subdiagonal ``e`` (..., n-1). Factorization,
solves and the Takahashi recursion run on the kernels K1-K3
(``tpu_gmrf_torch.kernels``); the logdet is differentiable through
`TridiagLogdet`, whose backward is the selected inverse (K3), and `solve`
through `FactorSolve` (K2 forward and backward). The other solves and the
selected inverse have no backward and raise while a gradient is asked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import SOLVE_BOTH, SOLVE_L, SOLVE_LT, tridiag_factor, tridiag_selinv, tridiag_solve
from .base import DirectFactor, no_double_backward
from ..sparse.matrix import SparseMatrix, _index
from ..sparse.pattern import SparsePattern

__all__ = ["TridiagFactor", "TridiagLogdet", "tridiag_factorize"]


def _rows(t: torch.Tensor, n_last: int):
    """Flatten the chain axes of a (..., m) tensor to (B, m)."""
    return t.reshape(-1, n_last).contiguous()


class TridiagLogdet(torch.autograd.Function):
    """logdet of tridiag(a, c) by K1, with the factor as non-differentiable outputs.

    Backward: ∂/∂a_k = Σ_kk and ∂/∂c_k = 2 Σ_{k+1,k}, both from K3."""

    @staticmethod
    def forward(ctx, a, c):
        d, e, logdet = tridiag_factor(a, c)
        ctx.mark_non_differentiable(d, e)
        ctx.save_for_backward(d, e)
        return logdet, d, e

    @staticmethod
    def backward(ctx, glogdet, _gd, _ge):
        no_double_backward("the tridiag logdet")
        d, e = ctx.saved_tensors
        zdiag, zoff = tridiag_selinv(d, e)
        g = glogdet[:, None]
        return g * zdiag, 2.0 * g * zoff


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

    def forward_solve(self, b: torch.Tensor) -> torch.Tensor:
        """L y = b (K2)."""
        return self._solve(b, SOLVE_L)

    def backward_solve(self, z: torch.Tensor) -> torch.Tensor:
        """Lᵀ x = z (K2)."""
        return self._solve(z, SOLVE_LT)

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

    def sqrt_matvec(self, z: torch.Tensor) -> torch.Tensor:
        """L z for z (*batch, n) or (*batch, n, k); plain torch."""
        nb = len(self.batch_shape)
        extra = (1,) * (z.ndim - nb - 1)
        d = self.d.reshape(self.d.shape + extra)
        e = self.e.reshape(self.e.shape + extra)
        main = d * z
        lower = e * z.narrow(nb, 0, self.n - 1)
        return main + torch.cat([torch.zeros_like(main.narrow(nb, 0, 1)), lower], nb)

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def selinv_tridiag(self):
        """Takahashi recursion (K3): (Zdiag (..., n), Zoff (..., n-1)) of Q⁻¹."""
        n = self.n
        zdiag, zoff = tridiag_selinv(_rows(self.d, n), _rows(self.e, n - 1))
        return zdiag.reshape(self.d.shape), zoff.reshape(self.e.shape)

    def selinv_diag(self) -> torch.Tensor:
        return self.selinv_tridiag()[0]

    def selinv(self, pattern: SparsePattern) -> SparseMatrix:
        zdiag, zoff = self.selinv_tridiag()
        off = pattern.rows.astype(np.int64) - pattern.cols
        if np.any(np.abs(off) > 1):
            raise ValueError("tridiag selinv only supports tridiagonal patterns")
        dev = self.d.device
        lower = np.minimum(np.minimum(pattern.rows, pattern.cols), max(self.n - 2, 0))
        vals = torch.where(
            _index(pattern, "ondiag", off == 0, dev, torch.bool),
            zdiag[..., _index(pattern, "rows", pattern.rows, dev)],
            zoff[..., _index(pattern, "lower", lower, dev)],
        )
        return SparseMatrix(vals, pattern)


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
