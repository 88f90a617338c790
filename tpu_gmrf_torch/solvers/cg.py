"""Preconditioned conjugate gradients + preconditioners for large
spatiotemporal systems.

Counterpart of ``tpu_gmrf.solvers.cg``. CG is a host loop of sparse
multiplies (`kernels.hot_matvec`: K4, K13 or K14) and torch vector
operations. Several right-hand sides run as one batched, masked loop: b is
(n,) or rows (k, n) (the reference vmaps its scalar CG over (n, k) columns);
each row has its own α, β and stopping iteration, and a row that has
stopped is frozen. The stopping test ‖r‖ > tol·max(‖b‖, 1e-30) is made before
every iteration, as the reference's ``while_loop`` does, which costs one
readback per iteration.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "cg_solve",
    "full_cholesky_preconditioner",
    "jacobi_preconditioner",
    "block_jacobi_preconditioner",
    "temporal_block_gauss_seidel_preconditioner",
]


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    preconditioner: Callable | None = None,
    x0=None,
    tol: float = 1e-6,
    max_iter: int = 1000,
):
    """Solve A x = b (A SPD) by preconditioned CG. b is (n,), or rows (k, n)
    solved together (`matvec` and `preconditioner` then take rows). Returns
    (x, iterations, relative residual), the last two per row."""
    M = preconditioner if preconditioner is not None else (lambda r: r)
    with torch.no_grad():
        x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
        r = b - matvec(x)
        z = M(r)
        p = z
        rz = (r * z).sum(-1)
        bnorm = torch.linalg.vector_norm(b, dim=-1).clamp_min(1e-30)
        thresh = tol * bnorm
        it = torch.zeros(b.shape[:-1], dtype=torch.long, device=b.device)
        active = torch.linalg.vector_norm(r, dim=-1) > thresh
        if max_iter <= 0:
            active = torch.zeros_like(active)
        one = torch.ones_like(rz)
        while bool(active.any()):
            Ap = matvec(p)
            # a stopped row keeps its state: α = β = 0 there, and no 0/0
            alpha = torch.where(active, rz / torch.where(active, (p * Ap).sum(-1), one), 0.0)
            x = x + alpha[..., None] * p
            r = r - alpha[..., None] * Ap
            z = M(r)
            rz_new = (r * z).sum(-1)
            beta = rz_new / torch.where(active, rz, one)
            p = torch.where(active[..., None], z + beta[..., None] * p, p)
            rz = torch.where(active, rz_new, rz)
            it = it + active
            active = active & (torch.linalg.vector_norm(r, dim=-1) > thresh) & (it < max_iter)
        relres = torch.linalg.vector_norm(r, dim=-1) / bnorm
    return x, it, relres


def _per_row(apply_cols: Callable) -> Callable:
    """A preconditioner on r (n,) or rows (k, n) from one on columns (n, k)."""

    def apply(r):
        if r.ndim == 1:
            return apply_cols(r[:, None])[:, 0]
        return apply_cols(r.mT).mT

    return apply


def jacobi_preconditioner(Q) -> Callable:
    dinv = 1.0 / Q.diagonal()
    return lambda r: dinv * r


def block_jacobi_preconditioner(Q, block_size: int) -> Callable:
    """Dense-inverts contiguous diagonal blocks (pad last block)."""
    n = Q.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    Qp = torch.nn.functional.pad(Q.todense(), (0, pad, 0, pad))
    if pad:
        idx = torch.arange(n, n + pad, device=Qp.device)
        Qp[idx, idx] = 1.0
    blocks = torch.stack(
        [Qp[i * block_size: (i + 1) * block_size, i * block_size: (i + 1) * block_size] for i in range(nb)]
    )
    chols = torch.linalg.cholesky(blocks)

    def apply_cols(r):  # (n, k)
        rp = torch.nn.functional.pad(r, (0, 0, 0, pad)).reshape(nb, block_size, -1)
        return torch.cholesky_solve(rp, chols).reshape(nb * block_size, -1)[:n]

    return _per_row(apply_cols)


def temporal_block_gauss_seidel_preconditioner(Q, Ns: int, Nt: int, sweeps: int = 1) -> Callable:
    """Symmetric block Gauss-Seidel over the time dimension of a
    block-tridiagonal space-time precision: extracts the Nt diagonal blocks
    (dense-factorized once, batched) and the sub-diagonal blocks, then runs
    forward+backward sweeps (reference tridiag_block_gauss_seidel.jl)."""
    Qd = Q.todense()
    diag_blocks = torch.stack([Qd[t * Ns: (t + 1) * Ns, t * Ns: (t + 1) * Ns] for t in range(Nt)])
    sub_blocks = [Qd[(t + 1) * Ns: (t + 2) * Ns, t * Ns: (t + 1) * Ns] for t in range(Nt - 1)]
    chols = torch.linalg.cholesky(diag_blocks)

    def apply_cols(r):  # (n, k)
        rb = r.reshape(Nt, Ns, -1)
        x = [torch.zeros_like(rb[0]) for _ in range(Nt)]
        for _ in range(sweeps):
            for t in range(Nt):  # forward sweep
                rhs = rb[t] - sub_blocks[t - 1] @ x[t - 1] if t > 0 else rb[t]
                x[t] = torch.cholesky_solve(rhs, chols[t])
            # standard symmetric GS backward: x_t = D_t^{-1}(r_t - L x_{t-1} - U x_{t+1})
            for t in reversed(range(Nt)):
                rhs = rb[t] - sub_blocks[t - 1] @ x[t - 1] if t > 0 else rb[t]
                if t < Nt - 1:
                    rhs = rhs - sub_blocks[t].mT @ x[t + 1]
                x[t] = torch.cholesky_solve(rhs, chols[t])
        return torch.cat(x, 0)

    return _per_row(apply_cols)


def full_cholesky_preconditioner(Q, spec=None) -> Callable:
    """P = Q itself, applied via a full factorization — one CG iteration
    converges exactly; a building block for hybrid schemes (reference
    src/preconditioners/full_cholesky.jl:15-35). The factorization backend
    follows the pattern (the solver dispatch)."""
    from .base import SolverSpec, factorize

    with torch.no_grad():
        factor = factorize(Q, spec if spec is not None else SolverSpec())

    def apply_cols(r):
        with torch.no_grad():
            return factor.solve(r.contiguous())

    return _per_row(apply_cols)
