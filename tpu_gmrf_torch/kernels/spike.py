"""Wrapper of K18 `spike_reduced` (``csrc/spike.cu``) and its plain version.

K18 solves the SPIKE solve's interface system (``parallel/pbtridiag.py``):
the P-block tridiagonal system over the chunk boundaries, rows
α_d s_{d-1} + β_d s_d + γ_d s_{d+1} = r_d with α, β, γ (P, ns, ns) and
r (P, ns, k), by block elimination and back substitution
(``tpu_gmrf/parallel/pbtridiag.py:100`` `_reduced_solve`). It returns
s (P, ns, k), logdet = 2 Σ log diag chol(C_d) and the factors
chol(C_d) (P, ns, ns); given those factors (`factors=`), it solves another
right-hand side without refactoring (β is then not read and the logdet is
None): the second solve of a gradient.

A CPU tensor takes the plain version (``torch.linalg``); a CUDA tensor
launches the kernel or raises. ``spike_reduced.launches`` counts launches.
"""

from __future__ import annotations

import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["spike_reduced", "spike_reduced_plain"]


def _chol(C: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (C + Cᵀ)/2; NaN where it breaks down, as ``jnp.linalg.cholesky``."""
    L, info = torch.linalg.cholesky_ex(0.5 * (C + C.mT))
    return L if int(info) == 0 else torch.full_like(L, torch.nan)


def spike_reduced_plain(alpha, beta, gamma, r, factors=None):
    """K18's function: (s (P, ns, k), logdet or None, factors (P, ns, ns))."""
    P = alpha.shape[0]
    Ls = [] if factors is None else list(factors.unbind(0))
    ys = []
    for d in range(P):
        y = r[d]
        if d > 0:
            Lp = Ls[d - 1]
            if factors is None:
                V = torch.linalg.solve_triangular(Lp, alpha[d].mT, upper=False)
                Z = torch.linalg.solve_triangular(Lp, gamma[d - 1], upper=False)
                C = beta[d] - V.mT @ Z
            y = y - alpha[d] @ torch.cholesky_solve(ys[d - 1], Lp)
        elif factors is None:
            C = beta[0]
        if factors is None:
            Ls.append(_chol(C))
        ys.append(y)
    s = [None] * P
    for d in reversed(range(P)):
        rhs = ys[d] if d == P - 1 else ys[d] - gamma[d] @ s[d + 1]
        s[d] = torch.cholesky_solve(rhs, Ls[d])
    L = torch.stack(Ls)
    logdet = None if factors is not None else 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum()
    return torch.stack(s), logdet, L


def spike_reduced(alpha, beta, gamma, r, factors=None):
    """K18: the interface system of the SPIKE solve (module docstring); one
    launch, one block of threads. Not differentiable."""
    if alpha.ndim != 3 or r.ndim != 3 or alpha.shape[1] != alpha.shape[2] or gamma.shape != alpha.shape \
            or r.shape[:2] != alpha.shape[:2] or (factors is None and beta.shape != alpha.shape) \
            or (factors is not None and factors.shape != alpha.shape):
        raise ValueError(f"spike_reduced: shapes alpha {tuple(alpha.shape)}, r {tuple(r.shape)}")
    given = [alpha, gamma, r] + ([beta] if factors is None else [factors])
    if torch.is_grad_enabled() and any(t.requires_grad for t in given):
        raise NotImplementedError("spike_reduced has no backward; call it under torch.no_grad()")
    if not _on_cuda("spike_reduced", *given):
        return spike_reduced_plain(alpha, beta, gamma, r, factors)
    P, ns, k = r.shape
    s = torch.empty_like(r)
    L = torch.empty_like(alpha) if factors is None else factors
    logdet = alpha.new_empty(1)
    work = alpha.new_empty(2 * ns * ns + ns * k)
    code = _fn("tg_spike_reduced", alpha.dtype)(
        alpha.data_ptr(), None if factors is not None else beta.data_ptr(), gamma.data_ptr(), r.data_ptr(),
        P, ns, k, L.data_ptr(), int(factors is not None), s.data_ptr(), work.data_ptr(), logdet.data_ptr(),
        _stream(alpha),
    )
    build.check(code, "spike_reduced", f" at P={P} ns={ns} k={k} {alpha.dtype}")
    spike_reduced.launches += 1
    return s, (None if factors is not None else logdet[0]), L


spike_reduced.launches = 0
