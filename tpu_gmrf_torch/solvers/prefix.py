"""Parallel-prefix primitives for first-order recurrences (plain PyTorch).

Counterpart of ``tpu_gmrf.solvers.prefix``. The reference solves each
recurrence with ``jax.lax.associative_scan``; here the same combines run as
a Hillis-Steele doubling scan (``ceil(log2 n)`` stages of whole-tensor ops),
which keeps the rounding close to the reference's. These are the plain
versions behind the tridiagonal kernels K1-K3 (``tpu_gmrf_torch.kernels``):
the CPU path uses them, and the card's kernels are checked against them.

Shapes: the scan runs along the last axis of ``alpha`` (``(..., n)``); any
leading axes are batch axes (one recurrence per chain), and ``beta`` may
carry trailing right-hand-side axes after ``n``.
"""

from __future__ import annotations

import torch

__all__ = ["linear_recurrence", "mobius_recurrence"]


def _shifted(t: torch.Tensor, axis: int, s: int):
    """(head, prev, cur): t[:s], t[:-s], t[s:] along `axis`."""
    n = t.shape[axis]
    return t.narrow(axis, 0, s), t.narrow(axis, 0, n - s), t.narrow(axis, s, n - s)


def linear_recurrence(alpha: torch.Tensor, beta: torch.Tensor, reverse: bool = False):
    """Solve y_k = alpha_k * y_{k-1} + beta_k along the last axis of alpha.

    alpha: (..., n). beta: (..., n) or (..., n, *rhs). y_0 = beta_0 (a zero
    initial carry). Returns all y_k, shape of beta.
    """
    axis = alpha.ndim - 1
    if beta.ndim > alpha.ndim:
        alpha = alpha.reshape(alpha.shape + (1,) * (beta.ndim - alpha.ndim))
    if reverse:
        alpha, beta = alpha.flip(axis), beta.flip(axis)
    n = beta.shape[axis]
    a, b = alpha, beta
    s = 1
    while s < n:
        a_head, a_prev, a_cur = _shifted(a, axis, s)
        b_head, b_prev, b_cur = _shifted(b, axis, s)
        # combine(earlier, later) = (a2*a1, a2*b1 + b2), prefix.py:43-46
        a = torch.cat([a_head, a_cur * a_prev], axis)
        b = torch.cat([b_head, a_cur * b_prev + b_cur], axis)
        s *= 2
    return b.flip(axis) if reverse else b


def mobius_recurrence(a, b, c, d, p0, q0):
    """Cumulative Möbius transforms: x_k = (a_k x_{k-1} + b_k)/(c_k x_{k-1} + d_k).

    a, b, c, d: (..., n) step coefficients (k = 1..n). p0, q0: scalars or
    (...,) tensors with x_0 = p0/q0. Returns x_1..x_n, shape (..., n).

    Each combine is the unrolled 2x2 product normalized by its max-abs
    entry, as in the reference (prefix.py:63-79): the ratio is unchanged
    and float32 stays in range for any n.
    """
    tiny = torch.finfo(a.dtype).tiny
    axis = a.ndim - 1
    n = a.shape[axis]
    m = (a, b, c, d)
    s = 1
    while s < n:
        parts = [_shifted(t, axis, s) for t in m]
        a1, b1, c1, d1 = (p[1] for p in parts)  # earlier
        a2, b2, c2, d2 = (p[2] for p in parts)  # later
        a3 = a2 * a1 + b2 * c1
        b3 = a2 * b1 + b2 * d1
        c3 = c2 * a1 + d2 * c1
        d3 = c2 * b1 + d2 * d1
        scale = torch.maximum(
            torch.maximum(a3.abs(), b3.abs()), torch.maximum(c3.abs(), d3.abs())
        ).clamp_min(tiny)
        m = tuple(
            torch.cat([p[0], v / scale], axis)
            for p, v in zip(parts, (a3, b3, c3, d3))
        )
        s *= 2
    A, B, C, D = m
    p0 = torch.as_tensor(p0, dtype=a.dtype, device=a.device)
    q0 = torch.as_tensor(q0, dtype=a.dtype, device=a.device)
    if p0.ndim:
        p0 = p0.unsqueeze(-1)
    if q0.ndim:
        q0 = q0.unsqueeze(-1)
    return (A * p0 + B * q0) / (C * p0 + D * q0)
