"""Wrappers of the tridiagonal kernels K1-K3 and their plain versions.

Each wrapper takes batched rows, one chain per row. A CPU tensor goes to the
plain PyTorch version (the Hillis-Steele scans of ``solvers/prefix.py``); a
CUDA tensor launches the hand-written kernel of ``csrc/tridiag.cu`` and
raises if it cannot. Any other device raises. ``<wrapper>.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from ..solvers.prefix import linear_recurrence, mobius_recurrence
from . import build

__all__ = [
    "tridiag_factor", "tridiag_solve", "tridiag_selinv",
    "tridiag_factor_plain", "tridiag_solve_plain", "tridiag_selinv_plain",
    "SOLVE_L", "SOLVE_LT", "SOLVE_BOTH",
]

SOLVE_L, SOLVE_LT, SOLVE_BOTH = 0, 1, 2
# Dynamic shared memory a block may use without an opt-in attribute.
SMEM_LIMIT = 48 * 1024


# ---- plain versions ---------------------------------------------------------


def tridiag_factor_plain(a: torch.Tensor, c: torch.Tensor):
    """(d, e, logdet) of the bidiagonal Cholesky of tridiag(a, c), batched.

    Pivots by the normalized Möbius scan, as ``tridiag.py:121-129``."""
    ones = torch.ones_like(c)
    delta_rest = mobius_recurrence(a[..., 1:], -c * c, ones, torch.zeros_like(c), a[..., 0], 1.0)
    delta = torch.cat([a[..., :1], delta_rest], -1)
    d = torch.sqrt(delta)
    e = c / d[..., :-1]
    return d, e, 2.0 * torch.log(d).sum(-1)


def tridiag_solve_plain(d: torch.Tensor, e: torch.Tensor, b: torch.Tensor, mode: int = SOLVE_BOTH):
    """L y = b (mode 0), Lᵀ x = b (mode 1) or both (mode 2); b (B, n) or (B, n, k)."""
    zero = torch.zeros_like(d[..., :1])
    dcol = d.reshape(d.shape + (1,) * (b.ndim - d.ndim))
    if mode != SOLVE_LT:
        alpha = -torch.cat([zero, e], -1) / d
        b = linear_recurrence(alpha, b / dcol)
    if mode != SOLVE_L:
        alpha = -torch.cat([e, zero], -1) / d
        b = linear_recurrence(alpha, b / dcol, reverse=True)
    return b


def tridiag_selinv_plain(d: torch.Tensor, e: torch.Tensor):
    """Takahashi (zdiag (B, n), zoff (B, n-1)) of Q⁻¹, ``tridiag.py:70-81``."""
    r = e / d[..., :-1]
    alpha = torch.cat([r * r, torch.zeros_like(d[..., :1])], -1)
    zdiag = linear_recurrence(alpha, 1.0 / (d * d), reverse=True)
    return zdiag, -r * zdiag[..., 1:]


# ---- checks shared by the wrappers -----------------------------------------


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {dtype} not supported (float32/float64)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _check_rows(name: str, diag: torch.Tensor, off: torch.Tensor):
    if diag.ndim != 2 or off.ndim != 2:
        raise ValueError(f"{name}: expected (B, n) and (B, n-1), got {tuple(diag.shape)}, {tuple(off.shape)}")
    B, n = diag.shape
    if n < 1 or off.shape != (B, n - 1):
        raise ValueError(f"{name}: expected (B, n) and (B, n-1), got {tuple(diag.shape)}, {tuple(off.shape)}")
    return B, n


def _check_smem(name: str, elems: int, dtype: torch.dtype):
    need = elems * (4 if dtype == torch.float32 else 8)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"{name}: one chain needs {need} bytes of shared memory, over the "
            f"{SMEM_LIMIT}-byte limit of this kernel"
        )


def _fn(name: str, dtype: torch.dtype):
    return getattr(build.library(), f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- wrappers ---------------------------------------------------------------


def tridiag_factor(a: torch.Tensor, c: torch.Tensor):
    """K1: (d (B, n), e (B, n-1), logdet (B,)) from a (B, n), c (B, n-1)."""
    B, n = _check_rows("tridiag_factor", a, c)
    if not _on_cuda("tridiag_factor", a, c):
        return tridiag_factor_plain(a, c)
    _check_smem("tridiag_factor", 2 * n - 1, a.dtype)
    d = torch.empty_like(a)
    e = torch.empty_like(c)
    logdet = a.new_empty(B)
    code = _fn("tg_tridiag_factor", a.dtype)(
        a.data_ptr(), c.data_ptr(), d.data_ptr(), e.data_ptr(), logdet.data_ptr(), B, n, _stream(a)
    )
    build.check(code, "tridiag_factor")
    tridiag_factor.launches += 1
    return d, e, logdet


def tridiag_solve(d: torch.Tensor, e: torch.Tensor, b: torch.Tensor, mode: int = SOLVE_BOTH):
    """K2: solve with L (mode 0), Lᵀ (mode 1) or Q = L Lᵀ (mode 2) per chain.

    d (B, n), e (B, n-1), b (B, n) or (B, n, k). Not differentiable."""
    B, n = _check_rows("tridiag_solve", d, e)
    if b.shape[:2] != (B, n) or b.ndim not in (2, 3):
        raise ValueError(f"tridiag_solve: b must be (B, n) or (B, n, k), got {tuple(b.shape)}")
    if mode not in (SOLVE_L, SOLVE_LT, SOLVE_BOTH):
        raise ValueError(f"tridiag_solve: unknown mode {mode}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (d, e, b)):
        raise NotImplementedError("tridiag_solve has no backward; call it under torch.no_grad()")
    if not _on_cuda("tridiag_solve", d, e, b):
        return tridiag_solve_plain(d, e, b, mode)
    k = 1 if b.ndim == 2 else b.shape[2]
    _check_smem("tridiag_solve", 2 * n - 1 + n * k, d.dtype)
    out = torch.empty_like(b)
    code = _fn("tg_tridiag_solve", d.dtype)(
        d.data_ptr(), e.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, k, mode, _stream(d)
    )
    build.check(code, "tridiag_solve")
    tridiag_solve.launches += 1
    return out


def tridiag_selinv(d: torch.Tensor, e: torch.Tensor):
    """K3: Takahashi (zdiag (B, n), zoff (B, n-1)) of (L Lᵀ)⁻¹."""
    B, n = _check_rows("tridiag_selinv", d, e)
    if not _on_cuda("tridiag_selinv", d, e):
        return tridiag_selinv_plain(d, e)
    _check_smem("tridiag_selinv", 2 * n - 1, d.dtype)
    zdiag = torch.empty_like(d)
    zoff = torch.empty_like(e)
    code = _fn("tg_tridiag_selinv", d.dtype)(
        d.data_ptr(), e.data_ptr(), zdiag.data_ptr(), zoff.data_ptr(), B, n, _stream(d)
    )
    build.check(code, "tridiag_selinv")
    tridiag_selinv.launches += 1
    return zdiag, zoff


tridiag_factor.launches = 0
tridiag_solve.launches = 0
tridiag_selinv.launches = 0
