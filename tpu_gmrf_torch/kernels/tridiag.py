"""Wrappers of the tridiagonal kernels K1-K3, K19 and K23 and their plain versions.

Each wrapper takes batched rows, one chain per row. A CPU tensor goes to the
plain PyTorch version (the Hillis-Steele scans of ``solvers/prefix.py``); a
CUDA tensor launches the hand-written kernel of ``csrc/tridiag.cu`` and
raises if it cannot. Any other device raises. ``<wrapper>.launches`` counts
the kernel launches.

K1-K3 run each chain as a segmented scan on a block (`scan_launch` picks
the warps and the rows per thread; a chain longer than a block's tile runs in
tiles in sequence, K2's backward pass and K3 the last tile first), so no n is
refused. K19, the tangent of K3 (Σ̇ = −Σ·Q̇·Σ on the tridiagonal), runs
K2's forward scan and K3's backward one in turn on a block per chain
(`tangent_launch`). K23, the adjoint of K1 (the cotangent of the rows a, c
from that of the factor d, e), is K3's backward scan on the pivots'
adjoint recurrence, in K19's shape.
"""

from __future__ import annotations

import functools

import torch

from ..solvers.prefix import linear_recurrence, mobius_recurrence
from . import build

__all__ = [
    "tridiag_factor", "tridiag_solve", "tridiag_selinv", "tridiag_selinv_tangent", "tridiag_factor_adjoint",
    "tridiag_factor_plain", "tridiag_solve_plain", "tridiag_selinv_plain", "tridiag_selinv_tangent_plain",
    "tridiag_factor_adjoint_plain",
    "SOLVE_L", "SOLVE_LT", "SOLVE_BOTH", "scan_launch", "tangent_launch",
]

SOLVE_L, SOLVE_LT, SOLVE_BOTH = 0, 1, 2
# Dynamic shared memory a block may use without an opt-in attribute.
SMEM_LIMIT = 48 * 1024
# K1-K3's scan shapes (csrc/tridiag.cu): a block per chain, SEG_ROWS rows a
# thread while MAX_WARPS warps hold the chain, then up to MAX_ROWS rows a
# thread (K2's three float64 arrays of 512 segments at stride 17 take 209 KB
# of the 227 KB a block may have), then tiles of that size in sequence.
SEG_ROWS, MAX_WARPS, MAX_ROWS = 4, 16, 16
# K19 stages five arrays a tile: at most 8 rows a thread (184 KB of float64 at 16 warps)
TANGENT_ROWS = 8
_FLOATS = (torch.float32, torch.float64)


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


def tridiag_selinv_tangent_plain(d: torch.Tensor, e: torch.Tensor, zdiag: torch.Tensor, da: torch.Tensor,
                                 dc: torch.Tensor):
    """K19's function: the tangent (dzdiag (B, n), dzoff (B, n-1)) of K3's
    Σ in the direction (ȧ, ċ) of tridiag(a, c), from the factor (d, e) and
    K3's zdiag. The pivots' tangent δ̇_k = r_{k-1}² δ̇_{k-1} + ȧ_k −
    2 r_{k-1} ċ_{k-1} (r = e/d), then ż_j = r_j² ż_{j+1} + 2 r_j ṙ_j z_{j+1} −
    δ̇_j/δ_j², ṙ_j = (ċ_j − r_j δ̇_j)/δ_j, and żoff_j = −(ṙ_j z_{j+1} + r_j ż_{j+1})."""
    zero = torch.zeros_like(d[..., :1])
    delta = d * d
    r = e / d[..., :-1]
    ddelta = linear_recurrence(torch.cat([zero, r * r], -1), da - torch.cat([zero, 2.0 * r * dc], -1))
    rdot = (dc - r * ddelta[..., :-1]) / delta[..., :-1]
    znext = zdiag[..., 1:]
    beta = torch.cat([2.0 * r * rdot * znext, zero], -1) - ddelta / (delta * delta)
    dz = linear_recurrence(torch.cat([r * r, zero], -1), beta, reverse=True)
    return dz, -(rdot * znext + r * dz[..., 1:])


def tridiag_factor_adjoint_plain(d: torch.Tensor, e: torch.Tensor, gd: torch.Tensor, ge: torch.Tensor):
    """K23's function: the cotangents (ā (B, n), c̄ (B, n-1)) of K1's rows
    from those (d̄, ē) of its factor. With r = e/d and the pivots' cotangent
    g_j = (d̄_j − ē_j e_j/d_j)/(2d_j), the recurrence x_j = g_j + r_j² x_{j+1}
    runs backwards; ā = x and c̄_j = (ē_j − 2 e_j x_{j+1})/d_j."""
    zero = torch.zeros_like(d[..., :1])
    ge0 = torch.cat([ge, zero], -1)
    r = torch.cat([e / d[..., :-1], zero], -1)
    x = linear_recurrence(r * r, (gd - ge0 * r) / (2.0 * d), reverse=True)
    return x, (ge - 2.0 * e * x[..., 1:]) / d[..., :-1]


# ---- checks shared by the wrappers -----------------------------------------


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    first = tensors[0]
    dev = first.device
    if not first.is_cuda:
        if any(t.device != dev for t in tensors):
            raise ValueError(f"{name}: tensors on different devices")
        if dev.type != "cpu":
            raise RuntimeError(f"{name}: no kernel for device {dev}")
        return False
    dtype = first.dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
    if dtype not in _FLOATS:
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


@functools.cache
def scan_launch(n: int) -> tuple[int, int]:
    """(warps per chain, rows per thread) of K1-K3 on chains of n rows:
    SEG_ROWS rows a thread on as many warps as that takes, up to MAX_WARPS;
    beyond, up to MAX_ROWS rows a thread, in tiles of 32·warps·rows rows
    (several in sequence past 32·MAX_WARPS·MAX_ROWS rows). K2 takes a block
    per chain and right-hand side, so k multiplies the blocks; the dtype
    changes nothing (a tile's arrays fit a block's shared memory in both:
    K2 stages three, K1 and K3 two)."""
    warps = min(MAX_WARPS, -(-n // (32 * SEG_ROWS)))
    return warps, min(MAX_ROWS, -(-n // (32 * warps)))


@functools.cache
def tangent_launch(n: int) -> tuple[int, int]:
    """(warps per chain, rows per thread) of K19: `scan_launch`'s warps, at
    most TANGENT_ROWS rows a thread (tiles in sequence beyond)."""
    warps, rows = scan_launch(n)
    return warps, min(rows, TANGENT_ROWS)


@functools.cache
def _fn(name: str, dtype: torch.dtype):
    """The library's entry `name` for `dtype`, looked up once."""
    return getattr(build.library(), f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _stream(t: torch.Tensor) -> int:
    """The current stream's handle on t's device, without a Stream object."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# ---- wrappers ---------------------------------------------------------------


def tridiag_factor(a: torch.Tensor, c: torch.Tensor):
    """K1: (d (B, n), e (B, n-1), logdet (B,)) from a (B, n), c (B, n-1)."""
    B, n = _check_rows("tridiag_factor", a, c)
    if not _on_cuda("tridiag_factor", a, c):
        return tridiag_factor_plain(a, c)
    # d and e: one allocation, cut into contiguous views; the logdet, the differentiable output of
    # `TridiagLogdet`, a tensor of its own (forward mode refuses a tangent for a view of a shared buffer)
    out = a.new_empty(B * (2 * n - 1))
    d = out.as_strided((B, n), (n, 1))
    e = out.as_strided((B, n - 1), (n - 1, 1), B * n)
    logdet = a.new_empty(B)
    base, el = out.data_ptr(), out.element_size()
    code = _fn("tg_tridiag_factor", a.dtype)(
        a.data_ptr(), c.data_ptr(), base, base + el * B * n, logdet.data_ptr(), B, n, *scan_launch(n), _stream(a)
    )
    build.check(code, "tridiag_factor")
    tridiag_factor.launches += 1
    return d, e, logdet


def tridiag_solve(d: torch.Tensor, e: torch.Tensor, b: torch.Tensor, mode: int = SOLVE_BOTH):
    """K2: solve with L (mode 0), Lᵀ (mode 1) or Q = L Lᵀ (mode 2) per chain.

    d (B, n), e (B, n-1), b (B, n) or (B, n, k). Not differentiable: the
    factors' Functions (`solvers.base`) carry the gradients."""
    B, n = _check_rows("tridiag_solve", d, e)
    if b.shape[:2] != (B, n) or b.ndim not in (2, 3):
        raise ValueError(f"tridiag_solve: b must be (B, n) or (B, n, k), got {tuple(b.shape)}")
    if mode not in (SOLVE_L, SOLVE_LT, SOLVE_BOTH):
        raise ValueError(f"tridiag_solve: unknown mode {mode}")
    if (d.requires_grad or e.requires_grad) and torch.is_grad_enabled():
        raise NotImplementedError("tridiag_solve has no backward in the factor; call it under torch.no_grad()")
    if not _on_cuda("tridiag_solve", d, e, b):
        return tridiag_solve_plain(d, e, b, mode)
    k = 1 if b.ndim == 2 else b.shape[2]
    out = torch.empty_like(b)
    code = _fn("tg_tridiag_solve", d.dtype)(
        d.data_ptr(), e.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, k, mode, *scan_launch(n), _stream(d)
    )
    build.check(code, "tridiag_solve")
    tridiag_solve.launches += 1
    return out


def tridiag_selinv(d: torch.Tensor, e: torch.Tensor):
    """K3: Takahashi (zdiag (B, n), zoff (B, n-1)) of (L Lᵀ)⁻¹."""
    B, n = _check_rows("tridiag_selinv", d, e)
    if not _on_cuda("tridiag_selinv", d, e):
        return tridiag_selinv_plain(d, e)
    zdiag = torch.empty_like(d)
    zoff = torch.empty_like(e)
    code = _fn("tg_tridiag_selinv", d.dtype)(
        d.data_ptr(), e.data_ptr(), zdiag.data_ptr(), zoff.data_ptr(), B, n, *scan_launch(n), _stream(d)
    )
    build.check(code, "tridiag_selinv")
    tridiag_selinv.launches += 1
    return zdiag, zoff


def tridiag_selinv_tangent(d: torch.Tensor, e: torch.Tensor, zdiag: torch.Tensor, da: torch.Tensor,
                           dc: torch.Tensor):
    """K19: the tangent (dzdiag (B, n), dzoff (B, n-1)) of K3's Σ in the
    direction (ȧ (B, n), ċ (B, n-1)) of tridiag(a, c); d, e the factor and
    zdiag K3's diagonal of Σ."""
    B, n = _check_rows("tridiag_selinv_tangent", d, e)
    if zdiag.shape != d.shape or da.shape != d.shape or dc.shape != e.shape:
        raise ValueError("tridiag_selinv_tangent: zdiag and ȧ must be (B, n), ċ (B, n-1)")
    if not _on_cuda("tridiag_selinv_tangent", d, e, zdiag, da, dc):
        return tridiag_selinv_tangent_plain(d, e, zdiag, da, dc)
    dz = torch.empty_like(d)
    dzoff = torch.empty_like(e)
    code = _fn("tg_tridiag_selinv_tangent", d.dtype)(
        d.data_ptr(), e.data_ptr(), zdiag.data_ptr(), da.data_ptr(), dc.data_ptr(), dz.data_ptr(), dzoff.data_ptr(),
        B, n, *tangent_launch(n), _stream(d)
    )
    build.check(code, "tridiag_selinv_tangent")
    tridiag_selinv_tangent.launches += 1
    return dz, dzoff


def tridiag_factor_adjoint(d: torch.Tensor, e: torch.Tensor, gd: torch.Tensor, ge: torch.Tensor):
    """K23: the cotangents (ā (B, n), c̄ (B, n-1)) of K1's rows a, c from
    those (d̄ (B, n), ē (B, n-1)) of its factor d, e. Not differentiable."""
    B, n = _check_rows("tridiag_factor_adjoint", d, e)
    if gd.shape != d.shape or ge.shape != e.shape:
        raise ValueError("tridiag_factor_adjoint: d̄ must be (B, n), ē (B, n-1)")
    if not _on_cuda("tridiag_factor_adjoint", d, e, gd, ge):
        return tridiag_factor_adjoint_plain(d, e, gd, ge)
    ga = torch.empty_like(d)
    gc = torch.empty_like(e)
    code = _fn("tg_tridiag_factor_adjoint", d.dtype)(
        d.data_ptr(), e.data_ptr(), gd.data_ptr(), ge.data_ptr(), ga.data_ptr(), gc.data_ptr(), B, n,
        *tangent_launch(n), _stream(d)
    )
    build.check(code, "tridiag_factor_adjoint")
    tridiag_factor_adjoint.launches += 1
    return ga, gc


tridiag_factor_adjoint.launches = 0
tridiag_factor.launches = 0
tridiag_selinv_tangent.launches = 0
tridiag_solve.launches = 0
tridiag_selinv.launches = 0
