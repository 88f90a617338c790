"""Wrapper of K16 `kl_columns` (``csrc/kl.cu``) and its plain version.

One bucket of columns of the KL-optimal sparse Cholesky factor
(``tpu_gmrf/kl_cholesky.py:116-134``): for column b with ``count[b]``
valid rows, the trailing block of its Θ (B, cap, cap) is symmetrized, given
``jitter`` on the diagonal and factored, A = L Lᵀ, and x = L⁻ᵀ e_last is
written into ``out`` (L's data) at ``entry_pos[b]`` (-1 on the padding at
the front). A column whose Cholesky breaks down is NaN throughout.

A CPU tensor takes the plain version (a right-looking batched Cholesky and a
column-oriented back-solve over the padded bucket); a CUDA tensor launches
the kernel or raises. The kernel's warp path (cap ≤ 32) rounds every
operation once, in the plain version's order, so the two agree to the bit;
its tile and cluster paths (`kl_path`) factor by tiles of 64 and round in
another order. ``kl_columns.launches`` counts launches. Forward only: Θ
that requires a gradient is refused.
"""

from __future__ import annotations

import torch

from . import build
from .banded import TILE, _cluster
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["kl_columns", "kl_columns_plain", "kl_path"]


def kl_path(cap: int) -> str:
    """"warp" (cap ≤ 32: one warp per column), "tile" (cap ≤ 128: one block
    per column, its tiles of 64 in shared memory) or "cluster" (a cluster of
    blocks per column on a workspace; `banded.factor_cluster` sizes it)."""
    return "warp" if cap <= 32 else "tile" if cap <= 2 * TILE else "cluster"


def _check(theta, count, entry_pos, out):
    if theta.ndim != 3 or theta.shape[1] != theta.shape[2]:
        raise ValueError(f"kl_columns: theta must be (B, cap, cap), got {tuple(theta.shape)}")
    B, cap = theta.shape[:2]
    if count.shape != (B,) or entry_pos.shape != (B, cap) or out.ndim != 1:
        raise ValueError(f"kl_columns: count (B,), entry_pos (B, cap) and out (nnz,) expected, got "
                         f"{tuple(count.shape)}, {tuple(entry_pos.shape)}, {tuple(out.shape)}")
    if torch.is_grad_enabled() and theta.requires_grad:
        raise NotImplementedError("kl_columns has no backward (forward only)")


def kl_columns_plain(theta: torch.Tensor, count: torch.Tensor, entry_pos: torch.Tensor, jitter: float,
                     out: torch.Tensor) -> torch.Tensor:
    """K16's function in batched torch ops, operation for operation as the kernel."""
    _check(theta, count, entry_pos, out)
    B, cap = theta.shape[:2]
    valid = torch.arange(cap, device=theta.device) >= (cap - count.long())[:, None]
    pair = valid[:, :, None] & valid[:, None, :]
    diag = torch.eye(cap, dtype=torch.bool, device=theta.device)
    A = torch.where(pair, (theta + theta.mT) * 0.5, 0.0)
    A = torch.where(diag & valid[:, :, None], A + jitter, A)
    A = torch.where(diag & ~valid[:, :, None], 1.0, A)  # decoupled identity on the padding
    dg = theta.new_empty(B, cap)
    for j in range(cap):
        d = A[:, j, j]
        ljj = torch.where(d > 0, torch.sqrt(torch.where(d > 0, d, 1.0)), torch.nan)
        dg[:, j] = ljj
        col = A[:, j + 1:, j] / ljj[:, None]
        A[:, j + 1:, j] = col
        A[:, j + 1:, j + 1:] -= col[:, :, None] * col[:, None, :]
    x = theta.new_zeros(B, cap)
    x[:, -1] = 1.0
    for i in range(cap - 1, -1, -1):
        xi = x[:, i] / dg[:, i]
        x[:, i] = xi
        x[:, :i] -= A[:, i, :i] * xi[:, None]
    out[entry_pos[valid].long()] = x[valid]
    return out


def kl_columns(theta: torch.Tensor, count: torch.Tensor, entry_pos: torch.Tensor, jitter: float,
               out: torch.Tensor) -> torch.Tensor:
    """K16: writes one bucket's columns into `out` (nnz,) and returns it.

    theta (B, cap, cap) as the cov_fn gave it (float32/float64), count (B,)
    and entry_pos (B, cap) int32 on theta's device; positions are not
    bounds-checked on the card."""
    _check(theta, count, entry_pos, out)
    theta = theta.contiguous()
    if not _on_cuda("kl_columns", theta, out):
        return kl_columns_plain(theta, count, entry_pos, jitter, out)
    for t in (count, entry_pos):
        if t.device != theta.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("kl_columns: count/entry_pos must be contiguous int32 on theta's device")
    B, cap = theta.shape[:2]
    path = kl_path(cap)
    work = flags = None
    cs = 1
    if path == "cluster":
        if B > 65535:
            raise ValueError(f"kl_columns: {B} columns of cap {cap} exceed one launch of the cluster path (65535)")
        nt = -(-cap // TILE)
        work = theta.new_empty(B, cap * cap + nt * TILE * TILE + cap)  # each column's matrix, inverted tiles, x
        flags = torch.empty(B, dtype=torch.int32, device=theta.device)
        cs = _cluster(cap, B, theta.dtype, "tg_kl_fit", "kl_columns")
    code = _fn("tg_kl_columns", theta.dtype)(
        theta.data_ptr(), entry_pos.data_ptr(), count.data_ptr(), cap, float(jitter), out.data_ptr(),
        None if work is None else work.data_ptr(), None if flags is None else flags.data_ptr(), cs, B,
        _stream(theta),
    )
    build.check(code, "kl_columns", f" at B={B} cap={cap} {theta.dtype}, {path} path, cluster={cs}")
    kl_columns.launches += 1
    return out


kl_columns.launches = 0
