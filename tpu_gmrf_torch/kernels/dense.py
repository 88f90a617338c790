"""Wrappers of the dense kernels K9 `dense_chol` and K10 `dense_trsv`
(``csrc/dense.cu``) and their plain versions.

K9 densifies B precisions over one symmetric pattern (data (B, nnz)),
Jacobi-equilibrates them and factors them with the reference's per-chain
ridge rescue (``tpu_gmrf/solvers/dense.py:102-132``): L (B, n, n) lower,
s (B, n), the rescue level (B,) int32 (0 none, 1 δ, 2 500δ), the
logdet (B,) and, on the card, the inverted 64 × 64 diagonal tiles of L,
Dinv (B, ⌈n/64⌉·64·64). It is one launch, a thread-block cluster per chain
(`banded.factor_cluster` sizes it), the rescue decided on the card. K10
solves with the factor and its tiles: mode 0 y = L⁻¹(s∘b), mode 1
x = s∘(L⁻ᵀb), mode 2 both, for b (B, n, k), on a cluster per chain and
group of right-hand sides (`trsv_cluster` sizes it). K10's second entry,
`dense_selinv`, gives Σ = Q⁻¹ at chosen entries (``dense.py:74-98``),
solving X = S L⁻ᵀ with K10.

A CPU tensor takes the plain version (``torch.linalg``); a CUDA tensor
launches the kernel or raises. ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build
from .banded import TILE, _cluster, _fit, factor_cluster
from .tridiag import SOLVE_BOTH, SOLVE_L, SOLVE_LT, _fn, _on_cuda, _stream

__all__ = ["DenseTables", "dense_chol", "dense_chol_plain", "dense_trsv", "dense_trsv_plain", "dense_selinv",
           "dense_selinv_plain", "trsv_cluster", "DENSE_MAX_N"]

DENSE_MAX_N = 4096  # the dense backend's largest n


class DenseTables:
    """A symmetric pattern's entries for K9: rows, cols, the transpose
    permutation and each row's diagonal position (-1 where absent), as
    int32 (kernel) and int64 (plain version) tensors, cached per device."""

    def __init__(self, pattern):
        if not pattern.is_symmetric:
            raise ValueError("dense_chol needs a symmetric pattern")
        self.n, self.nnz = pattern.shape[0], pattern.nnz
        dpos = np.full(self.n, -1, np.int64)
        on = pattern.rows == pattern.cols
        dpos[pattern.rows[on]] = np.nonzero(on)[0]
        self._np = dict(rows=pattern.rows, cols=pattern.cols, tperm=pattern.transpose_perm, diag=dpos)
        self._dev: dict = {}

    def on(self, device) -> dict:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = {}
            for k, a in self._np.items():
                t[k] = torch.tensor(np.asarray(a), dtype=torch.int32, device=device)
                t[k + "_l"] = torch.tensor(np.asarray(a), dtype=torch.long, device=device)
            low = self._np["cols"] <= self._np["rows"]
            t["low"] = torch.as_tensor(np.nonzero(low)[0], dtype=torch.long, device=device)
            self._dev[key] = t
        return t


# ---- plain versions -------------------------------------------------------------


def _chol(A):
    """Cholesky with LAPACK's breakdown rule (a pivot <= 0 or non-finite);
    a chain that breaks down gets NaN, as the reference's factor does."""
    L, info = torch.linalg.cholesky_ex(A)
    dg = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (info == 0) & (torch.isfinite(dg) & (dg > 0)).all(-1)
    return torch.where(ok[:, None, None], L, torch.nan), ok


def dense_chol_plain(data: torch.Tensor, tables: DenseTables):
    """K9's function: (L (B, n, n), s (B, n), level (B,) int32, logdet (B,))."""
    t = tables.on(data.device)
    B, n = data.shape[0], tables.n
    v = 0.5 * (data + data[:, t["tperm_l"]])
    dg = torch.where(t["diag_l"] >= 0, data[:, t["diag_l"].clamp_min(0)], 0.0)
    pos = dg > 0
    s = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, dg, 1.0)), 1.0)
    low = t["low"]
    r, c = t["rows_l"][low], t["cols_l"][low]
    A = data.new_zeros(B, n, n)
    A[:, r, c] = v[:, low] * s[:, r] * s[:, c]
    L, ok = _chol(A)
    level = torch.zeros(B, dtype=torch.int32, device=data.device)
    if not bool(ok.all()):
        eye = torch.eye(n, dtype=data.dtype, device=data.device)
        delta = torch.tensor(2e-6 * n, dtype=data.dtype, device=data.device)
        L1, ok1 = _chol(A + delta * eye)
        L2, _ = _chol(A + (500.0 * delta) * eye)
        L = torch.where(ok[:, None, None], L, torch.where(ok1[:, None, None], L1, L2))
        level = torch.where(ok, 0, torch.where(ok1, 1, 2)).to(torch.int32)
    logdet = 2.0 * (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) - torch.log(s)).sum(-1)
    return L, s, level, logdet


def dense_trsv_plain(L: torch.Tensor, s: torch.Tensor, b: torch.Tensor, mode: int = SOLVE_BOTH):
    """K10's function on b (B, n, k)."""
    x = b
    if mode != SOLVE_LT:
        x = torch.linalg.solve_triangular(L, s[..., None] * x, upper=False)
    if mode != SOLVE_L:
        x = s[..., None] * torch.linalg.solve_triangular(L.mT, x, upper=True)
    return x


def dense_selinv_plain(L: torch.Tensor, s: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """`dense_selinv`'s function: Q⁻¹ = X Xᵀ, X = S L⁻ᵀ, at (rows, cols)."""
    n = L.shape[-1]
    eye = torch.eye(n, dtype=L.dtype, device=L.device).expand(L.shape).contiguous()
    X = dense_trsv_plain(L, s, eye, SOLVE_LT)
    return (X @ X.mT)[:, rows.long(), cols.long()]


# ---- wrappers -------------------------------------------------------------------


def dense_chol(data: torch.Tensor, tables: DenseTables):
    """K9: (L (B, n, n), s (B, n), level (B,) int32, logdet (B,), Dinv) of data
    (B, nnz); Dinv (B, ⌈n/64⌉·64·64) holds L's inverted diagonal tiles for
    K10, None from the plain version (CPU tensors)."""
    if data.ndim != 2 or data.shape[1] != tables.nnz:
        raise ValueError(f"dense_chol: data must be (B, {tables.nnz}), got {tuple(data.shape)}")
    if tables.n > DENSE_MAX_N:
        raise ValueError(f"dense_chol: n={tables.n} is above the dense backend's {DENSE_MAX_N}")
    if not _on_cuda("dense_chol", data):
        return (*dense_chol_plain(data, tables), None)
    t = tables.on(data.device)
    B, n = data.shape[0], tables.n
    if B > 65535:
        raise ValueError(f"dense_chol: {B} chains exceed one launch (65535)")
    L = data.new_empty(B, n, n)
    s = data.new_empty(B, n)
    logdet = data.new_empty(B)
    level = torch.empty(B, dtype=torch.int32, device=data.device)
    flags = torch.empty(3 * B, dtype=torch.int32, device=data.device)  # a breakdown flag per chain and attempt
    Dinv = data.new_empty(B, -(-n // TILE) * TILE * TILE)  # each chain's inverted diagonal tiles
    cs = _cluster(n, B, data.dtype, "tg_dense_chol_fit", "dense_chol")
    code = _fn("tg_dense_chol", data.dtype)(
        data.data_ptr(), data.shape[1], t["rows"].data_ptr(), t["cols"].data_ptr(), t["tperm"].data_ptr(),
        t["diag"].data_ptr(), tables.nnz, n, L.data_ptr(), s.data_ptr(), level.data_ptr(), logdet.data_ptr(),
        flags.data_ptr(), Dinv.data_ptr(), cs, B, _stream(data),
    )
    build.check(code, "dense_chol", f" at n={n} B={B} cluster={cs} {data.dtype}")
    dense_chol.launches += 1
    return L, s, level, logdet, Dinv


def trsv_cluster(n: int, clusters: int, fit) -> int:
    """Blocks per cluster of K10 for `clusters` clusters (chains × groups of
    right-hand sides) of n rows: `factor_cluster`'s rule with at most a block
    per 64-row tile (a block owns whole row tiles)."""
    return factor_cluster(n, clusters, fit, "dense_trsv", most=-(-n // TILE))


@functools.cache
def _trsv_cs(n: int, B: int, k: int, dtype) -> int:
    """`trsv_cluster` on this card for B chains of n rows and k right-hand
    sides (groups of 8 for k ≤ 8, else 64), worked out once per shape."""
    wide = int(k > 8)
    return trsv_cluster(n, B * -(-k // (64 if wide else 8)), _fit("tg_dense_trsv_fit", dtype, "dense_trsv", (wide,)))


def _check_tiles(name: str, L: torch.Tensor, Dinv) -> None:
    """K10 on the card solves by K9's inverted diagonal tiles: raise without them."""
    B, n = L.shape[0], L.shape[-1]
    if Dinv is None:
        raise ValueError(f"{name}: on the card K10 needs K9's inverted diagonal tiles (Dinv)")
    if Dinv.shape != (B, -(-n // TILE) * TILE * TILE) or Dinv.dtype != L.dtype or Dinv.device != L.device \
            or not Dinv.is_contiguous():
        raise ValueError(f"{name}: Dinv must be a contiguous ({B}, {-(-n // TILE) * TILE * TILE}) tensor like L, "
                         f"got {tuple(Dinv.shape)} {Dinv.dtype} on {Dinv.device}")


def dense_trsv(L: torch.Tensor, s: torch.Tensor, b: torch.Tensor, mode: int = SOLVE_BOTH, Dinv=None):
    """K10: mode 0 L⁻¹(s∘b), mode 1 s∘(L⁻ᵀb), mode 2 both, for L (B, n, n),
    s (B, n), b (B, n, k), with Dinv, L's inverted diagonal tiles from K9
    (required on the card; the plain version on CPU tensors ignores it).
    Not differentiable."""
    if L.ndim != 3 or b.ndim != 3 or b.shape[:2] != L.shape[:2] or s.shape != L.shape[:2]:
        raise ValueError(f"dense_trsv: shapes L {tuple(L.shape)}, s {tuple(s.shape)}, b {tuple(b.shape)}")
    if mode not in (SOLVE_L, SOLVE_LT, SOLVE_BOTH):
        raise ValueError(f"dense_trsv: unknown mode {mode}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (L, s)):
        raise NotImplementedError("dense_trsv has no backward; call it under torch.no_grad()")
    if not _on_cuda("dense_trsv", L, s, b):
        return dense_trsv_plain(L, s, b, mode)
    _check_tiles("dense_trsv", L, Dinv)
    B, n, k = b.shape
    if B > 65535:
        raise ValueError(f"dense_trsv: {B} chains exceed one launch (65535)")
    out = torch.empty_like(b)
    cs = _trsv_cs(n, B, k, L.dtype)
    code = _fn("tg_dense_trsv", L.dtype)(
        L.data_ptr(), s.data_ptr(), Dinv.data_ptr(), b.data_ptr(), out.data_ptr(), n, k, mode, cs, B, _stream(L)
    )
    build.check(code, "dense_trsv", f" at n={n} k={k} B={B} cluster={cs} {L.dtype}")
    dense_trsv.launches += 1
    return out


def dense_selinv(L: torch.Tensor, s: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, Dinv=None):
    """K10's second entry: Σ = Q⁻¹ at the entries (rows[p], cols[p]) (int32
    (m,) tensors on L's device), (B, m), for the factor (L (B, n, n), s (B, n))
    of K9 and, on the card, its inverted diagonal tiles Dinv. X = S L⁻ᵀ is
    solved by K10 into a (B, n, n) workspace, then Σ_ij = X_i·X_j per entry;
    the n×n inverse is never formed. Indices are not bounds-checked on the
    card. Not differentiable."""
    if L.ndim != 3 or s.shape != L.shape[:2] or rows.shape != cols.shape or rows.ndim != 1:
        raise ValueError(f"dense_selinv: shapes L {tuple(L.shape)}, s {tuple(s.shape)}, rows {tuple(rows.shape)}, "
                         f"cols {tuple(cols.shape)}")
    if torch.is_grad_enabled() and (L.requires_grad or s.requires_grad):
        raise NotImplementedError("dense_selinv has no backward; call it under torch.no_grad()")
    if not _on_cuda("dense_selinv", L, s):
        return dense_selinv_plain(L, s, rows, cols)
    if rows.device != L.device or cols.device != L.device or rows.dtype != torch.int32 or cols.dtype != torch.int32 \
            or not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("dense_selinv: rows and cols must be contiguous int32 tensors on the factor's device")
    _check_tiles("dense_selinv", L, Dinv)
    B, n = s.shape
    if B > 65535:
        raise ValueError(f"dense_selinv: {B} chains exceed one launch (65535)")
    X = L.new_empty(B, n, n)
    out = L.new_empty(B, rows.numel())
    cs = _trsv_cs(n, B, n, L.dtype)
    code = _fn("tg_dense_selinv", L.dtype)(
        L.data_ptr(), s.data_ptr(), Dinv.data_ptr(), X.data_ptr(), rows.data_ptr(), cols.data_ptr(), rows.numel(), n,
        out.data_ptr(), cs, B, _stream(L),
    )
    build.check(code, "dense_selinv", f" at n={n} m={rows.numel()} B={B} cluster={cs} {L.dtype}")
    dense_selinv.launches += 1
    return out


dense_chol.launches = 0
dense_trsv.launches = 0
dense_selinv.launches = 0
