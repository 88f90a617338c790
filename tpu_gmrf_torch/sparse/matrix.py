"""Fixed-pattern sparse matrices over torch tensors.

Counterpart of ``tpu_gmrf.sparse.matrix``. A `SparseMatrix` carries a
``data`` tensor over a static host `SparsePattern`. Where the reference
leaves a batch of matrices to ``vmap``, here ``data`` is ``(nnz,)`` or
``(B, nnz)`` over one pattern (one row per chain) and vectors are ``(n,)``
or ``(B, n)``. ``matvec`` and ``quad`` run on the CSR kernel K4
(``tpu_gmrf_torch.kernels.csr_spmv``) through autograd Functions whose
backward is K4 on the transposed pattern plus a gather-product for the data.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..kernels import csr_spmv
from .pattern import SparsePattern, union_patterns

__all__ = ["SparseMatrix", "spdiag", "sp_tridiag", "sp_add"]


def _index(pattern: SparsePattern, key: str, array, device, dtype=torch.long) -> torch.Tensor:
    """`array` of `pattern` as a torch index tensor, cached on the pattern per device."""
    cache = pattern.__dict__.setdefault("_torch_index", {})
    k = (key, str(device), dtype)
    t = cache.get(k)
    if t is None:
        t = torch.tensor(np.asarray(array), dtype=dtype, device=device)
        cache[k] = t
    return t


def _csr(pattern: SparsePattern, device):
    return (
        _index(pattern, "indptr", pattern.indptr, device, torch.int32),
        _index(pattern, "cols32", pattern.cols, device, torch.int32),
    )


def _spmv_t(data, x, pattern):
    """Aᵀ x by K4 on the transposed pattern."""
    perm = _index(pattern, "tperm", pattern.transpose_perm, data.device)
    rp, col = _csr(pattern.transposed, data.device)
    return csr_spmv(rp, col, data[..., perm].contiguous(), x)[0]


def _data_grad(data, gd):
    return gd.sum(0) if data.ndim == 1 else gd


class _SpMV(torch.autograd.Function):
    """y = A x; x̄ = Aᵀ ȳ (K4), data̅_p = ȳ_{row p} x_{col p}."""

    @staticmethod
    def forward(ctx, data, x, pattern):
        ctx.pattern = pattern
        ctx.save_for_backward(data, x)
        rp, col = _csr(pattern, x.device)
        return csr_spmv(rp, col, data, x)[0]

    @staticmethod
    def backward(ctx, gy):
        data, x = ctx.saved_tensors
        p = ctx.pattern
        gy = gy.contiguous()
        gdata = gx = None
        if ctx.needs_input_grad[1]:
            gx = _spmv_t(data, gy, p)
        if ctx.needs_input_grad[0]:
            rows = _index(p, "rows", p.rows, x.device)
            cols = _index(p, "cols", p.cols, x.device)
            gdata = _data_grad(data, gy[:, rows] * x[:, cols])
        return gdata, gx, None


class _Quad(torch.autograd.Function):
    """q = xᵀ A x per chain; x̄ = q̄ (A + Aᵀ) x (K4 twice), data̅_p = q̄ x_{row p} x_{col p}."""

    @staticmethod
    def forward(ctx, data, x, pattern):
        rp, col = _csr(pattern, x.device)
        y, q = csr_spmv(rp, col, data, x, quad=True)
        ctx.pattern = pattern
        ctx.save_for_backward(data, x, y)
        return q

    @staticmethod
    def backward(ctx, gq):
        data, x, y = ctx.saved_tensors
        p = ctx.pattern
        gq = gq[:, None]
        gdata = gx = None
        if ctx.needs_input_grad[1]:
            gx = gq * (y + _spmv_t(data, x, p))
        if ctx.needs_input_grad[0]:
            rows = _index(p, "rows", p.rows, x.device)
            cols = _index(p, "cols", p.cols, x.device)
            gdata = _data_grad(data, gq * x[:, rows] * x[:, cols])
        return gdata, gx, None


@dataclasses.dataclass(frozen=True)
class SparseMatrix:
    """COO (canonically sorted) sparse matrix; `pattern` is static host data."""

    data: torch.Tensor  # (nnz,) or (B, nnz)
    pattern: SparsePattern

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def nnz(self):
        return self.pattern.nnz

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def _idx(self, key: str, array):
        return _index(self.pattern, key, array, self.data.device)

    # ---- linear ops --------------------------------------------------------

    def _batched(self, x: torch.Tensor):
        """(data, x as (B, n), squeeze) with the chain axes lined up."""
        if self.shape[0] != self.shape[1]:
            raise NotImplementedError("matvec/quad of a non-square pattern (ROADMAP 2.4)")
        if self.data.ndim > 2 or x.ndim > 2:
            raise ValueError("data must be (nnz,) or (B, nnz) and x (n,) or (B, n)")
        squeeze = self.data.ndim == 1 and x.ndim == 1
        xb = x if x.ndim == 2 else x.unsqueeze(0)
        if self.data.ndim == 2 and xb.shape[0] == 1:
            xb = xb.expand(self.data.shape[0], -1)
        return self.data.contiguous(), xb.contiguous(), squeeze

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x of shape (n,) or (B, n); K4."""
        data, xb, squeeze = self._batched(x)
        y = _SpMV.apply(data, xb, self.pattern)
        return y[0] if squeeze else y

    @property
    def T(self) -> "SparseMatrix":
        p = self.pattern
        return SparseMatrix(self.data[..., self._idx("tperm", p.transpose_perm)], p.transposed)

    def quad(self, x: torch.Tensor) -> torch.Tensor:
        """xᵀ A x, (B,) or scalar; K4 with the fused reduction."""
        data, xb, squeeze = self._batched(x)
        q = _Quad.apply(data, xb, self.pattern)
        return q[0] if squeeze else q

    def diagonal(self) -> torch.Tensor:
        return self.data[..., self._idx("diag", self.pattern.diag_positions)]

    def symmetrize(self) -> "SparseMatrix":
        """(A + Aᵀ)/2 on the (assumed symmetric) pattern."""
        perm = self._idx("tperm", self.pattern.transpose_perm)
        return SparseMatrix(0.5 * (self.data + self.data[..., perm]), self.pattern)

    # ---- arithmetic (fixed-pattern aware) ----------------------------------

    def __mul__(self, s):
        return SparseMatrix(self.data * s, self.pattern)

    __rmul__ = __mul__

    def __neg__(self):
        return SparseMatrix(-self.data, self.pattern)

    def __add__(self, other: "SparseMatrix") -> "SparseMatrix":
        if other.pattern == self.pattern:
            return SparseMatrix(self.data + other.data, self.pattern)
        return sp_add(self, other)

    def __sub__(self, other: "SparseMatrix") -> "SparseMatrix":
        return self + (other * -1.0)

    def pad_to(self, pattern: SparsePattern) -> "SparseMatrix":
        """Embed this matrix's values into a super-pattern (fixed scatter)."""
        if pattern == self.pattern:
            return self
        smap = _scatter_map(pattern, self.pattern, self.data.device)
        data = self.data.new_zeros(self.data.shape[:-1] + (pattern.nnz,))
        return SparseMatrix(data.index_add(-1, smap, self.data), pattern)

    def with_data(self, data) -> "SparseMatrix":
        return SparseMatrix(data, self.pattern)


def _scatter_map(pattern: SparsePattern, sub: SparsePattern, device) -> torch.Tensor:
    cache = pattern.__dict__.setdefault("_torch_scatter", {})
    key = (sub, str(device))
    t = cache.get(key)
    if t is None:
        t = torch.as_tensor(pattern.scatter_map(sub), dtype=torch.long, device=device)
        cache[key] = t
    return t


@lru_cache(maxsize=32)
def _diag_pattern(n: int) -> SparsePattern:
    idx = np.arange(n, dtype=np.int32)
    return SparsePattern(idx, idx, (n, n))


@lru_cache(maxsize=32)
def _tridiag_pattern(n: int) -> SparsePattern:
    idx = np.arange(n, dtype=np.int32)
    rows = np.concatenate([idx, idx[1:], idx[:-1]])
    cols = np.concatenate([idx, idx[:-1], idx[1:]])
    return SparsePattern(rows, cols, (n, n))


def spdiag(d: torch.Tensor) -> SparseMatrix:
    return SparseMatrix(d, _diag_pattern(d.shape[-1]))


_ADD_CACHE: dict = {}


def sp_add(a: SparseMatrix, b: SparseMatrix) -> SparseMatrix:
    """A + B on the union pattern (fixed scatter-adds; plain torch)."""
    key = (a.pattern, b.pattern)
    pat = _ADD_CACHE.get(key)
    if pat is None:
        pat = union_patterns(a.pattern, b.pattern)
        _ADD_CACHE[key] = pat
    return SparseMatrix(a.pad_to(pat).data + b.pad_to(pat).data, pat)


def sp_tridiag(main: torch.Tensor, off: torch.Tensor) -> SparseMatrix:
    """Symmetric tridiagonal matrix from main diagonal (..., n) and
    off-diagonal (..., n-1) values."""
    pat = _tridiag_pattern(main.shape[-1])
    data = torch.cat([main, off, off], -1)
    return SparseMatrix(data[..., _index(pat, "sort", pat.sort_order, main.device)], pat)
