"""Fixed-pattern sparse matrices over torch tensors.

Counterpart of ``tpu_gmrf.sparse.matrix``. A `SparseMatrix` carries a
``data`` tensor over a static host `SparsePattern`. Where the reference
leaves a batch of matrices to ``vmap``, here ``data`` is ``(nnz,)`` or
``(B, nnz)`` over one pattern (one row per chain) and vectors are ``(n,)``
or ``(B, n)``. ``matvec``, ``rmatvec`` and ``quad`` run on the CSR kernel K4
(``tpu_gmrf_torch.kernels.csr_spmv``) through autograd Functions whose
backward is K4 on the transposed pattern plus a gather-product for the data;
the sums (``sp_add``, ``pad_to``) and ``sp_matmul`` run on K5. Every
backward is built from these Functions again, so second derivatives go
through the kernels, and every Function has a ``jvp`` for forward mode.
A pattern may be rectangular (m × n), as the reference's segment-sum allows;
``quad`` needs a square one.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from .._device import as_tensor, default_device
from ..kernels import SegPlan, csr_spmv, gather_segsum
from .pattern import SparsePattern, spgemm_pattern, union_patterns

__all__ = ["SparseMatrix", "spdiag", "speye", "sp_tridiag", "sp_add", "sp_matmul", "sp_block_diag", "sp_kron",
           "from_dense", "from_scipy", "sp_dot"]


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


def _transposed(data, pattern):
    """Aᵀ's data (contiguous) from A's."""
    return data[..., _index(pattern, "tperm", pattern.transpose_perm, data.device)].contiguous()


def _spmv(data, x, pattern):
    """A x by K4, with no graph."""
    return csr_spmv(*_csr(pattern, x.device), data, x)[0]


def _data_grad(data, gd):
    return gd.sum(0) if data.ndim == 1 else gd


def _entry_product(u, v, pattern):
    """u[:, row p] · v[:, col p] for each entry p, (B, nnz)."""
    rows = _index(pattern, "rows", pattern.rows, u.device)
    cols = _index(pattern, "cols", pattern.cols, u.device)
    return u[:, rows] * v[:, cols]


# Each backward below computes its cotangents with the Functions of this
# module and torch ops, so that it is differentiable in turn: a Hessian by
# torch.autograd.grad(..., create_graph=True) goes through the kernels'
# own derivatives. Each Function also has a `jvp` (torch.autograd.forward_ad).


class _SpMV(torch.autograd.Function):
    """y = A x (K4); x̄ = Aᵀ ȳ (`_SpMV` on the transposed pattern), data̅_p = ȳ_{row p} x_{col p}."""

    @staticmethod
    def forward(ctx, data, x, pattern):
        ctx.pattern = pattern
        ctx.save_for_backward(data, x)
        ctx.save_for_forward(data, x)
        return _spmv(data, x, pattern)

    @staticmethod
    def backward(ctx, gy):
        data, x = ctx.saved_tensors
        p = ctx.pattern
        gy = gy.contiguous()
        gdata = gx = None
        if ctx.needs_input_grad[1]:
            gx = _SpMV.apply(_transposed(data, p), gy, p.transposed)
        if ctx.needs_input_grad[0]:
            gdata = _data_grad(data, _entry_product(gy, x, p))
        return gdata, gx, None

    @staticmethod
    def jvp(ctx, ddata, dx, _):
        data, x = ctx.saved_tensors
        p = ctx.pattern
        out = 0.0 if dx is None else _spmv(data, dx.contiguous(), p)
        return out if ddata is None else out + _spmv(ddata.contiguous(), x, p)


class _Quad(torch.autograd.Function):
    """q = xᵀ A x per chain (K4's fused reduction); x̄ = q̄ (A x + Aᵀ x),
    data̅_p = q̄ x_{row p} x_{col p}. A first-order backward takes A x from the
    forward and Aᵀ x from K4; one that builds a graph computes both again
    through `_SpMV`."""

    @staticmethod
    def forward(ctx, data, x, pattern):
        rp, col = _csr(pattern, x.device)
        y, q = csr_spmv(rp, col, data, x, quad=True)
        ctx.pattern = pattern
        ctx.save_for_backward(data, x, y)
        ctx.save_for_forward(data, x, y)
        return q

    @staticmethod
    def backward(ctx, gq):
        data, x, y = ctx.saved_tensors
        p = ctx.pattern
        gq = gq[:, None]
        gdata = gx = None
        if ctx.needs_input_grad[1]:
            dt = _transposed(data, p)
            if torch.is_grad_enabled():
                gx = gq * (_SpMV.apply(data, x, p) + _SpMV.apply(dt, x, p.transposed))
            else:
                gx = gq * (y + _spmv(dt, x, p.transposed))
        if ctx.needs_input_grad[0]:
            gdata = _data_grad(data, gq * _entry_product(x, x, p))
        return gdata, gx, None

    @staticmethod
    def jvp(ctx, ddata, dx, _):
        data, x, y = ctx.saved_tensors
        p = ctx.pattern
        out = 0.0
        if dx is not None:
            out = (dx * (y + _spmv(_transposed(data, p), x, p.transposed))).sum(-1)
        if ddata is not None:
            out = out + csr_spmv(*_csr(p, x.device), ddata.contiguous(), x, quad=True)[1]
        return out


def _linear_plans(rows, srcs, n_rows: int, n_srcs: int):
    """K5 plans of the 0/1 map out[rows[k]] += x[srcs[k]] and of its transpose."""
    return (SegPlan.grouped(rows, srcs, n_rows), SegPlan.grouped(srcs, rows, n_srcs))


class _Linear(torch.autograd.Function):
    """out (B, R) = S x for a static 0/1 plan S (K5); x̄ = Sᵀ ḡ (`_Linear` on the plans swapped)."""

    @staticmethod
    def forward(ctx, x, plans):
        ctx.plans = plans
        return gather_segsum(plans[0], x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return _Linear.apply(g.contiguous(), ctx.plans[::-1]), None

    @staticmethod
    def jvp(ctx, dx, _):
        return gather_segsum(ctx.plans[0], dx.contiguous())


def _as_rows(data: torch.Tensor) -> torch.Tensor:
    return data.reshape(-1, data.shape[-1])


def _triple_plans(idx, sizes):
    """The K5 plans of a SpGEMM's index triple (out, a, b entries of each
    term): plan r sums, into rows idx[r], the products of the operands at the
    other two indices; (plan, the role of its x, the role of its y)."""
    plans = []
    for r in range(3):
        u, v = (i for i in range(3) if i != r)
        plans.append((SegPlan.grouped(idx[r], idx[u], sizes[r], yi=idx[v]), u, v))
    return tuple(plans)


def _triple(u, v, plans, roles):
    plan, xr, _ = plans[roles[2]]
    x, y = (u, v) if xr == roles[0] else (v, u)
    return gather_segsum(plan, x.contiguous(), y=y.contiguous())


class _SpGEMM(torch.autograd.Function):
    """One of the three products over a SpGEMM's index triple (K5): with roles
    (ru, rv, ro), out[term's ro index] += u[its ru index] · v[its rv index];
    c = segment_sum(a[a_idx] · b[b_idx], out_idx) is roles (1, 2, 0). The
    cotangents are two more of them: ū with roles (ro, rv, ru), v̄ with (ro,
    ru, rv). u, v are (nnz,) or (B, nnz)."""

    @staticmethod
    def forward(ctx, u, v, plans, roles):
        ctx.plans, ctx.roles = plans, roles
        ctx.save_for_backward(u, v)
        ctx.save_for_forward(u, v)
        return _triple(u, v, plans, roles)

    @staticmethod
    def backward(ctx, g):
        u, v = ctx.saved_tensors
        ru, rv, ro = ctx.roles
        g = g.contiguous()
        gu = gv = None
        if ctx.needs_input_grad[0]:
            gu = _data_grad(u, _SpGEMM.apply(g, v, ctx.plans, (ro, rv, ru)))
        if ctx.needs_input_grad[1]:
            gv = _data_grad(v, _SpGEMM.apply(g, u, ctx.plans, (ro, ru, rv)))
        return gu, gv, None, None

    @staticmethod
    def jvp(ctx, du, dv, _plans, _roles):
        u, v = ctx.saved_tensors
        out = 0.0 if du is None else _triple(du, v, ctx.plans, ctx.roles)
        return out if dv is None else out + _triple(u, dv, ctx.plans, ctx.roles)


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

    def todense(self) -> torch.Tensor:
        """The dense matrix, (n, m) or (B, n, m)."""
        n, m = self.shape
        flat = self._idx("rows", self.pattern.rows) * m + self._idx("cols", self.pattern.cols)
        out = self.data.new_zeros(self.data.shape[:-1] + (n * m,))
        return out.index_add_(-1, flat, self.data).reshape(self.data.shape[:-1] + (n, m))

    def to_scipy(self):
        """A scipy CSR matrix of (nnz,) data, on the host."""
        import scipy.sparse as sp

        if self.data.ndim != 1:
            raise ValueError("to_scipy needs data of shape (nnz,)")
        return sp.coo_matrix(
            (self.data.detach().cpu().numpy(), (self.pattern.rows, self.pattern.cols)), shape=self.shape
        ).tocsr()

    # ---- linear ops --------------------------------------------------------

    def _batched(self, x: torch.Tensor):
        """(data, x as (B, n), squeeze) with the chain axes lined up."""
        if self.data.ndim > 2 or x.ndim > 2 or x.ndim == 0 or x.shape[-1] != self.shape[1]:
            raise ValueError(f"data must be (nnz,) or (B, nnz) and x (n,) or (B, n) with n = {self.shape[1]}, "
                             f"got {tuple(self.data.shape)} and {tuple(x.shape)}")
        squeeze = self.data.ndim == 1 and x.ndim == 1
        xb = x if x.ndim == 2 else x.unsqueeze(0)
        if self.data.ndim == 2 and xb.shape[0] == 1:
            xb = xb.expand(self.data.shape[0], -1)
        return self.data.contiguous(), xb.contiguous(), squeeze

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x of shape (n,) or (B, n), A of shape (m, n); K4."""
        data, xb, squeeze = self._batched(x)
        y = _SpMV.apply(data, xb, self.pattern)
        return y[0] if squeeze else y

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Aᵀ x for x of shape (m,) or (B, m); K4 on the transposed pattern."""
        return self.T.matvec(x)

    @property
    def T(self) -> "SparseMatrix":
        p = self.pattern
        return SparseMatrix(self.data[..., self._idx("tperm", p.transpose_perm)], p.transposed)

    def quad(self, x: torch.Tensor) -> torch.Tensor:
        """xᵀ A x, (B,) or scalar, for a square A; K4 with the fused reduction."""
        if self.shape[0] != self.shape[1]:
            raise ValueError(f"quad needs a square matrix, got {self.shape}")
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
        """Scale by a number, or per chain by a tensor of shape (B,)."""
        if torch.is_tensor(s) and s.ndim > 0:
            s = s[..., None]
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

    def __matmul__(self, other):
        if isinstance(other, SparseMatrix):
            return sp_matmul(self, other)
        return self.matvec(other)

    def pad_to(self, pattern: SparsePattern) -> "SparseMatrix":
        """Embed this matrix's values into a super-pattern (fixed scatter, K5)."""
        if pattern == self.pattern:
            return self
        cache = pattern.__dict__.setdefault("_pad_plans", {})
        plans = cache.get(self.pattern)
        if plans is None:
            smap = pattern.scatter_map(self.pattern)
            plans = _linear_plans(smap, np.arange(self.nnz), pattern.nnz, self.nnz)
            cache[self.pattern] = plans
        data = _Linear.apply(_as_rows(self.data), plans)
        return SparseMatrix(data.reshape(self.data.shape[:-1] + (pattern.nnz,)), pattern)

    def with_data(self, data) -> "SparseMatrix":
        return SparseMatrix(data, self.pattern)


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


def speye(n: int, dtype=torch.float32) -> SparseMatrix:
    return SparseMatrix(torch.ones(n, dtype=dtype, device=default_device()), _diag_pattern(n))


def from_dense(mat, pattern: SparsePattern | None = None, tol: float = 0.0) -> SparseMatrix:
    """The entries of a dense (m, n) matrix on `pattern`, by default its
    entries of absolute value above `tol` (a host mask)."""
    mat = as_tensor(mat)
    if pattern is None:
        pattern = SparsePattern.from_dense_mask((mat.abs() > tol).cpu().numpy())
    rows = _index(pattern, "rows", pattern.rows, mat.device)
    cols = _index(pattern, "cols", pattern.cols, mat.device)
    return SparseMatrix(mat[rows, cols], pattern)


def from_scipy(mat) -> SparseMatrix:
    """A scipy sparse matrix (duplicates summed), float64 on the default device."""
    coo = mat.tocoo()
    coo.sum_duplicates()
    pat = SparsePattern(coo.row, coo.col, coo.shape)
    return SparseMatrix(as_tensor(np.asarray(coo.data, np.float64)[pat.sort_order]), pat)


_ADD_CACHE: dict = {}
_MUL_CACHE: dict = {}


def sp_add(a: SparseMatrix, b: SparseMatrix) -> SparseMatrix:
    """A + B on the union pattern: each union entry sums at most two terms of
    the concatenated data (K5)."""
    key = (a.pattern, b.pattern)
    plan = _ADD_CACHE.get(key)
    if plan is None:
        pat = union_patterns(a.pattern, b.pattern)
        rows = np.concatenate([pat.scatter_map(a.pattern), pat.scatter_map(b.pattern)])
        plan = (pat, _linear_plans(rows, np.arange(a.nnz + b.nnz), pat.nnz, a.nnz + b.nnz))
        _ADD_CACHE[key] = plan
    pat, plans = plan
    batch = torch.broadcast_shapes(a.data.shape[:-1], b.data.shape[:-1])
    dtype = torch.promote_types(a.data.dtype, b.data.dtype)
    both = torch.cat([a.data.to(dtype).expand(batch + (a.nnz,)), b.data.to(dtype).expand(batch + (b.nnz,))], -1)
    data = _Linear.apply(_as_rows(both), plans)
    return SparseMatrix(data.reshape(batch + (pat.nnz,)), pat)


def sp_matmul(a: SparseMatrix, b: SparseMatrix) -> SparseMatrix:
    """Numeric SpGEMM over a cached symbolic plan (``spgemm_pattern``), K5."""
    key = (a.pattern, b.pattern)
    plan = _MUL_CACHE.get(key)
    if plan is None:
        pat, a_idx, b_idx, out_idx = spgemm_pattern(a.pattern, b.pattern)
        plan = (pat, _triple_plans((out_idx, a_idx, b_idx), (pat.nnz, a.nnz, b.nnz)))
        _MUL_CACHE[key] = plan
    pat, plans = plan
    if a.data.ndim > 2 or b.data.ndim > 2:
        raise ValueError("sp_matmul: data must be (nnz,) or (B, nnz)")
    dtype = torch.promote_types(a.data.dtype, b.data.dtype)
    data = _SpGEMM.apply(a.data.to(dtype), b.data.to(dtype), plans, (1, 2, 0))
    if a.data.ndim == 1 and b.data.ndim == 1:
        data = data[0]
    return SparseMatrix(data, pat)


def sp_tridiag(main: torch.Tensor, off: torch.Tensor) -> SparseMatrix:
    """Symmetric tridiagonal matrix from main diagonal (..., n) and
    off-diagonal (..., n-1) values."""
    pat = _tridiag_pattern(main.shape[-1])
    data = torch.cat([main, off, off], -1)
    return SparseMatrix(data[..., _index(pat, "sort", pat.sort_order, main.device)], pat)


def _broadcast_data(mats) -> list:
    """The matrices' data with their chain axes broadcast together and one dtype."""
    batch = torch.broadcast_shapes(*(m.data.shape[:-1] for m in mats))
    dtype = mats[0].data.dtype
    for m in mats[1:]:
        dtype = torch.promote_types(dtype, m.data.dtype)
    return [m.data.to(dtype).expand(batch + (m.nnz,)) for m in mats]


def sp_block_diag(mats: list[SparseMatrix]) -> SparseMatrix:
    """Block-diagonal composition; data (nnz,) or (B, nnz), chain axes broadcast."""
    rows, cols = [], []
    r0 = c0 = 0
    for m in mats:
        rows.append(m.pattern.rows.astype(np.int64) + r0)
        cols.append(m.pattern.cols.astype(np.int64) + c0)
        r0 += m.shape[0]
        c0 += m.shape[1]
    pat = SparsePattern(np.concatenate(rows), np.concatenate(cols), (r0, c0))
    data = torch.cat(_broadcast_data(mats), -1)
    return SparseMatrix(data[..., _index(pat, "sort", pat.sort_order, data.device)], pat)


def sp_kron(a: SparseMatrix, b: SparseMatrix) -> SparseMatrix:
    """Kronecker product A ⊗ B, the rightmost factor varying fastest (R-INLA's
    order); data (nnz,) or (B, nnz) on either side."""
    ar, ac, br, bc = a.pattern.rows, a.pattern.cols, b.pattern.rows, b.pattern.cols
    rows = (ar.astype(np.int64)[:, None] * b.shape[0] + br[None, :]).ravel()
    cols = (ac.astype(np.int64)[:, None] * b.shape[1] + bc[None, :]).ravel()
    pat = SparsePattern(rows, cols, (a.shape[0] * b.shape[0], a.shape[1] * b.shape[1]))
    ad, bd = _broadcast_data([a, b])
    data = (ad[..., :, None] * bd[..., None, :]).reshape(ad.shape[:-1] + (a.nnz * b.nnz,))
    return SparseMatrix(data[..., _index(pat, "sort", pat.sort_order, data.device)], pat)


@lru_cache(maxsize=None)
def _dot_plans(m: int):
    return _triple_plans((np.zeros(m, np.int64), np.arange(m), np.arange(m)), (1, m, m))


def sp_dot(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ_p z_p y_p per chain, (B,), for z (B, m) and y (m,) or (B, m): one K5
    row of m terms, differentiable in both."""
    return _SpGEMM.apply(z, y, _dot_plans(z.shape[-1]), (1, 2, 0))[:, 0]
