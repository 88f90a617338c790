"""BSR (block-sparse-row) matvec/matmat on the kernels K14 `bsr_spmm` and
K15 `bsr_outer` (``csrc/bsr.cu``).

Counterpart of ``tpu_gmrf.kernels.bsr_spmv``. The pattern is blocked on the
host into bs×bs dense blocks (`_bsr_plan`, the reference's, cached per
(pattern, bs)); `bsr_from_sparse` scatters the values into the blocks (one
index operation, differentiable); `bsr_spmv` multiplies, with a gradient:
dX = Aᵀg is K14 over the transposed plan (reading the blocks transposed in
place), dBlocks[b] = g_rowblock(b) ⊗ x_colblock(b) is K15.

Vectors are rows, as everywhere in the port: x is (n,) or (k, n), one
vector per row, where the reference takes (n, k) columns. The blocks are
(nblocks, bs, bs), shared by all rows, or (B, nblocks, bs, bs) with x (B, n),
one matrix per chain (what ``vmap`` over chains gives the reference).

A CPU tensor takes the plain versions (gather, ``einsum``, ``index_add_``,
as the reference); a CUDA tensor launches the kernels or raises.
``bsr_spmm.launches`` and ``bsr_outer.launches`` count the launches. K14
streams the stored blocks through rings in shared memory, a group of warps
walking a run of block rows; `spmm_launch` gives its split. K15 gives a
warp a run of consecutive stored blocks and writes each block once, its
lanes holding the block row's g values while the row lasts.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = ["BSRMatrix", "bsr_from_sparse", "bsr_spmv", "best_block_size", "bsr_spmm", "bsr_spmm_plain",
           "bsr_outer", "bsr_outer_plain", "spmm_launch"]


# --------------------------------------------------------------------------
# Host-side blocking (symbolic, once per pattern)
# --------------------------------------------------------------------------

_BSR_PLAN_CACHE: dict = {}


@dataclasses.dataclass(eq=False)  # identity hash: plans are cached & reused
class _BSRPlan:
    n: int  # logical dimension
    bs: int  # block size
    nb: int  # number of block rows/cols (padded)
    block_rows: np.ndarray  # (nblocks,) int32, sorted
    block_cols: np.ndarray  # (nblocks,) int32
    rowptr: np.ndarray  # (nb+1,) int32
    scatter_block: np.ndarray  # (nnz,) block id of each COO entry
    scatter_i: np.ndarray  # (nnz,) in-block row
    scatter_j: np.ndarray  # (nnz,) in-block col
    t_perm: np.ndarray  # (nblocks,) permutation: transpose block order
    transpose: Any = None  # _BSRPlan of Aᵀ (set once at build)
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def nblocks(self):
        return int(self.block_rows.shape[0])

    def on(self, device) -> dict:
        """Device copies of the tables: int32 for the kernels, int64
        (``*_l``) for the plain versions and the scatter; cached."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = {}
            for name in ("block_rows", "block_cols", "rowptr", "t_perm"):
                a = np.ascontiguousarray(getattr(self, name))
                t[name] = torch.tensor(a, dtype=torch.int32, device=device)
                t[name + "_l"] = torch.tensor(a, dtype=torch.long, device=device)
            flat = (self.scatter_block.astype(np.int64) * self.bs + self.scatter_i) * self.bs + self.scatter_j
            t["scatter_l"] = torch.tensor(flat, dtype=torch.long, device=device)
            self._dev[key] = t
        return t


def _bsr_plan(pattern, bs: int) -> _BSRPlan:
    key = (pattern, bs)
    hit = _BSR_PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    n = pattern.shape[0]
    nb = -(-n // bs)
    br = pattern.rows // bs
    bc = pattern.cols // bs
    bid_raw = br.astype(np.int64) * nb + bc
    uniq, inv = np.unique(bid_raw, return_inverse=True)
    block_rows = (uniq // nb).astype(np.int32)
    block_cols = (uniq % nb).astype(np.int32)
    rowptr = np.zeros(nb + 1, dtype=np.int32)
    np.add.at(rowptr, block_rows + 1, 1)
    rowptr = np.cumsum(rowptr, dtype=np.int32)
    # transpose plan: blocks sorted by (col, row)
    t_order = np.lexsort((block_rows, block_cols)).astype(np.int32)
    t_rowptr = np.zeros(nb + 1, dtype=np.int32)
    np.add.at(t_rowptr, block_cols + 1, 1)
    t_rowptr = np.cumsum(t_rowptr, dtype=np.int32)
    empty = np.zeros(0, dtype=np.int32)
    plan = _BSRPlan(
        n=n,
        bs=bs,
        nb=nb,
        block_rows=block_rows,
        block_cols=block_cols,
        rowptr=rowptr,
        scatter_block=inv.astype(np.int32).ravel(),
        scatter_i=(pattern.rows % bs).astype(np.int32),
        scatter_j=(pattern.cols % bs).astype(np.int32),
        t_perm=t_order,
    )
    plan.transpose = _BSRPlan(
        n=n,
        bs=bs,
        nb=nb,
        block_rows=block_cols[t_order],
        block_cols=block_rows[t_order],
        rowptr=t_rowptr,
        scatter_block=empty,
        scatter_i=empty,
        scatter_j=empty,
        t_perm=np.argsort(t_order).astype(np.int32),
        transpose=plan,
    )
    _BSR_PLAN_CACHE[key] = plan
    return plan


_BS_CACHE: dict = {}


def best_block_size(pattern, candidates=(8, 16, 32)) -> int:
    """Smallest padded-footprint block size: the product streams the blocks,
    so minimize nblocks·bs². GMRF patterns are scattered (≈7 nnz/row), so
    small blocks win."""
    hit = _BS_CACHE.get(pattern)
    if hit is not None:
        return hit
    best, best_cost = candidates[0], None
    for bs in candidates:
        br = pattern.rows // bs
        bc = pattern.cols // bs
        nb = -(-pattern.shape[0] // bs)
        nblocks = len(np.unique(br.astype(np.int64) * nb + bc))
        cost = nblocks * bs * bs
        if best_cost is None or cost < best_cost:
            best, best_cost = bs, cost
    _BS_CACHE[pattern] = best
    return best


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _row_blocks(x: torch.Tensor, plan: _BSRPlan) -> torch.Tensor:
    """Rows x (R, n) zero-padded and cut into blocks: (R, nb, bs)."""
    n_pad = plan.nb * plan.bs
    if n_pad != plan.n:
        x = torch.nn.functional.pad(x, (0, n_pad - plan.n))
    return x.reshape(x.shape[0], plan.nb, plan.bs)


def bsr_spmm_plain(blocks: torch.Tensor, plan: _BSRPlan, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """K14's function (``bsr_spmv.py:182-202``): gather, batched product,
    segment-sum over block rows. With `transpose`, Aᵀx over ``plan.transpose``
    on the permuted, transposed blocks (``:217-219``)."""
    if transpose:
        blocks = blocks.index_select(-3, plan.on(x.device)["t_perm_l"]).mT
        plan = plan.transpose
    t = plan.on(x.device)
    xg = _row_blocks(x, plan)[:, t["block_cols_l"]]  # (R, nblocks, bs)
    prod = torch.einsum("bij,rbj->rbi" if blocks.ndim == 3 else "rbij,rbj->rbi", blocks, xg)
    y = x.new_zeros(x.shape[0], plan.nb, plan.bs).index_add_(1, t["block_rows_l"], prod)
    return y.reshape(x.shape[0], -1)[:, : plan.n]


def bsr_outer_plain(plan: _BSRPlan, g: torch.Tensor, x: torch.Tensor, per_chain: bool = False) -> torch.Tensor:
    """K15's function (``bsr_spmv.py:220-228``): dBlocks[b] = Σ_rows
    g[rowblock(b)] ⊗ x[colblock(b)], or one product per row with `per_chain`."""
    t = plan.on(x.device)
    gb = _row_blocks(g, plan)[:, t["block_rows_l"]]
    xb = _row_blocks(x, plan)[:, t["block_cols_l"]]
    return torch.einsum("rbi,rbj->rbij" if per_chain else "rbi,rbj->bij", gb, xb)


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

# K14's split (csrc/bsr.cu) by block size: (warps a group, ring depth,
# shared bytes a group, shared bytes a CTA). A group walks a run of block
# rows through its ring; its stages hold the most blocks (4 to 32) that keep
# it within its bytes, and a CTA holds as many groups (1 to 8 warps) as its
# bytes allow: three CTAs a SM at bs=8. The launcher sizes both from these.
# Picked by the sweep of `tools/trace_vg.py <root> bsr` on an H100 (PERF.md
# §6).
SPMM_SPLIT = {8: (1, 2, 16 * 1024, 72 * 1024), 16: (2, 2, 32 * 1024, 72 * 1024), 32: (4, 2, 16 * 1024, 72 * 1024)}


def spmm_launch(bs: int) -> tuple[int, int, int, int]:
    """(warps a group, ring depth, shared bytes a group, shared bytes a CTA)
    of K14 for blocks of bs."""
    return SPMM_SPLIT[bs]


def _check(name: str, plan: _BSRPlan, x: torch.Tensor, blocks: torch.Tensor | None = None):
    if x.ndim != 2 or x.shape[1] != plan.n:
        raise ValueError(f"{name}: vectors must be rows (R, {plan.n}), got {tuple(x.shape)}")
    if plan.bs not in (8, 16, 32):
        raise ValueError(f"{name}: block size {plan.bs} not supported (8, 16, 32)")
    if blocks is not None:
        want = (max(plan.nblocks, 1), plan.bs, plan.bs)
        if blocks.shape[-3:] != want or blocks.ndim not in (3, 4) or (blocks.ndim == 4 and blocks.shape[0] != x.shape[0]):
            raise ValueError(f"{name}: blocks {tuple(blocks.shape)} do not match the plan {want} and x {tuple(x.shape)}")


def bsr_spmm(blocks: torch.Tensor, plan: _BSRPlan, x: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """K14: y (R, n) = A x (Aᵀ x with `transpose`) for the blocks of `plan`;
    x (R, n) rows; blocks (nblocks, bs, bs) or, one matrix per row,
    (R, nblocks, bs, bs). Not differentiable (`bsr_spmv` is)."""
    _check("bsr_spmm", plan, x, blocks)
    if not _on_cuda("bsr_spmm", blocks, x):
        return bsr_spmm_plain(blocks, plan, x, transpose)
    t, tt = plan.on(x.device), (plan.transpose if transpose else plan).on(x.device)
    y = torch.empty_like(x)
    R = x.shape[0]
    code = _fn("tg_bsr_spmm", x.dtype)(
        blocks.data_ptr(), blocks[0].numel() if blocks.ndim == 4 else 0, tt["rowptr"].data_ptr(),
        tt["block_cols"].data_ptr(), t["t_perm"].data_ptr() if transpose else None, plan.bs, plan.nb, plan.n,
        x.data_ptr(), y.data_ptr(), R, *spmm_launch(plan.bs), _stream(x),
    )
    build.check(code, "bsr_spmm", f" at bs={plan.bs} nblocks={plan.nblocks} rows={x.shape[0]} {x.dtype}")
    bsr_spmm.launches += 1
    return y


def bsr_outer(plan: _BSRPlan, g: torch.Tensor, x: torch.Tensor, per_chain: bool = False) -> torch.Tensor:
    """K15: dBlocks (nblocks, bs, bs) = Σ over the rows of g, x (R, n) of
    g[rowblock] ⊗ x[colblock]; with `per_chain`, (R, nblocks, bs, bs), one
    product per row."""
    _check("bsr_outer", plan, x)
    if g.shape != x.shape:
        raise ValueError(f"bsr_outer: g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    if not _on_cuda("bsr_outer", g, x):
        return bsr_outer_plain(plan, g, x, per_chain)
    t = plan.on(x.device)
    R = x.shape[0]
    out = x.new_empty(((R,) if per_chain else ()) + (max(plan.nblocks, 1), plan.bs, plan.bs))
    if plan.nblocks == 0:
        return out.zero_()
    code = _fn("tg_bsr_outer", x.dtype)(
        t["block_rows"].data_ptr(), t["block_cols"].data_ptr(), plan.nblocks, plan.bs, plan.n, g.data_ptr(),
        x.data_ptr(), R, int(per_chain), out.data_ptr(), _stream(x),
    )
    build.check(code, "bsr_outer", f" at bs={plan.bs} nblocks={plan.nblocks} rows={R} {x.dtype}")
    bsr_outer.launches += 1
    return out


bsr_spmm.launches = 0
bsr_outer.launches = 0


class _BsrSpmv(torch.autograd.Function):
    """y = A x (or Aᵀ x with `transpose`) on K14; x̄ = Aᵀ ȳ (`_BsrSpmv` the
    other way, so differentiable again), blocks̄ = K15's outer products, whose
    own derivative is not written: a graph through them raises."""

    @staticmethod
    def forward(ctx, blocks, x, plan, transpose):
        ctx.plan, ctx.transpose = plan, transpose
        ctx.save_for_backward(blocks, x)
        return bsr_spmm(blocks, plan, x, transpose=transpose)

    @staticmethod
    def backward(ctx, gy):
        from ..solvers.base import no_double_backward  # solvers import this module

        blocks, x = ctx.saved_tensors
        gy = gy.contiguous()
        gx = _BsrSpmv.apply(blocks, gy, ctx.plan, not ctx.transpose) if ctx.needs_input_grad[1] else None
        gb = None
        if ctx.needs_input_grad[0]:
            no_double_backward("the BSR product's gradient in its blocks")
            u, v = (x, gy) if ctx.transpose else (gy, x)
            gb = bsr_outer(ctx.plan, u, v, per_chain=blocks.ndim == 4)
        return gb, gx, None, None


def bsr_spmv(blocks: torch.Tensor, x: torch.Tensor, plan: _BSRPlan) -> torch.Tensor:
    """y = A x for BSR blocks; x (k, n) rows → y (k, n). Differentiable in
    blocks and x."""
    return _BsrSpmv.apply(blocks.contiguous(), x.contiguous(), plan, False)


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Blocked view of a fixed-pattern sparse matrix."""

    blocks: torch.Tensor  # (nblocks, bs, bs) or (B, nblocks, bs, bs)
    plan: _BSRPlan

    @property
    def shape(self):
        return (self.plan.n, self.plan.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x (n,) or rows (k, n) ((B, n) with one matrix per chain)."""
        squeeze = x.ndim == 1
        y = bsr_spmv(self.blocks, x[None] if squeeze else x, self.plan)
        return y[0] if squeeze else y

    def __matmul__(self, x):
        return self.matvec(x)


def bsr_from_sparse(A, bs: int | None = None) -> BSRMatrix:
    """Block a SparseMatrix (data (nnz,) or (B, nnz)) into BSR. Symbolic work
    cached per (pattern, bs); the numeric conversion is one scatter
    (differentiable). bs=None picks the block size minimizing padded bytes
    (`best_block_size`)."""
    if bs is None:
        bs = best_block_size(A.pattern)
    plan = _bsr_plan(A.pattern, bs)
    if A.data.ndim > 2:
        raise ValueError("data must be (nnz,) or (B, nnz)")
    size = max(plan.nblocks, 1) * bs * bs
    flat = A.data.new_zeros(A.data.shape[:-1] + (size,))
    blocks = flat.index_copy(-1, plan.on(A.data.device)["scatter_l"], A.data)
    return BSRMatrix(blocks.reshape(A.data.shape[:-1] + (max(plan.nblocks, 1), bs, bs)), plan)
