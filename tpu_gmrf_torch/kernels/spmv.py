"""Wrapper of the CSR SpMV kernel K4 (``csrc/spmv.cu``) and its plain version.

A CPU tensor goes to the plain version (gather + ``index_add``, the
segment-sum of ``sparse/matrix.py:58-65`` in the reference); a CUDA tensor
launches the kernel and raises if it cannot. ``csr_spmv.launches`` counts
the kernel launches. The pattern may be rectangular (n_r × n_c: y has n_r
rows, x n_c columns); the quadratic form needs a square one.

The kernel has two paths, chosen by `spmv_path` from (n_r, n_c, B, dtype): one
block per chain with the chain's x in shared memory (many chains of a short
vector, the flagship shape), or rows tiled over blocks with x read from
global memory (an x beyond the 48 KB of shared memory, or fewer chains
than the card has multiprocessors). Neither has a size limit of its own.
"""

from __future__ import annotations

import torch

from . import build
from .tridiag import SMEM_LIMIT, _fn, _on_cuda, _stream

__all__ = ["csr_spmv", "csr_spmv_plain", "spmv_path"]

ROWS_PER_TILE = 256  # rows per block of the tiled path (kThreads in the source)
FEW_CHAINS = 132  # below one chain per multiprocessor of an H100 the tiled path fills the card better
TILED_MIN_N = 1024  # ... once a chain has several tiles of rows


def spmv_path(n: int, B: int, dtype: torch.dtype, n_cols: int | None = None) -> str:
    """"shared" (one block per chain, x in shared memory) or "tiled" (rows
    over blocks, x in global memory) for B chains of n output rows and x of
    `n_cols` (default n) entries: x's size decides whether it fits shared
    memory, the rows whether tiles fill the card."""
    n_cols = n if n_cols is None else n_cols
    if (n_cols + 8) * (torch.finfo(dtype).bits // 8) > SMEM_LIMIT:
        return "tiled"
    return "tiled" if B < FEW_CHAINS and n >= TILED_MIN_N else "shared"


def csr_spmv_plain(row_ptr: torch.Tensor, col: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
                   quad: bool = False):
    """y = A x per chain (and xᵀ A x if `quad`); data (nnz,) or (B, nnz), x (B, n_c), y (B, n_r)."""
    n_r = row_ptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(n_r, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long()
    )
    col = col.long()
    xc = x[:, col]
    y = x.new_zeros(x.shape[0], n_r).index_add_(1, rows, data * xc)
    return y, ((data * x[:, rows] * xc).sum(-1) if quad else None)


def csr_spmv(row_ptr: torch.Tensor, col: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
             quad: bool = False):
    """K4: y (B, n_r) = A x, and xᵀ A x (B,) if `quad` (else None).

    row_ptr (n_r+1,) and col (nnz,) are int32 CSR indices of one n_r × n_c
    pattern whose entries are in canonical (row, col) order, columns below
    n_c = x.shape[1]; data is (nnz,) shared by all chains or (B, nnz); x is
    (B, n_c). `quad` needs n_r == n_c."""
    if x.ndim != 2 or data.ndim not in (1, 2):
        raise ValueError(f"csr_spmv: x must be (B, n) and data (nnz,) or (B, nnz), got "
                         f"{tuple(x.shape)}, {tuple(data.shape)}")
    B, n_c = x.shape
    n_r, nnz = row_ptr.shape[0] - 1, col.shape[0]
    if row_ptr.ndim != 1 or data.shape[-1] != nnz or (data.ndim == 2 and data.shape[0] != B):
        raise ValueError("csr_spmv: shapes of row_ptr, col, data and x disagree")
    if quad and n_r != n_c:
        raise ValueError(f"csr_spmv: the quadratic form needs a square pattern, got {n_r} x {n_c}")
    if not _on_cuda("csr_spmv", data, x):
        return csr_spmv_plain(row_ptr, col, data, x, quad)
    for t in (row_ptr, col):
        if t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("csr_spmv: row_ptr/col must be contiguous int32 on the data's device")
    tiled = spmv_path(n_r, B, x.dtype, n_c) == "tiled"
    y = x.new_empty(B, n_r)
    q = x.new_empty(B) if quad else None
    partial = x.new_empty(B, -(-n_r // ROWS_PER_TILE)) if tiled and quad else None
    code = _fn("tg_csr_spmv", x.dtype)(
        row_ptr.data_ptr(), col.data_ptr(), data.data_ptr(), nnz if data.ndim == 2 else 0,
        x.data_ptr(), y.data_ptr(), q.data_ptr() if quad else None, B, n_r, n_c, int(tiled),
        None if partial is None else partial.data_ptr(), _stream(x),
    )
    build.check(code, "csr_spmv", f" at B={B} n_r={n_r} n_c={n_c} {x.dtype}, {'tiled' if tiled else 'shared'} path")
    csr_spmv.launches += 1
    return y, q


csr_spmv.launches = 0
