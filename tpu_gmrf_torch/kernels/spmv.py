"""Wrapper of the CSR SpMV kernel K4 (``csrc/spmv.cu``) and its plain version.

A CPU tensor goes to the plain version (gather + ``index_add``, the
segment-sum of ``sparse/matrix.py:58-65`` in the reference); a CUDA tensor
launches the kernel and raises if it cannot. ``csr_spmv.launches`` counts
the kernel launches.
"""

from __future__ import annotations

import torch

from . import build
from .tridiag import SMEM_LIMIT, _fn, _on_cuda, _stream

__all__ = ["csr_spmv", "csr_spmv_plain"]


def csr_spmv_plain(row_ptr: torch.Tensor, col: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
                   quad: bool = False):
    """y = A x per chain (and xᵀ A x if `quad`); data (nnz,) or (B, nnz), x (B, n)."""
    n = x.shape[-1]
    rows = torch.repeat_interleave(
        torch.arange(n, device=x.device), (row_ptr[1:] - row_ptr[:-1]).long()
    )
    col = col.long()
    xr, xc = x[:, rows], x[:, col]
    y = x.new_zeros(x.shape).index_add_(1, rows, data * xc)
    return y, ((data * xr * xc).sum(-1) if quad else None)


def csr_spmv(row_ptr: torch.Tensor, col: torch.Tensor, data: torch.Tensor, x: torch.Tensor,
             quad: bool = False):
    """K4: y (B, n) = A x, and xᵀ A x (B,) if `quad` (else None).

    row_ptr (n+1,) and col (nnz,) are int32 CSR indices of one square pattern
    whose entries are in canonical (row, col) order; data is (nnz,) shared by
    all chains or (B, nnz); x is (B, n)."""
    if x.ndim != 2 or data.ndim not in (1, 2):
        raise ValueError(f"csr_spmv: x must be (B, n) and data (nnz,) or (B, nnz), got "
                         f"{tuple(x.shape)}, {tuple(data.shape)}")
    B, n = x.shape
    nnz = col.shape[0]
    if row_ptr.shape != (n + 1,) or data.shape[-1] != nnz or (data.ndim == 2 and data.shape[0] != B):
        raise ValueError("csr_spmv: shapes of row_ptr, col, data and x disagree")
    if not _on_cuda("csr_spmv", data, x):
        return csr_spmv_plain(row_ptr, col, data, x, quad)
    for t in (row_ptr, col):
        if t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("csr_spmv: row_ptr/col must be contiguous int32 on the data's device")
    need = (n + 8) * data.element_size()
    if need > SMEM_LIMIT:
        raise ValueError(f"csr_spmv: n={n} needs {need} bytes of shared memory, over {SMEM_LIMIT}")
    y = torch.empty_like(x)
    q = x.new_empty(B) if quad else None
    code = _fn("tg_csr_spmv", x.dtype)(
        row_ptr.data_ptr(), col.data_ptr(), data.data_ptr(), nnz if data.ndim == 2 else 0,
        x.data_ptr(), y.data_ptr(), q.data_ptr() if quad else None, B, n, _stream(x),
    )
    build.check(code, "csr_spmv")
    csr_spmv.launches += 1
    return y, q


csr_spmv.launches = 0
