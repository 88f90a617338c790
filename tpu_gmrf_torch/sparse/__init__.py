from .matrix import (
    SparseMatrix,
    from_dense,
    from_scipy,
    sp_add,
    sp_block_diag,
    sp_kron,
    sp_matmul,
    sp_tridiag,
    spdiag,
    speye,
)
from .pattern import SparsePattern, diag_pattern, spgemm_pattern, union_patterns

__all__ = [
    "SparsePattern",
    "SparseMatrix",
    "union_patterns",
    "spgemm_pattern",
    "diag_pattern",
    "spdiag",
    "sp_tridiag",
    "sp_add",
    "sp_matmul",
    "sp_block_diag",
    "sp_kron",
    "speye",
    "from_dense",
    "from_scipy",
]
