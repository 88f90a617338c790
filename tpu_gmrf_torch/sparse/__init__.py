from .matrix import SparseMatrix, sp_add, sp_tridiag, spdiag
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
]
