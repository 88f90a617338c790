"""Static sparsity patterns (host-side, NumPy).

TPU-native design note: the entire framework obeys a *static sparsity
contract* — the symbolic side of every sparse object (indices, orderings,
solver schedules) is computed once on the host as NumPy arrays and treated
as static metadata, while only the numeric values (`data`) are JAX arrays
that flow through `jit`/`grad`/`vmap`. This replaces the reference's
"symbolic-once / numeric-refactor" workspace machinery
(reference: src/workspace/gmrf_workspace.jl:31-289) with XLA's own
compile-once-per-pattern caching: a new hyperparameter value re-runs only
the numeric computation.
"""

from __future__ import annotations

import hashlib
from functools import cached_property, lru_cache

import numpy as np

__all__ = ["SparsePattern", "union_patterns", "spgemm_pattern", "diag_pattern", "dense_pattern"]


class SparsePattern:
    """Immutable COO/CSR sparsity pattern with content-based hashing.

    Entries are stored in row-major (row, col) sorted COO order; `indptr`
    gives the CSR row pointers over that order. Instances are hashable and
    comparable so they can be static fields of JAX pytrees (a new pattern
    triggers a re-trace; same pattern hits the jit cache).
    """

    __slots__ = ("rows", "cols", "shape", "indptr", "_digest", "__dict__")

    def __init__(self, rows, cols, shape):
        rows = np.asarray(rows, dtype=np.int32)
        cols = np.asarray(cols, dtype=np.int32)
        if rows.shape != cols.shape or rows.ndim != 1:
            raise ValueError("rows/cols must be matching 1-D arrays")
        order = np.lexsort((cols, rows))
        if not (np.all(np.diff(rows[order]) >= 0)):  # pragma: no cover
            raise AssertionError
        rows, cols = rows[order], cols[order]
        # reject duplicates — patterns must be canonical
        if len(rows) > 1:
            dup = (np.diff(rows) == 0) & (np.diff(cols) == 0)
            if np.any(dup):
                raise ValueError("duplicate entries in sparsity pattern")
        self.rows = rows
        self.rows.setflags(write=False)
        self.cols = cols
        self.cols.setflags(write=False)
        self.shape = (int(shape[0]), int(shape[1]))
        self.indptr = np.zeros(self.shape[0] + 1, dtype=np.int32)
        self.indptr[1:] = np.cumsum(np.bincount(rows, minlength=self.shape[0]), dtype=np.int32)
        self.indptr.setflags(write=False)
        h = hashlib.sha1()
        h.update(np.int64(self.shape[0]).tobytes())
        h.update(np.int64(self.shape[1]).tobytes())
        h.update(rows.tobytes())
        h.update(cols.tobytes())
        self._digest = h.digest()
        self._sort_order = order  # maps caller's entry order -> canonical

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def sort_order(self) -> np.ndarray:
        """Permutation from the constructor's entry order to canonical order."""
        return self._sort_order

    def __hash__(self):
        return hash(self._digest)

    def __eq__(self, other):
        return isinstance(other, SparsePattern) and self._digest == other._digest

    def __repr__(self):
        return f"SparsePattern(shape={self.shape}, nnz={self.nnz})"

    # ---- derived symbolic structure (cached) -------------------------------

    @cached_property
    def transpose_perm(self) -> np.ndarray:
        """p such that data[p] reorders entries into the transpose's
        canonical (col-major w.r.t. original) order."""
        return np.lexsort((self.rows, self.cols)).astype(np.int32)

    @cached_property
    def transposed(self) -> "SparsePattern":
        return SparsePattern(self.cols[self.transpose_perm], self.rows[self.transpose_perm], (self.shape[1], self.shape[0]))

    @cached_property
    def is_symmetric(self) -> bool:
        if self.shape[0] != self.shape[1]:
            return False
        t = self.transpose_perm
        return bool(np.array_equal(self.rows, self.cols[t]) and np.array_equal(self.cols, self.rows[t]))

    @cached_property
    def diag_positions(self) -> np.ndarray:
        """Index into entries for each diagonal element (must all exist)."""
        mask = self.rows == self.cols
        d = np.full(min(self.shape), -1, dtype=np.int32)
        d[self.rows[mask]] = np.nonzero(mask)[0].astype(np.int32)
        if np.any(d < 0):
            raise ValueError("pattern is missing diagonal entries")
        return d

    @cached_property
    def csc(self):
        """(colptr, row_of_entry_in_col_order, perm_into_canonical)."""
        perm = self.transpose_perm
        colptr = np.zeros(self.shape[1] + 1, dtype=np.int32)
        np.add.at(colptr, self.cols + 1, 1)
        colptr = np.cumsum(colptr, dtype=np.int32)
        return colptr, self.rows[perm], perm

    def scatter_map(self, sub: "SparsePattern") -> np.ndarray:
        """Positions of `sub`'s entries inside this pattern.

        Used to pad a sub-pattern's values into a super-pattern with fixed
        indices (reference: `_pad_to_workspace_pattern`,
        src/workspace/latent_model_integration.jl:208-244).
        """
        if sub.shape != self.shape:
            raise ValueError("shape mismatch")
        # canonical order is ascending (row, col) key order: a binary search per entry
        keys, want = self._keys, sub._keys
        pos = np.minimum(np.searchsorted(keys, want), max(self.nnz - 1, 0))
        miss = np.nonzero(keys[pos] != want)[0] if self.nnz else np.arange(sub.nnz)
        if len(miss):
            k = miss[0]
            raise ValueError(f"sub-pattern entry {(int(sub.rows[k]), int(sub.cols[k]))} not contained in pattern")
        return pos.astype(np.int32)

    @cached_property
    def _keys(self) -> np.ndarray:
        """row·ncols + col per entry, ascending."""
        return self.rows.astype(np.int64) * self.shape[1] + self.cols

    @classmethod
    def from_dense_mask(cls, mask: np.ndarray) -> "SparsePattern":
        rows, cols = np.nonzero(np.asarray(mask))
        return cls(rows, cols, mask.shape)

    @classmethod
    def from_scipy(cls, mat) -> "SparsePattern":
        coo = mat.tocoo()
        return cls(coo.row, coo.col, coo.shape)

    def to_scipy_bool(self):
        import scipy.sparse as sp

        return sp.coo_matrix(
            (np.ones(self.nnz, dtype=bool), (self.rows, self.cols)), shape=self.shape
        ).tocsr()


def diag_pattern(n: int) -> SparsePattern:
    idx = np.arange(n, dtype=np.int32)
    return SparsePattern(idx, idx, (n, n))


@lru_cache(maxsize=16)
def dense_pattern(n: int) -> SparsePattern:
    """The full n×n pattern (row-major), for dense Hessians."""
    rows, cols = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return SparsePattern(rows.ravel(), cols.ravel(), (n, n))


def union_patterns(*patterns: SparsePattern) -> SparsePattern:
    """Union of patterns (all same shape). Mirrors the reference's joint
    prior∪obs-Hessian pattern construction
    (src/workspace/latent_model_integration.jl:116-134)."""
    shape = patterns[0].shape
    for p in patterns:
        if p.shape != shape:
            raise ValueError("shape mismatch in union")
    keys = np.unique(np.concatenate([p._keys for p in patterns]))
    return SparsePattern(keys // shape[1], keys % shape[1], shape)


def spgemm_pattern(a: SparsePattern, b: SparsePattern):
    """Symbolic sparse×sparse product C = A·B with a numeric gather plan.

    Returns ``(c_pattern, a_idx, b_idx, out_idx)`` such that the numeric
    product is ``c_data = segment_sum(a_data[a_idx] * b_data[b_idx], out_idx)``
    — a fixed-shape gather + segment-sum, fully jittable on TPU. Used for the
    Matérn α-recursion on a fixed structural pattern
    (reference: ext/.../matern_spde.jl:177-231 and `_matern_structural_pattern`).
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError("inner dimension mismatch")
    # Expansion triples (i, k) x (k, j): each a-entry (i, k) pairs with every
    # b-entry in row k. Fully vectorized on host.
    starts = b.indptr[a.cols]
    counts = (b.indptr[a.cols + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    a_idx = np.repeat(np.arange(a.nnz, dtype=np.int32), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    b_idx = (np.repeat(starts.astype(np.int64), counts) + offs).astype(np.int32)
    out_r = a.rows[a_idx]
    out_c = b.cols[b_idx]
    key = out_r.astype(np.int64) * b.shape[1] + out_c
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // b.shape[1]).astype(np.int32)
    c_cols = (uniq % b.shape[1]).astype(np.int32)
    c_pat = SparsePattern(c_rows, c_cols, (a.shape[0], b.shape[1]))
    # np.unique returns keys sorted ascending == canonical (row, col) order,
    # so inv already maps triples to canonical entry ids.
    return c_pat, a_idx, b_idx, inv.astype(np.int32)
