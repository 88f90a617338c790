"""KL-minimizing sparse approximate Cholesky of a covariance operator
(Schäfer, Katzfuss & Owhadi 2021).

Counterpart of ``tpu_gmrf.kl_cholesky``. The host half (reverse-maximin
ordering, ℓ-ball sparsity pattern, column buckets by padded neighbourhood
size) is a copy of the reference's NumPy code. Per bucket, the user's
``cov_fn`` gives Θ[S,S] on the padded points and K16 (`kl_columns`) solves
every column, L[S,k] = U⁻¹e_last for Θ[S,S] + jitter·I = UᵀU, straight into
L's data; Q = L Lᵀ is K5's SpGEMM, reindexed to the original point order by
a gather. Forward only: Θ may not require a gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import default_device
from .gmrf import GMRF
from .kernels import kl_columns
from .solvers.base import SolverSpec
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern

__all__ = [
    "reverse_maximin_ordering",
    "sparsity_pattern_from_ordering",
    "kl_buckets",
    "sparse_approximate_cholesky",
    "approximate_gmrf_kl",
    "gram",
]


def reverse_maximin_ordering(X: np.ndarray):
    """Fine-to-coarse ordering (Schäfer et al.): the LAST point is coarsest
    (ℓ=∞ at the end); ℓ increases along the ordering. Built by greedy
    maximin selection from the coarse end, then reversed — so each column k
    of the precision factor conditions on the coarser points after it (the
    screening effect that makes L approximately sparse).
    Returns (order, lengthscales ℓ in order position)."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    # start from the point farthest from the centroid
    i0 = int(np.argmax(np.linalg.norm(X - X.mean(axis=0), axis=1)))
    order = np.empty(n, dtype=np.int64)
    ell = np.empty(n)
    order[0] = i0
    ell[0] = np.inf
    d = np.linalg.norm(X - X[i0], axis=1)
    d[i0] = -np.inf
    for k in range(1, n):
        i = int(np.argmax(d))
        order[k] = i
        ell[k] = d[i]
        d = np.minimum(d, np.linalg.norm(X - X[i], axis=1))
        d[i] = -np.inf
    return order[::-1].copy(), ell[::-1].copy()


def sparsity_pattern_from_ordering(X, order, ell, rho: float):
    """Lower-triangular pattern in ORDERED indices: column k has rows
    {m ≥ k : dist(x_{order[m]}, x_{order[k]}) ≤ ρ·ℓ_k}."""
    from scipy.spatial import cKDTree

    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    tree = cKDTree(X)
    rows, cols = [], []
    for k in range(n):
        xi = X[order[k]]
        r = rho * ell[k] if np.isfinite(ell[k]) else np.inf
        if np.isinf(r):
            nbrs = np.arange(n)
        else:
            nbrs = np.asarray(tree.query_ball_point(xi, r), dtype=np.int64)
        m = pos[nbrs]
        m = m[m >= k]
        rows.append(m)
        cols.append(np.full(len(m), k, dtype=np.int64))
    return SparsePattern(np.concatenate(rows), np.concatenate(cols), (n, n))


def kl_buckets(pattern: SparsePattern) -> list:
    """The reference's column buckets (``kl_cholesky.py:91-115``), as a list
    of (cap, cols, S_idx (B, cap), entry_pos (B, cap) with -1 on the padding,
    count (B,)): columns padded to the next power of two of their size,
    their rows in descending order (diagonal last), padding at the front."""
    n = pattern.shape[0]
    colptr, row_in_col, perm_entries = pattern.csc
    # bucket columns by neighborhood size (padded to powers of two-ish)
    sizes = np.diff(colptr)
    buckets: dict = {}
    for k in range(n):
        Ns = int(sizes[k])
        cap = 1 << max(Ns - 1, 0).bit_length()  # next power of 2
        buckets.setdefault(cap, []).append(k)
    out = []
    for cap, cols in buckets.items():
        B = len(cols)
        S_idx = np.zeros((B, cap), dtype=np.int64)  # ordered point indices
        entry_pos = np.full((B, cap), -1, dtype=np.int64)
        count = np.zeros(B, dtype=np.int64)
        for b, k in enumerate(cols):
            s, e = int(colptr[k]), int(colptr[k + 1])
            rows_k = row_in_col[s:e]  # ascending; diagonal k first
            entries = perm_entries[s:e]
            # descending rows → diagonal last; pad at FRONT with decoupled ids
            desc = np.argsort(-rows_k)
            Ns = e - s
            S_idx[b, cap - Ns :] = rows_k[desc]
            entry_pos[b, cap - Ns :] = entries[desc]
            count[b] = Ns
        out.append((cap, np.asarray(cols), S_idx, entry_pos, count))
    return out


def _points(points) -> torch.Tensor:
    """Points as a tensor: a tensor keeps its device and dtype, anything else
    becomes float64 on the default device (the reference's np.float64)."""
    if isinstance(points, torch.Tensor):
        return points
    return torch.as_tensor(np.asarray(points, dtype=np.float64), device=default_device())


def sparse_approximate_cholesky(points, cov_fn, pattern: SparsePattern, order, jitter: float = 1e-6):
    """Fill L (on `pattern`, ordered indices) with the KL-optimal values:
    per column k, with S = rows(col k) ordered descending (diagonal last),
    L[S, k] = U⁻¹ e_last for Θ[S,S]+jitter·I = UᵀU. One K16 launch per
    bucket, on Θ = cov_fn(pts, pts) of the bucket's padded points."""
    P = _points(points)
    X = P[torch.as_tensor(np.asarray(order), device=P.device)]
    data = X.new_zeros(pattern.nnz)
    for cap, _, S_idx, entry_pos, count in kl_buckets(pattern):
        pts = X[torch.as_tensor(S_idx, device=X.device)]  # (B, cap, d)
        theta = cov_fn(pts, pts)  # (B, cap, cap)
        kl_columns(theta.to(X.dtype), torch.as_tensor(count, dtype=torch.int32, device=X.device),
                   torch.as_tensor(entry_pos, dtype=torch.int32, device=X.device), jitter, data)
    return SparseMatrix(data, pattern)


def approximate_gmrf_kl(
    points,
    cov_fn,
    rho: float = 3.0,
    mean=None,
    solver: SolverSpec = SolverSpec(),
    jitter: float = 1e-6,
):
    """GMRF approximating the Gaussian process with covariance `cov_fn` at
    `points`: Q = P (L Lᵀ) Pᵀ ≈ Θ⁻¹ with KL-optimal sparse L.

    cov_fn(P1, P2) takes point tensors P1, P2 of shape (B, m, d) and returns
    the Gram matrices (B, m, m) (`gram` lifts a pairwise kernel into this
    convention). Points that are not a tensor become float64 on the default
    device."""
    X = np.asarray(points.detach().cpu() if isinstance(points, torch.Tensor) else points, dtype=np.float64)
    n = X.shape[0]
    order, ell = reverse_maximin_ordering(X)
    pattern = sparsity_pattern_from_ordering(X, order, ell, rho)
    L = sparse_approximate_cholesky(points, cov_fn, pattern, order, jitter)
    Q_ord = L @ L.T
    # map back to original point indexing
    rows = np.asarray(order)[Q_ord.pattern.rows]
    cols = np.asarray(order)[Q_ord.pattern.cols]
    pat = SparsePattern(rows, cols, (n, n))
    Q = SparseMatrix(Q_ord.data[torch.as_tensor(pat.sort_order, device=Q_ord.device)], pat)
    mu = Q.data.new_zeros(n) if mean is None else mean
    return GMRF.from_precision(mu, Q, solver)


def gram(kernel):
    """Lift a pairwise kernel k(x, y) -> scalar, written in torch, into the
    batched Gram-matrix convention cov_fn(P1 (B,m,d), P2 (B,m,d)) -> (B,m,m)."""
    from torch.func import vmap

    def cov_fn(P1, P2):
        return vmap(lambda A, Bm: vmap(lambda a: vmap(lambda b: kernel(a, b))(Bm))(A))(P1, P2)

    return cov_fn
