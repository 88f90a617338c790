"""Graphical lasso via thresholding + max-det chordal completion
(Zhang, Fattahi & Sojoudi).

Counterpart of ``tpu_gmrf.graphical_lasso``. The host half (the
soft-thresholded covariance, the chordal cover with its cliques and
junction-tree separators) is a copy of the reference's NumPy code. The
completion's inverse has the decomposable-MLE closed form

  Q = Σ_cliques E_C (C_C)⁻¹ E_Cᵀ − Σ_separators E_S (C_S)⁻¹ E_Sᵀ

computed here by K17 (`block_inv`: every clique and separator block
inverted, with its sign, in one ragged launch) and K5 (`gather_segsum`:
the signed entries summed into the cover's data over a host plan, in a
fixed order, without atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import default_device
from .gmrf import GMRF
from .kernels import BlockSets, SegPlan, block_inv, gather_segsum
from .solvers.base import SolverSpec
from .sparse.matrix import SparseMatrix
from .sparse.pattern import SparsePattern

__all__ = ["soft_threshold_cov", "chordal_cover", "embed_plan", "graphical_lasso"]


def soft_threshold_cov(X: np.ndarray, threshold, shift: float = 0.0):
    """Soft-thresholded sample covariance (off-diagonals shrunk toward 0 by
    `threshold`; diagonal kept + optional shift). `threshold` may be a scalar
    λ or a sparse/dense per-entry penalty matrix Λ — the *restricted*
    graphical lasso (reference docs graphical_lasso.jl:68-80): entries outside
    Λ's pattern are forced to zero. Returns (C dense masked, pattern, mean)."""
    X = np.asarray(X, dtype=np.float64)
    m, n = X.shape
    mu = X.mean(axis=0)
    Xc = X - mu
    S = (Xc.T @ Xc) / m
    if np.isscalar(threshold):
        lam = float(threshold)
        allowed = None
    else:
        if isinstance(threshold, SparseMatrix):
            lam = threshold.todense().detach().cpu().numpy()
        elif hasattr(threshold, "toarray"):
            lam = threshold.toarray()
        else:
            lam = np.asarray(threshold, dtype=np.float64)
        allowed = lam != 0.0
    C = np.where(S > lam, S - lam, np.where(S < -lam, S + lam, 0.0))
    if allowed is not None:
        C = np.where(allowed, C, 0.0)
    np.fill_diagonal(C, np.diag(S) + shift)
    pattern = SparsePattern.from_dense_mask(C != 0.0)
    return C, pattern, mu


def chordal_cover(pattern: SparsePattern):
    """Chordal cover by elimination fill (RCM ordering), plus a clique tree:
    returns (cover_pattern, cliques, separators) with cliques/separators as
    lists of original-index arrays."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = pattern.shape[0]
    S = pattern.to_scipy_bool()
    S = (S + S.T).tolil()
    perm = np.asarray(reverse_cuthill_mckee(S.tocsr(), symmetric_mode=True))
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(n)
    # adjacency in elimination (permuted) order
    adj = [set() for _ in range(n)]
    for i, j in zip(pattern.rows, pattern.cols):
        pi, pj = int(inv_perm[i]), int(inv_perm[j])
        if pi != pj:
            adj[pi].add(pj)
            adj[pj].add(pi)
    # elimination: connect higher neighbors
    higher = [None] * n
    for v in range(n):
        hn = sorted(u for u in adj[v] if u > v)
        higher[v] = hn
        for a_i in range(len(hn)):
            for b_i in range(a_i + 1, len(hn)):
                a, b = hn[a_i], hn[b_i]
                if b not in adj[a]:
                    adj[a].add(b)
                    adj[b].add(a)
    # maximal cliques of the filled (chordal) graph: candidates
    # C_v = {v} ∪ higher(v); C_v is non-maximal iff some earlier u with
    # v ∈ higher(u) has higher(u) ⊇ C_v
    filled_higher = [sorted(u for u in adj[v] if u > v) for v in range(n)]
    cand = [set([v]) | set(filled_higher[v]) for v in range(n)]
    maximal_idx = []
    for v in range(n):
        absorbed = False
        for u in range(n):
            if u != v and cand[v] < cand[u] or (cand[v] == cand[u] and u < v):
                absorbed = True
                break
        if not absorbed:
            maximal_idx.append(v)
    cliques_perm = [sorted(cand[v]) for v in maximal_idx]
    # junction tree = maximum-weight spanning tree of the clique graph with
    # weights |K_i ∩ K_j|; separators are the tree-edge intersections
    p_cl = len(cliques_perm)
    seps_perm = []
    if p_cl > 1:
        import scipy.sparse as _sp
        from scipy.sparse.csgraph import minimum_spanning_tree

        W = np.zeros((p_cl, p_cl))
        sets = [set(c) for c in cliques_perm]
        for i in range(p_cl):
            for j in range(i + 1, p_cl):
                w = len(sets[i] & sets[j])
                W[i, j] = W[j, i] = -w  # negate → max-weight via min spanning tree
        mst = minimum_spanning_tree(_sp.csr_matrix(W))
        ii, jj = mst.nonzero()
        for a, b in zip(ii, jj):
            inter = sorted(sets[a] & sets[b])
            if inter:
                seps_perm.append(inter)
    # cover pattern = all within-clique pairs
    rows, cols = [], []
    for c in cliques_perm:
        c = np.asarray(c)
        rows.append(np.repeat(c, len(c)))
        cols.append(np.tile(c, len(c)))
    allr = np.concatenate(rows)
    allc = np.concatenate(cols)
    uniq = np.unique(np.stack([allr, allc]), axis=1)
    cover_perm = SparsePattern(uniq[0], uniq[1], (n, n))
    # back to original indices
    cover = SparsePattern(perm[cover_perm.rows], perm[cover_perm.cols], (n, n))
    cliques = [np.sort(perm[np.asarray(c)]) for c in cliques_perm]
    separators = [np.sort(perm[np.asarray(s)]) for s in seps_perm]
    return cover, cliques, separators


def embed_plan(cover: SparsePattern, sets) -> np.ndarray:
    """Cover position of every (set, a, c), row-major per set, sets in order:
    the positions the reference's triple loop over ``position_map`` gives
    (``graphical_lasso.py:152-156``), by a search over the sorted (row, col)
    keys of the cover."""
    n = np.int64(cover.shape[1])
    keys = cover.rows.astype(np.int64) * n + cover.cols
    parts = []
    for s in sets:
        s = np.asarray(s, np.int64)
        parts.append((s[:, None] * n + s[None, :]).ravel())
    want = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    pos = np.searchsorted(keys, want)
    if want.size and (pos.max() >= keys.size or np.any(keys[np.minimum(pos, keys.size - 1)] != want)):
        raise ValueError("a set's entry is not in the cover")
    return pos


def graphical_lasso(
    X: np.ndarray,
    threshold: float,
    shift: float = 0.0,
    solver: SolverSpec = SolverSpec(),
) -> GMRF:
    """Estimate a sparse-precision Gaussian from samples X (m, n), in float64
    on the default device."""
    C, pattern, mu = soft_threshold_cov(X, threshold, shift)
    cover, cliques, separators = chordal_cover(pattern)
    sets = list(cliques) + list(separators)
    blocks = BlockSets(sets, [1.0] * len(cliques) + [-1.0] * len(separators))
    pos = embed_plan(cover, sets)
    plan = SegPlan.grouped(pos, np.arange(pos.size), cover.nnz)
    dev = default_device()
    signed = block_inv(torch.as_tensor(C, dtype=torch.float64, device=dev), blocks)
    data = gather_segsum(plan, signed[None])[0]
    Q = SparseMatrix(data, cover)
    return GMRF.from_precision(torch.as_tensor(mu, dtype=torch.float64, device=dev), Q.symmetrize(), solver)
