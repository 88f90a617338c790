"""Rao-Blackwellized Monte Carlo marginal-variance estimators (Sidén 2018).

Counterpart of ``tpu_gmrf.solvers.rbmc``; reference spec src/solvers/rbmc.jl —
the fallback variance path when selected inversion is unavailable or too
expensive:
  var_i ≈ 1/Q_ii + Var_s[ (Q_ii)⁻¹ · (Q x_s − Q_ii x_s)_i ]
with centered posterior samples x_s. The samples are one batched
backward-solve (S columns); the Rao-Blackwellization is one sparse product
with the S samples as rows (`kernels.hot_matvec`). Randomness comes from a
`torch.Generator`, as in `GMRF.sample`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rbmc_var", "block_rbmc_var"]


def _centered_samples(gmrf, generator, n_samples: int, z=None) -> torch.Tensor:
    """(S, n) draws of x − μ. `z` (S, n), standard normal, replaces the
    generator's draws (to hold two implementations to the same numbers)."""
    if gmrf.Q.data.ndim != 1:
        raise ValueError("the RBMC estimators take one GMRF, not a batch")
    if z is None:
        return gmrf.sample(generator, (n_samples,)) - gmrf.mean
    with torch.no_grad():
        return gmrf.factor.backward_solve(z.mT.contiguous()).mT


def rbmc_var(gmrf, generator, n_samples: int = 1000, *, _z=None) -> torch.Tensor:
    from ..kernels import hot_matvec

    Q = gmrf.Q
    D = Q.diagonal()
    Dinv = 1.0 / D
    xs = _centered_samples(gmrf, generator, n_samples, _z)  # (S, n)
    with torch.no_grad():
        Qx = hot_matvec(Q)(xs.contiguous())  # one product with S rows
    transformed = Dinv * (Qx - D * xs)
    return Dinv + torch.var(transformed, dim=0, unbiased=True)


_BLOCK_PLAN_CACHE: dict = {}


def _block_rbmc_plan(pattern, enclosure_size: int):
    """Host plan for block RBMC (reference src/solvers/rbmc.jl:52-160):
    greedy disjoint neighborhood subsets, each grown by `enclosure_size`
    rings of neighbors, padded to one uniform width so the device work is a
    single batched dense Cholesky + solve. Returns
    (blk_idx (b,B), interior_mask (b,B), entry_pos (b,B,B) into data+dummy)."""
    key = (pattern, enclosure_size)
    plan = _BLOCK_PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    import scipy.sparse as sp

    n = pattern.shape[0]
    S = pattern.to_scipy_bool().tocsr()
    S = ((S + S.T) > 0).tocsr()
    # position lookup: value = flat index into Q.data + 1 (0 = missing)
    M = sp.csr_matrix(
        (np.arange(1, pattern.nnz + 1, dtype=np.int64), (pattern.rows, pattern.cols)),
        shape=pattern.shape,
    )
    visited = np.zeros(n, bool)
    blocks = []
    for i in range(n):
        if visited[i]:
            continue
        interior = S.indices[S.indptr[i] : S.indptr[i + 1]]
        interior = interior[~visited[interior]]
        if i not in interior:
            interior = np.append(interior, i)
        visited[interior] = True
        explored = set(interior.tolist())
        ring = interior
        enclosure = []
        for _ in range(enclosure_size):
            neigh = np.unique(np.concatenate([S.indices[S.indptr[j] : S.indptr[j + 1]] for j in ring]))
            ring = np.array([j for j in neigh if j not in explored], dtype=np.int64)
            explored |= set(ring.tolist())
            enclosure.append(ring)
        blocks.append((interior.astype(np.int64), np.concatenate(enclosure) if enclosure else np.zeros(0, np.int64)))
    B = max(len(i) + len(e) for i, e in blocks)
    nb = len(blocks)
    blk_idx = np.zeros((nb, B), np.int64)
    interior_mask = np.zeros((nb, B), bool)
    pad_mask = np.zeros((nb, B), bool)
    for bi, (interior, enc) in enumerate(blocks):
        ids = np.concatenate([interior, enc])
        k = len(ids)
        blk_idx[bi, :k] = ids
        interior_mask[bi, : len(interior)] = True
        pad_mask[bi, k:] = True
    # dense block gather positions
    entry_pos = np.zeros((nb, B, B), np.int64)
    for bi in range(nb):
        sub = M[blk_idx[bi]][:, blk_idx[bi]].toarray()
        entry_pos[bi] = sub  # 0 = structurally missing → dummy slot
    plan = (blk_idx, interior_mask, pad_mask, entry_pos)
    _BLOCK_PLAN_CACHE[key] = plan
    return plan


def block_rbmc_var(gmrf, generator, n_samples: int = 100, enclosure_size: int = 1, *, _z=None) -> torch.Tensor:
    """Block Rao-Blackwellized MC variances (Sidén 2018 block variant;
    reference src/solvers/rbmc.jl:109-160 `var(gmrf, BlockRBMCStrategy)`):
    exact selected-inverse diagonals of padded dense blocks + the MC
    correction from the block exterior, batched over blocks (the batched
    block Cholesky and solves are ``torch.linalg`` calls, as they are
    ``jnp.linalg`` calls in the reference)."""
    Q = gmrf.Q
    blk_idx, interior_mask, pad_mask, entry_pos = _block_rbmc_plan(Q.pattern, enclosure_size)
    dev, dtype = Q.data.device, Q.data.dtype
    xs = _centered_samples(gmrf, generator, n_samples, _z)  # (S, n)
    blk = torch.as_tensor(blk_idx, device=dev)
    data = torch.cat([Q.data.new_zeros(1), Q.data])
    Qb = data[torch.as_tensor(entry_pos, device=dev)]  # (nb, B, B)
    # padded slots alias node 0 (blk_idx zero-fill): zero their rows/cols and
    # give them a unit diagonal so the batched Cholesky stays well-posed
    pad = torch.as_tensor(pad_mask, device=dev)
    valid = (~pad).to(dtype)  # (nb, B)
    Qb = Qb * valid[:, :, None] * valid[:, None, :] + torch.diag_embed(pad.to(dtype))
    with torch.no_grad():
        Qx = Q.matvec(xs.contiguous())
        L = torch.linalg.cholesky(Qb)  # (nb, B, B)
        eye = torch.eye(Qb.shape[-1], dtype=dtype, device=dev).expand_as(Qb)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        inv_diag = torch.einsum("bkj,bkj->bj", Linv, Linv)  # diag of Qb⁻¹
        xb = xs[:, blk] * valid  # (S, nb, B)
        rhs = (Qx[:, blk] - torch.einsum("bij,sbj->sbi", Qb, xb)) * valid
        kappa = torch.cholesky_solve(rhs.movedim(0, -1), L)  # (nb, B, S)
        est_b = inv_diag + torch.var(kappa, dim=-1, unbiased=True)
    interior = torch.as_tensor(interior_mask, device=dev)
    out = torch.zeros(Q.shape[0], dtype=dtype, device=dev)
    out[blk[interior]] = est_b[interior]
    return out
