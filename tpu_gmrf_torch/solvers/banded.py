"""Blocked banded Cholesky backend — the large-mesh (n ≫ 4096) path — batched
over chains.

Counterpart of ``tpu_gmrf.solvers.banded``. The precision pattern is
RCM-permuted on the host to bandwidth b (symbolic, cached per pattern);
choosing block size s ≥ b makes the permuted matrix block-tridiagonal with
s×s dense blocks, factored block by block:

  L₁ = chol(D₁);  Mₖ = Eₖ Lₖ⁻ᵀ;  Lₖ₊₁ = chol(Dₖ₊₁ − Mₖ Mₖᵀ)

The host plan (`_rcm_and_bandwidth`, `banded_plan`, `_PLAN_CACHE`) is the
reference's. The scatter and the factorization run on K11 (`bt_factor`),
the block forward/backward substitutions on K12 (`bt_trsv`). The block
Takahashi recursion of ``_sigma_blocks`` is K8 `sn_takahashi`'s step, one
launch per block from the last one up: block k is a supernode of width s
whose rows are block k+1 (Ld = L_k, Lb = M_k, Σ_RR = Σ_{k+1,k+1}); the
selected-inverse gathers and sums are K5 `gather_segsum` launches. The
logdet is differentiable through `BandedLogdet`, whose backward is Σ on
Q's pattern, and `solve` through `FactorSolve` (K12 forward and backward);
the other solves, `sqrt_matvec` and Σ have no backward and raise while a
gradient is asked. `sqrt_matvec` (L z) and the block-tridiagonal SpMV
(`BlockTridiagMV`, `block_tridiag_matvec`: x ↦ Qx over dense blocks, for
CG and RBMC through `kernels.hot_matvec`) run on K13 (`bt_sqrt`,
`bt_matvec`). Vectors of the SpMV are rows: x is (n,) or (k, n).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import (
    SOLVE_BOTH,
    SOLVE_L,
    SOLVE_LT,
    BandedTables,
    bt_factor,
    bt_matvec,
    bt_sqrt,
    bt_trsv,
    gather_segsum,
    sn_takahashi,
)
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import DirectFactor, no_double_backward
from .supernodal import _one_term, _sum_plans

__all__ = [
    "BandedFactor",
    "BandedLogdet",
    "BlockTridiagMV",
    "banded_factorize",
    "banded_plan",
    "block_tridiag_matvec",
]

_PLAN_CACHE: dict = {}
_TABLES: dict = {}
_SIGMA_CACHE: dict = {}
_SELINV_CACHE: dict = {}


def _rcm_and_bandwidth(pattern: SparsePattern):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = pattern.to_scipy_bool()
    S = (S + S.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(S, symmetric_mode=True))
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm))
    pr = inv_perm[pattern.rows]
    pc = inv_perm[pattern.cols]
    bw = int(np.max(np.abs(pr.astype(np.int64) - pc))) if pattern.nnz else 0
    return perm, inv_perm, pr, pc, bw


def banded_plan(pattern: SparsePattern, block: int | None = None):
    """Host symbolic plan: permutation + scatter maps into block-tridiag
    storage (D: (K, s, s) diagonal blocks, E: (K-1, s, s) sub blocks)."""
    key = (pattern, block)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    n = pattern.shape[0]
    perm, inv_perm, pr, pc, bw = _rcm_and_bandwidth(pattern)
    s = max(bw, 1)
    if block is not None:
        s = -(-s // block) * block
    else:
        mult = 8 if s < 64 else 128  # VPU/MXU tile alignment
        s = -(-s // mult) * mult
    K = -(-n // s)
    npad = K * s
    # scatter: for each entry keep LOWER (pr >= pc) into D or E
    lower = pr >= pc
    plr, plc = pr[lower].astype(np.int64), pc[lower].astype(np.int64)
    data_idx = np.nonzero(lower)[0]
    bk_r, bk_c = plr // s, plc // s
    same = bk_r == bk_c
    sub = bk_r == bk_c + 1
    if not np.all(same | sub):
        raise ValueError(
            f"bandwidth {bw} exceeds block structure (block {s}); increase block"
        )
    # D scatter (symmetric fill: also mirror off-diagonal within block)
    d_sel = data_idx[same]
    d_blk = bk_r[same]
    d_r = plr[same] - d_blk * s
    d_c = plc[same] - d_blk * s
    offdiag = d_r != d_c
    d_sel_m = d_sel[offdiag]
    d_blk_m = d_blk[offdiag]
    d_r_m = d_c[offdiag]
    d_c_m = d_r[offdiag]
    e_sel = data_idx[sub]
    e_blk = bk_c[sub]
    e_r = plr[sub] - (e_blk + 1) * s
    e_c = plc[sub] - e_blk * s
    plan = dict(
        n=n,
        s=s,
        K=K,
        npad=npad,
        perm=perm,
        inv_perm=inv_perm,
        d_idx=(np.concatenate([d_blk, d_blk_m]), np.concatenate([d_r, d_r_m]), np.concatenate([d_c, d_c_m]), np.concatenate([d_sel, d_sel_m])),
        e_idx=(e_blk, e_r, e_c, e_sel),
        pad_diag=np.arange(n, npad),
    )
    _PLAN_CACHE[key] = plan
    return plan


def _tables(pattern: SparsePattern, block) -> BandedTables:
    key = (pattern, block)
    t = _TABLES.get(key)
    if t is None:
        tperm = pattern.transpose_perm if pattern.is_symmetric else None
        t = _TABLES[key] = BandedTables(banded_plan(pattern, block), tperm)
    return t


def _takahashi_classes(meta, device) -> list:
    """K8 class batches of the Takahashi sweep, one per block, cached per
    (plan, device). Positions are those of P (B, K, 2s, s) flattened; Σ has
    the same layout plus one zero slot at K·2s·s (DUMMY), which the upper
    triangle of each Σ_{k+1,k+1} gather points at (K8 mirrors the lower)."""
    key = (meta, str(device))
    classes = _SIGMA_CACHE.get(key)
    if classes is None:
        plan = _PLAN_CACHE[meta]
        s, K = plan["s"], plan["K"]
        panel = 2 * s * s
        dummy = K * panel
        r, c = np.arange(s)[:, None], np.arange(s)[None, :]

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a)[None], dtype=torch.int32, device=device)

        classes = []
        for k in range(K):
            M = s if k < K - 1 else 0
            schur = np.where(c <= r, (k + 1) * panel + r * s + c, dummy) if M else np.zeros((0, 0), np.int64)
            classes.append(dict(W=s, M=M, panel=i32(k * panel + np.arange((s + M) * s).reshape(s + M, s)),
                                cols=i32(k * s + np.arange(s)), rows=i32((k + 1) * s + np.arange(M)),
                                schur=i32(schur), dummy=dummy, ndummy=plan["npad"]))
        _SIGMA_CACHE[key] = classes
    return classes


def _sigma_vals(P: torch.Tensor, meta, takahashi=sn_takahashi) -> torch.Tensor:
    """Block Takahashi (``banded.py:209-230``): Σ in P's layout, (B, K·2s·s+1):
    Σ_kk (lower) in rows 0..s of panel k, Σ_{k+1,k} in rows s..2s. K8 per
    block, the last block first; `takahashi` is K8's wrapper (its plain
    version only to compare the two on the card)."""
    vals = P.reshape(P.shape[0], -1)
    sig = vals.new_zeros(vals.shape[0], vals.shape[1] + 1)
    for c in reversed(_takahashi_classes(meta, P.device)):
        takahashi(vals, sig, c)
    return sig


def _selinv_plan(meta, pattern: SparsePattern):
    """K5 plan gathering Σ at `pattern`'s entries (``banded.py:238-265``),
    cached per (plan, pattern)."""
    key = (meta, pattern)
    got = _SELINV_CACHE.get(key)
    if got is None:
        plan = _PLAN_CACHE[meta]
        s = plan["s"]
        pr = plan["inv_perm"][pattern.rows].astype(np.int64)
        pc = plan["inv_perm"][pattern.cols].astype(np.int64)
        # normalize to the lower triangle (Σ symmetric)
        lo, hi = np.maximum(pr, pc), np.minimum(pr, pc)
        bk_r, bk_c = lo // s, hi // s
        if not np.all((bk_r == bk_c) | (bk_r == bk_c + 1)):
            raise ValueError("pattern outside block-tridiagonal envelope")
        # row lo − s·bk_c of panel bk_c: Σ_kk in rows 0..s, Σ_{k+1,k} in rows s..2s
        got = _SELINV_CACHE[key] = _one_term(bk_c * 2 * s * s + (lo - bk_c * s) * s + (hi - bk_c * s))
    return got


def _diag_plan(meta):
    """K5 plan of Σ's diagonal, unpermuted: out[perm[j]] = Σ_jj, j < n."""
    key = (meta, "diag")
    got = _SELINV_CACHE.get(key)
    if got is None:
        plan = _PLAN_CACHE[meta]
        s, j = plan["s"], np.arange(plan["n"])
        got = _SELINV_CACHE[key] = _one_term((j // s) * 2 * s * s + (j % s) * (s + 1), t=plan["perm"])
    return got


def _selinv_data(P: torch.Tensor, meta, pattern: SparsePattern) -> torch.Tensor:
    """Σ_ij on `pattern`'s entries, (B, nnz)."""
    return gather_segsum(_selinv_plan(meta, pattern), _sigma_vals(P, meta))


class BandedLogdet(torch.autograd.Function):
    """logdet of B precisions (data (B, nnz)) by K11, with the factor P and the
    boost counts as non-differentiable outputs.

    Backward: ∂logdet/∂data_p = Σ_{row p, col p}: the reference averages a
    symmetric pattern's two stored triangles before factoring, so each
    stored entry gets Σ_ij (the gradient JAX's AD gives whenever no pivot
    was boosted); Σ from the saved factor by K8 and K5."""

    @staticmethod
    def forward(ctx, data, meta):
        P, boost, logdet = bt_factor(data.contiguous(), _TABLES[meta])
        ctx.mark_non_differentiable(P, boost)
        ctx.save_for_backward(P)
        ctx.meta = meta
        return logdet, P, boost

    @staticmethod
    def backward(ctx, glogdet, _gP, _gb):
        no_double_backward("the banded logdet")
        (P,) = ctx.saved_tensors
        return glogdet[:, None] * _selinv_data(P, ctx.meta, ctx.meta[0]), None


@dataclasses.dataclass(frozen=True)
class BandedFactor(DirectFactor):
    """Block-tridiagonal Cholesky of B chains in the RCM order: P (B, K, 2s, s),
    panel k holding Lₖ (rows 0..s, lower) over Mₖ (rows s..2s). ``boost``
    (B,) counts the blocks whose Cholesky broke down and was retried with a
    boosted diagonal (0 in the well-conditioned case, as in the reference)."""

    P: torch.Tensor
    boost: torch.Tensor
    logdet_: torch.Tensor
    meta: tuple  # (pattern, block): the plan's key
    batch_shape: tuple
    data: torch.Tensor = dataclasses.field(repr=False, compare=False)  # (B, nnz) factored

    @property
    def plan(self):
        return _PLAN_CACHE[self.meta]

    @property
    def n(self):
        return self.plan["n"]

    @property
    def pattern(self) -> SparsePattern:
        return self.meta[0]

    @property
    def Lk(self) -> torch.Tensor:
        """(B, K, s, s) lower factors of the diagonal blocks."""
        return self.P[:, :, : self.plan["s"]]

    @property
    def Mk(self) -> torch.Tensor:
        """(B, K-1, s, s) sub-diagonal blocks of the factor."""
        s = self.plan["s"]
        return self.P[:, :-1, s:]

    # -- right-hand sides: (*batch, n) or (*batch, n, k) ↔ (B·k, n) rows -----------

    def _on_rows(self, b: torch.Tensor, op) -> torch.Tensor:
        """op(rows (B·k, n), k) on b (*batch, n) or (*batch, n, k), back in b's shape."""
        n, bs = self.n, tuple(self.batch_shape)
        if b.shape[: len(bs) + 1] != bs + (n,) or b.ndim not in (len(bs) + 1, len(bs) + 2):
            raise ValueError(f"rhs of shape {tuple(b.shape)} does not match a factor of {bs} x {n}")
        k = 1 if b.ndim == len(bs) + 1 else b.shape[-1]
        B = self.P.shape[0]
        rows = b.reshape(B, n, k).transpose(1, 2).reshape(B * k, n).contiguous()
        return op(rows, k).reshape(B, k, n).transpose(1, 2).reshape(b.shape)

    def _solve(self, b: torch.Tensor, mode: int) -> torch.Tensor:
        return self._on_rows(b, lambda rows, k: bt_trsv(self.P, _TABLES[self.meta], rows, k, mode))

    def _solve_both(self, b: torch.Tensor) -> torch.Tensor:
        """Q x = b (K12, forward and backward in one launch)."""
        return self._solve(b, SOLVE_BOTH)

    def forward_solve(self, b: torch.Tensor) -> torch.Tensor:
        """L y = b through the permuted block pipeline."""
        return self._solve(b, SOLVE_L)

    def backward_solve(self, z: torch.Tensor) -> torch.Tensor:
        """Lᵀ x = z through the permuted block pipeline (for sampling, the
        permutation of isotropic z is immaterial)."""
        return self._solve(z, SOLVE_LT)

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def _sigma_vals(self) -> torch.Tensor:
        return _sigma_vals(self.P, self.meta)

    def selinv_diag(self) -> torch.Tensor:
        sig = self._sigma_vals()
        d = gather_segsum(_diag_plan(self.meta), sig, out=sig.new_empty(sig.shape[0], self.n))
        return d.reshape(tuple(self.batch_shape) + (self.n,))

    def selinv(self, pattern: SparsePattern) -> SparseMatrix:
        """Entries of Q⁻¹ on `pattern` (within the block-tridiagonal envelope
        of the permuted ordering)."""
        z = _selinv_data(self.P, self.meta, pattern)
        return SparseMatrix(z.reshape(tuple(self.batch_shape) + (pattern.nnz,)), pattern)

    def selinv_dot(self, other: SparseMatrix) -> torch.Tensor:
        """tr(Q⁻¹·other) per chain: two K5 sums of Σ's values times other's."""
        z = _selinv_data(self.P, self.meta, other.pattern)
        y = other.data if other.data.ndim == 1 else other.data.reshape(-1, other.nnz)
        chunks, total = _sum_plans(other.nnz, dot=True)
        return gather_segsum(total, gather_segsum(chunks, z, y=y))[:, 0].reshape(tuple(self.batch_shape))

    def sqrt_matvec(self, z: torch.Tensor) -> torch.Tensor:
        """L z in the permuted block basis, mapped back (K13 `bt_sqrt`):
        maps N(0, I) to N(0, Q). z (*batch, n) or (*batch, n, k)."""
        return self._on_rows(z, lambda rows, k: bt_sqrt(self.P, _TABLES[self.meta], rows, k))


class _BtMatvec(torch.autograd.Function):
    """y = Q x on K13; Q is symmetric, so x̄ = Q ȳ is the same product."""

    @staticmethod
    def forward(ctx, x, mv):
        ctx.mv = mv
        return bt_matvec(mv.D, mv.E, mv.perm, x)

    @staticmethod
    def backward(ctx, gy):
        mv = ctx.mv
        return bt_matvec(mv.D, mv.E, mv.perm, gy.contiguous()), None


@dataclasses.dataclass(frozen=True)
class BlockTridiagMV:
    """x ↦ Qx over dense block-tridiagonal storage, on K13 `bt_matvec`.

    Callable on x (n,) or rows (k, n) (the reference takes (n, k) columns);
    with D (B, K, s, s) and E (B, K-1, s, s), one matrix per chain, on
    x (B, n). Differentiable in x (not in D and E)."""

    D: torch.Tensor  # (K, s, s) diagonal blocks (full symmetric)
    E: torch.Tensor  # (K-1, s, s) sub-diagonal blocks A[j+1, j]
    inv_perm: torch.Tensor  # (n,) RCM permutation map: original index → block position
    n: int
    npad: int
    perm: torch.Tensor = dataclasses.field(repr=False, default=None)  # (n,) int32: block position → original index

    def __post_init__(self):
        if self.perm is None:
            inv = self.inv_perm.long()
            perm = torch.empty_like(inv)
            perm[inv] = torch.arange(self.n, device=inv.device)
            object.__setattr__(self, "perm", perm.to(torch.int32))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 1
        y = _BtMatvec.apply((x[None] if squeeze else x).contiguous(), self)
        return y[0] if squeeze else y


def block_tridiag_matvec(Q: SparseMatrix, block: int | None = None) -> BlockTridiagMV:
    """Build the dense block-tridiagonal SpMV for banded-after-RCM patterns:
    scatter the values once into (K, s, s) diagonal and sub-diagonal blocks;
    a multiply is then one K13 launch streaming (2K−1)·s² values. Used by
    `kernels.hot_matvec` for CG/RBMC hot loops.

    Only valid for symmetric matrices: the storage keeps the lower triangle
    and mirrors it, so an asymmetric input would silently yield the
    symmetrized product. Raises on asymmetric patterns; values are averaged
    with their transpose (exact when values are symmetric)."""
    if not Q.pattern.is_symmetric:
        raise ValueError(
            "block_tridiag_matvec requires a symmetric sparsity pattern "
            "(lower-triangle storage is mirrored); use the BSR/COO paths "
            "for general matrices"
        )
    if Q.data.ndim > 2:
        raise ValueError("data must be (nnz,) or (B, nnz)")
    Q = Q.symmetrize()
    plan = banded_plan(Q.pattern, block)
    s, K, n = plan["s"], plan["K"], plan["n"]
    dev, batch = Q.data.device, tuple(Q.data.shape[:-1])

    def scatter(nblk, idx):
        blk, r, c, sel = (torch.as_tensor(np.asarray(a, np.int64), device=dev) for a in idx)
        out = Q.data.new_zeros(batch + (nblk * s * s,))
        return out.index_add_(-1, (blk * s + r) * s + c, Q.data[..., sel]).reshape(batch + (nblk, s, s))

    with torch.no_grad():
        D = scatter(K, plan["d_idx"])
        E = scatter(max(K - 1, 0), plan["e_idx"])
    return BlockTridiagMV(D=D, E=E, inv_perm=torch.as_tensor(np.ascontiguousarray(plan["inv_perm"], np.int64), device=dev),
                          n=n, npad=plan["npad"],
                          perm=torch.as_tensor(np.ascontiguousarray(plan["perm"], np.int32), device=dev))


def banded_factorize(Q: SparseMatrix, block: int | None = None) -> BandedFactor:
    """Factorize Q (data (nnz,) or (B, nnz)) on K11; a symmetric pattern is
    averaged with its transpose first, as in the reference. The logdet is
    differentiable on a symmetric pattern."""
    if Q.data.ndim > 2:
        raise ValueError("data must be (nnz,) or (B, nnz)")
    if torch.is_grad_enabled() and Q.data.requires_grad and not Q.pattern.is_symmetric:
        raise ValueError("the banded backend's gradients need a symmetric pattern")
    _tables(Q.pattern, block)  # the plan and its device tables, cached
    meta = (Q.pattern, block)
    batch = tuple(Q.data.shape[:-1])
    data = Q.data.reshape(-1, Q.nnz)
    logdet, P, boost = BandedLogdet.apply(data, meta)
    return BandedFactor(P, boost, logdet.reshape(batch), meta, batch, data)
