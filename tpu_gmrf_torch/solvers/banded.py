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
Takahashi recursion of ``_sigma_blocks`` runs on K8: block k is a supernode
of width s whose rows are block k+1 (Ld = L_k, Lb = M_k, Σ_RR =
Σ_{k+1,k+1}). K8's first entry `sn_takahashi_prep` forms every block's
C = M_k L_k⁻¹ and A = L_k⁻ᵀL_k⁻¹ at once (two launches: the K−1 blocks with
rows below, and the last), as the reference's batched inverses before its
scan; then K8 `sn_takahashi` does the K−1 dependent steps' products, one
launch per block from the last one up. The selected-inverse gathers and sums
are K5 `gather_segsum` launches. The
logdet is differentiable through `BandedLogdet`, whose backward is Σ on
Q's pattern, `solve` through `FactorSolve` (K12 forward and backward), and
Σ through `SelectedInverse`, whose tangent pass (`_tangent_sigma`) scatters
Q̇ onto the blocks (K5, the transpose of `_selinv_plan`), runs the
factorization's tangent block by block (K22) and the block Takahashi
sweep's (K21, as it reaches K8). The triangular solves and `sqrt_matvec` go
through `FactorTriangular`: L̄ onto the blocks by batched products, the
factorization's reverse sweep (K24, A_k from K8's first entry), then Q̄ at
the pattern's entries (K5); Lᵀ z is K13's second entry's transpose mode.
`sqrt_matvec` (L z) and the block-tridiagonal SpMV
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
    SegPlan,
    bt_factor,
    bt_factor_adjoint,
    bt_factor_tangent,
    bt_matvec,
    bt_sqrt,
    bt_trsv,
    gather_segsum,
    sn_takahashi,
    sn_takahashi_prep,
    sn_takahashi_tangent,
)
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import TRI_L, TRI_LINV, TRI_LINVT, DirectFactor, SelectedInverse, symmetric_weights
from .supernodal import _one_term, _prep_batches

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


def block_classes(K: int, s: int, device) -> tuple:
    """K8 class batches of the Takahashi sweep on K blocks of s, one per
    block, and the batches of K8's first entry, cached per (K, s, device).
    Positions are those of P (B, K, 2s, s) flattened; Σ has the same layout
    plus one zero slot at K·2s·s (DUMMY), which the upper triangle of each
    Σ_{k+1,k+1} gather points at (K8 mirrors the lower)."""
    key = (K, s, str(device))
    classes = _SIGMA_CACHE.get(key)
    if classes is None:
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
                                schur=i32(schur), dummy=dummy, ndummy=K * s))
        classes = _SIGMA_CACHE[key] = classes, _prep_batches(classes)
    return classes


def block_prep(P: torch.Tensor, prep=sn_takahashi_prep) -> torch.Tensor:
    """C_k = M_k L_k⁻¹ and A_k = L_k⁻ᵀL_k⁻¹ (lower) of every block of the factor
    P (B, K, 2s, s) in P's layout, (B, K·2s·s+1): K8's first entry (two
    launches: the K−1 blocks with rows below, and the last)."""
    _, preps = block_classes(P.shape[1], P.shape[3], P.device)
    vals = P.reshape(P.shape[0], -1)
    pre = vals.new_zeros(vals.shape[0], vals.shape[1] + 1)
    for c in preps:
        prep(vals, pre, c)
    return pre


def block_sigma(P: torch.Tensor, ops=(sn_takahashi_prep, sn_takahashi)):
    """Block Takahashi (``banded.py:209-230``) of the factor P (B, K, 2s, s):
    (pre, Σ) in P's layout, (B, K·2s·s+1) each: C_k and A_k of every block in
    pre (`block_prep`), Σ_kk (lower) in rows 0..s of panel k of Σ,
    Σ_{k+1,k} in rows s..2s, by K8 per block, the last block first; `ops`
    are K8's two wrappers (their plain versions only to compare them on the
    card)."""
    prep, takahashi = ops
    classes, _ = block_classes(P.shape[1], P.shape[3], P.device)
    pre = block_prep(P, prep)
    sig = torch.zeros_like(pre)
    for c in reversed(classes):
        takahashi(pre, sig, c)
    return pre, sig


def _sigma_vals(P: torch.Tensor, meta, ops=(sn_takahashi_prep, sn_takahashi)) -> torch.Tensor:
    """Σ in P's layout, (B, K·2s·s+1) (`block_sigma`)."""
    return block_sigma(P, ops)[1]


def _block_positions(meta, where) -> np.ndarray:
    """Positions in P's layout of `where`'s entries (an int n: the diagonal),
    each taken to the lower triangle of the permuted matrix."""
    plan = _PLAN_CACHE[meta]
    s, ip = plan["s"], plan["inv_perm"]
    if isinstance(where, int):
        j = ip[np.arange(where)].astype(np.int64)
        return (j // s) * 2 * s * s + (j % s) * (s + 1)
    pr, pc = ip[where.rows].astype(np.int64), ip[where.cols].astype(np.int64)
    lo, hi = np.maximum(pr, pc), np.minimum(pr, pc)
    bk_r, bk_c = lo // s, hi // s
    if not np.all((bk_r == bk_c) | (bk_r == bk_c + 1)):
        raise ValueError("pattern outside block-tridiagonal envelope")
    # row lo − s·bk_c of panel bk_c: Σ_kk in rows 0..s, Σ_{k+1,k} in rows s..2s
    return bk_c * 2 * s * s + (lo - bk_c * s) * s + (hi - bk_c * s)


def _scatter_plan(meta, where):
    """K5 plan putting T, given on `where`'s entries, onto P's layout (the
    transpose of `_selinv_plan`): position pos gets Σ t_p over the entries at pos."""
    key = (meta, where, "scatter")
    got = _SELINV_CACHE.get(key)
    if got is None:
        plan = _PLAN_CACHE[meta]
        pos = _block_positions(meta, where)
        ptr = np.concatenate([[0], np.cumsum(np.bincount(pos, minlength=plan["K"] * 2 * plan["s"] ** 2 + 1))])
        got = _SELINV_CACHE[key] = SegPlan(np.argsort(pos, kind="stable"), ptr=ptr)
    return got


def _factor_tangent(P: torch.Tensor, pre: torch.Tensor, t: torch.Tensor, where, meta) -> torch.Tensor:
    """(L̇_k, Ṁ_k) in P's layout, (B, K·2s·s+1), for Q̇ = sym(T), T given by t
    (B, m) on `where`'s entries: T onto the blocks (K5), then the
    factorization's tangent (K22); pre from `block_prep`."""
    B, K, s2, s = P.shape
    w = symmetric_weights(where, t.device, t.dtype)
    dvals = gather_segsum(_scatter_plan(meta, where), (t if w is None else t * w).contiguous())
    bt_factor_tangent(P, pre[:, :-1].view(B, K, s2, s), dvals[:, :-1].view(B, K, s2, s))
    return dvals


def _tangent_sigma(P: torch.Tensor, t: torch.Tensor, where, meta) -> torch.Tensor:
    """Σ̇ = −Σ·sym(T)·Σ in P's layout, (B, K·2s·s+1), for T given by t (B, m)
    on `where`'s entries: the factorization's tangent (`_factor_tangent`),
    then the block Takahashi sweep's, the last block first (K21)."""
    B = P.shape[0]
    classes, _ = block_classes(P.shape[1], P.shape[3], P.device)
    pre, sig = block_sigma(P)
    dvals = _factor_tangent(P, pre, t, where, meta)
    vals = P.reshape(B, -1)
    dsig = torch.zeros_like(pre)
    for c in reversed(classes):
        sn_takahashi_tangent(vals, pre, dvals, sig, dsig, c)
    return dsig


def _selinv_plan(meta, pattern: SparsePattern):
    """K5 plan gathering Σ at `pattern`'s entries (``banded.py:238-265``),
    cached per (plan, pattern)."""
    key = (meta, pattern)
    got = _SELINV_CACHE.get(key)
    if got is None:
        got = _SELINV_CACHE[key] = _one_term(_block_positions(meta, pattern))
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


def _selinv_data(P: torch.Tensor, meta, pattern, sig=None) -> torch.Tensor:
    """Σ_ij on `pattern`'s entries (an int n: the diagonal, unpermuted), (B,
    m), from Σ in P's layout (`sig`, by default the Takahashi recursion's)."""
    sig = _sigma_vals(P, meta) if sig is None else sig
    if isinstance(pattern, int):
        return gather_segsum(_diag_plan(meta), sig, out=sig.new_empty(sig.shape[0], pattern))
    return gather_segsum(_selinv_plan(meta, pattern), sig)


class BandedLogdet(torch.autograd.Function):
    """logdet of B precisions (data (B, nnz)) by K11, with the factor P and the
    boost counts as non-differentiable outputs.

    Backward: ∂logdet/∂data_p = Σ_{row p, col p}: the reference averages a
    symmetric pattern's two stored triangles before factoring, so each
    stored entry gets Σ_ij (the gradient JAX's AD gives whenever no pivot
    was boosted); Σ from the saved factor by K8 and K5 through
    `SelectedInverse`, differentiable in data. jvp: Σ_p Σ_{row p, col p}
    data̅'s tangent_p."""

    @staticmethod
    def forward(ctx, data, meta):
        P, boost, logdet = bt_factor(data.contiguous(), _TABLES[meta])
        ctx.mark_non_differentiable(P, boost)
        ctx.save_for_backward(data, P)
        ctx.save_for_forward(data, P)
        ctx.meta = meta
        return logdet, P, boost

    @staticmethod
    def _factor(ctx):
        data, P = ctx.saved_tensors
        return BandedFactor(P, None, None, ctx.meta, (P.shape[0],), data)

    @staticmethod
    def backward(ctx, glogdet, _gP, _gb):
        f = BandedLogdet._factor(ctx)
        return glogdet[:, None] * SelectedInverse.apply(f, f.pattern, f.data), None

    @staticmethod
    def jvp(ctx, ddata, _meta):
        f = BandedLogdet._factor(ctx)
        return (f._sigma(f.pattern) * ddata).sum(-1), None, None


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

    def logdet(self) -> torch.Tensor:
        return self.logdet_

    def _sigma_vals(self) -> torch.Tensor:
        return _sigma_vals(self.P, self.meta)

    def _sigma(self, where) -> torch.Tensor:
        """Σ at `where`'s entries (an int n: the diagonal), (B, m): K8, then K5;
        a pattern must lie within the permuted block-tridiagonal envelope."""
        return _selinv_data(self.P, self.meta, where)

    def _sigma_tangent(self, t: torch.Tensor, p_in, p_out) -> torch.Tensor:
        """−Σ·sym(T)·Σ at p_out's entries for T given by t (B, m) on p_in's (K5, K8, K22, K21)."""
        return _selinv_data(self.P, self.meta, p_out, sig=_tangent_sigma(self.P, t, p_in, self.meta))

    def _tri(self, op: int, z: torch.Tensor) -> torch.Tensor:
        """op(L) z for L = PᵀL_bP, L_b the block factor in the RCM order
        (`FactorTriangular`; the permutation of isotropic noise is immaterial
        to sampling): the solves on K12, L z and Lᵀ z on K13's second entry
        (`bt_sqrt`, its transpose mode). z (*batch, n) or (*batch, n, k)."""
        if op == TRI_LINV:
            return self._solve(z, SOLVE_L)
        if op == TRI_LINVT:
            return self._solve(z, SOLVE_LT)
        return self._on_rows(z, lambda rows, k: bt_sqrt(self.P, _TABLES[self.meta], rows, k, transpose=op != TRI_L))

    def _blocks(self, x: torch.Tensor) -> torch.Tensor:
        """x (*batch, n[, k]) as permuted, zero-padded blocks (B, K, s, k)."""
        plan = self.plan
        B, n, K, s = self.P.shape[0], plan["n"], plan["K"], plan["s"]
        xr = x.reshape(B, n, -1)
        out = xr.new_zeros(B, K * s, xr.shape[-1])
        out[:, :n] = xr[:, _TABLES[self.meta].on(x.device)["perm_l"]]
        return out.view(B, K, s, -1)

    def _lbar(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """L̄ = P_L(U Vᵀ) in P's layout plus a zero slot, (B, K·2s·s+1):
        L̄_k = tril(U_k V_kᵀ) and M̄_k = U_{k+1} V_kᵀ on the permuted blocks
        (batched products)."""
        B, K, s2, s = self.P.shape
        Ub, Vb = self._blocks(U), self._blocks(V)
        G = self.P.new_zeros(B, K * s2 * s + 1)
        Gb = G[:, :-1].view(B, K, s2, s)
        Gb[:, :, :s] = torch.tril(Ub @ Vb.mT)
        Gb[:, :-1, s:] = Ub[:, 1:] @ Vb[:, :-1].mT
        return G

    def _factor_adjoint(self, U: torch.Tensor, V: torch.Tensor) -> tuple:
        """data̅ for L̄ = P_L(U Vᵀ) (`_lbar`): the reverse sweep (K24, A_k from
        K8's first entry), then Q̄ at the pattern's entries (K5), each entry of
        a symmetric pair given half of its lower position's."""
        B, K, s2, s = self.P.shape
        G = self._lbar(U, V)
        pre = block_prep(self.P)
        bt_factor_adjoint(self.P, pre[:, :-1].view(B, K, s2, s), G[:, :-1].view(B, K, s2, s))
        w = symmetric_weights(self.pattern, G.device, G.dtype)
        return (_selinv_data(self.P, self.meta, self.pattern, sig=G) * w,)

    def _factor_tangent(self, dinputs) -> "BandedFactor":
        """The factor whose blocks are (L̇_k, Ṁ_k) (`_factor_tangent`: K5, K22)."""
        B, K, s2, s = self.P.shape
        dvals = _factor_tangent(self.P, block_prep(self.P), self._tangent_data(dinputs), self.pattern, self.meta)
        return dataclasses.replace(self, P=dvals[:, :-1].view(B, K, s2, s))


class _BtMatvec(torch.autograd.Function):
    """y = Q x on K13; Q is symmetric, so x̄ = Q ȳ is the same product (and
    through this Function, so differentiable again)."""

    @staticmethod
    def forward(ctx, x, mv):
        ctx.mv = mv
        return bt_matvec(mv.D, mv.E, mv.perm, x)

    @staticmethod
    def backward(ctx, gy):
        return _BtMatvec.apply(gy.contiguous(), ctx.mv), None

    @staticmethod
    def jvp(ctx, dx, _):
        mv = ctx.mv
        return bt_matvec(mv.D, mv.E, mv.perm, dx.contiguous())


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
