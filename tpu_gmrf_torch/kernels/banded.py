"""Wrappers of the block-tridiagonal kernels K11 `bt_factor`, K12 `bt_trsv`
and K13 `bt_matvec` (with its second entry `bt_sqrt`) of ``csrc/banded.cu``,
and their plain versions.

The factor of B chains is one array P (B, K, 2s, s): panel k holds the
lower Cholesky factor L_k of the k-th diagonal block in rows 0..s and
M_k = E_k L_k⁻ᵀ in rows s..2s (zero in the last panel). K11 scatters Q's
data (B, nnz) into the panels through a `BandedTables` (the reference
plan's d_idx / e_idx), factors them with the reference's ``_chol_boosted``
per block and chain, and returns P, the boost count (B,) int32 and the
logdet (B,). Its factorization is one launch: a thread-block cluster per
chain walks the band by column tiles of 64 (`factor_cluster` picks the
cluster's size), the panel below each diagonal tile solved by substitution;
the chains whose pivots broke down are redone with the boost. K12 solves with P on rows (B·k, n), chain-major: mode 0
L y = b, mode 1 Lᵀ x = b, mode 2 both, in the original numbering: the rows
are gathered through the RCM permutation and padded into blocks
(B, K, s, k), solved there by the block entry's design (below) with the
sweeps the mode asks for, and scattered back; `trsv_workspace` sizes its
workspace.

K13 multiplies by block-tridiagonal storage, with the RCM permutation of x
and y. `bt_matvec` takes the symmetric matrix as D (K, s, s) (both
triangles) and E (K-1, s, s), shared by all rows of x (R, n), or one set
per row ((B, K, s, s), (B, K-1, s, s) with x (B, n)); `bt_sqrt` takes K11's
factor P and computes y_k = L_k z_k + M_{k-1} z_{k-1} on rows (B·k, n),
chain-major. Three launches: x gathered into permuted rows, the units (64
rows of one block row, up to 8 vectors, in clusters that add their
Eᵀ-term partials in distributed shared memory), then y scattered with the
partials added. `matvec_split` sizes the work; any s is taken.

K11 and K12 have a block entry each, for the SPIKE solve
(``parallel/pbtridiag.py``): `bt_factor_blocks` factors blocks D (B, K, s, s),
E (B, K-1, s, s) given as they are (D_k symmetrized, no pivot boost: a block
that is not positive definite gives a NaN logdet) into the same P, and
`bt_trsv_blocks` solves with it on blocks (B, K, s, k), with no permutation.
The first runs K11's cluster factorization with no boost.
The second runs one thread-block cluster per chain and column tile of 64
right-hand sides (8 when k ≤ 8), the s rows of each block step spread over
its blocks by tiles of 64: a block step is the coupling, one product, then
the substitution with L_k by row tiles (the diagonal tile solved by
substitution, a cluster barrier, the tiles further on less its product),
never a product with an inverse, whose residual would grow with L_k's
condition. Its workspace holds B·s·k of scratch. A card that cannot hold
one such cluster raises with the shape.

K22 `bt_factor_tangent` is the tangent of K11's factorization (the selected
inverse's derivative): from P, A_k = L_k⁻ᵀL_k⁻¹ (K8's first entry on the
banded blocks) and the blocks' Q̇ in P's layout, it gives L̇_k and Ṁ_k in
place, block after block, a thread-block cluster per chain
(`tangent_cluster`) with its products in float64 on a workspace
(`bt_tangent_work`) on the float64 tensor cores. K24 `bt_factor_adjoint`
is its adjoint: from P, A_k and the factor's cotangent (L̄_k, M̄_k in P's
layout) it gives the cotangent of Q's blocks (the lower entries of D_k and
E_k) in place, the blocks walked backwards, in K22's design.
`bt_sqrt_t` is K13's second entry's transpose mode, y_k = L_kᵀz_k +
M_kᵀz_{k+1}, one launch: a unit is a slab of rows of [L_k; M_k] by 128
columns streamed through shared memory and used by all k ≤ 16 right-hand sides (each block of P read once), the slabs above L_k's
diagonal skipped, the slabs of a column tile a cluster that adds their
partials and writes y through the permutation (`sqrt_t_launch`,
`sqrt_t_slabs`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .supernodal import _chol_boosted, _sm_count, _sym, panel_adjoint_math, panel_tangent_math
from .tridiag import SOLVE_BOTH, SOLVE_L, SOLVE_LT, _fn, _on_cuda, _stream

__all__ = ["BandedTables", "bt_factor", "bt_factor_plain", "bt_trsv", "bt_trsv_plain",
           "bt_matvec", "bt_matvec_plain", "bt_sqrt", "bt_sqrt_plain", "matvec_split", "trsv_workspace",
           "bt_factor_blocks", "bt_factor_blocks_plain", "bt_trsv_blocks", "bt_trsv_blocks_plain",
           "factor_cluster", "bt_factor_adjoint", "bt_factor_adjoint_plain", "bt_sqrt_t_plain", "bt_sqrt_t",
           "sqrt_t_launch", "sqrt_t_slabs", "sqrt_t_smem"]

MV_ROWS = 64  # kMvR of the source: rows of a matrix block per unit of K13
MV_CLUSTER = 8  # the largest cluster of K13's units (portable)
MV_THREADS = (256, 192)  # threads of a unit, by preference (the source takes up to 512)
TILE = 64  # kT of csrc/tiles.cuh: the row tile of the factorization and of the block entry's solves
MAX_CLUSTER = 16  # the largest (non-portable) cluster of the card
SMEM_MAX = 232448  # a block's shared memory on the card (227 KB)
SQT_COLS = 128  # kSqtCols of the source: the columns of a unit of bt_sqrt's transpose mode
SQT_STAGE_BYTES = 16384  # kSqtStageBytes: bytes of a stage of its ring
SQT_RING = 4  # kSqtRing: stages of the ring
SQT_CLUSTER = 4  # kSqtMaxCluster: slabs of a cluster, at most
SQT_WINDOW_BYTES = 32768  # a window's rows of z, at most (two units an SM: 64 KB of ring and 32 KB of z each)


def factor_cluster(s: int, B: int, fit, name: str = "bt_factor", most: int | None = None) -> int:
    """Blocks per cluster of a factorization of B matrices (chains, or K16's
    columns) of s rows, each on a cluster of its own, K9's, K11's and K16's
    rule: at most 2⌈s/64⌉ (the row tiles below a column tile, 1 for a
    single tile; or `most`) and 16; of those, the size that runs the
    matrices in the fewest waves of clusters, the largest among equals.
    ``fit(cs)`` is how many clusters of cs blocks the card holds at once
    (0: refused)."""
    nt = -(-s // TILE)
    if most is None:
        most = 1 if nt == 1 else 2 * nt
    best = None
    for cs in range(min(MAX_CLUSTER, most), 0, -1):
        held = fit(cs)
        if held > 0 and (best is None or -(-B // held) < best[0]):
            best = (-(-B // held), cs)
    if best is None:
        raise RuntimeError(f"{name}: the card holds no cluster of the factorization at {s} rows")
    return best[1]


def tangent_cluster(W: int, M: int, units: int, fit, sms: int, name: str) -> int:
    """Blocks per cluster of K20-K22 on `units` (panel, chain) pairs of panels
    W wide with M rows below, on a card of `sms` SMs: one where the units
    fill the card; else `factor_cluster`'s choice, at most the widest
    product's 64 × 64 output tiles and the SMs per unit."""
    if units >= sms:
        return 1
    return factor_cluster(W, units, fit, name, max(1, min(-(-W // TILE) * -(-max(W, M) // TILE), sms // units)))


_FIT: dict = {}  # the card's cluster counts, per (entry, type, cluster size, arguments)


def _fit(entry: str, dtype, name: str, args: tuple = ()):
    """``fit(cs, *more)`` of `factor_cluster` on this card for the kernel
    whose cluster counts the C entry `entry` gives (called as
    ``entry(cs, *args, *more, &count)``), each asked once."""
    def fit(cs, *more):
        key = (entry, dtype, cs, args + more)
        if key not in _FIT:
            held = ctypes.c_int(0)
            build.check(_fn(entry, dtype)(cs, *args, *more, ctypes.byref(held)), name)
            _FIT[key] = held.value
        return _FIT[key]

    return fit


@functools.cache
def _cluster(s: int, B: int, dtype, entry: str = "tg_bt_factor_fit", name: str = "bt_factor") -> int:
    """`factor_cluster` on this card for the kernel whose cluster counts the C
    entry `entry` gives, worked out once per shape and type."""
    return factor_cluster(s, B, _fit(entry, dtype, name), name)


class BandedTables:
    """Scatter and permutation tables of one banded plan: for each table
    entry, the data index it reads (``src``, -1 for a padding diagonal 1)
    and its position in a chain's P (``dst``); ``perm`` (n,) maps block
    position j to the original index; ``tperm`` averages Q with its
    transpose (None for a non-symmetric pattern). int32 for the kernels,
    int64 for the plain versions, cached per device."""

    def __init__(self, plan: dict, tperm=None):
        n, s, K, npad = plan["n"], plan["s"], plan["K"], plan["npad"]
        self.n, self.s, self.K, self.npad = n, s, K, npad
        panel = 2 * s * s
        if K * panel >= 2**31:
            raise ValueError(f"banded factor of {K} blocks of {s} is too large for int32 positions")
        blk, r, c, sel = (np.asarray(a, np.int64) for a in plan["d_idx"])
        low = r >= c  # the kernels keep the lower triangle of each diagonal block
        eblk, er, ec, esel = (np.asarray(a, np.int64) for a in plan["e_idx"])
        pad = np.asarray(plan["pad_diag"], np.int64)
        dst = np.concatenate([
            blk[low] * panel + r[low] * s + c[low],
            eblk * panel + (s + er) * s + ec,
            (pad // s) * panel + (pad % s) * (s + 1),
        ])
        src = np.concatenate([sel[low], esel, np.full(len(pad), -1, np.int64)])
        if np.unique(dst).size != dst.size:
            raise ValueError("banded plan scatters two entries to one position")
        self._np = dict(src=src, dst=dst, perm=np.asarray(plan["perm"], np.int64))
        if tperm is not None:
            self._np["tperm"] = np.asarray(tperm, np.int64)
        self._dev: dict = {}

    @property
    def ntab(self) -> int:
        return len(self._np["src"])

    def on(self, device) -> dict:
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            t = {"tperm": None, "tperm_l": None}
            for k, a in self._np.items():
                t[k] = torch.tensor(np.asarray(a), dtype=torch.int32, device=device)
                t[k + "_l"] = torch.tensor(np.asarray(a), dtype=torch.long, device=device)
            self._dev[key] = t
        return t


# ---- plain versions -------------------------------------------------------------


def bt_factor_plain(data: torch.Tensor, tables: BandedTables):
    """K11's function: (P (B, K, 2s, s), boost (B,) int32, logdet (B,))."""
    t = tables.on(data.device)
    B, K, s = data.shape[0], tables.K, tables.s
    v = data if t["tperm_l"] is None else 0.5 * (data + data[:, t["tperm_l"]])
    src = t["src_l"]
    vals = torch.where(src >= 0, v[:, src.clamp_min(0)], 1.0)
    P = data.new_zeros(B, K * 2 * s * s)
    P[:, t["dst_l"]] = vals
    P = P.view(B, K, 2 * s, s)
    boost = torch.zeros(B, dtype=torch.int32, device=data.device)
    U = None
    for k in range(K):
        D = torch.tril(P[:, k, :s]) + torch.tril(P[:, k, :s], -1).mT
        if U is not None:
            D = D - U
        L, boosted = _chol_boosted(D)
        P[:, k, :s] = torch.tril(L)
        boost += boosted.to(torch.int32)
        if k < K - 1:
            M = torch.linalg.solve_triangular(L, P[:, k, s:].mT, upper=False).mT
            P[:, k, s:] = M
            U = M @ M.mT
    logdet = 2.0 * torch.log(torch.diagonal(P[:, :, :s], dim1=-2, dim2=-1)).sum((-2, -1))
    return P, boost, logdet


def bt_factor_tangent_plain(P: torch.Tensor, pre: torch.Tensor, dP: torch.Tensor):
    """K22's function: dP (B, K, 2s, s) holds Q̇'s blocks in P's layout (the
    lower triangle of Ḋ_k in rows 0..s, Ė_k in rows s..2s) and is
    overwritten with L̇_k and Ṁ_k; A_k = L_k⁻ᵀL_k⁻¹ in rows 0..s of pre's
    panels (lower). Block k takes Ḋ_k − U̇_{k-1} with
    U̇_{k-1} = Ṁ_{k-1}M_{k-1}ᵀ + M_{k-1}Ṁ_{k-1}ᵀ."""
    K, s = P.shape[1], P.shape[3]
    dU = None
    for k in range(K):
        dD = _sym(torch.tril(dP[:, k, :s]))
        if dU is not None:
            dD = dD - dU
        L, M = P[:, k, :s], P[:, k, s:]
        dL, dM, dU = panel_tangent_math(L, M, _sym(torch.tril(pre[:, k, :s])), dD, dP[:, k, s:])
        dP[:, k, :s] = dL
        dP[:, k, s:] = dM if k < K - 1 else 0.0
    return dP


def bt_factor_adjoint_plain(P: torch.Tensor, pre: torch.Tensor, G: torch.Tensor):
    """K24's function: G (B, K, 2s, s) holds the factor's cotangent in P's
    layout (L̄_k's lower triangle in rows 0..s, M̄_k in rows s..2s) and is
    overwritten with that of Q's blocks (Ā_k's lower entries, Ē_k), the last
    block first: block k's M̄_k takes −(Ā_{k+1} + Ā_{k+1}ᵀ)M_k from the
    block below (`panel_adjoint_math`). A_k = L_k⁻ᵀL_k⁻¹ in rows 0..s of pre's
    panels (lower)."""
    K, s = P.shape[1], P.shape[3]
    for k in reversed(range(K)):
        below = k < K - 1
        Sr = torch.tril(G[:, k + 1, :s]) if below else None
        gA, gE = panel_adjoint_math(torch.tril(P[:, k, :s]), P[:, k, s:], _sym(torch.tril(pre[:, k, :s])),
                                    G[:, k, :s], G[:, k, s:] if below else torch.zeros_like(P[:, k, s:]), Sr)
        G[:, k, :s] = gA
        G[:, k, s:] = gE if below else 0.0
    return G


def _rows_to_blocks(b: torch.Tensor, perm: torch.Tensor, B: int, K: int, s: int, k: int) -> torch.Tensor:
    """Rows b (B·k, n), chain-major, gathered through perm (block position →
    original index) and zero-padded into blocks (B, K, s, k): K12's first step."""
    n = b.shape[1]
    x = b.new_zeros(B, K * s, k)
    x[:, :n] = b.reshape(B, k, n)[:, :, perm].transpose(1, 2)
    return x.view(B, K, s, k)


def _blocks_to_rows(x: torch.Tensor, perm: torch.Tensor, n: int) -> torch.Tensor:
    """Blocks (B, K, s, k) back to rows (B·k, n) in the original numbering: K12's last step."""
    B, k = x.shape[0], x.shape[-1]
    out = x.new_empty(B, k, n)
    out[:, :, perm] = x.flatten(1, 2)[:, :n].transpose(1, 2)
    return out.view(B * k, n)


def _block_sweeps(P: torch.Tensor, b: torch.Tensor, mode: int) -> torch.Tensor:
    """Forward (L), backward (Lᵀ) or both block substitutions with the factor
    P (B, K, 2s, s) on blocks b (B, K, s, k)."""
    K, s = b.shape[1], b.shape[2]
    L, M = P[:, :, :s], P[:, :, s:]
    v = list(b.unbind(1))
    if mode != SOLVE_LT:
        for blk in range(K):
            rhs = v[blk] if blk == 0 else v[blk] - M[:, blk - 1] @ v[blk - 1]
            v[blk] = torch.linalg.solve_triangular(L[:, blk], rhs, upper=False)
    if mode != SOLVE_L:
        for blk in reversed(range(K)):
            rhs = v[blk] if blk == K - 1 else v[blk] - M[:, blk].mT @ v[blk + 1]
            v[blk] = torch.linalg.solve_triangular(L[:, blk].mT, rhs, upper=True)
    return torch.stack(v, 1)


def bt_trsv_plain(P: torch.Tensor, tables: BandedTables, b: torch.Tensor, k: int = 1, mode: int = SOLVE_BOTH):
    """K12's function on rows b (B·k, n)."""
    perm = tables.on(b.device)["perm_l"]
    x = _rows_to_blocks(b, perm, P.shape[0], tables.K, tables.s, k)
    return _blocks_to_rows(_block_sweeps(P, x, mode), perm, tables.n)


def bt_factor_blocks_plain(D: torch.Tensor, E: torch.Tensor):
    """`bt_factor_blocks`' function (``pbtridiag.py:53`` `_bt_chol`): (P (B, K, 2s, s),
    logdet (B,)); a block whose Cholesky breaks down is NaN, as
    ``jnp.linalg.cholesky`` gives it."""
    B, K, s = D.shape[0], D.shape[1], D.shape[-1]
    P = D.new_zeros(B, K, 2 * s, s)
    U = None
    for k in range(K):
        Dk = 0.5 * (D[:, k] + D[:, k].mT)
        if U is not None:
            Dk = Dk - U
        L, info = torch.linalg.cholesky_ex(Dk)
        L = torch.where((info == 0)[:, None, None], L, torch.nan)
        P[:, k, :s] = L
        if k < K - 1:
            M = torch.linalg.solve_triangular(L, E[:, k].mT, upper=False).mT
            P[:, k, s:] = M
            U = M @ M.mT
    logdet = 2.0 * torch.log(torch.diagonal(P[:, :, :s], dim1=-2, dim2=-1)).sum((-2, -1))
    return P, logdet


def bt_trsv_blocks_plain(P: torch.Tensor, b: torch.Tensor):
    """`bt_trsv_blocks`' function (``pbtridiag.py:76`` `_bt_solve_factored`) on
    blocks b (B, K, s, k)."""
    return _block_sweeps(P, b, SOLVE_BOTH)


def _permuted_blocks(x: torch.Tensor, perm: torch.Tensor, K: int, s: int) -> torch.Tensor:
    """Rows x (R, n) in the block order, zero-padded: (R, K, s)."""
    xp = x.new_zeros(x.shape[0], K * s)
    xp[:, : perm.shape[0]] = x[:, perm]
    return xp.view(x.shape[0], K, s)


def _unpermuted(y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    out = y.new_empty(y.shape[0], perm.shape[0])
    out[:, perm] = y.flatten(1)[:, : perm.shape[0]]
    return out


def bt_matvec_plain(D: torch.Tensor, E: torch.Tensor, perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K13's function, as ``banded.py:297-315``: three batched products and
    the index operations. D (K, s, s) with x (R, n), or (B, K, s, s) with
    x (B, n); perm (n,) maps block position j to the original index."""
    perm = perm.long()
    K, s = D.shape[-3], D.shape[-1]
    xb = _permuted_blocks(x, perm, K, s)
    mat = "kij" if D.ndim == 3 else "rkij"
    y = torch.einsum(f"{mat},rkj->rki", D, xb)
    if K > 1:
        y[:, 1:] += torch.einsum(f"{mat},rkj->rki", E, xb[:, :-1])
        y[:, :-1] += torch.einsum(f"{mat.replace('ij', 'ji')},rkj->rki", E, xb[:, 1:])
    return _unpermuted(y, perm)


def bt_sqrt_plain(P: torch.Tensor, tables: BandedTables, z: torch.Tensor, k: int = 1) -> torch.Tensor:
    """`bt_sqrt`'s function (``banded.py:272-280``) on rows z (B·k, n)."""
    perm = tables.on(z.device)["perm_l"]
    K, s = tables.K, tables.s
    Pr = P if k == 1 else P.repeat_interleave(k, 0)
    zb = _permuted_blocks(z, perm, K, s)
    y = torch.einsum("rkij,rkj->rki", torch.tril(Pr[:, :, :s]), zb)
    if K > 1:
        y[:, 1:] += torch.einsum("rkij,rkj->rki", Pr[:, :-1, s:], zb[:, :-1])
    return _unpermuted(y, perm)


def bt_sqrt_t_plain(P: torch.Tensor, tables: BandedTables, z: torch.Tensor, k: int = 1) -> torch.Tensor:
    """`bt_sqrt`'s transpose mode's function, y_k = L_kᵀz_k + M_kᵀz_{k+1}, on
    rows z (B·k, n)."""
    perm = tables.on(z.device)["perm_l"]
    K, s = tables.K, tables.s
    Pr = P if k == 1 else P.repeat_interleave(k, 0)
    zb = _permuted_blocks(z, perm, K, s)
    y = torch.einsum("rkji,rkj->rki", torch.tril(Pr[:, :, :s]), zb)
    if K > 1:
        y[:, :-1] += torch.einsum("rkji,rkj->rki", Pr[:, :-1, s:], zb[:, 1:])
    return _unpermuted(y, perm)


# ---- wrappers -------------------------------------------------------------------


def bt_factor(data: torch.Tensor, tables: BandedTables):
    """K11: (P (B, K, 2s, s), boost (B,) int32, logdet (B,)) of data (B, nnz)."""
    if data.ndim != 2:
        raise ValueError(f"bt_factor: data must be (B, nnz), got {tuple(data.shape)}")
    if not _on_cuda("bt_factor", data):
        return bt_factor_plain(data, tables)
    t = tables.on(data.device)
    B, K, s = data.shape[0], tables.K, tables.s
    P = data.new_empty(B, K, 2 * s, s)
    ws = data.new_empty(B, 2 * s, s)
    dom = data.new_empty(B)
    logdet = data.new_empty(B)
    boost = torch.empty(B, dtype=torch.int32, device=data.device)
    flags = torch.empty(4 * B, dtype=torch.int32, device=data.device)
    tperm = t["tperm"].data_ptr() if t["tperm"] is not None else None
    cs = _cluster(s, B, data.dtype)
    code = _fn("tg_bt_factor", data.dtype)(
        data.data_ptr(), data.shape[1], t["src"].data_ptr(), t["dst"].data_ptr(), tables.ntab, tperm,
        P.data_ptr(), K, s, ws.data_ptr(), dom.data_ptr(), boost.data_ptr(), logdet.data_ptr(),
        flags.data_ptr(), cs, B, _stream(data),
    )
    build.check(code, "bt_factor", f" at K={K} s={s} B={B} cluster={cs} {data.dtype}")
    bt_factor.launches += 1
    return P, boost, logdet


def bt_trsv(P: torch.Tensor, tables: BandedTables, b: torch.Tensor, k: int = 1, mode: int = SOLVE_BOTH):
    """K12: block substitution with the factor P (B, K, 2s, s) on rows
    b (B·k, n), chain-major. Not differentiable."""
    K, s, n = tables.K, tables.s, tables.n
    if P.shape[1:] != (K, 2 * s, s) or b.ndim != 2 or b.shape != (P.shape[0] * k, n):
        raise ValueError(f"bt_trsv: shapes P {tuple(P.shape)}, b {tuple(b.shape)}, k={k}")
    if mode not in (SOLVE_L, SOLVE_LT, SOLVE_BOTH):
        raise ValueError(f"bt_trsv: unknown mode {mode}")
    if torch.is_grad_enabled() and P.requires_grad:
        raise NotImplementedError("bt_trsv has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_trsv", P, b):
        return bt_trsv_plain(P, tables, b, k, mode)
    t = tables.on(b.device)
    B = P.shape[0]
    P, b = P.contiguous(), b.contiguous()
    out = torch.empty_like(b)
    work = P.new_empty(trsv_workspace(B, K, s, k))
    code = _fn("tg_bt_trsv", P.dtype)(
        P.data_ptr(), K, s, n, t["perm"].data_ptr(), b.data_ptr(), out.data_ptr(), k, mode, B,
        work.data_ptr(), _stream(P),
    )
    build.check(code, "bt_trsv", f" at B={B} K={K} s={s} k={k} mode={mode} {P.dtype}")
    bt_trsv.launches += 1
    return out


def trsv_workspace(B: int, K: int, s: int, k: int, permuted: bool = True) -> int:
    """Values of K12's workspace for B chains of K blocks of s and k
    right-hand sides: the right-hand sides in blocks (B, K, s, k) (with
    `permuted`, K12's own entry) and one block row of scratch (B·s·k)."""
    return (B * K * s * k if permuted else 0) + B * s * k


def bt_factor_blocks(D: torch.Tensor, E: torch.Tensor):
    """K11's block entry: (P (B, K, 2s, s), logdet (B,)) of the block-tridiagonal
    matrices with diagonal blocks D (B, K, s, s) and sub-diagonal blocks
    E (B, K-1, s, s) (E_k = A[k+1, k]). No pivot boost; not differentiable."""
    if D.ndim != 4 or E.ndim != 4 or D.shape[-1] != D.shape[-2] or E.shape != (D.shape[0], D.shape[1] - 1) + D.shape[2:]:
        raise ValueError(f"bt_factor_blocks: shapes D {tuple(D.shape)}, E {tuple(E.shape)}")
    if torch.is_grad_enabled() and (D.requires_grad or E.requires_grad):
        raise NotImplementedError("bt_factor_blocks has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_factor_blocks", D, E):
        return bt_factor_blocks_plain(D, E)
    B, K, s = D.shape[0], D.shape[1], D.shape[-1]
    D, E = D.contiguous(), E.contiguous()
    P = D.new_empty(B, K, 2 * s, s)
    logdet = D.new_empty(B)
    flags = torch.empty(B, dtype=torch.int32, device=D.device)
    cs = _cluster(s, B, D.dtype)
    code = _fn("tg_bt_factor_blocks", D.dtype)(
        D.data_ptr(), E.data_ptr() if K > 1 else None, P.data_ptr(), K, s, logdet.data_ptr(), flags.data_ptr(),
        cs, B, _stream(D),
    )
    build.check(code, "bt_factor_blocks", f" at B={B} K={K} s={s} cluster={cs} {D.dtype}")
    bt_factor_blocks.launches += 1
    return P, logdet


def bt_trsv_blocks(P: torch.Tensor, b: torch.Tensor):
    """K12's block entry: x = A⁻¹ b by forward and backward block substitution
    with the factor P (B, K, 2s, s) of `bt_factor_blocks`, on b (B, K, s, k),
    with no permutation. Not differentiable."""
    if P.ndim != 4 or b.ndim != 4 or P.shape[2] != 2 * P.shape[3] or b.shape[:3] != (P.shape[0], P.shape[1], P.shape[3]):
        raise ValueError(f"bt_trsv_blocks: shapes P {tuple(P.shape)}, b {tuple(b.shape)}")
    if torch.is_grad_enabled() and (P.requires_grad or b.requires_grad):
        raise NotImplementedError("bt_trsv_blocks has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_trsv_blocks", P, b):
        return bt_trsv_blocks_plain(P, b)
    B, K, s, k = b.shape
    P, b = P.contiguous(), b.contiguous()
    out = torch.empty_like(b)
    # one block row of scratch
    work = P.new_empty(trsv_workspace(B, K, s, k, permuted=False))
    code = _fn("tg_bt_trsv_blocks", P.dtype)(
        P.data_ptr(), K, s, b.data_ptr(), out.data_ptr(), k, B, work.data_ptr(), _stream(P),
    )
    build.check(code, "bt_trsv_blocks", f" at B={B} K={K} s={s} k={k} {P.dtype}")
    bt_trsv_blocks.launches += 1
    return out


def matvec_split(s: int, K: int, kk: int, B: int, element_size: int, upper: bool = True) -> dict:
    """How K13 splits a product of B chains' matrices of K blocks of s with
    kk vectors each: ``nv`` vectors per unit (1, 4 or 8) in ``chunks`` per
    chain; ``strips`` units of 64 rows per block row (padded to whole
    clusters); with the Eᵀ term (`upper` and K > 1), clusters of ``cluster``
    ≤ 8 units, whose column sums leave as ``parts`` partials per block row;
    ``cpl`` columns per thread and pass (2 in float32); ``threads`` per unit
    (256 or 192, whichever covers s in passes of ``threads``·``cpl``
    columns with fewer to spare; fewer for a narrow block); ``work`` values
    of workspace (x and y permuted, the partials)."""
    nv = 1 if kk <= 1 else 4 if kk <= 4 else 8
    chunks = -(-kk // nv)
    strips = -(-s // MV_ROWS)
    if upper and K > 1:
        parts = -(-strips // MV_CLUSTER)
        cluster = -(-strips // parts)
        strips = parts * cluster
    else:
        parts, cluster = 0, 1
    cpl = 2 if element_size == 4 else 1
    # the thread count whose passes waste the fewest columns; blocks narrower than one pass take 32 per warp
    threads = min(MV_THREADS, key=lambda t: -(-s // (t * cpl)) * t * cpl - s)
    threads = min(threads, 32 * -(-s // (32 * cpl)))
    rows = B * chunks * nv
    return {"nv": nv, "chunks": chunks, "strips": strips, "cluster": cluster, "parts": parts, "cpl": cpl,
            "threads": threads, "work": rows * (2 * K * s + max(K - 1, 0) * parts * s)}


def _launch_matvec(name, diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm, x, kk, B, lower, upper):
    """One K13 product; `diag` is a tensor, `sub` the address of sub-diagonal block 0 (or None)."""
    if perm.device != x.device or perm.dtype != torch.int32 or not perm.is_contiguous() or perm.shape != (n,):
        raise ValueError(f"{name}: perm must be contiguous int32 (n,) on the vectors' device")
    x = x.contiguous()
    y = torch.empty_like(x)
    sp = matvec_split(s, K, kk, B, x.element_size(), bool(upper))
    work = x.new_empty(sp["work"])
    code = _fn("tg_bt_matvec", x.dtype)(
        diag.data_ptr(), diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm.data_ptr(), x.data_ptr(), y.data_ptr(),
        kk, B, sp["nv"], sp["chunks"], sp["strips"], sp["cluster"], sp["parts"], sp["cpl"], sp["threads"], lower, upper,
        work.data_ptr(), _stream(x),
    )
    build.check(code, name, f" at B={B} K={K} s={s} rows={x.shape[0]} split={sp} {x.dtype}")
    return y


def bt_matvec(D: torch.Tensor, E: torch.Tensor, perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K13: y (R, n) = Q x for the symmetric block-tridiagonal Q given by
    D (K, s, s), E (K-1, s, s) (shared by the R rows of x) or D (B, K, s, s),
    E (B, K-1, s, s) with x (B, n); perm (n,) int32 maps block position j
    to the original index. Not differentiable."""
    if D.ndim not in (3, 4) or E.ndim != D.ndim or x.ndim != 2:
        raise ValueError(f"bt_matvec: shapes D {tuple(D.shape)}, E {tuple(E.shape)}, x {tuple(x.shape)}")
    K, s = D.shape[-3], D.shape[-1]
    n = perm.shape[0]
    batched = D.ndim == 4
    if D.shape[-2] != s or E.shape[-3:] != (max(K - 1, 0), s, s) or x.shape[1] != n or not K * s >= n > (K - 1) * s \
            or (batched and (D.shape[0] != x.shape[0] or E.shape[0] != x.shape[0])):
        raise ValueError(f"bt_matvec: shapes D {tuple(D.shape)}, E {tuple(E.shape)}, x {tuple(x.shape)}, n={n}")
    if torch.is_grad_enabled() and (D.requires_grad or E.requires_grad or x.requires_grad):
        raise NotImplementedError("bt_matvec has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_matvec", D, E, x):
        return bt_matvec_plain(D, E, perm, x)
    B, kk = (x.shape[0], 1) if batched else (1, x.shape[0])
    D, E = D.contiguous(), E.contiguous()
    y = _launch_matvec("bt_matvec", D, s * s, K * s * s if batched else 0, E.data_ptr() if K > 1 else None, s * s,
                       (K - 1) * s * s if batched else 0, K, s, n, perm, x, kk, B, 0, int(K > 1))
    bt_matvec.launches += 1
    return y


def bt_sqrt(P: torch.Tensor, tables: BandedTables, z: torch.Tensor, k: int = 1) -> torch.Tensor:
    """K13's second entry: y = L z with K11's factor P (B, K, 2s, s) on rows
    z (B·k, n), chain-major, in the original numbering (Lᵀ z is `bt_sqrt_t`).
    Not differentiable."""
    K, s, n = tables.K, tables.s, tables.n
    if P.shape[1:] != (K, 2 * s, s) or z.ndim != 2 or z.shape != (P.shape[0] * k, n):
        raise ValueError(f"bt_sqrt: shapes P {tuple(P.shape)}, z {tuple(z.shape)}, k={k}")
    if torch.is_grad_enabled() and P.requires_grad:
        raise NotImplementedError("bt_sqrt has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_sqrt", P, z):
        return bt_sqrt_plain(P, tables, z, k)
    P = P.contiguous()
    panel = 2 * s * s
    sub = P.data_ptr() + s * s * P.element_size()  # M_k: rows s..2s of panel k
    y = _launch_matvec("bt_sqrt", P, panel, K * panel, sub, panel, K * panel, K, s, n,
                       tables.on(z.device)["perm"], z, k, P.shape[0], 1, 0)
    bt_sqrt.launches += 1
    return y


def sqrt_t_rows(el: int) -> int:
    """Rows of a stage of bt_sqrt's transpose-mode ring (16 KB of 128 columns: 32 in float32, 16 in float64)."""
    return SQT_STAGE_BYTES // (SQT_COLS * el)


def sqrt_t_smem(nv: int, el: int, ws: int) -> int:
    """Shared memory bytes of a unit of bt_sqrt's transpose mode taking its
    rows in windows of ws ring stages (`sqrt_t_smem` in the source): a ring
    of 4 stages of 16 KB, a window's rows of z (ws × stage rows × nv), and
    the row groups' partials (RG × nv × 128, RG = 256 threads over 128
    columns by 16 bytes and nv by up to 8), which take the ring's place once
    it is spent."""
    rg = 256 // (SQT_COLS // (16 // el) * (nv // min(nv, 8)))
    ring, red = SQT_RING * SQT_STAGE_BYTES, el * rg * nv * SQT_COLS
    return max(ring, red) + el * ws * sqrt_t_rows(el) * nv


def sqrt_t_launch(s: int, k: int, el: int, fit) -> tuple:
    """(rows per slab R, slabs per cluster cs, right-hand sides per pass nv,
    ring stages per window ws) of bt_sqrt's transpose mode on blocks of s
    with k right-hand sides per chain and values of el bytes. A unit is R
    rows of a panel [L_k; M_k] (2s rows) by 128 columns; the ⌈2s/R⌉ slabs of
    a column tile are one cluster, which adds their partials. R is the
    smallest multiple of a ring stage's rows that keeps the cluster within 4
    blocks (the card holds few clusters of 8 or 16); nv is 1, 4, 8 or 16, all
    k ≤ 16 of a chain in one pass, so each block of P is read once, streamed
    through a ring of 4 stages (for k > 16 each pass of 16 streams it again).
    A unit gathers its rows of z a window at a time: the whole slab where its
    z takes at most 32 KB of shared memory (at k ≤ 16 every s up to 512 in
    float64, 1024 in float32), else windows of that size, so every s has a
    shape. ``fit(cs, ws, nv)``
    is how many such clusters the card holds at once."""
    nv = 1 if k <= 1 else 4 if k <= 4 else 8 if k <= 8 else 16
    rows = sqrt_t_rows(el)
    R = rows * -(-2 * s // (rows * SQT_CLUSTER))
    cs = -(-2 * s // R)
    ws = min(R // rows, SQT_WINDOW_BYTES // (el * rows * nv))
    if sqrt_t_smem(nv, el, ws) > SMEM_MAX or fit(cs, ws, nv) < 1:
        raise RuntimeError(f"bt_sqrt: the card holds no cluster of the transpose mode at s={s}, k={k}")
    return R, cs, nv, ws


def sqrt_t_slabs(s: int, K: int, R: int) -> list:
    """The rows that bt_sqrt's transpose mode reads, as the kernel decides
    (`slab_rows`): (block k, first column, slab's first row, first row read,
    rows read) of panel k's 2s rows (s in the last block, whose M is zero) by
    128 columns; a slab reads its rows from the tile's first column on (L_k's
    rows above it hold nothing for the tile), and a slab wholly above reads
    none and is left out."""
    out = []
    for k in range(K):
        rmax = 2 * s if k < K - 1 else s
        for j0 in range(0, s, SQT_COLS):
            for r0 in range(0, 2 * s, R):
                lo, hi = max(r0, j0), min(r0 + R, rmax)
                if hi > lo:
                    out.append((k, j0, r0, lo, hi - lo))
    return out


@functools.cache
def _sqrt_t_shape(s: int, k: int, dtype) -> tuple:
    """`sqrt_t_launch` on this card, worked out once per shape and type."""
    return sqrt_t_launch(s, k, torch.finfo(dtype).bits // 8, _fit("tg_bt_sqrt_t_fit", dtype, "bt_sqrt_t"))


def bt_sqrt_t(P: torch.Tensor, tables: BandedTables, z: torch.Tensor, k: int = 1) -> torch.Tensor:
    """bt_sqrt's transpose mode: y = Lᵀ z, y_k = L_kᵀz_k + M_kᵀz_{k+1}, with
    K11's factor P (B, K, 2s, s) on rows z (B·k, n), chain-major, in the
    original numbering, in one launch (`sqrt_t_launch`): each block of P read
    once for k ≤ 16, z gathered and y written through the permutation inside
    the kernel. Not differentiable."""
    K, s, n = tables.K, tables.s, tables.n
    if P.shape[1:] != (K, 2 * s, s) or z.ndim != 2 or z.shape != (P.shape[0] * k, n):
        raise ValueError(f"bt_sqrt_t: shapes P {tuple(P.shape)}, z {tuple(z.shape)}, k={k}")
    if not _on_cuda("bt_sqrt_t", P, z):
        return bt_sqrt_t_plain(P, tables, z, k)
    P, z = P.contiguous(), z.contiguous()
    y = torch.empty_like(z)
    B = P.shape[0]
    R, cs, nv, ws = _sqrt_t_shape(s, k, z.dtype)
    code = _fn("tg_bt_sqrt_t", z.dtype)(P.data_ptr(), K, s, n, R, ws, tables.on(z.device)["perm"].data_ptr(),
                                       z.data_ptr(), y.data_ptr(), k, B, nv, _stream(z))
    build.check(code, "bt_sqrt_t", f" at B={B} K={K} s={s} k={k} slabs of {R} rows, windows of {ws} stages, "
                f"cluster {cs} {z.dtype}")
    bt_sqrt_t.launches += 1
    return y


def bt_tangent_work(s: int) -> int:
    """float64 workspace values of K22 per chain: one panel's of K20 with W = M = s."""
    from .supernodal import tangent_work

    return tangent_work(s, s)


def bt_factor_tangent(P: torch.Tensor, pre: torch.Tensor, dP: torch.Tensor):
    """K22: L̇_k and Ṁ_k in place in dP (B, K, 2s, s), which holds Q̇'s blocks
    in P's layout, from P and A_k in pre (B, K, 2s, s; K8's first entry on
    the blocks). pre and dP may be views of (B, K·2s·s + 1) buffers."""
    if P.ndim != 4 or pre.shape != P.shape or dP.shape != P.shape:
        raise ValueError(f"bt_factor_tangent: P, pre and dP must be (B, K, 2s, s), got {tuple(P.shape)}, "
                         f"{tuple(pre.shape)}, {tuple(dP.shape)}")
    if any(t.device != P.device for t in (pre, dP)):
        raise ValueError("bt_factor_tangent: tensors on different devices")
    if not _on_cuda("bt_factor_tangent", P):
        return bt_factor_tangent_plain(P, pre, dP)
    B, K, s = P.shape[0], P.shape[1], P.shape[3]
    for t in (P, pre, dP):
        if t.device != P.device or t.dtype != P.dtype or t.stride()[1:] != (2 * s * s, s, 1):
            raise ValueError("bt_factor_tangent: P, pre and dP must be row-major blocks of one dtype and device")
    if pre.stride(0) != dP.stride(0) or not P.is_contiguous():
        raise ValueError("bt_factor_tangent: pre and dP must share a chain stride, P be contiguous")
    if B == 0:
        return dP
    work = torch.empty(B * bt_tangent_work(s), dtype=torch.float64, device=P.device)
    cs = tangent_cluster(s, s, B, _fit("tg_bt_factor_tangent_fit", P.dtype, "bt_factor_tangent"), _sm_count(P.device),
                         "bt_factor_tangent")
    code = _fn("tg_bt_factor_tangent", P.dtype)(P.data_ptr(), pre.data_ptr(), dP.data_ptr(), pre.stride(0), K, s,
                                               work.data_ptr(), B, cs, _stream(P))
    build.check(code, "bt_factor_tangent", f" at K={K} s={s} B={B} {P.dtype}, cluster={cs}")
    bt_factor_tangent.launches += 1
    return dP


def bt_factor_adjoint(P: torch.Tensor, pre: torch.Tensor, G: torch.Tensor):
    """K24: the cotangent of Q's blocks (Ā_k's lower entries, Ē_k) in place in
    G (B, K, 2s, s), which holds the factor's (L̄_k's lower triangle, M̄_k),
    from P and A_k in pre (B, K, 2s, s; K8's first entry on the blocks). pre
    and G may be views of (B, K·2s·s + 1) buffers."""
    if P.ndim != 4 or pre.shape != P.shape or G.shape != P.shape:
        raise ValueError(f"bt_factor_adjoint: P, pre and G must be (B, K, 2s, s), got {tuple(P.shape)}, "
                         f"{tuple(pre.shape)}, {tuple(G.shape)}")
    if any(t.device != P.device for t in (pre, G)):
        raise ValueError("bt_factor_adjoint: tensors on different devices")
    if not _on_cuda("bt_factor_adjoint", P):
        return bt_factor_adjoint_plain(P, pre, G)
    B, K, s = P.shape[0], P.shape[1], P.shape[3]
    for t in (P, pre, G):
        if t.dtype != P.dtype or t.stride()[1:] != (2 * s * s, s, 1):
            raise ValueError("bt_factor_adjoint: P, pre and G must be row-major blocks of one dtype")
    if pre.stride(0) != G.stride(0) or not P.is_contiguous():
        raise ValueError("bt_factor_adjoint: pre and G must share a chain stride, P be contiguous")
    if B == 0:
        return G
    work = torch.empty(B * bt_tangent_work(s), dtype=torch.float64, device=P.device)
    cs = tangent_cluster(s, s, B, _fit("tg_bt_factor_adjoint_fit", P.dtype, "bt_factor_adjoint"), _sm_count(P.device),
                         "bt_factor_adjoint")
    code = _fn("tg_bt_factor_adjoint", P.dtype)(P.data_ptr(), pre.data_ptr(), G.data_ptr(), pre.stride(0), K, s,
                                               work.data_ptr(), B, cs, _stream(P))
    build.check(code, "bt_factor_adjoint", f" at K={K} s={s} B={B} {P.dtype}, cluster={cs}")
    bt_factor_adjoint.launches += 1
    return G


bt_factor_adjoint.launches = 0
bt_factor_tangent.launches = 0
bt_factor.launches = 0
bt_trsv.launches = 0
bt_factor_blocks.launches = 0
bt_trsv_blocks.launches = 0
bt_matvec.launches = 0
bt_sqrt.launches = 0
bt_sqrt_t.launches = 0
