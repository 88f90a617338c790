"""Wrappers of the block-tridiagonal kernels K11 `bt_factor`, K12 `bt_trsv`
and K13 `bt_matvec` (with its second entry `bt_sqrt`) of ``csrc/banded.cu``,
and their plain versions.

The factor of B chains is one array P (B, K, 2s, s): panel k holds the
lower Cholesky factor L_k of the k-th diagonal block in rows 0..s and
M_k = E_k L_k⁻ᵀ in rows s..2s (zero in the last panel). K11 scatters Q's
data (B, nnz) into the panels through a `BandedTables` (the reference
plan's d_idx / e_idx), factors them with the reference's ``_chol_boosted``
per block and chain, and returns P, the boost count (B,) int32 and the
logdet (B,). K12 solves with P on rows (B·k, n), chain-major: mode 0
L y = b, mode 1 Lᵀ x = b, mode 2 both, in the original numbering (the RCM
permutation and padding are applied inside); the permuted vector is kept in
shared memory while npad entries fit in ``SMEM_MAX`` bytes, else in a
global workspace.

K13 multiplies by block-tridiagonal storage, one launch per product with
the RCM permutation of x and y fused in. `bt_matvec` takes the symmetric
matrix as D (K, s, s) (both triangles) and E (K-1, s, s), shared by all
rows of x (R, n), or one set per row ((B, K, s, s), (B, K-1, s, s) with
x (B, n)); `bt_sqrt` takes K11's factor P and computes
y_k = L_k z_k + M_{k-1} z_{k-1} on rows (B·k, n), chain-major. A block of
threads keeps 3·rc·s values of x in shared memory, rc ≤ 8 vectors at a
time (`matvec_chunk` picks rc so that they fit ``SMEM_MAX``).

K11 and K12 have a block entry each, for the SPIKE solve
(``parallel/pbtridiag.py``): `bt_factor_blocks` factors blocks D (B, K, s, s),
E (B, K-1, s, s) given as they are (D_k symmetrized, no pivot boost: a block
that is not positive definite gives a NaN logdet) into the same P, and
`bt_trsv_blocks` solves with it on blocks (B, K, s, k), with no permutation:
one block of threads per right-hand side while the B·k of them fit
`TILE_WAVES` waves of blocks on the card, else one per chain and tile of 64
right-hand sides.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build
from .supernodal import SMEM_MAX, _chol_boosted
from .tridiag import SOLVE_BOTH, SOLVE_L, SOLVE_LT, _fn, _on_cuda, _stream

__all__ = ["BandedTables", "bt_factor", "bt_factor_plain", "bt_trsv", "bt_trsv_plain",
           "bt_matvec", "bt_matvec_plain", "bt_sqrt", "bt_sqrt_plain", "matvec_chunk",
           "bt_factor_blocks", "bt_factor_blocks_plain", "bt_trsv_blocks", "bt_trsv_blocks_plain"]

MV_ROWS, MV_VECS, MV_WARPS = 64, 8, 8  # kMvRows, kMvVecs, kMvWarps of the source
# `bt_trsv_blocks` solves by tiles of 64 right-hand sides once the B·k of them
# would take more than this many waves of one block each: on the H100 at the
# SPIKE solve's shape (B=4, K=31, s=450, f64) a wave of single right-hand
# sides takes ~22 ms and a wave of tiles ~100 ms (chip_smoke.py phase 3f).
TILE_WAVES = 4


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


def bt_trsv_plain(P: torch.Tensor, tables: BandedTables, b: torch.Tensor, k: int = 1, mode: int = SOLVE_BOTH):
    """K12's function on rows b (B·k, n)."""
    t = tables.on(b.device)
    R, K, s, n = b.shape[0], tables.K, tables.s, tables.n
    Pr = P if k == 1 else P.repeat_interleave(k, 0)
    L, M = Pr[:, :, :s], Pr[:, :, s:]
    v = b.new_zeros(R, tables.npad)
    v[:, :n] = b[:, t["perm_l"]]
    v = v.view(R, K, s)
    if mode != SOLVE_LT:
        ys, prev = [], None
        for blk in range(K):
            rhs = v[:, blk] if prev is None else v[:, blk] - (M[:, blk - 1] @ prev[..., None])[..., 0]
            prev = torch.linalg.solve_triangular(L[:, blk], rhs[..., None], upper=False)[..., 0]
            ys.append(prev)
        v = torch.stack(ys, 1)
    if mode != SOLVE_L:
        xs, nxt = [None] * K, None
        for blk in reversed(range(K)):
            rhs = v[:, blk] if nxt is None else v[:, blk] - (M[:, blk].mT @ nxt[..., None])[..., 0]
            nxt = torch.linalg.solve_triangular(L[:, blk].mT, rhs[..., None], upper=True)[..., 0]
            xs[blk] = nxt
        v = torch.stack(xs, 1)
    out = b.new_empty(R, n)
    out[:, t["perm_l"]] = v.reshape(R, -1)[:, :n]
    return out


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
    K, s = b.shape[1], b.shape[2]
    L, M = P[:, :, :s], P[:, :, s:]
    v = list(b.unbind(1))
    for blk in range(K):
        rhs = v[blk] if blk == 0 else v[blk] - M[:, blk - 1] @ v[blk - 1]
        v[blk] = torch.linalg.solve_triangular(L[:, blk], rhs, upper=False)
    for blk in reversed(range(K)):
        rhs = v[blk] if blk == K - 1 else v[blk] - M[:, blk].mT @ v[blk + 1]
        v[blk] = torch.linalg.solve_triangular(L[:, blk].mT, rhs, upper=True)
    return torch.stack(v, 1)


def _permuted_blocks(x: torch.Tensor, perm: torch.Tensor, K: int, s: int) -> torch.Tensor:
    """Rows x (R, n) in the block order, zero-padded: (R, K, s)."""
    xp = x.new_zeros(x.shape[0], K * s)
    xp[:, : perm.shape[0]] = x[:, perm]
    return xp.view(x.shape[0], K, s)


def _unpermuted(y: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    out = y.new_empty(y.shape[0], perm.shape[0])
    out[:, perm] = y.reshape(y.shape[0], -1)[:, : perm.shape[0]]
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
    code = _fn("tg_bt_factor", data.dtype)(
        data.data_ptr(), data.shape[1], t["src"].data_ptr(), t["dst"].data_ptr(), tables.ntab, tperm,
        P.data_ptr(), K, s, ws.data_ptr(), dom.data_ptr(), boost.data_ptr(), logdet.data_ptr(),
        flags.data_ptr(), B, _stream(data),
    )
    build.check(code, "bt_factor", f" at K={K} s={s} B={B} {data.dtype}")
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
    if torch.is_grad_enabled() and (P.requires_grad or b.requires_grad):
        raise NotImplementedError("bt_trsv has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_trsv", P, b):
        return bt_trsv_plain(P, tables, b, k, mode)
    t = tables.on(b.device)
    out = torch.empty_like(b)
    # the permuted vector lives in shared memory, or in a workspace row when it does not fit
    work = P.new_empty(b.shape[0], tables.npad) if tables.npad * P.element_size() > SMEM_MAX else None
    code = _fn("tg_bt_trsv", P.dtype)(
        P.data_ptr(), K, s, n, t["perm"].data_ptr(), b.data_ptr(), out.data_ptr(), k, mode, b.shape[0],
        None if work is None else work.data_ptr(), _stream(P),
    )
    build.check(code, "bt_trsv", f" at K={K} s={s} rows={b.shape[0]} {P.dtype}")
    bt_trsv.launches += 1
    return out


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
    P = D.new_empty(B, K, 2 * s, s)
    logdet = D.new_empty(B)
    flags = torch.empty(B, dtype=torch.int32, device=D.device)
    code = _fn("tg_bt_factor_blocks", D.dtype)(
        D.data_ptr(), E.data_ptr() if K > 1 else None, P.data_ptr(), K, s, logdet.data_ptr(), flags.data_ptr(), B,
        _stream(D),
    )
    build.check(code, "bt_factor_blocks", f" at B={B} K={K} s={s} {D.dtype}")
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
    b = b.contiguous()
    out = torch.empty_like(b)
    tiles = B * k > TILE_WAVES * _sm_count(b.device)
    work = P.new_empty(B * k, K * s) if not tiles and K * s * P.element_size() > SMEM_MAX else None
    code = _fn("tg_bt_trsv_blocks", P.dtype)(
        P.data_ptr(), K, s, b.data_ptr(), out.data_ptr(), k, B, None if work is None else work.data_ptr(), int(tiles),
        _stream(P),
    )
    build.check(code, "bt_trsv_blocks", f" at B={B} K={K} s={s} k={k} {P.dtype}")
    bt_trsv_blocks.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def matvec_chunk(s: int, rows: int, element_size: int) -> int:
    """Vectors per block of K13: at most 8 and `rows`, fewer while the
    block's 3·rc·s values of x and (warps+1)·rc·64 partial sums exceed
    ``SMEM_MAX`` bytes; raises if not even one vector fits."""
    rc = max(1, min(MV_VECS, rows))
    while rc > 1 and element_size * rc * (3 * s + (MV_WARPS + 1) * MV_ROWS) > SMEM_MAX:
        rc -= 1
    if element_size * rc * (3 * s + (MV_WARPS + 1) * MV_ROWS) > SMEM_MAX:
        raise ValueError(f"bt_matvec: blocks of {s} rows do not fit a block's shared memory")
    return rc


def _launch_matvec(name, diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm, x, kk, B, lower, upper):
    """One K13 launch; `diag` is a tensor, `sub` the address of sub-diagonal block 0 (or None)."""
    if perm.device != x.device or perm.dtype != torch.int32 or not perm.is_contiguous() or perm.shape != (n,):
        raise ValueError(f"{name}: perm must be contiguous int32 (n,) on the vectors' device")
    y = torch.empty_like(x)
    rc = matvec_chunk(s, kk, x.element_size())
    code = _fn("tg_bt_matvec", x.dtype)(
        diag.data_ptr(), diag_k, diag_b, sub, sub_k, sub_b,
        K, s, n, perm.data_ptr(), x.data_ptr(), y.data_ptr(), kk, B, rc, lower, upper, _stream(x),
    )
    build.check(code, name, f" at K={K} s={s} rows={x.shape[0]} rc={rc} {x.dtype}")
    return y


def bt_matvec(D: torch.Tensor, E: torch.Tensor, perm: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K13: y (R, n) = Q x for the symmetric block-tridiagonal Q given by
    D (K, s, s), E (K-1, s, s) (shared by the R rows of x) or D (B, K, s, s),
    E (B, K-1, s, s) with x (B, n); perm (n,) int32 maps block position j
    to the original index. One launch; not differentiable."""
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
    y = _launch_matvec("bt_matvec", D, s * s, K * s * s if batched else 0, E.data_ptr() if K > 1 else None, s * s,
                       (K - 1) * s * s if batched else 0, K, s, n, perm, x, kk, B, 0, int(K > 1))
    bt_matvec.launches += 1
    return y


def bt_sqrt(P: torch.Tensor, tables: BandedTables, z: torch.Tensor, k: int = 1) -> torch.Tensor:
    """K13's second entry: y = L z with K11's factor P (B, K, 2s, s) on rows
    z (B·k, n), chain-major, in the original numbering. Not differentiable."""
    K, s, n = tables.K, tables.s, tables.n
    if P.shape[1:] != (K, 2 * s, s) or z.ndim != 2 or z.shape != (P.shape[0] * k, n):
        raise ValueError(f"bt_sqrt: shapes P {tuple(P.shape)}, z {tuple(z.shape)}, k={k}")
    if torch.is_grad_enabled() and (P.requires_grad or z.requires_grad):
        raise NotImplementedError("bt_sqrt has no backward; call it under torch.no_grad()")
    if not _on_cuda("bt_sqrt", P, z):
        return bt_sqrt_plain(P, tables, z, k)
    panel = 2 * s * s
    sub = P.data_ptr() + s * s * P.element_size()  # M_k: rows s..2s of panel k
    y = _launch_matvec("bt_sqrt", P, panel, K * panel, sub, panel, K * panel, K, s, n,
                       tables.on(z.device)["perm"], z, k, P.shape[0], 1, 0)
    bt_sqrt.launches += 1
    return y


bt_factor.launches = 0
bt_trsv.launches = 0
bt_factor_blocks.launches = 0
bt_trsv_blocks.launches = 0
bt_matvec.launches = 0
bt_sqrt.launches = 0
