"""Wrappers of the block-tridiagonal kernels K11 `bt_factor` and K12
`bt_trsv` (``csrc/banded.cu``) and their plain versions.

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

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``<wrapper>.launches`` counts launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .supernodal import SMEM_MAX, _chol_boosted
from .tridiag import SOLVE_BOTH, SOLVE_L, SOLVE_LT, _fn, _on_cuda, _stream

__all__ = ["BandedTables", "bt_factor", "bt_factor_plain", "bt_trsv", "bt_trsv_plain"]


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


bt_factor.launches = 0
bt_trsv.launches = 0
