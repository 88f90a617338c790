"""Wrappers of the supernodal kernels K6-K8 (``csrc/supernodal.cu``) and
their plain versions.

Each call runs one size-class batch of one level of the schedule, for all
chains: K6 `sn_panel` factors the panels, K7 `sn_trsv` does the forward or
backward block triangular solve (and, as `sn_multiply`, its mode MULTIPLY:
the product with the class batch's panels), K8 `sn_takahashi` the
Σ-dependent half of the block Takahashi step. K8's first entry
`sn_takahashi_prep` forms the Σ-free half, C = Lb·Ld⁻¹ and A = Ld⁻ᵀLd⁻¹,
into a buffer laid out like ``vals``; it runs once per sweep over every
supernode of a size class, whatever its level.
A class batch `c` is a dict of device tables for the P supernodes of this
level: ``panel`` (P, W+M, W), ``cols`` (P, W), ``rows`` (P, M) and
``schur`` (P, M, M), int32, padded with ``dummy`` (= nnzL) / ``ndummy``
(= n), plus ``W``, ``M`` and the offsets ``ubase`` / ``fbase`` of its slots
in the level's update buffers. A prep batch needs only ``panel`` and
``cols``.

A CPU tensor takes the plain version, which follows the reference's
batch-then-write-back semantics (``supernodal.py:775-1018``) with
``torch.linalg``; a CUDA tensor launches the kernel or raises. Both write
only live positions, so the DUMMY slot of ``vals``/``sig`` and the NDUMMY
slot of right-hand sides stay 0. ``<wrapper>.launches`` counts the kernels
a wrapper launched on the card (K8's entries launch one to three per call).
"""

from __future__ import annotations

import functools

import torch

from . import build
from .tridiag import _fn, _on_cuda, _stream

__all__ = [
    "sn_panel", "sn_trsv", "sn_multiply", "sn_takahashi_prep", "sn_takahashi",
    "sn_panel_plain", "sn_trsv_plain", "sn_multiply_plain", "sn_takahashi_prep_plain", "sn_takahashi_sweep_plain",
    "sn_takahashi_plain", "FORWARD", "BACKWARD", "MULTIPLY",
]

FORWARD, BACKWARD, MULTIPLY = 0, 1, 2
# Dynamic shared memory a block may take before the kernel falls back to a
# global-memory workspace (the H100 allows 227 KB per block; some room is
# left for the kernels' static shared arrays).
SMEM_MAX = 200 * 1024
TILE_MAX = 32  # widest column tile of K6's large-panel path (kTile in the source)
K8_TILE = 64  # K8's product tile (kT in csrc/tiles.cuh): K8's first entry takes a workspace beyond it
K8_CLUSTER_MAX = 8  # blocks per cluster of K8's one-launch form (the portable limit)


def _boost_delta(W: int) -> float:
    """First pivot boost of the reference, δ = 2e-6·W (``supernodal.py:807``)."""
    return 2e-6 * W


# ---- plain versions -----------------------------------------------------------


def _plain_tables(c: dict, device):
    """int64 copies and live masks of a class batch, cached on the batch dict."""
    key = ("_plain", str(device))
    t = c.get(key)
    if t is None:
        panel = c["panel"].long()
        live = (panel != c["dummy"]).flatten()
        cmask = c["cols"] != c["ndummy"]
        t = dict(
            panel=panel, live_at=torch.nonzero(live)[:, 0], live_pos=panel.flatten()[live],
            cols=c["cols"].long(), cmask=cmask,
            cmask_at=torch.nonzero(cmask.flatten())[:, 0], live_cols=c["cols"].long()[cmask],
            **{k: c[k].long() for k in ("rows", "schur") if k in c},  # a prep batch has neither
        )
        c[key] = t
    return t


def _gather(a, idx):
    """a[:, idx] for a (B, m) and an index tensor of any shape."""
    return a.index_select(1, idx.flatten()).reshape(a.shape[:1] + idx.shape)


def _write_live(a, t, newp):
    """Write the live positions of panels newp (B, P, W+M, W) into a (B, m)."""
    a[:, t["live_pos"]] = newp.reshape(a.shape[0], -1).index_select(1, t["live_at"])


def _panels(vals, t, W):
    """(Ld with unit padded diagonal, Lb) gathered per chain: (B, P, W, W), (B, P, M, W)."""
    panel = _gather(vals, t["panel"])
    pad = (~t["cmask"]).to(vals.dtype)
    return panel[..., :W, :] + torch.diag_embed(pad), panel[..., W:, :]


def _chol_boosted(D: torch.Tensor):
    """Batched Cholesky with the reference's escalating pivot boost
    (``supernodal.py:775-825``); returns (L, boosted mask over the batch)."""
    W = D.shape[-1]
    tiny = 30.0 * torch.finfo(D.dtype).eps

    def chol(A):
        L, info = torch.linalg.cholesky_ex(A)
        dg = torch.diagonal(L, dim1=-2, dim2=-1)
        return L, (info == 0) & (torch.isfinite(dg) & (dg > tiny)).all(-1)

    L0, ok0 = chol(D)
    if bool(ok0.all()):
        return L0, ~ok0
    eye = torch.eye(W, dtype=D.dtype, device=D.device)
    delta = _boost_delta(W)
    L1, ok1 = chol(D + delta * eye)
    dom = D.abs().sum(-1).amax(-1)
    L2, _ = chol(D + (dom + delta)[..., None, None] * eye)
    L = torch.where(ok0[..., None, None], L0, torch.where(ok1[..., None, None], L1, L2))
    return L, ~ok0


def sn_panel_plain(vals, c, u, logpiv, boost):
    """K6's function: factor the class batch `c` of every chain in place."""
    W, M = c["W"], c["M"]
    t = _plain_tables(c, vals.device)
    panel = _gather(vals, t["panel"])
    Dl, Bm = panel[..., :W, :], panel[..., W:, :]
    pad = (~t["cmask"]).to(vals.dtype)
    D = Dl + Dl.mT - torch.diag_embed(torch.diagonal(Dl, dim1=-2, dim2=-1)) + torch.diag_embed(pad)
    Ld, boosted = _chol_boosted(D)
    Lb = torch.linalg.solve_triangular(Ld, Bm.mT, upper=False).mT
    _write_live(vals, t, torch.cat([Ld * (1.0 - torch.diag_embed(pad)), Lb], -2))
    if M:
        P = t["panel"].shape[0]
        u[:, c["ubase"]: c["ubase"] + P * M * M] = (Lb @ Lb.mT).reshape(vals.shape[0], -1)
    logd = torch.log(torch.diagonal(Ld, dim1=-2, dim2=-1))
    logpiv[:, t["live_cols"]] = logd.reshape(vals.shape[0], -1).index_select(1, t["cmask_at"])
    boost += boosted.sum(-1).to(boost.dtype)


def sn_trsv_plain(vals, c, x, u, mode: int, k: int = 1):
    """K7's function: x (B·k, n+1) rows, chain-major; forward also fills u."""
    W = c["W"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    if k > 1:
        Ld, Lb = Ld.repeat_interleave(k, 0), Lb.repeat_interleave(k, 0)
    xc = _gather(x, t["cols"])
    if mode == FORWARD:
        yc = torch.linalg.solve_triangular(Ld, xc[..., None], upper=False)[..., 0]
        if c["M"]:
            P = t["cols"].shape[0]
            u[:, c["fbase"]: c["fbase"] + P * c["M"]] = (Lb @ yc[..., None])[..., 0].reshape(x.shape[0], -1)
    else:
        rhs = xc - (Lb.mT @ _gather(x, t["rows"])[..., None])[..., 0]
        yc = torch.linalg.solve_triangular(Ld.mT, rhs[..., None], upper=True)[..., 0]
    x[:, t["live_cols"]] = yc.reshape(x.shape[0], -1).index_select(1, t["cmask_at"])


def sn_multiply_plain(vals, c, out, z, u, k: int = 1):
    """K7's mode MULTIPLY (``supernodal.py:1296`` `sqrt_step`): out[cols] +=
    Ld·z[cols] without the padded columns' unit diagonal, u = Lb·z[cols];
    out, z (B·k, n+1) rows, chain-major."""
    W = c["W"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    Ld = Ld - torch.diag_embed((~t["cmask"]).to(vals.dtype))
    if k > 1:
        Ld, Lb = Ld.repeat_interleave(k, 0), Lb.repeat_interleave(k, 0)
    zc = _gather(z, t["cols"])[..., None]
    add = (Ld @ zc)[..., 0].reshape(out.shape[0], -1).index_select(1, t["cmask_at"])
    out[:, t["live_cols"]] += add
    if c["M"]:
        P = t["cols"].shape[0]
        u[:, c["fbase"]: c["fbase"] + P * c["M"]] = (Lb @ zc)[..., 0].reshape(out.shape[0], -1)


def sn_takahashi_prep_plain(vals, pre, c):
    """K8's first entry's function: C = Lb·Ld⁻¹ in Lb's positions and
    A = Ld⁻ᵀLd⁻¹ (lower) in Ld's positions of pre, for class batch `c`."""
    W = c["W"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    eye = torch.eye(W, dtype=vals.dtype, device=vals.device).expand_as(Ld)
    Ldinv = torch.linalg.solve_triangular(Ld, eye, upper=False)
    _write_live(pre, t, torch.cat([torch.tril(Ldinv.mT @ Ldinv), Lb @ Ldinv], -2))


def sn_takahashi_sweep_plain(pre, sig, c):
    """K8's function: Σ_RJ = −Σ_RR·C, Σ_JJ = A − Cᵀ·Σ_RJ on the panels of
    class batch `c`, C and A from pre (`sn_takahashi_prep_plain`)."""
    W = c["W"]
    t = _plain_tables(c, pre.device)
    panel = _gather(pre, t["panel"])
    A, C = torch.tril(panel[..., :W, :]), panel[..., W:, :]
    G = _gather(sig, t["schur"])
    Srr = G + G.mT - torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
    Srj = -Srr @ C
    _write_live(sig, t, torch.cat([torch.tril(A - C.mT @ Srj), Srj], -2))


def sn_takahashi_plain(vals, sig, c):
    """The whole Takahashi step on class batch `c` (``_sig_step``): the two
    halves above, through a buffer of its own."""
    pre = torch.zeros_like(sig)
    sn_takahashi_prep_plain(vals, pre, c)
    sn_takahashi_sweep_plain(pre, sig, c)


# ---- wrappers -------------------------------------------------------------------


def _check_class(name, c, vals, keys=("panel", "cols", "rows")):
    if vals.ndim != 2:
        raise ValueError(f"{name}: vals must be (B, nnzL+1), got {tuple(vals.shape)}")
    for key in keys:
        tab = c[key]
        if tab.device != vals.device or tab.dtype != torch.int32 or not tab.is_contiguous():
            raise ValueError(f"{name}: table {key} must be contiguous int32 on the values' device")


def sn_panel(vals, c, u, logpiv, boost):
    """K6: factor class batch `c` in place in vals (B, nnzL+1); U (lower) into
    u (B, ZU+1) at c["ubase"], log pivots into logpiv (B, >= n; column =
    the pivot's permuted index), boosted-block
    counts added to boost (B,) int32."""
    if not _on_cuda("sn_panel", vals, logpiv, *([u] if u is not None else [])):
        return sn_panel_plain(vals, c, u, logpiv, boost)
    _check_class("sn_panel", c, vals)
    if boost.dtype != torch.int32 or boost.device != vals.device:
        raise ValueError("sn_panel: boost must be int32 on the values' device")
    W, M = c["W"], c["M"]
    P, B = c["panel"].shape[0], vals.shape[0]
    # a panel that does not fit shared memory is factored in a global
    # workspace, column tile by column tile (the tile in shared memory)
    # (rows padded by one element in shared memory)
    work, tile = None, 0
    if vals.element_size() * (W + M) * (W + 1) > SMEM_MAX:
        work = vals.new_empty(B * P * (W + M) * W)
        tile = max(1, min(TILE_MAX, SMEM_MAX // (vals.element_size() * (W + M)) - 1))
    code = _fn("tg_sn_panel", vals.dtype)(
        vals.data_ptr(), vals.shape[1], c["panel"].data_ptr(), c["cols"].data_ptr(), P, W, M,
        c["dummy"], c["ndummy"], u.data_ptr() if u is not None else None,
        u.shape[1] if u is not None else 0, c["ubase"], logpiv.data_ptr(), logpiv.shape[1],
        boost.data_ptr(), work.data_ptr() if work is not None else None, tile, _boost_delta(W), B,
        _stream(vals),
    )
    build.check(code, "sn_panel", f" at W={W} M={M} P={P} B={B} {vals.dtype}, tile={tile}")
    sn_panel.launches += 1


def sn_trsv(vals, c, x, u, mode: int, k: int = 1):
    """K7: block triangular solve of class batch `c`, forward (L) or backward
    (Lᵀ), in place in x (B·k, n+1); forward writes Lb·y into u at c["fbase"]."""
    if mode not in (FORWARD, BACKWARD):
        raise ValueError(f"sn_trsv: unknown mode {mode}")
    if x.shape[0] != vals.shape[0] * k:
        raise ValueError("sn_trsv: x must hold k right-hand sides per chain")
    if not _on_cuda("sn_trsv", vals, x, *([u] if u is not None else [])):
        return sn_trsv_plain(vals, c, x, u, mode, k)
    _check_class("sn_trsv", c, vals)
    _launch_trsv("sn_trsv", vals, c, x, u, mode, k, None)
    sn_trsv.launches += 1


def _launch_trsv(name, vals, c, x, u, mode, k, z):
    W, M = c["W"], c["M"]
    P = c["panel"].shape[0]
    code = _fn("tg_sn_trsv", vals.dtype)(
        vals.data_ptr(), vals.shape[1], c["panel"].data_ptr(), c["cols"].data_ptr(),
        c["rows"].data_ptr(), P, W, M, c["ndummy"], x.data_ptr(), x.shape[1], k,
        u.data_ptr() if u is not None else None, u.shape[1] if u is not None else 0,
        c["fbase"], mode, x.shape[0], z.data_ptr() if z is not None else None, _stream(vals),
    )
    build.check(code, name, f" at W={W} M={M} P={P} rows={x.shape[0]} {vals.dtype}")


def sn_multiply(vals, c, out, z, u, k: int = 1):
    """K7, mode MULTIPLY: out[cols] += Ld·z[cols] and Lb·z[cols] into u at
    c["fbase"], for class batch `c`; out and z are (B·k, n+1) rows. The
    supernodes of a product do not depend on each other; the caller adds u
    into out through the level's forward ELL plans (K5)."""
    if out.shape != z.shape or out.shape[0] != vals.shape[0] * k:
        raise ValueError("sn_multiply: out and z must hold k rows of n+1 per chain")
    if not _on_cuda("sn_multiply", vals, out, z, *([u] if u is not None else [])):
        return sn_multiply_plain(vals, c, out, z, u, k)
    _check_class("sn_multiply", c, vals)
    _launch_trsv("sn_multiply", vals, c, out, u, MULTIPLY, k, z)
    sn_multiply.launches += 1


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tiles(n: int, t: int = K8_TILE) -> int:
    return -(-n // t)


def sweep_launch(W: int, M: int, units: int, sms: int) -> tuple:
    """(cluster size, t1, t2) of K8 on `units` (supernode, chain) pairs of
    panels W wide with M rows below, on a card of `sms` SMs. The products'
    tiles: t1 of Σ_RJ, t2 of Σ_JJ (64 rows by NT = 8 or 64 columns). A batch
    whose tiles fit a cluster of K8_CLUSTER_MAX, or that gives every SM two
    clusters' worth of blocks anyway, runs in one launch, a cluster per
    unit (cs, 0, 0); a batch of few units with more tiles (the top
    separators, the banded steps) runs its two products as two launches, a
    block per tile (0, t1, t2)."""
    nt = 8 if W <= 8 else K8_TILE
    t1 = _tiles(M) * _tiles(W, nt)
    t2 = sum(min(_tiles(W, nt), _tiles((i + 1) * K8_TILE, nt)) for i in range(_tiles(W)))
    tiles = max(t1, t2)
    if tiles <= K8_CLUSTER_MAX or units * K8_CLUSTER_MAX >= 2 * sms:
        return max(1, min(K8_CLUSTER_MAX, tiles, -(-2 * sms // max(units, 1)))), 0, 0
    return 0, t1, t2


def sn_takahashi_prep(vals, pre, c):
    """K8's first entry: C = Lb·Ld⁻¹ (Lb's positions) and A = Ld⁻ᵀLd⁻¹ (Ld's
    lower positions) of every supernode of batch `c` into pre (B, nnzL+1),
    which keeps vals' layout; positions outside the batch are not touched."""
    if not _on_cuda("sn_takahashi_prep", vals, pre):
        return sn_takahashi_prep_plain(vals, pre, c)
    _check_class("sn_takahashi_prep", c, vals, ("panel",))
    W, M = c["W"], c["M"]
    P, B = c["panel"].shape[0], vals.shape[0]
    work = None
    if W > K8_TILE:  # Ld⁻¹ and its inverted diagonal tiles, float64
        work = torch.empty(B * P * (W * W + _tiles(W) * K8_TILE**2), dtype=torch.float64, device=vals.device)
    code = _fn("tg_sn_takahashi_prep", vals.dtype)(
        vals.data_ptr(), vals.shape[1], pre.data_ptr(), pre.shape[1], c["panel"].data_ptr(), P, W, M, c["dummy"],
        None if work is None else work.data_ptr(), B, _stream(vals),
    )
    build.check(code, "sn_takahashi_prep", f" at W={W} M={M} P={P} B={B} {vals.dtype}")
    if P and B:  # the wide path is three launches: the diagonal tiles' inverses, Ld⁻¹, the products
        sn_takahashi_prep.launches += 1 if work is None else 3


def sn_takahashi(pre, sig, c):
    """K8: Σ_JJ (lower) and Σ_RJ of class batch `c` into sig (B, nnzL+1),
    from C and A in pre (`sn_takahashi_prep`) and Σ_RR of its ancestors in sig."""
    if not _on_cuda("sn_takahashi", pre, sig):
        return sn_takahashi_sweep_plain(pre, sig, c)
    _check_class("sn_takahashi", c, pre, ("panel", "schur"))
    W, M = c["W"], c["M"]
    P, B = c["panel"].shape[0], pre.shape[0]
    cs, t1, t2 = sweep_launch(W, M, P * B, _sm_count(pre.device))
    code = _fn("tg_sn_takahashi", pre.dtype)(
        pre.data_ptr(), pre.shape[1], sig.data_ptr(), sig.shape[1], c["panel"].data_ptr(), c["schur"].data_ptr(), P,
        W, M, c["dummy"], cs, t1, t2, B, _stream(pre),
    )
    build.check(code, "sn_takahashi", f" at W={W} M={M} P={P} B={B} {pre.dtype}, cluster={cs} tiles={t1},{t2}")
    if P and B:  # the two-launch form launches Σ_RJ's product only where rows lie below
        sn_takahashi.launches += 1 if cs else 1 + (t1 > 0)


sn_panel.launches = 0
sn_trsv.launches = 0
sn_multiply.launches = 0
sn_takahashi_prep.launches = 0
sn_takahashi.launches = 0
