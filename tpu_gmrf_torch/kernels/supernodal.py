"""Wrappers of the supernodal kernels K6-K8, K20 and K21
(``csrc/supernodal.cu``) and their plain versions.

Each call runs the size-class batches of one level of the schedule, for all
chains: K6 `sn_panel` factors the panels, K7 `sn_trsv` does the forward or
backward block triangular solve (and, as `sn_multiply`, its mode MULTIPLY:
the product with the panels), K8 `sn_takahashi` the Σ-dependent half of the
block Takahashi step (one class batch a call). K8's first entry
`sn_takahashi_prep` forms the Σ-free half, C = Lb·Ld⁻¹ and A = Ld⁻ᵀLd⁻¹,
into a buffer laid out like ``vals``; it runs once per sweep over every
supernode of a size class, whatever its level.
K20 `sn_panel_tangent` and K21 `sn_takahashi_tangent` are the tangents of
K6 and K8 (the selected inverse's derivative, Σ̇ = −Σ·Q̇·Σ): K20 gives a
class batch's factor tangent L̇ from the panel's accumulated Q̇ and U̇ for
the Schur ELL (K5), K21 the batch's Σ̇ from L̇ and its ancestors' Σ and Σ̇;
one launch per class batch each, a thread-block cluster per (supernode,
chain) (`banded.tangent_cluster`: one block where the batch fills the card,
up to 16 for the few wide panels), every product in float64 on a workspace
(`tangent_work`) on the float64 tensor cores. Both read Ld⁻¹ as
Ldᵀ·A with A = Ld⁻ᵀLd⁻¹ from K8's first entry.
K25 `sn_panel_adjoint` is the adjoint of K6 (the derivative of a sample, a
triangular solve or L·z): from the factor's cotangent on vals' layout it
gives the cotangent of a class batch's panel inputs in place, reading the
ancestors' through the Schur table; the solver runs it level by level,
descending, in K20's design. `sn_multiply(..., transpose=True)` is K7's mode
3, the product with Lᵀ: x[cols] = Ldᵀ·z[cols] + Lbᵀ·z[rows].
A class batch `c` is a dict of device tables for the P supernodes of this
level: ``panel`` (P, W+M, W), ``cols`` (P, W), ``rows`` (P, M) and
``schur`` (P, M, M), int32, padded with ``dummy`` (= nnzL) / ``ndummy``
(= n), plus ``W``, ``M`` and the offsets ``ubase`` / ``fbase`` of its slots
in the level's update buffers. A prep batch needs only ``panel`` and
``cols``. K6 and K7 take a level's group, ``{"classes": [c, ...]}``, one
batch or several: the batches of one level do not depend on each other, so
K7 runs them in one launch and K6 in one launch per path.

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
    "sn_panel_tangent", "sn_panel_tangent_plain", "sn_takahashi_tangent", "sn_takahashi_tangent_plain",
    "sn_panel_adjoint", "sn_panel_adjoint_plain", "panel_adjoint_math", "MULTIPLY_T",
]

FORWARD, BACKWARD, MULTIPLY, MULTIPLY_T = 0, 1, 2, 3
K8_TILE = 64  # the products' row tile (kT in csrc/tiles.cuh): K6's one-block path and K8's first entry stop at it
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


def sn_panel_plain(vals, group, u, logpiv, boost):
    """K6's function: factor the class batches of `group` of every chain in place."""
    for c in group["classes"]:
        _panel_plain(vals, c, u, logpiv, boost)


def _panel_plain(vals, c, u, logpiv, boost):
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


def sn_trsv_plain(vals, group, x, u, mode: int, k: int = 1):
    """K7's function on the class batches of `group`: x (B·k, n+1) rows, chain-major; forward also fills u."""
    for c in group["classes"]:
        _trsv_plain(vals, c, x, u, mode, k)


def _trsv_plain(vals, c, x, u, mode, k):
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


def sn_multiply_plain(vals, group, out, z, u, k: int = 1, transpose: bool = False):
    """K7's mode MULTIPLY (``supernodal.py:1296`` `sqrt_step`) on the class
    batches of `group`: out[cols] += Ld·z[cols] without the padded columns'
    unit diagonal, u = Lb·z[cols]; out, z (B·k, n+1) rows, chain-major. With
    `transpose` (mode MULTIPLY_T): out[cols] = Ldᵀ·z[cols] + Lbᵀ·z[rows]."""
    for c in group["classes"]:
        if transpose:
            _multiply_t_plain(vals, c, out, z, k)
        else:
            _multiply_plain(vals, c, out, z, u, k)


def _multiply_plain(vals, c, out, z, u, k):
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


def _multiply_t_plain(vals, c, out, z, k):
    W = c["W"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    Ld = Ld - torch.diag_embed((~t["cmask"]).to(vals.dtype))
    if k > 1:
        Ld, Lb = Ld.repeat_interleave(k, 0), Lb.repeat_interleave(k, 0)
    y = (Ld.mT @ _gather(z, t["cols"])[..., None])[..., 0]
    if c["M"]:
        y = y + (Lb.mT @ _gather(z, t["rows"])[..., None])[..., 0]
    out[:, t["live_cols"]] = y.reshape(out.shape[0], -1).index_select(1, t["cmask_at"])


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


def _sym(G):
    """The symmetric matrix whose lower triangle G holds (its upper is zero)."""
    return G + G.mT - torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))


def panel_tangent_math(Ld, Lb, A, dAjj, dArj):
    """The tangent of one panel's Cholesky (batched): from Ld, Lb, A =
    Ld⁻ᵀLd⁻¹ and the panel's symmetric Q̇ (Ȧ_JJ, Ȧ_RJ), with Ld⁻¹ the lower
    triangle of Ldᵀ·A and F = Φ(Ld⁻¹ Ȧ_JJ Ld⁻ᵀ) (lower, half diagonal):
    L̇d = Ld·F, L̇b = Ȧ_RJ·Ld⁻ᵀ − Lb·Fᵀ, and the Schur tangent
    U̇ = L̇b·Lbᵀ + Lb·L̇bᵀ."""
    Linv = torch.tril(Ld.mT @ A)
    G = Linv @ dAjj @ Linv.mT
    F = torch.tril(G) - 0.5 * torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
    dLb = dArj @ Linv.mT - Lb @ F.mT
    return Ld @ F, dLb, dLb @ Lb.mT + Lb @ dLb.mT


def panel_adjoint_math(Ld, Lb, A, gLd, gLb, Sr=None):
    """The adjoint of one panel's Cholesky (batched), the reverse of
    Ld = chol(A_JJ), Lb = A_RJ·Ld⁻ᵀ, U = Lb·Lbᵀ: from the cotangents of Ld
    (its lower triangle), Lb and, in Sr, of the lower entries U is
    subtracted from (lower; None without rows below), those of A_JJ's lower
    entries and of A_RJ: L̄b' = L̄b − (Sr + Srᵀ)·Lb, Ā_RJ = L̄b'·Ld⁻¹,
    L̄d' = tril(L̄d − Ā_RJᵀ·Lb), X = Φ(Ldᵀ·L̄d'), Ā_JJ = tril(Ld⁻ᵀ(X + Xᵀ)Ld⁻¹)
    with its diagonal halved; Ld⁻¹ the lower triangle of Ldᵀ·A."""
    Linv = torch.tril(Ld.mT @ A)
    if Sr is not None:
        gLb = gLb - (Sr + Sr.mT) @ Lb
    gArj = gLb @ Linv
    gLd = torch.tril(gLd - gArj.mT @ Lb)
    X = torch.tril(Ld.mT @ gLd)
    G = Linv.mT @ (X + X.mT - torch.diag_embed(torch.diagonal(X, dim1=-2, dim2=-1))) @ Linv
    return torch.tril(G) - 0.5 * torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1)), gArj


def takahashi_tangent_math(Ld, A, C, dLd, dLb, Srr, dSrr, Srj):
    """The tangent of one Takahashi step (batched): Ċ = (L̇b − C·L̇d)·Ld⁻¹,
    Ȧ = −Ld⁻ᵀ(Y + Yᵀ)Ld⁻¹ with Y = Ld⁻¹L̇d, Σ̇_RJ = −Σ̇_RR·C − Σ_RR·Ċ,
    Σ̇_JJ = Ȧ − Ċᵀ·Σ_RJ − Cᵀ·Σ̇_RJ; Ld⁻¹ the lower triangle of Ldᵀ·A."""
    Linv = torch.tril(Ld.mT @ A)
    Y = Linv @ dLd
    dA = -(Linv.mT @ (Y + Y.mT) @ Linv)
    dC = (dLb - C @ dLd) @ Linv
    dSrj = -(dSrr @ C + Srr @ dC)
    return dA - dC.mT @ Srj - C.mT @ dSrj, dSrj


def sn_panel_tangent_plain(vals, pre, dvals, c, du):
    """K20's function on class batch `c`: dvals holds the panels'
    accumulated Q̇ (lower, vals' layout), overwritten with L̇; U̇ (M × M) into
    du at the batch's ubase."""
    W, M = c["W"], c["M"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    A = _sym(_gather(pre, t["panel"])[..., :W, :])
    dp = _gather(dvals, t["panel"])
    dLd, dLb, dU = panel_tangent_math(Ld, Lb, A, _sym(dp[..., :W, :]), dp[..., W:, :])
    _write_live(dvals, t, torch.cat([dLd, dLb], -2))
    if M:
        P = t["panel"].shape[0]
        du[:, c["ubase"]: c["ubase"] + P * M * M] = dU.reshape(vals.shape[0], -1)


def sn_panel_adjoint_plain(vals, pre, gvals, c):
    """K25's function on class batch `c`: gvals holds the factor's cotangent
    on vals' layout, its batch panels overwritten with the cotangent of their
    inputs (`panel_adjoint_math`), the ancestors' read through the Schur table."""
    W, M = c["W"], c["M"]
    t = _plain_tables(c, vals.device)
    Ld, Lb = _panels(vals, t, W)
    A = _sym(_gather(pre, t["panel"])[..., :W, :])
    gp = _gather(gvals, t["panel"])
    gAjj, gArj = panel_adjoint_math(Ld, Lb, A, gp[..., :W, :], gp[..., W:, :], _gather(gvals, t["schur"]) if M else None)
    _write_live(gvals, t, torch.cat([gAjj, gArj], -2))


def sn_takahashi_tangent_plain(vals, pre, dvals, sig, dsig, c):
    """K21's function on class batch `c`: Σ̇_JJ (lower) and Σ̇_RJ into dsig,
    from L (vals), C and A (pre), L̇ (dvals), Σ (sig) and its ancestors' Σ̇
    (dsig)."""
    W = c["W"]
    t = _plain_tables(c, vals.device)
    Ld, _ = _panels(vals, t, W)
    pp = _gather(pre, t["panel"])
    dp = _gather(dvals, t["panel"])
    Srj = _gather(sig, t["panel"])[..., W:, :]
    dSjj, dSrj = takahashi_tangent_math(Ld, _sym(pp[..., :W, :]), pp[..., W:, :], torch.tril(dp[..., :W, :]),
                                        dp[..., W:, :], _sym(_gather(sig, t["schur"])),
                                        _sym(_gather(dsig, t["schur"])), Srj)
    _write_live(dsig, t, torch.cat([torch.tril(dSjj), dSrj], -2))


# ---- wrappers -------------------------------------------------------------------


def _check_class(name, c, vals, keys=("panel", "cols", "rows")):
    if vals.ndim != 2:
        raise ValueError(f"{name}: vals must be (B, nnzL+1), got {tuple(vals.shape)}")
    for key in keys:
        tab = c[key]
        if tab.device != vals.device or tab.dtype != torch.int32 or not tab.is_contiguous():
            raise ValueError(f"{name}: table {key} must be contiguous int32 on the values' device")


def _descriptors(batches, device, slices=None) -> torch.Tensor:
    """The launch's batch table on the card, int64 (len(batches), 10), the
    fields of ``Batch`` in csrc/supernodal.cu: the panel, cols and rows
    tables' addresses, W, M, P, the batch's first block (its supernodes'
    running count), ubase, fbase, and the offset of its slice of K6's
    workspace (`slices`: its workspace values per supernode, all chains)."""
    rows, first, work = [], 0, 0
    for i, c in enumerate(batches):
        P = c["panel"].shape[0]
        rows.append([c["panel"].data_ptr(), c["cols"].data_ptr(), c["rows"].data_ptr(), c["W"], c["M"], P, first,
                     c["ubase"], c["fbase"], work])
        first += P
        work += P * slices[i] if slices else 0
    return torch.tensor(rows, dtype=torch.int64, device=device)


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tiles(n: int, t: int = K8_TILE) -> int:
    return -(-n // t)


def panel_launch(W: int, M: int, units: int, fit, sms: int) -> int:
    """K6's cluster size on `units` (supernode, chain) pairs of panels W wide
    with M rows below, on a card of `sms` SMs; 0 for the one-block path. A
    panel W <= 64 takes one block when the batch fills the card or has at
    most 64 rows below; the rest (the top separators, and the few narrow
    panels with many rows below) take a cluster each, sized by K9's and
    K11's rule (`banded.factor_cluster`) for the panel's W + M rows.
    ``fit(cs)`` is how many clusters of cs blocks the card holds at once."""
    from .banded import factor_cluster  # banded.py imports this module

    if W <= K8_TILE and (units >= sms or M <= K8_TILE):
        return 0
    return factor_cluster(_tiles(W) * K8_TILE + M, units, fit, "sn_panel")


def trsv_launch(W: int, k: int, units: int, sms: int) -> tuple:
    """(column tile, blocks per supernode and chain) of K7 on k right-hand
    sides per chain of `units` (supernode, chain) pairs of panels at most W
    wide, on a card of `sms` SMs. A block solves up to 8 of a chain's
    right-hand sides, or up to 64 where at least 64 share a panel whose
    values then fit shared memory (W <= 128) and 8-column blocks would put
    8 or more on every SM: there the 64-column tile reads the panel an
    eighth as often and wins; with fewer blocks the launch is bound by its
    longest block, and 8 columns finish it sooner (each level timed both
    ways, tools/trace_vg.py k7tiles). A chain's panel is read once per
    block: once for k <= 8, else ceil(k / 8) or ceil(k / 64) times."""
    nt = 64 if k >= K8_TILE and W <= 2 * K8_TILE and units * -(-k // 8) >= 8 * sms else 8
    return nt, -(-k // nt)


def _panel_slice(W: int, M: int) -> int:
    """Values of K6's cluster-path workspace per (supernode, chain), in the factor's type (`panel_slice` in the
    source)."""
    Wq = _tiles(W) * K8_TILE
    return (Wq + M) * Wq + _tiles(W) * K8_TILE**2


def _panel_launches(group, vals) -> list:
    """K6's launches on `group` at vals' device, type and chain count,
    worked out once and kept on `group`: the one-block path's
    batches in one launch, the cluster path's in another, each a dict of its
    batch table, supernodes, widest W, cluster size (0: one block) and
    workspace (values of the factor's type, then the flags)."""
    B = vals.shape[0]
    key = ("_panel", str(vals.device), vals.dtype, B)
    got = group.get(key)
    if got is None:
        batches = group["classes"]
        for cc in batches:
            _check_class("sn_panel", cc, vals)
        from .banded import _fit  # banded.py imports this module

        fit, sms = _fit("tg_sn_panel_fit", vals.dtype, "sn_panel"), _sm_count(vals.device)
        path = [panel_launch(cc["W"], cc["M"], cc["panel"].shape[0] * B, fit, sms) for cc in batches]
        got = []
        for cluster in (False, True):
            part = [cc for cc, cs in zip(batches, path) if (cs > 0) == cluster]
            if not part:
                continue
            units = sum(cc["panel"].shape[0] for cc in part)
            slices = [B * _panel_slice(cc["W"], cc["M"]) for cc in part] if cluster else None
            work = sum(cc["panel"].shape[0] * sl for cc, sl in zip(part, slices)) if cluster else 0
            got.append(dict(desc=_descriptors(part, vals.device, slices), ng=len(part), units=units,
                            cs=max(path) if cluster else 0,  # a launch has one cluster size: its batches' largest
                            Wmax=max(cc["W"] for cc in part), work=work, flags=3 * B * units if cluster else 0))
        group[key] = got
    return got


def sn_panel(vals, group, u, logpiv, boost):
    """K6: factor the class batches of `group` in place in vals (B, nnzL+1); U
    (lower) into u (B, ZU+1) at each batch's ubase, log pivots into logpiv
    (B, >= n; column = the pivot's permuted index), boosted-block counts
    added to boost (B,) int32."""
    if not _on_cuda("sn_panel", vals, logpiv, *([u] if u is not None else [])):
        return sn_panel_plain(vals, group, u, logpiv, boost)
    if vals.ndim != 2:
        raise ValueError(f"sn_panel: vals must be (B, nnzL+1), got {tuple(vals.shape)}")
    if boost.dtype != torch.int32 or boost.device != vals.device:
        raise ValueError("sn_panel: boost must be int32 on the values' device")
    B = vals.shape[0]
    for ln in _panel_launches(group, vals):
        work, el = None, vals.element_size()
        if ln["cs"]:  # the cluster path's panels and inverted diagonal tiles, then its int32 flags
            work = vals.new_empty(ln["work"] + -(-4 * ln["flags"] // el))
        code = _fn("tg_sn_panel", vals.dtype)(
            vals.data_ptr(), vals.shape[1], ln["desc"].data_ptr(), ln["ng"], ln["units"], ln["Wmax"],
            group["classes"][0]["dummy"], u.data_ptr() if u is not None else None, u.shape[1] if u is not None else 0,
            logpiv.data_ptr(), logpiv.shape[1], boost.data_ptr(), None if work is None else work.data_ptr(),
            None if work is None else work.data_ptr() + el * ln["work"], ln["cs"], B, _stream(vals),
        )
        build.check(code, "sn_panel", f" at {_shapes(group)} B={B} {vals.dtype}, cluster={ln['cs']}")
        sn_panel.launches += 1


def _shapes(group) -> str:
    return ", ".join(f"W={c['W']} M={c['M']} P={c['panel'].shape[0]}" for c in group["classes"])


def sn_trsv(vals, group, x, u, mode: int, k: int = 1):
    """K7: block triangular solve of the class batches of `group`, forward (L)
    or backward (Lᵀ), in place in x (B·k, n+1); forward writes Lb·y into u at
    each batch's fbase."""
    if mode not in (FORWARD, BACKWARD):
        raise ValueError(f"sn_trsv: unknown mode {mode}")
    if x.shape[0] != vals.shape[0] * k:
        raise ValueError("sn_trsv: x must hold k right-hand sides per chain")
    if not _on_cuda("sn_trsv", vals, x, *([u] if u is not None else [])):
        return sn_trsv_plain(vals, group, x, u, mode, k)
    _launch_trsv("sn_trsv", vals, group, x, u, mode, k, None)
    sn_trsv.launches += 1


def _launch_trsv(name, vals, group, x, u, mode, k, z):
    """K7's one launch on `group` (its batch table built once and kept on `group`)."""
    if vals.ndim != 2:
        raise ValueError(f"{name}: vals must be (B, nnzL+1), got {tuple(vals.shape)}")
    key = ("_trsv", str(vals.device))
    ln = group.get(key)
    if ln is None:
        batches = group["classes"]
        for cc in batches:
            _check_class(name, cc, vals)
        ln = group[key] = dict(desc=_descriptors(batches, vals.device), ng=len(batches),
                           units=sum(cc["panel"].shape[0] for cc in batches), Wmax=max(cc["W"] for cc in batches),
                           dummy=batches[0]["dummy"])
    nt, _ = trsv_launch(ln["Wmax"], k, ln["units"] * vals.shape[0], _sm_count(vals.device))
    code = _fn("tg_sn_trsv", vals.dtype)(
        vals.data_ptr(), vals.shape[1], ln["desc"].data_ptr(), ln["ng"], ln["units"], ln["Wmax"], ln["dummy"],
        x.data_ptr(), x.shape[1], k, u.data_ptr() if u is not None else None, u.shape[1] if u is not None else 0,
        mode, vals.shape[0], z.data_ptr() if z is not None else None, nt, _stream(vals),
    )
    build.check(code, name, f" at {_shapes(group)} rows={x.shape[0]} {vals.dtype}")


def sn_multiply(vals, group, out, z, u, k: int = 1, transpose: bool = False):
    """K7, mode MULTIPLY: out[cols] += Ld·z[cols] and Lb·z[cols] into u at
    each batch's fbase, for the class batches of `group`; out and z are (B·k,
    n+1) rows. The supernodes of a product do not depend on each other; the
    caller adds u into out through the level's forward ELL plans (K5). With
    `transpose`, mode MULTIPLY_T: out[cols] = Ldᵀ·z[cols] + Lbᵀ·z[rows] (u
    unused), each supernode writing only its own columns."""
    if out.shape != z.shape or out.shape[0] != vals.shape[0] * k:
        raise ValueError("sn_multiply: out and z must hold k rows of n+1 per chain")
    if not _on_cuda("sn_multiply", vals, out, z, *([u] if u is not None else [])):
        return sn_multiply_plain(vals, group, out, z, u, k, transpose)
    _launch_trsv("sn_multiply", vals, group, out, None if transpose else u, MULTIPLY_T if transpose else MULTIPLY,
                 k, z)
    sn_multiply.launches += 1


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


def tangent_work(W: int, M: int) -> int:
    """float64 workspace values of K20 and K21 per (supernode, chain): eight
    W × W, six M × W and two M × M matrices (`tgt::tangent_slice` in the source)."""
    return 8 * W * W + 6 * M * W + 2 * M * M


def _tangent_work(c, vals):
    P, B = c["panel"].shape[0], vals.shape[0]
    return torch.empty(P * B * tangent_work(c["W"], c["M"]), dtype=torch.float64, device=vals.device)


def sn_panel_tangent(vals, pre, dvals, c, du):
    """K20: the factor tangent L̇ of class batch `c` in place in dvals (B,
    nnzL+1), which holds the panels' accumulated Q̇ on vals' layout (lower),
    and U̇ = L̇b·Lbᵀ + Lb·L̇bᵀ (M × M per supernode) into du (B, ZU+1) at the
    batch's ubase; L from vals, A = Ld⁻ᵀLd⁻¹ from pre (K8's first entry).
    pre and dvals may be one value wider than vals (the banded blocks)."""
    if not _on_cuda("sn_panel_tangent", vals, pre, dvals, *([du] if du is not None else [])):
        return sn_panel_tangent_plain(vals, pre, dvals, c, du)
    _check_class("sn_panel_tangent", c, vals, ("panel",))
    if dvals.shape != pre.shape or (c["M"] and du is None):
        raise ValueError("sn_panel_tangent: pre and dvals must have one shape, and rows below need du")
    W, M, P, B = c["W"], c["M"], c["panel"].shape[0], vals.shape[0]
    if not (P and B):
        return
    from .banded import _fit, tangent_cluster  # banded.py imports this module

    cs = tangent_cluster(W, M, P * B, _fit("tg_sn_tangent_fit", vals.dtype, "sn_panel_tangent", (0,)),
                         _sm_count(vals.device), "sn_panel_tangent")
    code = _fn("tg_sn_panel_tangent", vals.dtype)(
        vals.data_ptr(), vals.shape[1], pre.data_ptr(), dvals.data_ptr(), pre.shape[1],
        None if du is None else du.data_ptr(), 0 if du is None else du.shape[1], c["ubase"], c["panel"].data_ptr(),
        P, W, M, c["dummy"], _tangent_work(c, vals).data_ptr(), B, cs, _stream(vals))
    build.check(code, "sn_panel_tangent", f" at W={W} M={M} P={P} B={B} {vals.dtype}, cluster={cs}")
    sn_panel_tangent.launches += 1


def sn_takahashi_tangent(vals, pre, dvals, sig, dsig, c):
    """K21: Σ̇_JJ (lower) and Σ̇_RJ of class batch `c` into dsig (B, nnzL+1),
    from L (vals), C and A (pre), L̇ (dvals, `sn_panel_tangent`), Σ (sig,
    K8) and the ancestors' Σ̇ in dsig."""
    if not _on_cuda("sn_takahashi_tangent", vals, pre, dvals, sig, dsig):
        return sn_takahashi_tangent_plain(vals, pre, dvals, sig, dsig, c)
    _check_class("sn_takahashi_tangent", c, vals, ("panel", "schur"))
    if not dvals.shape == sig.shape == dsig.shape == pre.shape:
        raise ValueError("sn_takahashi_tangent: pre, dvals, sig and dsig must have one shape")
    W, M, P, B = c["W"], c["M"], c["panel"].shape[0], vals.shape[0]
    if not (P and B):
        return
    from .banded import _fit, tangent_cluster  # banded.py imports this module

    cs = tangent_cluster(W, M, P * B, _fit("tg_sn_tangent_fit", vals.dtype, "sn_takahashi_tangent", (1,)),
                         _sm_count(vals.device), "sn_takahashi_tangent")
    code = _fn("tg_sn_takahashi_tangent", vals.dtype)(
        vals.data_ptr(), vals.shape[1], pre.data_ptr(), dvals.data_ptr(), sig.data_ptr(), dsig.data_ptr(),
        pre.shape[1], c["panel"].data_ptr(), c["schur"].data_ptr(), P, W, M, c["dummy"],
        _tangent_work(c, vals).data_ptr(), B, cs, _stream(vals))
    build.check(code, "sn_takahashi_tangent", f" at W={W} M={M} P={P} B={B} {vals.dtype}, cluster={cs}")
    sn_takahashi_tangent.launches += 1


def sn_panel_adjoint(vals, pre, gvals, c):
    """K25: the cotangent of class batch `c`'s panel inputs (the lower
    entries of A_JJ, and A_RJ) in place in gvals (B, nnzL+1), which holds the
    factor's cotangent on vals' layout and, at the batch's ancestors, their
    inputs' (written by the launches of the levels above); L from vals,
    A = Ld⁻ᵀLd⁻¹ from pre (K8's first entry)."""
    if not _on_cuda("sn_panel_adjoint", vals, pre, gvals):
        return sn_panel_adjoint_plain(vals, pre, gvals, c)
    _check_class("sn_panel_adjoint", c, vals, ("panel", "schur"))
    if gvals.shape != pre.shape:
        raise ValueError("sn_panel_adjoint: pre and gvals must have one shape")
    W, M, P, B = c["W"], c["M"], c["panel"].shape[0], vals.shape[0]
    if not (P and B):
        return
    from .banded import _fit, tangent_cluster  # banded.py imports this module

    cs = tangent_cluster(W, M, P * B, _fit("tg_sn_tangent_fit", vals.dtype, "sn_panel_adjoint", (2,)),
                         _sm_count(vals.device), "sn_panel_adjoint")
    code = _fn("tg_sn_panel_adjoint", vals.dtype)(
        vals.data_ptr(), vals.shape[1], pre.data_ptr(), gvals.data_ptr(), pre.shape[1], c["panel"].data_ptr(),
        c["schur"].data_ptr(), P, W, M, c["dummy"], _tangent_work(c, vals).data_ptr(), B, cs, _stream(vals))
    build.check(code, "sn_panel_adjoint", f" at W={W} M={M} P={P} B={B} {vals.dtype}, cluster={cs}")
    sn_panel_adjoint.launches += 1


sn_panel_adjoint.launches = 0
sn_panel_tangent.launches = 0
sn_takahashi_tangent.launches = 0
sn_panel.launches = 0
sn_trsv.launches = 0
sn_multiply.launches = 0
sn_takahashi_prep.launches = 0
sn_takahashi.launches = 0
