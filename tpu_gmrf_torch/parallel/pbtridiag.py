"""Block-tridiagonal SPD solves and logdets with the time axis in chunks (SPIKE).

Counterpart of ``tpu_gmrf.parallel.pbtridiag``. The joint precision of a
spatiotemporal GMRF is block-tridiagonal over Nt time slices: ``diag[t]`` is
Q[t, t] (ns × ns) and ``sub[t]`` is Q[t+1, t], the convention of
`SymmetricBlockTridiagonalMap`. The Nt slices are cut into P chunks of
T = Nt / P slices and solved by substructuring, as the reference does:

1. *Local elimination*, per chunk: the block Cholesky of the chunk's T−1
   interior slices (K11's block entry `bt_factor_blocks`) and one block
   substitution of three right-hand side groups at once, the local b and the
   two coupling columns to the chunk boundaries (K12's block entry
   `bt_trsv_blocks`, 1 + 2ns columns).
2. *The interface system*: one neighbour exchange gives each chunk the
   right neighbour's first-interior products; the interface terms α, β, γ, r
   (plain products) of all chunks are gathered, and the P-block tridiagonal
   Schur system over the chunks' last slices is solved (K18 `spike_reduced`).
3. *Back substitution*, per chunk: u = g − G_L s_prev − G_R s_own.

The logdet is the sum of the chunks' interior logdets and the interface
system's. Where the chunks live is one small interface, the exchange: in one
process they are a batch axis (`_Chunks`: the neighbour exchange is a shift
along it, the gather is the identity); over ``torch.distributed`` each rank
holds one chunk (`_Ranks`: ``send``/``recv`` of the halo, ``all_gather`` of
the interface terms, ``all_reduce`` of the logdet). The per-chunk step is
written once, batched over the chunks a process holds.

The solve is differentiable (`_SpikeSolve`): b̄ = Q⁻¹x̄ by a second SPIKE
solve with the stored chunk factors, G_L, G_R and interface factors (no
second factorization), diag̅_t = −½(b̄_t x_tᵀ + x_t b̄_tᵀ) and
sub̅_t = −(b̄_{t+1} x_tᵀ + x_{t+1} b̄_tᵀ), as ``jax.grad`` of the reference
gives them. The logdet has no backward: `pbtridiag_logdet` raises while diag
or sub requires a gradient.

`pbtridiag_solve` takes a ``torch.distributed.device_mesh.DeviceMesh`` in
place of the reference's JAX ``Mesh``: one chunk per rank of `axis_name`;
every rank passes the whole arrays and gets the whole x back.
`_pbtridiag_chunks` runs P chunks in one process (one card), the same
computation as P devices.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import as_tensor
from ..kernels import bt_factor_blocks, bt_trsv_blocks, spike_reduced
from ..solvers.base import no_double_backward

__all__ = [
    "pbtridiag_solve",
    "pbtridiag_logdet",
    "sharded_block_tridiag_solver",
]


# ---- the exchange -------------------------------------------------------------------


class _Chunks:
    """All P chunks in this process, as the leading axis of (P, ...) tensors."""

    def __init__(self, nchunks: int):
        self.nchunks = nchunks
        self.first = 0  # global index of the first chunk held here

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def from_left(self, t: torch.Tensor) -> torch.Tensor:
        """out[c] = t[c−1], zero for chunk 0."""
        return torch.cat([torch.zeros_like(t[:1]), t[:-1]])

    def from_right(self, t: torch.Tensor) -> torch.Tensor:
        """out[c] = t[c+1], zero for the last chunk."""
        return torch.cat([t[1:], torch.zeros_like(t[:1])])

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t


class _Ranks:
    """One chunk per rank of a process group: tensors here are (1, ...)."""

    def __init__(self, group):
        self.group = group
        self.nchunks = dist.get_world_size(group)
        self.first = dist.get_rank(group)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.first: self.first + 1]

    def _shift(self, t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send t to rank `to`, receive from rank `frm` (zero where that rank does not exist)."""
        out = torch.zeros_like(t)
        ops = []
        if 0 <= to < self.nchunks:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(self.group, to), self.group))
        if 0 <= frm < self.nchunks:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(self.group, frm), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def from_left(self, t: torch.Tensor) -> torch.Tensor:
        return self._shift(t, self.first + 1, self.first - 1)

    def from_right(self, t: torch.Tensor) -> torch.Tensor:
        return self._shift(t, self.first - 1, self.first + 1)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.nchunks)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t


def _chunk_index(ex, C: int, device) -> torch.Tensor:
    return ex.first + torch.arange(C, device=device)


# ---- the per-chunk step -------------------------------------------------------------


def _back(ex, g, GL, GR, s):
    """x (C, T, ns) of the chunks held: u = g − G_L s_prev − G_R s_own over
    the interior, s_own on the last slice; s (P, ns)."""
    idx = _chunk_index(ex, g.shape[0], g.device)
    s_own = s[idx]
    s_prev = torch.where((idx > 0)[:, None], s[(idx - 1).clamp_min(0)], 0.0)
    u = g - (GL @ s_prev[:, None, :, None])[..., 0] - (GR @ s_own[:, None, :, None])[..., 0]
    return torch.cat([u, s_own[:, None]], 1)


def _eliminate(ex, diag, sub, b):
    """Solve and logdet from the chunks held: diag, sub (C, T, ns, ns),
    b (C, T, ns). Returns (x (C, T, ns), logdet, state for `_resolve`)."""
    C, T, ns = diag.shape[0], diag.shape[1], diag.shape[2]
    sub_left = ex.from_left(sub[:, T - 1].contiguous())  # Q[t0, t0−1], zero on chunk 0
    Pf, ld_local = bt_factor_blocks(diag[:, : T - 1].contiguous(), sub[:, : T - 2].contiguous())
    rhs = diag.new_zeros(C, T - 1, ns, 1 + 2 * ns)  # [b | L-coupling | R-coupling]
    rhs[..., 0] = b[:, : T - 1]
    rhs[:, 0, :, 1: 1 + ns] = sub_left
    rhs[:, T - 2, :, 1 + ns:] = sub[:, T - 2].mT
    X = bt_trsv_blocks(Pf, rhs)
    g, GL, GR = X[..., 0], X[..., 1: 1 + ns], X[..., 1 + ns:]
    nxt = ex.from_right(X[:, 0].contiguous())  # the right neighbour's first-interior products
    gf, GLf, GRf = nxt[..., 0], nxt[..., 1: 1 + ns], nxt[..., 1 + ns:]
    last = _chunk_index(ex, C, diag.device) == ex.nchunks - 1
    Eb = sub[:, T - 2]  # Q[t1, t1−1]
    En = torch.where(last[:, None, None], 0.0, sub[:, T - 1])  # Q[t1+1, t1], none after the last chunk
    alpha = -Eb @ GL[:, T - 2]
    beta = diag[:, T - 1] - Eb @ GR[:, T - 2] - En.mT @ GLf
    gamma = -En.mT @ GRf
    r = b[:, T - 1] - (Eb @ g[:, T - 2, :, None])[..., 0] - (En.mT @ gf[..., None])[..., 0]
    terms = ex.gather(torch.cat([alpha, beta, gamma, r[..., None]], -1))  # one gather: (P, ns, 3ns+1)
    A, Bt, G, R = terms[..., :ns], terms[..., ns: 2 * ns], terms[..., 2 * ns: 3 * ns], terms[..., 3 * ns:]
    s, ld_reduced, Lr = spike_reduced(A.contiguous(), Bt.contiguous(), G.contiguous(), R.contiguous())
    x = _back(ex, g, GL, GR, s[..., 0])
    logdet = ex.sum(ld_local.sum()) + ld_reduced
    return x, logdet, (Pf, GL, GR, Eb, En, A.contiguous(), G.contiguous(), Lr)


def _resolve(ex, state, rhs):
    """Q⁻¹ rhs on the chunks held, rhs (C, T, ns), with the factors of `_eliminate`."""
    Pf, GL, GR, Eb, En, A, G, Lr = state
    T = rhs.shape[1]
    g = bt_trsv_blocks(Pf, rhs[:, : T - 1, :, None].contiguous())[..., 0]
    gf = ex.from_right(g[:, 0].contiguous())
    r = rhs[:, T - 1] - (Eb @ g[:, T - 2, :, None])[..., 0] - (En.mT @ gf[..., None])[..., 0]
    s, _, _ = spike_reduced(A, None, G, ex.gather(r)[..., None].contiguous(), factors=Lr)
    return _back(ex, g, GL, GR, s[..., 0])


def _outer(u, v):
    return u[..., :, None] * v[..., None, :]


class _SpikeSolve(torch.autograd.Function):
    """(x (Nt, ns), logdet) of diag, sub (Nt, ns, ns; sub padded) and b (Nt, ns)
    through the exchange `ex`; differentiable in diag, sub and b through x
    (the logdet is a non-differentiable output)."""

    @staticmethod
    def forward(ctx, diag, sub, b, ex):
        Nt, ns = diag.shape[0], diag.shape[1]
        T = Nt // ex.nchunks

        def local(t):
            return ex.local(t.reshape((ex.nchunks, T) + t.shape[1:]))

        x, logdet, state = _eliminate(ex, local(diag), local(sub), local(b))
        ctx.ex, ctx.state, ctx.T = ex, state, T
        ctx.save_for_backward(x)
        ctx.mark_non_differentiable(logdet)
        return ex.gather(x).reshape(Nt, ns), logdet

    @staticmethod
    def backward(ctx, gx, _glogdet):
        no_double_backward("the SPIKE solve")
        (x,) = ctx.saved_tensors
        ex, T = ctx.ex, ctx.T
        Nt, ns = gx.shape
        gb = _resolve(ex, ctx.state, ex.local(gx.reshape(ex.nchunks, T, ns)).contiguous())
        gdiag = gsub = None
        if ctx.needs_input_grad[0]:
            gdiag = ex.gather(-0.5 * (_outer(gb, x) + _outer(x, gb))).reshape(Nt, ns, ns)
        if ctx.needs_input_grad[1]:
            nxt = ex.from_right(torch.stack([gb[:, 0], x[:, 0]], 1))  # slice 0 of the next chunk
            gb_next = torch.cat([gb[:, 1:], nxt[:, :1]], 1)
            x_next = torch.cat([x[:, 1:], nxt[:, 1:]], 1)
            gsub = ex.gather(-(_outer(gb_next, x) + _outer(x_next, gb))).reshape(Nt, ns, ns)
        return gdiag, gsub, ex.gather(gb).reshape(Nt, ns) if ctx.needs_input_grad[2] else None, None


# ---- entry points -------------------------------------------------------------------


def _prep(diag, sub, b, nchunks: int):
    diag = as_tensor(diag)
    sub = as_tensor(sub, dtype=diag.dtype, device=diag.device)
    b = as_tensor(b, dtype=diag.dtype, device=diag.device)
    Nt, ns = diag.shape[0], diag.shape[1]
    if Nt % nchunks != 0:
        raise ValueError(f"Nt={Nt} must be divisible by mesh axis size {nchunks}")
    if Nt // nchunks < 2:
        raise ValueError("need at least 2 time slices per device")
    if sub.shape[0] == Nt - 1:  # pad so the chunks are even
        sub = torch.cat([sub, sub.new_zeros(1, ns, ns)])
    elif sub.shape[0] != Nt:
        raise ValueError("sub must have Nt-1 (or padded Nt) blocks")
    return diag, sub, b


def _pbtridiag_chunks(diag, sub, b, chunks: int):
    """(x, logdet) with the time axis in `chunks` chunks held as a batch axis
    in this process: the reference's computation on `chunks` devices, on one."""
    diag, sub, b = _prep(diag, sub, b, chunks)
    return _SpikeSolve.apply(diag, sub, b, _Chunks(chunks))


def pbtridiag_solve(diag, sub, b, mesh, axis_name: str = "time"):
    """Solve the block-tridiagonal SPD system Q x = b with the time axis in
    one chunk per rank of `mesh`'s `axis_name` (a ``DeviceMesh``).

    diag: (Nt, ns, ns); sub: (Nt-1, ns, ns) with sub[t] = Q[t+1, t] (or padded
    to Nt); b: (Nt, ns), the whole arrays on every rank. Returns x: (Nt, ns)
    on every rank. Differentiable in diag, sub and b."""
    ex = _Ranks(mesh.get_group(axis_name))
    diag, sub, b = _prep(diag, sub, b, ex.nchunks)
    return _SpikeSolve.apply(diag, sub, b, ex)[0]


def pbtridiag_logdet(diag, sub, mesh, axis_name: str = "time"):
    """log det Q of the block-tridiagonal SPD matrix, its time axis in one
    chunk per rank of `mesh`'s `axis_name`. No backward: raises while diag or
    sub requires a gradient."""
    diag = as_tensor(diag)
    sub = as_tensor(sub, device=diag.device)
    if torch.is_grad_enabled() and (diag.requires_grad or sub.requires_grad):
        raise NotImplementedError("pbtridiag_logdet has no backward in this port; detach diag and sub")
    ex = _Ranks(mesh.get_group(axis_name))
    b = diag.new_zeros(diag.shape[0], diag.shape[1])
    diag, sub, b = _prep(diag, sub, b, ex.nchunks)
    return _SpikeSolve.apply(diag, sub, b, ex)[1]


def sharded_block_tridiag_solver(mesh, axis_name: str = "time"):
    """A `solve(diag, sub, b)` closure bound to a mesh: a drop-in for CG and
    preconditioner call sites on spatiotemporal systems."""

    def solve(diag, sub, b):
        return pbtridiag_solve(diag, sub, b, mesh, axis_name)

    return solve
