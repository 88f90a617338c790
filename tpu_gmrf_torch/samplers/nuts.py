"""No-U-Turn Sampler over B chains: iterative, multinomial, with the
Stan-style generalized U-turn criterion.

Counterpart of ``tpu_gmrf.samplers.nuts`` (``nuts.py:43-202``). The
reference runs one chain's doubling and leaf loops as nested
``while_loop``s and vmaps them over chains. Here the two loops are Python
loops over a leading chain axis: at doubling j every chain that is still
running builds a 2^j-leaf subtree, so the doubling counter and the leaf
index are common to all running chains. Chains stop at different leaves
and doublings; every state update is a ``torch.where`` mask, as in
`hmc_transition`. A chain that has stopped takes no further part: its
log-density is evaluated at the transition's start point (a zero step), so
a diverged chain cannot feed an extreme θ into the batched log-density and
slow or disturb the others.

Sub-U-turn checks use the reference's O(max_depth) checkpoint stack: when
leaf i opens a level-l subtree (i mod 2^l = 0) its momentum and the
pre-subtree momentum sum are stored at slot l; when leaf i closes one
((i+1) mod 2^l = 0) the segment sum is checked against the segment's end
velocities. Since i is common to all running chains, which slots open and
close at a leaf is known on the host.

`nuts_transition` takes its random draws as tensors, so a test can give it
the reference's draws; `nuts_kernel` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from .hmc import HMCState, leapfrog, own_rows

__all__ = ["nuts_kernel", "nuts_transition", "NUTSInfo", "NUTSDraws"]

_DIVERGENCE_THRESHOLD = 1000.0


class NUTSInfo(NamedTuple):
    accept_prob: Any  # (B,)
    num_leaves: Any  # (B,) int64
    depth: Any  # (B,) int64
    diverging: Any  # (B,) bool
    energy: Any  # (B,)


class NUTSDraws(NamedTuple):
    """The random numbers of one transition of B chains.

    momentum (B, d): the initial momenta, already scaled by √M;
    direction (B, max_depth): uniforms, go right where < 0.5 (the
      reference's Bernoulli(½));
    accept (B, max_depth): uniforms of the biased progressive sampling
      across doublings;
    leaf (B, max_depth, 2^(max_depth-1)): uniforms of the multinomial
      sampling within a subtree, per (doubling, leaf)."""

    momentum: torch.Tensor
    direction: torch.Tensor
    accept: torch.Tensor
    leaf: torch.Tensor


def _where(mask, new, old):
    """Per-chain select of (B, ...) tensors by a (B,) mask."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def _kinetic(r, inv_mass):
    return 0.5 * (r * inv_mass * r).sum(-1)


def _uturn(v_left, v_right, rho):
    return ((v_left * rho).sum(-1) <= 0) | ((v_right * rho).sum(-1) <= 0)


def _build_subtree(logdensity_fn, start, park, j, direction, h0, step_size, inv_mass, running, leaf_u, max_depth):
    """2^j leaves from `start` (z, r, ld, grad) in `direction` for the
    chains in `running`; returns (end state, proposal, rho, log_weight,
    sum_alpha, n_leaves, diverged, stop)."""
    z, r, ld, grad = start
    B, d = z.shape
    levels = max_depth + 1
    prop = (z, ld, grad)
    rho = torch.zeros_like(z)
    log_w = torch.full_like(ld, -math.inf)
    sum_alpha = torch.zeros_like(ld)
    n = torch.zeros(B, dtype=torch.long, device=z.device)
    ckpt_r = z.new_zeros(B, levels, d)
    ckpt_s = z.new_zeros(B, levels, d)
    div = torch.zeros(B, dtype=torch.bool, device=z.device)
    stop = torch.zeros_like(div)
    run = running
    eps = direction * step_size
    for i in range(2**j):
        if not bool(run.any()):
            break
        # a chain that has stopped steps by 0 from the transition's start
        z_in, r_in, g_in = _where(run, z, park[0]), _where(run, r, torch.zeros_like(r)), _where(run, grad, park[2])
        zn, rn, ldn, gn = leapfrog(logdensity_fn, z_in, r_in, g_in, torch.where(run, eps, 0.0)[:, None], inv_mass)
        delta = -ldn + _kinetic(rn, inv_mass) - h0  # positive = worse
        # NaN-safe: a NaN energy (failed factorization at extreme θ) is a
        # divergence, not a silent weight contribution
        diverged = ~(delta <= _DIVERGENCE_THRESHOLD)
        w = torch.where(diverged, -math.inf, -delta)
        alpha = torch.where(diverged, 0.0, torch.exp(-delta).clamp_max(1.0))
        new_log_w = torch.logaddexp(log_w, w)
        take = run & (torch.log(leaf_u[:, i]) < (w - new_log_w))
        # open checkpoints (before adding r to rho): levels l with i % 2^l == 0
        opens = [lv for lv in range(1, levels) if i % 2**lv == 0]
        new_r, new_s = ckpt_r, ckpt_s
        if opens:
            new_r, new_s = ckpt_r.clone(), ckpt_s.clone()
            new_r[:, opens] = rn[:, None]
            new_s[:, opens] = rho[:, None]
        new_rho = rho + rn
        # close checkpoints: levels l with (i+1) % 2^l == 0
        closes = [lv for lv in range(1, levels) if (i + 1) % 2**lv == 0]
        turning = torch.zeros_like(div)
        if closes:
            seg = new_rho[:, None] - new_s[:, closes]
            v_start = new_r[:, closes] * inv_mass.unsqueeze(-2)
            v_end = (rn * inv_mass)[:, None]
            turning = (((v_start * seg).sum(-1) <= 0) | ((v_end * seg).sum(-1) <= 0)).any(-1)
        z, r, ld, grad = (_where(run, a, b) for a, b in ((zn, z), (rn, r), (ldn, ld), (gn, grad)))
        prop = tuple(_where(take, a, b) for a, b in zip((zn, ldn, gn), prop))
        log_w = torch.where(run, new_log_w, log_w)
        sum_alpha = torch.where(run, sum_alpha + alpha, sum_alpha)
        ckpt_r, ckpt_s = _where(run, new_r, ckpt_r), _where(run, new_s, ckpt_s)
        rho = _where(run, new_rho, rho)
        n = n + run.long()
        div = div | (run & diverged)
        leaf_stop = diverged | turning
        stop = stop | (run & leaf_stop)
        run = run & ~leaf_stop
    return (z, r, ld, grad), prop, rho, log_w, sum_alpha, n, div, stop


def nuts_transition(logdensity_fn: Callable, state: HMCState, draws: NUTSDraws, step_size, inv_mass,
                    max_depth: int):
    """One NUTS transition of B chains with given draws.

    state: positions (B, d), log-densities (B,), gradients (B, d);
    step_size: a number or (B,); inv_mass: (d,) or (B, d). Returns
    (state, NUTSInfo)."""
    z0, ld0, g0 = state
    B, d = z0.shape
    step_size = torch.as_tensor(step_size, dtype=z0.dtype, device=z0.device).expand(B)
    inv_mass = torch.as_tensor(inv_mass, dtype=z0.dtype, device=z0.device).expand(B, d)
    r0 = draws.momentum
    h0 = -ld0 + _kinetic(r0, inv_mass)
    left = right = (z0, r0, ld0, g0)
    prop = (z0, ld0, g0)
    rho = r0
    log_w = torch.zeros_like(ld0)  # logW of the initial point = 0
    sum_alpha = torch.zeros_like(ld0)
    n_alpha = torch.zeros(B, dtype=torch.long, device=z0.device)
    depth = torch.zeros_like(n_alpha)
    div = torch.zeros(B, dtype=torch.bool, device=z0.device)
    stop = torch.zeros_like(div)
    for j in range(max_depth):
        active = ~stop
        if not bool(active.any()):
            break
        go_right = draws.direction[:, j] < 0.5
        direction = torch.where(go_right, 1.0, -1.0).to(z0.dtype)
        start = tuple(_where(go_right, b, a) for a, b in zip(left, right))
        end, sub_prop, sub_rho, sub_log_w, sub_alpha, sub_n, sub_div, sub_stop = _build_subtree(
            logdensity_fn, start, (z0, ld0, g0), j, direction, h0, step_size, inv_mass, active,
            draws.leaf[:, j], max_depth,
        )
        left = tuple(_where(active & ~go_right, e, a) for e, a in zip(end, left))
        right = tuple(_where(active & go_right, e, a) for e, a in zip(end, right))
        # biased progressive sampling across doublings
        take = active & ~sub_stop & (torch.log(draws.accept[:, j]) < (sub_log_w - log_w))
        prop = tuple(_where(take, a, b) for a, b in zip(sub_prop, prop))
        rho = _where(active, rho + sub_rho, rho)
        log_w = torch.where(active, torch.logaddexp(log_w, torch.where(sub_stop, -math.inf, sub_log_w)), log_w)
        sum_alpha = torch.where(active, sum_alpha + sub_alpha, sum_alpha)
        n_alpha = n_alpha + torch.where(active, sub_n, 0)
        turning = _uturn(left[1] * inv_mass, right[1] * inv_mass, rho)
        div = div | (active & sub_div)
        stop = stop | (active & (sub_stop | turning))
        depth = depth + active.long()
    z, ld, grad = prop
    info = NUTSInfo(
        accept_prob=sum_alpha / n_alpha.clamp_min(1),
        num_leaves=n_alpha,
        depth=depth,
        diverging=div,
        energy=-ld,
    )
    return HMCState(z, ld, grad), info


def nuts_kernel(logdensity_fn: Callable, max_depth: int = 10):
    """Returns step(generator, state, step_size, inv_mass, rows=None) ->
    (state, NUTSInfo); `rows` as in `hmc_kernel`."""

    def step(generator: torch.Generator, state: HMCState, step_size, inv_mass, rows=None):
        pos = state.position
        B, d = pos.shape
        kw = dict(generator=generator, dtype=pos.dtype, device=pos.device)
        randn, rand = (lambda s: torch.randn(s, **kw)), (lambda s: torch.rand(s, **kw))
        inv_mass = torch.as_tensor(inv_mass, dtype=pos.dtype, device=pos.device)
        draws = NUTSDraws(
            momentum=own_rows(randn, (B, d), rows) * torch.sqrt(1.0 / inv_mass),
            direction=own_rows(rand, (B, max_depth), rows),
            accept=own_rows(rand, (B, max_depth), rows),
            leaf=own_rows(rand, (B, max_depth, 2 ** (max_depth - 1)), rows),
        )
        return nuts_transition(logdensity_fn, state, draws, step_size, inv_mass, max_depth)

    return step
