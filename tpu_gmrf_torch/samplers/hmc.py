"""Hamiltonian Monte Carlo over B chains: leapfrog and a fixed-length kernel.

Counterpart of ``tpu_gmrf.samplers.hmc``. Positions are (B, d), one row per
chain; the log-density maps (B, d) to (B,), and its gradient comes from
``torch.autograd.grad(ld.sum(), z)`` (chains are independent, so the sum's
gradient is each chain's own). Momenta and accept draws come from a
``torch.Generator``. A kernel's step takes ``rows=(total, start)`` when its
B chains are rows start..start+B of a batch of `total` chains laid over
several processes: it draws the whole batch's numbers and keeps its own
rows, so each chain sees the numbers it would see in one process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["HMCState", "hmc_init", "hmc_kernel", "hmc_transition", "leapfrog", "value_and_grad"]


class HMCState(NamedTuple):
    position: torch.Tensor  # (B, d)
    logdensity: torch.Tensor  # (B,)
    grad: torch.Tensor  # (B, d)


def value_and_grad(logdensity_fn: Callable, z: torch.Tensor):
    """(ld (B,), ∂ld/∂z (B, d)) at z, detached."""
    z = z.detach().requires_grad_()
    with torch.enable_grad():
        ld = logdensity_fn(z)
        (g,) = torch.autograd.grad(ld.sum(), z)
    return ld.detach(), g


def hmc_init(logdensity_fn: Callable, position: torch.Tensor) -> HMCState:
    ld, grad = value_and_grad(logdensity_fn, position)
    return HMCState(position.detach(), ld, grad)


def leapfrog(logdensity_fn, z, r, grad, step_size, inv_mass):
    """One leapfrog step for H(z, r) = -logp(z) + ½ rᵀ M⁻¹ r."""
    r_half = r + 0.5 * step_size * grad
    z_new = z + step_size * inv_mass * r_half
    ld_new, grad_new = value_and_grad(logdensity_fn, z_new)
    r_new = r_half + 0.5 * step_size * grad_new
    return z_new, r_new, ld_new, grad_new


def _kinetic(r, inv_mass):
    return 0.5 * (r * inv_mass * r).sum(-1)


def hmc_transition(logdensity_fn, state: HMCState, r0, u, step_size, inv_mass, num_steps: int):
    """One HMC transition with given momenta r0 (B, d) and uniforms u (B,)."""
    h0 = -state.logdensity + _kinetic(r0, inv_mass)
    z, r, ld, grad = state.position, r0, state.logdensity, state.grad
    for _ in range(num_steps):
        z, r, ld, grad = leapfrog(logdensity_fn, z, r, grad, step_size, inv_mass)
    h1 = -ld + _kinetic(r, inv_mass)
    delta = h0 - h1
    # NaN-safe: failed evaluations reject with zero acceptance
    accept_prob = torch.where(torch.isnan(delta), torch.zeros_like(delta), torch.exp(delta).clamp_max(1.0))
    accept = u < accept_prob
    a = accept[:, None]
    new_state = HMCState(
        torch.where(a, z, state.position),
        torch.where(accept, ld, state.logdensity),
        torch.where(a, grad, state.grad),
    )
    return new_state, {"accept_prob": accept_prob, "accepted": accept, "energy": h1}


def own_rows(draw, shape: tuple, rows: tuple | None) -> torch.Tensor:
    """draw(shape) for this process's B = shape[0] chains: with rows =
    (total, start), draw(total, *shape[1:]) and keep rows start..start+B."""
    if rows is None:
        return draw(shape)
    total, start = rows
    return draw((total,) + tuple(shape[1:]))[start: start + shape[0]]


def hmc_kernel(logdensity_fn: Callable, num_steps: int = 32):
    """Returns step(generator, state, step_size, inv_mass, rows=None) -> (state, info)."""

    def step(generator: torch.Generator, state: HMCState, step_size, inv_mass, rows=None):
        pos = state.position
        kw = dict(generator=generator, dtype=pos.dtype, device=pos.device)
        r0 = own_rows(lambda s: torch.randn(s, **kw), pos.shape, rows)
        r0 = r0 * torch.sqrt(1.0 / torch.as_tensor(inv_mass, dtype=pos.dtype, device=pos.device))
        u = own_rows(lambda s: torch.rand(s, **kw), pos.shape[:1], rows)
        return hmc_transition(logdensity_fn, state, r0, u, step_size, inv_mass, num_steps)

    return step
