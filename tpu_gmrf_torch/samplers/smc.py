"""Adaptive tempered Sequential Monte Carlo.

Counterpart of ``tpu_gmrf.samplers.smc``. Tempering p_λ ∝ prior·likᵏ with
the next λ chosen by ESS bisection (26 halvings, on the device with
``torch.where``: no value is read back inside a stage), systematic
resampling, and HMC move steps at the new temperature with unit mass. The
particles are the leading axis of one batch; `log_prior_fn` and
`log_lik_fn` map (N, d) to (N,). The stage loop runs on the host and reads
λ back once per stage; it stops at λ ≥ 1 or after `max_stages`, the
reference's ``while_loop`` condition.

With ``mesh=``, each rank moves its own block of particles; the
log-likelihood values and the particles are all-gathered for the ESS, the
λ bisection and the resampling (the reference's gathered-weight
collectives), whose random numbers every rank draws alike, so every rank
returns the one-process result. Not ported: ``dispatch_chunk`` (see
`run.py`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from .._device import as_tensor
from ._mesh import gather, shard
from .hmc import hmc_init, hmc_kernel
from .run import _generator

__all__ = ["run_smc", "SMCResult"]

_BISECTIONS = 26


class SMCResult(NamedTuple):
    particles: Any  # (num_particles, dim)
    log_evidence: Any  # scalar estimate of log Z
    num_stages: int
    lambdas: Any  # (max_stages,) tempering schedule (padded with 1s)


def _systematic_resample(u, log_weights, n: int) -> torch.Tensor:
    """Indices of n systematic draws from softmax(log_weights) at offset u ∈ [0, 1)."""
    cum = torch.cumsum(torch.softmax(log_weights, 0), 0)
    points = (u + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    # a point past cum's rounded end takes the last particle, as JAX's clamped gather does
    return torch.searchsorted(cum, points).clamp_max(n - 1)


def _ess(log_weights) -> torch.Tensor:
    lw = log_weights - torch.logsumexp(log_weights, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _next_lambda(lam, loglik, target_ess: float):
    """(λ + δ, δ): the largest δ ∈ (0, 1 − λ] with ESS(δ·loglik)/N ≥ target, by bisection."""
    n = loglik.shape[0]

    def ok(delta):
        return _ess(delta * loglik) / n >= target_ess

    full = 1.0 - lam
    lo, hi = torch.zeros_like(lam), full
    for _ in range(_BISECTIONS):
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
    delta = torch.where(ok(full), full, lo)
    return lam + delta, delta


def run_smc(
    log_prior_fn: Callable,
    log_lik_fn: Callable,
    key,
    init_particles,
    num_move_steps: int = 3,
    hmc_num_steps: int = 16,
    step_size: float = 0.1,
    target_ess: float = 0.5,
    max_stages: int = 50,
    mesh=None,
    particle_axis: str | None = None,
) -> SMCResult:
    """Temper from prior to posterior: π_λ ∝ exp(log_prior + λ·log_lik).

    `key` is a torch.Generator or an int seed; `init_particles` (N, d) or
    (d,). With `mesh` (a ``DeviceMesh``) the particles are laid over its
    dimension `particle_axis` (default: dimension 0); N must divide over its
    ranks."""
    particles = as_tensor(init_particles)
    particles = particles[None] if particles.ndim == 1 else particles
    n, dim = particles.shape
    dtype, dev = particles.dtype, particles.device
    sh = None if mesh is None else shard(mesh, particle_axis, n,
                                         "num_particles {total} not divisible by mesh axis '{axis}' ({world})")
    lo, hi, rows = (0, n, None) if sh is None else (sh.start, sh.stop, sh.rows)
    full = (lambda t: t) if sh is None else (lambda t: gather(sh, t))
    particles = particles[lo:hi]
    gen = _generator(key, dev)
    inv_mass = torch.ones(dim, dtype=dtype, device=dev)
    lam = torch.zeros((), dtype=dtype, device=dev)
    log_z = torch.zeros((), dtype=dtype, device=dev)
    lambdas = torch.ones(max_stages, dtype=dtype, device=dev)
    stages = 0
    while stages < max_stages and float(lam) < 1.0:
        with torch.no_grad():
            loglik = full(log_lik_fn(particles))
        lam, delta = _next_lambda(lam, loglik, target_ess)
        log_w = delta * loglik
        log_z = log_z + torch.logsumexp(log_w, 0) - math.log(n)
        u = torch.rand((), generator=gen, dtype=dtype, device=dev)
        idx = _systematic_resample(u, log_w, n)
        particles = full(particles)[idx[lo:hi]]

        def tempered(z, lam=lam):
            return log_prior_fn(z) + lam * log_lik_fn(z)

        kernel = hmc_kernel(tempered, num_steps=hmc_num_steps)
        state = hmc_init(tempered, particles)
        for _ in range(num_move_steps):
            state, _ = kernel(gen, state, step_size, inv_mass, rows)
        particles = state.position
        lambdas[stages] = lam
        stages += 1
    return SMCResult(full(particles), log_z, stages, lambdas)
