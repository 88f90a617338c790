"""ADVI: mean-field Gaussian variational inference on unconstrained
parameters.

Counterpart of ``tpu_gmrf.samplers.vi``: the reparameterized negative ELBO
of S draws, −(mean of the log-densities + Σ log_std + ½·d·(1 + log 2π)),
minimized by Adam. optax's ``adam`` becomes ``torch.optim.Adam`` with the
same update: betas (0.9, 0.999), eps 1e-8 added after the square root of
the bias-corrected second moment. `advi_step` is one ELBO-and-update step
on given noise (S, d); `run_advi` draws that noise from a
``torch.Generator``, one (S, d) draw a step.

With ``mesh=``, each rank evaluates its own rows of the S draws (the noise
is drawn at full S on every rank and sliced); the log-densities' sum and the
gradient are summed over the ranks by ``all_reduce``. ``num_steps=0``
returns an empty trace (the reference's chunked path raises there). Not
ported: ``dispatch_chunk`` (see `run.py`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from .._device import as_tensor
from ._mesh import Shard, all_sum, shard
from .run import _generator

__all__ = ["run_advi", "ADVIResult"]


class ADVIResult(NamedTuple):
    mean: Any  # (dim,) variational mean (unconstrained)
    log_std: Any  # (dim,)
    elbo_trace: Any  # (num_steps,)

    def sample(self, generator: torch.Generator, num_samples: int):
        eps = torch.randn((num_samples, self.mean.shape[0]), generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + eps * torch.exp(self.log_std)


def adam(params, learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate)'s update as a torch optimizer over `params`."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def elbo_and_grad(logdensity_fn: Callable, mean, log_std, eps, sh: Shard | None = None):
    """(ELBO, ∂ELBO/∂mean, ∂ELBO/∂log_std) of the draws mean + eps·exp(log_std),
    eps (S, d); with `sh`, this rank takes its rows of eps and the sums go
    over the ranks."""
    S, d = eps.shape
    if sh is not None:
        eps = eps[sh.start: sh.stop]
    mean, log_std = mean.detach().requires_grad_(), log_std.detach().requires_grad_()
    with torch.enable_grad():
        lp_sum = logdensity_fn(mean + eps * torch.exp(log_std)).sum()
        g_mean, g_log_std = torch.autograd.grad(lp_sum, (mean, log_std))
    sums = torch.cat([lp_sum.detach()[None], g_mean, g_log_std])
    if sh is not None:
        sums = all_sum(sh, sums)
    entropy = log_std.detach().sum() + 0.5 * d * (1.0 + math.log(2 * math.pi))
    return sums[0] / S + entropy, sums[1: 1 + d] / S, sums[1 + d:] / S + 1.0


def advi_step(logdensity_fn: Callable, mean, log_std, optimizer, eps, sh: Shard | None = None):
    """One Adam step on the negative ELBO at noise eps (S, d); `mean` and
    `log_std` are the optimizer's parameters, updated in place. Returns the
    ELBO before the step."""
    elbo, g_mean, g_log_std = elbo_and_grad(logdensity_fn, mean, log_std, eps, sh)
    mean.grad, log_std.grad = -g_mean, -g_log_std
    optimizer.step()
    return elbo


def run_advi(
    logdensity_fn: Callable,
    key,
    init_position,
    num_steps: int = 2000,
    num_elbo_samples: int = 8,
    learning_rate: float = 1e-2,
    mesh=None,
    sample_axis: str | None = None,
) -> ADVIResult:
    """`logdensity_fn` maps (S, d) to (S,); `key` is a torch.Generator or an
    int seed; log_std starts at −1. With `mesh` (a ``DeviceMesh``) the ELBO's
    draws are laid over its dimension `sample_axis` (default: dimension 0);
    `num_elbo_samples` must divide over its ranks."""
    init = as_tensor(init_position)
    sh = None
    if mesh is not None:
        sh = shard(mesh, sample_axis, num_elbo_samples,
                   "num_elbo_samples {total} not divisible by mesh axis '{axis}' ({world})")
    gen = _generator(key, init.device)
    mean = init.detach().clone().requires_grad_()
    log_std = torch.full_like(mean, -1.0).requires_grad_()
    opt = adam([mean, log_std], learning_rate)
    elbos = []
    for _ in range(num_steps):
        eps = torch.randn((num_elbo_samples, init.shape[0]), generator=gen, dtype=init.dtype, device=init.device)
        elbos.append(advi_step(logdensity_fn, mean, log_std, opt, eps, sh))
    trace = torch.stack(elbos) if elbos else init.new_zeros(0)
    return ADVIResult(mean.detach(), log_std.detach(), trace)
