"""Warmup adaptation, per chain: Nesterov dual-averaging step size (Hoffman &
Gelman 2014, Stan defaults) and Welford diagonal mass-matrix estimation with
Stan-style three-phase windows (fast / expanding-slow / fast).

Counterpart of ``tpu_gmrf.samplers.adaptation``. Where the reference vmaps
one chain's state, the state here holds every chain: (B,) step-size
entries and (B, d) Welford moments.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from .._device import as_tensor, default_device

__all__ = ["DualAveragingState", "da_init", "da_update", "WelfordState", "welford_init", "welford_update",
           "welford_variance", "warmup_schedule"]


class DualAveragingState(NamedTuple):
    log_step: Any
    log_step_avg: Any
    avg_error: Any
    mu: Any
    count: Any


def da_init(initial_step_size):
    ls = torch.log(as_tensor(initial_step_size))
    return DualAveragingState(
        log_step=ls,
        log_step_avg=torch.zeros_like(ls),
        avg_error=torch.zeros_like(ls),
        mu=math.log(10.0) + ls,
        count=torch.zeros_like(ls),
    )


def da_update(state: DualAveragingState, accept_prob, target=0.8, gamma=0.05, t0=10.0, kappa=0.75):
    count = state.count + 1.0
    error = target - accept_prob
    avg_error = state.avg_error + (error - state.avg_error) / (count + t0)
    log_step = state.mu - avg_error * torch.sqrt(count) / gamma
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, avg_error, state.mu, count)


class WelfordState(NamedTuple):
    mean: Any
    m2: Any
    count: Any


def welford_init(dim, dtype=torch.float32, batch: tuple = (), device=None):
    """Zero moments of `batch` chains: mean and m2 (*batch, dim), count (*batch,)."""
    device = default_device() if device is None else device
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    return WelfordState(zeros(*batch, dim), zeros(*batch, dim), zeros(*batch))


def welford_update(state: WelfordState, x):
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize=True):
    var = state.m2 / torch.clamp(state.count - 1.0, min=1.0)[..., None]
    if regularize:
        # Stan's shrinkage toward unit metric
        n = state.count[..., None]
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return var


def warmup_schedule(num_warmup: int, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's warmup windows. Returns (is_slow (bool[num_warmup]),
    window_end (bool[num_warmup]) — True at the last step of each slow
    window where the mass matrix is refreshed), as NumPy arrays: the
    schedule is the same for every chain and is read on the host."""
    if num_warmup < init_buffer + term_buffer + base_window:
        # degenerate: single slow window in the middle
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
    is_slow = np.zeros(num_warmup, bool)
    window_end = np.zeros(num_warmup, bool)
    start = init_buffer
    end_slow = num_warmup - term_buffer
    is_slow[start:end_slow] = True
    w = base_window
    pos = start
    while pos < end_slow:
        win_end = min(pos + w, end_slow)
        # expand final window to absorb the remainder
        if win_end + 2 * w > end_slow:
            win_end = end_slow
        window_end[win_end - 1] = True
        pos = win_end
        w *= 2
    return is_slow, window_end
