"""Unconstraining transforms for hyperparameter sampling, batched over chains.

Counterpart of ``tpu_gmrf.samplers.transforms``. z is (B, dim) (one row per
chain); ``constrain`` gives a dict of (B,) tensors and the log-density made
by `make_logdensity` returns (B,).
"""

from __future__ import annotations

from typing import Callable

import math

import torch
import torch.nn.functional as F

__all__ = ["Transform", "LogTransform", "LogitTransform", "IdentityTransform", "ParamSpec", "make_logdensity"]


class Transform:
    """z (unconstrained) ↦ x (constrained), with log|dx/dz|."""

    def forward(self, z):
        raise NotImplementedError

    def log_jac(self, z):
        raise NotImplementedError

    def inverse(self, x):
        raise NotImplementedError


class IdentityTransform(Transform):
    forward = staticmethod(lambda z: z)
    inverse = staticmethod(lambda x: x)
    log_jac = staticmethod(torch.zeros_like)


class LogTransform(Transform):
    """x = exp(z) > 0."""

    forward = staticmethod(torch.exp)
    inverse = staticmethod(torch.log)
    log_jac = staticmethod(lambda z: z)


class LogitTransform(Transform):
    """x = lo + (hi-lo)·sigmoid(z) ∈ (lo, hi)."""

    def __init__(self, lo=0.0, hi=1.0):
        self.lo, self.hi = lo, hi

    def forward(self, z):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(z)

    def inverse(self, x):
        p = (x - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)

    def log_jac(self, z):
        return math.log(self.hi - self.lo) + F.logsigmoid(z) + F.logsigmoid(-z)


class ParamSpec:
    """Ordered named parameters with transforms and optional log-priors
    (evaluated on the constrained value)."""

    def __init__(self, **params):
        """params: name -> Transform | (Transform, log_prior_fn)."""
        self.names = tuple(params.keys())
        self.transforms = []
        self.log_priors = []
        for v in params.values():
            t, lp = v if isinstance(v, tuple) else (v, None)
            self.transforms.append(t)
            self.log_priors.append(lp)

    @property
    def dim(self):
        return len(self.names)

    def constrain(self, z):
        """z (..., dim) → dict of constrained (...,) params."""
        return {name: t.forward(z[..., i]) for i, (name, t) in enumerate(zip(self.names, self.transforms))}

    def unconstrain(self, theta: dict):
        return torch.stack(
            [torch.as_tensor(t.inverse(torch.as_tensor(theta[name]))) for name, t in zip(self.names, self.transforms)],
            -1,
        )

    def log_jac(self, z):
        return sum(t.log_jac(z[..., i]) for i, t in enumerate(self.transforms))

    def log_prior(self, z):
        out = torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device)
        theta = self.constrain(z)
        for name, lp in zip(self.names, self.log_priors):
            if lp is not None:
                out = out + lp(theta[name])
        return out


def make_logdensity(loglik_fn: Callable, spec: ParamSpec):
    """z (B, dim) ↦ loglik(θ(z)) + logprior(θ(z)) + log|J(z)|, shape (B,)."""

    def logdensity(z):
        theta = spec.constrain(z)
        return loglik_fn(theta) + spec.log_prior(z) + spec.log_jac(z)

    return logdensity
