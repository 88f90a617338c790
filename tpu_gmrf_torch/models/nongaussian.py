"""Non-Gaussian latent priors: iterated re-linearization (TMB-style).

Counterpart of ``tpu_gmrf.models.nongaussian`` (reference
src/latent_models/local_quadratic.jl:1-130: natural-form local quadratic
Q = −∇²log p at x_ref, h = ∇log p + Q·x_ref; autodiff_latent_prior.jl:66-161:
a prior given as a scalar log-density; structured_latent_prior.jl:48-227: a
factor graph, per-group small-factor autodiff scattered into a precomputed
pattern, O(nnz) per Newton iterate).

The log-density and the factors are written for one chain; x is (n,) or
(B, n) and θ entries scalars or (B,) (``_chains.per_chain``). A factor
group's gradients and Hessians come from ``vmap(grad)`` and
``vmap(hessian)`` over its (B, G, K) gathered factors, and are summed onto x
and onto the pattern by fixed K5 plans (`gather_segsum` through the
autograd-aware ``sparse.matrix._Linear``), built once at ``create`` from
position maps computed with NumPy: one gather/segment-sum per group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import grad, hessian, jvp, vmap

from .._chains import per_chain, theta_tensors
from .._device import default_device
from ..sparse.matrix import SparseMatrix, _Linear, _linear_plans
from ..sparse.pattern import SparsePattern, dense_pattern, diag_pattern, union_patterns

__all__ = [
    "LatentPrior",
    "AutoDiffLatentPrior",
    "StructuredLatentPrior",
    "FactorGroup",
    "detect_hessian_pattern",
]


def _keys(theta: dict) -> tuple:
    return tuple(sorted(theta))


class LatentPrior:
    """Protocol for non-Gaussian latent priors, materialized at θ.

    Subclasses implement `n`, `log_density(x)` (one value per chain),
    `grad_log_density(x)` and `local_quadratic(x) -> (Q, h)` with
    Q = −∇²log p(x) (a SparseMatrix on a fixed pattern) and
    h = ∇log p(x) + Q·x (natural form). `tensors()` / `with_tensors(ts)`
    list and replace θ's tensors, for the Newton mode's backward."""

    theta: dict

    def log_density(self, x):
        raise NotImplementedError

    def grad_log_density(self, x):
        raise NotImplementedError

    def local_quadratic(self, x):
        raise NotImplementedError

    def tensors(self) -> list:
        return [self.theta[k] for k in _keys(self.theta)]

    def with_tensors(self, ts) -> "LatentPrior":
        return dataclasses.replace(self, theta=dict(zip(_keys(self.theta), ts)))


def detect_hessian_pattern(fn, n: int, theta=None, nprobe: int = 3) -> SparsePattern:
    """Probe the structural Hessian sparsity of `fn(x, **theta)` (one chain)
    by evaluating the dense Hessian at `nprobe` random points (NumPy seed 0,
    x = 0.7·N(0, 1), float64) and keeping the entries nonzero at any of them,
    symmetrized, the diagonal always kept. An O(n²) host-side probe for
    model-build time at moderate n (reference
    ext/GaussianMarkovRandomFieldsSparseADLikelihoods.jl:21-52)."""
    if n > 8192:
        raise ValueError("detect_hessian_pattern materializes an n*n probe; pass an explicit SparsePattern for n > 8192")
    theta = theta_tensors(theta)
    rng = np.random.default_rng(0)
    mask = np.zeros((n, n), dtype=bool)
    h = hessian(lambda x: fn(x, **theta))
    for _ in range(nprobe):
        x = torch.as_tensor(rng.standard_normal(n) * 0.7, dtype=torch.float64, device=default_device())
        mask |= (h(x).abs() > 0).cpu().numpy()
    mask |= mask.T
    mask |= np.eye(n, dtype=bool)
    return SparsePattern.from_dense_mask(mask)


@dataclasses.dataclass(frozen=True)
class AutoDiffLatentPrior(LatentPrior):
    """Prior given by a scalar log-density fn(x, **theta) for one chain.
    `hessian` is 'dense' (exact, O(n²), small n only), 'diag' (separable
    log-densities only) or a symmetric `SparsePattern`: coloured HVPs
    restricted to the pattern (``sparse_hessian_map``), no n×n array."""

    theta: dict
    fn: Callable
    n: int
    hessian: object = "dense"

    def __post_init__(self):
        object.__setattr__(self, "theta", theta_tensors(self.theta))

    def _map(self, op, x):
        return per_chain(lambda v, th: op(lambda u: self.fn(u, **th))(v), x, self.theta)

    def log_density(self, x):
        return self._map(lambda f: f, x)

    def grad_log_density(self, x):
        return self._map(grad, x)

    def local_quadratic(self, x):
        g = self.grad_log_density(x)
        if isinstance(self.hessian, SparsePattern):
            from ..linear_maps import _jacobian_data

            H = SparseMatrix(self._map(lambda f: lambda v: _jacobian_data(grad(f), v, self.hessian), x), self.hessian)
            Q = -H.symmetrize()
        elif self.hessian == "diag":
            d = self._map(lambda f: lambda v: jvp(grad(f), (v,), (torch.ones_like(v),))[1], x)
            Q = SparseMatrix(-d, diag_pattern(self.n))
        else:
            H = self._map(hessian, x)
            Q = SparseMatrix(-H.reshape(H.shape[:-2] + (self.n * self.n,)), dense_pattern(self.n))
        return Q, g + Q.matvec(x)


class FactorGroup:
    """A group of identical small factors: fn(x_k (K,), **theta) over the
    rows of `indices` ((G, K) int array). Static configuration."""

    def __init__(self, indices, fn: Callable):
        self.indices = np.asarray(indices, dtype=np.int64)
        if self.indices.ndim != 2:
            raise ValueError("indices must be (G, K)")
        self.fn = fn

    @property
    def K(self):
        return self.indices.shape[1]


def factor_pattern(n: int, groups) -> tuple:
    """(pattern, posmaps): the diagonal ∪ every factor's K×K block, and per
    group the (G, K, K) positions of its blocks' entries in the pattern, by
    NumPy (a sorted search of the canonical keys row·n + col)."""
    pats = [diag_pattern(n)]
    for g in groups:
        K = g.K
        keys = np.unique((np.repeat(g.indices, K, axis=1) * n + np.tile(g.indices, (1, K))).ravel())
        pats.append(SparsePattern(keys // n, keys % n, (n, n)))
    pattern = union_patterns(*pats)
    keys = pattern.rows.astype(np.int64) * n + pattern.cols
    posmaps = tuple(np.searchsorted(keys, g.indices[:, :, None] * n + g.indices[:, None, :]) for g in groups)
    return pattern, posmaps


@dataclasses.dataclass(frozen=True)
class _FactorPlans:
    """Static gathers and K5 scatter plans of a factor graph: each group's
    (G, K) indices as a device tensor (per device), and the plans summing the
    concatenated per-factor gradients onto x (n,) and Hessian blocks onto
    the pattern (nnz,), with their transposes for the backward."""

    groups: tuple
    grad_plans: tuple
    hess_plans: tuple

    @staticmethod
    def build(n: int, groups, posmaps, nnz: int) -> "_FactorPlans":
        src = np.concatenate([g.indices.ravel() for g in groups])
        pos = np.concatenate([pm.ravel() for pm in posmaps])
        return _FactorPlans(tuple(groups), _linear_plans(src, np.arange(len(src)), n, len(src)),
                            _linear_plans(pos, np.arange(len(pos)), nnz, len(pos)))

    def gather(self, x, g: int):
        cache = self.__dict__.setdefault("_idx", {})
        key = (g, str(x.device))
        idx = cache.get(key)
        if idx is None:
            idx = cache[key] = torch.as_tensor(self.groups[g].indices, device=x.device)
        return x[..., idx]  # (…, G, K)


def _scatter(parts, plans, batch: tuple, width: int):
    """Σ of the flattened per-factor values `parts` onto `width` slots (K5)."""
    vals = torch.cat([p.reshape(batch + (-1,)) for p in parts], -1)
    rows = vals.reshape(-1, vals.shape[-1])
    return _Linear.apply(rows, plans).reshape(batch + (width,))


def factor_values(fn, op, xg, theta, y=None):
    """op(fn_θ) over the G factors of xg (…, G, K), per chain: fn(v, **θ), or
    fn(v, y_i, **θ) with per-factor observations y (G, ...)."""
    if y is None:
        one = lambda X, th: vmap(op(lambda v: fn(v, **th)))(X)
        return per_chain(one, xg, theta, event=2)
    one = lambda X, th, y_: vmap(lambda v, yi: op(lambda u: fn(u, yi, **th))(v))(X, y_)
    return per_chain(one, xg, theta, y, event=2)


@dataclasses.dataclass(frozen=True)
class StructuredLatentPrior(LatentPrior):
    """Factor-graph prior: log p(x) = Σ_g Σ_i fn_g(x[vars_{g,i}]; θ)."""

    theta: dict
    groups: tuple
    n: int
    pattern: SparsePattern
    posmaps: tuple  # (G, K, K) int per group
    plans: _FactorPlans

    @staticmethod
    def create(n: int, groups, theta=None) -> "StructuredLatentPrior":
        groups = tuple(groups)
        pattern, posmaps = factor_pattern(n, groups)
        plans = _FactorPlans.build(n, groups, posmaps, pattern.nnz)
        return StructuredLatentPrior(theta=theta_tensors(theta), groups=groups, n=n, pattern=pattern,
                                     posmaps=posmaps, plans=plans)

    def _batch(self, x):
        return torch.broadcast_shapes(x.shape[:-1], *(v.shape for v in self.theta.values()))

    def log_density(self, x):
        total = x.new_zeros(self._batch(x))
        for i, g in enumerate(self.groups):
            total = total + factor_values(g.fn, lambda f: f, self.plans.gather(x, i), self.theta).sum(-1)
        return total

    def grad_log_density(self, x):
        gs = [factor_values(g.fn, grad, self.plans.gather(x, i), self.theta) for i, g in enumerate(self.groups)]
        return _scatter(gs, self.plans.grad_plans, self._batch(x), self.n)

    def local_quadratic(self, x):
        batch = self._batch(x)
        gs, hs = [], []
        for i, g in enumerate(self.groups):
            xg = self.plans.gather(x, i)
            gs.append(factor_values(g.fn, grad, xg, self.theta))  # (…, G, K)
            hs.append(-factor_values(g.fn, hessian, xg, self.theta))  # (…, G, K, K)
        grad_full = _scatter(gs, self.plans.grad_plans, batch, self.n)
        Q = SparseMatrix(_scatter(hs, self.plans.hess_plans, batch, self.pattern.nnz), self.pattern)
        return Q, grad_full + Q.matvec(x)
