"""Factor-graph observation model.

Counterpart of ``tpu_gmrf.observations.structured`` (reference
src/observation_models/structured_observation_model.jl): the observation
side of `StructuredLatentPrior`, groups of identical small factors
fn(x[vars], y_i, **theta) for one chain, their ``vmap``-ed gradients and
Hessians summed onto x and onto a fixed pattern by the same K5 plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import grad, hessian

from .._chains import theta_tensors
from .._device import as_tensor
from ..models.nongaussian import _FactorPlans, _scatter, factor_pattern, factor_values
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern
from .base import ObservationLikelihood, ObservationModel

__all__ = ["StructuredObservationModel", "StructuredLikelihood", "ObsFactorGroup"]


class ObsFactorGroup:
    """Identical small observation factors: fn(x_k (K,), y_i, **theta) over
    the rows of `indices` ((G, K)) with per-factor observations y ((G, ...))."""

    def __init__(self, indices, fn):
        self.indices = np.asarray(indices, dtype=np.int64)
        if self.indices.ndim != 2:
            raise ValueError("indices must be (G, K)")
        self.fn = fn

    @property
    def K(self):
        return self.indices.shape[1]


@dataclasses.dataclass(frozen=True)
class StructuredLikelihood(ObservationLikelihood):
    ys: tuple  # per-group observation tensors (G_g, ...)
    theta: dict
    groups: tuple
    n: int
    pattern: SparsePattern
    plans: _FactorPlans

    conditionally_independent = True
    hessian_kind = "sparse"

    def tensors(self) -> list:
        return [*self.ys, *(self.theta[k] for k in sorted(self.theta))]

    def with_tensors(self, ts) -> "StructuredLikelihood":
        k = len(self.ys)
        return dataclasses.replace(self, ys=tuple(ts[:k]), theta=dict(zip(sorted(self.theta), ts[k:])))

    def _batch(self, x):
        return torch.broadcast_shapes(x.shape[:-1], *(v.shape for v in self.theta.values()))

    def _values(self, op, x):
        return [factor_values(g.fn, op, self.plans.gather(x, i), self.theta, y)
                for i, (g, y) in enumerate(zip(self.groups, self.ys))]

    def pointwise_loglik(self, x):
        return torch.cat(self._values(lambda f: f, x), -1)

    def loglik(self, x):
        return self.pointwise_loglik(x).sum(-1) + x.new_zeros(self._batch(x))

    def loggrad(self, x):
        return _scatter(self._values(grad, x), self.plans.grad_plans, self._batch(x), self.n)

    def loghessian(self, x) -> SparseMatrix:
        return SparseMatrix(_scatter(self._values(hessian, x), self.plans.hess_plans, self._batch(x),
                                     self.pattern.nnz), self.pattern)

    def loghessian_diag(self, x):
        raise NotImplementedError("structured Hessian is sparse; use loghessian")


class StructuredObservationModel(ObservationModel):
    def __init__(self, n: int, groups):
        self.n = n
        self.groups = tuple(groups)
        self.pattern, posmaps = factor_pattern(n, self.groups)
        self.posmaps = posmaps
        self.plans = _FactorPlans.build(n, self.groups, posmaps, self.pattern.nnz)

    def __call__(self, ys, **theta) -> StructuredLikelihood:
        if not isinstance(ys, (tuple, list)):
            ys = (ys,)
        ys = tuple(as_tensor(y) for y in ys)
        if len(ys) != len(self.groups):
            raise ValueError(f"expected {len(self.groups)} observation arrays")
        return StructuredLikelihood(ys=ys, theta=theta_tensors(theta), groups=self.groups, n=self.n,
                                    pattern=self.pattern, plans=self.plans)
