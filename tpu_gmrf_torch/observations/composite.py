"""Composite observation models: heterogeneous likelihood components that
each see the whole latent x (routing by their own `indices` or A), with
summed log-likelihoods, gradients and Hessians.

Counterpart of ``tpu_gmrf.observations.composite`` (reference
src/observation_models/composite/). The Hessians add on the union of the
components' patterns (``sp_add``, K5, its plan cached per pair of patterns).
"""

from __future__ import annotations

import dataclasses

import torch

from ..sparse.matrix import SparseMatrix, spdiag
from .base import ObservationLikelihood, ObservationModel

__all__ = ["CompositeObservationModel", "CompositeLikelihood"]


@dataclasses.dataclass(frozen=True)
class CompositeLikelihood(ObservationLikelihood):
    components: tuple  # ObservationLikelihoods

    conditionally_independent = False
    hessian_kind = "sparse"

    def tensors(self) -> list:
        return [t for c in self.components for t in c.tensors()]

    def with_tensors(self, ts) -> "CompositeLikelihood":
        comps, k = [], 0
        for c in self.components:
            m = len(c.tensors())
            comps.append(c.with_tensors(ts[k:k + m]))
            k += m
        return CompositeLikelihood(components=tuple(comps))

    def loglik(self, x):
        return sum(c.loglik(x) for c in self.components)

    def loggrad(self, x):
        return sum(c.loggrad(x) for c in self.components)

    def loghessian(self, x) -> SparseMatrix:
        mats = [spdiag(c.loghessian_diag(x)) if c.hessian_kind == "diag" else c.loghessian(x)
                for c in self.components]
        out = mats[0]
        for m in mats[1:]:
            out = out + m  # union-pattern add on a cached plan
        return out

    def pointwise_loglik(self, x):
        return torch.cat([c.pointwise_loglik(x) for c in self.components], -1)


class CompositeObservationModel(ObservationModel):
    """CompositeObservationModel(model1, model2, ...); call with a tuple of
    per-component observation vectors and merged θ kwargs."""

    def __init__(self, *models):
        if len(models) == 1 and isinstance(models[0], (list, tuple)):
            models = tuple(models[0])
        self.models = models

    def __call__(self, ys, **theta) -> CompositeLikelihood:
        if len(ys) != len(self.models):
            raise ValueError(f"expected {len(self.models)} observation sets, got {len(ys)}")
        return CompositeLikelihood(components=tuple(m(y, **theta) for m, y in zip(self.models, ys)))
