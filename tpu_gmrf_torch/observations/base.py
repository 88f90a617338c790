"""Observation model / likelihood protocol.

Counterpart of ``tpu_gmrf.observations.base``: an `ObservationModel` is
configuration; calling it with data y (+ hyperparameters θ) materializes an
`ObservationLikelihood` with the x-only API ``loglik / loggrad /
loghessian``. x is (n,) or (B, n); ``loglik`` returns one value per chain.

Hessian contract: ``hessian_kind`` "diag" → ``loghessian_diag(x)`` returns
the (…, n) diagonal; "sparse" → ``loghessian(x)`` a fixed-pattern matrix.
"""

from __future__ import annotations

import torch

__all__ = ["ObservationModel", "ObservationLikelihood"]


class ObservationModel:
    """Factory: obs_model(y, **theta) -> ObservationLikelihood."""

    def __call__(self, y, **theta):
        raise NotImplementedError


class ObservationLikelihood:
    """Materialized likelihood; x-only API."""

    conditionally_independent: bool = True
    hessian_kind: str = "diag"

    def loglik(self, x) -> torch.Tensor:
        raise NotImplementedError

    def loggrad(self, x) -> torch.Tensor:
        raise NotImplementedError

    def loghessian_diag(self, x) -> torch.Tensor:
        raise NotImplementedError

    def loghessian(self, x):
        from ..sparse.matrix import spdiag

        return spdiag(self.loghessian_diag(x))

    def pointwise_loglik(self, x) -> torch.Tensor:
        """Per-observation log-likelihoods (conditionally independent only)."""
        raise NotImplementedError
