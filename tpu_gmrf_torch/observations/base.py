"""Observation model / likelihood protocol.

Counterpart of ``tpu_gmrf.observations.base``: an `ObservationModel` is
configuration; calling it with data y (+ hyperparameters θ) materializes an
`ObservationLikelihood` with the x-only API ``loglik / loggrad /
loghessian``. x is (n,) or (B, n); ``loglik`` returns one value per chain.

Hessian contract: ``hessian_kind`` "diag" → ``loghessian_diag(x)`` returns
the (…, n) diagonal; "sparse" → ``loghessian(x)`` a fixed-pattern
`SparseMatrix` (data (nnz,) or (B, nnz)). The default ``loghessian`` is
``spdiag(loghessian_diag(x))``.

Tensor protocol: ``tensors()`` lists, in a fixed order, every tensor of a
likelihood that θ can reach (None where absent), and ``with_tensors(ts)``
rebuilds the likelihood from such a list. The Laplace mode's autograd
Functions pass the tensors as their inputs, so the implicit-function
backward can hand each one its cotangent.
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

    def tensors(self) -> list:
        """The likelihood's tensors that θ can reach, in a fixed order."""
        return []

    def with_tensors(self, ts) -> "ObservationLikelihood":
        """This likelihood rebuilt from a list shaped like ``tensors()``."""
        return self
