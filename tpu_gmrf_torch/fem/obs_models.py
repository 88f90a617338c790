"""FEM observation helpers: point evaluation and derivative observation models.

Counterpart of ``tpu_gmrf.fem.obs_models``: each is an evaluation or
derivative matrix composed with any base observation model through
`LinearlyTransformedObservationModel`. The matrix is built on the host once
(a static pattern) and lives on the default device; the hot path is the
batched sparse A·x and AᵀHA.
"""

from __future__ import annotations

from ..observations.linearly_transformed import LinearlyTransformedObservationModel

__all__ = [
    "PointEvaluationObsModel",
    "PointDerivativeObsModel",
    "PointSecondDerivativeObsModel",
]


def PointEvaluationObsModel(disc, points, base_model, offset=None):
    """Observe y_i ~ base(u(points_i)): A = evaluation matrix at `points`
    (P1 barycentric interpolation rows)."""
    A = disc.evaluation_matrix(points)
    return LinearlyTransformedObservationModel(base_model, A, offset)


def PointDerivativeObsModel(disc, points, base_model, dim: int = 0, offset=None):
    """Observe y_i ~ base(∂u/∂x_dim (points_i)): A = derivative matrix
    (piecewise-constant P1 gradients on the containing element)."""
    A = disc.derivative_matrix(points, dim=dim)
    return LinearlyTransformedObservationModel(base_model, A, offset)


def PointSecondDerivativeObsModel(disc, points, base_model, dims=(0, 0), offset=None):
    """Observe y_i ~ base(∂²u/∂x_{d2}∂x_{d1}(points_i)) through the
    recovered-gradient second-derivative matrix."""
    A = disc.second_derivative_matrix(points, dims=dims)
    return LinearlyTransformedObservationModel(base_model, A, offset)
