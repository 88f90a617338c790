"""Linearly transformed observation models: η = A·x + b.

Counterpart of ``tpu_gmrf.observations.linearly_transformed`` (reference
src/observation_models/linearly_transformed.jl:40-395): wraps any base
likelihood; gradient Aᵀ g(η), Hessian Aᵀ·diag(h_η)·A on a fixed pattern.
A sparse A multiplies on K4 (``SparseMatrix.matvec``, rectangular, and
``rmatvec`` on the transposed pattern) and forms the Hessian by two K5
SpGEMMs (``sp_matmul``) over plans cached per pattern; a dense A (m, n) is
a plain product on the dense n×n pattern. A's data is (nnz,) or (B, nnz)
(one A per chain, as a ``ParameterizedMatrix`` of per-chain θ gives it), b
is (m,) or (B, m), x is (n,) or (B, n).
"""

from __future__ import annotations

import dataclasses

import torch

from .._device import as_tensor
from ..sparse.matrix import SparseMatrix, spdiag
from ..sparse.pattern import dense_pattern
from .base import ObservationLikelihood, ObservationModel

__all__ = [
    "LinearlyTransformedObservationModel",
    "LinearlyTransformedLikelihood",
    "ParameterizedMatrix",
    "ParameterizedOffset",
]


class ParameterizedMatrix:
    """θ-dependent design matrix with a fixed sparsity pattern (reference
    linearly_transformed.jl:40-61): `builder(**θ_sub)` returns the concrete
    A (SparseMatrix or dense tensor) from the hyperparameters it declares.
    Values may depend on θ; the pattern and shape may not."""

    def __init__(self, builder, hyperparameters=(), n_latent=None):
        self.builder = builder
        self.hyperparameters = tuple(hyperparameters)
        self.n_latent = n_latent

    def resolve(self, theta):
        return self.builder(**{k: theta[k] for k in self.hyperparameters})


class ParameterizedOffset:
    """θ-dependent additive offset b of η = A·x + b (reference
    linearly_transformed.jl:63-104); its values may depend on θ, its length
    may not."""

    def __init__(self, builder, hyperparameters=()):
        self.builder = builder
        self.hyperparameters = tuple(hyperparameters)

    def resolve(self, theta):
        return as_tensor(self.builder(**{k: theta[k] for k in self.hyperparameters}))


def _like(A, t: torch.Tensor):
    """A in t's dtype: a float64 FEM operator applied to a float32 field is cast, not the field."""
    if A.dtype == t.dtype:
        return A
    return SparseMatrix(A.data.to(t.dtype), A.pattern) if isinstance(A, SparseMatrix) else A.to(t.dtype)


def _apply(A, x):
    """A x for a SparseMatrix (K4) or a dense (m, n) tensor, in x's dtype."""
    A = _like(A, x)
    return A.matvec(x) if isinstance(A, SparseMatrix) else x @ A.mT


@dataclasses.dataclass(frozen=True)
class LinearlyTransformedLikelihood(ObservationLikelihood):
    base: ObservationLikelihood  # evaluated at η
    A: object  # SparseMatrix (m, n) or dense (m, n)
    b: torch.Tensor | None  # (m,), (B, m) or None

    conditionally_independent = False  # with respect to the latent x
    hessian_kind = "sparse"

    @property
    def n(self):
        return self.A.shape[1]

    def tensors(self) -> list:
        """[A's data (or the dense A), b, *base tensors]."""
        a = self.A.data if isinstance(self.A, SparseMatrix) else self.A
        return [a, self.b, *self.base.tensors()]

    def with_tensors(self, ts) -> "LinearlyTransformedLikelihood":
        A = SparseMatrix(ts[0], self.A.pattern) if isinstance(self.A, SparseMatrix) else ts[0]
        return LinearlyTransformedLikelihood(base=self.base.with_tensors(ts[2:]), A=A, b=ts[1])

    def _eta(self, x):
        eta = _apply(self.A, x)
        return eta if self.b is None else eta + self.b

    def loglik(self, x):
        return self.base.loglik(self._eta(x))

    def pointwise_loglik(self, x):
        return self.base.pointwise_loglik(self._eta(x))

    def loggrad(self, x):
        g_eta = self.base.loggrad(self._eta(x))
        A = _like(self.A, g_eta)
        return A.rmatvec(g_eta) if isinstance(A, SparseMatrix) else g_eta @ A

    def loghessian(self, x) -> SparseMatrix:
        h_eta = self.base.loghessian_diag(self._eta(x))
        A = _like(self.A, h_eta)
        if isinstance(A, SparseMatrix):
            return A.T @ (spdiag(h_eta) @ A)  # Aᵀ D A, two K5 SpGEMMs on cached plans
        H = torch.einsum("...k,...ki,...kj->...ij", h_eta, A, A)
        n = H.shape[-1]
        return SparseMatrix(H.reshape(H.shape[:-2] + (n * n,)), dense_pattern(n))

    def loghessian_diag(self, x):
        raise NotImplementedError("LT Hessian is not diagonal; use loghessian")


class LinearlyTransformedObservationModel(ObservationModel):
    """Wrap a base ObservationModel with η = A·x + b.

    A is a SparseMatrix, a dense tensor or a `ParameterizedMatrix`; b a
    vector, a `ParameterizedOffset` or None. Parameterized specs resolve at
    materialization (``model(y, **θ)``), their hyperparameter names merged
    into the model's."""

    def __init__(self, base_model: ObservationModel, A, b=None):
        self.base_model = base_model
        self.A = A
        self.b = b if b is None or isinstance(b, ParameterizedOffset) else as_tensor(b)

    @property
    def hyperparameters(self):
        return tuple(getattr(self.base_model, "hyperparameters", ())) + self._design_hp_names()

    def _design_hp_names(self) -> tuple:
        names = ()
        if isinstance(self.A, ParameterizedMatrix):
            names += self.A.hyperparameters
        if isinstance(self.b, ParameterizedOffset):
            names += self.b.hyperparameters
        return names

    def _design(self, theta):
        A = self.A.resolve(theta) if isinstance(self.A, ParameterizedMatrix) else self.A
        b = self.b.resolve(theta) if isinstance(self.b, ParameterizedOffset) else self.b
        if not isinstance(A, SparseMatrix):
            A = as_tensor(A)
        return A, b

    def __call__(self, y, **theta) -> LinearlyTransformedLikelihood:
        design = self._design_hp_names()
        base = self.base_model(y, **{k: v for k, v in theta.items() if k not in design})
        A, b = self._design(theta)
        return LinearlyTransformedLikelihood(base=base, A=A, b=b)

    def conditional_distribution(self, x_full, **theta):
        """Predictive at η = A·x + b, forwarded to the base model."""
        design = self._design_hp_names()
        A, b = self._design(theta)
        eta = _apply(A, as_tensor(x_full))
        if b is not None:
            eta = eta + b
        return self.base_model.conditional_distribution(eta, **{k: v for k, v in theta.items() if k not in design})
