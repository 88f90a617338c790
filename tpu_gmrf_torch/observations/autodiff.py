"""Autodiff observation likelihoods and nonlinear least squares.

Counterpart of ``tpu_gmrf.observations.autodiff`` (reference
src/observation_models/autodiff_likelihood.jl:32-500 and
nonlinear_least_squares.jl:16-316): a user log-likelihood fn(x, y, **θ)
with autodiff gradient and Hessian, and y ~ N(f(x), σ) with the
Gauss-Newton curvature −JᵀJ/σ². The callables are written for one chain,
x (n,); the port maps them over x (B, n) and θ entries of shape (B,) with
``torch.func.vmap`` and differentiates them with ``torch.func``. The Hessian
is "dense", "diag" (valid only when ∂²ℓ/∂xᵢ∂xⱼ = 0 for i ≠ j) or a
`SparsePattern` (coloured HVPs, ``sparse_hessian_map``); NLSQ's Jacobian is
dense (``jacfwd``) or, with `jac_pattern`, coloured jvps, its JᵀJ a K5 SpGEMM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, hessian, jacfwd, jvp, vjp, vmap

from .._chains import per_chain, theta_tensors
from .._device import as_tensor
from ..sparse.matrix import SparseMatrix, sp_matmul, spdiag
from ..sparse.pattern import SparsePattern, dense_pattern
from .base import ObservationLikelihood, ObservationModel

__all__ = [
    "AutoDiffObservationModel",
    "AutoDiffLikelihood",
    "NLSQLikelihood",
    "NonlinearLeastSquaresModel",
    "ZeroLikelihood",
]

_LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class AutoDiffLikelihood(ObservationLikelihood):
    theta: dict  # hyperparameters passed through to fn: scalars or (B,)
    y: object
    fn: Callable
    hessian: object = "dense"

    conditionally_independent = False

    @property
    def hessian_kind(self):
        return "diag" if self.hessian == "diag" else "sparse"

    def tensors(self) -> list:
        return [self.y, *(self.theta[k] for k in sorted(self.theta))]

    def with_tensors(self, ts) -> "AutoDiffLikelihood":
        return dataclasses.replace(self, y=ts[0], theta=dict(zip(sorted(self.theta), ts[1:])))

    def _map(self, op, x):
        """op(ℓ_b)(x_b) per chain, ℓ_b(v) = fn(v, y, **θ_b)."""
        return per_chain(lambda v, th, y: op(lambda u: self.fn(u, y, **th))(v), x, self.theta, self.y)

    def loglik(self, x):
        return self._map(lambda f: f, x)

    def loggrad(self, x):
        return self._map(grad, x)

    def loghessian_diag(self, x):
        """The Hessian's diagonal by one HVP with the ones vector, exact only
        when the Hessian is diagonal (reference `diagonal_hessian_safe`)."""
        return self._map(lambda f: lambda v: jvp(grad(f), (v,), (torch.ones_like(v),))[1], x)

    def loghessian(self, x) -> SparseMatrix:
        if isinstance(self.hessian, SparsePattern):
            from ..linear_maps import _jacobian_data

            return SparseMatrix(self._map(lambda f: lambda v: _jacobian_data(grad(f), v, self.hessian), x),
                                self.hessian).symmetrize()
        if self.hessian == "diag":
            return spdiag(self.loghessian_diag(x))
        H = self._map(hessian, x)
        n = x.shape[-1]
        return SparseMatrix(H.reshape(H.shape[:-2] + (n * n,)), dense_pattern(n))


class AutoDiffObservationModel(ObservationModel):
    """obs_model = AutoDiffObservationModel(fn, hessian=...) with hessian in
    {'dense', 'diag'} or a symmetric `SparsePattern`; fn(x, y, **theta) ->
    scalar log-likelihood, for one chain."""

    def __init__(self, fn: Callable, hessian="dense"):
        if not isinstance(hessian, SparsePattern) and hessian not in ("dense", "diag"):
            raise ValueError("hessian must be 'dense', 'diag', or a SparsePattern")
        self.fn = fn
        self.hessian = hessian

    def __call__(self, y, **theta) -> AutoDiffLikelihood:
        return AutoDiffLikelihood(theta=theta_tensors(theta), y=as_tensor(y), fn=self.fn, hessian=self.hessian)


@dataclasses.dataclass(frozen=True)
class NLSQLikelihood(ObservationLikelihood):
    """y ~ N(f(x), σ): Gauss-Newton curvature −JᵀJ/σ² (negative
    semidefinite by construction). With `jac_pattern` (an (m, n)
    SparsePattern of ∂f/∂x) the Jacobian comes from coloured jvps and JᵀJ
    from a K5 SpGEMM."""

    y: torch.Tensor
    sigma: torch.Tensor  # scalar or (B,)
    f: Callable
    jac_pattern: SparsePattern | None = None

    conditionally_independent = False
    hessian_kind = "sparse"

    def tensors(self) -> list:
        return [self.y, self.sigma]

    def with_tensors(self, ts) -> "NLSQLikelihood":
        return dataclasses.replace(self, y=ts[0], sigma=ts[1])

    def _f(self, x):
        return per_chain(lambda v, th: self.f(v), x, {})

    def _sig(self, like):
        s = torch.as_tensor(self.sigma, dtype=like.dtype, device=like.device)
        return s[:, None] if s.ndim == 1 else s

    def loglik(self, x):
        r = self.y - self._f(x)
        m = r.shape[-1]
        sigma = torch.as_tensor(self.sigma, dtype=r.dtype, device=r.device)
        return -0.5 * ((r / self._sig(r)) ** 2).sum(-1) - m * torch.log(sigma) - 0.5 * m * _LOG2PI

    def loggrad(self, x):
        # ∇ℓ = Jᵀ W r with W = I/σ²
        r = self.y - self._f(x)
        w = r / self._sig(r) ** 2
        pull = lambda v, wv: vjp(self.f, v)[1](wv)[0]
        return pull(x, w) if w.ndim == 1 else vmap(pull)(x.expand(w.shape[:-1] + x.shape[-1:]), w)

    def loghessian(self, x) -> SparseMatrix:
        scale = -1.0 / torch.as_tensor(self.sigma, dtype=x.dtype, device=x.device) ** 2
        if self.jac_pattern is not None:
            from ..linear_maps import sparse_jacobian_map

            J = sparse_jacobian_map(self.f, x, self.jac_pattern)
            return sp_matmul(J.T, J) * scale
        J = per_chain(lambda v, th: jacfwd(self.f)(v), x, {})  # (…, m, n)
        H = J.mT @ J
        n = x.shape[-1]
        s = scale[..., None] if scale.ndim else scale
        return SparseMatrix(H.reshape(H.shape[:-2] + (n * n,)) * s, dense_pattern(n))


class NonlinearLeastSquaresModel(ObservationModel):
    """y ~ N(f(x), σ) with f (n,) -> (m,) for one chain; `jac_pattern` the
    (m, n) pattern of ∂f/∂x, or None for a dense Jacobian."""

    def __init__(self, f: Callable, jac_pattern: SparsePattern | None = None):
        self.f = f
        self.jac_pattern = jac_pattern

    @property
    def hyperparameters(self):
        return ("sigma",)

    def __call__(self, y, sigma, **_) -> NLSQLikelihood:
        return NLSQLikelihood(y=as_tensor(y), sigma=as_tensor(sigma), f=self.f, jac_pattern=self.jac_pattern)

    def conditional_distribution(self, x, sigma, **_):
        """Predictive y | x ~ Normal(f(x), σ)."""
        from .exponential_family import Predictive

        eta = per_chain(lambda v, th: self.f(v), as_tensor(x), {})
        return Predictive(eta=eta, params={"sigma": as_tensor(sigma)}, family="normal", link="identity")


@dataclasses.dataclass(frozen=True)
class ZeroLikelihood(ObservationLikelihood):
    """loglik ≡ 0: TMB-style monolithic joints, the whole model in the prior
    (reference src/observation_models/zero_likelihood.jl)."""

    conditionally_independent = True
    hessian_kind = "diag"

    def loglik(self, x):
        return x.new_zeros(x.shape[:-1])

    def loggrad(self, x):
        return torch.zeros_like(x)

    def loghessian_diag(self, x):
        return torch.zeros_like(x)

    def pointwise_loglik(self, x):
        return torch.zeros_like(x)
