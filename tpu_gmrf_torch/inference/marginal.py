"""Laplace marginal likelihood and latent-model entry points.

Counterpart of ``tpu_gmrf.inference.marginal``: log p(y|θ) ≈ log p(x*|θ) +
log p(y|x*,θ) − log p_Laplace(x*|y,θ) at the converged mode x*; under hard
constraints the correction terms enter through the constrained logpdfs on
both sides; a non-Gaussian `LatentPrior` contributes its exact
log-density. With θ entries of shape (B,) it returns B marginals, one per
chain.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.base import LatentModel
from ..models.nongaussian import LatentPrior
from ..observations.base import ObservationLikelihood, ObservationModel
from .gaussian_approximation import GAOptions, gaussian_approximation

__all__ = ["marginal_loglikelihood", "laplace_marginal"]


def _observations_on(y, device):
    """y on `device`: an array or tensor, or an observation box (``PoissonObservations``,
    ``BinomialObservations``, …) whose tensor fields are moved there."""
    if dataclasses.is_dataclass(y) and not isinstance(y, type):
        return dataclasses.replace(y, **{f.name: getattr(y, f.name).to(device) for f in dataclasses.fields(y)
                                         if isinstance(getattr(y, f.name), torch.Tensor)})
    return torch.as_tensor(y, device=device)


def marginal_loglikelihood(prior, obs_lik: ObservationLikelihood, posterior=None,
                           options: GAOptions = GAOptions()):
    """Laplace log p(y | θ) given a materialized prior (GMRF, ConstrainedGMRF
    or LatentPrior) and likelihood.

    ``posterior.logpdf(x*)`` differentiates through logdet(Q_post(x*(θ))), so
    the θ-gradient reaches the mode's IFT backward through the Hessian."""
    if posterior is None:
        posterior = gaussian_approximation(prior, obs_lik, options=options)
    x_star = posterior.mean
    prior_lp = prior.log_density(x_star) if isinstance(prior, LatentPrior) else prior.logpdf(x_star)
    return prior_lp + obs_lik.loglik(x_star) - posterior.logpdf(x_star)


def laplace_marginal(
    model: LatentModel,
    obs_model: ObservationModel,
    y,
    theta: dict,
    options: GAOptions = GAOptions(),
):
    """End-to-end θ ↦ log p(y | θ), differentiable w.r.t. every θ entry.

    θ entries are routed by name: latent-model hyperparameters go to the
    model, the rest to the observation model factory. y goes to the device
    of the θ tensors, also inside an observation box (a formula's `y`)."""
    latent_names = set(model.hyperparameters)
    theta_latent = {k: v for k, v in theta.items() if k in latent_names}
    theta_obs = {k: v for k, v in theta.items() if k not in latent_names}
    prior = model(**theta_latent)
    obs_lik = obs_model(_observations_on(y, prior.Q.device), **theta_obs)
    posterior = gaussian_approximation(prior, obs_lik, options=options)
    return marginal_loglikelihood(prior, obs_lik, posterior=posterior)
