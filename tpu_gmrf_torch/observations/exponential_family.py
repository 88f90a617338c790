"""Exponential-family observation models.

Counterpart of ``tpu_gmrf.observations.exponential_family``: families
Normal/Poisson/Bernoulli/Binomial/NegativeBinomial/Gamma/StudentT × links
Identity/Log/Logit. Canonical links use the closed forms for the gradient
and Hessian; the others exact autodiff of the pointwise log-likelihood
(``torch.func``: it is elementwise in η, so the gradient of the sum and the
gradient of that gradient's sum are the exact per-element derivatives).
Supports observation-index subsets (`indices`) and log-exposure offsets for
Poisson/NegBin. `Predictive` is the predictive distribution p(y | x) that
`conditional_distribution` returns; its draws take a ``torch.Generator``.

Batching: x is (n,) or (B, n). Family hyperparameters (sigma, r, phi, nu)
are scalars or (B,), one per chain; y, offset and binomial trials are per
observation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.func import grad

from .._device import as_tensor
from .base import ObservationLikelihood, ObservationModel

__all__ = [
    "ExponentialFamily",
    "IdentityLink",
    "LogLink",
    "LogitLink",
    "PoissonObservations",
    "BinomialObservations",
    "NegativeBinomialObservations",
    "EFLikelihood",
    "Predictive",
    "apply_link",
    "apply_invlink",
    "conditional_distribution",
]

_LOG2PI = 1.8378770664093453


# ---- link functions --------------------------------------------------------


class Link:
    name: str

    @staticmethod
    def inv(eta):  # mu = g⁻¹(eta)
        raise NotImplementedError


class IdentityLink(Link):
    name = "identity"
    inv = staticmethod(lambda eta: eta)


class LogLink(Link):
    name = "log"
    inv = staticmethod(torch.exp)


class LogitLink(Link):
    name = "logit"
    inv = staticmethod(torch.sigmoid)


_LINKS = {"identity": IdentityLink, "log": LogLink, "logit": LogitLink}


def apply_invlink(link, eta):
    """μ = g⁻¹(η) for a link name or Link class."""
    if isinstance(link, str):
        link = _LINKS[link]
    return link.inv(as_tensor(eta))


def apply_link(link, mu):
    """η = g(μ) for a link name or Link class."""
    name = link if isinstance(link, str) else link.name
    mu = as_tensor(mu)
    if name == "identity":
        return mu
    if name == "log":
        return torch.log(mu)
    if name == "logit":
        return torch.log(mu) - torch.log1p(-mu)
    raise ValueError(f"unknown link {name}")


_CANONICAL = {
    "normal": "identity",
    "poisson": "log",
    "bernoulli": "logit",
    "binomial": "logit",
    "negativebinomial": "log",
    "gamma": "log",
    "studentt": "identity",
}


def _softplus(x):
    # logaddexp(x, 0), as jax.nn.softplus (torch's softplus switches to x above 20)
    return torch.logaddexp(x, torch.zeros_like(x))


# ---- observation containers ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoissonObservations:
    """Counts with optional exposure (offset = log exposure)."""

    counts: Any
    logexposure: Any = None

    @staticmethod
    def create(counts, exposure=None):
        le = None if exposure is None else torch.log(as_tensor(exposure))
        return PoissonObservations(as_tensor(counts), le)


@dataclasses.dataclass(frozen=True)
class BinomialObservations:
    successes: Any
    trials: Any


@dataclasses.dataclass(frozen=True)
class NegativeBinomialObservations:
    counts: Any
    logexposure: Any = None

    @staticmethod
    def create(counts, exposure=None):
        le = None if exposure is None else torch.log(as_tensor(exposure))
        return NegativeBinomialObservations(as_tensor(counts), le)


# ---- materialized likelihood ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class EFLikelihood(ObservationLikelihood):
    """One class for all families; `family`/`link` select the closed forms."""

    y: torch.Tensor
    params: dict  # family parameters: name -> tensor
    offset: torch.Tensor | None
    indices: torch.Tensor | None
    family: str
    link: str

    @property
    def canonical(self) -> bool:
        return _CANONICAL[self.family] == self.link

    # -- the tensors autograd may differentiate (for the IFT backward) --

    def tensors(self) -> list:
        """[y, offset, *params values] (None where absent), in a fixed order."""
        return [self.y, self.offset, *(self.params[k] for k in sorted(self.params))]

    def with_tensors(self, ts) -> "EFLikelihood":
        keys = sorted(self.params)
        return dataclasses.replace(self, y=ts[0], offset=ts[1], params=dict(zip(keys, ts[2:])))

    # -- plumbing --

    def _hp(self, name: str, like: torch.Tensor):
        """Hyperparameter `name` shaped to broadcast against eta (…, m)."""
        t = torch.as_tensor(self.params[name], dtype=like.dtype, device=like.device)
        if name != "trials" and t.ndim == 1:
            t = t[:, None]
        return t

    def _eta(self, x):
        eta = x[..., self.indices] if self.indices is not None else x
        if self.offset is not None:
            eta = eta + self.offset
        return eta

    def _embed(self, g_obs, x):
        if self.indices is None:
            return g_obs
        return torch.zeros_like(x).index_add(-1, self.indices, g_obs.expand(x.shape[:-1] + g_obs.shape[-1:]))

    def _mu(self, eta):
        return _LINKS[self.link].inv(eta)

    # -- pointwise log-likelihood in eta (closed forms) --

    def _pointwise_eta(self, eta):
        y = self.y.to(eta)
        mu = self._mu(eta)
        f = self.family
        lg = torch.lgamma
        if f == "normal":
            sigma = self._hp("sigma", eta)
            return -0.5 * _LOG2PI - torch.log(sigma) - 0.5 * ((y - mu) / sigma) ** 2
        if f == "poisson":
            log_mu = eta if self.link == "log" else torch.log(mu)
            return y * log_mu - mu - lg(y + 1.0)
        if f == "bernoulli":
            eta_l = eta if self.link == "logit" else torch.log(mu) - torch.log1p(-mu)
            return y * eta_l - _softplus(eta_l)
        if f == "binomial":
            n = self._hp("trials", eta)
            eta_l = eta if self.link == "logit" else torch.log(mu) - torch.log1p(-mu)
            return y * eta_l - n * _softplus(eta_l) + lg(n + 1.0) - lg(y + 1.0) - lg(n - y + 1.0)
        if f == "negativebinomial":
            r = self._hp("r", eta)
            return (
                lg(y + r) - lg(r) - lg(y + 1.0) + r * torch.log(r)
                + y * torch.log(mu) - (r + y) * torch.log(r + mu)
            )
        if f == "gamma":
            phi = self._hp("phi", eta)
            return (
                phi * torch.log(phi) - lg(phi) + (phi - 1.0) * torch.log(y)
                - phi * torch.log(mu) - phi * y / mu
            )
        if f == "studentt":
            sigma, nu = self._hp("sigma", eta), self._hp("nu", eta)
            w = sigma**2 * (nu - 2.0)
            return (
                lg((nu + 1.0) / 2) - lg(nu / 2) - 0.5 * torch.log(math.pi * (nu - 2.0))
                - torch.log(sigma) - (nu + 1.0) / 2 * torch.log1p((y - mu) ** 2 / w)
            )
        raise ValueError(f"unknown family {f}")

    # -- public API --

    def pointwise_loglik(self, x):
        return self._pointwise_eta(self._eta(x))

    def loglik(self, x):
        return self._pointwise_eta(self._eta(x)).sum(-1)

    def _grad_hess_eta(self, eta):
        """(dℓ/dη, d²ℓ/dη²) per observation: the canonical links' closed
        forms, else exact autodiff of the elementwise ``_pointwise_eta``."""
        if not self.canonical:
            total = lambda e: self._pointwise_eta(e).sum()
            d1 = grad(total)
            return d1(eta), grad(lambda e: d1(e).sum())(eta)
        y, f = self.y.to(eta), self.family
        mu = self._mu(eta)
        if f == "normal":
            inv_s2 = 1.0 / self._hp("sigma", eta) ** 2
            return (y - eta) * inv_s2, -inv_s2 * torch.ones_like(eta)
        if f == "poisson":
            return y - mu, -mu
        if f == "bernoulli":
            return y - mu, -mu * (1.0 - mu)
        if f == "binomial":
            n = self._hp("trials", eta)
            return y - n * mu, -n * mu * (1.0 - mu)
        if f == "negativebinomial":
            r = self._hp("r", eta)
            return r * (y - mu) / (r + mu), -r * mu * (r + y) / (r + mu) ** 2
        if f == "gamma":
            phi = self._hp("phi", eta)
            return phi * (y / mu - 1.0), -phi * y / mu
        if f == "studentt":
            sigma, nu = self._hp("sigma", eta), self._hp("nu", eta)
            w = sigma**2 * (nu - 2.0)
            resid = y - eta
            denom = w + resid**2
            return (nu + 1.0) * resid / denom, (nu + 1.0) * (resid**2 - w) / denom**2
        raise ValueError(f"unknown family {f}")

    def loggrad(self, x):
        g, _ = self._grad_hess_eta(self._eta(x))
        return self._embed(g, x)

    def loghessian_diag(self, x):
        _, h = self._grad_hess_eta(self._eta(x))
        return self._embed(h, x)


# ---- predictive (conditional) distribution ---------------------------------


def _hyper(t, like):
    """A family parameter shaped to broadcast against η (…, m): (B,) → (B, 1)."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    return t[:, None] if t.ndim == 1 and like.ndim == 2 else t


@dataclasses.dataclass(frozen=True)
class Predictive:
    """Predictive distribution p(y | x) at a fixed linear predictor η (…, m),
    offset applied: vectorized ``mean`` / ``var`` / ``std`` / ``logpdf`` and
    ``sample(generator)``. Family parameters are scalars or (B,), except
    binomial trials, which are per observation."""

    eta: torch.Tensor
    params: dict
    family: str
    link: str

    def _lik(self, y) -> EFLikelihood:
        return EFLikelihood(y=as_tensor(y), params=self.params, offset=None, indices=None, family=self.family,
                            link=self.link)

    def _p(self, name):
        if name == "trials":
            return torch.as_tensor(self.params[name], dtype=self.eta.dtype, device=self.eta.device)
        return _hyper(self.params[name], self.eta)

    @property
    def mu(self):
        return _LINKS[self.link].inv(self.eta)

    def mean(self):
        mu = self.mu
        return self._p("trials") * mu if self.family == "binomial" else mu

    def var(self):
        mu, f = self.mu, self.family
        if f in ("normal", "studentt"):  # Student-t in its unit-variance parameterization
            return torch.broadcast_to(self._p("sigma") ** 2, mu.shape)
        if f == "poisson":
            return mu
        if f == "bernoulli":
            return mu * (1.0 - mu)
        if f == "binomial":
            return self._p("trials") * mu * (1.0 - mu)
        if f == "negativebinomial":
            return mu + mu**2 / self._p("r")
        if f == "gamma":
            return mu**2 / self._p("phi")
        raise ValueError(f"unknown family {f}")

    def std(self):
        return torch.sqrt(self.var())

    def logpdf(self, y):
        """Pointwise log p(yᵢ | ηᵢ), the likelihood's closed forms."""
        return self._lik(y)._pointwise_eta(self.eta)

    def sample(self, generator: torch.Generator):
        mu, f, gen = self.mu, self.family, generator
        if f == "normal":
            return mu + self._p("sigma") * torch.randn(mu.shape, generator=gen, dtype=mu.dtype, device=mu.device)
        if f == "poisson":
            return torch.poisson(mu, generator=gen)
        if f == "bernoulli":
            return torch.bernoulli(mu, generator=gen)
        if f == "binomial":
            n = torch.broadcast_to(self._p("trials"), mu.shape).contiguous()
            return torch.binomial(n, mu.contiguous(), generator=gen)
        if f == "negativebinomial":  # Gamma-Poisson mixture: λ ~ Gamma(r, μ/r), y ~ Poisson(λ)
            r = self._p("r")
            lam = torch._standard_gamma(torch.broadcast_to(r, mu.shape).contiguous(), generator=gen) * mu / r
            return torch.poisson(lam, generator=gen)
        if f == "gamma":
            phi = self._p("phi")
            return torch._standard_gamma(torch.broadcast_to(phi, mu.shape).contiguous(), generator=gen) * mu / phi
        if f == "studentt":  # t_ν = z / sqrt(χ²_ν / ν), χ²_ν = 2 Gamma(ν/2)
            sigma, nu = self._p("sigma"), self._p("nu")
            z = torch.randn(mu.shape, generator=gen, dtype=mu.dtype, device=mu.device)
            g = torch._standard_gamma(torch.broadcast_to(nu / 2, mu.shape).contiguous(), generator=gen)
            return mu + sigma * torch.sqrt((nu - 2.0) / nu) * z / torch.sqrt(2.0 * g / nu)
        raise ValueError(f"unknown family {f}")


def conditional_distribution(obs_model, x, **params):
    """Predictive distribution of y given latent x under `obs_model`:
    ExponentialFamily evaluates the inverse link at η = x[indices] (+ offset);
    LinearlyTransformed forwards η = Ax + b to its base; NonlinearLeastSquares
    returns Normal(f(x), σ)."""
    return obs_model.conditional_distribution(x, **params)


# ---- factory ---------------------------------------------------------------

_FAMILY_ALIASES = {
    "normal": "normal",
    "gaussian": "normal",
    "poisson": "poisson",
    "bernoulli": "bernoulli",
    "binomial": "binomial",
    "negativebinomial": "negativebinomial",
    "negbin": "negativebinomial",
    "gamma": "gamma",
    "studentt": "studentt",
    "tdist": "studentt",
}

_FAMILY_PARAMS = {
    "normal": ("sigma",),
    "poisson": (),
    "bernoulli": (),
    "binomial": (),
    "negativebinomial": ("r",),
    "gamma": ("phi",),
    "studentt": ("sigma", "nu"),
}


def _tensor(v):
    return as_tensor(v)


class ExponentialFamily(ObservationModel):
    """``ExponentialFamily('poisson')(y)`` → Poisson likelihood with log link.

    kwarg aliases: pass e.g. ``sigma='obs_sigma'`` to rename a family
    parameter for the θ interface."""

    def __init__(self, family: str, link: str | None = None, indices=None, **aliases):
        family = _FAMILY_ALIASES[family.lower()]
        self.family = family
        self.link = link if link is not None else _CANONICAL[family]
        if self.link not in _LINKS:
            raise ValueError(f"unknown link {self.link}")
        self.indices = None if indices is None else as_tensor(indices, dtype=torch.long)
        for k in aliases:
            if k not in _FAMILY_PARAMS[family]:
                raise ValueError(f"unknown parameter alias {k} for family {family}")
        self.aliases = aliases

    @property
    def hyperparameters(self):
        return tuple(self.aliases.get(p, p) for p in _FAMILY_PARAMS[self.family])

    def conditional_distribution(self, x, **theta) -> Predictive:
        """Predictive p(y | x): η = x[indices] (+ offset), μ = g⁻¹(η)."""
        params = {}
        for p in _FAMILY_PARAMS[self.family]:
            outer = self.aliases.get(p, p)
            if outer not in theta:
                raise ValueError(f"missing family parameter: {outer}")
            params[p] = _tensor(theta[outer])
        if self.family == "binomial":
            if "trials" not in theta:
                raise ValueError("binomial predictive requires trials=")
            params["trials"] = _tensor(theta["trials"])
        eta = as_tensor(x)
        if self.indices is not None:
            eta = eta[..., self.indices.to(eta.device)]
        offset = theta.get("offset")
        if offset is not None:
            if self.link != "log":
                raise ValueError("offset only supported with log link")
            eta = eta + _tensor(offset)
        return Predictive(eta=eta, params=params, family=self.family, link=self.link)

    def __call__(self, y, **theta) -> EFLikelihood:
        fam = self.family
        params = {}
        for p in _FAMILY_PARAMS[fam]:
            outer = self.aliases.get(p, p)
            if outer not in theta:
                raise ValueError(f"missing family parameter: {outer}")
            params[p] = _tensor(theta[outer])
        offset = None
        if fam in ("poisson", "negativebinomial"):
            box = PoissonObservations if fam == "poisson" else NegativeBinomialObservations
            if isinstance(y, box):
                offset, y = y.logexposure, y.counts
            elif "offset" in theta:
                offset = _tensor(theta["offset"])
        elif fam == "binomial":
            if isinstance(y, BinomialObservations):
                params["trials"] = _tensor(y.trials)
                y = y.successes
            elif "trials" in theta:
                params["trials"] = _tensor(theta["trials"])
            else:
                raise ValueError("binomial requires BinomialObservations or trials=")
        if offset is not None and self.link != "log":
            raise ValueError("offset only supported with log link")
        y = _tensor(y)
        indices = None if self.indices is None else self.indices.to(y.device)
        return EFLikelihood(y=y, params=params, offset=offset, indices=indices, family=fam, link=self.link)
