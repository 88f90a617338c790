"""Exponential-family observation models.

Counterpart of ``tpu_gmrf.observations.exponential_family``: families
Normal/Poisson/Bernoulli/Binomial/NegativeBinomial/Gamma/StudentT with the
canonical-link closed forms for the gradient and Hessian. Non-canonical
links use per-element autodiff in the reference and raise here until that
is ported. Supports observation-index subsets (`indices`) and log-exposure
offsets for Poisson/NegBin.

Batching: x is (n,) or (B, n). Family hyperparameters (sigma, r, phi, nu)
are scalars or (B,), one per chain; y, offset and binomial trials are per
observation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .._device import as_tensor
from .base import ObservationLikelihood, ObservationModel

__all__ = [
    "ExponentialFamily",
    "PoissonObservations",
    "BinomialObservations",
    "NegativeBinomialObservations",
    "EFLikelihood",
]

_LOG2PI = 1.8378770664093453

_INVLINKS = {"identity": lambda eta: eta, "log": torch.exp, "logit": torch.sigmoid}

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
        return _INVLINKS[self.link](eta)

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
        """(dℓ/dη, d²ℓ/dη²) per observation, canonical-link closed forms."""
        if not self.canonical:
            raise NotImplementedError(
                f"{self.family} with non-canonical link {self.link!r} needs per-element "
                "autodiff (non-canonical links), not ported yet"
            )
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
        if self.link not in _INVLINKS:
            raise ValueError(f"unknown link {self.link}")
        self.indices = None if indices is None else as_tensor(indices, dtype=torch.long)
        for k in aliases:
            if k not in _FAMILY_PARAMS[family]:
                raise ValueError(f"unknown parameter alias {k} for family {family}")
        self.aliases = aliases

    @property
    def hyperparameters(self):
        return tuple(self.aliases.get(p, p) for p in _FAMILY_PARAMS[self.family])

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
