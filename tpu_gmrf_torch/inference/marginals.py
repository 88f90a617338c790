"""Posterior linear-predictor marginals and pointwise model diagnostics.

Counterpart of ``tpu_gmrf.inference.marginals`` (reference
src/linear_predictor_marginals.jl:1-195 and
src/observation_models/observation_likelihood.jl:106-230): each
observation's linear-predictor mean and variance (with the hard-constraint
correction), and WAIC and CPO from posterior draws. `waic` and
`conditional_predictive_ordinates` take a ``torch.Generator`` where the
reference takes a key. `linear_predictor_marginals` has the
exponential-family, linearly transformed and composite branches; the
variance of Aη (`_row_diag_ASigmaAt`, with its plan `_pair_plan` and its
fallback `_inverse_entries`) takes one GMRF.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constrained import ConstrainedGMRF
from ..kernels import SegPlan, gather_segsum
from ..observations.composite import CompositeLikelihood
from ..observations.exponential_family import EFLikelihood
from ..observations.linearly_transformed import LinearlyTransformedLikelihood
from ..sparse.matrix import SparseMatrix
from ..sparse.pattern import SparsePattern

__all__ = ["linear_predictor_marginals", "waic", "conditional_predictive_ordinates"]


_PAIR_PLAN_CACHE: dict = {}


def _pair_plan(pat):
    """Host plan of the per-row quadratic form v_p = Σ_{j,k∈row p} A_pj Σ_jk A_pk:
    for every row of A, all (j, k) column pairs as flat arrays (row_of_pair,
    va, vb, jj, kk), the deduplicated Σ-entry pattern, the map onto it, and
    the K5 plan that sums the pairs into their rows. Cached per pattern."""
    plan = _PAIR_PLAN_CACHE.get(pat)
    if plan is not None:
        return plan
    indptr, cols = pat.indptr, pat.cols
    m, n = pat.shape
    c = np.diff(indptr).astype(np.int64)
    P = c * c
    total = int(P.sum())
    row_of_pair = np.repeat(np.arange(m, dtype=np.int64), P)
    start = np.repeat(np.cumsum(P) - P, P)
    t = np.arange(total, dtype=np.int64) - start
    cw = np.maximum(np.repeat(c, P), 1)
    base = np.repeat(indptr[:-1].astype(np.int64), P)
    va = base + t // cw
    vb = base + t % cw
    jj = cols[va].astype(np.int64)
    kk = cols[vb].astype(np.int64)
    key = jj * n + kk
    uniq, inv = np.unique(key, return_inverse=True)
    sig_pat = SparsePattern(uniq // n, uniq % n, (n, n))
    seg = SegPlan.grouped(row_of_pair, np.arange(total), m)
    plan = (row_of_pair, va, vb, jj, kk, sig_pat, inv.reshape(-1), seg)
    _PAIR_PLAN_CACHE[pat] = plan
    return plan


def _row_diag_ASigmaAt(A, ga):
    """diag(A Σ Aᵀ) through the posterior's inverse at the entries it needs.
    For a SparseMatrix A the Σ entries come from one selected inversion on
    the deduplicated (j, k) pattern, the pairs summed per row on K5; pairs
    outside the factor's envelope fall back to identity-column solves. A
    dense A uses the solve Σ Aᵀ. One GMRF (or ConstrainedGMRF)."""
    base = ga.base if isinstance(ga, ConstrainedGMRF) else ga
    dev = base.Q.device
    if isinstance(A, SparseMatrix):
        row_of_pair, va, vb, jj, kk, sig_pat, inv, seg = _pair_plan(A.pattern)
        try:
            Sig_uniq = base.factor.selinv(sig_pat).data
        except (ValueError, NotImplementedError):
            Sig_uniq = _inverse_entries(base, sig_pat.rows, sig_pat.cols)
        va, vb, inv = (torch.as_tensor(a, device=dev) for a in (va, vb, inv))
        prod = A.data[va] * A.data[vb] * Sig_uniq[inv]
        v = gather_segsum(seg, prod[None].contiguous())[0]
    else:
        A = torch.as_tensor(A, dtype=base.dtype, device=dev)
        Sig_rows = base.factor.solve(A.T.contiguous())  # (n, m) = Σ Aᵀ
        v = torch.sum(A * Sig_rows.T, 1)
    if isinstance(ga, ConstrainedGMRF):
        # subtract diag(A·Ã·L_c⁻ᵀ L_c⁻¹·Ãᵀ·Aᵀ)
        AAt_T = A.matvec(ga.A_tilde_T.T.contiguous()) if isinstance(A, SparseMatrix) else (A @ ga.A_tilde_T).T
        B = torch.linalg.solve_triangular(ga.L_c, AAt_T, upper=False)  # (m_c, m)
        v = v - torch.sum(B * B, 0)
    return torch.clamp_min(v, 0.0)


def _inverse_entries(base, jj, kk):
    """Σ entries at arbitrary (j, k) positions by identity-column solves; the
    fallback when (j, k) lies outside the factor's envelope."""
    jj, kk = np.array(jj), np.array(kk)
    uniq_cols, sel = np.unique(kk, return_inverse=True)
    dev = base.Q.device
    eye_cols = torch.zeros(base.n, len(uniq_cols), dtype=base.dtype, device=dev)
    eye_cols[torch.as_tensor(uniq_cols, device=dev), torch.arange(len(uniq_cols), device=dev)] = 1.0
    Sig_cols = base.factor.solve(eye_cols)  # (n, u)
    return Sig_cols[torch.as_tensor(jj, device=dev), torch.as_tensor(sel.reshape(-1), device=dev)]


def linear_predictor_marginals(ga, obs_lik):
    """(μ_η, v_η, eta_likelihood): the posterior mean and variance of each
    observation's linear predictor, and a likelihood re-indexed to take μ_η
    directly."""
    if isinstance(obs_lik, EFLikelihood):
        mu = ga.mean
        v = ga.var()
        if obs_lik.indices is None:
            return mu, v, obs_lik
        idx = obs_lik.indices
        return mu[..., idx], v[..., idx], dataclasses.replace(obs_lik, indices=None)
    if isinstance(obs_lik, LinearlyTransformedLikelihood):
        A = obs_lik.A
        mu_eta = A.matvec(ga.mean) if isinstance(A, SparseMatrix) else ga.mean @ A.mT
        if obs_lik.b is not None:
            mu_eta = mu_eta + obs_lik.b
        return mu_eta, _row_diag_ASigmaAt(A, ga), obs_lik.base
    if isinstance(obs_lik, CompositeLikelihood):
        parts = [linear_predictor_marginals(ga, c) for c in obs_lik.components]
        comps, off = [], 0
        for mu_c, _, lik in parts:
            m = mu_c.shape[-1]
            if isinstance(lik, EFLikelihood):
                lik = dataclasses.replace(lik, indices=torch.arange(off, off + m, device=mu_c.device))
            comps.append(lik)
            off += m
        mu = torch.cat([p[0] for p in parts], -1)
        return mu, torch.cat([p[1] for p in parts], -1), CompositeLikelihood(components=tuple(comps))
    raise TypeError(f"unsupported likelihood type {type(obs_lik)}")


def _pointwise_draws(posterior, obs_lik, generator, num_samples: int):
    xs = posterior.sample(generator, (num_samples,))
    return obs_lik.pointwise_loglik(xs)  # (S, *batch, m)


def waic(posterior, obs_lik, generator: torch.Generator, num_samples: int = 200):
    """Watanabe-Akaike information criterion from posterior draws:
    elpd_i = log E[p(y_i|x)] − Var[log p(y_i|x)]; returns (waic, elpd, p_eff)."""
    lps = _pointwise_draws(posterior, obs_lik, generator, num_samples)
    lppd = torch.logsumexp(lps, 0) - math.log(num_samples)
    p_eff = torch.var(lps, 0, correction=1)
    elpd = torch.sum(lppd - p_eff, -1)
    return -2.0 * elpd, elpd, torch.sum(p_eff, -1)


def conditional_predictive_ordinates(posterior, obs_lik, generator: torch.Generator, num_samples: int = 200):
    """log CPO_i = −log E[1/p(y_i|x)] (harmonic-mean estimator)."""
    lps = _pointwise_draws(posterior, obs_lik, generator, num_samples)
    return math.log(num_samples) - torch.logsumexp(-lps, 0)
