"""Laplace gaussian approximation, batched over chains.

Counterpart of ``tpu_gmrf.inference.gaussian_approximation`` (unconstrained
GMRF priors). Newton with a backtracking line search (α ← √α on accept,
α ← 0.1α on shrink, force-accept when α‖step‖∞ < tol/1000), convergence on
the Newton decrement or the mean change, and an immediate exit on a
non-finite iterate.

The reference gets per-chain convergence from ``vmap`` of ``while_loop``:
a converged chain's carry is frozen. Here the loop is written out over a
leading chain axis: it runs until every chain has converged or ``max_iter``
is reached, and a chain that has converged (or gone non-finite) keeps its
x and α. The line search is masked the same way.

Differentiation splits at the mode: `NewtonMode` runs the loop without
autograd, and its backward is the implicit-function rule of the reference
(``_newton_mode_jvp``): one refactorization of Q_post(x*), one opaque
solve v = Q_post⁻¹ x̄, and the input cotangents from the score
Q_p (x* − μ_p) − ∇loglik(x*) pulled back with −v. The loop and its backward
use only ``factorize`` and the factor's ``solve``, so they run unchanged on
the tridiagonal (K1, K2) and the supernodal (K5-K8) backends. Q_p − H is
formed on the union pattern by ``sp_add`` (K5); for a pattern that holds
its diagonal (every GMRF precision here) that union is Q_p's own pattern,
so one supernodal plan serves the prior and every posterior.
"""

from __future__ import annotations

import dataclasses

import torch

from ..gmrf import GMRF
from ..observations.base import ObservationLikelihood
from ..observations.exponential_family import EFLikelihood
from ..solvers.base import SolverSpec, factorize, no_double_backward
from ..sparse.matrix import SparseMatrix, spdiag

__all__ = ["gaussian_approximation", "GAOptions", "NewtonMode"]


@dataclasses.dataclass(frozen=True)
class GAOptions:
    max_iter: int = 50
    mean_change_tol: float = 1e-4
    newton_dec_tol: float = 1e-5
    adaptive_stepsize: bool = True
    max_linesearch_iter: int = 10
    # per-iteration Newton diagnostics printed to stdout (syncs the device)
    verbose: bool = False
    inner_solver: SolverSpec = SolverSpec()


def _loghessian(obs_lik, x) -> SparseMatrix:
    # exponential families only: the Hessian is diagonal
    return spdiag(obs_lik.loghessian_diag(x))


def _posterior_pair(Q_p: SparseMatrix, H: SparseMatrix) -> SparseMatrix:
    """Q_prior − H on the fixed union pattern."""
    return Q_p - H


def _where(mask, a, b):
    """Per-chain select: mask (...,) against a, b (..., n) or (...,)."""
    if a.ndim > mask.ndim:
        mask = mask[..., None]
    return torch.where(mask, a, b)


def _newton_mode_impl(opts: GAOptions, Q_p: SparseMatrix, mu_p, obs_lik, x0):
    h = Q_p.matvec(mu_p)

    def merit(x):
        return 0.5 * Q_p.quad(x) - (h * x).sum(-1) - obs_lik.loglik(x)

    tiny_tol = opts.newton_dec_tol / 1000.0

    def line_search(x_k, step, alpha):
        obj_current = merit(x_k)
        inf_step = step.abs().amax(-1)
        alpha_cur, x_new, alpha_next = alpha, x_k, alpha
        # NaN merit at x_k: skip the search (the non-finite exit follows)
        accepted = ~torch.isfinite(obj_current)
        for _ in range(opts.max_linesearch_iter):
            if bool(accepted.all()):
                break
            run = ~accepted
            candidate = x_k - alpha_cur[..., None] * step
            good = merit(candidate) <= obj_current
            alpha_shrunk = alpha_cur * 0.1
            tiny = alpha_shrunk * inf_step < tiny_tol
            acc = good | tiny
            x_new = _where(run & acc, candidate, x_new)
            alpha_next = _where(
                run, torch.where(good, torch.sqrt(alpha_cur), torch.where(tiny, alpha_shrunk, alpha_next)),
                alpha_next,
            )
            alpha_cur = _where(run, alpha_shrunk, alpha_cur)
            accepted = accepted | (run & acc)
        x_new = _where(accepted, x_new, x_k - alpha_cur[..., None] * step)
        return x_new, _where(accepted, alpha_next, alpha_cur)

    x = x0
    alpha = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    converged = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for it in range(opts.max_iter):
        active = ~converged
        if not bool(active.any()):
            break
        H_k = _loghessian(obs_lik, x)
        g_l = obs_lik.loggrad(x)
        factor = factorize(_posterior_pair(Q_p, H_k), opts.inner_solver)
        neg_score = (Q_p.matvec(x) - h) - g_l
        step = factor.solve(neg_score)
        if opts.adaptive_stepsize:
            x_new, alpha_new = line_search(x, step, alpha)
        else:
            x_new, alpha_new = x - step, alpha
        newton_dec = (neg_score * step).sum(-1)
        mean_change = torch.linalg.vector_norm(x_new - x, dim=-1)
        rel_change = mean_change / torch.linalg.vector_norm(x, dim=-1).clamp_min(1e-10)
        conv = (
            (newton_dec < opts.newton_dec_tol)
            | (mean_change < opts.mean_change_tol)
            | (rel_change < opts.mean_change_tol)
            | ~torch.isfinite(newton_dec)
            | ~torch.isfinite(mean_change)
        )
        if opts.verbose:
            print(f"newton it={it} active={int(active.sum())} dec={newton_dec.tolist()} "
                  f"|dx|={mean_change.tolist()} alpha={alpha_new.tolist()}")
        x = _where(active, x_new, x)
        alpha = _where(active, alpha_new, alpha)
        converged = converged | (active & conv)
    return x


class NewtonMode(torch.autograd.Function):
    """x* = argmax of the Laplace objective, with the IFT backward.

    apply(opts, pattern, lik, x0, q_data, mu_p, *lik.tensors()); x0 gets no
    gradient."""

    @staticmethod
    def forward(ctx, opts, pattern, lik, x0, q_data, mu_p, *lik_tensors):
        Q_p = SparseMatrix(q_data, pattern)
        lik = lik.with_tensors(lik_tensors)
        batch = torch.broadcast_shapes(q_data.shape[:-1], mu_p.shape[:-1], x0.shape[:-1])
        x0 = x0.expand(batch + x0.shape[-1:]).contiguous()
        x_star = _newton_mode_impl(opts, Q_p, mu_p, lik, x0)
        # the likelihood's tensors go through save_for_backward, not ctx
        ctx.opts, ctx.pattern = opts, pattern
        ctx.lik = lik.with_tensors([None] * len(lik_tensors))
        ctx.save_for_backward(x_star, q_data, mu_p, *lik_tensors)
        return x_star

    @staticmethod
    def backward(ctx, gx):
        no_double_backward("the Laplace Newton mode")
        x_star, q_data, mu_p, *lik_tensors = ctx.saved_tensors
        lik = ctx.lik.with_tensors(lik_tensors)
        Q_p = SparseMatrix(q_data, ctx.pattern)
        # 1-2: refactorize Q_post(x*) and solve v = Q_post⁻¹ x̄ (opaque solve)
        factor = factorize(_posterior_pair(Q_p, _loghessian(lik, x_star)), ctx.opts.inner_solver)
        v = factor.solve(gx.expand(x_star.shape).contiguous())
        # 3: input cotangents = (∂score/∂inputs)ᵀ (−v)
        inputs = [q_data, mu_p, *lik_tensors]
        needs = ctx.needs_input_grad[4:]
        leaves = [t.detach().requires_grad_() if need else t for t, need in zip(inputs, needs)]
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = [None] * len(inputs)
        if wanted:
            with torch.enable_grad():
                lik_ = ctx.lik.with_tensors(leaves[2:])
                score = SparseMatrix(leaves[0], ctx.pattern).matvec(x_star - leaves[1]) - lik_.loggrad(x_star)
                got = iter(torch.autograd.grad(score, wanted, grad_outputs=-v, allow_unused=True))
            grads = [next(got) if need else None for need in needs]
        return (None, None, None, None, *grads)


def _is_conjugate_normal(obs_lik) -> bool:
    return (
        isinstance(obs_lik, EFLikelihood)
        and obs_lik.family == "normal"
        and obs_lik.link == "identity"
        and obs_lik.offset is None
    )


def gaussian_approximation(
    prior: GMRF,
    obs_lik: ObservationLikelihood,
    x0=None,
    options: GAOptions = GAOptions(),
    solver: SolverSpec | None = None,
) -> GMRF:
    """Gaussian (Laplace) approximation to p(x | y) for an unconstrained GMRF
    prior (batched over chains); differentiable w.r.t. the prior's data and
    mean and the likelihood's tensors through `NewtonMode`."""
    if not isinstance(prior, GMRF):
        raise NotImplementedError(
            "constrained and non-Gaussian (LatentPrior) priors are not ported yet (ROADMAP queue 1, item 12)"
        )
    if not isinstance(obs_lik, EFLikelihood):
        raise NotImplementedError(f"{type(obs_lik).__name__} is not ported yet (ROADMAP queue 1, item 15)")
    if _is_conjugate_normal(obs_lik):
        raise NotImplementedError(
            "the conjugate Normal short-circuit (linear_condition) is not ported yet (ROADMAP queue 1, item 12)"
        )
    solver = solver if solver is not None else prior.solver
    x0 = prior.mean if x0 is None else torch.as_tensor(x0, dtype=prior.dtype, device=prior.Q.device)
    x_star = NewtonMode.apply(
        options, prior.Q.pattern, obs_lik, x0.detach(), prior.Q.data, prior.mean, *obs_lik.tensors()
    )
    Q_post = _posterior_pair(prior.Q, _loghessian(obs_lik, x_star))
    return GMRF.from_precision(x_star, Q_post, solver)
