"""Laplace gaussian approximation, batched over chains.

Counterpart of ``tpu_gmrf.inference.gaussian_approximation`` for GMRF,
`ConstrainedGMRF` and non-Gaussian `LatentPrior` priors and any observation
likelihood. Newton with a backtracking line search (α ← √α on accept,
α ← 0.1α on shrink, force-accept when α‖step‖∞ < tol/1000), convergence on
the Newton decrement or the mean change, and an immediate exit on a
non-finite iterate. A constrained prior's Newton steps are projected onto
Ax = 0 (the KKT step, ``_project_step``), from the prior's constrained
mean, and the result is the constrained posterior. A Normal likelihood
with the identity link and no offset on an unconstrained prior takes the
conjugate shortcut through `linear_condition`, seen directly or through a
linearly transformed likelihood (η = A x + b).

The reference gets per-chain convergence from ``vmap`` of ``while_loop``:
a converged chain's carry is frozen. Here the loop is written out over a
leading chain axis (``_newton_loop``): it runs until every chain has
converged or ``max_iter`` is reached, and a chain that has converged (or
gone non-finite) keeps its x and α. The line search is masked the same way.

Differentiation splits at the mode: `NewtonMode` runs the loop without
autograd, and its backward is the implicit-function rule of the reference
(``_newton_mode_jvp``): one refactorization of Q_post(x*), one solve
v = Q_post⁻¹ x̄, and the input cotangents from the score
Q_p (x* − μ_p) − ∇loglik(x*) pulled back with −v (`_ScorePullback`, at x*
held fixed). Under constraints the reference's KKT tangent rule projects
the tangent; its map M = S − SAᵀ(ASAᵀ)⁻¹AS (S = Q_post⁻¹) is symmetric, so
the backward is v = M x̄: the same solve, then the same projection as a
Newton step. A non-Gaussian prior takes `NewtonModeNL` (the reference's
``_newton_mode_nl``): the prior is re-linearized at every iterate
(``local_quadratic``), the line search's merit is the exact log-density,
and the backward pulls the score −∇log p(x*) − ∇loglik(x*) back with −v to
the prior's θ tensors and the likelihood's. Both backwards build their
graph when asked (``create_graph=True``): the factorization, the solve and
the pullback are differentiable, and x* is the Function's own output, so a
second derivative reaches the IFT rule again, as the reference's
``custom_jvp`` composes to any order. Each has a ``jvp`` too (forward mode):
ẋ = −M (∂score/∂inputs · input tangents).
The loop and its backwards use
only ``factorize`` and the factor's ``solve``, so they run unchanged on the
tridiagonal (K1, K2), dense (K9, K10) and supernodal (K5-K8) backends.
Q_p − H is formed on the union pattern by ``sp_add`` (K5, its plan cached
per pair of patterns, so per pattern and not per iterate); where H's
pattern lies inside Q_p's (a diagonal H, or a linearly transformed H whose
rows touch only Q_p's neighbourhoods) the union is Q_p's pattern, so one
supernodal plan serves the prior and every posterior.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constrained import ConstrainedGMRF, _cho_solve, _times
from ..gmrf import GMRF
from ..kernels import csr_spmv
from ..observations.base import ObservationLikelihood
from .._device import default_device
from ..models.nongaussian import LatentPrior
from ..observations.exponential_family import EFLikelihood
from ..observations.linearly_transformed import LinearlyTransformedLikelihood
from ..solvers.base import SolverSpec, factorize, no_double_backward
from ..sparse.matrix import SparseMatrix, _csr, spdiag

__all__ = ["gaussian_approximation", "GAOptions", "NewtonMode", "NewtonModeNL"]


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
    if obs_lik.hessian_kind == "diag":
        return spdiag(obs_lik.loghessian_diag(x))
    return obs_lik.loghessian(x)


def _posterior_pair(Q_p: SparseMatrix, H: SparseMatrix) -> SparseMatrix:
    """Q_prior − H on the fixed union pattern."""
    return Q_p - H


def _project_step(step, factor, A):
    """Remove the constraint-normal component: step ← step − Ã(AÃᵀ)⁻¹A·step,
    Ãᵀ = Q_post⁻¹Aᵀ by the iterate's factor, per chain."""
    m, n = A.shape
    At_T = factor.solve(A.T.expand(step.shape[:-1] + (n, m)).contiguous())
    L_c = torch.linalg.cholesky(A @ At_T)
    return step - _times(At_T, _cho_solve(L_c, step @ A.T))


def _where(mask, a, b):
    """Per-chain select: mask (...,) against a, b (..., n) or (...,)."""
    if a.ndim > mask.ndim:
        mask = mask[..., None]
    return torch.where(mask, a, b)


def _newton_loop(opts: GAOptions, x, linearize, merit, A=None):
    """Newton's iterations from x (…, n), per chain: `linearize(x)` gives
    (factor of Q_post(x), the negative score, merit(x)); `merit` is the
    line search's objective."""
    tiny_tol = opts.newton_dec_tol / 1000.0

    def line_search(x_k, step, alpha, obj_current):
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

    alpha = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    converged = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for it in range(opts.max_iter):
        active = ~converged
        if not bool(active.any()):
            break
        factor, neg_score, obj = linearize(x)
        step = factor.solve(neg_score)
        if A is not None:
            step = _project_step(step, factor, A)
        if opts.adaptive_stepsize:
            x_new, alpha_new = line_search(x, step, alpha, obj)
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


def _newton_mode_impl(opts: GAOptions, Q_p: SparseMatrix, mu_p, obs_lik, x0, A=None):
    h = Q_p.matvec(mu_p)

    def merit(x, xQx=None):
        xQx = Q_p.quad(x) if xQx is None else xQx
        return 0.5 * xQx - (h * x).sum(-1) - obs_lik.loglik(x)

    def linearize(x):
        H_k = _loghessian(obs_lik, x)
        g_l = obs_lik.loggrad(x)
        factor = factorize(_posterior_pair(Q_p, H_k), opts.inner_solver)
        # Q_p x for the score and xᵀQ_p x for the merit at x, from one K4 call (the loop runs without autograd)
        xb = x.reshape(-1, x.shape[-1]).contiguous()
        Qx, xQx = csr_spmv(*_csr(Q_p.pattern, x.device), Q_p.data.contiguous(), xb, quad=True)
        Qx, xQx = Qx.reshape(x.shape), xQx.reshape(x.shape[:-1])
        return factor, (Qx - h) - g_l, merit(x, xQx)

    return _newton_loop(opts, x0, linearize, merit, A)


class _ScorePullback(torch.autograd.Function):
    """(∂score/∂inputs)ᵀ w at x held fixed: the IFT rule's input cotangents,
    as a function of w, x and the inputs that is differentiable once more.

    apply(score, needs, w, x, *inputs), `score(x, inputs)` the Newton score,
    `needs` which inputs get a cotangent; returns one per needed input (zero
    where the score does not depend on it). Both passes run autograd on
    detached copies, so x is held fixed in the first derivative (its own
    derivative reaches the mode's Function again, through x's graph) and the
    mixed second derivatives of ⟨w, score⟩ make the backward."""

    @staticmethod
    def forward(ctx, score, needs, w, x, *inputs):
        ctx.score, ctx.needs = score, needs
        ctx.save_for_backward(w, x, *inputs)
        with torch.enable_grad():
            leaves = _leaves(inputs, needs)
            wanted = [t for t, need in zip(leaves, needs) if need]
            got = torch.autograd.grad(score(x.detach(), leaves), wanted, grad_outputs=w, allow_unused=True)
        return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(got, wanted))

    @staticmethod
    def backward(ctx, *gouts):
        no_double_backward("the Laplace mode's second derivative")
        w, x, *inputs = ctx.saved_tensors
        with torch.enable_grad():
            wl, xl = w.detach().requires_grad_(), x.detach().requires_grad_()
            leaves = _leaves(inputs, ctx.needs)
            wanted = [t for t, need in zip(leaves, ctx.needs) if need]
            got = torch.autograd.grad(ctx.score(xl, leaves), wanted, grad_outputs=wl, create_graph=True,
                                      allow_unused=True)
            pairs = [(g, go) for g, go in zip(got, gouts) if g is not None and g.requires_grad and go is not None]
            res = [None] * (2 + len(wanted))
            if pairs:
                res = torch.autograd.grad([g for g, _ in pairs], [wl, xl, *wanted], [go for _, go in pairs],
                                          allow_unused=True)
        gw, gx, *gin = res
        it = iter(gin)
        return (None, None, gw, gx, *(next(it) if need else None for need in ctx.needs))


def _leaves(inputs, needs):
    return [t if t is None else t.detach().requires_grad_() if need else t.detach() for t, need in zip(inputs, needs)]


def _pull_back(score, needs, v, x_star, inputs) -> list:
    """The input cotangents (∂score/∂inputs)ᵀ(−v), None where not needed."""
    if not any(needs):
        return [None] * len(needs)
    got = _ScorePullback.apply(score, tuple(needs), -v, x_star, *inputs)
    got = iter(got if isinstance(got, tuple) else (got,))
    return [next(got) if need else None for need in needs]


def _mode_tangent(score, factor, A, x_star, inputs, tangents) -> torch.Tensor:
    """ẋ = −M (∂score/∂inputs · u) for the input tangents u (None: none):
    J u as the derivative in w of ⟨(∂score/∂inputs)ᵀ w, u⟩."""
    needs = [u is not None for u in tangents]
    if not any(needs):
        return torch.zeros_like(x_star)
    with torch.enable_grad():
        leaves = _leaves(inputs, needs)
        s = score(x_star.detach(), leaves)
        w = torch.zeros_like(s, requires_grad=True)
        wanted = [t for t, need in zip(leaves, needs) if need]
        got = torch.autograd.grad(s, wanted, grad_outputs=w, create_graph=True, allow_unused=True)
        pairs = [(g, u) for g, u in zip(got, (u for u in tangents if u is not None)) if g is not None]
        if not pairs:
            return torch.zeros_like(x_star)
        (ju,) = torch.autograd.grad([g for g, _ in pairs], w, [u.expand_as(g) for g, u in pairs])
    with torch.no_grad():
        step = factor.solve(ju.contiguous())
        if A is not None:
            step = _project_step(step, factor, A)
    return -step


class NewtonMode(torch.autograd.Function):
    """x* = argmax of the Laplace objective, with the IFT backward and jvp.

    apply(opts, pattern, lik, A, x0, q_data, mu_p, *lik.tensors()); A (m, n)
    holds the constraints Ax = e (None for none), which x0 satisfies; A and
    x0 get no gradient (e is θ-independent in every model)."""

    @staticmethod
    def forward(ctx, opts, pattern, lik, A, x0, q_data, mu_p, *lik_tensors):
        Q_p = SparseMatrix(q_data, pattern)
        lik = lik.with_tensors(lik_tensors)
        batch = torch.broadcast_shapes(q_data.shape[:-1], mu_p.shape[:-1], x0.shape[:-1])
        x0 = x0.expand(batch + x0.shape[-1:]).contiguous()
        x_star = _newton_mode_impl(opts, Q_p, mu_p, lik, x0, A)
        # the likelihood's tensors go through save_for_backward, not ctx
        ctx.opts, ctx.pattern, ctx.A = opts, pattern, A
        ctx.lik = lik.with_tensors([None] * len(lik_tensors))
        ctx.save_for_backward(x_star, q_data, mu_p, *lik_tensors)
        ctx.save_for_forward(x_star, q_data, mu_p, *lik_tensors)
        return x_star

    @staticmethod
    def _score(ctx):
        def score(x, ts):
            return SparseMatrix(ts[0], ctx.pattern).matvec(x - ts[1]) - ctx.lik.with_tensors(ts[2:]).loggrad(x)

        return score

    @staticmethod
    def _factor(ctx, x_star, q_data, lik_tensors):
        """The factor of Q_post(x*), on the graph of its inputs when grad mode is on."""
        lik = ctx.lik.with_tensors(lik_tensors)
        Q_p = SparseMatrix(q_data, ctx.pattern)
        return factorize(_posterior_pair(Q_p, _loghessian(lik, x_star)), ctx.opts.inner_solver)

    @staticmethod
    def backward(ctx, gx):
        x_star, q_data, mu_p, *lik_tensors = ctx.saved_tensors
        # 1-2: refactorize Q_post(x*) and solve v = Q_post⁻¹ x̄, KKT-projected under constraints
        factor = NewtonMode._factor(ctx, x_star, q_data, lik_tensors)
        v = factor.solve(gx.expand(x_star.shape).contiguous())
        if ctx.A is not None:
            v = _project_step(v, factor, ctx.A)
        # 3: input cotangents = (∂score/∂inputs)ᵀ (−v)
        grads = _pull_back(NewtonMode._score(ctx), ctx.needs_input_grad[5:], v, x_star,
                           [q_data, mu_p, *lik_tensors])
        return (None, None, None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _opts, _pattern, _lik, _A, _x0, *tangents):
        x_star, q_data, mu_p, *lik_tensors = ctx.saved_tensors
        with torch.no_grad():
            factor = NewtonMode._factor(ctx, x_star, q_data, lik_tensors)
        return _mode_tangent(NewtonMode._score(ctx), factor, ctx.A, x_star, [q_data, mu_p, *lik_tensors],
                             tangents)


# ---- non-Gaussian latent priors (iterated re-linearization, TMB-style) -----


def _newton_mode_nl_impl(opts: GAOptions, prior, obs_lik, x0):
    """Newton with the prior re-linearized at every iterate (reference
    `_prior_local`, src/latent_models/local_quadratic.jl:100-140); the line
    search's merit is the exact log-density."""

    def merit(x):
        return -prior.log_density(x) - obs_lik.loglik(x)

    def linearize(x):
        Q_p, h = prior.local_quadratic(x)
        H_k = _loghessian(obs_lik, x)
        g_l = obs_lik.loggrad(x)
        factor = factorize(_posterior_pair(Q_p, H_k), opts.inner_solver)
        return factor, (Q_p.matvec(x) - h) - g_l, merit(x)

    batch = torch.broadcast_shapes(x0.shape[:-1], merit(x0).shape)
    return _newton_loop(opts, x0.expand(batch + x0.shape[-1:]).contiguous(), linearize, merit)


class NewtonModeNL(torch.autograd.Function):
    """x* of a non-Gaussian `LatentPrior` with the IFT backward and jvp.

    apply(opts, prior, lik, x0, k, *prior.tensors(), *lik.tensors()), k the
    number of prior tensors; x0 gets no gradient (the mode does not depend
    on the seed)."""

    @staticmethod
    def forward(ctx, opts, prior, lik, x0, k, *ts):
        prior, lik = prior.with_tensors(ts[:k]), lik.with_tensors(ts[k:])
        x_star = _newton_mode_nl_impl(opts, prior, lik, x0)
        # the tensors go through save_for_backward, not ctx
        ctx.opts, ctx.k = opts, k
        ctx.prior, ctx.lik = prior.with_tensors([None] * k), lik.with_tensors([None] * (len(ts) - k))
        ctx.save_for_backward(x_star, *ts)
        ctx.save_for_forward(x_star, *ts)
        return x_star

    @staticmethod
    def _score(ctx):
        def score(x, ts):
            k = ctx.k
            return -ctx.prior.with_tensors(ts[:k]).grad_log_density(x) - ctx.lik.with_tensors(ts[k:]).loggrad(x)

        return score

    @staticmethod
    def _factor(ctx, x_star, ts):
        """Q_post(x*) = −∇²log p(x*) − H(x*), factored; on the graph of its inputs when grad mode is on."""
        k = ctx.k
        Q_p, _ = ctx.prior.with_tensors(ts[:k]).local_quadratic(x_star)
        return factorize(_posterior_pair(Q_p, _loghessian(ctx.lik.with_tensors(ts[k:]), x_star)),
                         ctx.opts.inner_solver)

    @staticmethod
    def backward(ctx, gx):
        x_star, *ts = ctx.saved_tensors
        # 1-2: refactorize Q_post(x*) and solve v = Q_post⁻¹ x̄
        factor = NewtonModeNL._factor(ctx, x_star, ts)
        v = factor.solve(gx.expand(x_star.shape).contiguous())
        # 3: input cotangents = (∂score/∂inputs)ᵀ (−v), score = −∇log p(x*) − ∇loglik(x*)
        grads = _pull_back(NewtonModeNL._score(ctx), ctx.needs_input_grad[5:], v, x_star, ts)
        return (None, None, None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _opts, _prior, _lik, _x0, _k, *tangents):
        x_star, *ts = ctx.saved_tensors
        with torch.no_grad():
            factor = NewtonModeNL._factor(ctx, x_star, ts)
        return _mode_tangent(NewtonModeNL._score(ctx), factor, None, x_star, ts, tangents)


def _like(tensors):
    """(dtype, device) of the first floating tensor of `tensors`, else the defaults."""
    for t in tensors:
        if torch.is_tensor(t) and t.is_floating_point():
            return t.dtype, t.device
    return torch.get_default_dtype(), default_device()


def _is_conjugate_normal(obs_lik) -> bool:
    return (
        isinstance(obs_lik, EFLikelihood)
        and obs_lik.family == "normal"
        and obs_lik.link == "identity"
        and obs_lik.offset is None
    )


def _conjugate(base: GMRF, obs_lik: EFLikelihood, solver, A=None, b=None):
    """The conjugate shortcut: y = x[indices] + ε or y = A x + b + ε,
    ε ~ N(0, σ²I), by `linear_condition`; σ scalar or (B,), one per chain
    (a dense A takes one GMRF)."""
    from .linear_condition import linear_condition

    sigma = torch.as_tensor(obs_lik.params["sigma"], dtype=base.dtype, device=base.Q.device)
    prec = (1.0 / sigma**2)[..., None].expand(sigma.shape + obs_lik.y.shape[-1:])
    return linear_condition(base, y=obs_lik.y, Q_eps=spdiag(prec), A=A, b=b, indices=obs_lik.indices, solver=solver)


def gaussian_approximation(
    prior,
    obs_lik: ObservationLikelihood,
    x0=None,
    options: GAOptions = GAOptions(),
    solver: SolverSpec | None = None,
):
    """Gaussian (Laplace) approximation to p(x | y) for a GMRF,
    ConstrainedGMRF or non-Gaussian `LatentPrior` prior (batched over
    chains) and any observation likelihood; differentiable w.r.t. the
    prior's data and mean (θ for a LatentPrior) and the likelihood's
    tensors through `NewtonMode` / `NewtonModeNL` (the conjugate shortcut
    through `linear_condition`)."""
    if isinstance(prior, LatentPrior):
        solver = solver if solver is not None else SolverSpec()
        pt = prior.tensors()
        if x0 is None:
            dtype, dev = _like(pt + obs_lik.tensors())
            x0 = torch.zeros(prior.n, dtype=dtype, device=dev)
        else:
            x0 = torch.as_tensor(x0, device=_like(pt)[1])
        x_star = NewtonModeNL.apply(options, prior, obs_lik, x0.detach(), len(pt), *pt, *obs_lik.tensors())
        Q_p, _ = prior.local_quadratic(x_star)
        return GMRF.from_precision(x_star, _posterior_pair(Q_p, _loghessian(obs_lik, x_star)), solver)
    if not isinstance(prior, (GMRF, ConstrainedGMRF)):
        raise TypeError(f"unsupported prior type {type(prior).__name__}")
    constrained = isinstance(prior, ConstrainedGMRF)
    base = prior.base if constrained else prior
    solver = solver if solver is not None else base.solver
    if not constrained and _is_conjugate_normal(obs_lik):
        return _conjugate(base, obs_lik, solver)
    if (not constrained and isinstance(obs_lik, LinearlyTransformedLikelihood)
            and _is_conjugate_normal(obs_lik.base) and obs_lik.base.indices is None):
        return _conjugate(base, obs_lik.base, solver, A=obs_lik.A, b=obs_lik.b)
    x0 = prior.mean if x0 is None else torch.as_tensor(x0, dtype=base.dtype, device=base.Q.device)
    A = prior.A if constrained else None
    x_star = NewtonMode.apply(
        options, base.Q.pattern, obs_lik, A, x0.detach(), base.Q.data, base.mean, *obs_lik.tensors()
    )
    Q_post = _posterior_pair(base.Q, _loghessian(obs_lik, x_star))
    post = GMRF.from_precision(x_star, Q_post, solver)
    return ConstrainedGMRF.create(post, prior.A, prior.e) if constrained else post
