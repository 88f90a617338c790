"""The port's constrained Laplace approximation against the JAX package,
float64, on the same NumPy-seeded inputs: the KKT-projected Newton mode of
RW1, RW2, Besag and BYM2 priors with Poisson counts, the Laplace marginal
and its θ-gradient (the KKT IFT backward) against ``jax.grad`` of the
reference, unbatched and with B=3 chains; the conjugate Normal shortcut
through `linear_condition`, unbatched, batched and on an index subset.

Tolerances: the marginal and its θ-gradient 1e-8 relative. Both packages
run Newton to the same tight stop (`_OPTS`), so the comparison does not
depend on where a loose stop lands; what is left is the rounding of two
Cholesky factorizations of the same posteriors. The mode 1e-7: the line
search accepts a step only where the merit falls, and near the optimum the
merit (~1e2 here) moves by λ|Δx|², below its own rounding once |Δx| is
under ~√eps; each package then stops somewhere in that ball (RW2 at τ=8
reads 3.6e-8 apart with this stop and with a 1000x tighter one; the value
and gradient, flat there to first order, still agree to 1e-8). The
constraint residual of the mode |A x* − e| ≤ 1e-10. The conjugate posteriors' means, variances and
log-densities 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.inference.gaussian_approximation import _project_step
from tpu_gmrf_torch.solvers.base import factorize

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
_OPTS = dict(max_iter=50, mean_change_tol=1e-10, newton_dec_tol=1e-14)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=requires_grad)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def grid_adjacency(m, n):
    idx = np.arange(m * n).reshape(n, m)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(m * n, m * n))
    return W + W.T


# name: (model factory, θ of one chain, θ of three chains)
CASES = {
    "rw1": (lambda M: M.RW1Model(40), {"tau": 1.5}, {"tau": [0.7, 1.5, 3.0]}),
    "rw2": (lambda M: M.RW2Model(30), {"tau": 2.0}, {"tau": [0.5, 2.0, 8.0]}),
    "besag": (lambda M: M.BesagModel(grid_adjacency(5, 4)), {"tau": 1.2}, {"tau": [0.6, 1.2, 2.5]}),
    "bym2": (lambda M: M.BYM2Model(grid_adjacency(3, 3)), {"tau": 1.5, "phi": 0.4},
             {"tau": [0.8, 1.5, 3.0], "phi": [0.2, 0.4, 0.7]}),
}
_CACHE: dict = {}


def _case(name):
    """Port model, reference model, Poisson counts, the jitted reference value-and-grad (once per module)."""
    if name not in _CACHE:
        factory, _, _ = CASES[name]
        tm, jm = factory(tg), factory(jg)
        y = np.random.default_rng(len(name)).poisson(1.5, tm.n).astype(np.float64)
        obs = jg.ExponentialFamily("poisson")
        opts = jg.GAOptions(**_OPTS)
        names = jm.hyperparameters

        def f(th):
            return jg.laplace_marginal(jm, obs, jnp.asarray(y), dict(zip(names, th)), options=opts)

        _CACHE[name] = (tm, jm, y, jax.jit(jax.value_and_grad(f)))
    return _CACHE[name]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_constrained_laplace_marginal_and_gradient_match_reference(name, batched):
    tm, jm, y, ref = _case(name)
    theta = CASES[name][2 if batched else 1]
    th = {k: _t(v, requires_grad=True) for k, v in theta.items()}
    v = tg.laplace_marginal(tm, tg.ExponentialFamily("poisson"), y, th, options=tg.GAOptions(**_OPTS))
    v.sum().backward()
    rows = np.stack([np.atleast_1d(theta[k]) for k in jm.hyperparameters], -1)
    for b, row in enumerate(rows):
        jv, jgrad = ref(jnp.asarray(row))
        got_v = v.detach()[b] if batched else v.detach()
        assert abs(float(got_v) / float(jv) - 1) <= 1e-8
        for i, k in enumerate(jm.hyperparameters):
            got_g = th[k].grad[b] if batched else th[k].grad
            assert abs(float(got_g) - float(jgrad[i])) <= 1e-8 * max(abs(float(jgrad[i])), 1.0)


@pytest.mark.parametrize("name", ["rw2", "bym2"])
def test_constrained_mode_matches_reference_and_keeps_the_constraint(name):
    tm, jm, y, _ = _case(name)
    theta = CASES[name][2]
    prior = tm(**{k: _t(v) for k, v in theta.items()})
    post = tg.gaussian_approximation(prior, tg.ExponentialFamily("poisson")(_t(y)), options=tg.GAOptions(**_OPTS))
    assert isinstance(post, tg.ConstrainedGMRF) and post.mean.shape == (3, tm.n)
    A, e = tm.constraints()
    assert np.abs(post.mean.numpy() @ A.T - e).max() <= 1e-10
    for b in range(3):
        jp = jm(**{k: jnp.asarray(v[b]) for k, v in theta.items()})
        jpost = jg.gaussian_approximation(jp, jg.ExponentialFamily("poisson")(jnp.asarray(y)),
                                          options=jg.GAOptions(**_OPTS))
        assert _rel(post.mean[b], jpost.mean) <= 1e-7
        x = np.asarray(jpost.mean)
        assert abs(float(post.logpdf(_t(x))[b]) / float(jpost.logpdf(jnp.asarray(x))) - 1) <= 1e-8


def test_kkt_projection_is_the_symmetric_constrained_inverse():
    # v = M x̄ with M = S − SAᵀ(ASAᵀ)⁻¹AS: A v = 0, and M is symmetric (uᵀ M w = wᵀ M u)
    rng = np.random.default_rng(4)
    Q = tg.RW2Model(20).precision(tau=_t([1.0, 3.0]))
    A = _t(np.stack([np.ones(20), np.arange(20.0)]))
    f = factorize(Q)
    u, w = _t(rng.normal(size=(2, 20))), _t(rng.normal(size=(2, 20)))
    Mu, Mw = _project_step(f.solve(u), f, A), _project_step(f.solve(w), f, A)
    assert float((Mu @ A.T).abs().max()) <= 1e-9 * float(Mu.abs().max())
    assert float(((u * Mw).sum(-1) - (w * Mu).sum(-1)).abs().max()) <= 1e-10 * float((u * Mw).sum(-1).abs().max())


def _conjugate_inputs(n=30, m=None):
    rng = np.random.default_rng(17)
    idx = None if m is None else np.sort(rng.choice(n, m, replace=False))
    y = rng.normal(size=n if m is None else m)
    return idx, y


@pytest.mark.parametrize("subset", [False, True])
def test_conjugate_shortcut_matches_reference(subset):
    n = 30
    idx, y = _conjugate_inputs(n, 12 if subset else None)
    taus, rhos, sigmas = np.array([2.0, 0.7, 5.0]), np.array([0.5, 0.9, -0.3]), np.array([0.7, 0.3, 1.4])
    tobs = tg.ExponentialFamily("normal", indices=idx)
    jobs = jg.ExponentialFamily("normal", indices=idx)
    x = np.random.default_rng(2).normal(size=n)
    # one GMRF, then three chains with σ per chain
    one = tg.gaussian_approximation(tg.AR1Model(n)(tau=_t(2.0), rho=_t(0.5)), tobs(_t(y), sigma=_t(0.7)))
    batch = tg.gaussian_approximation(tg.AR1Model(n)(tau=_t(taus), rho=_t(rhos)), tobs(_t(y), sigma=_t(sigmas)))
    assert isinstance(one, tg.GMRF) and batch.mean.shape == (3, n)
    for b, post in [(0, one)] + [(b, batch) for b in range(3)]:
        ref = jg.gaussian_approximation(jg.AR1Model(n)(tau=taus[b], rho=rhos[b]), jobs(jnp.asarray(y), sigma=sigmas[b]))
        mean = post.mean if post is one else post.mean[b]
        var = post.var() if post is one else post.var()[b]
        lp = post.logpdf(_t(x)) if post is one else post.logpdf(_t(x))[b]
        assert _rel(mean, ref.mean) <= 1e-10 and _rel(var, ref.var()) <= 1e-10
        assert abs(float(lp) / float(ref.logpdf(jnp.asarray(x))) - 1) <= 1e-10


def test_conjugate_marginal_gradient_matches_reference():
    n = 30
    _, y = _conjugate_inputs(n)
    tau, sigma = _t([2.0, 0.7], requires_grad=True), _t([0.7, 0.4], requires_grad=True)
    v = tg.laplace_marginal(tg.AR1Model(n), tg.ExponentialFamily("normal"), y,
                            {"tau": tau, "rho": _t([0.5, 0.8]), "sigma": sigma})
    v.sum().backward()
    model, obs = jg.AR1Model(n), jg.ExponentialFamily("normal")

    def f(th):
        return jg.laplace_marginal(model, obs, jnp.asarray(y), {"tau": th[0], "rho": th[1], "sigma": th[2]})

    jv, jgrad = jax.jit(jax.vmap(jax.value_and_grad(f)))(jnp.asarray([[2.0, 0.5, 0.7], [0.7, 0.8, 0.4]]))
    assert _rel(v.detach(), jv) <= 1e-10
    assert _rel(tau.grad, jgrad[:, 0]) <= 1e-8 and _rel(sigma.grad, jgrad[:, 2]) <= 1e-8


def test_constrained_normal_likelihood_takes_newton_and_matches_reference():
    # the shortcut is for unconstrained priors only: a sum-to-zero IID prior with Normal data goes through the
    # KKT Newton mode, as in the reference
    n = 10
    y = np.random.default_rng(42).normal(size=n)
    post = tg.gaussian_approximation(tg.IIDModel(n, constraint="sumtozero")(tau=_t(1.0)),
                                     tg.ExponentialFamily("normal")(_t(y), sigma=_t(0.5)),
                                     options=tg.GAOptions(**_OPTS))
    ref = jg.gaussian_approximation(jg.IIDModel(n, constraint="sumtozero")(tau=1.0),
                                    jg.ExponentialFamily("normal")(jnp.asarray(y), sigma=0.5),
                                    options=jg.GAOptions(**_OPTS))
    assert isinstance(post, tg.ConstrainedGMRF)
    assert _rel(post.mean, ref.mean) <= 1e-10 and _rel(post.var(), ref.var()) <= 1e-10
    lp = tg.marginal_loglikelihood(tg.IIDModel(n, constraint="sumtozero")(tau=_t(1.0)),
                                   tg.ExponentialFamily("normal")(_t(y), sigma=_t(0.5)), posterior=post)
    jlp = jg.marginal_loglikelihood(jg.IIDModel(n, constraint="sumtozero")(tau=1.0),
                                    jg.ExponentialFamily("normal")(jnp.asarray(y), sigma=0.5), posterior=ref)
    assert abs(float(lp) / float(jlp) - 1) <= 1e-10
