"""The port's Laplace-marginal slice (AR1 + exponential family, batched over
chains, through HMC) against the JAX package, float64, same NumPy inputs.

Tolerances and why:
- pattern, precision, likelihood terms: exact arithmetic up to op order,
  rtol 1e-12;
- GMRF logpdf/var and the Laplace mode: the scans differ in rounding only,
  rtol 1e-9;
- Laplace marginal value rtol 1e-7 and θ-gradient rtol 1e-5: both sides
  stop Newton at the same tolerances (1e-4 mean change, 1e-5 decrement),
  and rounding can move a chain's stop by one iteration;
- HMC trajectories: the marginal's tolerance carried through 3 leapfrog
  steps, rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf.observations import exponential_family as jobs
from tpu_gmrf.samplers import hmc as jhmc
from tpu_gmrf.samplers import transforms as jtr
from tpu_gmrf.sparse import pattern as jpat
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop
from tpu_gmrf_torch.inference.gaussian_approximation import _newton_mode_impl
from tpu_gmrf_torch.observations import exponential_family as tobs
from tpu_gmrf_torch.samplers import hmc as thmc
from tpu_gmrf_torch.samplers import transforms as ttr
from tpu_gmrf_torch.sparse import pattern as tpat

F64 = torch.float64


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _poisson_y(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(n)
    for i in range(1, n):
        x[i] = 0.7 * x[i - 1] + rng.normal() * np.sqrt(1 - 0.49)
    return rng.poisson(np.exp(np.clip(x, -3, 3))).astype(np.float64)


# ---- host pattern copy --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_pattern_copy_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 20
    keys = rng.choice(n * n, size=60, replace=False)
    keys = np.union1d(keys, np.arange(n) * (n + 1))  # with a full diagonal
    rng.shuffle(keys)
    rows, cols = keys // n, keys % n
    a, b = jpat.SparsePattern(rows, cols, (n, n)), tpat.SparsePattern(rows, cols, (n, n))
    for name in ("rows", "cols", "indptr", "sort_order", "transpose_perm", "diag_positions"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.is_symmetric == b.is_symmetric and a._digest == b._digest
    ja, jb = jpat.union_patterns(a, jpat.diag_pattern(n)), tpat.union_patterns(b, tpat.diag_pattern(n))
    np.testing.assert_array_equal(ja.rows, jb.rows)
    np.testing.assert_array_equal(ja.cols, jb.cols)
    for x, y in zip(jpat.spgemm_pattern(a, a)[1:], tpat.spgemm_pattern(b, b)[1:]):
        np.testing.assert_array_equal(x, y)


# ---- AR1 precision and GMRF ---------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_ar1_precision_matches_reference(batched):
    n = 17
    taus, rhos = np.array([0.7, 2.5, 1.0]), np.array([0.3, -0.8, 0.95])
    Q = tg.AR1Model(n).precision(_t(taus) if batched else _t(taus[0]), _t(rhos) if batched else _t(rhos[0]))
    jm = jg.AR1Model(n)
    ref = np.stack([np.asarray(jm.precision(tau=t, rho=r).data) for t, r in zip(taus, rhos)])
    np.testing.assert_array_equal(Q.pattern.rows, jm.precision(tau=1.0, rho=0.5).pattern.rows)
    np.testing.assert_allclose(Q.data.numpy(), ref if batched else ref[0], rtol=1e-12)


def test_gmrf_logpdf_var_sample_match_reference():
    n, B = 24, 3
    rng = np.random.default_rng(3)
    taus, rhos = np.array([0.5, 1.0, 4.0]), np.array([0.2, 0.7, -0.6])
    x = rng.normal(size=(B, n))
    g = tg.AR1Model(n)(tau=_t(taus), rho=_t(rhos))
    jm = jg.AR1Model(n)
    for b in range(B):
        jgm = jm(tau=taus[b], rho=rhos[b])
        np.testing.assert_allclose(g.logpdf(_t(x))[b].item(), float(jgm.logpdf(jnp.asarray(x[b]))), rtol=1e-9)
        np.testing.assert_allclose(g.var()[b].numpy(), np.asarray(jgm.var()), rtol=1e-9)
        np.testing.assert_allclose(g.factor.selinv(g.Q.pattern).data[b].numpy(),
                                   np.asarray(jgm.factor.selinv(jgm.Q.pattern).data), rtol=1e-9)
        np.testing.assert_allclose(g.gradlogpdf(_t(x))[b].numpy(), np.asarray(jgm.gradlogpdf(jnp.asarray(x[b]))),
                                   rtol=1e-9, atol=1e-12)
    # sampling is x = μ + L⁻ᵀ z: check the map with the same z, and the shape
    z = rng.normal(size=(B, n))
    gen = torch.Generator().manual_seed(0)
    assert g.sample(gen, (5,)).shape == (5, B, n)
    ref = np.stack([np.asarray(jm(tau=t, rho=r).factor.backward_solve(jnp.asarray(zz)))
                    for t, r, zz in zip(taus, rhos, z)])
    np.testing.assert_allclose(g.factor.backward_solve(_t(z)).numpy(), ref, rtol=1e-9, atol=1e-12)
    with pytest.raises(NotImplementedError):
        g.cov()


# ---- observation model --------------------------------------------------------

_FAMILIES = [
    ("normal", {"sigma": [0.5, 2.0]}),
    ("poisson", {}),
    ("bernoulli", {}),
    ("binomial", {}),
    ("negativebinomial", {"r": [1.5, 7.0]}),
    ("gamma", {"phi": [0.8, 3.0]}),
    ("studentt", {"sigma": [0.5, 1.5], "nu": [3.0, 9.0]}),
]


@pytest.mark.parametrize("family,params", _FAMILIES, ids=[f for f, _ in _FAMILIES])
def test_exponential_family_matches_reference(family, params):
    n, B = 12, 2
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.5, size=(B, n))
    y = {
        "normal": rng.normal(size=n), "studentt": rng.normal(size=n),
        "poisson": rng.poisson(2.0, n), "negativebinomial": rng.poisson(2.0, n),
        "bernoulli": rng.integers(0, 2, n), "binomial": rng.integers(0, 6, n),
        "gamma": rng.gamma(2.0, size=n),
    }[family].astype(np.float64)
    if family == "binomial":  # trials arrive with the data
        ty, jy = tobs.BinomialObservations(y, np.full(n, 5.0)), jobs.BinomialObservations(y, np.full(n, 5.0))
    else:
        ty = jy = y
    tl = tg.ExponentialFamily(family)(ty, **{k: _t(v) for k, v in params.items()})
    for b in range(B):
        jl = jg.ExponentialFamily(family)(jy, **{k: v[b] for k, v in params.items()})
        xb = jnp.asarray(x[b])
        np.testing.assert_allclose(tl.loglik(_t(x))[b].item(), float(jl.loglik(xb)), rtol=1e-12)
        np.testing.assert_allclose(tl.loggrad(_t(x))[b].numpy(), np.asarray(jl.loggrad(xb)), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(tl.loghessian_diag(_t(x))[b].numpy(), np.asarray(jl.loghessian_diag(xb)),
                                   rtol=1e-12)


def test_noncanonical_links_and_unported_paths_raise():
    lik = tg.ExponentialFamily("poisson", link="identity")(np.ones(4))
    with pytest.raises(NotImplementedError):
        lik.loggrad(torch.ones(4, dtype=F64))
    with pytest.raises(NotImplementedError):
        tg.ARModel(8, order=2)
    with pytest.raises(NotImplementedError):
        tg.AR1Model(8, constraint="sumtozero")(tau=_t(1.0), rho=_t(0.5))
    Q = tg.AR1Model(8).precision(_t(1.0), _t(0.5))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tg.factorize(Q, tg.SolverSpec(kind="dense"))
    prior = tg.AR1Model(8)(tau=_t(1.0), rho=_t(0.5))
    with pytest.raises(NotImplementedError):
        tg.gaussian_approximation(prior, tg.ExponentialFamily("normal")(np.ones(8), sigma=_t(1.0)))


# ---- Laplace approximation and marginal ---------------------------------------

# One chain (tau=60) converges in far fewer Newton iterations than another
# (tau=0.3, rho=0.95), which exercises the per-chain masks.
_TAUS = np.array([1.0, 60.0, 0.3, 2.0])
_RHOS = np.array([0.7, 0.3, 0.95, -0.5])


def test_gaussian_approximation_mode_matches_reference():
    n = 40
    y = _poisson_y(n)
    post = tg.gaussian_approximation(tg.AR1Model(n)(tau=_t(_TAUS), rho=_t(_RHOS)),
                                     tg.ExponentialFamily("poisson")(y))
    jm, jo = jg.AR1Model(n), jg.ExponentialFamily("poisson")

    def mode(tau, rho):
        jp = jg.gaussian_approximation(jg.GMRF.from_precision(jnp.zeros(n), jm.precision(tau=tau, rho=rho)), jo(y))
        return jp.mean, jp.logdet_precision()

    mean, logdet = jax.jit(jax.vmap(mode))(_TAUS, _RHOS)
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(mean), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(post.logdet_precision().numpy(), np.asarray(logdet), rtol=1e-9)


def test_newton_chains_stop_at_their_own_iteration():
    n = 40
    y = _poisson_y(n)
    Q = tg.AR1Model(n).precision(_t(_TAUS), _t(_RHOS))
    lik = tg.ExponentialFamily("poisson")(y)
    mu = torch.zeros(n, dtype=F64)
    x0 = torch.zeros(len(_TAUS), n, dtype=F64)
    # a chain that has converged keeps its x: one more allowed iteration
    # changes nothing for it
    iters = []
    for b in range(len(_TAUS)):
        Qb = tg.SparseMatrix(Q.data[b:b + 1], Q.pattern)
        prev = x0[b:b + 1]
        for k in range(1, 26):
            xk = _newton_mode_impl(tg.GAOptions(max_iter=k), Qb, mu, lik, x0[b:b + 1])
            if torch.equal(xk, prev):
                iters.append(k - 1)
                break
            prev = xk
    assert min(iters) < max(iters) - 1
    full = _newton_mode_impl(tg.GAOptions(max_iter=25), Q, mu, lik, x0)
    for b, k in enumerate(iters):
        alone = _newton_mode_impl(tg.GAOptions(max_iter=k), tg.SparseMatrix(Q.data[b:b + 1], Q.pattern),
                                  mu, lik, x0[b:b + 1])
        assert torch.equal(full[b], alone[0])


def _jax_marginal_fn(n, y, opts):
    model, obs = jg.AR1Model(n), jg.ExponentialFamily("poisson")

    def f(th):
        return jg.laplace_marginal(model, obs, y, {"tau": th[0], "rho": th[1]}, options=opts)

    return jax.jit(jax.vmap(jax.value_and_grad(f)))


def test_laplace_marginal_value_and_grad_match_reference():
    n = 40
    y = _poisson_y(n)
    tau, rho = _t(_TAUS, requires_grad=True), _t(_RHOS, requires_grad=True)
    v = tg.laplace_marginal(tg.AR1Model(n), tg.ExponentialFamily("poisson"), y, {"tau": tau, "rho": rho},
                            options=tg.GAOptions(max_iter=25))
    v.sum().backward()
    jv, jgrad = _jax_marginal_fn(n, y, jg.GAOptions(max_iter=25))(jnp.stack([_TAUS, _RHOS], -1))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-7)
    np.testing.assert_allclose(tau.grad.numpy(), np.asarray(jgrad)[:, 0], rtol=1e-5)
    np.testing.assert_allclose(rho.grad.numpy(), np.asarray(jgrad)[:, 1], rtol=1e-5)


def test_laplace_marginal_gradient_through_likelihood_parameter():
    # a θ entry that reaches only the likelihood: the IFT cotangent path into
    # the likelihood's own tensors
    n = 24
    rng = np.random.default_rng(5)
    y = rng.poisson(3.0, n).astype(np.float64)
    r = _t([2.0, 5.0], requires_grad=True)
    v = tg.laplace_marginal(tg.AR1Model(n), tg.ExponentialFamily("negativebinomial"), y,
                            {"tau": _t([1.0, 3.0]), "rho": _t([0.5, 0.2]), "r": r})
    v.sum().backward()
    model, obs = jg.AR1Model(n), jg.ExponentialFamily("negativebinomial")

    def f(th):
        return jg.laplace_marginal(model, obs, y, {"tau": th[0], "rho": th[1], "r": th[2]})

    jv, jgrad = jax.jit(jax.vmap(jax.value_and_grad(f)))(jnp.asarray([[1.0, 0.5, 2.0], [3.0, 0.2, 5.0]]))
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-7)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgrad)[:, 2], rtol=1e-5)


# ---- transforms and HMC ------------------------------------------------------


def _specs():
    js = jtr.ParamSpec(tau=(jtr.LogTransform(), lambda t: -0.5 * jnp.log(t) ** 2),
                       rho=(jtr.LogitTransform(-1.0, 1.0), lambda r: 0.0))
    ts = ttr.ParamSpec(tau=(ttr.LogTransform(), lambda t: -0.5 * torch.log(t) ** 2),
                       rho=(ttr.LogitTransform(-1.0, 1.0), lambda r: 0.0))
    return js, ts


def test_leapfrog_and_hmc_transition_match_reference():
    n, B, steps, eps = 16, 3, 3, 0.15
    y = _poisson_y(n, seed=2)
    rng = np.random.default_rng(6)
    z0 = rng.normal(scale=0.3, size=(B, 2))
    r0 = rng.normal(size=(B, 2))
    u = rng.uniform(size=B)
    inv_mass = np.array([1.0, 0.5])
    js, ts = _specs()
    opts = dict(max_iter=25)
    jld = jtr.make_logdensity(
        lambda th: jg.laplace_marginal(jg.AR1Model(n), jg.ExponentialFamily("poisson"), y, th,
                                       options=jg.GAOptions(**opts)), js)
    tld = ttr.make_logdensity(
        lambda th: tg.laplace_marginal(tg.AR1Model(n), tg.ExponentialFamily("poisson"), y, th,
                                       options=tg.GAOptions(**opts)), ts)

    def jtraj(z, r):
        ld, g = jax.value_and_grad(jld)(z)
        h0 = -ld + jhmc._kinetic(r, inv_mass)
        for _ in range(steps):
            z, r, ld, g = jhmc.leapfrog(jld, z, r, g, eps, inv_mass)
        h1 = -ld + jhmc._kinetic(r, inv_mass)
        return z, r, ld, g, h0 - h1

    jz, jr, jl, jgr, jdelta = jax.jit(jax.vmap(jtraj))(z0, r0)
    state = thmc.hmc_init(tld, _t(z0))
    new, info = thmc.hmc_transition(tld, state, _t(r0), _t(u), eps, _t(inv_mass), steps)
    accept_ref = np.minimum(1.0, np.exp(np.asarray(jdelta)))
    np.testing.assert_allclose(info["accept_prob"].numpy(), accept_ref, rtol=1e-5, atol=1e-8)
    acc = info["accepted"].numpy()
    np.testing.assert_array_equal(acc, u < accept_ref)
    np.testing.assert_allclose(new.position.numpy()[acc], np.asarray(jz)[acc], rtol=1e-5)
    np.testing.assert_allclose(new.grad.numpy()[acc], np.asarray(jgr)[acc], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(info["energy"].numpy(),
                               -np.asarray(jl) + 0.5 * (np.asarray(jr) ** 2 * inv_mass).sum(-1), rtol=1e-5)
    # the kernel draws momenta and uniforms from the generator and moves the state
    step = thmc.hmc_kernel(tld, num_steps=2)
    out, _ = step(torch.Generator().manual_seed(0), state, 0.1, _t(inv_mass))
    assert out.position.shape == (B, 2) and torch.isfinite(out.position).all()


def test_transforms_match_reference():
    js, ts = _specs()
    z = np.array([[0.3, -1.2], [-2.0, 0.5], [1.0, 3.0]])
    th = ts.constrain(_t(z))
    for b in range(3):
        jth = js.constrain(jnp.asarray(z[b]))
        for k in ("tau", "rho"):
            np.testing.assert_allclose(th[k][b].item(), float(jth[k]), rtol=1e-12)
        np.testing.assert_allclose(ts.log_jac(_t(z))[b].item(), float(js.log_jac(jnp.asarray(z[b]))), rtol=1e-12)
        np.testing.assert_allclose(ts.log_prior(_t(z))[b].item(), float(js.log_prior(jnp.asarray(z[b]))),
                                   rtol=1e-12)
    np.testing.assert_allclose(ts.unconstrain(th).numpy(), z, rtol=1e-12)


# ---- interop -----------------------------------------------------------------


def test_interop_round_trips():
    n = 12
    jgm = jg.AR1Model(n)(tau=1.5, rho=0.4)
    x = np.linspace(-1, 1, n)
    p = jgm.Q.pattern
    g = interop.gmrf_from_numpy(np.asarray(jgm.mean), p.rows, p.cols, p.shape, np.asarray(jgm.Q.data))
    np.testing.assert_allclose(g.logpdf(_t(x)).item(), float(jgm.logpdf(jnp.asarray(x))), rtol=1e-12)
    Q = interop.sparse_from_numpy(p.rows, p.cols, p.shape, np.asarray(jgm.Q.data))
    np.testing.assert_array_equal(Q.data.numpy(), np.asarray(jgm.Q.data))
    with pytest.raises(ValueError):
        interop.sparse_from_numpy(p.rows[::-1], p.cols[::-1], p.shape, np.asarray(jgm.Q.data))
    y = np.arange(n, dtype=np.float64) % 3
    jl = jg.ExponentialFamily("negbin")(y, r=2.5, offset=np.full(n, 0.1))
    tl = interop.ef_likelihood_from_numpy("negativebinomial", "log", np.asarray(jl.y), {"r": 2.5},
                                          offset=np.asarray(jl.offset))
    np.testing.assert_allclose(tl.loglik(_t(x)).item(), float(jl.loglik(jnp.asarray(x))), rtol=1e-12)
    st = jhmc.HMCState(jnp.ones((2, 2)), jnp.zeros(2), jnp.ones((2, 2)) * 0.5)
    ts = interop.hmc_state_from_numpy(*(np.asarray(a) for a in st))
    for a, b in zip(st, ts):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
