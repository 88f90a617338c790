"""The port's Laplace approximation with linearly transformed observations
(η = A·x + b, A the FEM evaluation matrix of a small Matérn mesh) against
the JAX package, float64, on the same NumPy inputs: the mode and the
marginal standard deviations (example 03's configuration at its own size),
`laplace_marginal` and its θ-gradient, a θ that reaches A through a
`ParameterizedMatrix` included, the conjugate shortcut through
`linear_condition` (sparse A batched over chains, dense A on one GMRF), and
`linear_predictor_marginals`' linearly transformed and composite branches.

Tolerances: modes and standard deviations 1e-8 and the marginal 1e-8
relative (both sides stop Newton at the same tolerances; the reference runs
its dense backend, the port whatever ``SolverSpec()`` resolves to on the
posterior pattern); the θ-gradient 1e-6 relative, as in
test_torch_matern: at τ = 1, range = 0.25 the line search's merit stops
resolving a decrease at a Newton decrement of ~3e-13, so each side stops
where its own rounding leaves it, up to ~5e-7 from the exact mode, and the
implicit-function gradient carries that (2.3e-8 read here, with tighter
Newton tolerances as well); the conjugate shortcut, which has no iteration,
1e-10; the linear predictor's mean and variance 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.sparse import SparseMatrix

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
B = 3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, ref, rtol, atol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _setup():
    """Example 03 (examples/03_bernoulli_spatial_classification.py) at its own
    size: 150 scattered sites, Bernoulli marks, a Matérn α=2 field on the FEM
    mesh; both packages' models and their evaluation matrices."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1, size=(150, 2))
    logit = 3.0 * np.sin(3 * pts[:, 0]) - 1.0 * pts[:, 1]
    y = (rng.uniform(size=len(pts)) < 1 / (1 + np.exp(-logit))).astype(np.float64)
    jm, tm = jg.MaternModel(pts, smoothness=1), tg.MaternModel(pts, smoothness=1)
    jA, tA = jm.evaluation_matrix(), tm.evaluation_matrix()
    assert np.array_equal(tA.pattern.rows, jA.pattern.rows) and np.array_equal(tA.pattern.cols, jA.pattern.cols)
    return pts, y, jm, tm, jA, tA


@functools.lru_cache(maxsize=None)
def _mode_reference():
    pts, y, jm, _, jA, _ = _setup()

    @jax.jit
    def run(tau, rng_):
        prior = jm(tau=tau, range=rng_)
        lik = jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("bernoulli"), jA)(jnp.asarray(y))
        post = jg.gaussian_approximation(prior, lik, solver=jg.SolverSpec(kind="dense"))
        return post.mean, jnp.sqrt(post.var())

    return [np.asarray(r) for r in run(0.5, 0.4)]


def test_example03_mode_and_std():
    _, y, _, tm, _, tA = _setup()
    want_mean, want_std = _mode_reference()
    lik = tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("bernoulli"), tA)(y)
    prior = tm(tau=_t(0.5), range=_t(0.4))
    post = tg.gaussian_approximation(prior, lik)
    # the evaluation matrix's Aᵀ diag(h) A lies inside Q's pattern: the posterior keeps the prior's pattern
    assert post.Q.pattern == prior.Q.pattern
    _close(post.mean, want_mean, rtol=1e-8, atol=1e-8)
    _close(post.std(), want_std, rtol=1e-8)
    # example 03's own checks (its golden literals)
    p_hat = torch.sigmoid(tA.matvec(post.mean))
    acc = float(((p_hat > 0.5) == (_t(y) > 0.5)).double().mean())
    assert abs(float(torch.linalg.vector_norm(post.mean)) - 31.958964) < 0.3
    assert abs(float(post.std().mean()) - 1.026679) < 0.02
    assert abs(acc - 0.80) <= 2.0 / 150 + 1e-9


@functools.lru_cache(maxsize=None)
def _marginal_reference():
    """laplace_marginal and its (τ, range, a) gradient per chain, the design
    matrix scaled by a through a ParameterizedMatrix."""
    _, y, jm, _, jA, _ = _setup()
    obs = jg.LinearlyTransformedObservationModel(
        jg.ExponentialFamily("bernoulli"), jg.ParameterizedMatrix(lambda a: JSM(jA.data * a, jA.pattern), ("a",)))
    opts = jg.GAOptions(inner_solver=jg.SolverSpec(kind="dense"))

    def f(tau, rng_, a):
        return jg.laplace_marginal(jm, obs, jnp.asarray(y), {"tau": tau, "range": rng_, "a": a}, options=opts)

    v, g = jax.jit(jax.vmap(jax.value_and_grad(f, (0, 1, 2))))(*(jnp.asarray(c) for c in THETAS))
    return np.asarray(v), np.stack([np.asarray(x) for x in g], -1)


THETAS = (np.array([0.5, 1.0, 0.3]), np.array([0.4, 0.25, 0.6]), np.array([1.0, 0.7, 1.4]))


def test_laplace_marginal_gradient_through_parameterized_matrix():
    _, y, _, tm, _, tA = _setup()
    want_v, want_g = _marginal_reference()
    obs = tg.LinearlyTransformedObservationModel(
        tg.ExponentialFamily("bernoulli"),
        tg.ParameterizedMatrix(lambda a: SparseMatrix(tA.data * a[..., None], tA.pattern), ("a",)))
    th = {k: _t(v).requires_grad_() for k, v in zip(("tau", "range", "a"), THETAS)}
    v = tg.laplace_marginal(tm, obs, y, th)
    v.sum().backward()
    _close(v, want_v, rtol=1e-8)
    _close(torch.stack([th[k].grad for k in ("tau", "range", "a")], -1), want_g, rtol=1e-6)


def test_lt_conjugate_shortcut():
    """Normal observations through A take linear_condition: sparse A batched over chains, dense A one GMRF."""
    pts, _, jm, tm, jA, tA = _setup()
    rng = np.random.default_rng(8)
    yn = np.sin(3 * pts[:, 0]) + 0.2 * rng.normal(size=len(pts))
    b = np.full(len(pts), 0.1)
    taus, sig = np.array([0.5, 1.0, 2.0]), np.array([0.2, 0.3, 0.5])
    lik = tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("normal"), tA, b)(yn, sigma=_t(sig))
    post = tg.gaussian_approximation(tm(tau=_t(taus), range=_t(np.full(3, 0.4))), lik)

    @jax.jit
    @jax.vmap
    def ref(tau, s):
        jl = jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("normal"), jA, b)(yn, sigma=s)
        p = jg.gaussian_approximation(jm(tau=tau, range=0.4), jl, solver=jg.SolverSpec(kind="dense"))
        return p.mean, p.Q.data

    want_mean, want_q = ref(jnp.asarray(taus), jnp.asarray(sig))
    _close(post.mean, want_mean, rtol=1e-10, atol=1e-10)
    assert post.mean.shape == (B, tm.n)
    Ad = tA.todense()
    lik_d = tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("normal"), Ad, b)(yn, sigma=_t(sig[1]))
    post_d = tg.gaussian_approximation(tm(tau=_t(taus[1]), range=_t(0.4)), lik_d)
    _close(post_d.mean, want_mean[1], rtol=1e-10, atol=1e-10)
    _close(post_d.Q.todense(), post.Q.todense()[1], rtol=1e-10)


def test_linear_predictor_marginals_lt_and_composite():
    pts, y, jm, tm, jA, tA = _setup()
    idx = np.arange(0, tm.n, 7)
    yc = np.random.default_rng(9).normal(size=len(idx))
    b = np.linspace(-0.2, 0.2, len(pts))
    jlt = jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("bernoulli"), jA, b)
    tlt = tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("bernoulli"), tA, b)
    jcomp = jg.CompositeObservationModel(jlt, jg.ExponentialFamily("normal", indices=idx))((jnp.asarray(y), yc), sigma=0.5)
    tcomp = tg.CompositeObservationModel(tlt, tg.ExponentialFamily("normal", indices=idx))((y, yc), sigma=_t(0.5))

    @jax.jit
    def ref():
        post = jg.gaussian_approximation(jm(tau=0.5, range=0.4), jcomp, solver=jg.SolverSpec(kind="dense"))
        lt = jg.linear_predictor_marginals(post, jcomp.components[0])
        cp = jg.linear_predictor_marginals(post, jcomp)
        return post.mean, lt[0], lt[1], cp[0], cp[1]

    want = [np.asarray(r) for r in ref()]
    post = tg.gaussian_approximation(tm(tau=_t(0.5), range=_t(0.4)), tcomp)
    _close(post.mean, want[0], rtol=1e-8, atol=1e-8)
    mu, v, base = tg.linear_predictor_marginals(post, tcomp.components[0])
    assert isinstance(base, tg.observations.EFLikelihood) and base.family == "bernoulli"
    _close(mu, want[1], rtol=1e-8, atol=1e-8)
    _close(v, want[2], rtol=1e-8)
    mu_c, v_c, lik_c = tg.linear_predictor_marginals(post, tcomp)
    _close(mu_c, want[3], rtol=1e-8, atol=1e-8)
    _close(v_c, want[4], rtol=1e-8)
    # the re-indexed composite takes μ_η directly: its loglik at μ_η is the components' at x*
    np.testing.assert_array_equal(lik_c.components[1].indices.numpy(), np.arange(len(pts), len(pts) + len(idx)))
    _close(lik_c.loglik(mu_c), tcomp.loglik(post.mean), rtol=1e-12)
