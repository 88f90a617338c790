"""The port's observation breadth against the JAX package, float64, on the
same NumPy inputs: every family × link pair of ``tests/test_observation_grid.py``
(non-canonical links by autodiff), the link helpers, linearly transformed
(sparse and dense A, ``ParameterizedMatrix``, ``ParameterizedOffset``),
composite, autodiff (dense, diagonal and sparse-pattern Hessians),
nonlinear least squares (with and without a Jacobian pattern) and zero
likelihoods, ``Predictive`` and ``conditional_distribution``; each
unbatched and at B = 3 chains.

Tolerances: log-likelihoods, gradients and Hessians rtol 1e-10 (the same
formulas, autodiff in another order); Laplace modes over the IID prior 1e-8
(both stop Newton at the same tolerances); ``Predictive`` mean, variance and
log-density 1e-12; its draws by their moments over 20,000 draws: the sample
mean within 5 standard errors and the sample variance within 10% (at least
5 standard deviations of the sample variance for every family here, the
Student-t's kurtosis of 9 included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf import observations as jobs
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JPattern
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import observations as tobs
from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
RTOL = 1e-10
B = 3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, ref, rtol=RTOL, atol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


# ---- the family × link grid (tests/test_observation_grid.py) ------------------

N, M_SUB = 9, 4
GRID = [
    ("normal", "identity"), ("normal", "log"), ("poisson", "log"), ("poisson", "identity"),
    ("bernoulli", "logit"), ("binomial", "logit"), ("negativebinomial", "log"), ("gamma", "log"),
    ("gamma", "identity"), ("studentt", "identity"),
]


def _theta(family):
    return {"normal": dict(sigma=0.8), "poisson": {}, "bernoulli": {}, "binomial": dict(trials=7.0),
            "negativebinomial": dict(r=3.0), "gamma": dict(phi=0.5), "studentt": dict(sigma=0.9, nu=5.0)}[family]


def _draw_y(rng, family, m):
    return {
        "normal": lambda: rng.normal(size=m),
        "poisson": lambda: rng.poisson(2.0, size=m).astype(np.float64),
        "bernoulli": lambda: rng.integers(0, 2, size=m).astype(np.float64),
        "binomial": lambda: rng.integers(0, 8, size=m).astype(np.float64),
        "negativebinomial": lambda: rng.poisson(3.0, size=m).astype(np.float64),
        "gamma": lambda: rng.gamma(2.0, 1.5, size=m),
        "studentt": lambda: rng.standard_t(5.0, size=m),
    }[family]()


def _draw_x(rng, family, link, shape):
    if link == "identity" and family in ("poisson", "gamma"):
        return rng.uniform(1.5, 3.0, size=shape)
    if link == "log" and family == "normal":
        return rng.uniform(-0.5, 0.5, size=shape)
    return rng.normal(size=shape) * 0.6


CASES = ([("grid", f, l, i) for f, l in GRID for i in (False, True)]
         + [("offset", f, "log", i) for f in ("poisson", "negativebinomial") for i in (False, True)]
         + [("laplace", f, l, False) for f, l in GRID])


def _laplace_case(rng, family, link):
    y = _draw_y(rng, family, N)
    if link == "identity" and family == "poisson":
        y = np.maximum(y, 1.0)  # no interior stationary point at y = 0 under the identity link
    x0 = _draw_x(rng, family, link, N)
    jlik = jg.ExponentialFamily(family, link=link)(y, **_theta(family))
    jpost = jax.jit(lambda x: jg.gaussian_approximation(jg.IIDModel(N)(tau=2.0), jlik, x0=x).mean)(jnp.asarray(x0))
    tlik = tg.ExponentialFamily(family, link=link)(y, **{k: _t(v) for k, v in _theta(family).items()})
    tpost = tg.gaussian_approximation(tg.IIDModel(N)(tau=_t(2.0)), tlik, x0=_t(x0))
    _close(tpost.mean, jpost, rtol=1e-8, atol=1e-8)
    score = -2.0 * tpost.mean + tlik.loggrad(tpost.mean)
    assert float(score.abs().max()) < 5e-3, (family, link)


@pytest.mark.parametrize("kind,family,link,use_indices", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_link_grid(kind, family, link, use_indices):
    """loglik, loggrad and loghessian_diag of every grid cell (unbatched and at
    B = 3), the offset cells, and the Laplace mode of every pair over an IID prior."""
    rng = np.random.default_rng(CASES.index((kind, family, link, use_indices)))
    if kind == "laplace":
        return _laplace_case(rng, family, link)
    m = M_SUB if use_indices else N
    idx = np.sort(rng.choice(N, size=m, replace=False)) if use_indices else None
    y = _draw_y(rng, family, m)
    th = _theta(family)
    if kind == "offset":
        th = dict(th, offset=np.log(rng.uniform(0.5, 2.0, size=m)))
    jlik = jg.ExponentialFamily(family, link=link, indices=idx)(y, **th)
    tlik = tg.ExponentialFamily(family, link=link, indices=idx)(y, **{k: _t(v) for k, v in th.items()})
    x = _draw_x(rng, family, link, (B, N))
    ref = jax.jit(jax.vmap(lambda xb: (jlik.loglik(xb), jlik.pointwise_loglik(xb), jlik.loggrad(xb),
                                       jlik.loghessian_diag(xb))))(jnp.asarray(x))
    ref = [np.asarray(r) for r in ref]
    for b in range(B):
        _close(tlik.loglik(_t(x[b])), ref[0][b])
        _close(tlik.pointwise_loglik(_t(x[b])), ref[1][b])
        _close(tlik.loggrad(_t(x[b])), ref[2][b])
        _close(tlik.loghessian_diag(_t(x[b])), ref[3][b])
    _close(tlik.loglik(_t(x)), ref[0])
    _close(tlik.loggrad(_t(x)), ref[2])
    _close(tlik.loghessian_diag(_t(x)), ref[3])


def test_noncanonical_per_chain_parameters():
    """A non-canonical link with σ per chain: each chain's derivatives are those of its own σ."""
    rng = np.random.default_rng(7)
    y, x = rng.normal(size=N), rng.uniform(-0.5, 0.5, size=(B, N))
    sig = np.array([0.3, 0.8, 1.5])
    tlik = tg.ExponentialFamily("normal", link="log")(y, sigma=_t(sig))
    for b in range(B):
        jlik = jg.ExponentialFamily("normal", link="log")(y, sigma=sig[b])
        _close(tlik.loglik(_t(x))[b], jlik.loglik(jnp.asarray(x[b])))
        _close(tlik.loggrad(_t(x))[b], jlik.loggrad(jnp.asarray(x[b])))
        _close(tlik.loghessian_diag(_t(x))[b], jlik.loghessian_diag(jnp.asarray(x[b])))


@pytest.mark.parametrize("link", ["identity", "log", "logit"])
def test_link_helpers(link):
    mu = np.array([0.1, 0.35, 0.8])
    eta = np.array([-1.2, 0.0, 0.7])
    _close(tobs.apply_link(link, _t(mu)), jobs.apply_link(link, jnp.asarray(mu)), rtol=1e-14)
    _close(tobs.apply_invlink(link, _t(eta)), jobs.apply_invlink(link, jnp.asarray(eta)), rtol=1e-14)
    cls = {"identity": tobs.IdentityLink, "log": tobs.LogLink, "logit": tobs.LogitLink}[link]
    _close(tobs.apply_invlink(cls, tobs.apply_link(cls, _t(mu))), mu, rtol=1e-14)


# ---- linearly transformed, composite ------------------------------------------

def _sparse_A(rng, m, n, per_row=3):
    rows = np.repeat(np.arange(m), per_row)
    cols = np.concatenate([rng.choice(n, per_row, replace=False) for _ in range(m)])
    vals = rng.uniform(0.2, 1.0, size=m * per_row)
    jpat, tpat = JPattern(rows, cols, (m, n)), SparsePattern(rows, cols, (m, n))
    vals = vals[tpat.sort_order]
    return JSM(jnp.asarray(vals), jpat), SparseMatrix(_t(vals), tpat), vals


def _jax_terms(make, x, *per_chain):
    """(loglik, loggrad, Hessian data) of the JAX likelihood `make(*per_chain_b)`
    at each chain's x (B, n), by one jitted vmap, and the Hessian's pattern."""
    f = lambda xb, *p: (make(*p).loglik(xb), make(*p).loggrad(xb), make(*p).loghessian(xb).data)
    vals = jax.jit(jax.vmap(f))(jnp.asarray(x), *(jnp.asarray(p) for p in per_chain))
    pat = make(*(p[0] for p in per_chain)).loghessian(jnp.asarray(x[0])).pattern
    return [np.asarray(v) for v in vals], pat


def _hold_lik(tlik, make, x, *per_chain):
    """loglik, loggrad and the Hessian (pattern and data) per chain of x (B, n)
    against the JAX likelihood `make(*per_chain_b)`, and unbatched (chain 0)."""
    ref, pat = _jax_terms(make, x, *per_chain)
    for xt, pick in ((_t(x), lambda a: a), (_t(x[0]), lambda a: a[0])):
        if per_chain and xt.ndim == 1:
            continue  # per-chain θ: the batched call only
        _close(tlik.loglik(xt), pick(ref[0]))
        _close(tlik.loggrad(xt), pick(ref[1]))
        Ht = tlik.loghessian(xt)
        assert np.array_equal(Ht.pattern.rows, pat.rows) and np.array_equal(Ht.pattern.cols, pat.cols)
        _close(Ht.data, pick(ref[2]))


@pytest.mark.parametrize("form", ["sparse", "dense", "parameterized"])
def test_linearly_transformed(form):
    rng = np.random.default_rng(11)
    n, m = 10, 7
    jA, tA, vals = _sparse_A(rng, m, n)
    y = rng.poisson(2.0, size=m).astype(np.float64)
    b = rng.normal(scale=0.1, size=m)
    x = rng.normal(scale=0.5, size=(B, n))
    base_j, base_t = jg.ExponentialFamily("poisson"), tg.ExponentialFamily("poisson")
    if form == "sparse":
        jmod = jg.LinearlyTransformedObservationModel(base_j, jA, b)
        jlik, tlik = jmod(y), tg.LinearlyTransformedObservationModel(base_t, tA, _t(b))(y)
    elif form == "dense":
        Ad = np.asarray(jA.todense())
        jmod = jg.LinearlyTransformedObservationModel(base_j, jnp.asarray(Ad), b)
        jlik, tlik = jmod(y), tg.LinearlyTransformedObservationModel(base_t, _t(Ad), _t(b))(y)
    else:
        jA_p = jg.ParameterizedMatrix(lambda a: JSM(jA.data * a, jA.pattern), ("a",))
        tA_p = tg.ParameterizedMatrix(lambda a: SparseMatrix(tA.data * a, tA.pattern), ("a",))
        jb_p = jg.ParameterizedOffset(lambda c: c * jnp.asarray(b), ("c",))
        tb_p = tg.ParameterizedOffset(lambda c: c * _t(b), ("c",))
        jmod = jg.LinearlyTransformedObservationModel(base_j, jA_p, jb_p)
        tmod = tg.LinearlyTransformedObservationModel(base_t, tA_p, tb_p)
        assert tmod.hyperparameters == jmod.hyperparameters == ("a", "c")
        jlik, tlik = jmod(y, a=1.3, c=-0.7), tmod(y, a=_t(1.3), c=_t(-0.7))
    _hold_lik(tlik, lambda: jlik, x)
    _close(tlik.pointwise_loglik(_t(x[0])), jlik.pointwise_loglik(jnp.asarray(x[0])))
    # the tensor protocol rebuilds the same likelihood
    re = tlik.with_tensors(tlik.tensors())
    _close(re.loglik(_t(x)), tlik.loglik(_t(x)), rtol=0, atol=0)


def test_linearly_transformed_per_chain_A():
    """A's data (B, nnz), one design per chain (a ParameterizedMatrix of θ (B,))."""
    rng = np.random.default_rng(12)
    n, m = 8, 6
    jA, tA, vals = _sparse_A(rng, m, n, per_row=2)
    y = rng.integers(0, 2, size=m).astype(np.float64)
    a = np.array([0.5, 1.0, 2.0])
    x = rng.normal(size=(B, n))
    tmod = tg.LinearlyTransformedObservationModel(
        tg.ExponentialFamily("bernoulli"), tg.ParameterizedMatrix(lambda a: SparseMatrix(tA.data * a[:, None], tA.pattern), ("a",)))
    make = lambda ak: jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("bernoulli"),
                                                             JSM(jA.data * ak, jA.pattern))(jnp.asarray(y))
    _hold_lik(tmod(y, a=_t(a)), make, x, a)


def test_composite():
    rng = np.random.default_rng(13)
    n, m = 9, 5
    jA, tA, _ = _sparse_A(rng, m, n, per_row=2)
    idx = np.array([0, 3, 4, 8])
    y1, y2 = rng.normal(size=4), rng.poisson(1.5, size=m).astype(np.float64)
    jmod = jg.CompositeObservationModel(jg.ExponentialFamily("normal", indices=idx),
                                        jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("poisson"), jA))
    tmod = tg.CompositeObservationModel(tg.ExponentialFamily("normal", indices=idx),
                                        tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("poisson"), tA))
    jlik, tlik = jmod((y1, y2), sigma=0.6), tmod((y1, y2), sigma=_t(0.6))
    x = rng.normal(scale=0.5, size=(B, n))
    _hold_lik(tlik, lambda: jlik, x)
    _close(tlik.pointwise_loglik(_t(x[1])), jlik.pointwise_loglik(jnp.asarray(x[1])))
    re = tlik.with_tensors(tlik.tensors())
    _close(re.loggrad(_t(x)), tlik.loggrad(_t(x)), rtol=0, atol=0)


# ---- autodiff, NLSQ, zero -----------------------------------------------------

def _coupled(np_):
    def fn(x, y, s):
        return s * np_.sum(y * x - np_.exp(x)) - 0.3 * np_.sum((x[1:] - x[:-1]) ** 2 * (1 + x[1:] ** 2))
    return fn


def _separable(np_):
    def fn(x, y, s):
        return np_.sum(y * x - s * np_.exp(x) - 0.1 * x**4)
    return fn


@pytest.mark.parametrize("hessian", ["dense", "diag", "pattern"])
def test_autodiff_likelihood(hessian):
    rng = np.random.default_rng(14)
    n = 12
    y = rng.poisson(2.0, size=n).astype(np.float64)
    x = rng.normal(scale=0.5, size=(B, n))
    fj, ft = (_separable(jnp), _separable(torch)) if hessian == "diag" else (_coupled(jnp), _coupled(torch))
    if hessian == "pattern":
        i = np.arange(n)
        rows, cols = np.concatenate([i, i[1:], i[:-1]]), np.concatenate([i, i[:-1], i[1:]])
        hj, ht = JPattern(rows, cols, (n, n)), SparsePattern(rows, cols, (n, n))
    else:
        hj = ht = hessian
    s = np.array([0.5, 1.0, 1.5])
    tlik = tg.AutoDiffObservationModel(ft, hessian=ht)(y, s=_t(s))
    assert tlik.hessian_kind == ("diag" if hessian == "diag" else "sparse")
    make = lambda sb: jg.AutoDiffObservationModel(fj, hessian=hj)(jnp.asarray(y), s=sb)
    _hold_lik(tlik, make, x, s)
    if hessian == "diag":
        _close(tlik.loghessian_diag(_t(x)), tlik.loghessian(_t(x)).data)
    # unbatched: one chain, scalar θ
    _hold_lik(tg.AutoDiffObservationModel(ft, hessian=ht)(y, s=_t(s[0])), lambda: make(jnp.asarray(s[0])), x[:1])


def _forward(np_):
    return lambda x: np_.concatenate([x[1:] ** 2 - x[:-1], np_.sin(x[:3])])


@pytest.mark.parametrize("with_pattern", [False, True])
def test_nlsq(with_pattern):
    rng = np.random.default_rng(15)
    n = 10
    m = n - 1 + 3
    rows = np.concatenate([np.arange(n - 1), np.arange(n - 1), n - 1 + np.arange(3)])
    cols = np.concatenate([np.arange(1, n), np.arange(n - 1), np.arange(3)])
    pj = JPattern(rows, cols, (m, n)) if with_pattern else None
    pt = SparsePattern(rows, cols, (m, n)) if with_pattern else None
    y = rng.normal(size=m)
    x = rng.normal(size=(B, n))
    sig = np.array([0.4, 0.9, 1.7])
    tmod = tg.NonlinearLeastSquaresModel(_forward(torch), jac_pattern=pt)
    make = lambda sb: jg.NonlinearLeastSquaresModel(_forward(jnp), jac_pattern=pj)(y, sigma=sb)
    _hold_lik(tmod(y, sigma=_t(sig)), make, x, sig)
    _hold_lik(tmod(y, sigma=_t(0.5)), lambda: make(jnp.asarray(0.5)), x[:1])


def test_zero_likelihood():
    x = _t(np.random.default_rng(16).normal(size=(B, 5)))
    z = tg.ZeroLikelihood()
    assert z.loglik(x).shape == (B,) and not z.loglik(x).any()
    assert not z.loggrad(x).any() and not z.loghessian_diag(x).any() and z.tensors() == []


# ---- Predictive and conditional_distribution -------------------------------------

PRED = [("normal", "identity", dict(sigma=0.7)), ("normal", "log", dict(sigma=0.7)), ("poisson", "log", {}),
        ("bernoulli", "logit", {}), ("binomial", "logit", dict(trials=np.array([3.0, 5.0, 8.0, 2.0, 6.0]))),
        ("negativebinomial", "log", dict(r=3.0)), ("gamma", "log", dict(phi=2.5)),
        ("studentt", "identity", dict(sigma=0.9, nu=5.0))]


@pytest.mark.parametrize("family,link,params", PRED, ids=[f"{f}-{l}" for f, l, _ in PRED])
def test_predictive(family, link, params):
    eta = np.array([-0.8, -0.1, 0.3, 0.6, 1.1])
    jp = jobs.Predictive(eta=jnp.asarray(eta), params={k: jnp.asarray(v) for k, v in params.items()},
                         family=family, link=link)
    tp = tobs.Predictive(eta=_t(eta), params={k: _t(v) for k, v in params.items()}, family=family, link=link)
    _close(tp.mean(), jp.mean(), rtol=1e-12)
    _close(tp.var(), jp.var(), rtol=1e-12)
    _close(tp.std(), jp.std(), rtol=1e-12)
    y = np.asarray(jp.sample(jax.random.PRNGKey(0)))
    _close(tp.logpdf(_t(y)), jp.logpdf(jnp.asarray(y)), rtol=1e-12)
    S = 20000
    big = tobs.Predictive(eta=_t(eta).expand(S, -1), params=tp.params, family=family, link=link)
    draws = big.sample(torch.Generator().manual_seed(3))
    assert draws.shape == (S, 5) and draws.dtype == F64
    mean, var = tp.mean().numpy(), tp.var().numpy()
    assert np.all(np.abs(draws.mean(0).numpy() - mean) <= 5 * np.sqrt(var / S)), (draws.mean(0), mean)
    np.testing.assert_allclose(draws.var(0).numpy(), var, rtol=0.1)


def test_conditional_distribution():
    rng = np.random.default_rng(17)
    n, m = 8, 5
    jA, tA, _ = _sparse_A(rng, m, n, per_row=2)
    x = rng.normal(size=n)
    cases = [
        (jg.ExponentialFamily("poisson", indices=np.array([1, 4, 6])), tg.ExponentialFamily("poisson", indices=np.array([1, 4, 6])), {}),
        (jg.ExponentialFamily("normal", link="log"), tg.ExponentialFamily("normal", link="log"), dict(sigma=0.5)),
        (jg.LinearlyTransformedObservationModel(jg.ExponentialFamily("bernoulli"), jA, np.full(m, 0.2)),
         tg.LinearlyTransformedObservationModel(tg.ExponentialFamily("bernoulli"), tA, np.full(m, 0.2)), {}),
        (jg.NonlinearLeastSquaresModel(_forward(jnp)), tg.NonlinearLeastSquaresModel(_forward(torch)), dict(sigma=0.3)),
    ]
    for jm, tm, th in cases:
        jp = jg.conditional_distribution(jm, jnp.asarray(x), **th)
        tp = tg.conditional_distribution(tm, _t(x), **{k: _t(v) for k, v in th.items()})
        assert (tp.family, tp.link) == (jp.family, jp.link)
        _close(tp.mean(), jp.mean(), rtol=1e-12)
        _close(tp.var(), jp.var(), rtol=1e-12)
    # per chain: x (B, n)
    xb = rng.normal(size=(B, n))
    tp = tg.conditional_distribution(cases[2][1], _t(xb))
    for b in range(B):
        _close(tp.mean()[b], jg.conditional_distribution(cases[2][0], jnp.asarray(xb[b])).mean(), rtol=1e-12)


def test_structured_likelihood():
    """Pairwise observation factors (a noisy difference of neighbours) and single ones, θ per chain."""
    rng = np.random.default_rng(18)
    n = 10
    pairs = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    singles = np.arange(0, n, 3)[:, None]
    y1, y2 = rng.normal(size=n - 1), rng.poisson(2.0, size=len(singles)).astype(np.float64)
    x = rng.normal(scale=0.5, size=(B, n))
    s = np.array([0.5, 1.0, 2.0])

    def diff(np_):
        return lambda v, yi, s, **_: -0.5 * s * (yi - (v[1] - v[0])) ** 2 - 0.1 * (v[1] * v[0]) ** 2

    def pois(np_):
        return lambda v, yi, **_: yi * v[0] - np_.exp(v[0])

    tmod = tg.observations.StructuredObservationModel(n, [tg.observations.ObsFactorGroup(pairs, diff(torch)),
                                                          tg.observations.ObsFactorGroup(singles, pois(torch))])
    tlik = tmod((y1, y2), s=_t(s))

    def make(sb):
        jmod = jobs.StructuredObservationModel(n, [jobs.ObsFactorGroup(pairs, diff(jnp)),
                                                   jobs.ObsFactorGroup(singles, pois(jnp))])
        return jmod((jnp.asarray(y1), jnp.asarray(y2)), s=sb)

    _hold_lik(tlik, make, x, s)
    one = tmod((y1, y2), s=_t(s[0]))
    jl = make(jnp.asarray(s[0]))
    _close(one.pointwise_loglik(_t(x[0])), jl.pointwise_loglik(jnp.asarray(x[0])))
    _hold_lik(one, lambda: jl, x[:1])
