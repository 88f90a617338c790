"""Gradients through the port's direct solves (`FactorSolve`) against
``jax.grad`` of the JAX package, in float64 on the same NumPy inputs.

For each direct backend (tridiag, dense, banded, supernodal):

* d/dτ of a sum-to-zero `ConstrainedGMRF`'s logpdf over
  Q(τ) = τ·tridiag(−1, 2.5, −1), n = 6, and of `linear_condition`'s mean
  sum (the reference gives −0.17692 and −2.50229);
* the per-entry data gradient and the right-hand side's gradient of
  wᵀ·solve(b), on a tridiagonal Q whose two stored triangles differ (so the
  averaging convention shows) and, for the general backends, on a random
  sparse SPD Q with several right-hand sides.

And d/dτ of `linear_condition`'s mean sum at the KL setup of
``chip_smoke.py``'s phase 18 (example 09 at n = 900: Q(τ) = τ·Q_KL, whose
condition reaches 1/jitter = 1e8), by autograd and by a central difference
computed without cancellation, against ``jax.grad`` of the reference.

All to 1e-8 relative. Every reference value is computed once per module,
under ``jax.jit``. Also: the statistics without a backward (`sample`, `var`,
the CG solve) raise while Q requires a gradient, and a second derivative
(``create_graph=True``) through a solve or the Laplace marginal raises
(ROADMAP fault 3.2) instead of returning a value cut from the graph.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.kl_cholesky import gram
from tpu_gmrf_torch.sparse.pattern import SparsePattern
from tests.conftest import random_sparse_spd

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
KINDS = ["tridiag", "dense", "banded", "supernodal"]
TOL = 1e-8
N = 6
TAU = 1.3
# blocks of 2 give the banded plan several blocks at n = 6 (the reference's
# banded scan needs K >= 2)
BLOCK = {"banded": 2}


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _probe():
    """The fault probe: Q(1) = tridiag(−1, 2.5, −1) as COO, A = 1ᵀ, x centred."""
    rows = np.concatenate([np.arange(N), np.arange(N - 1), np.arange(1, N)])
    cols = np.concatenate([np.arange(N), np.arange(1, N), np.arange(N - 1)])
    pat = JP(rows, cols, (N, N))
    vals = np.where(pat.rows == pat.cols, 2.5, -1.0)
    x = np.linspace(-1.0, 1.0, N)
    return pat, vals, x - x.mean()


def _tridiag_case():
    """A tridiagonal Q whose stored upper and lower entries differ."""
    rng = np.random.default_rng(21)
    pat, vals, _ = _probe()
    vals = vals + np.where(pat.rows == pat.cols, 1.0, 0.3 * rng.normal(size=pat.nnz))
    return pat, vals


def _sparse_case():
    A = random_sparse_spd(np.random.default_rng(22), 14, density=0.2).tocoo()
    pat = JP(A.row, A.col, A.shape)
    return pat, np.asarray(A.data)[pat.sort_order]


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """Every JAX value of one backend, computed once."""
    spec = jg.SolverSpec(kind=kind, block=BLOCK.get(kind))
    jpat, base, x = _probe()
    ones, zero = jnp.ones((1, N)), jnp.zeros(1)

    def constrained(tau):
        g = jg.GMRF.from_precision(jnp.zeros(N), JSM(jnp.asarray(base) * tau, jpat), spec)
        return jg.ConstrainedGMRF.create(g, ones, zero).logpdf(jnp.asarray(x))

    def conditioned(tau):
        g = jg.GMRF.from_precision(jnp.zeros(N), JSM(jnp.asarray(base) * tau, jpat), spec)
        return jg.linear_condition(g, jnp.arange(N, dtype=jnp.float64), 2.0).mean.sum()

    def solve(pat, d, b, w):
        return jnp.sum(w * jg.factorize(JSM(d, pat), spec).solve(b))

    out = {"constrained": float(jax.jit(jax.grad(constrained))(TAU)),
           "conditioned": float(jax.jit(jax.grad(conditioned))(TAU))}
    cases = [("tridiag", _tridiag_case(), (N,))]
    if kind != "tridiag":
        cases.append(("sparse", _sparse_case(), (14, 3)))
    rng = np.random.default_rng(23)
    for name, (pat, d), bshape in cases:
        b, w = rng.normal(size=bshape), rng.normal(size=bshape)
        gd, gb = jax.jit(jax.grad(functools.partial(solve, pat), argnums=(0, 1)))(
            jnp.asarray(d), jnp.asarray(b), jnp.asarray(w))
        out[name] = dict(pat=pat, d=d, b=b, w=w, gd=np.asarray(gd), gb=np.asarray(gb))
    return out


def _port_pattern(jp):
    return SparsePattern(jp.rows, jp.cols, jp.shape)


def _port_q(kind, tau):
    jpat, base, _ = _probe()
    Q = SparseMatrix(_t(base) * tau, _port_pattern(jpat))
    return tg.GMRF.from_precision(torch.zeros(N, dtype=F64), Q, tg.SolverSpec(kind=kind, block=BLOCK.get(kind)))


@pytest.mark.parametrize("kind", KINDS)
def test_constrained_logpdf_tau_gradient_matches_jax_grad(kind):
    tau = _t(TAU, requires_grad=True)
    x = _t(_probe()[2])
    tg.ConstrainedGMRF.create(_port_q(kind, tau), np.ones((1, N)), np.zeros(1)).logpdf(x).backward()
    ref = _reference(kind)["constrained"]
    assert ref == pytest.approx(-0.17692, abs=1e-5)
    assert abs(float(tau.grad) - ref) <= TOL * abs(ref)


@pytest.mark.parametrize("kind", KINDS)
def test_linear_condition_mean_tau_gradient_matches_jax_grad(kind):
    tau = _t(TAU, requires_grad=True)
    post = tg.linear_condition(_port_q(kind, tau), np.arange(N, dtype=np.float64), 2.0)
    assert post.mean.requires_grad
    post.mean.sum().backward()
    ref = _reference(kind)["conditioned"]
    assert ref == pytest.approx(-2.50229, abs=1e-5)
    assert abs(float(tau.grad) - ref) <= TOL * abs(ref)


# the tridiagonal backend takes tridiagonal patterns only
@pytest.mark.parametrize("kind,case", [(k, "tridiag") for k in KINDS] + [(k, "sparse") for k in KINDS[1:]])
def test_solve_data_and_rhs_gradients_match_jax_grad(kind, case):
    ref = _reference(kind)[case]
    d, b = _t(ref["d"], requires_grad=True), _t(ref["b"], requires_grad=True)
    f = tg.factorize(SparseMatrix(d, _port_pattern(ref["pat"])), tg.SolverSpec(kind=kind, block=BLOCK.get(kind)))
    (f.solve(b) * _t(ref["w"])).sum().backward()
    assert _rel(d.grad.numpy(), ref["gd"]) <= TOL
    assert _rel(b.grad.numpy(), ref["gb"]) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_batched_solve_gradient_is_per_chain(kind):
    """Chains stay apart: the (B, nnz) gradient of a batched solve equals the
    single-chain gradients stacked."""
    ref = _reference(kind)["tridiag"]
    rng = np.random.default_rng(24)
    d2 = np.stack([ref["d"], ref["d"] * 1.5])
    b2, w2 = rng.normal(size=(2, N)), rng.normal(size=(2, N))
    pat = _port_pattern(ref["pat"])
    spec = tg.SolverSpec(kind=kind, block=BLOCK.get(kind))
    d = _t(d2, requires_grad=True)
    (tg.factorize(SparseMatrix(d, pat), spec).solve(_t(b2)) * _t(w2)).sum().backward()
    for c in range(2):
        dc = _t(d2[c], requires_grad=True)
        (tg.factorize(SparseMatrix(dc, pat), spec).solve(_t(b2[c])) * _t(w2[c])).sum().backward()
        assert _rel(d.grad[c].numpy(), dc.grad.numpy()) <= 1e-13


@pytest.mark.parametrize("kind", KINDS)
def test_statistics_without_backward_raise_while_q_requires_grad(kind):
    g = _port_q(kind, _t(TAU, requires_grad=True))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="no backward"):
        g.sample(gen)
    with pytest.raises(NotImplementedError, match="no backward"):
        g.var()
    with pytest.raises(NotImplementedError, match="no backward"):
        g.factor.selinv(g.Q.pattern)
    with torch.no_grad():  # without a graph they compute as before
        torch.testing.assert_close(g.var(), _port_q(kind, _t(TAU)).var(), rtol=0, atol=0)
        assert g.sample(gen).shape == (N,)


def test_cg_solve_raises_while_q_or_b_requires_grad():
    jpat, base, _ = _probe()
    pat = _port_pattern(jpat)
    b = torch.ones(N, dtype=F64)
    cg = tg.factorize(SparseMatrix(_t(base, requires_grad=True), pat), tg.SolverSpec(kind="cg"))
    with pytest.raises(NotImplementedError, match="no backward"):
        cg.solve(b)
    cg = tg.factorize(SparseMatrix(_t(base), pat), tg.SolverSpec(kind="cg"))
    with pytest.raises(NotImplementedError, match="no backward"):
        cg.solve(b.clone().requires_grad_())
    x = cg.solve(b)
    torch.testing.assert_close(SparseMatrix(_t(base), pat).matvec(x), b, rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("kind", KINDS)
def test_second_derivatives_through_a_solve_raise(kind):
    ref = _reference(kind)["tridiag"]
    d = _t(ref["d"], requires_grad=True)
    f = tg.factorize(SparseMatrix(d, _port_pattern(ref["pat"])), tg.SolverSpec(kind=kind, block=BLOCK.get(kind)))
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad((f.solve(_t(ref["b"])) ** 2).sum(), d, create_graph=True)


def test_second_derivatives_of_the_laplace_marginal_raise():
    y = np.random.default_rng(25).poisson(1.0, 20).astype(np.float64)
    theta = {"tau": _t(1.0, requires_grad=True), "rho": _t(0.5)}
    v = tg.laplace_marginal(tg.AR1Model(20), tg.ExponentialFamily("poisson"), y, theta)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(v, theta["tau"], create_graph=True)
    (g,) = torch.autograd.grad(v, theta["tau"])  # the first derivative is as before
    assert torch.isfinite(g)


def _matern32(a, b, ell=0.3):
    """Example 09's pairwise Matérn-3/2 kernel (examples/09_kl_approximation.py:30), in torch."""
    r = torch.sqrt(torch.sum((a - b) ** 2) + 1e-12)
    s = 3.0**0.5 * r / ell
    return (1.0 + s) * torch.exp(-s)


def test_linear_condition_tau_gradient_at_the_kl_setup_matches_jax_grad():
    """Phase 18's KL n = 900 case on CPU tensors: the port's Q_KL (g = 30,
    ρ = 3, jitter 1e-8), five observations drawn as phase 18 draws them,
    Q_ε = 1e4, τ = 1. The reference conditions the same Q and data."""
    g = 30
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    X = np.stack([gx.ravel(), gy.ravel()], axis=1)
    n = len(X)
    prior = tg.approximate_gmrf_kl(_t(X), gram(_matern32), rho=3.0, jitter=1e-8)
    Qd, mu0 = prior.Q.data.detach(), prior.mean.detach()
    rng = np.random.default_rng(123)
    rng.integers(0, n, size=12)  # example 09's probe columns, drawn before its observations
    obs = rng.integers(0, n, size=5)
    y = np.sin(4 * X[obs, 0]) * np.cos(3 * X[obs, 1])
    A = SparseMatrix(torch.ones(5, dtype=F64), SparsePattern(np.arange(5), obs, (5, n)))

    def conditioned(tau):
        return tg.linear_condition(tg.GMRF.from_precision(mu0, SparseMatrix(Qd * tau, prior.Q.pattern)), y,
                                   Q_eps=1e4, A=A)

    jp = JP(prior.Q.pattern.rows, prior.Q.pattern.cols, (n, n))
    jA = JSM(jnp.ones(5), JP(np.arange(5), obs, (5, n)))

    def reference(tau):
        prior_j = jg.GMRF.from_precision(jnp.asarray(mu0.numpy()), JSM(jnp.asarray(Qd.numpy()) * tau, jp))
        return jg.linear_condition(prior_j, jnp.asarray(y), 1e4, A=jA).mean.sum()

    ref = float(jax.jit(jax.grad(reference))(1.0))
    tau = _t(1.0, requires_grad=True)
    conditioned(tau).mean.sum().backward()
    # (f(1+h) − f(1−h)) / 2h = 1ᵀ Q_post(1+h)⁻¹ Q_KL (μ₀ − μ(1−h)), exactly: the difference of the two means
    # solved for directly, as no subtraction of the two sums (~80 each) could resolve it to 1e-8
    h = 1e-5
    with torch.no_grad():
        hi, lo = conditioned(_t(1.0 + h)), conditioned(_t(1.0 - h))
        cd = float(hi.factor.solve(torch.ones(n, dtype=F64)) @ SparseMatrix(Qd, prior.Q.pattern).matvec(mu0 - lo.mean))
    assert abs(float(tau.grad) - ref) <= TOL * abs(ref)
    assert abs(cd - ref) <= TOL * abs(ref)
