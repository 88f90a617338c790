"""The port's non-Gaussian latent priors and sparse autodiff maps against the
JAX package, float64, on the same NumPy inputs: `StructuredLatentPrior` and
`AutoDiffLatentPrior` (log-density and local quadratic), `detect_hessian_pattern`,
`pattern_column_coloring`, `sparse_jacobian_map`, `sparse_hessian_map` and
`ADJacobianMap`; the re-linearized Laplace mode of the Student-t random walk
(``tests/test_nongaussian_priors.py``) and `marginal_loglikelihood` with its
θ-gradient through `NewtonModeNL`'s implicit-function backward, unbatched and
at B = 3 chains.

Tolerances: log-densities, gradients, Hessians and sparse maps rtol 1e-10
(the same formulas, autodiff in another order); patterns and colours exactly;
the Laplace mode 1e-8 and the marginal and its θ-gradient 1e-8 (both sides
stop Newton at the same tolerances).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf import linear_maps as jlm
from tpu_gmrf.sparse.pattern import SparsePattern as JPattern
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import linear_maps as tlm
from tpu_gmrf_torch.sparse import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
B = 3


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(got, ref, rtol=1e-10, atol=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def _same_pattern(tp, jp):
    assert tp.shape == jp.shape
    assert np.array_equal(tp.rows, jp.rows) and np.array_equal(tp.cols, jp.cols)


# ---- the Student-t random walk (tests/test_nongaussian_priors.py:55-88) ----------

NU = 4.0


def _rw_factor(np_):
    def f(v, log_tau, **_):
        d = (v[1] - v[0]) * np_.exp(log_tau)
        return -0.5 * (NU + 1) * np_.log1p(d**2 / NU) + log_tau
    return f


def _anchor(v, **_):
    return -0.5 * v[0] ** 2 / 100.0


def _rw_prior(M, n, log_tau):
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    np_ = jnp if M is jg else torch
    return M.StructuredLatentPrior.create(
        n, [M.FactorGroup(idx, _rw_factor(np_)), M.FactorGroup(np.arange(n)[:, None], _anchor)],
        theta={"log_tau": log_tau})


def _rw_density(np_, n):
    """The same log-density as one function of x (n,), for AutoDiffLatentPrior."""

    def fn(x, log_tau):
        d = (x[1:] - x[:-1]) * np_.exp(log_tau)
        return np_.sum(-0.5 * (NU + 1) * np_.log1p(d**2 / NU) + log_tau) - 0.5 * np_.sum(x**2) / 100.0
    return fn


def _quartic(np_):
    return lambda v, a, **_: -a * (v[1] - v[0]) ** 4


@pytest.mark.parametrize("batched", [False, True])
def test_structured_prior_log_density_and_quadratic(batched):
    rng = np.random.default_rng(0)
    n = 10
    idx = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    a = np.array([0.3, 0.7, 1.1])
    x = rng.normal(size=(B, n))
    tp = tg.StructuredLatentPrior.create(n, [tg.FactorGroup(idx, _quartic(torch)),
                                             tg.FactorGroup(idx[::2], _rw_factor(torch))],
                                         theta={"a": _t(a if batched else a[0]), "log_tau": _t(0.2)})

    def ref(ab, xb):
        p = jg.StructuredLatentPrior.create(n, [jg.FactorGroup(idx, _quartic(jnp)),
                                                jg.FactorGroup(idx[::2], _rw_factor(jnp))],
                                            theta={"a": ab, "log_tau": jnp.asarray(0.2)})
        Q, h = p.local_quadratic(xb)
        return p.log_density(xb), Q.data, h, jax.grad(p.log_density)(xb)

    want = [np.asarray(r) for r in jax.jit(jax.vmap(ref))(jnp.asarray(a if batched else np.full(B, a[0])),
                                                         jnp.asarray(x))]
    xt = _t(x) if batched else _t(x[0])
    pick = (lambda r: r) if batched else (lambda r: r[0])
    Q, h = tp.local_quadratic(xt)
    _close(tp.log_density(xt), pick(want[0]))
    _close(Q.data, pick(want[1]))
    _close(h, pick(want[2]))
    _close(tp.grad_log_density(xt), pick(want[3]))
    # the pattern: the diagonal ∪ the factors' blocks, as the reference builds it
    full = jg.StructuredLatentPrior.create(n, [jg.FactorGroup(idx, _quartic(jnp)), jg.FactorGroup(idx[::2], _anchor)])
    _same_pattern(tp.pattern, full.pattern)
    assert all(np.array_equal(t_, j_.arr) for t_, j_ in zip(tp.posmaps, full.posmaps))


@pytest.mark.parametrize("hessian", ["dense", "diag", "pattern"])
def test_autodiff_prior_log_density_and_quadratic(hessian):
    rng = np.random.default_rng(1)
    n = 12
    x = rng.normal(scale=0.7, size=(B, n))
    lt = np.array([0.1, -0.4, 0.6])
    if hessian == "diag":
        fj = lambda x, log_tau: jnp.sum(-jnp.exp(log_tau) * x**2 - 0.1 * x**4)
        ft = lambda x, log_tau: torch.sum(-torch.exp(log_tau) * x**2 - 0.1 * x**4)
        hj = ht = "diag"
    else:
        fj, ft = _rw_density(jnp, n), _rw_density(torch, n)
        hj, ht = "dense", "dense"
        if hessian == "pattern":
            hj = jg.detect_hessian_pattern(fj, n, {"log_tau": 0.3})
            ht = tg.detect_hessian_pattern(ft, n, {"log_tau": 0.3})
            _same_pattern(ht, hj)
    tp = tg.AutoDiffLatentPrior(theta={"log_tau": _t(lt)}, fn=ft, n=n, hessian=ht)

    def ref(ltb, xb):
        p = jg.AutoDiffLatentPrior(theta={"log_tau": ltb}, fn=fj, n=n, hessian=hj)
        Q, h = p.local_quadratic(xb)
        return p.log_density(xb), Q.data, h

    want = [np.asarray(r) for r in jax.jit(jax.vmap(ref))(jnp.asarray(lt), jnp.asarray(x))]
    Q, h = tp.local_quadratic(_t(x))
    _close(tp.log_density(_t(x)), want[0])
    _close(Q.data, want[1])
    _close(h, want[2])
    one = tg.AutoDiffLatentPrior(theta={"log_tau": _t(lt[0])}, fn=ft, n=n, hessian=ht)
    _close(one.local_quadratic(_t(x[0]))[0].data, want[1][0])


def test_sparse_ad_maps():
    rng = np.random.default_rng(2)
    n = 14
    fj = lambda x: jnp.concatenate([x[1:] * x[:-1], jnp.exp(x[::3])])
    ft = lambda x: torch.cat([x[1:] * x[:-1], torch.exp(x[::3])])
    m = n - 1 + len(range(0, n, 3))
    rows = np.concatenate([np.arange(n - 1), np.arange(n - 1), n - 1 + np.arange(m - n + 1)])
    cols = np.concatenate([np.arange(n - 1), np.arange(1, n), np.arange(0, n, 3)])
    jpat, tpat = JPattern(rows, cols, (m, n)), SparsePattern(rows, cols, (m, n))
    tc, tk = tlm.pattern_column_coloring(tpat, n)
    jc, jk = jlm.pattern_column_coloring(jpat, n)
    assert tk == jk and np.array_equal(tc, jc)
    x = rng.normal(size=(B, n))
    J = tlm.sparse_jacobian_map(ft, _t(x), tpat)
    want = np.stack([np.asarray(jlm.sparse_jacobian_map(fj, jnp.asarray(x[b]), jpat).data) for b in range(B)])
    _close(J.data, want)
    _close(tlm.sparse_jacobian_map(ft, _t(x[0]), tpat).data, want[0])
    # the Hessian map on the tridiagonal pattern: 3 colours
    gj = lambda x: jnp.sum(jnp.sin(x[1:] * x[:-1])) + jnp.sum(x**3)
    gt = lambda x: torch.sum(torch.sin(x[1:] * x[:-1])) + torch.sum(x**3)
    i = np.arange(n)
    hr, hc = np.concatenate([i, i[1:], i[:-1]]), np.concatenate([i, i[:-1], i[1:]])
    hj, ht = JPattern(hr, hc, (n, n)), SparsePattern(hr, hc, (n, n))
    assert tlm.pattern_column_coloring(ht, n)[1] == 3
    H = tlm.sparse_hessian_map(gt, _t(x), ht)
    want = np.stack([np.asarray(jlm.sparse_hessian_map(gj, jnp.asarray(x[b]), hj).data) for b in range(B)])
    _close(H.data, want)
    # the lazy Jacobian
    jm, tm = jlm.ADJacobianMap(fj, jnp.asarray(x[0])), tlm.ADJacobianMap(ft, _t(x[0]))
    assert tm.shape == jm.shape == (m, n)
    v, w = rng.normal(size=n), rng.normal(size=m)
    _close(tm.matvec(_t(v)), jm.matvec(jnp.asarray(v)))
    _close(tm.rmatvec(_t(w)), jm.rmatvec(jnp.asarray(w)))
    tb = tlm.ADJacobianMap(ft, _t(x))
    _close(tb.matvec(_t(v))[2], jlm.ADJacobianMap(fj, jnp.asarray(x[2])).matvec(jnp.asarray(v)))
    _close(tb.rmatvec(_t(w))[1], jlm.ADJacobianMap(fj, jnp.asarray(x[1])).rmatvec(jnp.asarray(w)))


def test_detect_hessian_pattern():
    n = 16

    def fj(x, c):
        return jnp.sum(jnp.cos(x[2:] - x[:-2])) * c + x[0] * x[-1] + jnp.sum(x**4)

    def ft(x, c):
        return torch.sum(torch.cos(x[2:] - x[:-2])) * c + x[0] * x[-1] + torch.sum(x**4)

    _same_pattern(tg.detect_hessian_pattern(ft, n, {"c": 0.5}), jg.detect_hessian_pattern(fj, n, {"c": 0.5}))
    with pytest.raises(ValueError, match="8192"):
        tg.detect_hessian_pattern(ft, 8193)


# ---- the Laplace mode and the marginal ------------------------------------------

def test_student_t_rw_mode():
    """The reference test's model and data (normal observations, σ = 0.7)."""
    n = 25
    rng = np.random.default_rng(42)
    y = rng.normal(size=n) + np.linspace(0, 3, n)
    lt = float(np.log(1 / 0.5))
    jmode = jax.jit(lambda l: jg.gaussian_approximation(_rw_prior(jg, n, l),
                                                         jg.ExponentialFamily("normal")(y, sigma=0.7)).mean)
    post = tg.gaussian_approximation(_rw_prior(tg, n, _t(lt)), tg.ExponentialFamily("normal")(y, sigma=_t(0.7)))
    _close(post.mean, jmode(jnp.asarray(lt)), rtol=1e-8, atol=1e-8)
    assert post.solver.resolve(post.Q.pattern).kind == "tridiag"


def _poisson_y(n, seed):
    return np.random.default_rng(seed).poisson(2.0, size=n).astype(np.float64)


ML_N, ML_LTS = 20, np.array([0.2, -0.3, 0.7])


@functools.lru_cache(maxsize=None)
def _ml_reference():
    """The reference's marginal and its log_tau-gradient at ML_LTS, one jitted program."""
    y = _poisson_y(ML_N, 3)

    def jml(l):
        return jg.marginal_loglikelihood(_rw_prior(jg, ML_N, l), jg.ExponentialFamily("poisson")(y))

    v, g = jax.jit(jax.vmap(jax.value_and_grad(jml)))(jnp.asarray(ML_LTS))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("batched", [False, True])
def test_marginal_and_gradient(batched):
    n, lts = ML_N, ML_LTS
    y = _poisson_y(n, 3)
    want_v, want_g = _ml_reference()
    lt = _t(lts if batched else lts[0]).requires_grad_()
    v = tg.marginal_loglikelihood(_rw_prior(tg, n, lt), tg.ExponentialFamily("poisson")(y))
    v.sum().backward()
    pick = (lambda r: r) if batched else (lambda r: r[0])
    _close(v, pick(want_v), rtol=1e-8)
    _close(lt.grad, pick(want_g), rtol=1e-8)


def test_autodiff_prior_marginal_gradient():
    """An AutoDiffLatentPrior on the tridiagonal pattern (coloured HVPs) gives
    the structured prior's mode, marginal and gradient; the likelihood's σ
    gets its cotangent through the same backward."""
    n = 15
    rng = np.random.default_rng(4)
    y = rng.normal(size=n) + np.linspace(0, 2, n)
    i = np.arange(n)
    rows, cols = np.concatenate([i, i[1:], i[:-1]]), np.concatenate([i, i[:-1], i[1:]])
    pat = SparsePattern(rows, cols, (n, n))
    lts, sig = np.array([0.1, 0.5, -0.2]), 0.6

    def jml(l, s):
        p = jg.AutoDiffLatentPrior(theta={"log_tau": l}, fn=_rw_density(jnp, n), n=n,
                                   hessian=JPattern(rows, cols, (n, n)))
        return jg.marginal_loglikelihood(p, jg.ExponentialFamily("normal", link="log")(y, sigma=s))

    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(jml, (0, 1)), (0, None)))(jnp.asarray(lts), sig)
    want_g = [np.asarray(g) for g in want_g]
    lt, s = _t(lts).requires_grad_(), _t(sig).requires_grad_()
    prior = tg.AutoDiffLatentPrior(theta={"log_tau": lt}, fn=_rw_density(torch, n), n=n, hessian=pat)
    v = tg.marginal_loglikelihood(prior, tg.ExponentialFamily("normal", link="log")(y, sigma=s))
    v.sum().backward()
    _close(v, want_v, rtol=1e-8)
    _close(lt.grad, want_g[0], rtol=1e-8)
    _close(s.grad, want_g[1].sum(), rtol=1e-8)


def test_autodiff_prior_matches_gaussian_path():
    """The non-Gaussian machinery on a Gaussian prior (AR1 as a log-density)
    reproduces the Gaussian Laplace approximation, and a TMB-style joint
    (the data in the prior, ZeroLikelihood) gives the same mode."""
    n = 15
    y = _poisson_y(n, 5)
    Q = tg.AR1Model(n).precision(_t(1.2), _t(0.6))
    Qd = Q.todense()
    logdet = float(torch.linalg.slogdet(Qd)[1])

    def fn(x, scale):
        return 0.5 * logdet * scale - 0.5 * x @ (Qd @ x) - 0.5 * n * np.log(2 * np.pi)

    lik = tg.ExponentialFamily("poisson")(y)
    post_g = tg.gaussian_approximation(tg.AR1Model(n)(tau=_t(1.2), rho=_t(0.6)), lik)
    prior_ad = tg.AutoDiffLatentPrior(theta={"scale": _t(1.0)}, fn=fn, n=n)
    post_ad = tg.gaussian_approximation(prior_ad, lik)
    _close(post_ad.mean, post_g.mean, rtol=1e-6, atol=1e-6)
    _close(post_ad.Q.todense(), post_g.Q.todense(), rtol=1e-6)
    _close(tg.marginal_loglikelihood(prior_ad, lik, posterior=post_ad),
           tg.marginal_loglikelihood(tg.AR1Model(n)(tau=_t(1.2), rho=_t(0.6)), lik, posterior=post_g), rtol=1e-7)
    yt = _t(y)
    joint = tg.AutoDiffLatentPrior(theta={"d": _t(0.0)}, fn=lambda x, d: -0.5 * x @ (Qd @ x) + torch.sum(yt * x - torch.exp(x)),
                                   n=n)
    _close(tg.gaussian_approximation(joint, tg.ZeroLikelihood()).mean, post_g.mean, rtol=1e-6, atol=1e-6)
