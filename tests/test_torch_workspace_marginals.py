"""The port's workspace layer, joint GMRF and posterior marginals against the
JAX package (float64, the same NumPy inputs) and against NumPy on the
port's own draws: `make_workspace` / `WorkspacePool.batch_evaluate` (chunked
against unchunked and against the reference's ``lax.map``), `joint_gmrf`
and `sp_bmat`, `linear_predictor_marginals` (the exponential-family branch,
constrained and on an index subset), `_pair_plan`, `_row_diag_ASigmaAt`,
`_inverse_entries`, `waic` and `conditional_predictive_ordinates`, and
`constrained_gmrf_from_numpy`.

Tolerances: log-densities, means and variances 1e-10 relative (dense
Choleskys of the same matrices in another order); the linear-predictor
marginals of a Laplace posterior 1e-8 (both packages' default Newton stop);
chunked against unchunked batch evaluation to the bit (the same batched
kernels on the same rows); WAIC and CPO against NumPy on the same draws
1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.special import logsumexp

import tpu_gmrf as jg
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop
from tpu_gmrf_torch.inference.joint import sp_bmat
from tpu_gmrf_torch.inference.marginals import _inverse_entries, _pair_plan, _row_diag_ASigmaAt
from tpu_gmrf_torch.sparse.pattern import diag_pattern, union_patterns

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


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


# ---- workspace -----------------------------------------------------------------------------------------------


def test_workspace_evaluate_matches_model_and_reference():
    model = tg.AR1Model(40)
    ws = tg.make_workspace(model, tau=1.0, rho=0.5)
    jws = jg.make_workspace(jg.AR1Model(40), tau=1.0, rho=0.5)
    assert ws.pattern == union_patterns(model.precision(_t(1.0), _t(0.5)).pattern, diag_pattern(40))
    assert ws.solver.kind == jws.solver.kind == "tridiag"
    z = np.random.default_rng(42).normal(size=40)
    for tau, rho in [(0.5, -0.8), (2.0, 0.0), (3.7, 0.95)]:
        a, b = ws.evaluate(tau=_t(tau), rho=_t(rho)), model(tau=_t(tau), rho=_t(rho))
        ref = jws.evaluate(tau=tau, rho=rho)
        assert abs(float(a.logpdf(_t(z))) / float(ref.logpdf(jnp.asarray(z))) - 1) <= 1e-10
        assert float(a.logpdf(_t(z))) == pytest.approx(float(b.logpdf(_t(z))), rel=1e-12)
        assert _rel(a.var(), ref.var()) <= 1e-10
    assert tg.make_workspace(model).evaluate(tau=_t(2.0), rho=_t(0.3)).n == 40  # θ_ref defaults to 1.0


def test_workspace_explicit_hessian_pattern_and_pool():
    model = tg.RW1Model(10)
    extra = tg.SparsePattern([0, 9], [9, 0], (10, 10))
    ws = tg.make_workspace(model, obs_hessian=extra)
    assert ws.pattern.nnz == model.precision(_t(1.0)).nnz + 2 and ws.solver.kind == "dense"
    g = ws.evaluate(tau=_t(1.3))
    assert isinstance(g, tg.ConstrainedGMRF) and abs(float(g.mean.sum())) <= 1e-12
    assert g.base.Q.pattern == ws.pattern
    pool = tg.make_workspace_pool(model, size=3)
    assert pool.size == 3 and pool.checkout() is pool.workspace
    pool.checkin(pool.workspace)
    assert pool.with_workspace(lambda w: w.pattern) == pool.workspace.pattern


@pytest.mark.parametrize("batch_size", [None, 4, 5])
def test_batch_evaluate_chunked_matches_unchunked_and_reference(batch_size):
    W = grid_adjacency(4, 3)
    model, jmodel = tg.BesagModel(W), jg.BesagModel(W)
    z = np.random.default_rng(7).normal(size=12)
    z -= z.mean()
    taus = np.linspace(0.5, 2.0, 10)
    pool = tg.make_workspace_pool(model, tau=float(taus[0]))
    fn = lambda g: (g.logpdf(_t(z)), {"mean": g.mean})
    got, extra = pool.batch_evaluate(fn, batch_size=batch_size, tau=_t(taus))
    whole, _ = pool.batch_evaluate(fn, tau=_t(taus))
    assert got.shape == (10,) and extra["mean"].shape == (10, 12)
    assert torch.equal(got, whole)
    jpool = jg.make_workspace_pool(jmodel, tau=float(taus[0]))
    ref = jpool.batch_evaluate(lambda g: g.logpdf(jnp.asarray(z)), batch_size=batch_size, tau=jnp.asarray(taus))
    # the norms come from two factorizations in another order (1e-12); the log-densities carry that
    assert _rel(got, ref) <= 1e-10
    # the analytic τ-profile of the constrained Besag logpdf (example 08's anchor): lp(τ) − lp(τ₀) =
    # (N−1)/2·ln(τ/τ₀) − ½(τ−τ₀)·q with q = zᵀQ(1)z, up to the 1e-5 ridge
    q = float(model.precision(_t(1.0)).quad(_t(z)))
    pred = 5.5 * np.log(taus / taus[0]) - 0.5 * (taus - taus[0]) * q
    assert np.abs((got - got[0]).numpy() - pred).max() <= 1e-3


# ---- joint GMRF ----------------------------------------------------------------------------------------------


def test_joint_gmrf_and_sp_bmat_match_reference():
    n, m = 8, 5
    rng = np.random.default_rng(188)
    A = sp.random(m, n, density=0.4, random_state=np.random.RandomState(3)) + sp.eye(m, n)
    b = rng.normal(size=m)
    x1 = tg.AR1Model(n)(tau=_t(1.2), rho=_t(0.4))
    jx1 = jg.AR1Model(n)(tau=1.2, rho=0.4)
    for Q_eps, jQ_eps in ((4.0, 4.0), (_t(np.linspace(1, 3, m)), jnp.linspace(1, 3, m))):
        joint = tg.joint_gmrf(x1, tg.from_scipy(A.tocsr()), Q_eps, b=_t(b))
        ref = jg.joint_gmrf(jx1, jg.from_scipy(A.tocsr()), jQ_eps, b=jnp.asarray(b))
        np.testing.assert_array_equal(joint.Q.pattern.rows, ref.Q.pattern.rows)
        np.testing.assert_array_equal(joint.Q.pattern.cols, ref.Q.pattern.cols)
        assert _rel(joint.Q.data, ref.Q.data) <= 1e-12 and _rel(joint.mean, ref.mean) <= 1e-12
        x = rng.normal(size=n + m)
        assert abs(float(joint.logpdf(_t(x))) / float(ref.logpdf(jnp.asarray(x))) - 1) <= 1e-10
    dense = tg.joint_gmrf(x1, A.toarray(), 4.0)
    assert _rel(dense.Q.todense(), tg.joint_gmrf(x1, tg.from_scipy(A.tocsr()), 4.0).Q.todense()) <= 1e-12
    blocks = sp_bmat([[tg.speye(2, dtype=F64), None], [None, tg.spdiag(_t([[2.0, 3.0], [4.0, 5.0]]))]])
    assert blocks.data.shape == (2, 4) and blocks.todense()[1].diagonal().tolist() == [1.0, 1.0, 4.0, 5.0]


# ---- linear-predictor marginals ------------------------------------------------------------------------------


def _ga(prior, lik):
    return tg.gaussian_approximation(prior, lik)


def test_linear_predictor_marginals_subset_and_constrained_match_reference():
    n = 12
    rng = np.random.default_rng(42)
    idx = np.array([2, 5, 9])
    y = rng.poisson(2.0, size=3).astype(np.float64)
    lik = tg.ExponentialFamily("poisson", indices=idx)(_t(y))
    post = _ga(tg.AR1Model(n)(tau=_t(1.0), rho=_t(0.5)), lik)
    mu, v, eta_lik = tg.linear_predictor_marginals(post, lik)
    jpost = jg.gaussian_approximation(jg.AR1Model(n)(tau=1.0, rho=0.5),
                                      jg.ExponentialFamily("poisson", indices=idx)(jnp.asarray(y)))
    jmu, jv, _ = jg.linear_predictor_marginals(jpost, jg.ExponentialFamily("poisson", indices=idx)(jnp.asarray(y)))
    assert _rel(mu, jmu) <= 1e-8 and _rel(v, jv) <= 1e-8
    assert eta_lik.indices is None and float(eta_lik.loglik(mu)) == pytest.approx(float(lik.loglik(post.mean)),
                                                                                  rel=1e-12)
    # a constrained posterior: the variances are the constrained ones
    ys = rng.poisson(1.0, size=10).astype(np.float64)
    cpost = _ga(tg.RW1Model(10)(tau=_t([1.0, 2.0])), tg.ExponentialFamily("poisson")(_t(ys)))
    mu, v, _ = tg.linear_predictor_marginals(cpost, tg.ExponentialFamily("poisson")(_t(ys)))
    with torch.no_grad():
        assert torch.equal(v, cpost.var()) and v.shape == (2, 10)
    for b, tau in enumerate((1.0, 2.0)):
        jc = jg.gaussian_approximation(jg.RW1Model(10)(tau=tau), jg.ExponentialFamily("poisson")(jnp.asarray(ys)))
        assert _rel(v[b], jc.var()) <= 1e-8
    # a likelihood with no linear predictor raises, as in the reference (the LT and composite branches are
    # held in test_torch_lt_laplace.py)
    with pytest.raises(TypeError, match="unsupported likelihood type"):
        tg.linear_predictor_marginals(post, tg.ObservationLikelihood())


@pytest.mark.parametrize("constrained", [False, True])
def test_row_diag_of_A_sigma_At_matches_dense(constrained):
    n, m = 10, 6
    A = (sp.random(m, n, density=0.5, random_state=np.random.RandomState(0)) + sp.eye(m, n)).tocsr()
    g = tg.AR1Model(n)(tau=_t(1.0), rho=_t(0.3))
    if constrained:
        g = tg.ConstrainedGMRF.create(g, np.ones((1, n)), np.zeros(1))
    base = g.base if constrained else g
    Sig = np.linalg.inv(base.Q.todense().numpy())
    if constrained:
        s = Sig.sum(1)
        Sig = Sig - np.outer(s, s) / s.sum()
    ref = np.diag(A.toarray() @ Sig @ A.toarray().T)
    assert _rel(_row_diag_ASigmaAt(tg.from_scipy(A), g), ref) <= 1e-10
    assert _rel(_row_diag_ASigmaAt(_t(A.toarray()), g), ref) <= 1e-10
    # the pairs of every row, and Σ at arbitrary positions (outside the tridiagonal envelope) by solves
    row_of_pair, va, vb, jj, kk, sig_pat, inv, _ = _pair_plan(tg.from_scipy(A).pattern)
    assert len(row_of_pair) == int((np.diff(A.indptr) ** 2).sum())
    np.testing.assert_array_equal(sig_pat.rows[inv], jj)
    np.testing.assert_array_equal(sig_pat.cols[inv], kk)
    full = np.linalg.inv(base.Q.todense().numpy())
    assert _rel(_inverse_entries(base, jj, kk), full[jj, kk]) <= 1e-10


# ---- WAIC and CPO ------------------------------------------------------------------------------------------


def test_waic_and_cpo_match_numpy_on_the_same_draws():
    n, S = 15, 300
    y = np.random.default_rng(42).poisson(2.0, size=n).astype(np.float64)
    lik = tg.ExponentialFamily("poisson")(_t(y))
    with torch.no_grad():
        post = _ga(tg.AR1Model(n)(tau=_t(1.0), rho=_t(0.5)), lik)
        w, elpd, p_eff = tg.waic(post, lik, torch.Generator().manual_seed(0), num_samples=S)
        log_cpo = tg.conditional_predictive_ordinates(post, lik, torch.Generator().manual_seed(1), S)
        draws = [post.sample(torch.Generator().manual_seed(s), (S,)).numpy() for s in (0, 1)]
    lp = [y * x - np.exp(x) - np.array([np.sum(np.log(np.arange(1, k + 1))) for k in y]) for x in draws]
    lppd = logsumexp(lp[0], 0) - np.log(S)
    pe = np.var(lp[0], 0, ddof=1)
    assert abs(float(elpd) - np.sum(lppd - pe)) <= 1e-10 * abs(np.sum(lppd - pe))
    assert abs(float(p_eff) - pe.sum()) <= 1e-10 * pe.sum() and float(w) == pytest.approx(-2 * float(elpd))
    assert _rel(log_cpo, np.log(S) - logsumexp(-lp[1], 0)) <= 1e-10 and log_cpo.shape == (n,)
    # per chain on a batched constrained posterior
    with torch.no_grad():
        cpost = _ga(tg.RW1Model(n)(tau=_t([1.0, 3.0])), lik)
        wb, _, peb = tg.waic(cpost, lik, torch.Generator().manual_seed(2), num_samples=50)
    assert wb.shape == (2,) and bool(torch.isfinite(wb).all()) and bool((peb > 0).all())


def test_constrained_gmrf_from_numpy_matches_reference():
    jb = jg.RW1Model(9)(tau=1.4)
    c = interop.constrained_gmrf_from_numpy(np.asarray(jb.base.mean), jb.Q.pattern.rows, jb.Q.pattern.cols,
                                            jb.Q.shape, np.asarray(jb.Q.data), np.asarray(jb.A), np.asarray(jb.e))
    x = np.asarray(jb.project(jnp.asarray(np.random.default_rng(0).normal(size=9))))
    assert abs(float(c.logpdf(_t(x))) / float(jb.logpdf(jnp.asarray(x))) - 1) <= 1e-10
    assert _rel(c.var(), jb.var()) <= 1e-10
