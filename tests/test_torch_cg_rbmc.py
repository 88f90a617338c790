"""The port's CG backend (`cg_solve`, its preconditioners, `CGFactor`), the
RBMC variance estimators, the linear maps and the GMRF additions of this
slice against the JAX package in float64 on the same NumPy inputs.

Tolerances: CG solutions 1e-8 relative (both stop below the same residual),
iteration counts equal or ±1 (the stopping test sits on a rounding edge);
RBMC given the same standard-normal draws 1e-8; the linear maps 1e-12.
The reference solves k right-hand sides as (n, k) columns, the port's
`cg_solve` takes rows (k, n); the factors of both take (n, k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf import linear_maps as jlm
from tpu_gmrf.solvers import cg as jcg
from tpu_gmrf.solvers import rbmc as jrbmc
from tpu_gmrf.solvers.base import SolverSpec as JaxSolverSpec
from tpu_gmrf.solvers.base import factorize as jax_factorize
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
from tpu_gmrf_torch import set_default_device
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import gmrf as tgmrf
from tpu_gmrf_torch import linear_maps as tlm
from tpu_gmrf_torch.models import grid_matern2_precision
from tpu_gmrf_torch.solvers import cg as tcg
from tpu_gmrf_torch.solvers import rbmc as trbmc
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64


def _t(a, dtype=F64, **kw):
    return torch.tensor(np.asarray(a), dtype=dtype, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _canonical(A):
    A = A.tocoo()
    order = np.lexsort((A.col, A.row))
    return A.row[order], A.col[order], A.data[order]


def _random_spd(n, seed, density=0.05):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(seed))
    A = A + A.T
    return (A + sp.eye(n) * (abs(A).sum(1).max() + 1.0)).tocsr()


def _both(A):
    r, c, v = _canonical(A)
    return JSM(jnp.asarray(v), JP(r, c, A.shape)), SparseMatrix(_t(v), SparsePattern(r, c, A.shape))


def _space_time(ns=6, nt=5, seed=0):
    """A block-tridiagonal SPD matrix over nt slices of ns: both packages' maps."""
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(nt, ns, ns))
    diag = diag @ diag.transpose(0, 2, 1) + 2.0 * ns * np.eye(ns)
    sub = 0.5 * rng.normal(size=(nt - 1, ns, ns))
    return diag, sub


# ---- cg_solve and its preconditioners ------------------------------------------------


def _preconditioner(mod, Q, name):
    return {"none": lambda: None, "jacobi": lambda: mod.jacobi_preconditioner(Q),
            "block_jacobi": lambda: mod.block_jacobi_preconditioner(Q, 16),
            "full_cholesky": lambda: mod.full_cholesky_preconditioner(Q)}[name]()


@pytest.mark.parametrize("precond", ["none", "jacobi", "block_jacobi", "full_cholesky"])
def test_cg_solve_matches_reference(precond):
    n = 60
    A = _random_spd(n, 1) + sp.diags(np.linspace(0.0, 40.0, n))  # spread the spectrum: tens of iterations
    jq, tq = _both(A.tocsr())
    b = np.random.default_rng(2).normal(size=n)
    x_ref, it_ref, res_ref = jcg.cg_solve(jq.matvec, jnp.asarray(b), preconditioner=_preconditioner(jcg, jq, precond),
                                          tol=1e-10)
    x, it, res = tcg.cg_solve(tq.matvec, _t(b), preconditioner=_preconditioner(tcg, tq, precond), tol=1e-10)
    assert x.shape == (n,) and it.ndim == 0 and res.ndim == 0
    assert _rel(x.numpy(), x_ref) <= 1e-8
    assert abs(int(it) - int(it_ref)) <= 1
    assert (int(it) == 1) == (precond == "full_cholesky")
    assert float(res) <= 1e-10
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-8)


def test_cg_temporal_gauss_seidel_matches_reference():
    diag, sub = _space_time()
    jq = jlm.block_tridiag_to_sparse(jlm.SymmetricBlockTridiagonalMap(jnp.asarray(diag), jnp.asarray(sub)))
    tq = tlm.block_tridiag_to_sparse(tlm.SymmetricBlockTridiagonalMap(_t(diag), _t(sub)))
    b = np.random.default_rng(3).normal(size=tq.shape[0])
    for sweeps in (1, 2):
        x_ref, it_ref, _ = jcg.cg_solve(
            jq.matvec, jnp.asarray(b), tol=1e-10,
            preconditioner=jcg.temporal_block_gauss_seidel_preconditioner(jq, 6, 5, sweeps))
        M = tcg.temporal_block_gauss_seidel_preconditioner(tq, 6, 5, sweeps)
        x, it, _ = tcg.cg_solve(tq.matvec, _t(b), preconditioner=M, tol=1e-10)
        assert _rel(x.numpy(), x_ref) <= 1e-8
        assert abs(int(it) - int(it_ref)) <= 1
    _, it_plain, _ = tcg.cg_solve(tq.matvec, _t(b), tol=1e-10)
    assert int(it) < int(it_plain)
    # rows through the preconditioner are columns through it
    r = _t(np.random.default_rng(4).normal(size=(3, tq.shape[0])))
    np.testing.assert_allclose(M(r)[1].numpy(), M(r[1]).numpy(), rtol=1e-12)


def test_cg_solve_rows_stop_on_their_own():
    """Several right-hand sides as rows of one masked loop: each row stops at
    its own iteration and equals its solo solve; a zero row never starts."""
    n = 80
    A = (_random_spd(n, 5) + sp.diags(np.linspace(0.0, 60.0, n))).tocsr()
    _, tq = _both(A)
    rng = np.random.default_rng(6)
    # A v = λ diag(A) v: Jacobi-preconditioned CG ends after as many iterations as b = A x has such v in x
    _, V = scipy.linalg.eigh(A.toarray(), np.diag(A.diagonal()))
    b = np.stack([rng.normal(size=n), np.zeros(n), A @ V[:, 0], A @ (V[:, 0] + V[:, 30] + V[:, 60])])
    M = tcg.jacobi_preconditioner(tq)
    x, it, res = tcg.cg_solve(tq.matvec, _t(b), preconditioner=M, tol=1e-9)
    assert it.tolist()[1] == 0 and len(set(it.tolist())) >= 3
    assert torch.isfinite(x).all() and torch.isfinite(res).all()
    for j in range(4):
        xj, itj, resj = tcg.cg_solve(tq.matvec, _t(b[j]), preconditioner=M, tol=1e-9)
        assert int(itj) == int(it[j])
        np.testing.assert_allclose(x[j].numpy(), xj.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(res[j]), float(resj), rtol=1e-9, atol=1e-300)
    # max_iter freezes every row where it stands
    x2, it2, _ = tcg.cg_solve(tq.matvec, _t(b), preconditioner=M, tol=1e-9, max_iter=3)
    assert it2.tolist() == [min(3, i) for i in it.tolist()]


# ---- the CG backend ------------------------------------------------------------------


def test_cg_factor_columns_match_reference():
    n = 80
    A = (_random_spd(n, 7) + sp.diags(np.linspace(0.0, 60.0, n))).tocsr()
    jq, tq = _both(A)
    rng = np.random.default_rng(8)
    # A v = λ diag(A) v: Jacobi-preconditioned CG ends after as many iterations as b = A x has such v in x
    _, V = scipy.linalg.eigh(A.toarray(), np.diag(A.diagonal()))
    b = np.stack([rng.normal(size=n), A @ V[:, 5], A @ (V[:, 0] + V[:, 30] + V[:, 60])], axis=1)  # (n, 3)
    spec = dict(kind="cg", cg_tol=1e-9, cg_max_iter=500)
    ref = jax_factorize(jq, JaxSolverSpec(**spec)).solve(jnp.asarray(b))  # vmapped over the columns
    f = tg.factorize(tq, tg.SolverSpec(**spec))
    x, it, res = f.solve_info(_t(b))
    assert x.shape == (n, 3) and it.shape == (3,) and res.shape == (3,)
    assert _rel(x.numpy(), ref) <= 1e-8
    assert _rel(f.solve(_t(b[:, 0])).numpy(), np.asarray(ref)[:, 0]) <= 1e-8
    its = [int(jcg.cg_solve(jq.matvec, jnp.asarray(b[:, j]), preconditioner=jcg.jacobi_preconditioner(jq),
                            tol=1e-9, max_iter=500)[1]) for j in range(3)]
    assert len(set(its)) > 1  # the columns stop at different iterations
    assert all(abs(a - b_) <= 1 for a, b_ in zip(it.tolist(), its))
    assert float(res.max()) <= 1e-9


def test_cg_factor_one_matrix_per_chain():
    n = 50
    A = _random_spd(n, 9)
    _, tq = _both(A)
    scale = _t([[1.0], [4.0]])
    f = tg.factorize(SparseMatrix(tq.data[None] * scale, tq.pattern), tg.SolverSpec(kind="cg"))
    assert f.batch_shape == (2,)
    b = _t(np.random.default_rng(10).normal(size=(2, n)))
    x = f.solve(b)
    np.testing.assert_allclose((tq.matvec(x) * scale).numpy(), b.numpy(), atol=1e-6)
    bk = _t(np.random.default_rng(11).normal(size=(2, n, 2)))
    np.testing.assert_allclose(f.solve(bk)[..., 1].numpy(), f.solve(bk[..., 1].contiguous()).numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="does not match"):
        f.solve(b[0])


@pytest.mark.parametrize("what", ["logdet", "backward_solve", "selinv_diag", "selinv"])
def test_cg_factor_raises_with_the_reference_message(what):
    jq, tq = _both(_random_spd(20, 12))
    args = {"logdet": (), "selinv_diag": ()}
    jf, tf = jax_factorize(jq, JaxSolverSpec(kind="cg")), tg.factorize(tq, tg.SolverSpec(kind="cg"))
    with pytest.raises(NotImplementedError) as ref:
        getattr(jf, what)(*args.get(what, (None,)))
    with pytest.raises(NotImplementedError) as got:
        getattr(tf, what)(*args.get(what, (None,)))
    assert str(got.value) == str(ref.value)
    assert (tg.SolverSpec().cg_tol, tg.SolverSpec().cg_max_iter) == (JaxSolverSpec().cg_tol, JaxSolverSpec().cg_max_iter)


def test_from_information_on_the_cg_backend():
    n = 60
    A = _random_spd(n, 13)
    jq, tq = _both(A)
    b = np.random.default_rng(14).normal(size=n)
    ref = jg.GMRF.from_information(jnp.asarray(b), jq, JaxSolverSpec(kind="cg"))
    g = tg.GMRF.from_information(b, tq, tg.SolverSpec(kind="cg"))
    assert _rel(g.mean.numpy(), ref.mean) <= 1e-7
    np.testing.assert_allclose(g.information_vector().numpy(), b, atol=1e-6)
    with pytest.raises(NotImplementedError, match="logdet"):
        g.logpdf(_t(b))


# ---- GMRF additions --------------------------------------------------------------------


def test_gmrf_from_information_arithmetic_and_aliases():
    n = 30
    jq, tq = _both(_random_spd(n, 15, 0.1))
    rng = np.random.default_rng(16)
    b, v, x = rng.normal(size=n), rng.normal(size=n), rng.normal(size=n)
    ref, g = jg.GMRF.from_information(jnp.asarray(b), jq), tg.GMRF.from_information(b, tq)
    assert _rel(g.mean.numpy(), ref.mean) <= 1e-10
    for got, want in (((g + v), (ref + v)), ((_t(v) + g), (jnp.asarray(v) + ref)), ((g - v), (ref - v))):
        assert _rel(got.mean.numpy(), want.mean) <= 1e-10
        assert got.factor is g.factor
    import tpu_gmrf.gmrf as jgm

    np.testing.assert_allclose(tgmrf.logpdf(g, _t(x)).item(), float(jgm.logpdf(ref, jnp.asarray(x))), rtol=1e-10)
    assert _rel(tgmrf.gradlogpdf(g, _t(x)).numpy(), jgm.gradlogpdf(ref, jnp.asarray(x))) <= 1e-10
    assert _rel(tgmrf.information_vector(g).numpy(), jgm.information_vector(ref)) <= 1e-10
    assert tgmrf.sample(torch.Generator().manual_seed(0), g, (3,)).shape == (3, n)
    assert _rel(tq.todense().numpy(), jq.todense()) <= 1e-15
    batched = SparseMatrix(torch.stack([tq.data, 2 * tq.data]), tq.pattern).todense()
    np.testing.assert_allclose(batched[1].numpy(), 2 * np.asarray(jq.todense()), rtol=1e-15)


# ---- RBMC -------------------------------------------------------------------------------


def _gmrfs(n=40, seed=17):
    jq, tq = _both(_random_spd(n, seed, 0.08))
    return jg.GMRF.from_precision(jnp.zeros(n), jq), tg.GMRF.from_precision(np.zeros(n), tq)


def test_rbmc_var_same_draws_matches_reference():
    ref_g, g = _gmrfs()
    key, S = jax.random.PRNGKey(0), 200
    ref = jrbmc.rbmc_var(ref_g, key, n_samples=S)
    z = np.asarray(jax.random.normal(key, (S, len(g)), dtype=ref_g.dtype))  # the draws `sample` makes from the key
    got = trbmc.rbmc_var(g, None, n_samples=S, _z=_t(z))
    assert _rel(got.numpy(), ref) <= 1e-8


@pytest.mark.parametrize("enclosure", [1, 2])
def test_block_rbmc_var_same_draws_matches_reference(enclosure):
    ref_g, g = _gmrfs()
    for a, b in zip(trbmc._block_rbmc_plan(g.Q.pattern, enclosure), jrbmc._block_rbmc_plan(ref_g.Q.pattern, enclosure)):
        np.testing.assert_array_equal(a, b)
    key, S = jax.random.PRNGKey(1), 100
    ref = jrbmc.block_rbmc_var(ref_g, key, n_samples=S, enclosure_size=enclosure)
    z = np.asarray(jax.random.normal(key, (S, len(g)), dtype=ref_g.dtype))
    got = trbmc.block_rbmc_var(g, None, n_samples=S, enclosure_size=enclosure, _z=_t(z))
    assert _rel(got.numpy(), ref) <= 1e-8


def test_rbmc_estimators_converge_to_selinv_diag():
    _, g = _gmrfs(n=20, seed=18)
    exact = g.var().numpy()
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_allclose(trbmc.rbmc_var(g, gen, n_samples=4000).numpy(), exact, rtol=0.15)
    np.testing.assert_allclose(trbmc.block_rbmc_var(g, gen, n_samples=400).numpy(), exact, rtol=0.15)
    with pytest.raises(ValueError, match="not a batch"):
        Qb = SparseMatrix(torch.stack([g.Q.data, g.Q.data]), g.Q.pattern)
        trbmc.rbmc_var(tg.GMRF.from_precision(np.zeros(20), Qb), gen, 10)


# ---- linear maps ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["SymmetricBlockTridiagonalMap", "SSMBidiagonalMap"])
def test_block_maps_match_reference(name):
    diag, sub = _space_time(seed=19)
    ref, got = getattr(jlm, name)(jnp.asarray(diag), jnp.asarray(sub)), getattr(tlm, name)(_t(diag), _t(sub))
    assert (got.nt, got.ns, got.shape) == (ref.nt, ref.ns, ref.shape)
    x = np.random.default_rng(20).normal(size=30)
    assert _rel(got.matvec(_t(x)).numpy(), ref.matvec(jnp.asarray(x))) <= 1e-12
    assert _rel((got @ _t(x)).numpy(), ref @ jnp.asarray(x)) <= 1e-12


def test_outer_product_and_zero_maps_match_reference():
    rng = np.random.default_rng(21)
    Bm, M, x = rng.normal(size=(12, 3)), rng.normal(size=(3, 3)), rng.normal(size=12)
    ref, got = jlm.OuterProductMap(jnp.asarray(Bm), jnp.asarray(M)), tlm.OuterProductMap(_t(Bm), _t(M))
    assert got.shape == ref.shape
    assert _rel((got @ _t(x)).numpy(), ref @ jnp.asarray(x)) <= 1e-12
    assert tlm.ZeroMap(12).shape == jlm.ZeroMap(12).shape
    assert not (tlm.ZeroMap(12) @ _t(x)).any()


def test_block_tridiag_to_sparse_matches_reference():
    diag, sub = _space_time(seed=22)
    ref = jlm.block_tridiag_to_sparse(jlm.SymmetricBlockTridiagonalMap(jnp.asarray(diag), jnp.asarray(sub)))
    m = tlm.SymmetricBlockTridiagonalMap(_t(diag), _t(sub))
    got = tlm.block_tridiag_to_sparse(m)
    np.testing.assert_array_equal(got.pattern.rows, ref.pattern.rows)
    np.testing.assert_array_equal(got.pattern.cols, ref.pattern.cols)
    assert _rel(got.data.numpy(), ref.data) <= 1e-15
    x = _t(np.random.default_rng(23).normal(size=30))
    np.testing.assert_allclose(got.matvec(x).numpy(), m.matvec(x).numpy(), rtol=1e-12)
    # the SSM square root squares to a symmetric block-tridiagonal precision
    L = tlm.SSMBidiagonalMap(_t(diag), _t(sub))
    dense = torch.stack([L.matvec(e) for e in torch.eye(30, dtype=F64)], 1)
    np.testing.assert_allclose((dense @ dense.T).numpy(), (dense @ dense.T).T.numpy(), rtol=1e-12)


# ---- the grid precision helper -------------------------------------------------------------


def test_grid_matern2_precision_matches_the_reference_helper():
    from test_scale import _grid_matern2_precision

    ref, got = _grid_matern2_precision(12), grid_matern2_precision(12, dtype=torch.float32)
    np.testing.assert_array_equal(got.pattern.rows, ref.pattern.rows)
    np.testing.assert_array_equal(got.pattern.cols, ref.pattern.cols)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert got.pattern.is_symmetric and got.shape == (144, 144)
