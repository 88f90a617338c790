"""The port's rectangular `SparseMatrix` products (K4 on m × n patterns,
`rmatvec`, K5's SpGEMM of (n × m)·(m × n)), its sparse constructors,
`linear_condition` (every branch) and `ConstrainedGMRF` against the JAX
package in float64 on the same NumPy inputs.

Tolerances: products and constructors 1e-13 relative (sums of a few terms in
another order); conditioned means, variances and log-densities and the
constrained statistics 1e-9 relative (both sides run a dense Cholesky of the
same posterior precision, in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.matrix import from_dense as j_from_dense
from tpu_gmrf.sparse.matrix import from_scipy as j_from_scipy
from tpu_gmrf.sparse.matrix import speye as j_speye
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels
from tpu_gmrf_torch.sparse.matrix import SparseMatrix, from_dense, from_scipy, sp_matmul, speye
from tests.conftest import random_sparse_spd

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _rect(m, n, seed):
    """A random m × n sparse matrix with at least one entry in every row and column."""
    rs = np.random.RandomState(seed)
    A = sp.random(m, n, density=0.25, random_state=rs).tolil()
    for i in range(m):
        A[i, rs.randint(n)] = rs.normal()
    for j in range(n):
        A[rs.randint(m), j] = rs.normal()
    return A.tocsr()


# ---- rectangular products (K4's plain version, K5) -------------------------------------


@pytest.mark.parametrize("shape", [(7, 12), (12, 7)])
def test_rectangular_matvec_and_rmatvec_match_reference(shape):
    m, n = shape
    A = _rect(m, n, 1)
    At, Aj = from_scipy(A), j_from_scipy(A)
    rng = np.random.default_rng(2)
    x, y = rng.normal(size=n), rng.normal(size=(3, m))
    assert _rel(At.matvec(_t(x)), Aj.matvec(jnp.asarray(x))) <= 1e-13
    assert _rel(At.rmatvec(_t(y)), jax.vmap(Aj.rmatvec)(jnp.asarray(y))) <= 1e-13
    assert _rel((At @ _t(x)), Aj @ jnp.asarray(x)) <= 1e-13
    # one matrix per chain: data (B, nnz), x (B, n)
    scale = np.linspace(1.0, 2.0, 3)[:, None]
    Ab = SparseMatrix(_t(scale * At.data.numpy()), At.pattern)
    xb = rng.normal(size=(3, n))
    want = np.stack([np.asarray(JSM(jnp.asarray(s * np.asarray(Aj.data)), Aj.pattern).matvec(jnp.asarray(v)))
                     for s, v in zip(scale[:, 0], xb)])
    assert _rel(Ab.matvec(_t(xb)), want) <= 1e-13
    with pytest.raises(ValueError):
        At.quad(_t(np.ones(n)))
    with pytest.raises(ValueError):
        At.matvec(_t(np.ones(n + 1)))


def test_rectangular_matvec_gradients():
    A = _rect(5, 9, 3)
    At = from_scipy(A)
    x = _t(np.random.default_rng(4).normal(size=9)).requires_grad_()
    d = At.data.clone().requires_grad_()
    torch.sin(SparseMatrix(d, At.pattern).matvec(x)).sum().backward()
    g = np.cos(A @ x.detach().numpy())
    assert _rel(x.grad, A.T @ g) <= 1e-13
    Acoo = A.tocoo()
    order = np.lexsort((Acoo.col, Acoo.row))
    assert _rel(d.grad, g[Acoo.row[order]] * x.detach().numpy()[Acoo.col[order]]) <= 1e-13


def test_csr_spmv_plain_rectangular_and_path_choice():
    A = _rect(6, 40, 5)
    P = from_scipy(A).pattern
    rp, col = torch.tensor(P.indptr), torch.tensor(P.cols)
    data = _t(np.random.default_rng(6).normal(size=(2, P.nnz)))
    x = _t(np.random.default_rng(7).normal(size=(2, 40)))
    y, q = kernels.csr_spmv(rp, col, data, x)
    assert q is None and y.shape == (2, 6)
    for b in range(2):
        Ab = sp.csr_matrix((data[b].numpy(), P.cols, P.indptr), shape=(6, 40))
        assert _rel(y[b], Ab @ x[b].numpy()) <= 1e-13
    with pytest.raises(ValueError):
        kernels.csr_spmv(rp, col, data, x, quad=True)
    # x of n_c entries decides shared memory, the n_r rows the tiling
    assert kernels.spmv_path(500, 1, F64, 14058) == "tiled"  # x beyond 48 KB
    assert kernels.spmv_path(500, 8, F64, 4000) == "shared"  # few rows: no tiles to fill the card with
    assert kernels.spmv_path(14058, 1, F64, 500) == "tiled"
    assert kernels.spmv_path(14058, 256, F64, 500) == "shared"
    assert kernels.spmv_path(500, 256, F64) == kernels.spmv_path(500, 256, F64, 500) == "shared"


@pytest.mark.parametrize("order", ["nm_mn", "mn_nm"])
def test_rectangular_spgemm_matches_reference(order):
    A = _rect(6, 15, 8)
    B = _rect(15, 6, 9)
    if order == "mn_nm":
        A, B = B, A
    got = sp_matmul(from_scipy(A), from_scipy(B))
    ref = j_from_scipy(A) @ j_from_scipy(B)
    assert got.shape == ref.shape == (A.shape[0], B.shape[1])
    assert np.array_equal(got.pattern.rows, ref.pattern.rows) and np.array_equal(got.pattern.cols, ref.pattern.cols)
    assert _rel(got.data, ref.data) <= 1e-13
    # Aᵀ(Q A), the observation term of linear_condition
    Qe = from_scipy(sp.diags(np.linspace(1, 2, 6)).tocsr())
    At = from_scipy(_rect(6, 15, 10))
    Aj = j_from_scipy(_rect(6, 15, 10))
    got = At.T @ (Qe @ At)
    ref = Aj.T @ (j_from_scipy(sp.diags(np.linspace(1, 2, 6)).tocsr()) @ Aj)
    assert _rel(got.todense(), ref.todense()) <= 1e-13


def test_sparse_constructors_match_reference():
    M = np.random.default_rng(11).normal(size=(5, 8))
    M[np.abs(M) < 0.7] = 0.0
    got, ref = from_dense(_t(M)), j_from_dense(jnp.asarray(M))
    assert np.array_equal(got.pattern.rows, ref.pattern.rows) and np.array_equal(got.pattern.cols, ref.pattern.cols)
    assert _rel(got.data, ref.data) == 0.0
    got, ref = from_dense(M, tol=1.0), j_from_dense(jnp.asarray(M), tol=1.0)
    assert got.nnz == ref.nnz and _rel(got.data, ref.data) == 0.0
    S = sp.csr_matrix(M)
    S2 = sp.coo_matrix((np.r_[S.tocoo().data, 1.0], (np.r_[S.tocoo().row, 0], np.r_[S.tocoo().col, 0])), shape=(5, 8))
    got, ref = from_scipy(S2), j_from_scipy(S2)  # a duplicate entry, summed
    assert np.array_equal(got.pattern.rows, ref.pattern.rows) and _rel(got.data, ref.data) == 0.0
    assert abs(got.to_scipy() - ref.to_scipy()).max() == 0.0
    e, ej = speye(4, dtype=F64), j_speye(4, dtype=jnp.float64)
    assert torch.equal(e.todense(), torch.eye(4, dtype=F64)) and np.array_equal(e.pattern.rows, ej.pattern.rows)


# ---- linear_condition ----------------------------------------------------------------------


N, M = 20, 6


def _base(seed=3):
    rng = np.random.default_rng(seed)
    S = random_sparse_spd(rng, N)
    mu = rng.normal(size=N)
    return S, mu, tg.GMRF.from_precision(_t(mu), from_scipy(S)), jg.GMRF.from_precision(jnp.asarray(mu),
                                                                                         j_from_scipy(S))


def _spd(k, seed, sparse):
    rng = np.random.default_rng(seed)
    if sparse:
        return sp.diags([np.full(k - 1, -0.3), 1.5 + rng.random(k), np.full(k - 1, -0.3)], [-1, 0, 1]).tocsr()
    G = rng.normal(size=(k, k))
    return G @ G.T / k + np.eye(k)


def _case(name):
    """(y, kwargs for the port, kwargs for the reference) of one branch."""
    rng = np.random.default_rng(21)
    A_sp = _rect(M, N, 22)
    A_dn = rng.normal(size=(M, N))
    vec = 2.0 + rng.random(M)
    if name.startswith("identity"):
        y = rng.normal(size=N)
        q = {"identity_scalar": 4.0, "identity_vector": 2.0 + rng.random(N),
             "identity_sparse_qeps": _spd(N, 23, True), "identity_dense_qeps": _spd(N, 24, False)}[name]
        if sp.issparse(q):
            return y, dict(Q_eps=from_scipy(q)), dict(Q_eps=j_from_scipy(q))
        return y, dict(Q_eps=q), dict(Q_eps=q)
    y = rng.normal(size=M)
    if name == "indices":
        idx = np.array([1, 4, 5, 11, 17, 19])
        return y, dict(Q_eps=vec, indices=idx), dict(Q_eps=vec, indices=idx)
    if name == "sparse_A":
        return y, dict(Q_eps=4.0, A=from_scipy(A_sp)), dict(Q_eps=4.0, A=j_from_scipy(A_sp))
    if name == "sparse_A_sparse_qeps":
        q = _spd(M, 25, True)
        return y, dict(Q_eps=from_scipy(q), A=from_scipy(A_sp)), dict(Q_eps=j_from_scipy(q), A=j_from_scipy(A_sp))
    if name == "sparse_A_offset":
        b = rng.normal(size=M)
        return y, dict(Q_eps=vec, A=from_scipy(A_sp), b=b), dict(Q_eps=vec, A=j_from_scipy(A_sp), b=jnp.asarray(b))
    if name == "dense_A":
        return y, dict(Q_eps=vec, A=A_dn), dict(Q_eps=vec, A=A_dn)
    if name == "dense_A_dense_qeps":
        q = _spd(M, 26, False)
        return y, dict(Q_eps=q, A=_t(A_dn)), dict(Q_eps=q, A=A_dn)
    raise KeyError(name)


CASES = ["identity_scalar", "identity_vector", "identity_sparse_qeps", "identity_dense_qeps", "indices",
         "sparse_A", "sparse_A_sparse_qeps", "sparse_A_offset", "dense_A", "dense_A_dense_qeps"]


def _same_posterior(post, ref, x):
    assert _rel(post.mean, ref.mean) <= 1e-9
    assert _rel(post.var(), ref.var()) <= 1e-9
    assert abs(float(post.logpdf(_t(x))) / float(ref.logpdf(jnp.asarray(x))) - 1) <= 1e-9


@pytest.mark.parametrize("name", CASES)
def test_linear_condition_matches_reference(name):
    _, _, g, gj = _base()
    y, kw, kwj = _case(name)
    post = tg.linear_condition(g, y, **kw)
    ref = jg.linear_condition(gj, jnp.asarray(y), **kwj)
    assert np.array_equal(post.Q.pattern.rows, ref.Q.pattern.rows)
    assert np.array_equal(post.Q.pattern.cols, ref.Q.pattern.cols)
    assert _rel(post.Q.data, ref.Q.data) <= 1e-13
    _same_posterior(post, ref, np.random.default_rng(27).normal(size=N))


def test_linear_condition_indices_keep_their_noise_precisions():
    """Unsorted indices with one noise precision each: Q_post = Q + Σ_k q_k e_{i_k} e_{i_k}ᵀ
    and info = Qμ + Σ_k q_k y_k e_{i_k}, against a dense oracle. (The reference
    pairs q with the sorted pattern's entries, so it differs here.)"""
    S, mu, g, _ = _base()
    idx = np.array([17, 2, 9, 4])
    q = np.array([1.0, 2.0, 3.0, 4.0])
    y = np.array([0.5, -1.0, 2.0, 0.25])
    post = tg.linear_condition(g, y, q, indices=idx)
    Qd = S.toarray()
    Qd[idx, idx] += q
    info = S @ mu
    np.add.at(info, idx, q * y)
    assert _rel(post.Q.todense(), Qd) <= 1e-15
    assert _rel(post.mean, np.linalg.solve(Qd, info)) <= 1e-10
    with pytest.raises(ValueError):
        tg.linear_condition(g, np.ones(3), 1.0)  # y of length m ≠ n without A or indices


# ---- ConstrainedGMRF ----------------------------------------------------------------------


def _constrained(m=2, seed=5):
    S, mu, g, gj = _base(seed)
    rng = np.random.default_rng(seed + 1)
    A = rng.normal(size=(m, N))
    e = rng.normal(size=m)
    return A, e, tg.ConstrainedGMRF.create(g, A, e), jg.ConstrainedGMRF.create(gj, jnp.asarray(A), jnp.asarray(e))


def test_constrained_create_matches_reference():
    _, _, c, cj = _constrained()
    assert _rel(c.mean, cj.mean) <= 1e-9
    assert _rel(c.A_tilde_T, cj.A_tilde_T) <= 1e-9
    assert _rel(c.L_c, cj.L_c) <= 1e-9
    assert abs(float(c.log_correction) / float(cj.log_correction) - 1) <= 1e-9
    assert c.n_constraints == 2 and len(c) == N and c.Q is c.base.Q and c.precision_matrix() is c.base.Q
    with pytest.raises(ValueError):
        tg.ConstrainedGMRF.create(c.base, np.ones((2, N + 1)), np.zeros(2))


def test_constrained_statistics_match_reference():
    A, e, c, cj = _constrained()
    x = np.random.default_rng(8).normal(size=N)
    assert abs(float(c.logpdf(_t(x))) / float(cj.logpdf(jnp.asarray(x))) - 1) <= 1e-9
    assert _rel(c.gradlogpdf(_t(x)), cj.gradlogpdf(jnp.asarray(x))) <= 1e-9
    assert _rel(c.var(), cj.var()) <= 1e-9
    assert _rel(c.std(), cj.std()) <= 1e-9
    assert abs(float(c.logdet_precision()) / float(cj.logdet_precision()) - 1) <= 1e-9
    assert abs(float(c.sqmahal(_t(x))) / float(cj.sqmahal(jnp.asarray(x))) - 1) <= 1e-9
    xs = np.random.default_rng(9).normal(size=(4, N))
    assert _rel(c.project(_t(x)), cj.project(jnp.asarray(x))) <= 1e-9
    assert _rel(c.project(_t(xs)), cj.project(jnp.asarray(xs))) <= 1e-9


def test_constrained_samples_satisfy_the_constraint():
    A, e, c, _ = _constrained(m=1)
    xs = c.sample(torch.Generator().manual_seed(1), (500,))
    assert xs.shape == (500, N)
    assert np.abs(xs.numpy() @ A.T - e).max() <= 1e-10
    assert np.abs(xs.numpy().mean(0) - c.mean.numpy()).max() <= 0.5


def test_linear_condition_of_a_constrained_gmrf_matches_reference():
    _, _, g, gj = _base()
    A = np.ones((1, N))  # sum to zero
    c = tg.ConstrainedGMRF.create(g, A, np.zeros(1))
    cj = jg.ConstrainedGMRF.create(gj, jnp.asarray(A), jnp.zeros(1))
    y, kw, kwj = _case("sparse_A")
    post = tg.linear_condition(c, y, **kw)
    ref = jg.linear_condition(cj, jnp.asarray(y), **kwj)
    assert isinstance(post, tg.ConstrainedGMRF)
    _same_posterior(post, ref, np.random.default_rng(28).normal(size=N))
    assert abs(float(post.mean.sum())) <= 1e-10
