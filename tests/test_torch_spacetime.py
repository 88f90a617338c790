"""The port's space-time FEM models against the JAX package, float64, on the
same seeded NumPy inputs: `sp_block_tridiag`, the advection-diffusion joint
precision on interval and triangle meshes, the SSM means, the Kronecker and
product-Matérn models and the per-time-slice statistics.

Tolerances and why:
- block assembly and lifted observation matrices: the same data moved: equal;
- joint precisions: the same sparse products in another summation order,
  rel 1e-12;
- SSM means: one LU per package, rel 1e-10; GMRES (the dense branch's size
  limit lowered) stops at its own 1e-10 residual in each package, rel 1e-8;
- time means and variances: a direct factor's, rel 1e-10, on a joint of
  moderate condition (the docstring says why);
- draws: the port's generator differs from JAX's keys, so the draws are held
  by their moments against the variances, within 5 standard errors.

The reference's `discretize` assembles on the host and runs eagerly; every
reference is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf.fem as jfem
from tpu_gmrf.fem import spatiotemporal as jst
from tpu_gmrf.solvers.base import SolverSpec as JSolverSpec
from tpu_gmrf.sparse.matrix import SparseMatrix as JSparse
from tpu_gmrf.sparse.pattern import SparsePattern as JPattern
import tpu_gmrf_torch as tg
import tpu_gmrf_torch.fem as tfem
from tpu_gmrf_torch.fem import spatiotemporal as tst
from tpu_gmrf_torch.sparse import SparseMatrix, SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _same_pattern(T, J):
    np.testing.assert_array_equal(T.pattern.rows, J.pattern.rows)
    np.testing.assert_array_equal(T.pattern.cols, J.pattern.cols)
    assert T.shape == J.shape


def _pair(mat):
    """The same scipy matrix as a port and a reference SparseMatrix."""
    coo = sp.coo_matrix(mat)
    coo.sum_duplicates()
    tp = SparsePattern(coo.row, coo.col, coo.shape)
    jp = JPattern(coo.row, coo.col, coo.shape)
    data = coo.data[tp.sort_order]
    return SparseMatrix(torch.tensor(data, dtype=F64), tp), JSparse(jnp.asarray(data), jp)


def _random_block(rng, n, density):
    return sp.random(n, n, density=density, random_state=np.random.RandomState(rng.integers(1 << 31))) + sp.eye(n)


# ---- sp_block_tridiag ---------------------------------------------------------


@pytest.mark.parametrize("shared", [True, False])
def test_sp_block_tridiag_matches_reference(shared):
    rng = np.random.default_rng(3)
    Ns, Nt = 7, 5
    first = _random_block(rng, Ns, 0.3)
    diag = [first if shared else _random_block(rng, Ns, 0.3) for _ in range(Nt)]
    off = [_random_block(rng, Ns, 0.25) for _ in range(Nt - 1)]
    if shared:
        off = [off[0]] * (Nt - 1)
    tdiag, jdiag = zip(*(_pair(b) for b in diag))
    toff, joff = zip(*(_pair(b) for b in off))
    T, J = tst.sp_block_tridiag(list(tdiag), list(toff)), jst.sp_block_tridiag(list(jdiag), list(joff))
    _same_pattern(T, J)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    dense = sp.bmat([[diag[i] if i == j else off[j] if i == j + 1 else off[i].T if j == i + 1 else None
                      for j in range(Nt)] for i in range(Nt)]).toarray()
    np.testing.assert_array_equal(T.todense().numpy(), dense)


def test_sp_block_tridiag_chains():
    """Data (B, nnz) on either side broadcasts: each chain is its own block tridiagonal."""
    rng = np.random.default_rng(4)
    Ns, Nt = 6, 4
    d, o = _pair(_random_block(rng, Ns, 0.4))[0], _pair(_random_block(rng, Ns, 0.3))[0]
    scale = torch.tensor([1.0, 2.0, -0.5], dtype=F64)
    db = SparseMatrix(d.data * scale[:, None], d.pattern)
    T = tst.sp_block_tridiag([db] * Nt, [o] * (Nt - 1))
    for b in range(3):
        one = tst.sp_block_tridiag([SparseMatrix(db.data[b], d.pattern)] * Nt, [o] * (Nt - 1))
        np.testing.assert_array_equal(T.data[b].numpy(), one.data.numpy())


# ---- the advection-diffusion joint on an interval ------------------------------

_NX, _NT = 25, 6
_TS = np.linspace(0.0, 1.0, _NT)


def _ad_kwargs(bc):
    return dict(gamma=[0.6], H=0.1, kappa=1.0, alpha=1, c=1.0, tau=3.0, spatial_kappa=float(np.sqrt(8.0) / 0.4),
                bc=bc)


@pytest.fixture(scope="module")
def interval_joints():
    """Both packages' joints for Neumann/Dirichlet, with and without streamline diffusion."""
    out = {}
    for bc in ("neumann", "dirichlet"):
        jd = jfem.FEMDiscretization(jfem.interval_mesh(0, 1, _NX))
        td = tfem.FEMDiscretization(tfem.interval_mesh(0, 1, _NX))
        for sd in (False, True):
            J = jfem.AdvectionDiffusionSPDE(jd, **_ad_kwargs(bc)).discretize(_TS, streamline_diffusion=sd)
            T = tfem.AdvectionDiffusionSPDE(td, **_ad_kwargs(bc)).discretize(_TS, streamline_diffusion=sd)
            out[bc, sd] = (T, J)
    return out


@pytest.mark.parametrize("sd", [False, True], ids=["plain", "streamline"])
@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_advdiff_joint_interval_matches_reference(interval_joints, bc, sd):
    T, J = interval_joints[bc, sd]
    assert (T.N_t, T.N_s) == (J.N_t, J.N_s) == (_NT, _NX)
    _same_pattern(T.Q, J.Q)
    assert _rel(T.Q.data.numpy(), J.Q.data) <= 1e-12
    np.testing.assert_array_equal(T.mean.numpy(), np.asarray(J.mean))


def test_time_means_and_vars_match_reference():
    """Per-slice means (nonzero Dirichlet values make nonzero SSM means), variances and the logpdf. The joints
    above are stiff (condition 3e9 at τ=3, the Neumann joint's smallest eigenvalues are its temporal increments'):
    there each package's dense variances sit ~5e-8 from NumPy's inverse, so the statistics are held on a joint of
    condition 1.7e7 (Dirichlet noise 1e-2, τ=1, 11 nodes, 4 times)."""
    kw = dict(gamma=[0.6], H=0.1, kappa=1.0, alpha=1, c=1.0, tau=1.0, spatial_kappa=2.0, bc="dirichlet",
              constraint_noise=1e-2)
    ts = np.linspace(0, 1, 4)
    jX = jfem.AdvectionDiffusionSPDE(jfem.FEMDiscretization(jfem.interval_mesh(0, 1, 11)), **kw).discretize(
        ts, boundary_values=[0.7, -0.4], mean_offset=0.25)
    tX = tfem.AdvectionDiffusionSPDE(tfem.FEMDiscretization(tfem.interval_mesh(0, 1, 11)), **kw).discretize(
        ts, boundary_values=[0.7, -0.4], mean_offset=0.25)
    assert tuple(tX.time_means().shape) == (4, 11)
    assert float(tX.time_means()[1:, 0].sub(0.95).abs().max()) < 1e-12  # the boundary value plus the offset
    assert _rel(tX.time_means().numpy(), jX.time_means()) <= 1e-10
    assert tX.discretization_at_time(3) is tX.disc
    assert _rel(tX.time_vars().numpy(), jX.time_vars()) <= 1e-10
    assert _rel(tX.time_stds().numpy(), jX.time_stds()) <= 1e-10
    x = np.random.default_rng(0).normal(size=44)
    assert _rel(float(tX.logpdf(torch.tensor(x))), float(jX.logpdf(jnp.asarray(x)))) <= 1e-10


def test_time_rands_moments():
    kw = _ad_kwargs("neumann")
    tX = tfem.AdvectionDiffusionSPDE(tfem.FEMDiscretization(tfem.interval_mesh(0, 1, 11)), **kw).discretize(
        np.linspace(0, 1, 4), mean_offset=0.5)
    k = 4000
    draws = tX.time_rands(torch.Generator().manual_seed(0), (k,))
    assert tuple(draws.shape) == (k, 4, 11)
    v = tX.time_vars()
    z = (draws.mean(0) - tX.time_means()) / (v / k).sqrt()
    assert float(z.abs().max()) < 5.0
    se = (v * np.sqrt(2.0 / (k - 1)))
    assert float(((draws.var(0) - v) / se).abs().max()) < 5.0


# ---- SSM means on both branches --------------------------------------------------


def _g_dt(nx: int, dt: float):
    """G_dt = M + dt·(κ²M + G + B) with the Dirichlet rows replaced by unit rows, as scipy."""
    td = tfem.FEMDiscretization(tfem.interval_mesh(0, 1, nx))
    M = td.mass_matrix().to_scipy()
    K = M + td.stiffness_matrix().to_scipy() + td.advection_matrix([0.8]).to_scipy()
    G = (M + dt * K).tolil()
    for b in (0, nx - 1):
        G[b, :] = 0.0
        G[b, b] = 1.0
    return G.tocsr(), M.diagonal()


@pytest.mark.parametrize("branch", ["lu", "gmres"])
def test_ssm_means_match_reference(branch):
    nx, Nt = 30, 7
    G, Md = _g_dt(nx, 0.1)
    tG, jG = _pair(G)
    mu0 = np.random.default_rng(1).normal(size=nx)
    bnodes, bvals = np.array([0, nx - 1]), np.array([0.9, -0.6])
    dense_max = 4096 if branch == "lu" else 8
    got = tst._ssm_means(tG, torch.tensor(Md), torch.tensor(mu0), Nt, bnodes, bvals, dense_max)
    ref = jst._ssm_means(jG, jnp.asarray(Md), jnp.asarray(mu0), Nt, bnodes, bvals, dense_max)
    assert _rel(got.numpy(), ref) <= (1e-10 if branch == "lu" else 1e-8)
    assert np.allclose(got.numpy().reshape(Nt, nx)[1:, [0, -1]], bvals)


# ---- a 2-D advection-diffusion joint -----------------------------------------------


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_advdiff_joint_2d_matches_reference(bc):
    pts = np.random.default_rng(5).uniform(size=(30, 2))
    jm, tm = jfem.generate_mesh(pts), tfem.generate_mesh(pts)
    kw = dict(gamma=[0.6, 0.3], kappa=1.0, alpha=2, c=1.0, tau=1.0, bc=bc)
    ts = np.linspace(0, 1, 4)
    J = jfem.AdvectionDiffusionSPDE(jfem.FEMDiscretization(jm), **kw).discretize(
        ts, streamline_diffusion=True, solver=JSolverSpec(kind="dense"))
    T = tfem.AdvectionDiffusionSPDE(tfem.FEMDiscretization(tm), **kw).discretize(
        ts, streamline_diffusion=True, solver=tg.SolverSpec(kind="dense"))
    _same_pattern(T.Q, J.Q)
    assert _rel(T.Q.data.numpy(), J.Q.data) <= 1e-12
    assert T.Q.pattern.is_symmetric


# ---- Kronecker and product-Matérn models -------------------------------------------


def test_kronecker_model_matches_reference():
    rng = np.random.default_rng(6)
    nt = 5
    Qt = sp.diags([np.full(nt, 2.5), np.full(nt - 1, -1.0), np.full(nt - 1, -1.0)], [0, 1, -1])
    tQt, jQt = _pair(Qt)
    pts = rng.uniform(size=(20, 2))
    jd, td = jfem.FEMDiscretization(jfem.generate_mesh(pts)), tfem.FEMDiscretization(tfem.generate_mesh(pts))
    jQs = jfem.MaternSPDE(jd, smoothness=1).precision(3.0)
    tQs = tfem.MaternSPDE(td, smoothness=1).precision(torch.tensor(3.0, dtype=F64))
    J = jfem.kronecker_product_spatiotemporal_model(jQt, jQs, jd)
    T = tfem.kronecker_product_spatiotemporal_model(tQt, tQs, td)
    assert (T.N_t, T.N_s) == (J.N_t, J.N_s)
    _same_pattern(T.Q, J.Q)
    assert _rel(T.Q.data.numpy(), J.Q.data) <= 1e-12
    assert _rel(T.time_vars().numpy(), J.time_vars()) <= 1e-10


@pytest.fixture(scope="module")
def product_mesh():
    pts = np.random.default_rng(7).uniform(size=(25, 2))
    return jfem.generate_mesh(pts), tfem.generate_mesh(pts)


def test_product_matern_matches_reference(product_mesh):
    jm, tm = product_mesh
    J = jfem.product_matern(1, 0.5, 12, jfem.MaternSPDE(jfem.FEMDiscretization(jm), smoothness=1), 4.0)
    T = tfem.product_matern(1, torch.tensor(0.5, dtype=F64), 12,
                            tfem.MaternSPDE(tfem.FEMDiscretization(tm), smoothness=1), torch.tensor(4.0, dtype=F64))
    assert (T.N_t, T.N_s) == (J.N_t, J.N_s) == (12, tm.n_vertices)
    _same_pattern(T.Q, J.Q)
    assert _rel(T.Q.data.numpy(), J.Q.data) <= 1e-12


def test_product_matern_chains(product_mesh):
    """κ_t and κ_s as (B,) tensors: chain b is the reference at (κ_t[b], κ_s[b])."""
    jm, tm = product_mesh
    kt, ks = np.array([0.5, 0.9]), np.array([4.0, 2.5])
    T = tfem.product_matern(1, torch.tensor(kt), 10, tfem.MaternSPDE(tfem.FEMDiscretization(tm), smoothness=1),
                            torch.tensor(ks))
    spde = jfem.MaternSPDE(jfem.FEMDiscretization(jm), smoothness=1)
    for b in range(2):
        J = jfem.product_matern(1, kt[b], 10, spde, ks[b])
        _same_pattern(T.Q, J.Q)
        assert _rel(T.Q.data[b].numpy(), J.Q.data) <= 1e-12


def test_spatial_to_spatiotemporal_matches_reference():
    jd = jfem.FEMDiscretization(jfem.interval_mesh(-1, 1, 15))
    td = tfem.FEMDiscretization(tfem.interval_mesh(-1, 1, 15))
    pts = np.linspace(-0.9, 0.95, 6)[:, None]
    J = jfem.spatial_to_spatiotemporal(jd.evaluation_matrix(pts), 3, 5)
    T = tfem.spatial_to_spatiotemporal(td.evaluation_matrix(pts), 3, 5)
    _same_pattern(T, J)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))


@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_banded_solve_of_the_interval_joint_matches_reference(interval_joints, bc):
    """The banded backend's solve with the stiff joint (an implicit-Euler SSM): the port's relative residual
    ‖Qx − b‖∞ / (‖Q‖∞‖x‖∞ + ‖b‖∞) at most 1e-13 (~450 ε, a backward-stable solve; chip_smoke.py phase 26 holds
    the card's kernels to the same), and its solution within 10 κ ε of the reference's banded solve, κ the
    joint's 2-norm condition."""
    from tpu_gmrf.solvers.base import factorize as jfactorize

    T, J = interval_joints[bc, False]
    b = np.random.default_rng(21).normal(size=T.n)
    x = tg.factorize(T.Q, tg.SolverSpec(kind="banded")).solve(torch.tensor(b, dtype=F64)).numpy()
    xr = np.asarray(jfactorize(J.Q, JSolverSpec(kind="banded")).solve(jnp.asarray(b)))
    Qd = T.Q.todense().numpy()
    resid = np.abs(Qd @ x - b).max() / (np.abs(Qd).sum(1).max() * np.abs(x).max() + np.abs(b).max())
    assert resid <= 1e-13
    assert _rel(x, xr) <= 10 * np.linalg.cond(Qd) * np.finfo(np.float64).eps
