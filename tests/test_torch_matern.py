"""The port's FEM mesh, P1 assembly, Matérn SPDE model and the batched
spatial-Poisson Laplace slice on the supernodal backend, against the JAX
package, float64, on the same NumPy inputs.

Tolerances and why:
- mesh and FEM matrices: the same host NumPy code: equal;
- Matérn precisions: the same products in another summation order, rtol 1e-12;
- GMRF statistics: the supernodal factor's rel 1e-10 (test_torch_supernodal);
- Laplace marginal value rel 1e-8 and θ-gradient rel 1e-6: both sides stop
  Newton at the same tolerances, and rounding can move a chain's stop by
  one iteration.

The slice's reference runs the JAX package's dense backend: at n=931 it
gives the reference's supernodal results to about 1e-13 and compiles in
seconds, where the jitted supernodal Laplace program takes over a minute.
The port's side runs the supernodal backend, whose factor, solves, Σ and
logdet gradient are held against the reference's supernodal backend in
test_torch_supernodal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
from tpu_gmrf.fem import discretization as jdisc
from tpu_gmrf.fem import mesh as jmesh
from tpu_gmrf.fem import spde as jspde
from tpu_gmrf.solvers.base import SolverSpec as JaxSolverSpec
from tpu_gmrf_torch import set_default_device
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop
from tpu_gmrf_torch.fem import discretization as tdisc
from tpu_gmrf_torch.fem import mesh as tmesh
from tpu_gmrf_torch.fem import spde as tspde

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---- mesh and FEM assembly ----------------------------------------------------


@pytest.mark.parametrize("cloud", ["grid", "scattered"])
def test_mesh_and_fem_matrices_match_reference(cloud):
    pts = _grid(12) if cloud == "grid" else np.random.default_rng(0).uniform(size=(80, 2))
    jm, tm = jmesh.generate_mesh(pts), tmesh.generate_mesh(pts)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.triangles, jm.triangles)
    assert tmesh.auto_mesh_size(pts) == jmesh.auto_mesh_size(pts)
    jd, td = jdisc.FEMDiscretization(jm), tdisc.FEMDiscretization(tm)
    assert td.ndofs == jd.ndofs and td.intrinsic_dim == jd.intrinsic_dim == 2
    for name in ("mass_matrix", "stiffness_matrix"):
        J, T = getattr(jd, name)(), getattr(td, name)()
        np.testing.assert_array_equal(T.pattern.rows, J.pattern.rows)
        np.testing.assert_array_equal(T.pattern.cols, J.pattern.cols)
        np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    np.testing.assert_array_equal(td.boundary_nodes(), jd.boundary_nodes())
    E, JE = td.evaluation_matrix(pts[:9] * 0.9 + 0.05), jd.evaluation_matrix(pts[:9] * 0.9 + 0.05)
    np.testing.assert_array_equal(E.pattern.cols, JE.pattern.cols)
    np.testing.assert_allclose(E.data.numpy(), np.asarray(JE.data), rtol=1e-12)


# ---- Matérn precision -----------------------------------------------------------


@pytest.fixture(scope="module")
def mesh10():
    jm = jg.MaternModel(_grid(10), smoothness=1)
    return jm.disc.mesh.vertices, jm.disc.mesh.triangles


_TAUS = np.array([1.0, 0.5, 3.0])
_RANGES = np.array([0.25, 0.4, 0.15])


@pytest.mark.parametrize("alpha", [1, 2, 3])
@pytest.mark.parametrize("bc", ["neumann", "dirichlet"])
def test_matern_precision_matches_reference(mesh10, alpha, bc):
    nodes, tris = mesh10
    smoothness = max(alpha - 2, 0)  # α = smoothness + 2 in 2D; α = 1 is set on the SPDE directly
    tmod = interop.matern_model_from_numpy(nodes, tris, smoothness=smoothness, bc=bc)
    jmod = jg.MaternModel(jdisc.FEMDiscretization(jmesh.TriangleMesh(nodes, tris)), smoothness=smoothness, bc=bc)
    if alpha == 1:
        tmod.spde.alpha = jmod.spde.alpha = 1
    assert tmod.spde.alpha == jmod.spde.alpha == alpha
    Q = tmod.precision(tau=_t(_TAUS), range=_t(_RANGES))
    for b in range(3):
        J = jmod.precision(tau=_TAUS[b], range=_RANGES[b])
        if b == 0:
            np.testing.assert_array_equal(Q.pattern.rows, J.pattern.rows)
            np.testing.assert_array_equal(Q.pattern.cols, J.pattern.cols)
        np.testing.assert_allclose(Q.data[b].numpy(), np.asarray(J.data), rtol=1e-12, atol=1e-12 * float(
            np.abs(np.asarray(J.data)).max()))
    # the κ-independent structural pattern: the posterior Q − H keeps it
    H = tg.SparseMatrix(_t(np.ones((3, Q.shape[0]))), tg.SparsePattern(np.arange(Q.shape[0]), np.arange(Q.shape[0]),
                                                                       Q.shape))
    assert (Q - H).pattern == Q.pattern


def test_constrained_matern_raises(mesh10):
    nodes, tris = mesh10
    disc = tdisc.FEMDiscretization(tmesh.TriangleMesh(nodes, tris))
    # the constrained GMRF no longer raises: it is a ConstrainedGMRF whose mean sums to zero
    g = tspde.MaternModel(disc, constraint="sumtozero")(tau=_t(1.0), range=_t(0.3))
    assert isinstance(g, tg.ConstrainedGMRF) and abs(float(g.mean.sum())) <= 1e-12


# ---- the slice: spatial-Poisson Laplace marginal on the supernodal backend ------


@pytest.fixture(scope="module")
def spatial24():
    """g=24 (n=931) spatial Poisson model as the reference bench builds it
    (bench.py:256-265), with the reference's batched value and θ-gradient
    and its GMRF statistics (on the reference's dense backend)."""
    g = 24
    pts = _grid(g)
    spec = JaxSolverSpec(kind="dense")
    jmod = jg.MaternModel(pts, smoothness=1, solver=spec)
    n = jmod.n
    rng = np.random.default_rng(1)
    gx, gy = pts[:, 0], pts[:, 1]
    field = np.zeros(n)
    field[: g * g] = np.sin(3.0 * gx) * np.cos(2.0 * gy)
    y = rng.poisson(np.exp(np.clip(field, -3, 3))).astype(np.float64)
    obs = jg.ExponentialFamily("poisson")
    opts = jg.GAOptions(max_iter=10, inner_solver=spec)

    def f(th):
        return jg.laplace_marginal(jmod, obs, y, {"tau": th[0], "range": th[1]}, options=opts)

    theta = np.stack([_TAUS, _RANGES], -1)
    value, grad = jax.jit(jax.vmap(jax.value_and_grad(f)))(jnp.asarray(theta))
    x = rng.normal(size=(3, n))

    def stats(th, xx):
        gm = jmod(tau=th[0], range=th[1])
        return gm.logpdf(xx), gm.var()

    logpdf, var = jax.jit(jax.vmap(stats))(jnp.asarray(theta), x)
    tmod = interop.matern_model_from_numpy(jmod.disc.mesh.vertices, jmod.disc.mesh.triangles, smoothness=1,
                                           solver=tg.SolverSpec(kind="supernodal"))
    return dict(tmod=tmod, y=y, x=x, value=np.asarray(value), grad=np.asarray(grad),
                logpdf=np.asarray(logpdf), var=np.asarray(var))


def test_matern_gmrf_statistics_match_reference(spatial24):
    gm = spatial24["tmod"](tau=_t(_TAUS), range=_t(_RANGES))
    assert gm.factor.batch_shape == (3,)
    assert _rel(gm.logpdf(_t(spatial24["x"])).numpy(), spatial24["logpdf"]) <= 1e-10
    assert _rel(gm.var().numpy(), spatial24["var"]) <= 1e-10
    s = gm.sample(torch.Generator().manual_seed(0), (2,))
    assert s.shape == (2, 3, gm.n) and torch.isfinite(s).all()


def test_spatial_poisson_laplace_marginal_matches_reference(spatial24):
    tau, rng_ = _t(_TAUS, requires_grad=True), _t(_RANGES, requires_grad=True)
    opts = tg.GAOptions(max_iter=10, inner_solver=tg.SolverSpec(kind="supernodal"))
    v = tg.laplace_marginal(spatial24["tmod"], tg.ExponentialFamily("poisson"), spatial24["y"],
                            {"tau": tau, "range": rng_}, options=opts)
    v.sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), spatial24["value"], rtol=1e-8)
    np.testing.assert_allclose(torch.stack([tau.grad, rng_.grad], -1).numpy(), spatial24["grad"], rtol=1e-6)
