"""The port's FEM breadth against the JAX package, float64, on the same seeded
NumPy inputs: interval, surface and structured meshes, their P1 matrices and
observation operators, the closest-point projection onto a surface, the
barrier model, the point observation models through the Laplace
approximation, `solve_refined`, and the supernodal plan's disk cache.

Tolerances and why:
- meshes: the same host NumPy code, index for index: equal;
- FEM matrices and observation operators: the same host code, rel 1e-13;
- barrier precision: the same sparse products in another order, rel 1e-12;
  its logpdf and θ-gradient per chain (B=3) rel 1e-10;
- point observation models through `gaussian_approximation`: both stop
  Newton at the same tolerance, mean and variance rel 1e-8;
- `solve_refined`: rel 1e-10;
- the plan cache: the loaded plan equals the built one table by table.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_gmrf as jg
import tpu_gmrf.fem as jfem
from tpu_gmrf.fem import discretization as jdisc
from tpu_gmrf.solvers import supernodal as jsn
from tpu_gmrf.sparse.matrix import SparseMatrix as JSparse
import tpu_gmrf_torch as tg
import tpu_gmrf_torch.fem as tfem
from tpu_gmrf_torch.fem import discretization as tdisc
from tpu_gmrf_torch.solvers import supernodal as tsn
from tpu_gmrf_torch.sparse import SparseMatrix

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _same(T, J, tol=1e-13):
    np.testing.assert_array_equal(T.pattern.rows, J.pattern.rows)
    np.testing.assert_array_equal(T.pattern.cols, J.pattern.cols)
    assert T.shape == J.shape
    assert _rel(T.data.cpu().numpy(), J.data) <= tol


# ---- meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("sub", [0, 1, 2])
def test_icosphere_matches_reference_exactly(sub):
    J, T = jfem.icosphere(sub, radius=1.5), tfem.icosphere(sub, radius=1.5)
    np.testing.assert_array_equal(T.vertices, J.vertices)
    np.testing.assert_array_equal(T.triangles, J.triangles)
    assert T.n_vertices == 10 * 4**sub + 2 and T.embedding_dim == 3 and T.intrinsic_dim == 2


@pytest.mark.parametrize("buffer", [0.0, 0.25])
def test_inflated_rectangle_matches_reference_exactly(buffer):
    J = jfem.create_inflated_rectangle(0.0, -1.0, 2.0, 0.5, 0.3, buffer)
    T = tfem.create_inflated_rectangle(0.0, -1.0, 2.0, 0.5, 0.3, buffer)
    np.testing.assert_array_equal(T.vertices, J.vertices)
    np.testing.assert_array_equal(T.triangles, J.triangles)


def test_interval_mesh_matches_reference():
    nodes = np.random.default_rng(0).uniform(-1, 2, 17)
    J, T = jfem.IntervalMesh(nodes), tfem.IntervalMesh(nodes)
    np.testing.assert_array_equal(T.nodes, J.nodes)
    assert (T.n_vertices, T.n_elements, T.intrinsic_dim, T.embedding_dim) == (17, 16, 1, 1)
    np.testing.assert_array_equal(tfem.interval_mesh(-1, 1, 9).nodes, jfem.interval_mesh(-1, 1, 9).nodes)


# ---- P1 matrices on interval, surface and planar meshes ---------------------------

_RNG = np.random.default_rng(11)
_INTERVAL_NODES = np.concatenate([[0.0, 1.0], _RNG.uniform(0, 1, 13)])
_SPHERE_PTS = _RNG.normal(size=(40, 3)) * _RNG.uniform(0.8, 1.2, size=(40, 1))
_PLANE_PTS = _RNG.uniform(0.05, 0.95, size=(25, 2))


def _meshes(kind):
    if kind == "interval":
        return jfem.IntervalMesh(_INTERVAL_NODES), tfem.IntervalMesh(_INTERVAL_NODES), _RNG.uniform(0, 1, (9, 1)), [0.7]
    if kind == "surface":
        return jfem.icosphere(1), tfem.icosphere(1), _SPHERE_PTS, [0.3, -0.5, 0.2]
    return (jfem.create_inflated_rectangle(0, 0, 1, 1, 0.15, 0.1), tfem.create_inflated_rectangle(0, 0, 1, 1, 0.15, 0.1),
            _PLANE_PTS, [0.6, -0.3])


_OPS = {
    "mass_lumped": lambda d, pts, g: d.mass_matrix(lumped=True),
    "mass_consistent": lambda d, pts, g: d.mass_matrix(lumped=False),
    "stiffness": lambda d, pts, g: d.stiffness_matrix(),
    "advection": lambda d, pts, g: d.advection_matrix(g),
    "streamline": lambda d, pts, g: d.streamline_diffusion_matrix(g, h=0.2),
    "evaluation": lambda d, pts, g: d.evaluation_matrix(pts),
    "derivative": lambda d, pts, g: d.derivative_matrix(pts, dim=len(g) - 1),
    "second_derivative": lambda d, pts, g: d.second_derivative_matrix(pts, dims=(0, len(g) - 1)),
    "node_selection": lambda d, pts, g: d.node_selection_matrix([3, 0, 5]),
}
# the reference's derivative operators locate points by planar barycentric coordinates: no surface case
_CASES = [(k, op) for k in ("interval", "surface", "plane") for op in _OPS
          if not (k == "surface" and op in ("derivative", "second_derivative"))]


@pytest.mark.parametrize("kind,op", _CASES)
def test_fem_matrices_match_reference(kind, op):
    jm, tm, pts, g = _meshes(kind)
    jd, td = jdisc.FEMDiscretization(jm), tdisc.FEMDiscretization(tm)
    assert (td.ndofs, td.intrinsic_dim) == (jd.ndofs, jd.intrinsic_dim)
    _same(_OPS[op](td, pts, g), _OPS[op](jd, pts, g))


@pytest.mark.parametrize("kind", ["interval", "plane"])
def test_boundary_nodes_and_diffusion_match_reference(kind):
    jm, tm, _, g = _meshes(kind)
    jd, td = jdisc.FEMDiscretization(jm), tdisc.FEMDiscretization(tm)
    np.testing.assert_array_equal(td.boundary_nodes(), jd.boundary_nodes())
    if kind == "plane":
        H = np.array([[0.4, 0.1], [0.1, 0.2]])
        _same(td.stiffness_matrix(diffusion=H), jd.stiffness_matrix(diffusion=H))


def test_surface_frame_gradients_match_reference():
    """The local frame's lifted gradients and the areas on icosphere(2), element by element."""
    jd, td = jdisc.FEMDiscretization(jfem.icosphere(2)), tdisc.FEMDiscretization(tfem.icosphere(2))
    np.testing.assert_array_equal(td.areas, jd.areas)
    np.testing.assert_array_equal(td.grads, jd.grads)
    # a P1 gradient of a linear function restricted to the plane: Σ_k ∇φ_k = 0 in every element
    assert np.abs(td.grads.sum(1)).max() < 1e-12


def test_closest_point_bary_matches_reference_node_by_node():
    coords = tfem.icosphere(2).element_coords()
    pts = np.random.default_rng(12).normal(size=(300, 3)) * np.random.default_rng(13).uniform(0.5, 1.5, (300, 1))
    el_t, bar_t = tdisc._closest_point_bary(pts, coords)
    el_j, bar_j = jdisc._closest_point_bary(pts, coords)
    np.testing.assert_array_equal(el_t, el_j)
    np.testing.assert_array_equal(bar_t, bar_j)
    # points on the vertices project onto themselves: one weight of 1 at that vertex
    mesh = tfem.icosphere(2)
    E = tdisc.FEMDiscretization(mesh).evaluation_matrix(mesh.vertices).to_scipy().toarray()
    np.testing.assert_allclose(E, np.eye(mesh.n_vertices), atol=1e-12)


def test_closest_point_chunks_agree(monkeypatch):
    """Points run in chunks of the (points × triangles) work (here 3 points a chunk): the same answer as one call
    per point."""
    coords = tfem.icosphere(1).element_coords()
    pts = np.random.default_rng(14).normal(size=(50, 3))
    monkeypatch.setattr(tdisc, "_CLOSEST_PAIRS", 3 * len(coords))
    el, bar = tdisc._closest_point_bary(pts, coords)
    one = [tdisc._closest_point_bary(p[None], coords) for p in pts]
    np.testing.assert_array_equal(el, [e[0] for e, _ in one])
    np.testing.assert_array_equal(bar, np.concatenate([b for _, b in one]))


def test_surface_matern_variance_matches_reference():
    """Example 14's Matérn on the sphere at icosphere(2), dense backend."""
    jd, td = jdisc.FEMDiscretization(jfem.icosphere(2)), tdisc.FEMDiscretization(tfem.icosphere(2))
    kappa = np.sqrt(8.0)
    jv = jfem.MaternSPDE(jd, smoothness=0).discretize(kappa, solver=jg.SolverSpec(kind="dense")).var()
    tv = tfem.MaternSPDE(td, smoothness=0).discretize(torch.tensor(kappa, dtype=F64),
                                                      solver=tg.SolverSpec(kind="dense")).var()
    assert _rel(tv.numpy(), jv) <= 1e-10


# ---- the barrier model --------------------------------------------------------------

_TAUS = np.array([1.0, 0.6, 2.0])
_RANGES = np.array([0.3, 0.5, 0.2])


@pytest.fixture(scope="module")
def barrier():
    mesh = jfem.create_inflated_rectangle(0, 0, 1, 1, 0.1)
    cent = mesh.element_coords().mean(1)
    wall = np.nonzero((np.abs(cent[:, 0] - 0.5) < 0.08) & (cent[:, 1] < 0.7))[0]
    jm = jfem.BarrierModel(jdisc.FEMDiscretization(mesh), wall)
    tm = tfem.BarrierModel(tdisc.FEMDiscretization(tfem.create_inflated_rectangle(0, 0, 1, 1, 0.1)), wall)
    return jm, tm


def test_barrier_precision_matches_reference(barrier):
    jm, tm = barrier
    Q = tm.precision(tau=torch.tensor(_TAUS), range=torch.tensor(_RANGES))
    for b in range(3):
        J = jm.precision(tau=_TAUS[b], range=_RANGES[b])
        np.testing.assert_array_equal(Q.pattern.rows, J.pattern.rows)
        np.testing.assert_array_equal(Q.pattern.cols, J.pattern.cols)
        assert _rel(Q.data[b].numpy(), J.data) <= 1e-12


def test_barrier_logpdf_and_gradient_match_reference(barrier):
    jm, tm = barrier
    x = np.random.default_rng(15).normal(size=(3, tm.n))

    def jlogpdf(th, xb):
        return jm(tau=jnp.exp(th[0]), range=jnp.exp(th[1])).logpdf(xb)

    th = np.log(np.stack([_TAUS, _RANGES], 1))
    jv, jgrad = jax.jit(jax.vmap(jax.value_and_grad(jlogpdf)))(jnp.asarray(th), jnp.asarray(x))
    p = torch.tensor(th, requires_grad=True)
    v = tm(tau=torch.exp(p[:, 0]), range=torch.exp(p[:, 1])).logpdf(torch.tensor(x))
    (g,) = torch.autograd.grad(v.sum(), p)
    assert _rel(v.detach().numpy(), jv) <= 1e-10
    assert _rel(g.numpy(), jgrad) <= 1e-10


def test_barrier_uniform_range_is_the_stationary_matern():
    """With range_fraction 1 the barrier model is the ν=1 Matérn with range r (κ = √8/r) up to τ."""
    mesh = tfem.create_inflated_rectangle(0, 0, 1, 1, 0.2)
    disc = tdisc.FEMDiscretization(mesh)
    bm = tfem.BarrierModel(disc, [0, 1, 2], range_fraction=1.0)
    Qb = bm.precision(tau=torch.tensor(1.0, dtype=F64), range=torch.tensor(0.4, dtype=F64))
    Qm = tfem.MaternSPDE(disc, smoothness=0).precision(torch.tensor(np.sqrt(8.0) / 0.4, dtype=F64))
    ratio = (Qb.to_scipy().toarray() / np.where(Qm.to_scipy().toarray() == 0, np.inf, Qm.to_scipy().toarray()))
    nz = Qm.to_scipy().toarray() != 0
    assert np.ptp(ratio[nz]) <= 1e-10 * np.abs(ratio[nz]).max()


# ---- point observation models through the Laplace approximation -----------------------


@pytest.fixture(scope="module")
def obs_setup():
    pts = np.random.default_rng(16).uniform(size=(40, 2))
    jmod = jg.MaternModel(pts, smoothness=1)
    tmod = tg.MaternModel(pts, smoothness=1)
    obs_pts = np.random.default_rng(17).uniform(0.1, 0.9, size=(30, 2))
    return jmod, tmod, obs_pts


@pytest.mark.parametrize("which", ["evaluation", "derivative"])
def test_point_obs_models_through_laplace_match_reference(obs_setup, which):
    jmod, tmod, obs_pts = obs_setup
    rng = np.random.default_rng(18)
    if which == "evaluation":
        y = rng.poisson(2.0, size=len(obs_pts)).astype(np.float64)
        jobs = jfem.PointEvaluationObsModel(jmod.disc, obs_pts, jg.ExponentialFamily("poisson"))
        tobs = tfem.PointEvaluationObsModel(tmod.disc, obs_pts, tg.ExponentialFamily("poisson"))
        jlik, tlik = jobs(jnp.asarray(y)), tobs(torch.tensor(y))
    else:
        y = rng.normal(size=len(obs_pts))
        jobs = jfem.PointDerivativeObsModel(jmod.disc, obs_pts, jg.ExponentialFamily("normal"), dim=1)
        tobs = tfem.PointDerivativeObsModel(tmod.disc, obs_pts, tg.ExponentialFamily("normal"), dim=1)
        jlik, tlik = jobs(jnp.asarray(y), sigma=0.5), tobs(torch.tensor(y), sigma=torch.tensor(0.5, dtype=F64))
    jpost = jg.gaussian_approximation(jmod(tau=1.0, range=0.4), jlik, solver=jg.SolverSpec(kind="dense"))
    tpost = tg.gaussian_approximation(tmod(tau=torch.tensor(1.0, dtype=F64), range=torch.tensor(0.4, dtype=F64)),
                                      tlik)
    assert _rel(tpost.mean.numpy(), jpost.mean) <= 1e-8
    assert _rel(tpost.var().numpy(), jpost.var()) <= 1e-8


def test_point_obs_model_on_a_float32_field(obs_setup):
    """The FEM operators are float64; a float32 prior (example 15's) takes the operator in its own dtype: the
    posterior stays float32, within float32 rounding of the float64 one."""
    _, tmod, obs_pts = obs_setup
    y = np.random.default_rng(22).binomial(1, 0.4, size=len(obs_pts)).astype(np.float32)
    obs = tfem.PointEvaluationObsModel(tmod.disc, obs_pts, tg.ExponentialFamily("bernoulli"))
    assert obs.A.dtype == F64
    posts = {dt: tg.gaussian_approximation(tmod(tau=torch.tensor(1.0, dtype=dt), range=torch.tensor(0.4, dtype=dt)),
                                           obs(torch.tensor(y)))
             for dt in (torch.float32, F64)}
    assert posts[torch.float32].mean.dtype == posts[torch.float32].Q.dtype == torch.float32
    assert _rel(posts[torch.float32].mean.numpy(), posts[F64].mean.numpy()) <= 1e-4
    p = tg.conditional_distribution(obs, posts[torch.float32].mean).mean()
    assert p.dtype == torch.float32 and bool(((p >= 0) & (p <= 1)).all())


def test_second_derivative_obs_model_operator(obs_setup):
    jmod, tmod, obs_pts = obs_setup
    J = jfem.PointSecondDerivativeObsModel(jmod.disc, obs_pts, jg.ExponentialFamily("normal"), dims=(0, 1))
    T = tfem.PointSecondDerivativeObsModel(tmod.disc, obs_pts, tg.ExponentialFamily("normal"), dims=(0, 1))
    _same(T.A, J.A)


def test_fem_exports_every_reference_name():
    for name in jfem.__all__:
        assert name in tfem.__all__ and hasattr(tfem, name), name


# ---- solve_refined ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def matern_q():
    mod = jg.MaternModel(np.random.default_rng(19).uniform(size=(60, 2)), smoothness=1)
    J = mod.precision(tau=1.0, range=0.3)
    return J, SparseMatrix(torch.tensor(np.asarray(J.data)), tsn.SparsePattern(J.pattern.rows, J.pattern.cols,
                                                                                 J.shape))


def test_solve_refined_matches_reference(matern_q):
    J, T = matern_q
    b = np.random.default_rng(20).normal(size=(T.shape[0], 3))
    ref = jax.jit(lambda d, bb: jsn.supernodal_factorize(JSparse(d, J.pattern)).solve_refined(
        JSparse(d, J.pattern), bb))(J.data, jnp.asarray(b))
    f = tsn.supernodal_factorize(T)
    got = f.solve_refined(T, torch.tensor(b))
    assert _rel(got.numpy(), ref) <= 1e-10
    one = f.solve_refined(T, torch.tensor(b[:, 0]), iters=1)
    assert tuple(one.shape) == (T.shape[0],) and _rel(one.numpy(), ref[:, 0]) <= 1e-10


def test_solve_refined_on_chains_in_float32(matern_q):
    """Three chains in float32: refinement against the f32 Q brings each chain's solve to the f64 solution of that
    f32 matrix at least as close as the plain solve."""
    _, T = matern_q
    scale = torch.tensor([1.0, 3.0, 0.2], dtype=F64)
    Q32 = SparseMatrix((T.data * scale[:, None]).float(), T.pattern)
    b = torch.tensor(np.random.default_rng(21).normal(size=(3, T.shape[0])), dtype=torch.float32)
    f = tsn.supernodal_factorize(Q32)
    exact = torch.stack([torch.linalg.solve(SparseMatrix(Q32.data[c].double(), T.pattern).todense(), b[c].double())
                         for c in range(3)])
    plain, refined = f.solve(b), f.solve_refined(Q32, b)
    for c in range(3):
        e0 = float((plain[c].double() - exact[c]).abs().max())
        e1 = float((refined[c].double() - exact[c]).abs().max())
        assert e1 <= e0 + 1e-7 * float(exact[c].abs().max())


# ---- the plan's disk cache ------------------------------------------------------------------


def _equal_tables(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, (int, float)) and isinstance(b, (int, float))), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal_tables(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_tables(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path
    else:
        assert a == b, path


@pytest.fixture
def disk_cache(tmp_path, monkeypatch, matern_q):
    monkeypatch.setenv("TPU_GMRF_PLAN_CACHE", str(tmp_path))
    monkeypatch.setattr(tsn, "_DISK_MIN_N", 1)
    _, T = matern_q
    key = (T.pattern, 2048, "auto")
    built = tsn.supernodal_plan(T.pattern) if tsn._PLAN_CACHE.get(key) is None else tsn._PLAN_CACHE[key]
    tsn._PLAN_CACHE.pop(key)
    fresh = tsn.supernodal_plan(T.pattern)  # built again: written to disk
    path = tsn._disk_path(T.pattern, 2048, "auto")
    yield T, key, fresh, path
    tsn._PLAN_CACHE[key] = built


def test_plan_disk_cache_round_trip(disk_cache):
    T, key, fresh, path = disk_cache
    assert path.endswith(".npz") and (tsn._PLAN_VERSION and f"plan_{T.shape[0]}_" in path)
    tsn._PLAN_CACHE.pop(key)
    loaded = tsn.supernodal_plan(T.pattern)
    assert loaded is not fresh
    _equal_tables(loaded, fresh)
    tsn._PLAN_CACHE.pop(key)
    tsn._PLAN_CACHE[key] = loaded
    f = tsn.supernodal_factorize(T)
    tsn._PLAN_CACHE[key] = fresh
    g = tsn.supernodal_factorize(T)
    assert torch.equal(f.logdet(), g.logdet())


@pytest.mark.parametrize("damage", ["version", "garbage", "pickled"])
def test_plan_disk_cache_rebuilds_a_bad_file(disk_cache, damage):
    T, key, fresh, path = disk_cache
    if damage == "version":
        with np.load(path) as f:
            arrays = {k: f[k] for k in f.files}
        arrays["__version__"] = np.array(tsn._PLAN_VERSION - 1)
        np.savez(path, **arrays)
    elif damage == "garbage":
        with open(path, "wb") as fh:
            fh.write(b"not a plan")
    else:  # an object array needs pickle to load: never trusted
        with np.load(path) as f:
            arrays = {k: f[k] for k in f.files}
        arrays["__skeleton__"] = np.array([json.loads(str(arrays["__skeleton__"]))], dtype=object)
        np.savez(path, **arrays)
    assert tsn._load_plan(path) is None
    tsn._PLAN_CACHE.pop(key)
    rebuilt = tsn.supernodal_plan(T.pattern)
    _equal_tables(rebuilt, fresh)
    _equal_tables(tsn._load_plan(path), fresh)  # written anew


def test_plan_disk_cache_off_below_its_size(tmp_path, monkeypatch, matern_q):
    monkeypatch.setenv("TPU_GMRF_PLAN_CACHE", str(tmp_path))
    _, T = matern_q
    assert tsn._disk_path(T.pattern, 2048, "auto") is None
    monkeypatch.delenv("TPU_GMRF_PLAN_CACHE")
    monkeypatch.setattr(tsn, "_DISK_MIN_N", 1)
    assert tsn._disk_path(T.pattern, 2048, "auto") is None
