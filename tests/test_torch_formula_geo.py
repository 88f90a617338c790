"""The port's formula interface, shapefile contiguity and plotting recipes
against the JAX package, float64 on CPU tensors, on the same NumPy-seeded
inputs.

Formula: the cases of tests/test_formula.py (normal IID + RW1 with fixed
effects, Poisson + exposure + Besag, BYM2, Separable, predict_cols with and
without fixed terms) plus a Matérn and an AR1 term; the design A (pattern
and data), y, the hyperparameters and meta equal to the reference's, and
the posterior mean at 1e-10 where the prior is unconstrained, 1e-7 where it
is constrained (the KKT Newton mode agrees only to ~√eps:
tests/test_torch_constrained_ga.py); the Laplace marginal and its
θ-gradient through a formula-built model at 1e-8 relative against
``jax.grad``. `_khatri_rao_indicator` equal to the reference's exactly.
Geo: W equal to the reference's (queen and rook) on a written shapefile
and on example 06's polygons, and the reader's three errors. Plotting
(under Agg): each recipe returns its axes or figure, and plot_1d's ribbon
is mean ± 1.96·std at 1e-10. Example 06 at its size: both posteriors'
mean and std against the reference at 1e-7, and the example's asserts.
Each reference result is computed once per module.
"""

import importlib.util
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
import tpu_gmrf.formula as jf
import tpu_gmrf.geo as jgeo
import tpu_gmrf_torch as tg
import tpu_gmrf_torch.formula as tf
from tpu_gmrf.formula.terms import _khatri_rao_indicator as j_khatri_rao
from tpu_gmrf_torch import geo as tgeo
from tpu_gmrf_torch.formula.terms import _khatri_rao_indicator as t_khatri_rao

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
_OPTS = dict(max_iter=50, mean_change_tol=1e-10, newton_dec_tol=1e-14)
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=requires_grad)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grid_W(nx, ny):
    n = nx * ny
    rows, cols = [], []
    for i in range(nx):
        for j in range(ny):
            k = i * ny + j
            if i + 1 < nx:
                rows += [k, k + ny]
                cols += [k + ny, k]
            if j + 1 < ny:
                rows += [k, k + 1]
                cols += [k + 1, k]
    return sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()


def _assert_same_sparse(T, J):
    np.testing.assert_array_equal(T.pattern.rows, J.pattern.rows)
    np.testing.assert_array_equal(T.pattern.cols, J.pattern.cols)
    assert T.shape == J.shape
    np.testing.assert_array_equal(_np(T.data), np.asarray(J.data))


def _ex06():
    spec = importlib.util.spec_from_file_location("ex06", ROOT / "examples" / "06_bym_disease_mapping.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the formula cases ----------------------------------------------------------------------------------------
# name: (formula or a function of the formula module giving a term list, data from an rng(42), family, kwargs of
# build_formula_components with W in its context, θ of the prior, θ of the likelihood)


def _iid_rw(rng):
    n = 60
    group, time = rng.integers(0, 5, size=n), rng.integers(0, 10, size=n)
    x = rng.normal(size=n)
    return {"y": rng.normal(size=n) + x * 0.5, "x": x, "group": group, "time": time}


def _besag(rng):
    region, E = rng.integers(0, 16, size=48), rng.uniform(0.5, 2.0, size=48)
    return {"y": rng.poisson(E * 1.5), "region": region, "E": E}


def _bym2(rng):
    return {"y": rng.poisson(2.0, size=27), "region": rng.integers(0, 9, size=27)}


def _separable(rng):
    n = 40
    g, t = rng.integers(0, 3, size=n), rng.integers(0, 4, size=n)
    return {"y": rng.normal(size=n), "g": g, "t": t}


def _iid(rng):
    n = 30
    group = rng.integers(0, 4, size=n)
    return {"y": rng.normal(size=n), "group": group}


def _iid_fixed(rng):
    n = 30
    group, x = rng.integers(0, 4, size=n), rng.normal(size=n)
    return {"y": rng.normal(size=n), "group": group, "x": x}


def _matern(rng):
    n = 50
    px, py = rng.uniform(size=n), rng.uniform(size=n)
    return {"y": np.sin(3 * px) * np.cos(2 * py) + 0.1 * rng.normal(size=n), "px": px, "py": py,
            "z": rng.normal(size=n)}


def _ar1(rng):
    n = 40
    t = rng.integers(0, 12, size=n)
    return {"y": rng.poisson(np.exp(0.3 * np.sin(t)), size=n), "t": t}


CASES = {
    "iid_rw1": ("y ~ 1 + x + IID(group) + RW1(time)", _iid_rw, "normal", {},
                {"tau_iid": 1.0, "tau_rw1": 1.0}, {"sigma": 1.0}),
    "besag_exposure": ("y ~ 1 + Besag(region, W)", _besag, "poisson", {"exposure": "E", "W": _grid_W(4, 4)},
                       {"tau_besag": 1.0}, {}),
    "bym2": ("y ~ BYM2(region, W)", _bym2, "poisson", {"W": _grid_W(3, 3)}, {"tau_bym2": 1.0, "phi_bym2": 0.5}, {}),
    "separable": (lambda F: [F.Separable(F.RW1("t"), F.IID("g"))], _separable, "normal", {},
                  {"tau_rw1_separable": 1.0, "tau_iid_separable": 2.0}, {"sigma": 1.0}),
    "iid": ("y ~ IID(group)", _iid, "normal", {}, {"tau_iid": 1.0}, {"sigma": 1.0}),
    "iid_fixed": ("y ~ x + IID(group)", _iid_fixed, "normal", {}, {"tau_iid": 1.0}, {"sigma": 1.0}),
    "matern": ("y ~ 1 + z + Matern(['px', 'py'], smoothness=1)", _matern, "normal", {},
               {"tau_matern": 1.0, "range_matern": 0.5}, {"sigma": 0.3}),
    "ar1": ("y ~ 1 + AR1(t)", _ar1, "poisson", {}, {"tau_ar1": 2.0, "rho_ar1": 0.6}, {}),
}
_REF: dict = {}
_REF_POST: dict = {}
# the predict_cols cases are held by their designs; the others also by their posteriors
POSTERIOR_CASES = sorted(set(CASES) - {"iid", "iid_fixed"})


def _build(M, name):
    formula, make, family, kw, _, _ = CASES[name]
    kw = dict(kw)
    W = kw.pop("W", None)
    data = make(np.random.default_rng(42))
    return M.build_formula_components(formula if isinstance(formula, str) else formula(M), data, family=family,
                                      context=None if W is None else {"W": W}, **kw)


def _ref(name):
    """The reference's components (once per module)."""
    if name not in _REF:
        _REF[name] = _build(jf, name)
    return _REF[name]


def _jref_posterior(comps, th_prior, th_lik, jit):
    """The reference's posterior mean and std, as one jitted program or eagerly."""

    def f(th):
        post = jg.gaussian_approximation(comps.combined_model(**th), comps.obs_model(comps.y, **th_lik),
                                         options=jg.GAOptions(**_OPTS))
        return post.mean, post.std()

    mean, std = (jax.jit(f) if jit else f)({k: jnp.asarray(v) for k, v in th_prior.items()})
    return np.asarray(mean), np.asarray(std)


def _ref_posterior(name):
    """The reference's posterior mean and std (once per module). A constrained case's is one jitted program (a
    quarter of the eager time); an unconstrained one runs eagerly, op by op as the port does: there the fused program
    reorders the arithmetic, and on the AR1 + intercept posterior (the intercept's ridge is 1e-6) it reads 8e-10 from
    the eager one, above the 1e-10 these cases are held to."""
    if name not in _REF_POST:
        comps = _ref(name)
        _, _, _, _, th_prior, th_lik = CASES[name]
        _REF_POST[name] = _jref_posterior(comps, th_prior, th_lik, jit=comps.combined_model.constraints() is not None)
    return _REF_POST[name]


def _port_posterior(comps, name):
    _, _, _, _, th_prior, th_lik = CASES[name]
    prior = comps.combined_model(**{k: _t(v) for k, v in th_prior.items()})
    lik = comps.obs_model(comps.y, **{k: _t(v) for k, v in th_lik.items()})
    return tg.gaussian_approximation(prior, lik, options=tg.GAOptions(**_OPTS))


def _y_arrays(y):
    """The observation box's arrays (or y itself), by field name."""
    if hasattr(y, "__dataclass_fields__"):
        return {k: getattr(y, k) for k in y.__dataclass_fields__}
    return {"y": y}


@pytest.mark.parametrize("name", sorted(CASES))
def test_formula_components_match_reference(name):
    comps, jcomps = _build(tf, name), _ref(name)
    _assert_same_sparse(comps.A, jcomps.A)
    assert comps.hyperparameters == jcomps.hyperparameters
    assert comps.combined_model.n == jcomps.combined_model.n == comps.A.shape[1]
    for key in ("n_random", "n_fixed", "term_sizes"):
        assert comps.meta[key] == jcomps.meta[key]
    assert [type(t).__name__ for t in comps.meta["fixed_terms"]] == [type(t).__name__ for t in
                                                                      jcomps.meta["fixed_terms"]]
    got, ref = _y_arrays(comps.y), _y_arrays(jcomps.y)
    assert got.keys() == ref.keys()
    for k in got:
        assert (got[k] is None) == (ref[k] is None)
        if got[k] is not None:
            np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), rtol=1e-15, atol=0)
    if "exposure" in CASES[name][3]:
        assert comps.y.logexposure.dtype == F64
    for (t, levels), (jt, jlevels) in zip(comps.terms, jcomps.terms):
        assert type(t).__name__ == type(jt).__name__
        if levels is not None:
            np.testing.assert_array_equal(np.asarray(levels), np.asarray(jlevels))


@pytest.mark.parametrize("name", POSTERIOR_CASES)
def test_formula_posterior_mean_matches_reference(name):
    comps = _build(tf, name)
    jmean, jstd = _ref_posterior(name)
    post = _port_posterior(comps, name)
    constrained = comps.combined_model.constraints() is not None
    assert isinstance(post, tg.ConstrainedGMRF) == constrained
    assert _rel(post.mean, jmean) <= (1e-7 if constrained else 1e-10)
    assert _rel(post.std(), jstd) <= (1e-7 if constrained else 1e-10)
    if constrained:
        A, e = comps.combined_model.constraints()
        assert np.abs(_np(post.mean) @ A.T - e).max() <= 1e-10


def test_formula_structure_as_in_the_reference_tests():
    """tests/test_formula.py's own assertions on the port."""
    comps = _build(tf, "iid_rw1")
    assert comps.meta["n_random"] == 2 and comps.meta["n_fixed"] == 2
    assert comps.combined_model.n == 17 and comps.A.shape == (60, 17)
    assert comps.hyperparameters == ("tau_iid", "tau_rw1")
    A = _np(_build(tf, "bym2").A.todense())
    nz = [np.nonzero(row)[0] for row in A]
    assert all(len(z) == 2 and z[1] - z[0] == 9 for z in nz)
    comps = _build(tf, "separable")
    data = _separable(np.random.default_rng(42))
    assert comps.combined_model.n == 12
    A = _np(comps.A.todense())
    assert all(np.nonzero(A[i])[0].tolist() == [data["t"][i] * 3 + data["g"][i]] for i in range(40))


@pytest.mark.parametrize("with_fixed", [False, True])
def test_predict_cols_matches_reference(with_fixed):
    name = "iid_fixed" if with_fixed else "iid"
    newdata = {"group": np.array([1, 3]), "x": np.array([0.5, -2.0])} if with_fixed else \
        {"group": np.array([0, 2, 3])}
    got = tf.predict_cols(_build(tf, name), newdata)
    _assert_same_sparse(got, jf.predict_cols(_ref(name), newdata))
    Ad = _np(got.todense())
    if with_fixed:
        np.testing.assert_allclose(Ad[:, :4], [[0, 1, 0, 0], [0, 0, 0, 1]])
        np.testing.assert_allclose(Ad[:, 4], [0.5, -2.0])
    else:
        np.testing.assert_allclose(Ad[:2], [[1, 0, 0, 0], [0, 0, 1, 0]])
    with pytest.raises(KeyError):
        tf.predict_cols(_build(tf, name), {**newdata, "group": np.array([7])})


def test_predict_cols_on_the_fitted_matern_mesh():
    newdata = {"px": np.array([0.2, 0.7]), "py": np.array([0.5, 0.4]), "z": np.array([1.0, -1.0])}
    _assert_same_sparse(tf.predict_cols(_build(tf, "matern"), newdata),
                        jf.predict_cols(_ref("matern"), newdata))


def test_formula_accepts_tensor_columns_and_float32_exposure():
    data = _besag(np.random.default_rng(42))
    W = CASES["besag_exposure"][3]["W"]
    ref = tf.build_formula_components("y ~ 1 + Besag(region, W)", data, family="poisson", exposure="E",
                                      context={"W": W})
    for E in (data["E"].astype(np.float32), torch.tensor(data["E"], dtype=torch.float32)):
        tdata = {"y": torch.tensor(data["y"]), "region": torch.tensor(data["region"]), "E": E}
        got = tf.build_formula_components("y ~ 1 + Besag(region, W)", tdata, family="poisson", exposure="E",
                                          context={"W": W})
        _assert_same_sparse(got.A, ref.A)
        assert got.y.logexposure.dtype == F64
        np.testing.assert_allclose(_np(got.y.logexposure), np.log(data["E"].astype(np.float32).astype(np.float64)),
                                   rtol=1e-15)


def test_khatri_rao_indicator_matches_reference_exactly():
    rng = np.random.default_rng(3)
    m, na, nb = 23, 5, 4

    def block(M, n, per_row):
        rows, cols = [], []
        for r in range(m):
            c = rng.choice(n, size=per_row[r], replace=False)
            rows += [r] * len(c)
            cols += list(c)
        vals = rng.normal(size=len(rows))
        pat = M.SparsePattern(np.asarray(rows), np.asarray(cols), (m, n))
        return pat, vals

    per_a, per_b = rng.integers(0, 3, size=m), rng.integers(0, 4, size=m)
    pa, va = block(jg, na, per_a)
    pb, vb = block(jg, nb, per_b)
    J = j_khatri_rao(jg.SparseMatrix(jnp.asarray(va)[pa.sort_order], pa),
                     jg.SparseMatrix(jnp.asarray(vb)[pb.sort_order], pb))
    tpa = tg.SparsePattern(pa.rows, pa.cols, pa.shape)
    tpb = tg.SparsePattern(pb.rows, pb.cols, pb.shape)
    T = t_khatri_rao(tg.SparseMatrix(_t(np.asarray(va)[pa.sort_order]), tpa),
                     tg.SparseMatrix(_t(np.asarray(vb)[pb.sort_order]), tpb))
    _assert_same_sparse(T, J)
    assert T.nnz == int((per_a * per_b).sum())


_GRAD: dict = {}


@pytest.mark.parametrize("name", ["besag_exposure", "bym2"])
def test_laplace_marginal_and_gradient_through_a_formula_match_reference(name):
    _, _, _, _, th_prior, _ = CASES[name]
    names = tuple(th_prior)
    if name not in _GRAD:
        jc = _ref(name)

        def f(lt):
            return jg.laplace_marginal(jc.combined_model, jc.obs_model, jc.y,
                                       {k: jnp.exp(lt[i]) for i, k in enumerate(names)},
                                       options=jg.GAOptions(**_OPTS))

        _GRAD[name] = jax.jit(jax.value_and_grad(f))(jnp.log(jnp.asarray([th_prior[k] for k in names])))
    jv, jgrad = _GRAD[name]
    comps = _build(tf, name)
    lt = _t(np.log([th_prior[k] for k in names]), requires_grad=True)
    v = tg.laplace_marginal(comps.combined_model, comps.obs_model, comps.y,
                            {k: torch.exp(lt[i]) for i, k in enumerate(names)}, options=tg.GAOptions(**_OPTS))
    v.backward()
    assert abs(float(v.detach()) / float(jv) - 1) <= 1e-8
    assert _rel(lt.grad, jgrad) <= 1e-8


# ---- geo -------------------------------------------------------------------------------------------------------


def _write_polygon_shapefile(path, polygons, null_after=()):
    """A minimal .shp of polygon records (each a list of closed rings); a null record after each index listed."""
    records = []
    for i, poly in enumerate(polygons):
        rings = [np.asarray(r, dtype=np.float64) for r in poly]
        pts = np.concatenate(rings)
        content = struct.pack("<i", 5)  # polygon
        content += struct.pack("<4d", *pts.min(0), *pts.max(0))
        content += struct.pack("<ii", len(rings), len(pts))  # numparts, numpoints
        content += struct.pack(f"<{len(rings)}i", *np.cumsum([0] + [len(r) for r in rings[:-1]]))
        content += pts.astype("<f8").tobytes()
        records.append(content)
        if i in null_after:
            records.append(struct.pack("<i", 0))
    body = b"".join(struct.pack(">ii", k + 1, len(c) // 2) + c for k, c in enumerate(records))
    header = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", (100 + len(body)) // 2)
    header += struct.pack("<ii", 1000, 5) + struct.pack("<8d", 0, 0, 10, 10, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header + body)


def _square(ox, oy):
    return [[(ox, oy), (ox, oy + 1.0), (ox + 1.0, oy + 1.0), (ox + 1.0, oy), (ox, oy)]]


def _same_W(T, J):
    assert T.shape == J.shape
    np.testing.assert_array_equal(T.indptr, J.indptr)
    np.testing.assert_array_equal(T.indices, J.indices)
    np.testing.assert_array_equal(T.data, J.data)


@pytest.mark.parametrize("criterion", ["queen", "rook"])
def test_shapefile_contiguity_matches_reference(tmp_path, criterion):
    # tests/test_parity_layers.py's squares: 0-1 and 1-2 share an edge, 3 touches 0 at a corner and 1 along an
    # edge; plus a square with a hole (two rings) and a null record, which the readers skip
    shp = tmp_path / "grid.shp"
    holed = [_square(3, 0)[0], [(3.25, 0.25), (3.75, 0.25), (3.75, 0.75), (3.25, 0.75), (3.25, 0.25)]]
    _write_polygon_shapefile(shp, [_square(0, 0), _square(1, 0), _square(2, 0), _square(1, 1), holed], null_after=(1,))
    polys, jpolys = tgeo.read_shapefile_polygons(str(shp)), jgeo.read_shapefile_polygons(str(shp))
    assert len(polys) == len(jpolys) == 5 and [len(p) for p in polys] == [1, 1, 1, 1, 2]
    for p, jp in zip(polys, jpolys):
        for r, jr in zip(p, jp):
            np.testing.assert_array_equal(r, jr)
    W = tg.adjacency_from_shapefile(str(shp), criterion)
    _same_W(W, jgeo.adjacency_from_shapefile(str(shp), criterion))
    Wd = W.toarray()
    np.testing.assert_array_equal(Wd, Wd.T)
    assert Wd[0, 1] == Wd[1, 2] == Wd[1, 3] == Wd[2, 4] == 1 and Wd[0, 2] == 0
    assert Wd[0, 3] == (1 if criterion == "queen" else 0)  # a corner counts for queen only
    assert len(tg.BesagModel(W)(tau=_t(1.0))) == 5


@pytest.mark.parametrize("criterion", ["queen", "rook"])
def test_contiguity_of_example06_polygons_matches_reference(criterion):
    polys, _ = _ex06().synthetic_districts(12, 9, seed=3)
    W = tg.contiguity_adjacency(polys, criterion)
    _same_W(W, jgeo.contiguity_adjacency(polys, criterion))
    deg = np.asarray(W.sum(axis=1)).ravel().reshape(12, 9)
    assert deg[1:-1, 1:-1].min() == deg[1:-1, 1:-1].max() == (8 if criterion == "queen" else 4)


@pytest.mark.parametrize("fault", ["truncated", "magic", "shape_type"])
def test_shapefile_reader_errors_match_reference(tmp_path, fault):
    shp = tmp_path / "bad.shp"
    _write_polygon_shapefile(shp, [_square(0, 0)])
    raw = bytearray(shp.read_bytes())
    if fault == "truncated":
        raw = raw[:60]
    elif fault == "magic":
        raw[:4] = struct.pack(">i", 1234)
    else:
        raw[108:112] = struct.pack("<i", 3)  # the first record's shape type: a polyline
    shp.write_bytes(bytes(raw))
    with pytest.raises(ValueError) as got:
        tgeo.read_shapefile_polygons(str(shp))
    with pytest.raises(ValueError) as ref:
        jgeo.read_shapefile_polygons(str(shp))
    assert str(got.value) == str(ref.value)


# ---- plotting --------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plotting():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    from tpu_gmrf_torch import plotting

    return plotting


def test_plot_1d_ribbon_and_samples(plotting):
    g = tg.AR1Model(30)(tau=_t(1.0), rho=_t(0.5))
    ax = plotting.plot_1d(g, n_samples=3, generator=torch.Generator().manual_seed(0))
    band = ax.collections[0].get_paths()[0].vertices
    mean, std = _np(g.mean), _np(g.std())
    lo, hi = band[1:31, 1], band[32:62, 1][::-1]
    np.testing.assert_allclose(lo, mean - 1.96 * std, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(hi, mean + 1.96 * std, rtol=1e-10, atol=1e-12)
    assert len(ax.lines) == 4  # the mean and three draws
    np.testing.assert_allclose(ax.lines[0].get_ydata(), mean, rtol=1e-15)
    two = tg.AR1Model(30)(tau=_t([1.0, 2.0]), rho=_t([0.5, 0.5]))
    with pytest.raises(ValueError, match="one chain"):
        plotting.plot_1d(two)


def test_plot_field_and_spatiotemporal(plotting):
    rng = np.random.default_rng(42)
    mesh = tg.generate_mesh(rng.random((30, 2)))
    vals = _t(rng.random(mesh.vertices.shape[0]))
    ax = plotting.plot_field(vals, mesh=mesh)
    # flat shading: each triangle coloured by the mean of its vertices' values
    np.testing.assert_allclose(ax.collections[0].get_array(), _np(vals)[mesh.triangles].mean(1), rtol=1e-12)
    disc = tg.FEMDiscretization(mesh)
    Q = tg.spdiag(_t(np.full(3 * disc.ndofs, 4.0)))
    st = tg.SpatiotemporalGMRF(tg.GMRF.from_precision(_t(rng.normal(size=3 * disc.ndofs)), Q), 3, disc)
    fig = plotting.plot_spatiotemporal(st, ncols=2)
    assert len(fig.axes) >= 4
    fig = plotting.plot_spatiotemporal(st, what="std", times=[0, 2])
    assert len(fig.axes) >= 4


# ---- example 06 ------------------------------------------------------------------------------------------------


def _ex06_data():
    """examples/06_bym_disease_mapping.py's polygons, W and data (seed 7)."""
    ex = _ex06()
    rng = np.random.default_rng(7)
    polys, centers = ex.synthetic_districts()
    n_d = len(polys)
    W = tg.contiguity_adjacency(polys, criterion="queen")
    aff = rng.uniform(0.0, 0.3, size=n_d)
    u_true = 0.6 * np.sin(1.2 * centers[:, 0]) * np.cos(0.9 * centers[:, 1])
    v_true = 0.15 * rng.standard_normal(n_d)
    eta_true = -0.2 + 2.0 * aff + u_true + v_true
    E = rng.uniform(5.0, 80.0, size=n_d)
    y = rng.poisson(E * np.exp(eta_true)).astype(np.float64)
    return W, {"y": y, "aff": aff, "E": E, "district": np.arange(n_d)}, eta_true


EX06 = {"bym": ("y ~ 1 + aff + Besag(district, W) + IID(district)", {"tau_besag": 4.0, "tau_iid": 16.0}),
        "bym2": ("y ~ 1 + aff + BYM2(district, W)", {"tau_bym2": 2.0, "phi_bym2": 0.4})}


_EX06_REF: dict = {}


@pytest.mark.parametrize("form", sorted(EX06))
def test_example06_matches_reference_and_its_asserts(form):
    W, data, eta_true = _ex06_data()
    formula, theta = EX06[form]
    if form not in _EX06_REF:  # the reference's posterior, constrained: one jitted program
        jc = jf.build_formula_components(formula, data, family="poisson", exposure="E", context={"W": W})
        _EX06_REF[form] = _jref_posterior(jc, theta, {}, jit=True)
    jmean, jstd = _EX06_REF[form]
    comps = tf.build_formula_components(formula, data, family="poisson", exposure="E", context={"W": W})
    post = tg.gaussian_approximation(comps.combined_model(**{k: _t(v) for k, v in theta.items()}),
                                     comps.obs_model(comps.y), options=tg.GAOptions(**_OPTS))
    mean, std, eta = _np(post.mean), _np(post.std()), _np(comps.A.matvec(post.mean))
    assert _rel(mean, jmean) <= 1e-7 and _rel(std, jstd) <= 1e-7
    # the example's acceptance checks (examples/06_bym_disease_mapping.py:123-131)
    assert np.all(np.isfinite(std))
    r = np.corrcoef(eta, eta_true)[0, 1]
    if form == "bym":
        assert abs(mean[-1] - 2.0) < 3 * 1.96 * std[-1] + 0.5
        assert r > 0.9
    else:
        assert r > 0.85
