"""The port's latent model zoo against the JAX package, float64, on the same
NumPy inputs: RW1/RW2 (with the Sørbye-Rue scaling), IID and fixed effects,
AR(p) through Durbin-Levinson and K5's SpGEMM, Besag (components,
singletons, the geometric-mean normalization) and BYM2, CAR, Combined and
Separable; `sp_block_diag`, `sp_kron`, `stack_constraints` and `MetaGMRF`.

Tolerances: precision data, constraints and hyperparameter names 1e-12
relative (the same arithmetic on the same host arrays, the SpGEMM's sums in
another order; the port model is given the reference's normalization for
this); the Besag and RW normalizations 1e-10 (the reference takes
the constrained variances from its dense backend, the port from
``SolverSpec()``: tridiagonal for RW1, dense for the small grids here, each
a Cholesky in another order); model log-densities 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf.models.base import stack_constraints as j_stack
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.matrix import sp_block_diag as j_block_diag
from tpu_gmrf.sparse.matrix import sp_kron as j_kron
from tpu_gmrf.sparse.pattern import SparsePattern as JPattern
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.models.ar import durbin_levinson
from tpu_gmrf_torch.models.base import stack_constraints
from tpu_gmrf_torch.models.rw import geomean

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
    """Example 08's four-neighbour grid adjacency."""
    idx = np.arange(m * n).reshape(n, m)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(m * n, m * n))
    return W + W.T


def _islands():
    """Two components and a singleton: a 3-cycle, a path of 3, an isolated node."""
    W = np.zeros((7, 7))
    for i, j in ((0, 1), (1, 2), (0, 2), (3, 4), (4, 5)):
        W[i, j] = W[j, i] = 1.0
    return sp.csr_matrix(W)


# (name, port model factory, reference model factory, θ)
CASES = {
    "rw1": (lambda M: M.RW1Model(12), {"tau": 1.7}),
    "rw2": (lambda M: M.RW2Model(14), {"tau": 0.6}),
    "rw1_scaled": (lambda M: M.RW1Model(40, scale_model=True), {"tau": 1.3}),
    "rw2_scaled_extra": (lambda M: M.RWModel(25, order=2, scale_model=True,
                                             additional_constraints=(np.arange(25.0)[None] ** 2, [1.0])),
                         {"tau": 2.1}),
    "iid": (lambda M: M.IIDModel(6), {"tau": 4.0}),
    "iid_sumtozero": (lambda M: M.IIDModel(6, constraint="sumtozero"), {"tau": 0.3}),
    "fixed": (lambda M: M.FixedEffectsModel(4, lam=1e-3), {}),
    "ar2": (lambda M: M.ARModel(15, order=2), {"tau": 1.2, "pacf1": 0.9, "pacf2": -0.5}),
    "ar3": (lambda M: M.ARModel(17, order=3), {"tau": 0.8, "pacf1": 0.5, "pacf2": 0.3, "pacf3": -0.4}),
    "besag_raw": (lambda M: M.BesagModel(grid_adjacency(4, 4), normalize_var=False), {"tau": 2.0}),
    "besag": (lambda M: M.BesagModel(grid_adjacency(5, 4)), {"tau": 1.4}),
    "besag_islands": (lambda M: M.BesagModel(_islands()), {"tau": 0.9}),
    "besag_degenerate": (lambda M: M.BesagModel(_islands(), normalize_var=False, singleton_policy="degenerate"),
                         {"tau": 1.1}),
    "bym2": (lambda M: M.BYM2Model(grid_adjacency(3, 3)), {"tau": 1.5, "phi": 0.4}),
    "car": (lambda M: M.CARModel(grid_adjacency(3, 3)), {"rho": 0.7, "sigma": 2.0}),
    "combined": (lambda M: M.CombinedModel(M.RW1Model(5), M.IIDModel(3), M.IIDModel(4)),
                 {"tau_rw1": 1.0, "tau_iid": 2.0, "tau_iid_2": 3.0}),
    "combined_fixed": (lambda M: M.CombinedModel(M.BesagModel(grid_adjacency(3, 2)), M.FixedEffectsModel(2)),
                       {"tau_besag": 0.7}),
    "separable": (lambda M: M.SeparableModel(M.AR1Model(4), M.IIDModel(3)),
                  {"tau_ar1": 1.0, "rho_ar1": 0.5, "tau_iid": 2.0}),
    "separable_intrinsic": (lambda M: M.SeparableModel(M.RW1Model(4), M.RW1Model(3)),
                            {"tau_rw1": 1.0, "tau_rw1_2": 1.6}),
}


def _shared_normalization(tm, jm):
    """Give the port model the reference's normalization (Besag's norms, RW's
    scale factor), so that the data comparison sees the precision's own
    arithmetic; the normalizations are held on their own, to 1e-10, below."""
    for t, j in [(tm, jm)] + [(a, b) for a, b in zip(getattr(tm, "components", ()), getattr(jm, "components", ()))] \
            + ([(tm.besag, jm.besag)] if hasattr(tm, "besag") else []):
        if hasattr(t, "_norms"):
            t._norms = np.asarray(j._norms)
        if hasattr(t, "scale_factor"):
            t.scale_factor = float(j.scale_factor)


_REF: dict = {}


def _models(name, shared=True):
    """(port model, reference model, θ); each reference model is built once per module (the JAX package's
    normalizations run eagerly, seconds each)."""
    factory, theta = CASES[name]
    if name not in _REF:
        _REF[name] = factory(jg)
    tm, jm = factory(tg), _REF[name]
    if shared:
        _shared_normalization(tm, jm)
    return tm, jm, theta


def _jdata(Q):
    return np.asarray(Q.data, np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_precision_constraints_and_names_match_reference(name):
    tm, jm, theta = _models(name)
    assert tm.hyperparameters == jm.hyperparameters and tm.n == jm.n and tm.name == jm.name
    Q = tm.precision(**{k: _t(v) for k, v in theta.items()})
    J = jm.precision(**{k: jnp.asarray(v) for k, v in theta.items()})
    np.testing.assert_array_equal(Q.pattern.rows, J.pattern.rows)
    np.testing.assert_array_equal(Q.pattern.cols, J.pattern.cols)
    assert Q.dtype == F64 and _rel(Q.data, _jdata(J)) <= 1e-12
    tc, jc = tm.constraints(), jm.constraints()
    assert (tc is None) == (jc is None)
    if tc is not None:
        assert _rel(tc[0], jc[0]) <= 1e-12 and np.array_equal(np.asarray(tc[1]), np.asarray(jc[1]))


@pytest.mark.parametrize("name", ["rw1", "rw2_scaled_extra", "ar2", "besag", "bym2", "separable_intrinsic",
                                  "combined"])
def test_batched_hyperparameters_match_reference_per_chain(name):
    tm, jm, theta = _models(name)
    scales = np.array([0.5, 1.0, 1.7])
    # every θ entry that is not a PACF or a mixing weight is scaled per chain
    batched = {k: (v * scales if not k.startswith(("pacf", "phi", "rho")) else np.full(3, v))
               for k, v in theta.items()}
    Q = tm.precision(**{k: _t(v) for k, v in batched.items()})
    assert Q.data.shape == (3, Q.nnz)
    for b in range(3):
        J = jm.precision(**{k: jnp.asarray(v[b]) for k, v in batched.items()})
        assert _rel(Q.data[b], _jdata(J)) <= 1e-12


@pytest.mark.parametrize("name", ["rw1", "rw2", "iid_sumtozero", "besag", "bym2", "separable_intrinsic",
                                  "combined", "ar2"])
def test_model_gmrf_logpdf_matches_reference(name):
    tm, jm, theta = _models(name)
    g = tm(**{k: _t(v) for k, v in theta.items()})
    gj = jm(**{k: jnp.asarray(v) for k, v in theta.items()})
    assert type(g).__name__ == type(gj).__name__
    x = np.random.default_rng(3).normal(size=tm.n)
    if isinstance(g, tg.ConstrainedGMRF):
        x = np.asarray(gj.project(jnp.asarray(x)))
        assert _rel(g.mean, gj.mean) <= 1e-10 or np.abs(np.asarray(gj.mean)).max() <= 1e-12
        assert abs(float(g.log_correction) - float(gj.log_correction)) <= 1e-10 * abs(float(gj.log_correction))
    assert abs(float(g.logpdf(_t(x))) / float(gj.logpdf(jnp.asarray(x))) - 1) <= 1e-10


@pytest.mark.parametrize("name", ["rw1_scaled", "rw2_scaled_extra"])
def test_rw_scale_factor_matches_reference(name):
    tm, jm, _ = _models(name, shared=False)
    assert abs(tm.scale_factor / float(jm.scale_factor) - 1) <= 1e-10
    # the Sørbye-Rue property: under the null-space constraints alone, the scaled model's variances have
    # geometric mean 1 (up to the ridge)
    if tm.additional is None:
        with torch.no_grad():
            var = tm(tau=_t(1.0)).var()
        assert abs(float(geomean(var)) - 1.0) <= 2e-3


@pytest.mark.parametrize("grid", [(5, 4), (6, 6)])
def test_besag_normalization_matches_reference(grid):
    W = grid_adjacency(*grid)
    tm, jm = tg.BesagModel(W), jg.BesagModel(W)
    assert _rel(tm._norms, jm._norms) <= 1e-10
    assert tm.normalization_backend == "dense"


def test_besag_components_and_singletons_match_reference():
    for policy in ("gaussian", "degenerate"):
        tm = tg.BesagModel(_islands(), singleton_policy=policy)
        jm = jg.BesagModel(_islands(), singleton_policy=policy)
        assert _rel(tm._norms, jm._norms) <= 1e-10
        assert [c.tolist() for c in tm.components] == [c.tolist() for c in jm.components]
        assert tm.constraints()[0].shape == ((2, 7) if policy == "gaussian" else (3, 7))
    with pytest.raises(ValueError):
        tg.BesagModel(_islands(), additional_constraints="sumtozero")
    with pytest.raises(ValueError):
        tg.BesagModel(sp.csr_matrix(np.triu(np.ones((3, 3)), 1)))


def test_combined_component_access_and_missing_names():
    m = tg.CombinedModel(tg.RW1Model(5), tg.IIDModel(3), tg.IIDModel(4))
    assert m.component("iid_2").n == 4 and m.iid_2.n == 4 and m.offsets.tolist() == [0, 5, 8, 12]
    with pytest.raises(ValueError, match="tau_iid_2"):
        m.precision(tau_rw1=_t(1.0), tau_iid=_t(2.0))
    with pytest.raises(AttributeError):
        m.nothing
    with pytest.raises(KeyError):
        m.component("besag")
    # the ridge without hyperparameters takes the θ tensors' dtype in the stack
    mf = tg.CombinedModel(tg.IIDModel(2), tg.FixedEffectsModel(2))
    assert mf.precision(tau_iid=torch.tensor(1.0, dtype=torch.float32)).dtype == torch.float32
    assert mf.mean(tau_iid=torch.tensor(1.0, dtype=torch.float32)).shape == (4,)


def test_separable_constraints_are_independent_and_hold():
    m = tg.SeparableModel(tg.RW1Model(4), tg.RW1Model(3))
    A, e = m.constraints()
    assert np.linalg.matrix_rank(A) == A.shape[0] == 6
    with torch.no_grad():
        x = m(tau_rw1=_t(1.0), tau_rw1_2=_t(1.0)).sample(torch.Generator().manual_seed(0), (5,))
    assert np.abs(x.numpy() @ A.T - e).max() <= 1e-8
    jA, je = jg.SeparableModel(jg.RW1Model(4), jg.RW1Model(3)).constraints()
    assert _rel(A, jA) <= 1e-12 and np.array_equal(e, je)


def test_generate_car_model_and_durbin_levinson():
    W = grid_adjacency(3, 3)
    g = tg.generate_car_model(W, _t(0.7), sigma=_t(2.0))
    D = np.diag(np.asarray(W.sum(axis=1)).ravel())
    np.testing.assert_allclose(g.Q.todense().numpy(), (D - 0.7 * W.toarray()) / 2.0, atol=1e-12)
    from tpu_gmrf.models.ar import durbin_levinson as j_dl

    pacf = [0.5, 0.3, -0.4, 0.2]
    phi, hist = durbin_levinson([_t(p) for p in pacf])
    jphi, jhist = j_dl([jnp.asarray(p) for p in pacf])
    assert _rel(phi, jphi) <= 1e-14
    for a, b in zip(hist, jhist):
        assert _rel(a, b) <= 1e-14


def test_arp_precision_is_the_stationary_inverse_covariance():
    # AR(2) with these PACFs: Q⁻¹ must be Toeplitz (stationary) up to rounding
    Q = tg.ARModel(12, order=2).precision(tau=_t(1.0), pacf1=_t(0.6), pacf2=_t(-0.3)).todense().numpy()
    C = np.linalg.inv(Q)
    for k in range(3):
        d = np.diagonal(C, k)
        assert np.abs(d - d[0]).max() <= 1e-10 * abs(C[0, 0])


@pytest.mark.parametrize("batch", [(None, None), (3, None), (None, 3), (3, 3)])
def test_block_diag_and_kron_match_reference(batch):
    rng = np.random.default_rng(11)
    a = sp.random(5, 4, density=0.5, random_state=np.random.RandomState(1)).tocoo()
    b = sp.random(3, 6, density=0.5, random_state=np.random.RandomState(2)).tocoo()
    pats = [JPattern(a.row, a.col, a.shape), JPattern(b.row, b.col, b.shape)]
    datas = [rng.normal(size=(B or 1, p.nnz)) for B, p in zip(batch, pats)]
    tms = [tg.SparseMatrix(_t(d if B else d[0]), tg.SparsePattern(p.rows, p.cols, p.shape))
           for B, d, p in zip(batch, datas, pats)]
    B = max(x or 1 for x in batch)
    for fn, jfn in ((lambda u, v: tg.sp_block_diag([u, v]), lambda u, v: j_block_diag([u, v])),
                    (tg.sp_kron, j_kron)):
        got = fn(*tms)
        for c in range(B):
            jms = [JSM(jnp.asarray(d[min(c, d.shape[0] - 1)]), p) for d, p in zip(datas, pats)]
            ref = jfn(*jms)
            np.testing.assert_array_equal(got.pattern.rows, ref.pattern.rows)
            np.testing.assert_array_equal(got.pattern.cols, ref.pattern.cols)
            row = got.data if got.data.ndim == 1 else got.data[c]
            assert _rel(row, ref.data) <= 1e-14
        assert got.data.shape[:-1] == (() if batch == (None, None) else (B,))


def test_stack_constraints_and_metagmrf():
    a = (np.ones((1, 4)), np.zeros(1))
    b = (np.eye(4)[:2], np.array([1.0, 2.0]))
    A, e = stack_constraints(None, a, b)
    jA, je = j_stack(None, a, b)
    assert np.array_equal(A, jA) and np.array_equal(e, je)
    assert stack_constraints(None, None) is None

    class Tag(tg.GMRFMetadata):
        pass

    g = tg.AR1Model(6)(tau=_t(1.0), rho=_t(0.3))
    meta = tg.MetaGMRF(g, Tag())
    x = _t(np.linspace(-1, 1, 6))
    assert len(meta) == 6 and meta.n == 6 and isinstance(meta.metadata, Tag)
    assert float(meta.logpdf(x)) == float(g.logpdf(x))
    assert torch.equal(meta.var(), g.var()) and "MetaGMRF" in repr(meta)
