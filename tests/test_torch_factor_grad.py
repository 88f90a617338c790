"""The factor's own derivative: gradients through `forward_solve`,
`backward_solve` and `sqrt_matvec` (`FactorTriangular`, whose data cotangent
is the factorization's reverse sweep) on the four direct backends, against
the JAX package in float64 on the same NumPy inputs.

For each backend and statistic, on a Q whose diagonal is not constant (so
the Jacobi scaling of the dense and supernodal backends is exercised) and k
right-hand sides, with f = Σ w·op(z):

* ∂f/∂data and ∂f/∂z against ``jax.grad`` of the reference's factor method
  (1e-10 relative, normwise);
* the forward derivative along (v, u) against ``jax.jvp``;
* the mixed second derivatives, ∂/∂z of ⟨∂f/∂data, v⟩ and ∂/∂data of
  ⟨∂f/∂z, u⟩, against ``jax.grad`` of ``jax.jvp`` along v and, f being
  linear in z, ``jax.grad`` of f at z = u;
* the data/data second derivative (the factor's second derivative) raises.
* forward mode over the data gradient raises.

Every reference value of a backend comes from one ``jax.jit`` call, made once
per module. And: the gradients of `GMRF.sample` and `ConstrainedGMRF.sample`
in a parameter of Q against a central difference of the port's own float64
sample at a fixed generator.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern
from tests.conftest import random_sparse_spd

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
KINDS = ["tridiag", "dense", "banded", "supernodal"]
OPS = ["forward_solve", "backward_solve", "sqrt_matvec"]
TOL = 1e-10
K = 3  # right-hand sides
# blocks of 2 give the banded plan several blocks at these sizes (the reference's banded scan needs K >= 2)
BLOCK = {"banded": 2}


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(pattern, data): a tridiagonal Q whose stored triangles differ for the
    tridiagonal backend, else a random sparse SPD Q; both with a diagonal
    that varies along it."""
    rng = np.random.default_rng(41)
    if kind == "tridiag":
        n = 9
        rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
        cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
        pat = JP(rows, cols, (n, n))
        d = np.where(pat.rows == pat.cols, 2.5 + 2.0 * rng.uniform(size=pat.nnz), -1.0 + 0.3 * rng.normal(size=pat.nnz))
        return pat, d
    A = random_sparse_spd(rng, 14, density=0.2).tocoo()
    pat = JP(A.row, A.col, A.shape)
    d = np.asarray(A.data)[pat.sort_order]
    return pat, d + np.where(pat.rows == pat.cols, np.linspace(0.5, 4.0, 14)[pat.rows], 0.0)


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    pat, d = _case(kind)
    n = pat.shape[0]
    rng = np.random.default_rng(42)
    return dict(pat=pat, d=d, z=rng.normal(size=(n, K)), w=rng.normal(size=(n, K)), v=rng.normal(size=d.shape),
                u=rng.normal(size=(n, K)))


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """Every JAX value of one backend, from one jitted call: per statistic the
    gradients, the jvp and the two mixed second derivatives."""
    inp = _inputs(kind)
    pat = inp["pat"]
    spec = jg.SolverSpec(kind=kind, block=BLOCK.get(kind))

    def value(op, dd, zz, w):
        fac = jg.factorize(JSM(dd, pat), spec)
        return jnp.sum(w * jax.vmap(getattr(fac, op), in_axes=1, out_axes=1)(zz))

    def everything(dd, zz, w, vv, uu):
        out = {}
        for op in OPS:
            f = functools.partial(value, op, w=w)
            grad = jax.grad(f, argnums=(0, 1))
            gd, gz = grad(dd, zz)
            _, tangent = jax.jvp(f, (dd, zz), (vv, uu))
            # f is linear in z: ∂/∂data ⟨∂f/∂z, u⟩ is ∂f/∂data at z = u; ∂/∂z ⟨∂f/∂data, v⟩ by reverse over
            # forward mode (both a third of jax.jvp(jax.grad)'s compile through the tridiagonal prefix scans)
            hd = jax.grad(f, argnums=0)(dd, uu)
            hz = jax.grad(lambda z_: jax.jvp(lambda d_: f(d_, z_), (dd,), (vv,))[1])(zz)
            out[op] = dict(gd=gd, gz=gz, jvp=tangent, hz=hz, hd=hd)
        return out

    got = jax.jit(everything)(*(jnp.asarray(inp[k]) for k in ("d", "z", "w", "v", "u")))
    return {op: {k: np.asarray(a) for k, a in vals.items()} for op, vals in got.items()}


def _port(kind, d):
    pat = _inputs(kind)["pat"]
    spec = tg.SolverSpec(kind=kind, block=BLOCK.get(kind))
    return tg.factorize(SparseMatrix(d, SparsePattern(pat.rows, pat.cols, pat.shape)), spec)


CASES = [(k, op) for k in KINDS for op in OPS]


@pytest.mark.parametrize("kind,op", CASES)
def test_factor_statistic_gradients_match_jax_grad(kind, op):
    inp, ref = _inputs(kind), _reference(kind)[op]
    d, z = _t(inp["d"], requires_grad=True), _t(inp["z"], requires_grad=True)
    f = (getattr(_port(kind, d), op)(z) * _t(inp["w"])).sum()
    gd, gz = torch.autograd.grad(f, (d, z))
    assert _rel(gd.numpy(), ref["gd"]) <= TOL
    assert _rel(gz.numpy(), ref["gz"]) <= TOL


@pytest.mark.parametrize("kind,op", CASES)
def test_factor_statistic_jvp_matches_jax_jvp(kind, op):
    inp, ref = _inputs(kind), _reference(kind)[op]
    with fwAD.dual_level():
        d = fwAD.make_dual(_t(inp["d"]), _t(inp["v"]))
        z = fwAD.make_dual(_t(inp["z"]), _t(inp["u"]))
        f = (getattr(_port(kind, d), op)(z) * _t(inp["w"])).sum()
        tangent = fwAD.unpack_dual(f).tangent
    assert _rel(float(tangent), float(ref["jvp"])) <= TOL


@pytest.mark.parametrize("kind,op", CASES)
def test_factor_statistic_mixed_second_derivatives_match_jax(kind, op):
    """∂/∂z ⟨∂f/∂data, v⟩ and ∂/∂data ⟨∂f/∂z, u⟩: the parts of the Hessian that
    the factor's first derivative carries (f is linear in z)."""
    inp, ref = _inputs(kind), _reference(kind)[op]
    d, z = _t(inp["d"], requires_grad=True), _t(inp["z"], requires_grad=True)
    f = (getattr(_port(kind, d), op)(z) * _t(inp["w"])).sum()
    gd, gz = torch.autograd.grad(f, (d, z), create_graph=True)
    (hz,) = torch.autograd.grad((gd * _t(inp["v"])).sum(), z, retain_graph=True)
    (hd,) = torch.autograd.grad((gz * _t(inp["u"])).sum(), d)
    assert _rel(hz.numpy(), ref["hz"]) <= TOL
    assert _rel(hd.numpy(), ref["hd"]) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_factor_second_derivative_in_the_data_raises(kind):
    inp = _inputs(kind)
    d, z = _t(inp["d"], requires_grad=True), _t(inp["z"])
    f = (_port(kind, d).backward_solve(z) * _t(inp["w"])).sum()
    (gd,) = torch.autograd.grad(f, d, create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad((gd * _t(inp["v"])).sum(), d)


def _sample_objective(kind, theta, constrained: bool):
    """Σ w·x for x one draw (seed 7, 2 samples) of the GMRF with precision
    Q(θ) = Q₀ + θ·diag(0.5 … 2), μ = 0, or its sum-to-zero ConstrainedGMRF."""
    pat, d = _case(kind)
    n = pat.shape[0]
    diag = torch.as_tensor(np.where(pat.rows == pat.cols, np.linspace(0.5, 2.0, n)[pat.rows], 0.0))
    Q = SparseMatrix(_t(d) + theta * diag, SparsePattern(pat.rows, pat.cols, pat.shape))
    g = tg.GMRF.from_precision(torch.zeros(n, dtype=F64), Q, tg.SolverSpec(kind=kind, block=BLOCK.get(kind)))
    if constrained:
        g = tg.ConstrainedGMRF.create(g, np.ones((1, n)), np.zeros(1))
    x = g.sample(torch.Generator().manual_seed(7), (2,))
    w = torch.as_tensor(np.random.default_rng(43).normal(size=(2, n)))
    return (w * x).sum()


@pytest.mark.parametrize("constrained", [False, True], ids=["gmrf", "constrained"])
@pytest.mark.parametrize("kind", KINDS)
def test_sample_gradient_matches_a_central_difference(kind, constrained):
    theta0, h = 0.7, 1e-5
    theta = _t(theta0, requires_grad=True)
    (g,) = torch.autograd.grad(_sample_objective(kind, theta, constrained), theta)
    with torch.no_grad():
        cd = (_sample_objective(kind, _t(theta0 + h), constrained)
              - _sample_objective(kind, _t(theta0 - h), constrained)) / (2 * h)
    assert abs(float(g) - float(cd)) <= 1e-7 * max(abs(float(cd)), 1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_mode_over_the_data_gradient_raises(kind):
    """Forward mode over a reverse gradient in the data would need the factor's
    second derivative: it raises (no jvp of the reverse sweep) instead of
    dropping the data/data part."""
    inp = _inputs(kind)
    with fwAD.dual_level():
        d = fwAD.make_dual(_t(inp["d"]), _t(inp["v"])).requires_grad_()
        f = (_port(kind, d).sqrt_matvec(_t(inp["z"])) * _t(inp["w"])).sum()
        with pytest.raises(NotImplementedError, match="jvp"):
            torch.autograd.grad(f, d)
