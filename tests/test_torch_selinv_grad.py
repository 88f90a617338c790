"""The selected inverse's derivative and the sparse Functions' second
derivatives in the port, against the JAX package in float64 on the same
NumPy inputs (the plain versions of the kernels, CPU tensors).

* The double backward of the sparse Functions (ROADMAP fault 3.4): the
  Hessian of ``SparseMatrix.quad`` is 2Q and that of ``GMRF.logpdf`` is −Q,
  equal to ``jax.hessian`` of the reference's (1e-12); mixed data/x second
  derivatives through ``matvec``, ``sp_add`` and ``sp_matmul`` (the AR(2)
  precision) equal the reference's (1e-10).
* Σ's derivative on each direct backend: the gradient of Σ_p w_p Σ_p on Q's
  pattern, of Σ_i w_i var_i and of ``selinv_dot`` with respect to Q's data,
  against ``jax.grad`` of the same function of the reference (1e-10); each
  tangent kernel's plain version (K19-K22) against −P(Σ·T·Σ) from a dense
  inverse (1e-12); ``ConstrainedGMRF.var``'s gradient (RW1, n = 20; 1e-7,
  the problem's rounding, see the test).
* Second derivatives of the logdet on each backend: a Hessian-vector product
  against ``jax.jvp`` of ``jax.grad`` of the reference (1e-10), and forward
  mode (``torch.autograd.forward_ad``) against ``jax.jvp`` (1e-10).

Every reference value is computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import tpu_gmrf as jg
from tpu_gmrf.sparse import matrix as jm
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels
from tpu_gmrf_torch.sparse import matrix as tm
from tpu_gmrf_torch.sparse.pattern import SparsePattern
from tests.conftest import random_sparse_spd

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
KINDS = ["tridiag", "dense", "banded", "supernodal"]
BLOCK = {"banded": 2}  # several blocks at these sizes
TOL = 1e-10
RW1_TOL = 1e-7


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _spec(M, kind):
    return M.SolverSpec(kind=kind, block=BLOCK.get(kind))


# ---- fault 3.4: the sparse Functions' double backward -----------------------------------


def test_quad_and_logpdf_hessians_match_jax_hessian():
    x = np.random.default_rng(0).normal(size=6)
    jq = jg.AR1Model(6)(tau=1.3, rho=0.4)
    tq = tg.AR1Model(6)(tau=_t(1.3), rho=_t(0.4))
    want_q = np.asarray(jax.hessian(lambda v: jq.Q.quad(v))(jnp.asarray(x)))
    want_lp = np.asarray(jax.hessian(jq.logpdf)(jnp.asarray(x)))
    got_q = torch.autograd.functional.hessian(tq.Q.quad, _t(x))
    got_lp = torch.autograd.functional.hessian(tq.logpdf, _t(x))
    Q = tq.Q.todense().numpy()
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_q.numpy(), 2 * Q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got_lp.numpy(), -Q, rtol=0, atol=1e-12)


def _rect():
    """A random 5 x 7 pattern, and the generator that drew it."""
    rng = np.random.default_rng(1)
    mask = rng.random((5, 7)) < 0.4
    r, c = np.nonzero(mask)
    return JP(r, c, (5, 7)), rng


def _mixed(fn_t, fn_j, params):
    """The full Hessian of a scalar function of several flat parameters, port and reference."""
    sizes = [p.size for p in params]
    flat = np.concatenate([p.ravel() for p in params])

    def split(v, M):
        out, k = [], 0
        for s in sizes:
            out.append(v[k:k + s])
            k += s
        return out

    got = torch.autograd.functional.hessian(lambda v: fn_t(*split(v, torch)), _t(flat))
    want = jax.jit(jax.hessian(lambda v: fn_j(*split(v, jnp))))(jnp.asarray(flat))
    return got.numpy(), np.asarray(want)


def test_matvec_mixed_second_derivatives_match_jax_hessian():
    jp, rng = _rect()
    tp = SparsePattern(jp.rows, jp.cols, jp.shape)
    d, x = rng.normal(size=jp.nnz), rng.normal(size=7)
    got, want = _mixed(lambda d_, x_: (tm.SparseMatrix(d_, tp).matvec(x_) ** 3).sum(),
                       lambda d_, x_: jnp.sum(jm.SparseMatrix(d_, jp).matvec(x_) ** 3), [d, x])
    assert _rel(got, want) <= TOL


def test_sp_add_mixed_second_derivatives_match_jax_hessian():
    rng = np.random.default_rng(2)
    n = 7
    a, c, h, x = rng.normal(size=n) + 3, rng.normal(size=n - 1), rng.normal(size=n), rng.normal(size=n)

    def port(a_, c_, h_, x_):
        Q = tm.sp_add(tm.sp_tridiag(a_, c_), tm.spdiag(h_ ** 2))
        return Q.quad(x_) * Q.matvec(x_).sum()

    def ref(a_, c_, h_, x_):
        Q = jm.sp_add(jm.sp_tridiag(a_, c_), jm.spdiag(h_ ** 2))
        return Q.quad(x_) * Q.matvec(x_).sum()

    # the union pattern differs from both operands', so sp_add's K5 Function carries the sum
    assert tm.sp_add(tm.sp_tridiag(_t(a), _t(c)), tm.spdiag(_t(h))).pattern.nnz == 3 * n - 2
    got, want = _mixed(port, ref, [a, c, h, x])
    assert _rel(got, want) <= TOL


def test_ar2_logpdf_hessian_through_sp_matmul_matches_jax_hessian():
    """The AR(2) precision is Lᵀ(D L)·τ by two SpGEMMs (K5): the Hessian of
    its logpdf in (τ, pacf1, pacf2, x) mixes the SpGEMM's data with x."""
    n = 9
    x = np.random.default_rng(3).normal(size=n)

    def port(th, x_):
        g = tg.ARModel(n, order=2)(tau=th[0], pacf1=th[1], pacf2=th[2])
        return g.logpdf(x_)

    def ref(th, x_):
        g = jg.ARModel(n, order=2)(tau=th[0], pacf1=th[1], pacf2=th[2])
        return g.logpdf(x_)

    got, want = _mixed(port, ref, [np.array([1.4, 0.5, -0.3]), x])
    assert _rel(got, want) <= TOL


# ---- Σ's derivative on the four direct backends -----------------------------------------


def _case(kind):
    """(pattern, data): a tridiagonal Q whose two stored triangles differ for
    the tridiagonal backend, a random sparse SPD Q (n = 14) for the others."""
    if kind == "tridiag":
        n = 8
        rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
        cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
        pat = JP(rows, cols, (n, n))
        rng = np.random.default_rng(30)
        vals = np.where(pat.rows == pat.cols, 3.0, -1.0) + np.where(pat.rows == pat.cols, 0.0,
                                                                    0.3 * rng.normal(size=pat.nnz))
        return pat, vals
    A = random_sparse_spd(np.random.default_rng(31), 14, density=0.2).tocoo()
    pat = JP(A.row, A.col, A.shape)
    return pat, np.asarray(A.data)[pat.sort_order]


def _stats(M, kind, pat, d, w_pat, w_diag, other):
    SM = (jm if M is jg else tm).SparseMatrix
    f = M.factorize(SM(d, pat), _spec(M, kind))
    return ((w_pat * f.selinv(pat).data).sum() + (w_diag * f.selinv_diag()).sum()
            + f.selinv_dot(SM(d * other, pat)).sum())


@functools.lru_cache(maxsize=None)
def _sigma_reference(kind):
    pat, d = _case(kind)
    rng = np.random.default_rng(32)
    w_pat, w_diag, other = rng.normal(size=pat.nnz), rng.normal(size=pat.shape[0]), rng.normal(size=pat.nnz)
    v = rng.normal(size=pat.nnz)
    args = tuple(jnp.asarray(a) for a in (w_pat, w_diag, other))

    def stat(dd):
        return _stats(jg, kind, pat, dd, *args)

    def logdet(dd):
        return jg.factorize(jm.SparseMatrix(dd, pat), _spec(jg, kind)).logdet()

    grad = jax.jit(jax.grad(stat))(jnp.asarray(d))
    hvp = jax.jit(lambda dd, vv: jax.jvp(jax.grad(logdet), (dd,), (vv,)))(jnp.asarray(d), jnp.asarray(v))
    jvp = jax.jit(lambda dd, vv: jax.jvp(stat, (dd,), (vv,)))(jnp.asarray(d), jnp.asarray(v))
    return dict(pat=pat, d=d, w=(w_pat, w_diag, other), v=v, grad=np.asarray(grad), hvp=np.asarray(hvp[1]),
                jvp=float(jvp[1]))


def _port_stat(kind, ref):
    pat = SparsePattern(ref["pat"].rows, ref["pat"].cols, ref["pat"].shape)
    w = tuple(_t(a) for a in ref["w"])
    return pat, lambda d: _stats(tg, kind, pat, d, *w)


@pytest.mark.parametrize("kind", KINDS)
def test_selected_inverse_gradient_matches_jax_grad(kind):
    ref = _sigma_reference(kind)
    _, stat = _port_stat(kind, ref)
    d = _t(ref["d"], requires_grad=True)
    (g,) = torch.autograd.grad(stat(d), d)
    assert _rel(g.numpy(), ref["grad"]) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_selected_inverse_forward_mode_matches_jax_jvp(kind):
    ref = _sigma_reference(kind)
    _, stat = _port_stat(kind, ref)
    with fwAD.dual_level():
        out = stat(fwAD.make_dual(_t(ref["d"]), _t(ref["v"])))
        got = float(fwAD.unpack_dual(out).tangent)
    assert abs(got - ref["jvp"]) <= TOL * abs(ref["jvp"])


@pytest.mark.parametrize("kind", KINDS)
def test_logdet_second_derivative_matches_jax_jvp_of_grad(kind):
    ref = _sigma_reference(kind)
    pat = SparsePattern(ref["pat"].rows, ref["pat"].cols, ref["pat"].shape)
    d = _t(ref["d"], requires_grad=True)
    (g,) = torch.autograd.grad(tg.factorize(tm.SparseMatrix(d, pat), _spec(tg, kind)).logdet(), d,
                               create_graph=True)
    (hv,) = torch.autograd.grad((g * _t(ref["v"])).sum(), d)
    assert _rel(hv.numpy(), ref["hvp"]) <= TOL


def _dense_tangent(A, T):
    """−Σ·sym(T)·Σ for a dense symmetric A and T, in float64 NumPy."""
    Sig = np.linalg.inv(0.5 * (A + A.T))
    return -Sig @ (0.5 * (T + T.T)) @ Sig


def test_tridiag_tangent_plain_matches_dense_inverse():
    """K19's plain version: Σ̇ on the tridiagonal in a direction (ȧ, ċ)."""
    rng = np.random.default_rng(40)
    B, n = 3, 12
    c = rng.normal(size=(B, n - 1))
    a = np.abs(rng.normal(size=(B, n))) + 0.5 + np.pad(np.abs(c), ((0, 0), (0, 1))) + np.pad(np.abs(c), ((0, 0), (1, 0)))
    da, dc = rng.normal(size=(B, n)), rng.normal(size=(B, n - 1))
    d, e, _ = kernels.tridiag_factor(_t(a), _t(c))
    z, _ = kernels.tridiag_selinv(d, e)
    dz, dzo = kernels.tridiag_selinv_tangent(d, e, z, _t(da), _t(dc))
    for b in range(B):
        A = np.diag(a[b]) + np.diag(c[b], -1) + np.diag(c[b], 1)
        want = _dense_tangent(A, np.diag(da[b]) + np.diag(dc[b], -1) + np.diag(dc[b], 1))
        assert _rel(dz[b].numpy(), np.diag(want)) <= 1e-12
        assert _rel(dzo[b].numpy(), np.diag(want, -1)) <= 1e-12


@pytest.mark.parametrize("kind", ["supernodal", "banded"])
def test_tangent_kernels_plain_match_dense_inverse(kind):
    """K20 and K21 (supernodal), K22 and K21 (banded), through the backends'
    tangent pass on two chains: −P(Σ·sym(T)·Σ) at Q's pattern and at the
    diagonal, for T on Q's pattern and on the diagonal."""
    pat_j, d = _case(kind)
    pat = SparsePattern(pat_j.rows, pat_j.cols, pat_j.shape)
    rng = np.random.default_rng(41)
    data = np.stack([d, d * 1.4])
    f = tg.factorize(tm.SparseMatrix(_t(data), pat), _spec(tg, kind))
    n = pat.shape[0]
    t_pat, t_diag = rng.normal(size=(2, pat.nnz)), rng.normal(size=(2, n))
    got_pp = f._sigma_tangent(_t(t_pat), pat, pat).numpy()
    got_dd = f._sigma_tangent(_t(t_diag), n, n).numpy()
    for b in range(2):
        A = np.zeros((n, n))
        np.add.at(A, (pat.rows, pat.cols), data[b])
        T = np.zeros((n, n))
        np.add.at(T, (pat.rows, pat.cols), t_pat[b])
        assert _rel(got_pp[b], _dense_tangent(A, T)[pat.rows, pat.cols]) <= 1e-12
        assert _rel(got_dd[b], np.diag(_dense_tangent(A, np.diag(t_diag[b])))) <= 1e-12


def test_constrained_var_gradient_matches_jax_grad():
    """RW1's ridge (1e-5) gives Q a condition near 1e6, and the constrained
    variance subtracts terms of ~3e3 to leave ~1: its τ-gradient carries
    that rounding, whoever computes it (the port's tridiagonal and
    supernodal backends differ by 1.8e-8 here, the base variance's gradient
    by 3e-7 from the reference's), so it is held to RW1_TOL."""
    n = 20
    w = np.random.default_rng(42).normal(size=n)

    def ref(tau):
        return jnp.sum(jnp.asarray(w) * jg.RW1Model(n)(tau=tau).var())

    want = float(jax.jit(jax.grad(ref))(1.7))
    tau = _t(1.7, requires_grad=True)
    prior = tg.RW1Model(n)(tau=tau)
    assert isinstance(prior, tg.ConstrainedGMRF)
    (got,) = torch.autograd.grad((_t(w) * prior.var()).sum(), tau)
    assert abs(float(got) - want) <= RW1_TOL * abs(want)


def test_second_derivative_of_the_selected_inverse_raises():
    """Σ's derivative comes from the tangent kernels and is not
    differentiable again: a graph through it (create_graph=True) raises,
    which is the logdet's third derivative; the first derivative stays."""
    ref = _sigma_reference("dense")
    _, stat = _port_stat("dense", ref)
    d = _t(ref["d"], requires_grad=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(stat(d), d, create_graph=True)
    (g,) = torch.autograd.grad(stat(d), d)
    assert _rel(g.numpy(), ref["grad"]) <= TOL
