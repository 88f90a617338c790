"""The port's dense (K9, K10) and banded (K11, K12) backends, their plain
versions as CPU tensors take them, against the JAX package in float64 on
the same NumPy inputs; the auto solver resolution; and the Laplace marginal
on the auto→dense and banded inner solvers.

Tolerances: factors, solves, logdets and selected inverses 1e-10 relative
(both sides run LAPACK-class Cholesky and triangular solves, in other
orders); the logdet gradients 1e-8; the Laplace value 1e-8 and θ-gradient 1e-6 (as the
other slice tests).
"""

import functools

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf.solvers import banded as jb
from tpu_gmrf.solvers import dense as jd
from tpu_gmrf.solvers.base import SolverSpec as JaxSolverSpec
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
from tpu_gmrf_torch import set_default_device
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop, kernels
from tpu_gmrf_torch.solvers import banded as tb
from tpu_gmrf_torch.solvers import dense as td
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64
B = 3


def _t(a, dtype=F64, **kw):
    return torch.tensor(np.asarray(a), dtype=dtype, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _canonical(A):
    """(rows, cols, values) of a scipy matrix in the patterns' canonical order."""
    A = A.tocoo()
    order = np.lexsort((A.col, A.row))
    return A.row[order], A.col[order], A.data[order]


def _random_spd(n, seed, density=0.06):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(seed))
    A = A + A.T
    return (A + sp.eye(n) * (abs(A).sum(1).max() + 1.0)).tocsr()


@pytest.fixture(scope="module")
def matern10():
    """The g=10 Matérn α=2 prior (τ=1, range 0.3) plus three positive diagonals."""
    jm = jg.MaternModel(_grid(10), smoothness=1)
    Q = jm.precision(tau=1.0, range=0.3)
    rng = np.random.default_rng(0)
    d = np.exp(rng.normal(size=(B, jm.n)))
    rows, cols = np.asarray(Q.pattern.rows), np.asarray(Q.pattern.cols)
    data = np.asarray(Q.data)[None] + np.where(rows == cols, 1.0, 0.0)[None] * d[:, rows]
    return rows, cols, (jm.n, jm.n), data


def _cases(matern10):
    rows, cols, shape, data = matern10
    A = _random_spd(60, 3)
    r2, c2, v2 = _canonical(A)
    scale = 1.0 + 0.2 * np.arange(B)[:, None]
    return {"matern": (rows, cols, shape, data), "random": (r2, c2, (60, 60), v2[None] * scale)}


# ---- the banded host plan -----------------------------------------------------------


@pytest.mark.parametrize("case", ["matern", "random"])
@pytest.mark.parametrize("block", [None, 16])
def test_banded_plan_matches_reference(matern10, case, block):
    rows, cols, shape, _ = _cases(matern10)[case]
    ref = jb.banded_plan(JP(rows, cols, shape), block)
    got = tb.banded_plan(SparsePattern(rows, cols, shape), block)
    assert set(got) == set(ref)
    for k in ref:
        for a, b in zip(np.atleast_1d(got[k]) if k not in ("d_idx", "e_idx") else got[k],
                        np.atleast_1d(ref[k]) if k not in ("d_idx", "e_idx") else ref[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- factor, solves, logdet -----------------------------------------------------------


def _jax_stats(factorize, rows, cols, shape, data, b):
    jp = JP(rows, cols, shape)

    def one(d, rhs):
        f = factorize(JSM(d, jp))
        return f.logdet(), f.solve(rhs), f.forward_solve(rhs), f.backward_solve(rhs)

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(data), jnp.asarray(b))]


@pytest.mark.parametrize("case", ["matern", "random"])
@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_factor_solves_logdet_match_reference(matern10, case, kind):
    rows, cols, shape, data = _cases(matern10)[case]
    n = shape[0]
    b = np.random.default_rng(1).normal(size=(B, n))
    jfact = jd.dense_factorize if kind == "dense" else jb.banded_factorize
    ld, x, fw, bw = _jax_stats(jfact, rows, cols, shape, data, b)
    Q = SparseMatrix(_t(data), SparsePattern(rows, cols, shape))
    f = tg.factorize(Q, tg.SolverSpec(kind=kind))
    assert f.logdet().shape == (B,)
    assert _rel(f.logdet().numpy(), ld) <= 1e-10
    assert _rel(f.solve(_t(b)).numpy(), x) <= 1e-10
    assert _rel(f.forward_solve(_t(b)).numpy(), fw) <= 1e-10
    assert _rel(f.backward_solve(_t(b)).numpy(), bw) <= 1e-10
    # k right-hand sides per chain and one unbatched matrix
    bk = _t(np.random.default_rng(2).normal(size=(B, n, 2)))
    np.testing.assert_allclose(f.solve(bk)[..., 1].numpy(), f.solve(bk[..., 1].contiguous()).numpy(), rtol=1e-12)
    f0 = tg.factorize(SparseMatrix(_t(data[0]), Q.pattern), tg.SolverSpec(kind=kind))
    assert _rel(f0.solve(_t(b[0])).numpy(), x[0]) <= 1e-10


# K12 at the edges of its tiles: (case, block) giving one block (K = 1: 256 rows for the n=198 Matérn,
# 65 for the n=60 random matrix) and several (K > 1: s the bandwidth itself, and s rounded up to 16)
EDGES = [("matern", 256), ("matern", 1), ("random", 65), ("random", 16)]


@pytest.fixture(scope="module")
def edge_reference(matern10):
    """The reference's banded solve, forward and backward solves at EDGES
    with k = 1 and k = 3 right-hand sides per chain, jitted once per shape."""
    out = {}
    for case, block in EDGES:
        rows, cols, shape, data = _cases(matern10)[case]
        jp = JP(rows, cols, shape)
        for k in (1, 3):
            b = np.random.default_rng(5).normal(size=(B, shape[0], k))

            def one(d, rhs):
                f = jb.banded_factorize(JSM(d, jp), block)
                if f.Lk.shape[0] > 1:
                    return f.solve(rhs), f.forward_solve(rhs), f.backward_solve(rhs)
                # one block: the reference's scans take no plan of one block (ROADMAP §3), so its own
                # factor, blocks and permutation with one triangular solve each way
                bb, L = f._to_blocks(rhs)[0], f.Lk[0]
                fw = jsl.solve_triangular(L, bb, lower=True)
                return tuple(f._from_blocks(x[None], 2) for x in (
                    jsl.solve_triangular(L, fw, lower=True, trans=1), fw,
                    jsl.solve_triangular(L, bb, lower=True, trans=1)))

            out[case, block, k] = b, [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(data), jnp.asarray(b))]
    return out


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case,block", EDGES)
def test_banded_solves_match_reference_at_tile_edges(matern10, edge_reference, case, block, k):
    rows, cols, shape, data = _cases(matern10)[case]
    b, (x, fw, bw) = edge_reference[case, block, k]
    Q = SparseMatrix(_t(data), SparsePattern(rows, cols, shape))
    f = tg.factorize(Q, tg.SolverSpec(kind="banded", block=block))
    assert (f.plan["K"] == 1) == (block in (256, 65))
    assert _rel(f.solve(_t(b)).numpy(), x) <= 1e-10
    assert _rel(f.forward_solve(_t(b)).numpy(), fw) <= 1e-10
    assert _rel(f.backward_solve(_t(b)).numpy(), bw) <= 1e-10


@pytest.mark.parametrize("k", [1, 3])
def test_rows_to_blocks_match_reference_layout(matern10, k):
    """K12's gather into blocks (B, K, s, k) is the reference's `_to_blocks`
    per chain, and its scatter the reference's `_from_blocks`."""
    rows, cols, shape, _ = _cases(matern10)["matern"]
    n = shape[0]
    jp = JP(rows, cols, shape)
    plan = jb.banded_plan(jp, 8)  # the reference's factor finds its plan under (pattern, block)
    b = np.random.default_rng(6).normal(size=(B, n, k))
    perm = torch.as_tensor(np.asarray(plan["perm"], np.int64))
    got = kernels.banded._rows_to_blocks(_t(b).transpose(1, 2).reshape(B * k, n), perm, B, plan["K"], plan["s"], k)
    jf = jb.BandedFactor(None, None, (jp, 8))
    ref = np.stack([np.asarray(jf._to_blocks(jnp.asarray(b[i]))) for i in range(B)])
    np.testing.assert_array_equal(got.numpy(), ref)
    back = kernels.banded._blocks_to_rows(got, perm, n).reshape(B, k, n).transpose(1, 2)
    np.testing.assert_array_equal(back.numpy(), np.stack([np.asarray(jf._from_blocks(jnp.asarray(ref[i]), 2))
                                                          for i in range(B)]))


@pytest.mark.parametrize("B_,K,s,k,want", [
    (4, 12, 512, 1, 4 * 12 * 512 + 4 * 512),
    (1, 1, 65, 3, 195 + 195),
    (2, 3, 64, 9, 2 * 3 * 64 * 9 + 2 * 64 * 9)])
def test_trsv_workspace_counts_the_blocks(B_, K, s, k, want):
    """K12's workspace: the permuted right-hand sides and one block row of
    scratch (it solves by substitution and keeps no inverses); the block
    entry takes no permuted copy."""
    assert kernels.banded.trsv_workspace(B_, K, s, k) == want
    assert kernels.banded.trsv_workspace(B_, K, s, k, permuted=False) == want - B_ * K * s * k


def test_banded_solves_take_no_right_hand_sides(matern10):
    """B·k = 0: the solves and the square-root product return empty results of the right shape."""
    rows, cols, shape, data = _cases(matern10)["matern"]
    f = tg.factorize(SparseMatrix(_t(data), SparsePattern(rows, cols, shape)), tg.SolverSpec(kind="banded"))
    z = _t(np.zeros((B, shape[0], 0)))
    for op in (f.solve, f.forward_solve, f.backward_solve, f.sqrt_matvec):
        assert op(z).shape == (B, shape[0], 0)


@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_selinv_and_logdet_gradient_match_reference(matern10, kind):
    rows, cols, shape, data = matern10
    jp = JP(rows, cols, shape)
    # blocks a multiple of 8 wide: the banded plan has several blocks (K=3
    # here), so the Takahashi sweep carries Σ_{k+1,k+1} through two steps
    jfact = jd.dense_factorize if kind == "dense" else functools.partial(jb.banded_factorize, block=8)
    spec = tg.SolverSpec(kind=kind, block=None if kind == "dense" else 8)

    def one(d):
        f = jfact(JSM(d, jp))
        return f.selinv_diag(), f.selinv(jp).data

    diag, sel = jax.jit(jax.vmap(one))(jnp.asarray(data))
    grad = jax.jit(jax.vmap(jax.grad(lambda d: jfact(JSM(d, jp)).logdet())))(jnp.asarray(data))
    tp = SparsePattern(rows, cols, shape)
    td_ = _t(data, requires_grad=True)
    f = tg.factorize(SparseMatrix(td_, tp), spec)
    # Σ and the triangular solves have no backward: they take a detached Q
    fd = tg.factorize(SparseMatrix(td_.detach(), tp), spec)
    if kind == "banded":
        assert f.plan["K"] == 3
    assert _rel(fd.selinv_diag().numpy(), diag) <= 1e-10
    assert _rel(fd.selinv(tp).data.numpy(), sel) <= 1e-10
    other = SparseMatrix(_t(data[::-1].copy()), tp)
    np.testing.assert_allclose(fd.selinv_dot(other).numpy(), (np.asarray(sel) * data[::-1]).sum(-1),
                               rtol=1e-10)
    f.logdet().sum().backward()
    assert _rel(td_.grad.numpy(), grad) <= 1e-8
    z = _t(np.random.default_rng(3).normal(size=(B, shape[0])))
    # L z undoes L⁻¹ z
    torch.testing.assert_close(fd.sqrt_matvec(fd.forward_solve(z)), z, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["matern", "random"])
def test_dense_selinv_matches_reference_inverse(matern10, case):
    """K10's second entry `dense_selinv` (its plain version on CPU tensors) at
    arbitrary entries, the diagonal and both triangles, against the
    reference's whole Q⁻¹."""
    rows, cols, shape, data = _cases(matern10)[case]
    n = shape[0]
    jp = JP(rows, cols, shape)
    inv = np.asarray(jax.jit(jax.vmap(lambda d: jd.dense_factorize(JSM(d, jp))._inv()))(jnp.asarray(data)))
    rng = np.random.default_rng(4)
    r = np.concatenate([np.arange(n), rng.integers(0, n, 200)])
    c = np.concatenate([np.arange(n), rng.integers(0, n, 200)])
    f = tg.factorize(SparseMatrix(_t(data), SparsePattern(rows, cols, shape)), tg.SolverSpec(kind="dense"))
    got = kernels.dense_selinv(f.L, f.s, _t(r, torch.int32), _t(c, torch.int32))
    assert got.shape == (B, len(r))
    assert _rel(got.numpy(), inv[:, r, c]) <= 1e-10


def test_block_tridiag_matvec_raises(matern10):
    """The block-tridiagonal SpMV multiplies as `Q.matvec` does on a symmetric
    pattern and raises on a non-symmetric one (its storage mirrors the lower triangle)."""
    rows, cols, shape, data = matern10
    Q = SparseMatrix(_t(data[0]), SparsePattern(rows, cols, shape))
    x = _t(np.random.default_rng(4).normal(size=shape[0]))
    torch.testing.assert_close(tb.block_tridiag_matvec(Q)(x), Q.matvec(x), rtol=1e-12, atol=1e-12)
    lower = rows >= cols
    with pytest.raises(ValueError, match="symmetric sparsity pattern"):
        tb.block_tridiag_matvec(SparseMatrix(_t(data[0][lower]), SparsePattern(rows[lower], cols[lower], shape)))


# ---- rescue paths -----------------------------------------------------------------------


def _rw2(n):
    """The intrinsic RW2 precision D₂ᵀD₂ (pentadiagonal, rank n-2)."""
    D = np.diff(np.eye(n), 2, axis=0)
    return sp.csr_matrix(D.T @ D)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_ridge_rescue_decides_as_reference(dtype):
    n = 30
    rows, cols, vals = _canonical(_rw2(n))
    diag = rows == cols
    delta = 2e-6 * n
    # shifts of the (equilibrated) diagonal: none needed, δ enough, 500δ
    # enough, and indefinite beyond rescue (NaN)
    shifts = np.array([1e-2, -0.2 * delta, -20.0 * delta, -1.0])
    data = vals[None] + np.where(diag, 1.0, 0.0)[None] * vals[None] * shifts[:, None]
    jp = JP(rows, cols, (n, n))
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    ref = jax.jit(jax.vmap(lambda d: jd.dense_factorize(JSM(d, jp)).logdet()))(jnp.asarray(data, jdt))
    t = td._tables(SparsePattern(rows, cols, (n, n)))
    _, _, level, logdet = kernels.dense_chol_plain(_t(data, getattr(torch, dtype)), t)
    assert level.tolist() == [0, 1, 2, 2]
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(logdet.double().numpy()), np.isnan(ref))
    assert np.isnan(ref[-1])
    # f32: these matrices are near-singular by design, so the logdet carries
    # f32 rounding divided by the smallest pivot (~δ)
    tol = 1e-10 if dtype == "float64" else 1e-3
    assert _rel(logdet.double().numpy()[:3], ref[:3]) <= tol


@pytest.fixture(scope="module")
def dense130():
    """Two SPD precisions at n = 130 (K9's tiles of 64: three, the last ragged), a random pattern with a random
    diagonal per chain, and the reference's dense factor (L, s, logdet) of each, computed once per module."""
    n = 130
    rows, cols, vals = _canonical(_random_spd(n, 41))
    diag = rows == cols
    data = vals[None] + np.where(diag, 1.0, 0.0)[None] * np.exp(np.random.default_rng(41).normal(size=(2, 1)))
    jp = JP(rows, cols, (n, n))

    def ref(d):
        f = jd.dense_factorize(JSM(d, jp))
        return f.L, f.s, f.logdet()

    L, s, logdet = jax.jit(jax.vmap(ref))(jnp.asarray(data))
    return dict(pattern=SparsePattern(rows, cols, (n, n)), data=data, L=np.asarray(L), s=np.asarray(s),
                logdet=np.asarray(logdet))


def test_dense_chol_plain_matches_reference_at_three_tiles(dense130):
    L, s, level, logdet = kernels.dense_chol_plain(_t(dense130["data"]), td._tables(dense130["pattern"]))
    assert level.tolist() == [0, 0]
    assert _rel(L.numpy(), dense130["L"]) <= 1e-12
    assert _rel(s.numpy(), dense130["s"]) <= 1e-15
    assert _rel(logdet.numpy(), dense130["logdet"]) <= 1e-12


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_banded_boost_decides_as_reference(dtype):
    n = 48
    A = _random_spd(n, 5, density=0.0) + sp.diags([np.full(n - 1, -0.4)], [-1], shape=(n, n))
    A = (A + A.T) * 0.5 + sp.diags(np.full(n, 0.5))
    rows, cols, vals = _canonical(A.tocsr())
    diag = rows == cols
    # chain 0 as is; chain 1 one pivot just below zero (δ rescues); chain 2
    # indefinite (the Gershgorin step rescues)
    data = np.stack([vals, vals, vals])
    data[1, np.nonzero(diag)[0][20]] = 0.0
    data[2, np.nonzero(diag)[0][20]] = -5.0
    jp = JP(rows, cols, (n, n))
    jdt = jnp.float64 if dtype == "float64" else jnp.float32

    def one(d):
        f = jb.banded_factorize(JSM(d, jp), block=8)
        return f.logdet(), f.boost, f.Lk

    ld, boost, Lk = jax.jit(jax.vmap(one))(jnp.asarray(data, jdt))
    Q = SparseMatrix(_t(data, getattr(torch, dtype)), SparsePattern(rows, cols, (n, n)))
    f = tg.factorize(Q, tg.SolverSpec(kind="banded", block=8))
    assert f.boost.tolist() == np.asarray(boost).tolist()
    assert f.boost[0] == 0 and f.boost[1] > 0 and f.boost[2] > 0
    tol = 1e-10 if dtype == "float64" else 2e-5
    assert _rel(f.logdet().double().numpy(), np.asarray(ld, np.float64)) <= tol
    assert _rel(f.Lk.double().numpy(), np.asarray(Lk, np.float64)) <= tol


# ---- the auto resolution ---------------------------------------------------------------


def test_auto_resolution_picks_the_reference_backend():
    pats = {
        "ar1": sp.diags([np.ones(40), np.ones(39), np.ones(39)], [0, -1, 1]),
        "matern8": None,
        "strip": sp.kron(sp.eye(60), sp.diags([np.ones(3), np.ones(2), np.ones(2)], [0, -1, 1]))
        + sp.diags([np.ones(177), np.ones(177)], [-3, 3]),
        "matern20": None,
        # one hub joined to every node: a wide band, but no fill for AMD
        "arrow": sp.eye(2000) + sp.coo_matrix((np.ones(3998), (np.r_[np.zeros(1999), np.arange(1, 2000)],
                                                             np.r_[np.arange(1, 2000), np.zeros(1999)])),
                                            shape=(2000, 2000)),
    }
    for g in (8, 20):
        jm = jg.MaternModel(_grid(g), smoothness=1)
        Q = jm.precision(tau=1.0, range=0.3)
        pats[f"matern{g}"] = sp.coo_matrix((np.ones(Q.nnz), (Q.pattern.rows, Q.pattern.cols)), shape=Q.shape)
    kinds = {}
    for name, A in pats.items():
        r, c, _ = _canonical(sp.csr_matrix(A))
        shape = A.shape
        for dense_max in (4096, 50):
            want = JaxSolverSpec(dense_max=dense_max).resolve(JP(r, c, shape)).kind
            got = tg.SolverSpec(dense_max=dense_max).resolve(SparsePattern(r, c, shape))
            assert got.kind == want, (name, dense_max, got.kind, want)
            assert tg.SolverSpec(dense_max=dense_max).resolve(SparsePattern(r, c, shape)) is got  # cached
            kinds[(name, dense_max)] = got.kind
    assert set(kinds.values()) == {"tridiag", "dense", "banded", "supernodal"}, kinds


# ---- the Laplace marginal on the new inner solvers ---------------------------------------


@pytest.mark.parametrize("g,inner", [(8, None), (12, "banded")])
def test_laplace_marginal_on_dense_and_banded_inner_solvers(g, inner):
    jmod = jg.MaternModel(_grid(g), smoothness=1)
    n = jmod.n
    pts = _grid(g)
    rng = np.random.default_rng(1)
    field = np.zeros(n)
    field[: g * g] = np.sin(3.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    y = rng.poisson(np.exp(np.clip(field, -3, 3))).astype(np.float64)
    jopts = jg.GAOptions(max_iter=15) if inner is None else jg.GAOptions(max_iter=15, inner_solver=JaxSolverSpec(kind=inner))
    obs = jg.ExponentialFamily("poisson")
    theta = np.array([[1.0, 0.25], [0.5, 0.4], [3.0, 0.15]])

    def f(th):
        return jg.laplace_marginal(jmod, obs, y, {"tau": th[0], "range": th[1]}, options=jopts)

    value, grad = jax.jit(jax.vmap(jax.value_and_grad(f)))(jnp.asarray(theta))
    tmod = interop.matern_model_from_numpy(jmod.disc.mesh.vertices, jmod.disc.mesh.triangles, smoothness=1)
    topts = tg.GAOptions(max_iter=15) if inner is None else tg.GAOptions(max_iter=15, inner_solver=tg.SolverSpec(kind=inner))
    tau, rng_ = _t(theta[:, 0], requires_grad=True), _t(theta[:, 1], requires_grad=True)
    kernels.reset_launches()
    v = tg.laplace_marginal(tmod, tg.ExponentialFamily("poisson"), y, {"tau": tau, "range": rng_}, options=topts)
    v.sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(value), rtol=1e-8)
    np.testing.assert_allclose(torch.stack([tau.grad, rng_.grad], -1).numpy(), np.asarray(grad), rtol=1e-6)
    assert tg.SolverSpec().resolve(tmod.precision(tau=_t(1.0), range=_t(0.3)).pattern).kind == "dense"


def test_split_banded_takahashi_matches_reference_blocks(matern10):
    # K8's plain halves on the banded factor (the prep over all K blocks at once, then K - 1 dependent steps)
    # against the reference's _sigma_blocks (its batched inverses, then its scan), block by block, and against
    # the whole step of the kept entry; K = 3 (blocks of 8), rel 1e-10
    rows, cols, shape, data = matern10
    jp = JP(rows, cols, shape)
    sig_d, sig_s = jax.jit(jax.vmap(lambda d: jb.banded_factorize(JSM(d, jp), block=8)._sigma_blocks()))(
        jnp.asarray(data))
    f = tg.factorize(SparseMatrix(_t(data), SparsePattern(rows, cols, shape)), tg.SolverSpec(kind="banded", block=8))
    K, s = f.plan["K"], f.plan["s"]
    assert K >= 3
    sig = tb._sigma_vals(f.P, f.meta)
    blocks = sig[:, :-1].reshape(B, K, 2 * s, s)
    assert _rel(torch.tril(blocks[:, :, :s]).numpy(), np.tril(np.asarray(sig_d))) <= 1e-10
    assert _rel(blocks[:, : K - 1, s:].numpy(), np.asarray(sig_s)) <= 1e-10
    whole = torch.zeros_like(sig)
    vals = f.P.reshape(B, -1)
    for c in reversed(tb.block_classes(f.P.shape[1], f.P.shape[3], f.P.device)[0]):
        kernels.sn_takahashi_plain(vals, whole, c)
    assert _rel(whole.numpy(), sig.numpy()) <= 1e-12
