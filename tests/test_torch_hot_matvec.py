"""The port's repeated-multiply operators (K13 `bt_matvec`, K14 `bsr_spmm`,
K15 `bsr_outer`, `hot_matvec`) and every backend's `sqrt_matvec`, their
plain versions as CPU tensors take them, against the JAX package in float64
on the same NumPy inputs.

The port's operators take vectors as rows, (k, n); the reference takes
(n, k) columns: the tests transpose. Tolerances: host plans are the
reference's code, so every table is equal; products are sums of a few
dozen terms in another order, 1e-12 relative; the square-root products go
through each package's own factor, 1e-10; gradients 1e-10.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf import kernels as jk
from tpu_gmrf.solvers import banded as jb
from tpu_gmrf.solvers import dense as jd
from tpu_gmrf.solvers import supernodal as jsn
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
from tpu_gmrf_torch import set_default_device
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import interop, kernels
from tpu_gmrf_torch.kernels import hot as thot
from tpu_gmrf_torch.kernels.banded import matvec_split
from tpu_gmrf_torch.solvers import banded as tb
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# the packages export a function under the module's name, so the modules are imported by path
jbsr = importlib.import_module("tpu_gmrf.kernels.bsr_spmv")
tbsr = importlib.import_module("tpu_gmrf_torch.kernels.bsr_spmv")

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64


def _t(a, dtype=F64, **kw):
    return torch.tensor(np.asarray(a), dtype=dtype, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    if ref.size == 0:
        return 0.0
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _canonical(A):
    A = A.tocoo()
    order = np.lexsort((A.col, A.row))
    return A.row[order], A.col[order], A.data[order]


def _random_spd(n, seed, density=0.05):
    A = sp.random(n, n, density=density, random_state=np.random.RandomState(seed))
    A = A + A.T
    return (A + sp.eye(n) * (abs(A).sum(1).max() + 1.0)).tocsr()


@pytest.fixture(scope="module")
def cases():
    """(rows, cols, shape, data) of the g=10 Matérn α=2 prior (n=198) and of
    two random SPD matrices (n=100, and n=53, no multiple of a block size)."""
    Q = jg.MaternModel(_grid(10), smoothness=1).precision(tau=1.0, range=0.3)
    out = {"matern": (np.asarray(Q.pattern.rows), np.asarray(Q.pattern.cols), Q.shape, np.asarray(Q.data))}
    for name, n, seed in (("random", 100, 3), ("ragged", 53, 5)):
        r, c, v = _canonical(_random_spd(n, seed))
        out[name] = (r, c, (n, n), v)
    return out


def _both(case):
    rows, cols, shape, data = case
    return JSM(jnp.asarray(data), JP(rows, cols, shape)), SparseMatrix(_t(data), SparsePattern(rows, cols, shape))


# ---- K13: the block-tridiagonal product ---------------------------------------------


@pytest.mark.parametrize("block", [None, 8])
@pytest.mark.parametrize("case", ["matern", "random"])
def test_block_tridiag_matvec_matches_reference(cases, case, block):
    jq, tq = _both(cases[case])
    ref, got = jb.block_tridiag_matvec(jq, block), tb.block_tridiag_matvec(tq, block)
    assert (got.n, got.npad) == (ref.n, ref.npad)
    assert (got.D.shape[0] == 1) == (case == "random" and block is None)  # K = 1 and K > 1 both occur
    np.testing.assert_array_equal(got.inv_perm.numpy(), np.asarray(ref.inv_perm))
    assert _rel(got.D.numpy(), ref.D) <= 1e-15 and _rel(got.E.numpy(), ref.E) <= 1e-15
    rng = np.random.default_rng(0)
    x = rng.normal(size=(tq.shape[0], 3))
    assert _rel(got(_t(x.T)).numpy().T, ref(jnp.asarray(x))) <= 1e-12
    assert _rel(got(_t(x[:, 0])).numpy(), ref(jnp.asarray(x[:, 0]))) <= 1e-12
    # the reference's operator carried over field by field multiplies alike
    mv = interop.block_tridiag_mv_from_numpy(np.asarray(ref.D), np.asarray(ref.E), np.asarray(ref.inv_perm),
                                             ref.n, ref.npad)
    assert _rel(mv(_t(x.T)).numpy().T, ref(jnp.asarray(x))) <= 1e-12


def test_block_tridiag_matvec_per_chain_and_gradient(cases):
    _, tq = _both(cases["random"])
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(2, tq.shape[0])))
    one = tb.block_tridiag_matvec(tq, 8)
    two = tb.block_tridiag_matvec(SparseMatrix(torch.stack([tq.data, 2.0 * tq.data]), tq.pattern), 8)
    np.testing.assert_allclose(two(x).numpy(), (one(x) * _t([[1.0], [2.0]])).numpy(), rtol=1e-12)
    xg = x.clone().requires_grad_()
    torch.sin(one(xg)).sum().backward()  # Q symmetric: the gradient is Q cos(Q x)
    np.testing.assert_allclose(xg.grad.numpy(), tq.matvec(torch.cos(tq.matvec(x))).numpy(), rtol=1e-10)


def test_block_tridiag_matvec_raises_on_nonsymmetric_pattern():
    pat = SparsePattern(np.array([0, 0, 1, 2]), np.array([0, 1, 1, 2]), (3, 3))
    with pytest.raises(ValueError, match="symmetric sparsity pattern"):
        tb.block_tridiag_matvec(SparseMatrix(torch.ones(4, dtype=F64), pat))


# (s, K, kk, B, element size, upper): the two phase-12 shapes in both dtypes, one vector per chain, bt_sqrt's
# (no Eᵀ term), a block of 65 rows, and blocks of 20,000 rows, beyond the old kernel's shared-memory limit
SPLITS = [(768, 19, 8, 1, 4, True), (384, 261, 8, 1, 8, True), (768, 19, 1, 4, 8, True), (512, 12, 1, 4, 4, False),
          (65, 3, 9, 1, 8, True), (20000, 2, 8, 1, 8, True)]


@pytest.mark.parametrize("s,K,kk,B,size,upper", SPLITS)
def test_matvec_split_covers_the_product(s, K, kk, B, size, upper):
    sp = matvec_split(s, K, kk, B, size, upper)
    assert sp["nv"] in (1, 4, 8) and sp["chunks"] * sp["nv"] >= kk > (sp["chunks"] - 1) * sp["nv"]
    assert sp["strips"] * kernels.banded.MV_ROWS >= s  # every row of a block row has a unit
    passes = -(-s // (sp["threads"] * sp["cpl"]))
    assert sp["threads"] % 32 == 0 and 32 <= sp["threads"] <= 512
    assert sp["threads"] * sp["cpl"] * passes < s + 32 * sp["cpl"] * passes  # no pass has a warp with nothing to read
    if upper and K > 1:  # clusters of at most 8 consecutive strips, one partial of y per cluster and block row
        assert 1 <= sp["cluster"] <= 8 and sp["parts"] * sp["cluster"] == sp["strips"]
        assert sp["strips"] - sp["cluster"] < -(-s // kernels.banded.MV_ROWS)  # padding less than one cluster
    else:
        assert (sp["cluster"], sp["parts"]) == (1, 0)
    rows = B * sp["chunks"] * sp["nv"]
    assert sp["work"] == rows * (2 * K * s + (K - 1) * sp["parts"] * s)


def test_matvec_split_at_the_phase12_shapes():
    """n=14058 (s=768, f32): 12 strips of 64 rows in clusters of 6, two passes of 384 columns; n=99,856
    (s=384, f64): one cluster of 6 per block row, two passes of 192 columns."""
    assert {k: matvec_split(768, 19, 8, 1, 4)[k] for k in ("nv", "strips", "cluster", "parts", "cpl", "threads")} == \
        {"nv": 8, "strips": 12, "cluster": 6, "parts": 2, "cpl": 2, "threads": 192}
    assert {k: matvec_split(384, 261, 8, 1, 8)[k] for k in ("strips", "cluster", "parts", "cpl", "threads")} == \
        {"strips": 6, "cluster": 6, "parts": 1, "cpl": 1, "threads": 192}


# ---- sqrt_matvec of every backend --------------------------------------------------------


@pytest.fixture(scope="module")
def chains(cases):
    """Three SPD matrices on the Matérn pattern (the prior plus positive diagonals)."""
    rows, cols, shape, data = cases["matern"]
    d = np.exp(np.random.default_rng(2).normal(size=(3, shape[0])))
    return rows, cols, shape, data[None] + np.where(rows == cols, 1.0, 0.0)[None] * d[:, rows]


@pytest.mark.parametrize("kind", ["dense", "banded", "supernodal"])
def test_sqrt_matvec_matches_reference(chains, kind):
    rows, cols, shape, data = chains
    jp = JP(rows, cols, shape)
    jfact = {"dense": jd.dense_factorize, "banded": lambda Q: jb.banded_factorize(Q, block=8),
             "supernodal": jsn.supernodal_factorize}[kind]
    z = np.random.default_rng(3).normal(size=(3, shape[0]))
    ref = jax.jit(jax.vmap(lambda d, v: jfact(JSM(d, jp)).sqrt_matvec(v)))(jnp.asarray(data), jnp.asarray(z))
    spec = tg.SolverSpec(kind=kind, block=8 if kind == "banded" else None)
    f = tg.factorize(SparseMatrix(_t(data), SparsePattern(rows, cols, shape)), spec)
    got = f.sqrt_matvec(_t(z))
    assert _rel(got.numpy(), ref) <= 1e-10
    # k columns per chain, and the map undone by the forward solve
    zk = _t(np.random.default_rng(4).normal(size=(3, shape[0], 2)))
    np.testing.assert_allclose(f.sqrt_matvec(zk)[..., 1].numpy(), f.sqrt_matvec(zk[..., 1].contiguous()).numpy(),
                               rtol=1e-12)
    if kind != "supernodal":  # the supernodal forward_solve scales its input; its square root is held below
        torch.testing.assert_close(f.sqrt_matvec(f.forward_solve(_t(z))), _t(z), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kind", ["dense", "banded", "supernodal", "tridiag"])
def test_sqrt_matvec_squares_to_q(kind):
    """W = sqrt_matvec(I) has W Wᵀ = Q, whatever order the backend takes z in."""
    n = 24
    if kind == "tridiag":
        A = sp.diags([np.full(n - 1, -0.7), np.full(n, 2.0), np.full(n - 1, -0.7)], [-1, 0, 1]).tocsr()
    else:
        A = _random_spd(n, 7, 0.2)
    r, c, v = _canonical(A)
    f = tg.factorize(SparseMatrix(_t(v), SparsePattern(r, c, (n, n))),
                     tg.SolverSpec(kind=kind, block=8 if kind == "banded" else None))
    W = f.sqrt_matvec(torch.eye(n, dtype=F64))
    np.testing.assert_allclose((W @ W.T).numpy(), A.toarray(), rtol=1e-10, atol=1e-10)
    from tpu_gmrf_torch.linear_maps import CholeskySqrtMap

    z = _t(np.random.default_rng(5).normal(size=n))
    np.testing.assert_allclose((CholeskySqrtMap(f) @ z).numpy(), (W @ z).numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(CholeskySqrtMap(f).rsolve(z).numpy(), f.backward_solve(z).numpy(), rtol=1e-12)


# ---- K14 / K15: BSR ----------------------------------------------------------------------

_PLAN_TABLES = ("block_rows", "block_cols", "rowptr", "scatter_block", "scatter_i", "scatter_j", "t_perm")


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("case", ["matern", "ragged"])
def test_bsr_plan_matches_reference(cases, case, bs):
    jq, tq = _both(cases[case])
    ref, got = jbsr._bsr_plan(jq.pattern, bs), tbsr._bsr_plan(tq.pattern, bs)
    for a, b in ((got, ref), (got.transpose, ref.transpose)):
        assert (a.n, a.bs, a.nb, a.nblocks) == (b.n, b.bs, b.nb, b.nblocks)
        for name in _PLAN_TABLES:
            np.testing.assert_array_equal(np.ravel(getattr(a, name)), np.ravel(getattr(b, name)), err_msg=name)
    assert got.transpose.transpose is got
    assert kernels.best_block_size(tq.pattern) == jk.best_block_size(jq.pattern)


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("case", ["matern", "ragged"])
def test_bsr_forward_matches_reference(cases, case, bs):
    jq, tq = _both(cases[case])
    ref, got = jk.bsr_from_sparse(jq, bs), kernels.bsr_from_sparse(tq, bs)
    assert got.shape == ref.shape
    assert _rel(got.blocks.numpy(), ref.blocks) <= 1e-15
    x = np.random.default_rng(6).normal(size=(tq.shape[0], 3))
    assert _rel(got.matvec(_t(x.T)).numpy().T, ref.matvec(jnp.asarray(x))) <= 1e-12
    assert _rel((got @ _t(x[:, 0])).numpy(), ref @ jnp.asarray(x[:, 0])) <= 1e-12
    # Aᵀx over the transposed plan, without a transposed copy of the blocks
    At = sp.csr_matrix((cases[case][3], (cases[case][0], cases[case][1])), shape=tq.shape).T
    assert _rel(kernels.bsr_spmm(got.blocks, got.plan, _t(x.T), transpose=True).numpy().T, At @ x) <= 1e-12
    # the reference's blocks and block tables carried over multiply alike
    p = ref.plan
    Bm = interop.bsr_from_numpy(np.asarray(ref.blocks), p.n, p.bs, p.block_rows, p.block_cols)
    np.testing.assert_array_equal(Bm.plan.t_perm, p.t_perm)
    np.testing.assert_array_equal(Bm.plan.transpose.rowptr, p.transpose.rowptr)
    assert _rel(Bm.matvec(_t(x.T)).numpy().T, ref.matvec(jnp.asarray(x))) <= 1e-12


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("case", ["random", "ragged"])
def test_bsr_gradients_match_jax_grad(cases, case, bs):
    jq, tq = _both(cases[case])
    ref, got = jk.bsr_from_sparse(jq, bs), kernels.bsr_from_sparse(tq, bs)
    x = np.random.default_rng(7).normal(size=(tq.shape[0], 2))
    g_b, g_x = jax.grad(lambda b, v: jnp.sum(jnp.sin(jbsr.bsr_spmv(b, v, ref.plan))), argnums=(0, 1))(
        ref.blocks, jnp.asarray(x))
    blocks, xr = got.blocks.clone().requires_grad_(), _t(x.T).requires_grad_()
    torch.sin(kernels.bsr_spmv(blocks, xr, got.plan)).sum().backward()
    assert _rel(blocks.grad.numpy(), g_b) <= 1e-10
    assert _rel(xr.grad.numpy().T, g_x) <= 1e-10
    # and through the scatter, to the matrix's own values
    data = tq.data.clone().requires_grad_()
    torch.sin(kernels.bsr_from_sparse(SparseMatrix(data, tq.pattern), bs).matvec(_t(x.T))).sum().backward()
    g_d = jax.grad(lambda d: jnp.sum(jnp.sin(jk.bsr_from_sparse(JSM(d, jq.pattern), bs).matvec(jnp.asarray(x)))))(jq.data)
    assert _rel(data.grad.numpy(), g_d) <= 1e-10


def test_bsr_one_matrix_per_chain(cases):
    _, tq = _both(cases["ragged"])
    scale = _t([[1.0], [0.5], [3.0]])
    Bm = kernels.bsr_from_sparse(SparseMatrix(tq.data[None] * scale, tq.pattern), 8)
    assert Bm.blocks.shape[0] == 3
    x = _t(np.random.default_rng(8).normal(size=(3, tq.shape[0])))
    np.testing.assert_allclose(Bm.matvec(x).numpy(), (tq.matvec(x) * scale).numpy(), rtol=1e-12)
    blocks, xg = Bm.blocks.clone().requires_grad_(), x.clone().requires_grad_()
    torch.sin(kernels.bsr_spmv(blocks, xg, Bm.plan)).sum().backward()
    assert blocks.grad.shape == Bm.blocks.shape
    ref = torch.autograd.grad(torch.sin(tq.matvec(x_ := x.clone().requires_grad_()) * scale).sum(), x_)[0]
    np.testing.assert_allclose(xg.grad.numpy(), ref.numpy(), rtol=1e-10)
    # dBlocks of chain c is g_c ⊗ x_c on the stored blocks
    one = kernels.bsr_outer(Bm.plan, torch.cos(Bm.matvec(x))[1:2].contiguous(), x[1:2].contiguous())
    np.testing.assert_allclose(blocks.grad[1].numpy(), one.numpy(), rtol=1e-12)


# ---- hot_matvec --------------------------------------------------------------------------


@pytest.fixture
def reference_rates(monkeypatch):
    """The dispatch rule's two rates set to the reference's values, so that
    both packages decide by the same numbers."""
    monkeypatch.setattr(thot, "_DENSE_BYTES_PER_S", jk._DENSE_BYTES_PER_S)
    monkeypatch.setattr(thot, "_GATHER_BYTES_PER_S", jk._GATHER_BYTES_PER_S)


def _branch(mv, block_cls):
    if isinstance(mv, block_cls):
        return "block_tridiag"
    return "bsr" if type(mv.__self__).__name__ == "BSRMatrix" else "csr"


@pytest.mark.parametrize("symmetric_values", [True, False])
@pytest.mark.parametrize("min_nnz", [10**9, 1])
def test_hot_matvec_dispatch_matches_reference(reference_rates, min_nnz, symmetric_values):
    n = 300
    r, c, v = _canonical(_random_spd(n, 11, 0.02))
    if not symmetric_values:  # a symmetric pattern with non-symmetric values must not take the mirrored storage
        v = v * (1.0 + 0.1 * (r > c))
    jq, tq = JSM(jnp.asarray(v), JP(r, c, (n, n))), SparseMatrix(_t(v), SparsePattern(r, c, (n, n)))
    ref, got = jk.hot_matvec(jq, min_nnz=min_nnz), kernels.hot_matvec(tq, min_nnz=min_nnz)
    assert _branch(got, tb.BlockTridiagMV) == _branch(ref, jb.BlockTridiagMV)
    want = "csr" if min_nnz > 1 else ("block_tridiag" if symmetric_values else "bsr")
    assert _branch(got, tb.BlockTridiagMV) == want
    x = np.random.default_rng(9).normal(size=(n, 2))
    assert _rel(got(_t(x.T)).numpy().T, ref(jnp.asarray(x))) <= 1e-12
    assert _rel(got(_t(x[:, 0])).numpy(), ref(jnp.asarray(x[:, 0]))) <= 1e-12


def test_hot_matvec_batched_values(cases):
    _, tq = _both(cases["matern"])
    Qb = SparseMatrix(torch.stack([tq.data, 2.0 * tq.data]), tq.pattern)
    x = _t(np.random.default_rng(10).normal(size=(2, tq.shape[0])))
    for min_nnz in (10**9, 1):
        np.testing.assert_allclose(kernels.hot_matvec(Qb, min_nnz=min_nnz)(x).numpy(), Qb.matvec(x).numpy(), rtol=1e-11)


# ---- the wrappers' choice of path (the kernels themselves are held on the card) -----------


@pytest.mark.parametrize("n,B,dtype,want", [
    (500, 256, torch.float32, "shared"),  # the flagship shape stays where it was
    (500, 4, torch.float64, "shared"),  # few chains, but one tile of rows
    (5741, 4, torch.float64, "tiled"),  # few chains: rows spread over blocks
    (5741, 256, torch.float64, "shared"),
    (6136, 256, torch.float64, "shared"),  # (n + 8)·8 = 48 KB exactly
    (6137, 256, torch.float64, "tiled"),
    (12280, 256, torch.float32, "shared"),
    (12281, 256, torch.float32, "tiled"),
    (14058, 8, torch.float32, "tiled"),
    (99856, 1, torch.float64, "tiled"),
])
def test_csr_spmv_picks_its_path(n, B, dtype, want):
    assert kernels.spmv_path(n, B, dtype) == want


@pytest.mark.parametrize("n,k,dtype,want", [
    (500, 0, torch.float32, "shared"),
    (500, 1, torch.float64, "shared"),
    (3072, 0, torch.float64, "shared"),  # 2n − 1 values: 49,144 bytes
    (3073, 0, torch.float64, "global"),
    (6144, 0, torch.float32, "shared"),
    (6145, 0, torch.float32, "global"),
    (2048, 1, torch.float64, "shared"),
    (2048, 2, torch.float64, "global"),  # the right-hand sides count
    (20000, 0, torch.float64, "global"),
])
def test_tridiag_kernels_pick_their_path(n, k, dtype, want):
    assert kernels.tridiag_path(n, k, dtype) == want


def test_large_sizes_answer_on_the_plain_versions():
    """n beyond the old shared-memory limits: `SparseMatrix.matvec`/`quad` and
    an AR1 factor answer (on CPU tensors through the plain versions; the
    kernels' own large paths are checked on the card)."""
    n = 20000
    g = tg.AR1Model(n)(tau=_t(1.3), rho=_t(0.6))
    x = _t(np.random.default_rng(11).normal(size=n))
    assert torch.isfinite(g.logpdf(x))
    np.testing.assert_allclose(g.var()[n // 2].item(), 1.0 / (1.3 * (1 - 0.36)), rtol=1e-10)
    np.testing.assert_allclose(g.Q.matvec(g.solve(x)).numpy(), x.numpy(), atol=1e-9)


def test_new_wrappers_count_no_launch_on_cpu(cases):
    kernels.reset_launches()
    _, tq = _both(cases["random"])
    x = _t(np.ones((2, tq.shape[0])))
    kernels.bsr_from_sparse(tq, 8).matvec(x)
    tb.block_tridiag_matvec(tq, 8)(x)
    tg.factorize(tq, tg.SolverSpec(kind="supernodal")).sqrt_matvec(x[0])
    assert kernels.launches() == dict.fromkeys(kernels.KERNELS, 0)
    assert {"bt_matvec", "bt_sqrt", "bsr_spmm", "bsr_outer", "sn_multiply"} <= set(kernels.KERNELS)
