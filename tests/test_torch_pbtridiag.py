"""The port's SPIKE block-tridiagonal solve (`tpu_gmrf_torch.parallel`) and
the mesh variant of its supernodal factorization, against the JAX package
in float64 on the same NumPy inputs.

* In one process (P chunks as a batch axis, the private entry
  `_pbtridiag_chunks`) at P = 2, 4 and 8 against ``tpu_gmrf.parallel`` on
  P devices of the 8-device CPU mesh: x to atol 1e-8, the logdet to rtol
  1e-10, at the shapes of ``tests/test_parallel.py`` (the reference marks
  (16, 3), (32, 5) and its logdet shape (24, 4) slow, and so does this file).
* Over ``torch.distributed`` (gloo, ``torch.multiprocessing``) at world sizes
  2 and 4 through the public `pbtridiag_solve` / `pbtridiag_logdet` on a
  ``DeviceMesh``: one spawn per world size runs every case (processes meet
  through a ``FileStore`` under the test's tmp_path, so parallel test workers
  never share a port).
* `_prep`'s ValueErrors.
* Gradients of wᵀx: with respect to b, diag and sub against
  ``jax.jit(jax.grad)`` of the reference at (16, 2), and with respect to diag
  and sub against the dense NumPy oracle, to 1e-8; its Hessian-vector
  product (``create_graph=True``) against ``jax.jvp`` of ``jax.grad`` at
  P = 4, to 1e-10 relative.
* The logdet's gradient in diag and sub (Σ_tt, 2Σ_{t+1,t}) against
  ``jax.grad`` of the reference's `pbtridiag_logdet` at P = 2 and 4 and over
  gloo, to 1e-10 relative; its own second derivative raises.
* `supernodal_factorize(mesh=)` at world size 2 on the 28×28 grid of
  ``tests/test_parallel.py:108``, in float32 and float64: equal bit for bit
  to the one-rank factorization, and held against the reference's own
  ``supernodal_factorize(mesh=)`` on 2 devices of the CPU mesh (float32:
  values to atol 2e-6 as the reference holds; float64: to 1e-12).

Reference values are computed once per module, under ``jax.jit``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import Mesh

from tpu_gmrf.parallel import pbtridiag_logdet as j_logdet
from tpu_gmrf.parallel import pbtridiag_solve as j_solve
from tpu_gmrf.solvers.supernodal import supernodal_factorize as j_supernodal_factorize
from tpu_gmrf.sparse.matrix import SparseMatrix as JaxSparseMatrix
from tpu_gmrf.sparse.pattern import SparsePattern as JaxSparsePattern
import tpu_gmrf_torch as tg
from tpu_gmrf_torch.parallel.pbtridiag import _pbtridiag_chunks

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
CHUNKS = [2, 4, 8]
SOLVE_SHAPES = [(16, 1), pytest.param(16, 3, marks=pytest.mark.slow), pytest.param(32, 5, marks=pytest.mark.slow)]
GRAD_SHAPE = (16, 2)
# the cases run over torch.distributed: (Nt, ns) of a solve, its logdet and its gradients
DIST_SHAPES = [(16, 1), GRAD_SHAPE]


def _random_bt_spd(Nt, ns, seed):
    """`tests/test_parallel.py`'s diagonally dominant block-tridiagonal SPD matrix."""
    rng = np.random.default_rng(seed)
    diag = rng.normal(size=(Nt, ns, ns))
    diag = diag @ np.swapaxes(diag, -1, -2) + 1e-1 * np.eye(ns)
    sub = 0.1 * rng.normal(size=(Nt - 1, ns, ns))
    for t in range(Nt):
        bump = 0.0
        if t > 0:
            bump += np.abs(sub[t - 1]).sum()
        if t < Nt - 1:
            bump += np.abs(sub[t]).sum()
        diag[t] += (bump + ns) * np.eye(ns)
    return diag, sub, rng.normal(size=(Nt, ns)), rng.normal(size=(Nt, ns))


def _dense(diag, sub):
    Nt, ns = diag.shape[0], diag.shape[1]
    A = np.zeros((Nt * ns, Nt * ns))
    for t in range(Nt):
        A[t * ns: (t + 1) * ns, t * ns: (t + 1) * ns] = diag[t]
    for t in range(Nt - 1):
        A[(t + 1) * ns: (t + 2) * ns, t * ns: (t + 1) * ns] = sub[t]
        A[t * ns: (t + 1) * ns, (t + 1) * ns: (t + 2) * ns] = sub[t].T
    return A


def _case(Nt, ns):
    return _random_bt_spd(Nt, ns, seed=Nt * 100 + ns)


@functools.lru_cache(maxsize=None)
def _reference(Nt, ns, P):
    """x, logdet and, at GRAD_SHAPE, the gradients of Σ w·x (and at P = 2, 4 the
    logdet's, at P = 4 the Hessian-vector product) from `tpu_gmrf.parallel` on
    P devices, in one jitted call."""
    diag, sub, b, w = (jnp.asarray(a) for a in _case(Nt, ns))
    mesh = Mesh(np.array(jax.devices()[:P]), ("time",))
    grad = jax.grad(lambda d, s, b_: jnp.sum(w * j_solve(d, s, b_, mesh)), argnums=(0, 1, 2))
    dirs = tuple(jnp.asarray(a) for a in _directions(Nt, ns))

    def run(d, s, b_):
        out = dict(x=j_solve(d, s, b_, mesh), logdet=j_logdet(d, s, mesh))
        if (Nt, ns) == GRAD_SHAPE:
            out.update(zip(("g_diag", "g_sub", "g_b"), grad(d, s, b_)))
            if P in (2, 4):
                ld_grads = jax.grad(lambda d_, s_: j_logdet(d_, s_, mesh), argnums=(0, 1))(d, s)
                out.update(zip(("ld_diag", "ld_sub"), ld_grads))
            if P == 4:
                out.update(zip(("h_diag", "h_sub", "h_b"), jax.jvp(grad, (d, s, b_), dirs)[1]))
        return out

    out = {k: np.asarray(v) for k, v in jax.jit(run)(diag, sub, b).items()}
    out["logdet"] = float(out["logdet"])
    return out


def _directions(Nt, ns):
    """A direction (diag, sub, b) of the Hessian-vector product, diag's blocks symmetric."""
    rng = np.random.default_rng(11)
    vd = rng.normal(size=(Nt, ns, ns))
    return 0.5 * (vd + vd.transpose(0, 2, 1)), rng.normal(size=(Nt - 1, ns, ns)), rng.normal(size=(Nt, ns))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _dense_grads(diag, sub, b, w):
    """The gradients of Σ w·x, x = Q⁻¹b, from the dense matrix: b̄ = Q⁻¹w and
    Q̄ = −b̄xᵀ, read at Q's blocks (the diagonal blocks symmetrized)."""
    Nt, ns = b.shape
    A = _dense(diag, sub)
    x = np.linalg.solve(A, b.ravel()).reshape(Nt, ns)
    gb = np.linalg.solve(A, w.ravel()).reshape(Nt, ns)
    gd = np.stack([-0.5 * (np.outer(gb[t], x[t]) + np.outer(x[t], gb[t])) for t in range(Nt)])
    gs = np.stack([-(np.outer(gb[t + 1], x[t]) + np.outer(x[t + 1], gb[t])) for t in range(Nt - 1)])
    return gd, gs, gb


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=F64, **kw)


# ---- in one process --------------------------------------------------------------------


@pytest.mark.parametrize("P", CHUNKS)
@pytest.mark.parametrize("Nt,ns", SOLVE_SHAPES)
def test_in_process_solve_matches_reference(Nt, ns, P):
    diag, sub, b, _ = _case(Nt, ns)
    x, logdet = _pbtridiag_chunks(_t(diag), _t(sub), _t(b), P)
    ref = _reference(Nt, ns, P)
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=1e-8)
    np.testing.assert_allclose(float(logdet), ref["logdet"], rtol=1e-10)


@pytest.mark.slow
@pytest.mark.parametrize("P", CHUNKS)
def test_in_process_logdet_matches_reference(P):
    diag, sub, _, _ = _case(24, 4)
    _, logdet = _pbtridiag_chunks(_t(diag), _t(sub), torch.zeros(24, 4, dtype=F64), P)
    np.testing.assert_allclose(float(logdet), _reference(24, 4, P)["logdet"], rtol=1e-10)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(_dense(diag, sub))[1], rtol=1e-10)


@pytest.mark.parametrize("P", CHUNKS)
def test_in_process_gradients_match_jax_grad(P):
    diag, sub, b, w = _case(*GRAD_SHAPE)
    td, ts, tb = _t(diag, requires_grad=True), _t(sub, requires_grad=True), _t(b, requires_grad=True)
    x, logdet = _pbtridiag_chunks(td, ts, tb, P)
    assert logdet.requires_grad  # differentiable in diag and sub, not in b
    (x * _t(w)).sum().backward()
    ref = _reference(*GRAD_SHAPE, P)
    oracle = _dense_grads(diag, sub, b, w)
    for got, name, dense in zip((td, ts, tb), ("g_diag", "g_sub", "g_b"), oracle):
        np.testing.assert_allclose(got.grad.numpy(), ref[name], atol=1e-8)
        np.testing.assert_allclose(got.grad.numpy(), dense, atol=1e-8)


@pytest.mark.parametrize("Nt,ns,P", [(16, 3, 4), (12, 2, 6), (8, 4, 4)])
def test_in_process_gradients_match_the_dense_oracle(Nt, ns, P):
    """Two slices per chunk (T = 2) included: the chunk's one interior slice
    carries both couplings."""
    diag, sub, b, w = _random_bt_spd(Nt, ns, seed=7)
    td, ts, tb = _t(diag, requires_grad=True), _t(sub, requires_grad=True), _t(b, requires_grad=True)
    x, _ = _pbtridiag_chunks(td, ts, tb, P)
    (x * _t(w)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), np.linalg.solve(_dense(diag, sub), b.ravel()).reshape(Nt, ns),
                               atol=1e-10)
    for got, dense in zip((td, ts, tb), _dense_grads(diag, sub, b, w)):
        np.testing.assert_allclose(got.grad.numpy(), dense, atol=1e-10)


def test_prep_raises_the_reference_errors():
    diag, sub, b, _ = _random_bt_spd(9, 2, seed=1)
    with pytest.raises(ValueError, match="divisible"):
        _pbtridiag_chunks(_t(diag), _t(sub), _t(b), 8)
    with pytest.raises(ValueError, match="at least 2"):
        _pbtridiag_chunks(_t(diag), _t(sub), _t(b), 9)
    with pytest.raises(ValueError, match="Nt-1"):
        _pbtridiag_chunks(_t(diag), _t(sub[:-2]), _t(b), 3)


def test_logdet_has_no_backward():
    """The logdet now has a backward: ∂/∂diag_t = Σ_tt and ∂/∂sub_t = 2Σ_{t+1,t}
    equal jax.grad of the reference's pbtridiag_logdet at P = 2 and 4; its
    second derivative (Σ's derivative) raises."""
    diag, sub, b, _ = _case(*GRAD_SHAPE)
    for P in (2, 4):
        td, ts = _t(diag, requires_grad=True), _t(sub, requires_grad=True)
        _, logdet = _pbtridiag_chunks(td, ts, _t(b), P)
        gd, gs = torch.autograd.grad(logdet, (td, ts))
        ref = _reference(*GRAD_SHAPE, P)
        assert _rel(gd.numpy(), ref["ld_diag"]) <= 1e-10
        assert _rel(gs.numpy(), ref["ld_sub"]) <= 1e-10
    td = _t(diag, requires_grad=True)
    (gd,) = torch.autograd.grad(_pbtridiag_chunks(td, _t(sub), _t(b), 2)[1], td, create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(gd.sum(), td)


def test_in_process_solve_hessian_vector_product_matches_jax():
    """The solve's second derivative goes through `_SpikeResolve` (no second
    factorization): H·(v_diag, v_sub, v_b) of wᵀx by create_graph=True."""
    diag, sub, b, w = _case(*GRAD_SHAPE)
    td, ts, tb = _t(diag, requires_grad=True), _t(sub, requires_grad=True), _t(b, requires_grad=True)
    x, _ = _pbtridiag_chunks(td, ts, tb, 4)
    grads = torch.autograd.grad((x * _t(w)).sum(), (td, ts, tb), create_graph=True)
    dirs = _directions(*GRAD_SHAPE)
    hvp = torch.autograd.grad(sum((g[: len(v)] * _t(v)).sum() for g, v in zip(grads, dirs)), (td, ts, tb))
    ref = _reference(*GRAD_SHAPE, 4)
    for got, name in zip(hvp, ("h_diag", "h_sub", "h_b")):
        assert _rel(got.numpy(), ref[name]) <= 1e-10


# ---- over torch.distributed (gloo) ---------------------------------------------------------


SN_DTYPES = {"float32": torch.float32, "float64": F64}


@functools.lru_cache(maxsize=None)
def _grid_precision():
    """`tests/test_parallel.py:108`'s Q = KᵀK, K = 2I + L on the 28×28 grid:
    (rows, cols, shape, data in the pattern's order), float64."""
    import scipy.sparse as sp

    m = 28
    n = m * m
    idx = np.arange(n).reshape(m, m)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)])
    W = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    K = (2.0 * sp.eye(n) + L).tocsr()
    Qs = (K.T @ K).tocoo()
    pat = tg.SparsePattern(Qs.row, Qs.col, (n, n))
    return pat.rows, pat.cols, pat.shape, Qs.data[pat.sort_order]


def _grid_matrix(dtype):
    rows, cols, shape, data = _grid_precision()
    return tg.SparseMatrix(torch.tensor(data, dtype=dtype), tg.SparsePattern(rows, cols, shape))


@functools.lru_cache(maxsize=None)
def _reference_supernodal_mesh(dtype):
    """vals and logdet of the reference's `supernodal_factorize(Q, mesh=)` on 2
    devices of the CPU mesh, as ``tests/test_parallel.py:145`` calls it."""
    rows, cols, shape, data = _grid_precision()
    jp = JaxSparsePattern(rows, cols, shape)
    mesh = Mesh(np.array(jax.devices()[:2]), ("snode",))

    def factor(d):
        f = j_supernodal_factorize(JaxSparseMatrix(d, jp), mesh=mesh)
        return f.vals, f.logdet()

    vals, logdet = jax.jit(factor)(jnp.asarray(data, dtype=dtype))
    return np.asarray(vals), float(logdet)


def _dist_worker(rank, world, store, out_dir, cases):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_gmrf_torch.solvers.supernodal import _device_plan, supernodal_factorize

    torch.set_num_threads(1)
    tg.set_default_device("cpu")
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("time",))
        out = {}
        for key, (diag, sub, b, w) in cases.items():
            td, ts, tb = _t(diag, requires_grad=True), _t(sub, requires_grad=True), _t(b, requires_grad=True)
            x = tg.sharded_block_tridiag_solver(mesh)(td, ts, tb)
            (x * _t(w)).sum().backward()
            out[key] = dict(x=x.detach().numpy(), logdet=float(tg.pbtridiag_logdet(_t(diag), _t(sub), mesh)),
                            g_diag=td.grad.numpy(), g_sub=ts.grad.numpy(), g_b=tb.grad.numpy())
            ld, ls = _t(diag, requires_grad=True), _t(sub, requires_grad=True)
            out[key].update(zip(("ld_diag", "ld_sub"),
                                (g.numpy() for g in torch.autograd.grad(tg.pbtridiag_logdet(ld, ls, mesh), (ld, ls)))))
        try:
            tg.pbtridiag_solve(torch.zeros(2 * world + 1, 2, 2, dtype=F64), torch.zeros(2 * world, 2, 2, dtype=F64),
                               torch.zeros(2 * world + 1, 2, dtype=F64), mesh)
        except ValueError as e:
            out["error"] = str(e)
        if world == 2:
            for name, dtype in SN_DTYPES.items():
                Q = _grid_matrix(dtype)
                single, sharded = supernodal_factorize(Q), supernodal_factorize(Q, mesh=mesh)
                # class batches of the split levels whose last shard is padded with DUMMY panels
                padded = sum(c["panel"].shape[0] % world != 0 for lv in _device_plan(sharded.meta, "cpu")["levels"]
                             if not lv.top for c in lv.classes)
                out["supernodal", name] = dict(single=single.vals.numpy(), sharded=sharded.vals.numpy(),
                                               ld_single=float(single.logdet()), ld_sharded=float(sharded.logdet()),
                                               padded=padded)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_results(tmp_path_factory):
    """world -> every rank's results; one spawn per world size, run at first use."""
    done = {}

    def get(world):
        if world not in done:
            tmp = str(tmp_path_factory.mktemp(f"gloo{world}"))
            cases = {shape: _case(*shape) for shape in DIST_SHAPES}
            mp.spawn(_dist_worker, args=(world, os.path.join(tmp, "store"), tmp, cases), nprocs=world)
            done[world] = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
        return done[world]

    return get


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_solve_and_logdet_match_reference(dist_results, world):
    results = dist_results(world)
    for shape in DIST_SHAPES:
        ref = _reference(*shape, world)
        for out in results:  # every rank holds the whole x and the logdet
            np.testing.assert_allclose(out[shape]["x"], ref["x"], atol=1e-8)
            np.testing.assert_allclose(out[shape]["logdet"], ref["logdet"], rtol=1e-10)
    assert all(out["error"] == f"Nt={2 * world + 1} must be divisible by mesh axis size {world}" for out in results)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_gradients_match_jax_grad(dist_results, world):
    results = dist_results(world)
    ref = _reference(*GRAD_SHAPE, world)
    for out in results:  # every rank gets the gradient of the whole arrays
        for name in ("g_diag", "g_sub", "g_b"):
            np.testing.assert_allclose(out[GRAD_SHAPE][name], ref[name], atol=1e-8)


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_logdet_gradient_matches_jax_grad(dist_results, world):
    results = dist_results(world)
    ref = _reference(*GRAD_SHAPE, world)
    for out in results:  # every rank gets the gradient of the whole arrays
        for name in ("ld_diag", "ld_sub"):
            assert _rel(out[GRAD_SHAPE][name], ref[name]) <= 1e-10


@pytest.mark.parametrize("dtype", list(SN_DTYPES))
def test_supernodal_mesh_factorization_matches_one_rank(dist_results, dtype):
    """Each rank's K6 launch on its shard computes what the one launch on the
    whole batch computes, so the sharded factor is the one-rank factor."""
    for out in dist_results(2):
        sn = out["supernodal", dtype]
        assert sn["padded"] > 0  # the DUMMY padding and its write-back ran
        np.testing.assert_array_equal(sn["sharded"], sn["single"])
        assert sn["ld_sharded"] == sn["ld_single"]


@pytest.mark.parametrize("dtype", list(SN_DTYPES))
def test_supernodal_mesh_factorization_matches_reference(dist_results, dtype):
    ref_vals, ref_logdet = _reference_supernodal_mesh(getattr(jnp, dtype))
    # float32: the reference's own limit on the values; the logdet sums 784 log
    # pivots in f32 in another order than XLA does (read 4.6e-7 apart)
    atol, ld_rtol = (2e-6, 1e-6) if dtype == "float32" else (1e-12, 1e-12)
    for out in dist_results(2):
        sn = out["supernodal", dtype]
        np.testing.assert_allclose(sn["sharded"][0], ref_vals, rtol=0, atol=atol)  # one chain
        np.testing.assert_allclose(sn["ld_sharded"], ref_logdet, rtol=ld_rtol)
