"""The port's supernodal backend (host plan, K5-K8 plain versions, logdet
gradient) and its K5 sparse ops against the JAX package, float64, on the
same NumPy inputs.

Tolerances and why:
- plans: the host code is the reference's, so every table is equal;
- factor values, logdet, solves, Σ: the same schedule and block algebra,
  LAPACK and torch.linalg differ only in rounding order: rel 1e-10;
- logdet gradient against ``jax.grad``: rel 1e-8;
- sparse ops: exact arithmetic up to summation order: rtol 1e-12.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_gmrf import MaternModel as JaxMatern
from tpu_gmrf.solvers import supernodal as jsn
from tpu_gmrf.sparse.matrix import SparseMatrix as JaxSparseMatrix
from tpu_gmrf.sparse.pattern import SparsePattern as JaxPattern
from tpu_gmrf_torch import set_default_device
from tpu_gmrf_torch import interop, kernels
from tpu_gmrf_torch.solvers import supernodal as tsn
from tpu_gmrf_torch.sparse.matrix import SparseMatrix, sp_add, sp_matmul
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
set_default_device("cpu")

F64 = torch.float64
RTOL = 1e-10


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=kw.pop("dtype", F64), **kw)


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def matern24():
    """Matérn α=2 precisions on the 24×24 grid (n=931) at three (τ, range),
    plus a non-symmetric perturbation of the first (a 4th chain), right-hand
    sides, and the reference's statistics and logdet gradients: one jitted,
    vmapped JAX call."""
    model = JaxMatern(_grid(24), smoothness=1)
    thetas = [(1.0, 0.25), (0.5, 0.4), (3.0, 0.15)]
    data = np.stack([np.asarray(model.precision(tau=t, range=r).data) for t, r in thetas])
    jp = model.precision(tau=1.0, range=0.25).pattern
    rng = np.random.default_rng(0)
    data = np.concatenate([data, data[:1] + 1e-3 * rng.normal(size=(1, jp.nnz))])
    n = jp.shape[0]
    b, z = rng.normal(size=(4, n)), rng.normal(size=(4, n))

    def stats(d, bb, zz):
        f = jsn.supernodal_factorize(JaxSparseMatrix(d, jp))
        grad = jax.grad(lambda dd: jsn.supernodal_factorize(JaxSparseMatrix(dd, jp)).logdet())(d)
        return (f.vals, f.s, f.logdet(), f.solve(bb), f.backward_solve(zz), f.selinv_diag(),
                f.selinv(jp).data, f.boost, grad, f.selinv_dot(JaxSparseMatrix(d, jp)))

    ref = [np.asarray(r) for r in jax.jit(jax.vmap(stats))(jnp.asarray(data), b, z)]
    return dict(pattern=jp, data=data, b=b, z=z, ref=ref)


def _port_pattern(jp):
    return SparsePattern(jp.rows, jp.cols, jp.shape)


def _assert_same_tree(a, b, path="plan"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# ---- host plan --------------------------------------------------------------


@pytest.mark.parametrize("g,max_width", [(24, 2048), (12, 16)])
def test_plan_matches_reference(g, max_width):
    jp = JaxMatern(_grid(g), smoothness=1).precision(tau=1.0, range=0.25).pattern
    ref = jsn.supernodal_plan(jp, max_width, "auto")
    got = tsn.supernodal_plan(_port_pattern(jp), max_width, "auto")
    if g == 24:
        assert got["lstar"] == 1 and len(got["segments"]) == 1
    _assert_same_tree(interop.plan_to_numpy(ref), got)
    assert tsn.supernodal_symbolic_summary(_port_pattern(jp), max_width) == jsn.supernodal_symbolic_summary(
        jp, max_width)


# ---- factor parity ----------------------------------------------------------


_STATS = ["vals", "s", "logdet", "solve", "backward_solve", "selinv_diag", "selinv", None, None, "selinv_dot"]


@pytest.mark.parametrize("batched", [False, True])
def test_factor_matches_reference(matern24, batched):
    jp, ref = matern24["pattern"], matern24["ref"]
    sel = slice(0, 3) if batched else 0  # B=3 against jax.vmap, or one unbatched chain
    Q = SparseMatrix(_t(matern24["data"][sel]), _port_pattern(jp))
    f = tsn.supernodal_factorize(Q)
    got = [f.vals, f.s, f.logdet(), f.solve(_t(matern24["b"][sel])),
           f.backward_solve(_t(matern24["z"][sel])), f.selinv_diag(), f.selinv(Q.pattern).data, None, None,
           f.selinv_dot(Q)]
    for name, gv, rv in zip(_STATS, got, ref):
        if name is None:  # boost and the logdet gradient: checked below and in their own test
            continue
        rv = rv[sel]
        gv = gv.detach().reshape(rv.shape).numpy()
        assert _rel(gv, rv) <= RTOL, (name, _rel(gv, rv))
    assert f.boost.tolist() == [0] * (3 if batched else 1) and np.all(ref[7][sel] == 0)


def test_solve_with_several_right_hand_sides(matern24):
    jp = matern24["pattern"]
    Q = SparseMatrix(_t(matern24["data"][:3]), _port_pattern(jp))
    f = tsn.supernodal_factorize(Q)
    rhs = _t(np.random.default_rng(1).normal(size=(3, jp.shape[0], 2)))
    x = f.solve(rhs)
    for j in range(2):
        np.testing.assert_allclose(x[..., j].numpy(), f.solve(rhs[..., j].contiguous()).numpy(), rtol=1e-12)
    np.testing.assert_allclose(Q.matvec(x[..., 0].contiguous()).numpy(), rhs[..., 0].numpy(), atol=1e-9)
    # solve carries the gradient to b (b̄ = Q⁻¹x̄); so does the sampling solve, z̄ = L⁻¹x̄ (its adjoint)
    b = rhs[..., 0].clone().requires_grad_()
    w = _t(np.random.default_rng(2).normal(size=(3, jp.shape[0])))
    (f.solve(b) * w).sum().backward()
    np.testing.assert_allclose(b.grad.numpy(), f.solve(w).numpy(), rtol=1e-12)
    z = rhs[..., 0].clone().requires_grad_()
    (f.backward_solve(z) * w).sum().backward()
    np.testing.assert_allclose((z.grad * rhs[..., 1]).sum((-1,)).numpy(),
                               (f.backward_solve(rhs[..., 1].contiguous()) * w).sum(-1).numpy(), rtol=1e-12)


@pytest.mark.parametrize("chain", [0, 3])
def test_logdet_gradient_matches_jax_grad(matern24, chain):
    # chain 3 carries a non-symmetric perturbation of the stored values: the
    # gradient must split over both stored triangles as the reference's does
    td = _t(matern24["data"][chain]).requires_grad_()
    tsn.supernodal_factorize(SparseMatrix(td, _port_pattern(matern24["pattern"]))).logdet().backward()
    assert _rel(td.grad.numpy(), matern24["ref"][8][chain]) <= 1e-8


def _boost_case(blocks):
    # near-singular diagonal blocks: all-ones plus a 1e-9 ridge is singular
    # in f32, so the reference boosts every such block
    n = 6
    A = np.kron(np.eye(blocks), np.ones((n, n))) + np.diag(np.linspace(1e-9, 2e-9, n * blocks))
    r, c = np.nonzero(A)
    return JaxPattern(r, c, A.shape), A[r, c]


@pytest.mark.parametrize("blocks", [1, 2])
def test_boosted_f32_blocks_match_reference(blocks):
    jp, d = _boost_case(blocks)
    d = d.astype(np.float32)
    jf = jsn.supernodal_factorize(JaxSparseMatrix(jnp.asarray(d), jp))
    f = tsn.supernodal_factorize(SparseMatrix(_t(d, dtype=torch.float32), _port_pattern(jp)))
    assert int(jf.boost) == blocks
    assert int(f.boost[0]) == blocks
    # f32 rounding of LAPACK's and torch's Cholesky orders, amplified by the
    # boosted block's conditioning
    assert _rel(f.vals[0].numpy(), np.asarray(jf.vals)) <= 1e-3
    np.testing.assert_allclose(float(f.logdet()), float(jf.logdet()), rtol=1e-4)


def test_supernodal_rejects_unsymmetric_patterns():
    p = SparsePattern([0, 1, 1], [0, 0, 1], (2, 2))
    with pytest.raises(ValueError, match="symmetric"):
        tsn.supernodal_factorize(SparseMatrix(_t([1.0, 0.1, 1.0]), p))


# ---- K5 sparse ops ----------------------------------------------------------


def _random_pattern(rng, n, density):
    mask = rng.uniform(size=(n, n)) < density
    mask |= np.eye(n, dtype=bool)
    return np.nonzero(mask)


@pytest.mark.parametrize("batched", [False, True])
def test_sp_matmul_values_and_gradients_match_jax(batched):
    rng = np.random.default_rng(3)
    n, B = 14, 3
    ra, ca = _random_pattern(rng, n, 0.2)
    rb, cb = _random_pattern(rng, n, 0.25)
    ja, jb = JaxPattern(ra, ca, (n, n)), JaxPattern(rb, cb, (n, n))
    a = rng.normal(size=(B, ja.nnz) if batched else ja.nnz)
    b = rng.normal(size=(B, jb.nnz))

    def jf(ad, bd):
        C = JaxSparseMatrix(ad, ja) @ JaxSparseMatrix(bd, jb)
        return C.data, jnp.sum(jnp.sin(C.data))

    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    C = SparseMatrix(ta, SparsePattern(ra, ca, (n, n))) @ SparseMatrix(tb, SparsePattern(rb, cb, (n, n)))
    torch.sin(C.data).sum().backward()
    for i in range(B):
        ai = a[i] if batched else a
        data_ref, _ = jf(jnp.asarray(ai), jnp.asarray(b[i]))
        np.testing.assert_allclose(C.data[i].detach().numpy(), np.asarray(data_ref), rtol=1e-12, atol=1e-14)
        gb = jax.grad(lambda bd: jf(jnp.asarray(ai), bd)[1])(jnp.asarray(b[i]))
        np.testing.assert_allclose(tb.grad[i].numpy(), np.asarray(gb), rtol=1e-12, atol=1e-14)
    ga = [np.asarray(jax.grad(lambda ad: jf(ad, jnp.asarray(b[i]))[1])(jnp.asarray(a[i] if batched else a)))
          for i in range(B)]
    np.testing.assert_allclose(ta.grad.numpy(), np.stack(ga) if batched else np.sum(ga, 0), rtol=1e-12, atol=1e-14)
    assert sp_matmul(SparseMatrix(_t(a[0] if batched else a), SparsePattern(ra, ca, (n, n))),
                     SparseMatrix(_t(b[0]), SparsePattern(rb, cb, (n, n)))).data.shape == (C.pattern.nnz,)


@pytest.mark.parametrize("batched", [False, True])
def test_pad_to_and_sp_add_gradients_match_jax(batched):
    # a non-tridiagonal super-pattern, (B, nnz) and (nnz,) data
    rng = np.random.default_rng(4)
    n, B = 12, 2
    r, c = _random_pattern(rng, n, 0.3)
    jp, tp = JaxPattern(r, c, (n, n)), SparsePattern(r, c, (n, n))
    rs, cs = _random_pattern(rng, n, 0.1)
    keep = np.isin(rs * n + cs, r * n + c)
    jsub, tsub = JaxPattern(rs[keep], cs[keep], (n, n)), SparsePattern(rs[keep], cs[keep], (n, n))
    rd, cd = _random_pattern(rng, n, 0.15)
    jo, to = JaxPattern(rd, cd, (n, n)), SparsePattern(rd, cd, (n, n))
    x = rng.normal(size=(B, jsub.nnz) if batched else jsub.nnz)
    y = rng.normal(size=(B, jo.nnz) if batched else jo.nnz)
    w1 = rng.normal(size=jp.nnz)

    def jf(xd, yd):
        P = JaxSparseMatrix(xd, jsub).pad_to(jp)
        S = JaxSparseMatrix(xd, jsub) + JaxSparseMatrix(yd, jo)
        return P.data, S.data, jnp.sum(P.data * w1) + jnp.sum(jnp.cos(S.data))

    tx, ty = _t(x).requires_grad_(), _t(y).requires_grad_()
    P = SparseMatrix(tx, tsub).pad_to(tp)
    S = sp_add(SparseMatrix(tx, tsub), SparseMatrix(ty, to))
    ((P.data * _t(w1)).sum() + torch.cos(S.data).sum()).backward()
    xs = x if batched else x[None]
    ys = y if batched else y[None]
    gx_ref, gy_ref = [], []
    for i in range(xs.shape[0]):
        pd, sd, _ = jf(jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        np.testing.assert_allclose(P.data.reshape(-1, tp.nnz)[i].detach().numpy(), np.asarray(pd), rtol=1e-12)
        np.testing.assert_allclose(S.data.reshape(-1, S.pattern.nnz)[i].detach().numpy(), np.asarray(sd), rtol=1e-12)
        gx, gy = jax.grad(lambda a, b: jf(a, b)[2], argnums=(0, 1))(jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        gx_ref.append(np.asarray(gx))
        gy_ref.append(np.asarray(gy))
    np.testing.assert_allclose(tx.grad.reshape(-1, tsub.nnz).numpy(), np.stack(gx_ref), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ty.grad.reshape(-1, to.nnz).numpy(), np.stack(gy_ref), rtol=1e-12, atol=1e-14)


def test_gather_segsum_plain_semantics():
    # out[t[r]] (=|+=) α Σ x[xi]·y[yi] over CSR and fixed-width rows
    x = _t([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0]])
    y = _t([10.0, 20.0, 30.0, 40.0])
    plan = kernels.SegPlan([0, 1, 3, 2], ptr=[0, 2, 2, 4], yi=[0, 0, 1, 1], t=[4, 0, 1])
    out = torch.ones(2, 5, dtype=F64)
    kernels.gather_segsum(plan, x, y=y, out=out, alpha=-1.0, accumulate=True)
    ref = np.ones((2, 5))
    ref[:, 4] -= [10 * 1 + 10 * 2, 10 * 5 + 10 * 6]
    ref[:, 1] -= [20 * 4 + 20 * 3, 20 * 8 + 20 * 7]
    np.testing.assert_array_equal(out.numpy(), ref)
    ell = kernels.SegPlan([0, 1, 2, 3], width=2)
    np.testing.assert_array_equal(kernels.gather_segsum(ell, x).numpy(), [[3.0, 7.0], [11.0, 15.0]])


def test_gather_segsum_three_factors_and_factor_checks():
    # out[r] = Σ x[xi]·y[yi]·z[zi], the form that undoes the Jacobi scaling (s_i·Σ_ij·s_j)
    x = _t([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    s = _t([[2.0, 3.0], [5.0, 7.0]])
    plan = kernels.SegPlan([2, 0, 1], ptr=[0, 1, 3], yi=[0, 1, 1], zi=[1, 0, 1])
    got = kernels.gather_segsum(plan, x, y=s, z=s).numpy()
    ref = [[3 * 2 * 3, 1 * 3 * 2 + 2 * 3 * 3], [6 * 5 * 7, 4 * 7 * 5 + 5 * 7 * 7]]
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="exactly when"):
        kernels.gather_segsum(plan, x, y=s)
    with pytest.raises(ValueError, match="zi needs yi"):
        kernels.SegPlan([0], ptr=[0, 1], zi=[0])


def test_fct_init_matches_reference():
    # symmetrize, equilibrate and scatter onto the fill pattern (K5's second
    # entry), on a non-symmetric perturbation and one non-positive pivot
    jp = JaxMatern(_grid(12), smoothness=1).precision(tau=1.0, range=0.25).pattern
    d0 = np.asarray(JaxMatern(_grid(12), smoothness=1).precision(tau=1.0, range=0.25).data)
    rng = np.random.default_rng(5)
    data = np.stack([d0, d0 + 1e-3 * rng.normal(size=jp.nnz)])
    data[1, jp.diag_positions[3]] = -1.0  # s = 1 there, as the reference
    plan = jsn.supernodal_plan(jp, 2048, "auto")
    tp = _port_pattern(jp)
    tsn.supernodal_plan(tp, 2048, "auto")
    init = tsn._device_plan((tp, 2048, "auto"), torch.device("cpu"))["init"]
    B, n = data.shape[0], jp.shape[0]
    vals, s, nls = torch.zeros(B, plan["nnzL"] + 1, dtype=F64), torch.empty(B, n, dtype=F64), torch.empty(B, n, dtype=F64)
    kernels.fct_init(init, _t(data), vals, s, nls)
    for b in range(B):
        rv, rs = jsn._fct_init(JaxSparseMatrix(jnp.asarray(data[b]), jp), plan)
        np.testing.assert_allclose(vals[b].numpy(), np.asarray(rv), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(s[b].numpy(), np.asarray(rs), rtol=1e-14)
        np.testing.assert_allclose(nls[b].numpy(), -np.log(np.asarray(rs)), rtol=1e-14, atol=1e-15)
    assert float(s[1, 3]) == 1.0


# ---- K8's two halves (the Σ-free prep, the Σ-dependent sweep) ---------------------------


def _live(idx, dummy, W):
    """(ns, m) of one supernode's panel table (W+M, W): its live columns and rows below."""
    ns = int((idx[np.arange(W), np.arange(W)] != dummy).sum())
    return ns, int((idx[W:, 0] != dummy).sum())


@pytest.mark.parametrize("chains", [[0], [0, 1, 2]], ids=["B1", "B3"])
def test_split_takahashi_matches_reference(matern24, chains):
    # the plain prep over every class shape, then the plain sweep level by level, against the reference's Σ
    # (selinv_diag, selinv on Q's pattern) and logdet gradient: rel 1e-10, both sides exact up to the rounding
    # order of LAPACK-class triangular solves and products
    jp, ref = matern24["pattern"], matern24["ref"]
    tp = _port_pattern(jp)
    td = _t(matern24["data"][chains], requires_grad=True)
    f = tsn.supernodal_factorize(SparseMatrix(td.detach(), tp))
    assert _rel(f.selinv_diag().numpy(), ref[5][chains]) <= RTOL
    assert _rel(f.selinv(tp).data.numpy(), ref[6][chains]) <= RTOL
    tsn.supernodal_factorize(SparseMatrix(td, tp)).logdet().sum().backward()
    assert _rel(td.grad.numpy(), ref[8][chains]) <= RTOL
    # the whole step of the kept entry, class batch by class batch, gives the same Σ
    sig = torch.zeros_like(f.vals)
    for lv in reversed(tsn._device_plan(f.meta, f.vals.device)["levels"]):
        for c in lv.classes:
            kernels.sn_takahashi_plain(f.vals, sig, c)
    assert _rel(sig.numpy(), f._sigma_vals().numpy()) <= 1e-12


def test_takahashi_prep_plain_against_triangular_solves(matern24):
    # C = Lb Ld⁻¹ and A = Ld⁻ᵀ Ld⁻¹ of every supernode, against torch.linalg.solve_triangular on the gathered
    # blocks (the other side of the products: rel 1e-10 normwise per supernode)
    f = tsn.supernodal_factorize(SparseMatrix(_t(matern24["data"][:2]), _port_pattern(matern24["pattern"])))
    dp = tsn._device_plan(f.meta, f.vals.device)
    pre = torch.zeros_like(f.vals)
    for c in dp["prep"]:
        kernels.sn_takahashi_prep_plain(f.vals, pre, c)
    seen = 0
    for c in dp["prep"]:
        W = c["W"]
        for idx in c["panel"].long().numpy():
            ns, m = _live(idx, c["dummy"], W)
            if ns == 0:
                continue
            Ld = torch.tril(f.vals[:, torch.from_numpy(idx[:ns, :ns])])
            Linv = torch.linalg.solve_triangular(Ld, torch.eye(ns, dtype=F64).expand_as(Ld), upper=False)
            A = pre[:, torch.from_numpy(idx[:ns, :ns])]
            assert _rel(torch.tril(A).numpy(), torch.tril(Linv.mT @ Linv).numpy()) <= RTOL
            if m:
                Lb = f.vals[:, torch.from_numpy(idx[W:W + m, :ns])]
                C = torch.linalg.solve_triangular(Ld, Lb, upper=False, left=False)
                assert _rel(pre[:, torch.from_numpy(idx[W:W + m, :ns])].numpy(), C.numpy()) <= RTOL
            seen += 1
    assert seen == tsn._PLAN_CACHE[f.meta]["nsuper"]


@pytest.mark.parametrize("W, M, units, want", [
    (16, 128, 296, (1, 0, 0)),  # a scan level: many supernodes, one block each fills the card
    (32, 128, 16, (2, 0, 0)),  # few supernodes, tiles that fit a cluster
    (64, 512, 4, (8, 0, 0)),  # eight Σ_RJ tiles: a cluster of eight
    (128, 512, 4, (0, 16, 3)),  # a top separator: a block per tile, two launches
    (512, 512, 4, (0, 64, 36)),  # a banded step
    (512, 0, 4, (0, 0, 36)),  # no rows below: Σ_JJ = A alone
    (4, 32, 4, (1, 0, 0)),  # column tiles of 8
])
def test_sweep_launch_picks_its_form(W, M, units, want):
    # K8's launch form from the batch's shape, on a card of 132 SMs
    assert kernels.supernodal.sweep_launch(W, M, units, 132) == want


def _held(per_sm):
    """Clusters of cs blocks a card of 132 SMs holds at once with per_sm blocks on an SM (0 above 16)."""
    return lambda cs: per_sm * 132 // cs if cs <= 16 else 0


# K6's path and cluster size at the n=5741 plan's class shapes (W, M, P·B at B=4), on a card of 132 SMs that holds
# three of its cluster-path blocks per SM
@pytest.mark.parametrize("W, M, units, want", [
    (512, 0, 4, 16),  # the level-13 separator (475 wide): four clusters of 16
    (128, 512, 4, 16),  # levels 8-12: ten row tiles, clusters of 16
    (64, 256, 12, 10),  # a narrow panel with many rows below on a few units: five row tiles, clusters of 10
    (16, 128, 296, 0),  # a scan level that fills the card: one block per (supernode, chain)
    (8, 64, 156, 0),  # one row tile below: one block
])
def test_panel_launch_picks_path_and_cluster(W, M, units, want):
    assert kernels.supernodal.panel_launch(W, M, units, _held(3), 132) == want


# K7's column tile and blocks per (supernode, chain) at the same shapes, for 1, 8 and 65 right-hand sides, on a card
# of 132 SMs: 64 columns only where 64 of them fit shared memory (W <= 128) and 8-column blocks would put 8 or more
# on every SM (units x 9 >= 1056 at k=65)
@pytest.mark.parametrize("W, M, units, want", [
    (512, 0, 4, ((8, 1), (8, 1), (8, 9))),
    (128, 512, 4, ((8, 1), (8, 1), (8, 9))),
    (64, 256, 12, ((8, 1), (8, 1), (8, 9))),
    (16, 128, 296, ((8, 1), (8, 1), (64, 2))),
    (8, 64, 156, ((8, 1), (8, 1), (64, 2))),
])
def test_trsv_launch_picks_its_tile(W, M, units, want):
    assert tuple(kernels.supernodal.trsv_launch(W, k, units, 132) for k in (1, 8, 65)) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("k", [1, 3])
def test_panel_and_trsv_yardsticks_match_the_plain_factor(matern24, k):
    # chip_smoke.py's library yardsticks of K6 (cholesky_ex of the densified, permuted, equilibrated matrix, then
    # the gather onto L's pattern) and K7 (cholesky_solve on the densified factor, permuted and scaled) against
    # the plain factorization and its solve, all four chains (the fourth one's Q is not symmetric)
    cs = _chip_smoke()
    Q = SparseMatrix(_t(matern24["data"]), _port_pattern(matern24["pattern"]))
    f = tsn.supernodal_factorize(Q)
    assert _rel(cs.k6_library(Q, f.meta)().numpy(), f.vals[:, :-1].numpy()) <= RTOL
    b = _t(np.random.default_rng(7).normal(size=(4, Q.shape[0], k) if k > 1 else (4, Q.shape[0])))
    assert _rel(cs.k7_library(f, b)().numpy(), f.solve(b).numpy()) <= RTOL


def test_launch_descriptors_lay_out_a_level():
    # K6 and K7 take a level's class batches in one launch: their table gives each batch its first block (the
    # supernodes before it) and, on K6's cluster path, the offset of its workspace (its values per supernode over
    # all chains times the supernodes before it); ubase / fbase are the batches' own
    level = [dict(panel=torch.zeros(P, W + M, W, dtype=torch.int32), cols=torch.zeros(P, W, dtype=torch.int32),
                  rows=torch.zeros(P, M, dtype=torch.int32), W=W, M=M, ubase=ub, fbase=fb)
             for W, M, P, ub, fb in ((16, 128, 3, 0, 0), (32, 256, 2, 3 * 128**2, 3 * 128), (128, 512, 1, 7, 9))]
    slices = [4 * kernels.supernodal._panel_slice(c["W"], c["M"]) for c in level]
    got = kernels.supernodal._descriptors(level, "cpu", slices).numpy()
    assert got.shape == (3, 10)
    assert [list(r[3:9]) for r in got] == [[16, 128, 3, 0, 0, 0], [32, 256, 2, 3, 3 * 128**2, 3 * 128],
                                          [128, 512, 1, 5, 7, 9]]
    assert list(got[:, 9]) == [0, 3 * slices[0], 3 * slices[0] + 2 * slices[1]]
    assert list(got[:, 0]) == [c["panel"].data_ptr() for c in level]
    # (W + M) x W float64 panel in 64-column tiles, then one inverted 64 x 64 tile per column tile
    assert kernels.supernodal._panel_slice(128, 512) == (128 + 512) * 128 + 2 * 64 * 64
    assert kernels.supernodal._panel_slice(16, 128) == (64 + 128) * 64 + 64 * 64


@pytest.mark.parametrize("g,max_width", [(24, 2048), (12, 16)])
def test_panel_columns_are_consecutive_in_vals(g, max_width):
    # K6 and K7 read L(r, c) at base[c] + r - c: a live column of a panel runs down consecutive positions of vals
    # from its diagonal through the rows below (CSC), whatever the class batch and level
    model = JaxMatern(_grid(g), smoothness=1)
    Q = SparseMatrix(_t(np.asarray(model.precision(tau=1.0, range=0.25).data)),
                     _port_pattern(model.precision(tau=1.0, range=0.25).pattern))
    f = tsn.supernodal_factorize(Q, max_width=max_width)
    seen = 0
    for lv in tsn._device_plan(f.meta, torch.device("cpu"))["levels"]:
        for c in lv.classes:
            W, pan = c["W"], c["panel"].numpy()
            for p in range(pan.shape[0]):
                ns = int((pan[p, np.arange(W), np.arange(W)] != c["dummy"]).sum())
                m = int((pan[p, W:, 0] != c["dummy"]).sum()) if c["M"] else 0
                for col in range(ns):
                    run = np.concatenate([pan[p, col:ns, col], pan[p, W:W + m, col]])
                    assert np.array_equal(run, pan[p, col, col] + np.arange(len(run)))
                seen += ns > 0
    assert seen == tsn._PLAN_CACHE[f.meta]["nsuper"]
