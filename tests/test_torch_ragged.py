"""K5's one-launch plans and K10's tile solve, in their plain versions as CPU
tensors take them: a supernodal level's two ELL tiers as one ragged plan
against the two-tier application of the host plan, the one-row sums against
a float64 NumPy sum, the row runs of a plan and its long rows' chunks,
K10's cluster rule and its need of K9's tiles, and the dense factor's three
solve modes against
`tpu_gmrf.solvers.dense` at several right-hand sides.

Tolerances: the ragged plans add a target's two tiers in turn as the tiers
did, and NumPy sums a tier's row in its own order (pairwise from 8 terms);
the one-row sums sum in another order than NumPy: 1e-13 relative (float64).
A row's two parts against a sequential loop, in float32 on the short rows
and in float64 rounded once on the long ones: equal on every row. The dense solves: 1e-10 relative, as in
test_torch_dense_banded.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_gmrf.solvers import dense as jd
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels, set_default_device
from tpu_gmrf_torch.kernels import dense as kd
from tpu_gmrf_torch.kernels.segsum import BLOCK_TERMS, CHUNK_TERMS
from tpu_gmrf_torch.solvers import supernodal as sn
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors)
set_default_device("cpu")

F64 = torch.float64
CPU = torch.device("cpu")


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


# ---- K5: a level's two ELL tiers as one ragged plan -----------------------------------


def _tiers(plan):
    """Per level of the schedule (scan segments, then the top levels): the Schur
    and forward ELL tiers [(t, s), ...] of the host plan, and the dummy
    targets."""
    n, nnzL = plan["n"], plan["nnzL"]
    out = []
    for seg in plan["segments"]:
        for lev in range(seg["hi"] - seg["lo"]):
            out.append({nm: None if seg[nm] is None else
                        [(seg[nm][f"t{i}"][lev], seg[nm][f"s{i}"][lev]) for i in (1, 2)]
                        for nm in ("schur", "fwd")})
    for se, fe in zip(plan["top_schur_ells"], plan["top_fwd_ells"]):
        out.append({"schur": [(se["t1"], se["s1"]), (se["t2"], se["s2"])],
                    "fwd": [(fe["t1"], fe["s1"]), (fe["t2"], fe["s2"])]})
    return out, {"schur": nnzL, "fwd": n}


def _two_tier(out, u, tiers, dummy):
    """out[:, t] -= Σ_w u[:, s[t, w]] per tier, tier 1 then tier 2: the reference's application."""
    out = out.copy()
    for t, s in tiers:
        live = t != dummy
        out[:, t[live]] -= u[:, s[live]].sum(-1)
    return out


@pytest.mark.parametrize("g, max_width", [(24, 2048), (24, 16), (12, 2048)])
def test_ragged_level_plans_equal_the_two_tier_application(g, max_width):
    model = tg.MaternModel(_grid(g), smoothness=1)
    Q = model.precision(tau=torch.tensor(1.0, dtype=F64), range=torch.tensor(0.3, dtype=F64))
    plan = sn.supernodal_plan(Q.pattern, max_width, "auto")
    levels = sn._device_plan((Q.pattern, max_width, "auto"), CPU)["levels"]
    tiers, dummy = _tiers(plan)
    assert len(tiers) == len(levels)
    two = sum(1 for lv in tiers for nm in ("schur", "fwd") if lv[nm] is not None
              and (lv[nm][1][0] != dummy[nm]).any())
    assert two > 0, "the mesh's plan must hold a level with two tiers"
    rng = np.random.default_rng(g)
    width = {"schur": plan["nnzL"] + 1, "fwd": plan["n"] + 1}
    for lv, host in zip(levels, tiers):
        for nm, size in (("schur", lv.zu), ("fwd", lv.zf)):
            plans = getattr(lv, nm)
            assert len(plans) <= 1  # one launch per level and reduction
            if host[nm] is None or not any((t != dummy[nm]).any() for t, _ in host[nm]):
                assert plans == []
                continue
            (p,) = plans
            assert len(np.unique(p.t)) == p.rows  # unique targets: no write races, no atomics
            u = rng.normal(size=(3, size + 1))
            u[:, size] = 0.0  # the zero slot the tiers' padding reads
            out0 = rng.normal(size=(3, width[nm]))
            got = kernels.gather_segsum_plain(p, _t(u), out=_t(out0), alpha=-1.0, accumulate=True)
            assert _rel(got.numpy(), _two_tier(out0, u, host[nm], dummy[nm])) <= 1e-13


def test_factorization_and_solve_launch_counts():
    """K5's launches per factorization (a Schur plan per level with updates, and
    the logdet's one) and per solve (the permutation, a forward plan per level
    with updates, the unpermutation), from the device plan of the g=24 mesh,
    against the tiers' count (a launch per live tier, and the logdet's two)."""
    model = tg.MaternModel(_grid(24), smoothness=1)
    Q = model.precision(tau=torch.tensor(1.0, dtype=F64), range=torch.tensor(0.3, dtype=F64))
    plan = sn.supernodal_plan(Q.pattern, 2048, "auto")
    dp = sn._device_plan((Q.pattern, 2048, "auto"), CPU)
    tiers, dummy = _tiers(plan)
    live = {nm: [sum(1 for t, _ in lv[nm] if (t != dummy[nm]).any()) if lv[nm] else 0 for lv in tiers]
            for nm in ("schur", "fwd")}
    factor = sum(len(lv.schur) for lv in dp["levels"]) + 1
    solve = sum(len(lv.fwd) for lv in dp["levels"]) + 2
    assert factor == sum(c > 0 for c in live["schur"]) + 1 < sum(live["schur"]) + 2
    assert solve == sum(c > 0 for c in live["fwd"]) + 2 <= sum(live["fwd"]) + 2
    assert dp["logdet"].rows == 1 and dp["logdet"].r_block == 0  # one row, on a block


# ---- K5: one-row sums and the row runs ------------------------------------------------


@pytest.mark.parametrize("dot", [False, True])
@pytest.mark.parametrize("m", [1, 31, 32, BLOCK_TERMS - 1, BLOCK_TERMS, 11482])
def test_one_row_sum_plan_equals_numpy(m, dot):
    plan = sn._sum_plan(m, dot)
    assert plan.rows == 1 and plan.r_block == int(m < BLOCK_TERMS)
    rng = np.random.default_rng(m)
    x, y = rng.normal(size=(5, m)), rng.normal(size=(5, m))
    got = kernels.gather_segsum(plan, _t(x), y=_t(y) if dot else None)[:, 0].numpy()
    ref = (x * y if dot else x).sum(-1)
    assert _rel(got, ref) <= 1e-13


@pytest.mark.parametrize("targets", [False, True])
def test_plan_sorts_rows_into_runs(targets):
    """Rows of 3, 300, 1, 2000, 0, 256 and 5 terms: the thread rows first, then
    the block rows, each run in its given order, the targets carried along;
    the sums as given."""
    lengths = [3, 300, 1, 2000, 0, BLOCK_TERMS, 5]
    rng = np.random.default_rng(5)
    ptr = np.concatenate([[0], np.cumsum(lengths)])
    m, R = int(ptr[-1]), len(lengths)
    xi, yi, zi = (rng.integers(0, 50, size=m) for _ in range(3))
    t = rng.permutation(20)[:R] if targets else None
    plan = kernels.SegPlan(xi, ptr=ptr, yi=yi, zi=zi, t=t)
    assert plan.r_block == 4 and plan.full == (not targets)
    assert list(np.diff(plan.ptr)) == [3, 1, 0, 5, 300, 2000, BLOCK_TERMS]
    x, y = rng.normal(size=(3, 50)), rng.normal(size=50)  # y shared by the chains
    z = rng.normal(size=(3, 50))
    rows = np.repeat(np.arange(R), lengths)
    sums = np.zeros((3, R))
    np.add.at(sums.T, rows, (x[:, xi] * y[yi] * z[:, zi]).T)
    tgt = np.arange(R) if t is None else t
    out0 = rng.normal(size=(3, 20))
    got = kernels.gather_segsum(plan, _t(x), y=_t(y), z=_t(z), out=_t(out0), alpha=0.5, accumulate=True)
    ref = out0.copy()
    ref[:, tgt] += 0.5 * sums
    assert _rel(got.numpy(), ref) <= 1e-13


@pytest.mark.parametrize("accumulate", [False, True])
def test_split_rows_add_their_parts_in_turn(accumulate):
    """A row's first split[r] terms and the rest are two sums added in turn,
    (out + alpha Σ₁) + alpha Σ₂, bit for bit in float32: on the short rows
    each part summed in order in float32, on the long rows (400 and 1500
    terms) in float64, rounded once."""
    lengths, split = [3, 400, 2, 1500, 4], [1, 333, 2, 700, 0]
    rng = np.random.default_rng(8)
    ptr = np.concatenate([[0], np.cumsum(lengths)])
    xi = rng.integers(0, 30, size=int(ptr[-1]))
    t = np.array([7, 0, 3, 9, 5])
    plan = kernels.SegPlan(xi, ptr=ptr, t=t, split=split)
    x = rng.normal(size=(2, 30)).astype(np.float32)
    out0 = rng.normal(size=(2, 10)).astype(np.float32)
    ref = out0.copy() if accumulate else np.zeros_like(out0)
    for r, (a, m, e) in enumerate(zip(ptr[:-1], ptr[:-1] + np.array(split), ptr[1:])):
        for lo, hi in ((a, m), (m, e)):
            acc = np.zeros(2, np.float64 if lengths[r] >= BLOCK_TERMS else np.float32)
            for k in range(lo, hi):
                acc = acc + x[:, xi[k]].astype(acc.dtype)
            ref[:, t[r]] = ref[:, t[r]] + np.float32(-0.5) * acc.astype(np.float32)
    got = kernels.gather_segsum(plan, _t(x, torch.float32), out=_t(out0, torch.float32), alpha=-0.5,
                                accumulate=accumulate).numpy()
    np.testing.assert_array_equal(got[:, t], ref[:, t])
    untouched = np.setdiff1d(np.arange(10), t)
    np.testing.assert_array_equal(got[:, untouched], out0[:, untouched])
    with pytest.raises(ValueError, match="split"):
        kernels.SegPlan(xi, ptr=ptr, split=[4, 0, 0, 0, 0])


@pytest.mark.parametrize("split", [False, True])
def test_long_rows_are_cut_into_chunks_of_one_part(split):
    """The kernel's chunks of the long rows (400, 5000 and 256 terms; the
    short rows none): at most CHUNK_TERMS terms each, in order, tiling each
    part of each long row; `cptr` and `cmid` bound each row's chunks and its
    second part's."""
    lengths = [3, 400, 2, 5000, 4, BLOCK_TERMS]
    parts = [0, 133, 0, 4097, 0, 0] if split else None
    ptr = np.concatenate([[0], np.cumsum(lengths)])
    plan = kernels.SegPlan(np.zeros(int(ptr[-1]), np.int32), ptr=ptr, split=parts)
    assert plan.r_block == 3 and plan.chunks == len(plan.crow) == len(plan.ck) - 1
    for j, r in enumerate(range(plan.r_block, plan.rows)):
        a, e = int(plan.ptr[r]), int(plan.ptr[r + 1])
        m = e if plan.mid is None else int(plan.mid[r])
        c0, c2 = int(plan.cptr[j]), int(plan.cptr[j + 1])
        c1 = c2 if plan.cmid is None else int(plan.cmid[j])
        assert (plan.crow[c0:c2] == j).all()
        for lo, hi, first, stop in ((a, m, c0, c1), (m, e, c1, c2)):
            want = list(range(lo, hi, CHUNK_TERMS))
            assert list(plan.ck[first:stop]) == want
            assert stop - first == len(want)
    assert np.diff(plan.ck).max() <= CHUNK_TERMS and plan.ck[-1] == ptr[-1]
    assert (plan.cmid is None) == (not split)


def test_gather_segsum_checks_lengths_against_the_plan():
    plan = kernels.SegPlan([0, 4, 2], ptr=[0, 2, 3], t=[5, 1])
    with pytest.raises(ValueError, match="out must be"):
        kernels.gather_segsum(plan, _t(np.ones((2, 5))), out=_t(np.zeros((2, 5))))
    with pytest.raises(ValueError, match="m >= 5"):
        kernels.gather_segsum(plan, _t(np.ones((2, 4))), out=_t(np.zeros((2, 6))))
    with pytest.raises(ValueError, match="need an output"):
        kernels.gather_segsum(plan, _t(np.ones((2, 5))))


# ---- K10 ---------------------------------------------------------------------------------


def _held(per_sm):
    """Clusters of cs blocks a card of 132 SMs holds at once with per_sm blocks on an SM (0 above 16)."""
    return lambda cs: per_sm * 132 // cs if cs <= 16 else 0


@pytest.mark.parametrize("n, clusters, want", [
    (450, 8, 8),  # phases 3c and 10: eight chains, k=1: a block per row tile
    (450, 16, 8),  # k=65: two groups of 64 right-hand sides per chain
    (450, 64, 6),  # dense_selinv at n=450, B=8: eight groups per chain, one wave of clusters of 6
    (1000, 1, 16),  # phase 16's shape: one chain, the largest cluster
    (4096, 1, 16),  # DENSE_MAX_N: four row tiles per block
    (100, 8, 2),  # two row tiles: at most two blocks
    (64, 8, 1),  # one row tile: one block
])
def test_trsv_cluster_at_most_a_block_per_row_tile(n, clusters, want):
    assert kd.trsv_cluster(n, clusters, _held(3)) == want


def test_dense_trsv_on_the_card_needs_the_tiles():
    L, n = torch.eye(130, dtype=F64)[None], 130
    with pytest.raises(ValueError, match="Dinv"):
        kd._check_tiles("dense_trsv", L, None)
    with pytest.raises(ValueError, match="Dinv must be"):
        kd._check_tiles("dense_trsv", L, torch.zeros(1, 2 * 64 * 64, dtype=F64))
    kd._check_tiles("dense_trsv", L, torch.zeros(1, -(-n // 64) * 64 * 64, dtype=F64))


@pytest.fixture(scope="module")
def dense130():
    """Two SPD matrices of n = 130 (three 64-row tiles) on one random pattern."""
    n = 130
    A = sp.random(n, n, density=0.05, random_state=np.random.RandomState(4))
    A = (A + A.T + sp.eye(n) * 12.0).tocoo()
    order = np.lexsort((A.col, A.row))
    rows, cols, vals = A.row[order], A.col[order], A.data[order]
    data = np.stack([vals, vals * (1.0 + 0.1 * (rows == cols))])
    return rows, cols, (n, n), data


@pytest.mark.parametrize("k", [1, 8, 65])
def test_dense_factor_modes_match_reference(dense130, k):
    rows, cols, shape, data = dense130
    b = np.random.default_rng(k).normal(size=(2, shape[0], k))
    jp = JP(rows, cols, shape)

    def one(d, rhs):
        f = jd.dense_factorize(JSM(d, jp))
        return f.solve(rhs), f.forward_solve(rhs), f.backward_solve(rhs)

    ref = [np.asarray(r) for r in jax.jit(jax.vmap(one))(jnp.asarray(data), jnp.asarray(b))]
    f = tg.factorize(SparseMatrix(_t(data), SparsePattern(rows, cols, shape)), tg.SolverSpec(kind="dense"))
    assert f.Dinv is None  # CPU tensors: the plain version, no tiles
    bt = _t(b)
    for got, want in zip((f.solve(bt), f.forward_solve(bt), f.backward_solve(bt)), ref):
        assert _rel(got.numpy(), want) <= 1e-10
