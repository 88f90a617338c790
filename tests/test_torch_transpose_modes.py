"""The transpose products Lᵀz of the supernodal and banded factors: K7's mode 3
(`sn_multiply_t`, one launch over the whole level schedule) and K13's transpose
mode (`bt_sqrt_t`, a cluster of row slabs per column tile). On the CPU their
wrappers take the plain versions; these tests hold what surrounds the kernels,
against the JAX package in float64 on the same NumPy inputs:

* the whole-schedule unit table of K7's mode 3 (`multiply_t_units`): its
  units deal out every live column of L exactly once and no padded slot, the
  deepest first;
* `sn_multiply_plain(transpose=True)` over the merged table equals the loop
  over the levels bit for bit (no supernode of the product waits for another),
  and so does `sn_multiply_t` on CPU tensors;
* `SupernodalFactor._tri(TRI_LT, ·)` on a g=8 Matérn posterior and the banded
  `_tri(TRI_LT, ·)` on an AR1 ⊗ AR1 space-time posterior, which auto resolves
  to banded (a plain AR1 is tridiagonal and resolves to tridiag), against
  `jax.vjp` of the reference's `sqrt_matvec` at k = 1 and 16: 1e-12 normwise,
  the rounding of products of at most a few hundred terms taken in another
  order (the factors themselves agree to ~1e-15);
* the launch-shape functions partition the work over a sweep of shapes:
  `sqrt_t_slabs` reads every entry of [L_k; M_k] on or below L_k's diagonal
  once and no row twice, `sqrt_t_launch` keeps a cluster within 4 slabs and
  shared memory at every s (up to 6000 here), and K7's units cover every
  live (supernode, 64-column tile) of random class batches once.

The reference's two factors and their vjps come from one ``jax.jit`` call,
made once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf as jg
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels
from tpu_gmrf_torch.kernels import banded as kb
from tpu_gmrf_torch.kernels import supernodal as ks
from tpu_gmrf_torch.solvers import supernodal as sn
from tpu_gmrf_torch.solvers.base import TRI_LT
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")

F64 = torch.float64
TOL = 1e-12
KS = (1, 16)
SPEC = {"supernodal": dict(kind="supernodal"), "banded": dict(kind="auto", dense_max=16)}


def _grid(g):
    gx, gy = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    return np.stack([gx.ravel(), gy.ravel()], axis=1)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _ar1(n, rho):
    return sp.diags([np.r_[1.0, np.full(n - 2, 1 + rho**2), 1.0], np.full(n - 1, -rho), np.full(n - 1, -rho)],
                    [0, -1, 1])


@functools.lru_cache(maxsize=None)
def _case(kind):
    """(rows, cols, n, data) of a posterior-like Q (the prior plus a random
    positive diagonal): the Matérn prior on the g=8 grid's mesh (supernodal),
    or AR1(8) ⊗ AR1(6) (banded, by auto)."""
    rng = np.random.default_rng(61)
    if kind == "supernodal":
        model = tg.MaternModel(_grid(8), smoothness=1)
        Q = model.precision(tau=torch.tensor(1.0, dtype=F64), range=torch.tensor(0.3, dtype=F64))
        rows, cols, d = Q.pattern.rows, Q.pattern.cols, Q.data.numpy()
    else:
        A = sp.kron(_ar1(8, 0.7), _ar1(6, 0.5)).tocoo()
        pat = JP(A.row, A.col, A.shape)
        rows, cols, d = pat.rows, pat.cols, np.asarray(A.data)[pat.sort_order]
    n = int(max(rows.max(), cols.max())) + 1
    d = d + np.where(rows == cols, np.exp(rng.normal(size=len(d))), 0.0)
    return np.asarray(rows), np.asarray(cols), n, d


@functools.lru_cache(maxsize=None)
def _inputs(kind):
    _, _, n, _ = _case(kind)
    rng = np.random.default_rng(62)
    return {k: rng.normal(size=(n, k)) for k in KS}


@functools.lru_cache(maxsize=None)
def _reference():
    """Lᵀw of both cases at both k: jax.vjp of the reference's sqrt_matvec, one jitted call."""
    pats = {kind: JP(*_case(kind)[:2], (_case(kind)[2],) * 2) for kind in SPEC}

    def everything(data, ws):
        out = {}
        for kind, pat in pats.items():
            fac = jg.factorize(JSM(data[kind], pat), jg.SolverSpec(**SPEC[kind]))
            out[kind] = {}
            for k, w in ws[kind].items():
                f = jax.vmap(fac.sqrt_matvec, in_axes=1, out_axes=1)
                out[kind][k] = jax.vjp(f, jnp.zeros_like(w))[1](w)[0]
        return out

    data = {kind: jnp.asarray(_case(kind)[3]) for kind in SPEC}
    ws = {kind: {k: jnp.asarray(a) for k, a in _inputs(kind).items()} for kind in SPEC}
    got = jax.jit(everything)(data, ws)
    return {kind: {k: np.asarray(a) for k, a in v.items()} for kind, v in got.items()}


@functools.lru_cache(maxsize=None)
def _factor(kind):
    rows, cols, n, d = _case(kind)
    Q = SparseMatrix(torch.tensor(d, dtype=F64), SparsePattern(rows, cols, (n, n)))
    return tg.factorize(Q, tg.SolverSpec(**SPEC[kind]))


def test_auto_resolves_the_space_time_case_to_banded():
    assert type(_factor("banded")).__name__ == "BandedFactor"
    assert type(_factor("supernodal")).__name__ == "SupernodalFactor"


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", list(SPEC))
def test_tri_lt_matches_the_reference_vjp(kind, k):
    got = _factor(kind)._tri(TRI_LT, torch.tensor(_inputs(kind)[k], dtype=F64))
    assert _rel(got.numpy(), _reference()[kind][k]) <= TOL


def _schedule():
    f = _factor("supernodal")
    return f, sn._device_plan(f.meta, torch.device("cpu"))


def test_merged_schedule_equals_the_level_loop_bit_for_bit():
    f, dp = _schedule()
    n, k = f.n, 16
    rng = np.random.default_rng(63)
    z = torch.tensor(rng.normal(size=(k, n + 1)), dtype=F64)
    z[:, n] = 0.0
    levels = torch.zeros_like(z)
    for lv in dp["levels"]:
        kernels.sn_multiply_plain(f.vals, lv.group, levels, z, None, k, transpose=True)
    merged = torch.zeros_like(z)
    kernels.sn_multiply_plain(f.vals, dp["schedule"], merged, z, None, k, transpose=True)
    assert torch.equal(merged, levels)
    kernels.reset_launches()
    wrapped = torch.zeros_like(z)
    kernels.sn_multiply_t(f.vals, dp["schedule"], wrapped, z, k)
    assert torch.equal(wrapped, levels)
    assert kernels.launches()["sn_multiply_t"] == 0  # CPU tensors


def test_multiply_t_units_cover_every_live_column_once():
    f, dp = _schedule()
    classes = dp["schedule"]["classes"]
    live = [ks._live_dims(c) for c in classes]
    units = ks.multiply_t_units(live)
    depth = units[:, 3] + units[:, 4] - units[:, 2]
    assert (np.diff(depth) <= 0).all()  # the deepest units first
    seen = []
    for g, p, j0, ns, m, *_ in units.tolist():
        assert (ns, m) == (live[g][0][p], live[g][1][p]) and 0 <= j0 < ns
        cols = classes[g]["cols"][p, j0:min(j0 + ks.K8_TILE, ns)].numpy()
        rows = classes[g]["rows"][p, :m].numpy()
        assert (cols != classes[g]["ndummy"]).all() and (rows != classes[g]["ndummy"]).all()
        assert (classes[g]["cols"][p, ns:].numpy() == classes[g]["ndummy"]).all()  # the rest is padding
        seen.extend(cols.tolist())
    assert sorted(seen) == list(range(f.n))  # every column of the permuted factor, once


@pytest.mark.parametrize("seed", range(4))
def test_multiply_t_units_partition_random_batches(seed):
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(int(rng.integers(1, 50))):
        W, P = int(rng.choice([1, 4, 8, 16, 64, 65, 128, 200, 512, 1024])), int(rng.integers(1, 40))
        live.append((rng.integers(1, W + 1, size=P), rng.integers(0, 1025, size=P)))
    units = ks.multiply_t_units(live)
    got = [tuple(u[:3]) for u in units.tolist()]
    want = [(g, p, j0) for g, (ns, _) in enumerate(live) for p in range(len(ns)) for j0 in range(0, ns[p], 64)]
    assert sorted(got) == sorted(want) and len(set(got)) == len(got)
    assert (np.diff(units[:, 3] + units[:, 4] - units[:, 2]) <= 0).all()
    for k in (1, 7, 8, 9, 16, 17, 65):
        nb, chunks = ks.multiply_t_chunks(k)
        assert nb in (1, 2) and (chunks - 1) * 8 * nb < k <= chunks * 8 * nb and (k > 16 or chunks == 1)


@pytest.mark.parametrize("s,K", [(1, 1), (5, 3), (64, 2), (91, 4), (96, 3), (450, 2), (512, 3), (768, 2), (1100, 2),
                                 (2600, 2), (3000, 2), (6000, 1)])
def test_sqrt_t_slabs_partition_the_factor(s, K):
    for k in (1, 3, 8, 16, 40):
        for el in (4, 8):
            R, cs, nv, ws = kb.sqrt_t_launch(s, k, el, lambda *a: 1)
            rows = kb.sqrt_t_rows(el)
            assert R % rows == 0 and cs == -(-2 * s // R) <= kb.SQT_CLUSTER
            assert kb.sqrt_t_smem(nv, el, ws) <= kb.SMEM_MAX and nv in (1, 4, 8, 16) and (nv >= k or nv == 16)
            assert 1 <= ws <= R // rows and (ws == R // rows or ws * rows * nv * el == kb.SQT_WINDOW_BYTES)
    read = {}
    for kk, j0, r0, lo, rows in kb.sqrt_t_slabs(s, K, R):
        assert r0 <= lo and lo + rows <= r0 + R and rows > 0
        read.setdefault((kk, j0), []).append((lo, lo + rows))
    for kk in range(K):
        rmax = 2 * s if kk < K - 1 else s  # the last block has no M
        for j0 in range(0, s, kb.SQT_COLS):  # a column tile: rows of [L_k; M_k] by its columns
            r, j = np.meshgrid(np.arange(2 * s), np.arange(j0, min(j0 + kb.SQT_COLS, s)), indexing="ij")
            need = ((r >= s) | (r >= j)) & (r < rmax)  # L_k's lower triangle, all of M_k
            count = np.zeros_like(r)
            for lo, hi in read.get((kk, j0), []):
                count += (r >= lo) & (r < hi)
            assert np.array_equal(count[need], np.ones(need.sum(), count.dtype))  # each needed entry read once
            assert count.max() <= 1  # no row read twice
