"""The port's KL sparse Cholesky (`approximate_gmrf_kl`, K16 `kl_columns`)
and graphical lasso (`graphical_lasso`, K17 `block_inv` + K5) against the
JAX package in float64 on the same NumPy inputs.

Host tables (orderings, ℓ, patterns, buckets, covers, cliques, separators,
embedding positions) are equal exactly. Values: L's data and Q within 1e-10
relative (normwise), the graphical lasso's Q within 1e-10: both sides are
exact up to the rounding order of their Choleskys and inverses. The plain
versions are also held against NumPy oracles column by column and block by
block.
"""

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import tpu_gmrf.graphical_lasso  # noqa: F401  (the package exports a function of the same name)
from tpu_gmrf import kl_cholesky as jkl
from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels
from tpu_gmrf_torch import kl_cholesky as tkl
from tpu_gmrf_torch.graphical_lasso import chordal_cover, embed_plan, soft_threshold_cov
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")
jgl = sys.modules["tpu_gmrf.graphical_lasso"]

F64 = torch.float64
RHOS = (1.5, 3.0, 6.0)


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _matern32_jax(a, b, ell=0.3):
    r = jnp.sqrt(jnp.sum((a - b) ** 2) + 1e-12)
    s = jnp.sqrt(3.0) * r / ell
    return (1.0 + s) * jnp.exp(-s)


def _matern32_torch(a, b, ell=0.3):
    r = torch.sqrt(torch.sum((a - b) ** 2) + 1e-12)
    s = 3.0**0.5 * r / ell
    return (1.0 + s) * torch.exp(-s)


def _points(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, 2))


_REF: dict = {}


def _kl_reference(rho):
    """The reference's ordering, pattern, L (with the padded points its
    cov_fn was called on) and GMRF at 40 points (computed once per ρ: the
    JAX package compiles every bucket shape anew)."""
    if rho not in _REF:
        X = _points(40)
        calls = []

        def cov(P1, P2):
            calls.append(np.asarray(P1))
            return jkl.gram(_matern32_jax)(P1, P2)

        order, ell = jkl.reverse_maximin_ordering(X)
        pat = jkl.sparsity_pattern_from_ordering(X, order, ell, rho)
        L = jkl.sparse_approximate_cholesky(X, cov, pat, order, 1e-8)
        g = jkl.approximate_gmrf_kl(X, jkl.gram(_matern32_jax), rho=rho, jitter=1e-8)
        _REF[rho] = dict(X=X, order=order, ell=ell, pat=pat, calls=calls, L=np.asarray(L.data), g=g)
    return _REF[rho]


# ---- KL: host tables ---------------------------------------------------------------


@pytest.mark.parametrize("n", [30, 80])
def test_maximin_ordering_and_patterns_equal(n):
    X = _points(n, seed=n)
    order, ell = tkl.reverse_maximin_ordering(X)
    order_j, ell_j = jkl.reverse_maximin_ordering(X)
    assert np.array_equal(order, order_j) and np.array_equal(ell, ell_j)
    for rho in RHOS:
        p = tkl.sparsity_pattern_from_ordering(X, order, ell, rho)
        pj = jkl.sparsity_pattern_from_ordering(X, order_j, ell_j, rho)
        assert p.shape == pj.shape
        assert np.array_equal(p.rows, pj.rows) and np.array_equal(p.cols, pj.cols)


@pytest.mark.parametrize("rho", RHOS)
def test_buckets_equal_the_points_the_reference_covariance_sees(rho):
    ref = _kl_reference(rho)
    p = SparsePattern(ref["pat"].rows, ref["pat"].cols, ref["pat"].shape)
    buckets = tkl.kl_buckets(p)
    X = ref["X"][ref["order"]]
    assert len(buckets) == len(ref["calls"])
    for (cap, cols, S_idx, entry_pos, count), pts in zip(buckets, ref["calls"]):
        assert S_idx.shape == (len(cols), cap)
        assert np.array_equal(X[S_idx], pts)  # padding is point 0, as in the reference
        assert np.array_equal(count, (entry_pos >= 0).sum(1))
        assert np.all(entry_pos[:, :cap][np.arange(cap)[None, :] < (cap - count)[:, None]] == -1)
    # every entry of L belongs to exactly one column
    pos = np.concatenate([e[e >= 0] for *_, e, _ in buckets])
    assert np.array_equal(np.sort(pos), np.arange(p.nnz))


# ---- KL: values ------------------------------------------------------------------------


@pytest.mark.parametrize("rho", RHOS)
def test_kl_factor_and_precision_match_reference(rho):
    ref = _kl_reference(rho)
    p = SparsePattern(ref["pat"].rows, ref["pat"].cols, ref["pat"].shape)
    L = tkl.sparse_approximate_cholesky(ref["X"], tkl.gram(_matern32_torch), p, ref["order"], 1e-8)
    assert _rel(L.data, ref["L"]) <= 1e-10
    g = tkl.approximate_gmrf_kl(ref["X"], tkl.gram(_matern32_torch), rho=rho, jitter=1e-8)
    gj = ref["g"]
    assert np.array_equal(g.Q.pattern.rows, gj.Q.pattern.rows)
    assert np.array_equal(g.Q.pattern.cols, gj.Q.pattern.cols)
    assert _rel(g.Q.data, gj.Q.data) <= 1e-10
    assert abs(float(g.logdet_precision()) / float(gj.logdet_precision()) - 1) <= 1e-10
    assert torch.equal(g.mean, torch.zeros(40, dtype=F64))


def test_approximate_gmrf_kl_statistics_match_reference():
    ref = _kl_reference(3.0)
    g = tkl.approximate_gmrf_kl(torch.tensor(ref["X"]), tkl.gram(_matern32_torch), rho=3.0, jitter=1e-8,
                                mean=np.linspace(-1, 1, 40))
    gj = jkl.approximate_gmrf_kl(ref["X"], jkl.gram(_matern32_jax), rho=3.0, jitter=1e-8,
                                 mean=np.linspace(-1, 1, 40))
    assert _rel(g.var(), gj.var()) <= 1e-10
    x = np.random.default_rng(3).normal(size=40)
    assert abs(float(g.logpdf(torch.tensor(x))) / float(gj.logpdf(jnp.asarray(x))) - 1) <= 1e-10


def test_gram_matches_reference():
    P = np.random.default_rng(4).uniform(size=(3, 5, 2))
    got = tkl.gram(_matern32_torch)(torch.tensor(P), torch.tensor(P))
    ref = jkl.gram(_matern32_jax)(jnp.asarray(P), jnp.asarray(P))
    assert got.shape == (3, 5, 5)
    assert _rel(got, ref) <= 1e-14


# ---- K16's plain version ---------------------------------------------------------------


def _kl_oracle(theta, count, jitter):
    """Per column: A = sym(Θ_valid) + jitter·I = L Lᵀ, x = L⁻ᵀ e_last (NumPy)."""
    B, cap = theta.shape[:2]
    out = np.full((B, cap), np.nan)
    for b in range(B):
        N = int(count[b])
        T = theta[b, cap - N:, cap - N:]
        A = 0.5 * (T + T.T) + jitter * np.eye(N)
        try:
            L = np.linalg.cholesky(A)
        except np.linalg.LinAlgError:
            continue
        e = np.zeros(N)
        e[-1] = 1.0
        out[b, cap - N:] = np.linalg.solve(L.T, e)
    return out


def test_kl_columns_plain_against_numpy_oracle():
    rng = np.random.default_rng(5)
    B, cap = 6, 8
    count = np.array([8, 5, 1, 3, 8, 6])
    theta = np.full((B, cap, cap), np.nan)  # NaN on the padding must not poison a column
    for b in range(B):
        N = count[b]
        G = rng.normal(size=(N, N + 2))
        S = G @ G.T / (N + 2) + 0.1 * np.eye(N)
        theta[b, cap - N:, cap - N:] = S + 1e-9 * rng.normal(size=(N, N))  # slightly non-symmetric
    theta[4, -1, -1] = -5.0  # this column breaks down
    entry_pos = np.full((B, cap), -1)
    nxt = 0
    for b in range(B):
        entry_pos[b, cap - count[b]:] = np.arange(nxt, nxt + count[b])
        nxt += count[b]
    out = torch.zeros(nxt, dtype=F64)
    got = kernels.kl_columns(torch.tensor(theta), torch.tensor(count, dtype=torch.int32),
                             torch.tensor(entry_pos, dtype=torch.int32), 1e-6, out)
    ref = _kl_oracle(theta, count, 1e-6)
    want = np.concatenate([ref[b, cap - count[b]:] for b in range(B)])
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(got.numpy()[entry_pos[4, cap - 8:]]).all()  # the whole column
    ok = ~np.isnan(want)
    assert _rel(got.numpy()[ok], want[ok]) <= 1e-12


def test_kl_columns_forward_only_and_paths():
    theta = torch.eye(4, dtype=F64).expand(2, 4, 4).clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        kernels.kl_columns(theta, torch.tensor([4, 4], dtype=torch.int32), torch.zeros(2, 4, dtype=torch.int32),
                           0.0, torch.zeros(8, dtype=F64))
    assert [kernels.kl_path(cap) for cap in (1, 32, 33, 64, 128, 129, 256)] == \
        ["warp", "warp", "tile", "tile", "tile", "cluster", "cluster"]


_BAND: dict = {}


def _band_reference():
    """The reference's factor on a banded pattern whose columns fill K16's buckets of caps 64, 128 and 256:
    n = 200, column k holds rows k .. min(n - 1, k + 129) (130 rows at most: three tiles of 64, the last
    ragged), random points, ℓ = 0.3, jitter 1e-3 (computed once per module: the JAX package compiles every
    bucket anew)."""
    if not _BAND:
        n, w = 200, 129
        rows = np.concatenate([np.arange(k, min(n, k + w + 1)) for k in range(n)])
        cols = np.concatenate([np.full(min(n, k + w + 1) - k, k) for k in range(n)])
        X, order = _points(n, seed=3), np.arange(n)
        L = jkl.sparse_approximate_cholesky(X, jkl.gram(_matern32_jax), JP(rows, cols, (n, n)), order, 1e-3)
        _BAND.update(X=X, rows=rows, cols=cols, order=order, L=np.asarray(L.data))
    return _BAND


@pytest.mark.parametrize("cap", [64, 128, 256])
def test_kl_columns_plain_matches_reference_at_tile_caps(cap):
    ref = _band_reference()
    n = len(ref["X"])
    p = SparsePattern(ref["rows"], ref["cols"], (n, n))
    L = tkl.sparse_approximate_cholesky(ref["X"], tkl.gram(_matern32_torch), p, ref["order"], 1e-3)
    entry_pos = {c: np.asarray(e) for c, _, _, e, _ in tkl.kl_buckets(p)}[cap]
    pos = entry_pos[entry_pos >= 0]
    assert _rel(L.data.numpy()[pos], ref["L"][pos]) <= 1e-11


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_kl_backward_error_helper_matches_numpy_oracle():
    """chip_smoke.py's check of K16's tile and cluster paths: per column ‖A x − e_N / x_N‖_∞ / (‖A‖_∞ ‖x‖_∞)."""
    rng = np.random.default_rng(9)
    B, cap, jitter = 4, 8, 1e-6
    count = np.array([8, 5, 1, 6])
    theta = np.full((B, cap, cap), np.nan)  # the padding is never read
    for b in range(B):
        N = count[b]
        G = rng.normal(size=(N, N + 2))
        theta[b, cap - N:, cap - N:] = G @ G.T / (N + 2) + 0.1 * np.eye(N) + 1e-9 * rng.normal(size=(N, N))
    # the columns perturbed by 1e-6 (a backward error well above rounding, so both sides read it to many digits)
    x = np.nan_to_num(_kl_oracle(theta, count, jitter)) * (1.0 + 1e-6 * rng.normal(size=(B, cap)))
    x[1, -3] *= 1.5  # a wrong entry: a backward error of order one for that column
    want = np.zeros(B)
    for b in range(B):
        N = count[b]
        T = theta[b, cap - N:, cap - N:]
        A = 0.5 * (T + T.T) + jitter * np.eye(N)
        xb = x[b, cap - N:]
        r = A @ xb
        r[-1] -= 1.0 / xb[-1]
        want[b] = np.abs(r).max() / (np.abs(A).sum(1).max() * np.abs(xb).max())
    got = _chip_smoke().kl_backward_error(torch.tensor(theta), torch.tensor(count), torch.tensor(x), jitter)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert want[1] > 1e-2 and np.delete(want, 1).max() < 1e-5


# ---- graphical lasso: host tables ---------------------------------------------------------


def _glasso_samples(n=30, m=600, seed=7):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.06, random_state=np.random.RandomState(seed))
    A = A + A.T
    A = A + sp.diags(np.abs(A).sum(axis=1).A1 + 1.0)
    L = np.linalg.cholesky(A.toarray())
    return np.linalg.solve(L.T, rng.normal(size=(n, m))).T, A


def _thresholds(A):
    n = A.shape[0]
    Lam = sp.csr_matrix((np.full(A.nnz, 0.03), A.nonzero()), shape=(n, n))
    return {"scalar": 0.03, "scipy": Lam, "dense": Lam.toarray()}


@pytest.mark.parametrize("kind", ["scalar", "scipy", "dense", "sparse_matrix"])
def test_soft_threshold_and_chordal_cover_equal(kind):
    X, A = _glasso_samples()
    th = _thresholds(A)
    if kind == "sparse_matrix":
        t_th = tg.from_scipy(th["scipy"])
        j_th = JSM(jnp.asarray(t_th.data.numpy()), JP(t_th.pattern.rows, t_th.pattern.cols, t_th.shape))
    else:
        t_th = j_th = th[kind]
    C, pat, mu = soft_threshold_cov(X, t_th)
    Cj, patj, muj = jgl.soft_threshold_cov(X, j_th)
    assert np.array_equal(C, Cj) and np.array_equal(mu, muj)
    assert np.array_equal(pat.rows, patj.rows) and np.array_equal(pat.cols, patj.cols)
    cover, cliques, seps = chordal_cover(pat)
    coverj, cliquesj, sepsj = jgl.chordal_cover(patj)
    assert np.array_equal(cover.rows, coverj.rows) and np.array_equal(cover.cols, coverj.cols)
    assert len(cliques) == len(cliquesj) and len(seps) == len(sepsj)
    assert all(np.array_equal(a, b) for a, b in zip(cliques, cliquesj))
    assert all(np.array_equal(a, b) for a, b in zip(seps, sepsj))


def test_embed_plan_equals_the_reference_position_map():
    X, A = _glasso_samples()
    _, patj, _ = jgl.soft_threshold_cov(X, 0.03)
    coverj, cliques, seps = jgl.chordal_cover(patj)
    cover = SparsePattern(coverj.rows, coverj.cols, coverj.shape)
    sets = list(cliques) + list(seps)
    got = embed_plan(cover, sets)
    posmap = coverj.position_map()  # the reference's loop (graphical_lasso.py:152-156)
    want = [posmap[(int(s[a]), int(s[c]))] for s in sets for a in range(len(s)) for c in range(len(s))]
    assert np.array_equal(got, want)
    with pytest.raises(ValueError):
        embed_plan(SparsePattern([0, 1], [0, 1], (2, 2)), [np.array([0, 1])])


# ---- graphical lasso: values ----------------------------------------------------------------


def _banded_samples(n=24, m=5000, seed=11):
    """Samples of a pentadiagonal truth: its cover has cliques of few sizes,
    so the reference compiles few inverse shapes."""
    rng = np.random.default_rng(seed)
    Q = sp.diags([np.full(n - 2, -0.2), np.full(n - 1, -0.3), np.ones(n) * 1.2, np.full(n - 1, -0.3),
                  np.full(n - 2, -0.2)], [-2, -1, 0, 1, 2]).tocsr()
    L = np.linalg.cholesky(Q.toarray())
    return np.linalg.solve(L.T, rng.normal(size=(n, m))).T, Q


@pytest.mark.parametrize("kind", ["scalar", "restricted"])
def test_graphical_lasso_matches_reference(kind):
    X, Qt = _banded_samples()
    th = 0.03 if kind == "scalar" else sp.csr_matrix((np.full(Qt.nnz, 0.03), Qt.nonzero()), shape=Qt.shape)
    g = tg.graphical_lasso(X, th)
    gj = jgl.graphical_lasso(X, th)
    assert np.array_equal(g.Q.pattern.rows, gj.Q.pattern.rows)
    assert np.array_equal(g.Q.pattern.cols, gj.Q.pattern.cols)
    assert _rel(g.Q.data, gj.Q.data) <= 1e-10
    assert np.array_equal(g.mean.numpy(), np.asarray(gj.mean))
    assert abs(float(g.logdet_precision()) / float(gj.logdet_precision()) - 1) <= 1e-10


@pytest.mark.parametrize("kind", ["scalar", "scipy"])
def test_graphical_lasso_is_the_decomposable_completion(kind):
    """At 30 variables with cliques of many sizes: Q against the closed form
    Σ_C E_C C_C⁻¹ E_Cᵀ − Σ_S E_S C_S⁻¹ E_Sᵀ in NumPy on the reference's own
    cover, cliques and separators, and the completion's defining property
    (Q⁻¹)_ij = C_ij on the thresholded pattern."""
    X, A = _glasso_samples()
    th = _thresholds(A)[kind]
    Cj, patj, _ = jgl.soft_threshold_cov(X, th)
    coverj, cliques, seps = jgl.chordal_cover(patj)
    want = np.zeros(Cj.shape)
    for sets, sg in ((cliques, 1.0), (seps, -1.0)):
        for s in sets:
            want[np.ix_(s, s)] += sg * np.linalg.inv(Cj[np.ix_(s, s)])
    g = tg.graphical_lasso(X, th)
    assert np.array_equal(g.Q.pattern.rows, coverj.rows) and np.array_equal(g.Q.pattern.cols, coverj.cols)
    Qd = g.Q.todense().numpy()
    assert _rel(Qd, want) <= 1e-10
    Sig = np.linalg.inv(Qd)
    assert _rel(Sig[patj.rows, patj.cols], Cj[patj.rows, patj.cols]) <= 1e-8


# ---- K17's plain version ---------------------------------------------------------------------


def test_block_inv_plain_pivots_and_signs():
    rng = np.random.default_rng(9)
    n = 12
    C = rng.normal(size=(n, n))
    C = C + C.T
    C[2, 2] = 0.0  # zero leading entry of the first set: needs a row interchange
    sets = [np.array([2, 3, 5, 7]), np.array([0, 1]), np.array([4, 6, 8, 9, 10, 11]), np.array([3])]
    signs = [1.0, -1.0, 1.0, -1.0]
    block = C[np.ix_(sets[0], sets[0])]
    assert np.linalg.eigvalsh(block).min() < 0 < np.linalg.eigvalsh(block).max()  # indefinite
    bs = kernels.BlockSets(sets, signs)
    got = kernels.block_inv(torch.tensor(C), bs).numpy()
    assert got.shape == (bs.total,)
    for s, sg, off in zip(sets, signs, bs.out_off):
        want = sg * np.linalg.inv(C[np.ix_(s, s)])
        assert _rel(got[off:off + s.size**2].reshape(s.size, s.size), want) <= 1e-12


def test_block_inv_plain_singular_block_is_non_finite():
    C = np.eye(5)
    C[3, 3] = 0.0
    C[3, 4] = C[4, 3] = 0.0
    bs = kernels.BlockSets([np.array([0, 1]), np.array([2, 3])], [1.0, 1.0])
    got = kernels.block_inv(torch.tensor(C), bs).numpy()
    assert np.allclose(got[:4], np.eye(2).ravel())
    assert not np.isfinite(got[4:]).all()
    assert not np.isfinite(np.asarray(jnp.linalg.inv(jnp.asarray(C[np.ix_([2, 3], [2, 3])])))).all()


def test_block_sets_tables_and_shared_memory_limit():
    assert kernels.block_inv_smem_max(torch.float64) == 169
    assert kernels.block_inv_smem_max(torch.float32) == 239
    sizes = [200, 3, 170, 96, 33, 97, 32, 33]
    bs = kernels.BlockSets([np.arange(s) for s in sizes], [1.0, -1.0, 1.0, 1.0, -1.0, 1.0, 1.0, -1.0])
    # largest first (ties in set order), as the classes global, shared, tile and warp
    t = bs.on("cpu", torch.float64)
    assert t["order"].tolist() == [0, 2, 5, 3, 4, 7, 6, 1] and t["counts"] == [2, 1, 3, 2] and t["smem_s"] == 97
    assert t["goff"].tolist() == [0, -1, 200, -1, -1, -1, -1, -1] and t["gtotal"] == 370
    t = bs.on("cpu", torch.float32)
    assert t["order"].tolist() == [0, 2, 5, 3, 4, 7, 6, 1] and t["counts"] == [0, 3, 3, 2] and t["smem_s"] == 200
    assert t["goff"].tolist() == [-1] * 8 and t["gtotal"] == 0
    assert bs.out_off.tolist() == np.concatenate([[0], np.cumsum(np.square(sizes))]).tolist()
    with pytest.raises(ValueError):
        kernels.BlockSets([np.arange(2), np.zeros(0)], [1.0, 1.0])


def test_launch_counters_stay_zero_on_the_cpu():
    kernels.reset_launches()
    tkl.approximate_gmrf_kl(_points(12), tkl.gram(_matern32_torch), rho=2.0)
    X, _ = _glasso_samples(n=10, m=200)
    tg.graphical_lasso(X, 0.05)
    assert kernels.launches() == dict.fromkeys(kernels.KERNELS, 0)
