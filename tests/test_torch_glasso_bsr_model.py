"""NumPy models of the work mappings of K17 `block_inv` and K15 `bsr_outer`
(``tpu_gmrf_torch/csrc/block_inv.cu``, ``csrc/bsr.cu``), held to the plain
versions that CPU tensors take and to the JAX package, in float64 (and the
plain versions in float32).

K17's model walks the launch plan of `BlockSets.plan` (the sets largest
first, in the classes global, shared, tile and warp) block by block as the
two launches do, and inverts each set as its class does: the warp class with
a lane per row, the tile class with a 16 x 16 grid of threads each holding
rows ty + 16a and columns tx + 16b (a half-warp a column group), both leaving rows in place and swapping
their logical labels, the final column permutation applied as the result is
written; the shared and global classes by Gauss-Jordan with row
interchanges. Every operation is one IEEE operation in the plain version's
order, so the model equals `block_inv_plain` bit for bit (NaN masks too); it
is within 1e-10 of the reference's `jnp.linalg.inv` per size bucket.

K15's model walks runs of stored blocks a warp, the tables 32 blocks at a
time, and gives each lane its runs of V entries of every block; each output
entry is written once. It is held to `bsr_outer_plain` and to the
reference's gradient of `bsr_spmv` within 1e-12 (float64; float32 1e-5).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from tpu_gmrf.sparse.matrix import SparseMatrix as JSM
from tpu_gmrf.sparse.pattern import SparsePattern as JP
from tpu_gmrf import kernels as jk
import tpu_gmrf_torch as tg
from tpu_gmrf_torch import kernels
from tpu_gmrf_torch.sparse.matrix import SparseMatrix
from tpu_gmrf_torch.sparse.pattern import SparsePattern

# these tests hold the plain versions (CPU tensors) against the JAX package
tg.set_default_device("cpu")
jbsr = importlib.import_module("tpu_gmrf.kernels.bsr_spmv")
tbi = importlib.import_module("tpu_gmrf_torch.kernels.block_inv")  # the module: the package exports the function

DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


# ---- K17 -------------------------------------------------------------------------------------------------


def _better(v, i, bv, bi):
    """The kernels' pivot order: NaN largest, then larger |value|, then the smaller logical row."""
    nv, nb = np.isnan(v), np.isnan(bv)
    if nv != nb:
        return nv
    if not nv and v != bv:
        return v > bv
    return i < bi


def _pick(v, i, bv, bi):
    return i is not None and (bi is None or _better(v, i, bv, bi))


def _finish(A, lab, swap, s):
    """Undo the column interchanges in reverse as a map (source column -> output column) and write each
    physical row at its logical index."""
    pos = np.arange(s)
    for k in range(s - 1, -1, -1):
        q = swap[k]
        pos = np.where(pos == k, q, np.where(pos == q, k, pos))
    out = np.empty((s, s), A.dtype)
    out[np.ix_(lab[:s], pos)] = A[:s, :s]
    return out


def _step(A, f, r, y, k):
    """One elimination step on every row: the pivot row (physical y) becomes r, the others
    sub(A or 0 in column k, mul(f, r))."""
    upd = np.where(np.arange(A.shape[1]) == k, A.dtype.type(0), A) - f[:, None] * r[None, :]
    upd[y] = r
    return upd


def model_warp(A):
    """The warp class: lane i holds row i of the set, W = 8, 16 or 32 columns wide."""
    s, one = A.shape[0], A.dtype.type(1)
    W = 8 if s <= 8 else 16 if s <= 16 else 32
    R = np.zeros((32, W), A.dtype)
    R[:s, :s] = A
    lab = np.where(np.arange(32) < s, np.arange(32), -1)
    swap = np.zeros(32, int)
    for k in range(s):
        # butterfly argmax over lanes 0 .. W - 1: each of them ends with the winner, which lane 0 passes on
        best = [(abs(R[l, k]), lab[l] if lab[l] >= k else None, l) for l in range(32)]
        m = W // 2
        while m:
            best = [best[l ^ m] if _pick(best[l ^ m][0], best[l ^ m][1], best[l][0], best[l][1]) else best[l]
                    for l in range(32)]
            m //= 2
        assert len(set(best[:W])) == 1
        _, p, y = best[0]
        piv = R[y, k]
        row = R[y].copy()  # lane j takes element j of the pivot row and divides it
        r = np.where(np.arange(W) == k, one, row) / piv
        R = _step(R, R[:, k].copy(), r, y, k)
        lab = np.where(np.arange(32) == y, k, np.where(lab == k, p, lab))
        swap[k] = p
    return _finish(R, lab, swap, s)


def model_tile(A):
    """The tile class: thread (tx, ty) of a 16 x 16 grid holds T[ty, a, tx, b] = A[ty + 16a, tx + 16b], a, b < RT
    (4 up to 64 rows, 6 beyond); a half-warp holds the columns tx + 16b. The half-warp of column k stores it, zeroes
    it in place and chooses the pivot (each lane its best slot, then a butterfly over the 16 lanes); lane b of each
    half-warp divides element b of the pivot row; the pivot row takes the scaled row and the other rows one
    product and one difference a slot."""
    s, one, zero = A.shape[0], A.dtype.type(1), A.dtype.type(0)
    RT = 4 if s <= 64 else tbi.TILE_MAX // 16
    M = np.zeros((16 * RT, 16 * RT), A.dtype)
    M[:s, :s] = A
    T = M.reshape(RT, 16, RT, 16).transpose(1, 0, 3, 2).copy()  # (ty, a, tx, b)
    ty, a = np.meshgrid(np.arange(16), np.arange(RT), indexing="ij")
    rows = ty + 16 * a  # (ty, a): the physical row of a lane's slot
    lab = np.where(rows < s, rows, -1)
    swap = np.zeros(s, int)

    def offer(k):
        """The half-warp of column k (tx = k % 16, slot k // 16)."""
        col = T[:, :, k % 16, k // 16].copy()
        T[:, :, k % 16, k // 16] = zero
        best = []
        for t in range(16):
            bt = (zero, None, 0)
            for aa in range(RT):
                if lab[t, aa] >= k and _pick(abs(col[t, aa]), lab[t, aa], bt[0], bt[1]):
                    bt = (abs(col[t, aa]), lab[t, aa], rows[t, aa])
            best.append(bt)
        for m in (8, 4, 2, 1):
            best = [best[t ^ m] if _pick(best[t ^ m][0], best[t ^ m][1], best[t][0], best[t][1]) else best[t]
                    for t in range(16)]
        assert len(set(best)) == 1
        return best[0], col  # the pivot; the column by (ty, a) = physical row ty + 16a

    pivot, colk = offer(0)
    cols = np.arange(16)[:, None] + 16 * np.arange(RT)[None, :]  # (tx, b): the column of a half-warp's slot
    for k in range(s):
        _, p, y = pivot
        piv = colk[y % 16, y // 16]
        rowk = np.where(cols == k, one, T[y % 16, y // 16]) / piv  # (tx, b), lane b of half-warp tx
        lab = np.where(rows == y, k, np.where(lab == k, p, lab))
        swap[k] = p
        T = T - colk[:, :, None, None] * rowk[None, None]
        T[y % 16, y // 16] = rowk
        if k + 1 < s:
            pivot, colk = offer(k + 1)
    M = T.transpose(1, 0, 3, 2).reshape(16 * RT, 16 * RT)
    lab_by_row = np.empty(16 * RT, int)
    lab_by_row[rows.T.reshape(-1)] = lab.T.reshape(-1)
    return _finish(M, lab_by_row, swap, s)


def model_dense(A):
    """The shared and global classes (gj_invert): Gauss-Jordan with row interchanges in place."""
    s, one, zero = A.shape[0], A.dtype.type(1), A.dtype.type(0)
    A = A.copy()
    perm = np.zeros(s, int)
    for k in range(s):
        p = k
        for i in range(k + 1, s):
            if _better(abs(A[i, k]), i, abs(A[p, k]), p):
                p = i
        perm[k] = p
        A[[k, p]] = A[[p, k]]
        f = A[:, k].copy()
        row = np.where(np.arange(s) == k, one, A[k]) / f[k]
        A = _step(A, f, row, k, k)
    for k in range(s - 1, -1, -1):
        A[:, [k, perm[k]]] = A[:, [perm[k], k]]
    return A


def model_block_inv(C, sets, dtype):
    """K17's two launches over the plan of `sets`: the shared class's blocks, then blocks [0, nglob) global,
    the next ntile blocks a tile each and the rest 8 warp sets each; every set once, by its class."""
    p = sets.plan(dtype)
    order, (nglob, nsmem, ntile, nwarp) = p["order"], p["counts"]
    npd = DTYPES[dtype]
    out, seen = np.zeros(sets.total, npd), np.zeros(len(sets), int)
    smax = kernels.block_inv_smem_max(dtype)

    def run(q, model, lo, hi):
        s = int(sets.sizes[q])
        assert lo < s <= hi
        idx = sets.idx[sets.ptr[q]:sets.ptr[q + 1]]
        with np.errstate(divide="ignore", invalid="ignore"):  # a singular set divides by its zero pivot
            res = model(np.asarray(C, npd)[np.ix_(idx, idx)])
        out[sets.out_off[q]:sets.out_off[q + 1]] = (npd(sets.signs[q]) * res).ravel()
        seen[q] += 1

    for q in order[nglob:nglob + nsmem]:  # the shared class's launch
        run(q, model_dense, tbi.TILE_MAX, smax)
    rest = order[nglob + nsmem:]
    for b in range(nglob + ntile + -(-nwarp // 8)):
        if b < nglob:
            run(order[b], model_dense, smax, np.inf)
        elif b < nglob + ntile:
            run(rest[b - nglob], model_tile, tbi.WARP_MAX, tbi.TILE_MAX)
        else:
            for w in range(8):
                i = ntile + (b - nglob - ntile) * 8 + w
                if i < ntile + nwarp:
                    run(rest[i], model_warp, 0, tbi.WARP_MAX)
    assert (seen == 1).all()
    return out


EDGE_SIZES = (1, 2, 8, 31, 32, 33, 47, 95, 96, 97, 169, 170, 239, 240)


def _glasso_like(seed, n=300):
    """A symmetric, indefinite C (a random symmetric matrix with a ±5 diagonal: partial pivoting interchanges
    rows) and sets of every class edge's size, each a random subset of rows."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, n))
    C = G + G.T + np.diag(np.where(np.arange(n) % 2, 5.0, -5.0))
    sets = [np.sort(rng.choice(np.arange(1, n), s, replace=False)) for s in EDGE_SIZES]
    return C, sets


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_inv_model_equals_plain_bit_for_bit(dtype):
    C, sets = _glasso_like(21)
    C[0, :] = C[:, 0] = 0.0  # row 0 is in the singular set only, as its first row: a zero pivot at its first step
    sets += [np.array([0, 5, 9, 40]), sets[7][:3]]  # the singular set, and one more small set
    signs = [1.0 if i % 3 else -1.0 for i in range(len(sets))]
    bs = kernels.BlockSets(sets, signs)
    for a in sets[:-2]:
        block = C[np.ix_(a, a)]
        assert a.size < 3 or np.linalg.eigvalsh(block).min() < 0 < np.linalg.eigvalsh(block).max()
    got = model_block_inv(C, bs, dtype)
    ref = kernels.block_inv(torch.tensor(C, dtype=dtype), bs).numpy()
    assert np.array_equal(got, ref, equal_nan=True)
    sing = slice(bs.out_off[-3], bs.out_off[-2])
    assert np.isnan(got[sing]).all() and np.isfinite(np.delete(got, np.r_[sing])).all()


def test_block_inv_model_matches_reference_inverses():
    """Within 1e-10 of the reference's formulation (`_batched_embed_inverses`, graphical_lasso.py:146-151):
    per bucket of sets of one size, the gathered blocks inverted by jnp.linalg.inv; with the set's sign."""
    C, sets = _glasso_like(22)
    sets = [a for a in sets if a.size in (8, 32, 33, 96, 97, 170)]  # a set on each side of every f64 class edge
    rng = np.random.default_rng(23)
    sets += [np.sort(rng.choice(C.shape[0], s, replace=False)) for s in (8, 33, 97)]  # buckets of two
    signs = [1.0 if i % 2 else -1.0 for i in range(len(sets))]
    bs = kernels.BlockSets(sets, signs)
    buf = model_block_inv(C, bs, torch.float64)
    buckets: dict = {}
    for q, a in enumerate(sets):
        buckets.setdefault(a.size, []).append(q)
    for size, group in buckets.items():
        idx = np.stack([sets[q] for q in group])
        invs = np.asarray(jnp.linalg.inv(jnp.asarray(C)[idx[:, :, None], idx[:, None, :]]))
        want = np.asarray([signs[q] for q in group])[:, None, None] * invs
        got = np.stack([buf[bs.out_off[q]:bs.out_off[q + 1]].reshape(size, size) for q in group])
        assert _rel(got, want) <= 1e-10, size


# ---- K15 -------------------------------------------------------------------------------------------------


def model_bsr_outer(plan, g, x, per_chain, resident_warps):
    """bsr_outer_kernel's walk: `wave_rows` gives each warp a run of stored blocks (taken UB at a time on the card,
    which changes no value); lane l owns the NR runs of V entries (l + 32t)V .. + V of every block (rows
    row0 + RS t, columns j0 .. j0 + V), with its g values of the block row held while the block row lasts (CH
    vectors at a time; one with a matrix per chain); the sum over the vectors in their order."""
    bs, n, nbl = plan.bs, plan.n, plan.nblocks
    V = min(16 // g.itemsize, bs * bs // 32)
    NR, RS = bs * bs // (32 * V), 32 * V // bs
    CH = 1 if per_chain else 8 if NR <= 2 else 4 if NR <= 4 else 1
    R = g.shape[0]
    chains = R if per_chain else 1
    run = max(1, -(-nbl * chains // resident_warps))
    pad = plan.nb * bs - n
    gp, xp = np.pad(g, ((0, 0), (0, pad))), np.pad(x, ((0, 0), (0, pad)))
    lane = np.arange(32)
    row0, j0 = lane * V // bs, lane * V % bs
    out = np.full((chains, nbl, bs, bs), np.nan, g.dtype)
    written = np.zeros(out.shape, int)
    for cy in range(chains):
        c_lo, c_hi = (cy, cy + 1) if per_chain else (0, R)
        for w in range(-(-nbl // run)):
            q0, q1 = w * run, min(nbl, w * run + run)
            held, gr = -1, None
            for q in range(q0, q1):
                if (q - q0) % 32 == 0:  # the next 32 blocks' table entries, a lane each
                    rb_t, cb_t = plan.block_rows[q:min(q + 32, q1)], plan.block_cols[q:min(q + 32, q1)]
                rb, cb = int(rb_t[(q - q0) % 32]), int(cb_t[(q - q0) % 32])
                rows = rb * bs + row0[:, None] + RS * np.arange(NR)[None, :]  # (lane, t)
                cols = cb * bs + j0[:, None] + np.arange(V)[None, :]  # (lane, v)
                acc = np.zeros((32, NR, V), g.dtype)
                for c0 in range(c_lo, c_hi, CH):
                    if rb != held or c_hi - c_lo > CH:
                        gr, held = gp[c0:min(c0 + CH, c_hi)][:, rows], rb
                    for cc in range(min(CH, c_hi - c0)):
                        acc += gr[cc][:, :, None] * xp[c0 + cc][cols][:, None, :]
                ii = (row0[:, None] + RS * np.arange(NR))[:, :, None]
                jj = (j0[:, None] + np.arange(V))[:, None, :]
                out[cy, q][ii, jj] = acc
                written[cy, q][ii, jj] += 1
    assert (written == 1).all()
    return out if per_chain else out[0]


def _bsr_case(name):
    """(rows, cols, n, data): the g=10 Matérn-like 5-point grid Laplacian + 4I (n=100, not a multiple of 32) and a
    random SPD matrix of n=53 (no multiple of any block size)."""
    if name == "grid":
        m = 10
        L1 = sp.diags([-np.ones(m - 1), 2 * np.ones(m), -np.ones(m - 1)], [-1, 0, 1])
        A = sp.kronsum(L1, L1) + 4 * sp.eye(m * m)
    else:
        A = sp.random(53, 53, density=0.08, random_state=np.random.RandomState(5))
        A = A + A.T + sp.eye(53) * 10.0
    A = A.tocoo()
    o = np.lexsort((A.col, A.row))
    return A.row[o], A.col[o], A.shape[0], A.data[o]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_chain", [False, True])
@pytest.mark.parametrize("case", ["grid", "ragged"])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_bsr_outer_model(bs, case, per_chain, dtype):
    rows, cols, n, data = _bsr_case(case)
    tq = SparseMatrix(torch.tensor(data, dtype=dtype), SparsePattern(rows, cols, (n, n)))
    plan = kernels.bsr_from_sparse(tq, bs).plan
    rng = np.random.default_rng(bs + n)
    R = 3
    g, x = (rng.normal(size=(R, n)).astype(DTYPES[dtype]) for _ in range(2))
    plain = kernels.bsr_outer_plain(plan, torch.tensor(g), torch.tensor(x), per_chain).numpy()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for resident in (4, 10**6):  # runs longer than a table chunk of 32 blocks, and one block a warp
        assert _rel(model_bsr_outer(plan, g, x, per_chain, resident), plain) <= tol
    if dtype == torch.float64:  # the reference's gradient of bsr_spmv with respect to the blocks (_spmv_bwd)
        jq = JSM(jnp.asarray(data), JP(rows, cols, (n, n)))
        ref = jk.bsr_from_sparse(jq, bs)
        if per_chain:
            B = jnp.broadcast_to(ref.blocks, (R,) + ref.blocks.shape)
            f = jax.vmap(lambda b, v: jbsr.bsr_spmv(b, v[:, None], ref.plan)[:, 0])
            grad = jax.jit(lambda b, v, w: jax.vjp(lambda b_: f(b_, v), b)[1](w)[0])
            want = np.asarray(grad(B, jnp.asarray(x), jnp.asarray(g)))
        else:
            grad = jax.jit(lambda b, v, w: jax.vjp(lambda b_: jbsr.bsr_spmv(b_, v, ref.plan), b)[1](w)[0])
            want = np.asarray(grad(ref.blocks, jnp.asarray(x.T), jnp.asarray(g.T)))
        assert _rel(model_bsr_outer(plan, g, x, per_chain, 64), want) <= 1e-12
