"""K1 `tridiag_factor`, K2 `tridiag_solve` and K3 `tridiag_selinv` as the
card runs them: a segmented scan per chain (csrc/scan.cuh, csrc/tridiag.cu).

A NumPy model of the kernels' algorithm (segments of m rows per thread,
their maps composed, a Hillis-Steele scan across each warp of 32 and across
the warps' totals, both in float64 whatever the chain's type, the sequential
recurrence replayed in the chain's type from each segment's carry-in, tiles
in sequence with the last row's value carried; K2's backward pass and K3
take the tiles last first and carry the first row's value) is held
against the JAX package's factor, solves and Takahashi selected inverse, in
float64 and float32, on inputs made with NumPy from a seed. This checks the
design's numerics before the card does. Then the wrappers' launch-shape
rule `scan_launch`.

Tolerances: float64, rtol 1e-9 against the reference's scan trees, as the
plain versions are held (tests/test_torch_kernels.py); the near-singular
chain 1e-6, as there. float32: normwise n·eps(float32), at least 32·eps,
against the float64 reference: the sequential recurrence's own rounding
grows at most linearly in n (read: 1.5e-7 at n=500, where the bound is
3e-5).
"""

import numpy as np
import pytest

from tests.test_torch_kernels import _jax_tridiag
from tpu_gmrf_torch import kernels, set_default_device
from tpu_gmrf_torch.kernels import tridiag as kt

set_default_device("cpu")

WARP = 32
W = np.float64  # the maps' type (csrc/tridiag.cu's W)
MOB_ID = np.array([1.0, 0.0, 0.0, 1.0])
AFF_ID = np.array([1.0, 0.0])


# ---- the model --------------------------------------------------------------


def _pow2_inv(s, dtype):
    """2^-floor(log2 s), kept a normal number (scan.cuh's pow2_inv)."""
    lim = 126 if dtype == np.float32 else 1022
    e = np.clip(np.frexp(s)[1].astype(np.int64) - 1, -lim, lim)
    return np.ldexp(dtype(1), -e).astype(dtype)


def _mob_after(l, e, dtype):
    """l ∘ e for Möbius maps (a, b, c, d) along the last axis, scaled by a power of two."""
    a = l[..., 0] * e[..., 0] + l[..., 1] * e[..., 2]
    b = l[..., 0] * e[..., 1] + l[..., 1] * e[..., 3]
    c = l[..., 2] * e[..., 0] + l[..., 3] * e[..., 2]
    d = l[..., 2] * e[..., 1] + l[..., 3] * e[..., 3]
    m = np.stack([a, b, c, d], -1).astype(dtype)
    return m * _pow2_inv(np.abs(m).max(-1), dtype)[..., None]


def _aff_after(l, e, dtype):
    return np.stack([l[..., 0] * e[..., 0], l[..., 0] * e[..., 1] + l[..., 1]], -1).astype(dtype)


def _mob_apply(m, x, dtype):
    p = m[..., 0] * x[..., 0] + m[..., 1] * x[..., 1]
    q = m[..., 2] * x[..., 0] + m[..., 3] * x[..., 1]
    v = np.stack([p, q], -1).astype(dtype)
    return v * _pow2_inv(np.abs(v).max(-1), dtype)[..., None]


def _aff_apply(m, y, dtype):
    return (m[..., 0] * y + m[..., 1]).astype(dtype)


def _warp_scan(maps, after, ident, forward):
    """Inclusive and exclusive Hillis-Steele scans within each warp of 32 (maps (T, k), T a multiple of 32)."""
    x = maps.copy()
    lane = np.arange(len(x)) % WARP
    s = 1
    while s < WARP:
        if forward:
            y = np.concatenate([np.tile(ident, (s, 1)), x[:-s]])
            x = np.where((lane >= s)[:, None], after(x, y), x)
        else:
            y = np.concatenate([x[s:], np.tile(ident, (s, 1))])
            x = np.where((lane + s < WARP)[:, None], after(x, y), x)
        s *= 2
    if forward:
        exc = np.concatenate([ident[None], x[:-1]])
        exc[lane == 0] = ident
    else:
        exc = np.concatenate([x[1:], ident[None]])
        exc[lane == WARP - 1] = ident
    return x, exc


def _entry_states(maps, carry, after, apply, ident, forward):
    """scan.cuh's entry_state for every thread of a group (maps (T, k))."""
    T = len(maps)
    inc, exc = _warp_scan(maps, after, ident, forward)
    nw = T // WARP
    at = np.tile(carry, (T, 1)) if np.ndim(carry) else np.full(T, carry)
    if nw > 1:
        totals = inc[WARP - 1::WARP] if forward else inc[::WARP]
        padded = np.concatenate([totals, np.tile(ident, (WARP - nw, 1))])
        _, wexc = _warp_scan(padded, after, ident, forward)
        wstates = apply(wexc[:nw], carry)
        at = np.repeat(wstates, WARP, axis=0)
    return apply(exc, at)


def model_factor(a, c, lanes, m):
    """(d, e, logdet) of one chain as K1 computes them, `lanes` threads of m rows a tile."""
    dt = a.dtype.type
    n = len(a)
    tile = lanes * m
    d, e = np.empty(n, dt), np.empty(max(n - 1, 0), dt)
    mob = lambda l, r: _mob_after(l, r, W)  # noqa: E731
    carry, total = np.array([1.0, 1.0], W), dt(0)
    for t0 in range(0, n, tile):
        R = min(tile, n - t0)
        ck = lambda k: c[k] if 0 <= k < n - 1 else dt(0)  # noqa: E731
        maps = np.tile(MOB_ID, (lanes, 1))
        for t in range(lanes):
            for i in range(t * m, min(t * m + m, R)):
                k, q = t0 + i, W(ck(t0 + i - 1)) ** 2
                maps[t] = mob(np.array([a[k], -q, 1.0, 0.0], W), maps[t])
        states = _entry_states(maps, carry, mob, lambda mm, x: _mob_apply(mm, x, W), MOB_ID, True)
        partial = np.zeros(lanes, dt)
        for t in range(lanes):
            delta = dt(states[t, 0] / states[t, 1])
            for i in range(t * m, min(t * m + m, R)):
                k = t0 + i
                delta = a[k] - ck(k - 1) * ck(k - 1) / delta
                d[k] = np.sqrt(delta)
                if k < n - 1:
                    e[k] = c[k] / d[k]
                partial[t] += np.log(d[k])
            if t * m < R <= t * m + m:
                last = delta
        total += partial.sum(dtype=dt)
        carry = np.array([last, 1.0], W)
    return d, e, dt(2) * total


def model_solve(d, e, b, mode, lanes, m):
    """K2 on one chain and one right-hand side b (n,)."""
    dt = d.dtype.type
    n = len(d)
    tile = lanes * m
    x = b.astype(dt).copy()
    aff = lambda l, r: _aff_after(l, r, W)  # noqa: E731
    apply = lambda mm, y: _aff_apply(mm, y, W)  # noqa: E731
    ek = lambda k: e[k] if 0 <= k < n - 1 else dt(0)  # noqa: E731
    tiles = list(range(0, n, tile))
    if mode != kernels.SOLVE_LT:
        carry = W(0)
        for t0 in tiles:
            R = min(tile, n - t0)
            maps = np.tile(AFF_ID, (lanes, 1))
            for t in range(lanes):
                for k in range(t0 + t * m, t0 + min(t * m + m, R)):
                    r = W(1) / W(d[k])
                    A, B = maps[t]
                    maps[t] = [-W(ek(k - 1)) * A * r, (W(x[k]) - W(ek(k - 1)) * B) * r]
            y0 = _entry_states(maps, carry, aff, apply, AFF_ID, True)
            for t in range(lanes):
                y = dt(y0[t])
                for k in range(t0 + t * m, t0 + min(t * m + m, R)):
                    y = (x[k] - ek(k - 1) * y) / d[k]
                    x[k] = y
            carry = W(x[t0 + R - 1])
    if mode != kernels.SOLVE_L:
        carry = W(0)
        for t0 in reversed(tiles):
            R = min(tile, n - t0)
            maps = np.tile(AFF_ID, (lanes, 1))
            for t in range(lanes):
                for k in reversed(range(t0 + t * m, t0 + min(t * m + m, R))):
                    r = W(1) / W(d[k])
                    A, B = maps[t]
                    maps[t] = [-W(ek(k)) * A * r, (W(x[k]) - W(ek(k)) * B) * r]
            x0 = _entry_states(maps, carry, aff, apply, AFF_ID, False)
            for t in range(lanes):
                y = dt(x0[t])
                for k in reversed(range(t0 + t * m, t0 + min(t * m + m, R))):
                    y = (x[k] - ek(k) * y) / d[k]
                    x[k] = y
            carry = W(x[t0])
    return x


def model_selinv(d, e, lanes, m):
    """K3 on one chain: (zdiag, zoff) by the reverse scan of the maps
    z_{j+1} -> r_j² z_{j+1} + 1/d_j² (r_j = e_j / d_j, r_{n-1} = 0), tiles last first."""
    dt = d.dtype.type
    n = len(d)
    tile = lanes * m
    z, zoff = np.empty(n, dt), np.empty(max(n - 1, 0), dt)
    aff = lambda l, r: _aff_after(l, r, W)  # noqa: E731
    apply = lambda mm, y: _aff_apply(mm, y, W)  # noqa: E731
    carry = W(0)
    for t0 in reversed(range(0, n, tile)):
        R = min(tile, n - t0)
        maps = np.tile(AFF_ID, (lanes, 1))
        for t in range(lanes):
            for k in reversed(range(t0 + t * m, t0 + min(t * m + m, R))):
                dk = W(d[k])
                r = W(0) if k == n - 1 else W(e[k]) / dk
                A, B = maps[t]
                maps[t] = [r * r * A, r * r * B + W(1) / (dk * dk)]
        z0 = _entry_states(maps, carry, aff, apply, AFF_ID, False)
        for t in range(lanes):
            zz = dt(z0[t])
            for k in reversed(range(t0 + t * m, t0 + min(t * m + m, R))):
                r = dt(0) if k == n - 1 else e[k] / d[k]
                if k < n - 1:
                    zoff[k] = -r * zz
                zz = dt(1) / (d[k] * d[k]) + r * r * zz
                z[k] = zz
        carry = W(z[t0])
    return z, zoff


def _shape(n):
    warps, m = kernels.scan_launch(n)
    return WARP * warps, m


# ---- inputs -----------------------------------------------------------------


def _spd(rng, n):
    c = rng.normal(size=n - 1)
    a = np.abs(rng.normal(size=n)) + 0.5
    a[1:] += np.abs(c)
    a[:-1] += np.abs(c)
    return a, c


def _near_singular(n, ridge):
    a = np.full(n, 2.0) + ridge
    a[0] = a[-1] = 1.0 + ridge
    return a, np.full(n - 1, -1.0)


def _relnorm(got, ref):
    return np.abs(got.astype(np.float64) - ref).max() / max(np.abs(ref).max(), 1e-300)


# ---- the model against the JAX package --------------------------------------


@pytest.mark.parametrize("n", [1, 2, 31, 33, 500])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scan_model_matches_jax(n, dtype):
    """The kernels' algorithm at the launch shape of n, against the reference's
    factor, logdet and three solves (float64 reference on the same inputs)."""
    rng = np.random.default_rng(100 + n)
    a, c = _spd(rng, n) if n > 1 else (np.abs(rng.normal(size=1)) + 0.5, np.zeros(0))
    b = rng.normal(size=n)
    rd, re, rl, _, _, r_l, r_lt, r_q = (r[0] for r in _jax_tridiag(a[None], c[None], b[None]))
    lanes, m = _shape(n)
    d, e, ld = model_factor(a.astype(dtype), c.astype(dtype), lanes, m)
    sols = [model_solve(d, e, b.astype(dtype), mode, lanes, m) for mode in (0, 1, 2)]
    if dtype == np.float64:
        for got, ref in ((d, rd), (e, re), (np.array([ld]), np.array([rl])), *zip(sols, (r_l, r_lt, r_q))):
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
    else:
        for got, ref in ((d, rd), (e, re), (np.array([ld]), np.array([rl])), *zip(sols, (r_l, r_lt, r_q))):
            if ref.size:
                assert _relnorm(got, ref) <= max(n, 32) * np.finfo(np.float32).eps


@pytest.mark.parametrize("n,lanes,m", [(20, WARP, 1), (100, WARP, 2), (700, 64, 4), (1000, 64, 3)])
def test_scan_model_tiles_and_blocks_match_jax(n, lanes, m):
    """Two warps a group (the block scan) and several tiles a chain, float64."""
    rng = np.random.default_rng(n)
    a, c = _spd(rng, n)
    b = rng.normal(size=n)
    rd, re, rl, _, _, r_l, r_lt, r_q = (r[0] for r in _jax_tridiag(a[None], c[None], b[None]))
    d, e, ld = model_factor(a, c, lanes, m)
    np.testing.assert_allclose(d, rd, rtol=1e-9)
    np.testing.assert_allclose(e, re, rtol=1e-9)
    np.testing.assert_allclose(ld, rl, rtol=1e-9)
    for mode, ref in ((0, r_l), (1, r_lt), (2, r_q)):
        np.testing.assert_allclose(model_solve(d, e, b, mode, lanes, m), ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [64, 500])
@pytest.mark.parametrize("dtype,ridge", [(np.float64, 1e-8), (np.float32, 1e-5)])
def test_scan_model_near_singular_chain_stays_finite(dtype, ridge, n):
    """RW1 plus a ridge (tests/test_torch_kernels.py's chain): pivots decay
    towards the ridge. float32 takes a ridge it can hold: 2 + 1e-8 rounds to 2
    in float32, which makes the chain exactly singular in any algorithm."""
    a, c = _near_singular(n, ridge)
    rd, _, rl, *_ = (r[0] for r in _jax_tridiag(a[None], c[None], np.zeros((1, n))))
    lanes, m = _shape(n)
    d, e, ld = model_factor(a.astype(dtype), c.astype(dtype), lanes, m)
    assert np.isfinite(d).all() and np.isfinite(e).all() and np.isfinite(ld)
    if dtype == np.float64:
        np.testing.assert_allclose(d, rd, rtol=1e-6)
        np.testing.assert_allclose(ld, rl, rtol=1e-6)
    else:
        # the last pivot carries ~n/√ridge of float32's rounding: the sequential float32 recurrence reads
        # 5.9e-4 from the float64 reference at n=500, the reference's own scan in float32 5e-2, the model with
        # float32 maps 0.25; with float64 maps 4.5e-4
        np.testing.assert_allclose(d, rd, rtol=2e-3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scan_model_negative_pivot_gives_nan_where_the_reference_does(dtype):
    """A clearly negative pivot in a middle segment: the logdet is NaN, and d
    is NaN at the same rows as the reference's, finite where it is finite."""
    n = 200
    rng = np.random.default_rng(7)
    a, c = _spd(rng, n)
    c[99] = 3.0 * np.sqrt(a[99] * a[100])  # the pivot of row 100 goes clearly negative
    rd, _, rl, *_ = (r[0] for r in _jax_tridiag(a[None], c[None], np.zeros((1, n))))
    lanes, m = _shape(n)
    d, _, ld = model_factor(a.astype(dtype), c.astype(dtype), lanes, m)
    assert np.isnan(rl) and np.isnan(ld)
    assert np.isnan(rd).any()
    np.testing.assert_array_equal(np.isnan(d), np.isnan(rd))
    ok = ~np.isnan(rd)
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(d[ok], rd[ok], rtol=tol)


SCAN_NS = (1, 2, 31, 32, 33, 129, 500, 1025, 2049, 8193, 20000)  # chip_smoke.py's: the segment, warp, row and tile edges


@pytest.mark.parametrize("n", SCAN_NS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_selinv_model_matches_jax(n, dtype):
    """K3's algorithm at the launch shape of n (one warp to 16 warps a chain, one
    to three tiles), on the reference's own factor, against the reference's
    `selinv_tridiag` (float64)."""
    rng = np.random.default_rng(200 + n)
    a, c = _spd(rng, n) if n > 1 else (np.abs(rng.normal(size=1)) + 0.5, np.zeros(0))
    rd, re, _, rz, rzo, *_ = (r[0] for r in _jax_tridiag(a[None], c[None], np.zeros((1, n))))
    z, zoff = model_selinv(rd.astype(dtype), re.astype(dtype), *_shape(n))
    if dtype == np.float64:
        np.testing.assert_allclose(z, rz, rtol=1e-9)
        np.testing.assert_allclose(zoff, rzo, rtol=1e-9, atol=1e-12 * np.abs(rz).max())
    else:
        for got, ref in ((z, rz), (zoff, rzo)):
            if ref.size:
                assert _relnorm(got, ref) <= max(n, 32) * np.finfo(np.float32).eps


@pytest.mark.parametrize("dtype,ridge", [(np.float64, 1e-8), (np.float32, 1e-5)])
def test_selinv_model_near_singular_chain(dtype, ridge):
    """RW1 plus a ridge at n=500: z on the model's own factor of the chain is
    finite, and on the reference's factor it matches the reference's."""
    n = 500
    a, c = _near_singular(n, ridge)
    rd, re, _, rz, rzo, *_ = (r[0] for r in _jax_tridiag(a[None], c[None], np.zeros((1, n))))
    lanes, m = _shape(n)
    d, e, _ = model_factor(a.astype(dtype), c.astype(dtype), lanes, m)
    assert all(np.isfinite(t).all() for t in model_selinv(d, e, lanes, m))
    z, zoff = model_selinv(rd.astype(dtype), re.astype(dtype), lanes, m)
    tol = 1e-9 if dtype == np.float64 else n * np.finfo(np.float32).eps
    assert _relnorm(z, rz) <= tol and _relnorm(zoff, rzo) <= tol


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_selinv_model_negative_pivot_gives_nan_where_the_reference_does(dtype):
    """d NaN at a clearly negative pivot (the reference's factor): z and zoff
    are NaN at the same rows as the reference's, from that row down, and
    match it above."""
    n = 200
    rng = np.random.default_rng(7)
    a, c = _spd(rng, n)
    c[99] = 3.0 * np.sqrt(a[99] * a[100])
    rd, re, _, rz, rzo, *_ = (r[0] for r in _jax_tridiag(a[None], c[None], np.zeros((1, n))))
    assert np.isnan(rd).any()
    z, zoff = model_selinv(rd.astype(dtype), re.astype(dtype), *_shape(n))
    top = int(np.flatnonzero(np.isnan(rd)).max())
    for got, ref in ((z, rz), (zoff, rzo)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(ref[: top + 1]).all() and np.isfinite(ref[top + 1:]).all()
    tol = 1e-9 if dtype == np.float64 else 1e-4
    np.testing.assert_allclose(z[top + 1:], rz[top + 1:], rtol=tol)


# ---- the launch-shape rule ----------------------------------------------------


@pytest.mark.parametrize("n,want", [
    (1, (1, 1)),
    (32, (1, 1)),
    (33, (1, 2)),
    (128, (1, 4)),
    (129, (2, 3)),
    (500, (4, 4)),  # the flagship: 4 warps a chain, 4 rows a thread
    (1025, (9, 4)),
    (2048, (16, 4)),
    (2049, (16, 5)),
    (8192, (16, 16)),
    (8193, (16, 16)),  # two tiles
    (20000, (16, 16)),  # three tiles
])
def test_scan_launch_shapes(n, want):
    assert kernels.scan_launch(n) == want


def _smem(warps, m, arrays, el):
    """Shared bytes of a launch, as csrc/tridiag.cu's scan_smem computes them."""
    return arrays * 32 * warps * (m | 1) * el + (32 * 4 + 32 * 2 + 32 + 2) * 8


def test_scan_launch_fits_the_card_and_no_thread_walks_a_chain():
    """Over n = 1..40,000: at most 512 threads a block (csrc/tridiag.cu's
    kMaxThreads) and 16 rows a thread (kSegMax: no thread walks a chain past
    16 rows), K2's three float64 arrays within a block's 227 KB of shared
    memory, and tiles that cover the chain up to 8192 rows."""
    for n in list(range(1, 2100)) + list(range(2100, 40001, 97)):
        warps, m = kernels.scan_launch(n)
        assert 1 <= m <= 16 and 1 <= warps <= 16
        assert _smem(warps, m, 3, 8) <= 232448
        tile = 32 * warps * m
        assert tile >= n or (warps, m) == (kt.MAX_WARPS, kt.MAX_ROWS)
        if n <= 32 * kt.MAX_WARPS * kt.SEG_ROWS:
            assert m <= kt.SEG_ROWS and tile >= n


def test_scan_launch_flagship_segments():
    """At the flagship's n=500 a thread replays 4 rows where one thread walked 500."""
    assert kernels.scan_launch(500) == (4, 4)
