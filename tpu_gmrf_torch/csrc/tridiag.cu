// Batched tridiagonal kernels K1-K3: bidiagonal Cholesky with logdet,
// triangular solves, and the Takahashi selected inverse; K19, the
// selected inverse's tangent; and K23, the factorization's adjoint.
//
// Replaces (JAX reference, tpu_gmrf/):
//   K1 tridiag_factor  solvers/prefix.py:53 `mobius_recurrence` as used by
//                      solvers/tridiag.py:102-129 `tridiag_factorize`, and
//                      solvers/tridiag.py:67-68 `TridiagFactor.logdet`.
//   K2 tridiag_solve   solvers/prefix.py:33 `linear_recurrence` as used by
//                      solvers/tridiag.py:44-59 (forward/backward/solve).
//   K3 tridiag_selinv  solvers/tridiag.py:70-81 `selinv_tridiag`, the
//                      reverse `linear_recurrence`.
//   K19 tridiag_selinv_tangent  JAX's AD of solvers/tridiag.py:70
//                      `selinv_tridiag` through the factorization (the
//                      reference has no kernel of its own for it): the
//                      tangent of K1's pivots and of K3's recurrence.
//   K23 tridiag_factor_adjoint  JAX's AD (reverse mode) of
//                      solvers/tridiag.py:102-129 `tridiag_factorize`, as
//                      `jax.grad` of a sample (solvers/tridiag.py:51-65:
//                      backward_solve, forward_solve, sqrt_matvec) reaches it.
//
// What bounds them on the card: each chain is a length-n first-order
// recurrence. At the flagship shape (B=256 chains, n=500) the whole batch
// moves ~1-3 MB, well under a microsecond of HBM time, and the arithmetic is
// a few flops a row; the bound is the latency of the dependent steps. The TPU
// reference traded that latency for O(n log n) work in associative scans.
// The tensor cores have no part here: a 2x2 Möbius product is four FMAs, and
// the work is latency, not throughput.
//
// K1 and K2: a segmented scan per chain (csrc/scan.cuh). Each thread owns a
// segment of m consecutive rows; it composes the segment's step maps (K1 the
// Möbius matrices [[a_k, -c_{k-1}^2], [1, 0]] of the pivots, K2 the affine
// maps of y_k = (b_k - e_{k-1} y_{k-1}) / d_k), the maps are scanned across
// each warp (5 shuffle steps) and across the warps' totals, and each thread
// replays the sequential recurrence over its rows from its carry-in. A block
// takes a chain (K2: a chain and one right-hand side) with up to 4 rows a
// thread while 16 warps hold it (n <= 2048; at n=500, 4 warps: 4 + 5 + 5 + 4
// dependent steps where one thread walked 500); a longer chain takes up to 16
// rows a thread and, past 8192 rows, tiles in sequence, the last row's value
// carried from tile to tile (kernels/tridiag.py::scan_launch). Measured at
// n=500 on the H100, a warp per chain with 16 rows a lane took K1 13.4 µs and
// K2 19.7-25.6 µs per launch against 9.0 and 10.9 for 4 warps of 4 rows. A
// tile's rows are staged in shared memory by coalesced loads and written back
// coalesced; a thread's segment sits at an odd stride (scan::seg_pos) so the
// threads' reads do not conflict. K1 sums log d in a fixed order (shuffles,
// then the warps' sums, then the tiles in order: no atomics). K2's mode 2
// runs the backward pass on the forward result where it lies in shared
// memory; only a chain of several tiles sends its forward result through
// `out`. K2's right-hand sides each take a block, which computes the
// columns' shared affine products again.
// Numerics: the replay rounds as the sequential loop does; only the
// segments' carry-ins come from the scan, whose maps are composed in float64
// (W below) and whose Möbius products are scaled by powers of two. A
// non-positive pivot gives a NaN (or -inf) logdet with no clamping, and d is
// NaN exactly where the pivot is negative, as in the reference's scan.
//
// K3: the same scan as K2's backward pass (mode 1), on the affine maps
// z_{j+1} -> r_j^2 z_{j+1} + 1/d_j^2 of the Takahashi recurrence: a block per
// chain in K1's shape, tiles last first, z at a tile's first row
// carried to the tile before it; the replay rounds as the sequential loop,
// and writes zdiag and zoff into the staged d and e rows. Where a pivot of K1
// was negative, d is NaN there and so is z at that row and every row above
// it, as in the reference's scan.
//
// K19: the tangent of Sigma's tridiagonal in a direction (a', c') of (a, c).
// Two scans on a block per chain (kernels/tridiag.py::tangent_launch, at most
// 8 rows a thread: a tile stages five arrays): K2's forward affine scan on
// the pivots' tangent delta'_k = r_{k-1}^2 delta'_{k-1} + a'_k -
// 2 r_{k-1} c'_{k-1} (r = e/d), stored in dzdiag, then K3's backward one on
// z'_j = r_j^2 z'_{j+1} + 2 r_j r'_j z_{j+1} - delta'_j/delta_j^2 with
// r'_j = (c'_j - r_j delta'_j)/delta_j, which writes dzdiag and
// dzoff_j = -(r'_j z_{j+1} + r_j z'_{j+1}). Bound, like K1-K3, by the
// latency of the dependent steps.
//
// K23: the adjoint of K1 from the cotangents (d', e') of the factor to those
// (a', c') of the rows. d = sqrt(delta), e = c / d give the pivots' cotangent
// g_j = (d'_j - e'_j e_j / d_j) / (2 d_j), and the pivot recurrence
// delta_{j+1} = a_{j+1} - c_j^2 / delta_j runs backwards as the linear
// recurrence x_j = g_j + r_j^2 x_{j+1} (r = e / d, x_n = 0): K3's backward
// scan with g in place of 1/d^2, on a block per chain in K19's shape (four
// arrays a tile). The replay writes a'_j = x_j and
// c'_j = (e'_j - 2 e_j x_{j+1}) / d_j. Bound, like K1-K3, by the latency of the
// dependent steps.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise. Nothing is allocated
// here; the wrapper allocates every output.

#include <cuda_runtime.h>
#include <math.h>

#include "scan.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T dev_sqrt(T x);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T dev_log(T x);
template <>
__device__ __forceinline__ float dev_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double dev_log<double>(double x) { return log(x); }

// The largest rows per thread of a scan tile (the loops over a segment are
// unrolled to it); scan_launch never asks for more.
constexpr int kSegMax = 16;
// Shared entries (of double) a block keeps beside its tile: the warps' maps
// (32 Mobius), their entry states (32 Proj), the logdet partials (32) and
// the carry.
constexpr int kScratch = 32 * 4 + 32 * 2 + 32 + 2;
// The maps are composed and scanned in float64 for float32 chains too: on a
// near-singular chain (RW1 + ridge) the products of the pivots' Möbius
// matrices approach a Jordan block, whose ratio loses ~log2(n) bits to
// cancellation, and float32 carry-ins then moved the last pivot by a
// quarter (n=500); the replay runs in the chain's type.
using W = double;

// Launch shape, all three kernels: a block of nw = blockDim.x / 32 warps per
// chain (K2: per chain and right-hand side), m rows a thread, tiles of
// 32·nw·m rows. Shared memory: the tile's arrays of T (32·nw segments at
// stride m | 1 each), then the scratch.
constexpr int kMaxThreads = 512;

// One tile of a backward affine scan (K2's mode 1, K3): each thread composes
// its rows' maps, last row first (compose(i, maps of the rows below i) gives
// the maps of rows i and below), takes the state entering its segment from the
// scan, and replays its rows (replay(i, state below row i) gives row i's
// state). `carry`, the state below the tile, becomes the state of its first
// row.
template <typename T, typename Compose, typename Replay>
__device__ __forceinline__ void reverse_tile(int rows, int r0, W& carry, int nw, scan::Affine<W>* wmaps,
                                             W* wstates, T* slot, Compose compose, Replay replay) {
  using namespace scan;
  Affine<W> mine = identity<Affine<W>>();
#pragma unroll
  for (int i = kSegMax - 1; i >= 0; --i)
    if (i < rows) mine = compose(i, mine);
  T x = T(entry_state<false>(mine, carry, nw, wmaps, wstates));
#pragma unroll
  for (int i = kSegMax - 1; i >= 0; --i)
    if (i < rows) x = replay(i, x);
  if (rows > 0 && r0 == 0) *slot = x;
  group_sync(nw);
  carry = *slot;
}

// K1. Pivots delta_k = a_k - c_{k-1}^2 / delta_{k-1}, d = sqrt(delta),
// e_k = c_k / d_k, logdet = 2 sum log d.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_factor_kernel(const T* __restrict__ a, const T* __restrict__ c, T* __restrict__ d,
                          T* __restrict__ e, T* __restrict__ logdet, int n, int m) {
  using namespace scan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gsize = blockDim.x, nw = gsize / 32, t = threadIdx.x;
  const long chain = blockIdx.x;
  const int s = m | 1, tile = gsize * m;
  T* sa = reinterpret_cast<T*>(smem_raw);  // a, then d
  T* sc = sa + gsize * s;                  // c, then e
  Mobius<W>* wmaps = reinterpret_cast<Mobius<W>*>(sc + gsize * s);
  Proj<W>* wstates = reinterpret_cast<Proj<W>*>(wmaps + 32);
  T* red = reinterpret_cast<T*>(wstates + 32);
  T* slot = red + 32;
  const T* ar = a + chain * n;
  const T* cr = c + chain * (n - 1);
  T* dr = d + chain * n;
  T* er = e + chain * (n - 1);
  T* ma = sa + t * s;
  T* mc = sc + t * s;
  Proj<W> carry = {1.0, 1.0};  // delta_{-1} = 1 with c_{-1} = 0: delta_0 = a_0
  T total = 0;
  for (int t0 = 0; t0 < n; t0 += tile) {
    const int R = min(tile, n - t0);
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {  // each thread loads its m rows in one unrolled loop
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        sa[p] = ar[t0 + j];
        sc[p] = t0 + j < n - 1 ? cr[t0 + j] : T(0);
      }
    }
    const int r0 = t * m, rows = max(0, min(m, R - r0));
    const T cin = rows > 0 && t0 + r0 > 0 ? cr[t0 + r0 - 1] : T(0);  // c_{k-1} of the segment's first row
    group_sync(nw);
    Mobius<W> mine = identity<Mobius<W>>();
    T cp = cin;
#pragma unroll
    for (int i = 0; i < kSegMax; ++i)
      if (i < rows) {
        const W ak = ma[i], q = W(cp) * cp;
        mine = normalized(ak * mine.a - q * mine.c, ak * mine.b - q * mine.d, mine.a, mine.b);
        cp = mc[i];
      }
    const Proj<W> in = entry_state<true>(mine, carry, nw, wmaps, wstates);
    T delta = T(in.p / in.q), acc = 0;
    cp = cin;
#pragma unroll
    for (int i = 0; i < kSegMax; ++i)
      if (i < rows) {
        const T ck = mc[i];
        delta = ma[i] - cp * cp / delta;
        const T dk = dev_sqrt(delta);
        ma[i] = dk;
        mc[i] = ck / dk;
        acc += dev_log(dk);
        cp = ck;
      }
    if (rows > 0 && r0 + rows == R) *slot = delta;
    acc = group_sum(acc, nw, red);
    if (t == 0) total += acc;
    group_sync(nw);
    carry = {W(*slot), 1.0};
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        dr[t0 + j] = sa[p];
        if (t0 + j < n - 1) er[t0 + j] = sc[p];
      }
    }
    group_sync(nw);
  }
  if (t == 0) logdet[chain] = T(2) * total;
}

// K2. mode 0: L y = b; mode 1: L^T x = b; mode 2: both (Q x = b). b is
// (n, k) per chain, row-major; a block solves one column.
// forward  y_i = (b_i - e_{i-1} y_{i-1}) / d_i, y_{-1} = 0
// backward x_i = (z_i - e_i x_{i+1}) / d_i,     x_n = 0
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_solve_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ rhs,
                         T* out, int n, int k, int mode, int m) {
  using namespace scan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gsize = blockDim.x, nw = gsize / 32, t = threadIdx.x;
  const long unit = blockIdx.x, chain = unit / k;
  const int s = m | 1, tile = gsize * m, ntiles = (n + tile - 1) / tile;
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* se = sd + gsize * s;
  T* sb = se + gsize * s;
  Affine<W>* wmaps = reinterpret_cast<Affine<W>*>(sb + gsize * s);
  W* wstates = reinterpret_cast<W*>(wmaps + 32);
  T* slot = reinterpret_cast<T*>(wstates + 32);
  const T* dr = d + chain * n;
  const T* er = e + chain * (n - 1);
  const long col = chain * n * k + unit % k;  // (row, column) at col + row·k
  const T* md = sd + t * s;
  const T* me = se + t * s;
  T* mb = sb + t * s;
  const int r0 = t * m;
  auto load = [&](int t0, int R, const T* src) {
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {  // each thread loads its m rows in one unrolled loop
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        sd[p] = dr[t0 + j];
        se[p] = t0 + j < n - 1 ? er[t0 + j] : T(0);
        sb[p] = src[col + (long)(t0 + j) * k];
      }
    }
  };
  auto store = [&](int t0, int R) {
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) out[col + (long)(t0 + j) * k] = sb[seg_pos(j, m, s)];
    }
  };
  int held = -1;  // the tile whose forward result stays in shared memory for mode 2
  if (mode != 1) {
    W carry = 0;
    for (int ti = 0; ti < ntiles; ++ti) {
      const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
      load(t0, R, rhs);
      const T ein = rows > 0 && t0 + r0 > 0 ? er[t0 + r0 - 1] : T(0);  // e_{i-1} of the segment's first row
      group_sync(nw);
      Affine<W> mine = identity<Affine<W>>();
      T ep = ein;
#pragma unroll
      for (int i = 0; i < kSegMax; ++i)
        if (i < rows) {
          const W r = W(1) / md[i];
          mine = {-ep * mine.A * r, (mb[i] - ep * mine.B) * r};
          ep = me[i];
        }
      T y = T(entry_state<true>(mine, carry, nw, wmaps, wstates));
      ep = ein;
#pragma unroll
      for (int i = 0; i < kSegMax; ++i)
        if (i < rows) {
          y = (mb[i] - ep * y) / md[i];
          mb[i] = y;
          ep = me[i];
        }
      if (rows > 0 && r0 + rows == R) *slot = y;
      group_sync(nw);
      carry = *slot;
      if (mode == 2 && ti == ntiles - 1) {
        held = ti;
      } else {
        store(t0, R);
      }
      group_sync(nw);
    }
  }
  if (mode != 0) {
    W carry = 0;
    for (int ti = ntiles - 1; ti >= 0; --ti) {
      const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
      if (ti != held) load(t0, R, mode == 1 ? rhs : out);
      group_sync(nw);
      reverse_tile(
          rows, r0, carry, nw, wmaps, wstates, slot,
          [&](int i, const Affine<W>& below) -> Affine<W> {
            const W r = W(1) / md[i], ek = me[i];
            return {-ek * below.A * r, (mb[i] - ek * below.B) * r};
          },
          [&](int i, T x) {
            x = (mb[i] - me[i] * x) / md[i];
            mb[i] = x;
            return x;
          });
      store(t0, R);
      group_sync(nw);
    }
  }
}

// K3. Takahashi: z_{n-1} = 1/d_{n-1}^2; z_j = 1/d_j^2 + r_j^2 z_{j+1};
// zoff_j = -r_j z_{j+1}, with r_j = e_j / d_j (r_{n-1} = 0).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_selinv_kernel(const T* __restrict__ d, const T* __restrict__ e, T* __restrict__ zdiag,
                          T* __restrict__ zoff, int n, int m) {
  using namespace scan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gsize = blockDim.x, nw = gsize / 32, t = threadIdx.x;
  const long chain = blockIdx.x;
  const int s = m | 1, tile = gsize * m, ntiles = (n + tile - 1) / tile;
  T* sd = reinterpret_cast<T*>(smem_raw);  // d, then zdiag
  T* se = sd + gsize * s;                  // e, then zoff
  Affine<W>* wmaps = reinterpret_cast<Affine<W>*>(se + gsize * s);
  W* wstates = reinterpret_cast<W*>(wmaps + 32);
  T* slot = reinterpret_cast<T*>(wstates + 32);
  const T* dr = d + chain * n;
  const T* er = e + chain * (n - 1);
  T* zr = zdiag + chain * n;
  T* zo = zoff + chain * (n - 1);
  T* md = sd + t * s;
  T* me = se + t * s;
  const int r0 = t * m;
  W carry = 0;  // z_n = 0; row n-1's map ignores it
  for (int ti = ntiles - 1; ti >= 0; --ti) {
    const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
    const int last = n - 1 - t0 - r0;  // the chain's last row, as a row of this segment
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {  // each thread loads its m rows in one unrolled loop
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        sd[p] = dr[t0 + j];
        se[p] = t0 + j < n - 1 ? er[t0 + j] : T(0);
      }
    }
    group_sync(nw);
    reverse_tile(
        rows, r0, carry, nw, wmaps, wstates, slot,
        [&](int i, const Affine<W>& below) -> Affine<W> {
          const W dj = md[i], r = i == last ? W(0) : W(me[i]) / dj, a = r * r;
          return {a * below.A, a * below.B + W(1) / (dj * dj)};
        },
        [&](int i, T z) {
          const T dj = md[i], r = i == last ? T(0) : me[i] / dj;
          me[i] = -r * z;
          z = T(1) / (dj * dj) + r * r * z;
          md[i] = z;
          return z;
        });
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        zr[t0 + j] = sd[p];
        if (t0 + j < n - 1) zo[t0 + j] = se[p];
      }
    }
    group_sync(nw);
  }
}

// K19. delta'_k = r_{k-1}^2 delta'_{k-1} + a'_k - 2 r_{k-1} c'_{k-1}, then
// z'_j = r_j^2 z'_{j+1} + 2 r_j r'_j z_{j+1} - delta'_j / delta_j^2,
// dzoff_j = -(r'_j z_{j+1} + r_j z'_{j+1}), r'_j = (c'_j - r_j delta'_j) / delta_j.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_selinv_tangent_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ z,
                                  const T* __restrict__ da, const T* __restrict__ dc, T* dz, T* __restrict__ dzoff,
                                  int n, int m) {
  using namespace scan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gsize = blockDim.x, nw = gsize / 32, t = threadIdx.x;
  const long chain = blockIdx.x;
  const int s = m | 1, tile = gsize * m, ntiles = (n + tile - 1) / tile;
  T* sd = reinterpret_cast<T*>(smem_raw);  // d
  T* se = sd + gsize * s;                  // e
  T* s1 = se + gsize * s;                  // a', then z_{j+1}
  T* s2 = s1 + gsize * s;                  // c', then dzoff
  T* s3 = s2 + gsize * s;                  // delta', then z'
  Affine<W>* wmaps = reinterpret_cast<Affine<W>*>(s3 + gsize * s);
  W* wstates = reinterpret_cast<W*>(wmaps + 32);
  T* slot = reinterpret_cast<T*>(wstates + 32);
  const T* dr = d + chain * n;
  const T* er = e + chain * (n - 1);
  const T* zr = z + chain * n;
  const T* ar = da + chain * n;
  const T* cr = dc + chain * (n - 1);
  T* out = dz + chain * n;
  T* oo = dzoff + chain * (n - 1);
  T* md = sd + t * s;
  T* me = se + t * s;
  T* m1 = s1 + t * s;
  T* m2 = s2 + t * s;
  T* m3 = s3 + t * s;
  const int r0 = t * m;
  W carry = 0;  // delta'_{-1}, multiplied by r_{-1} = 0
  for (int ti = 0; ti < ntiles; ++ti) {
    const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        const bool inner = t0 + j < n - 1;
        sd[p] = dr[t0 + j];
        se[p] = inner ? er[t0 + j] : T(0);
        s1[p] = ar[t0 + j];
        s2[p] = inner ? cr[t0 + j] : T(0);
      }
    }
    const int k0 = t0 + r0;
    // r and c' of the row before the segment's first
    const T rin = rows > 0 && k0 > 0 ? er[k0 - 1] / dr[k0 - 1] : T(0);
    const T cin = rows > 0 && k0 > 0 ? cr[k0 - 1] : T(0);
    group_sync(nw);
    Affine<W> mine = identity<Affine<W>>();
    T rp = rin, cp = cin;
#pragma unroll
    for (int i = 0; i < kSegMax; ++i)
      if (i < rows) {
        const W A = W(rp) * rp;
        mine = {A * mine.A, A * mine.B + W(m1[i]) - W(2) * rp * cp};
        rp = me[i] / md[i];
        cp = m2[i];
      }
    T y = T(entry_state<true>(mine, carry, nw, wmaps, wstates));
    rp = rin;
    cp = cin;
#pragma unroll
    for (int i = 0; i < kSegMax; ++i)
      if (i < rows) {
        y = rp * rp * y + (m1[i] - T(2) * rp * cp);
        m3[i] = y;
        rp = me[i] / md[i];
        cp = m2[i];
      }
    if (rows > 0 && r0 + rows == R) *slot = y;
    group_sync(nw);
    carry = *slot;
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) out[t0 + j] = s3[seg_pos(j, m, s)];
    }
    group_sync(nw);
  }
  carry = 0;  // z'_n = 0; row n-1's map ignores it
  for (int ti = ntiles - 1; ti >= 0; --ti) {
    const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
    const int last = n - 1 - t0 - r0;  // the chain's last row, as a row of this segment
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        const bool inner = t0 + j < n - 1;
        sd[p] = dr[t0 + j];
        se[p] = inner ? er[t0 + j] : T(0);
        s1[p] = inner ? zr[t0 + j + 1] : T(0);
        s2[p] = inner ? cr[t0 + j] : T(0);
        s3[p] = out[t0 + j];
      }
    }
    group_sync(nw);
    reverse_tile(
        rows, r0, carry, nw, wmaps, wstates, slot,
        [&](int i, const Affine<W>& below) -> Affine<W> {
          const W dj = md[i], delta = dj * dj, r = i == last ? W(0) : W(me[i]) / dj;
          const W rdot = i == last ? W(0) : (W(m2[i]) - r * W(m3[i])) / delta, a = r * r;
          return {a * below.A, a * below.B + W(2) * r * rdot * W(m1[i]) - W(m3[i]) / (delta * delta)};
        },
        [&](int i, T x) {
          const T dj = md[i], delta = dj * dj, r = i == last ? T(0) : me[i] / dj;
          const T rdot = i == last ? T(0) : (m2[i] - r * m3[i]) / delta, zn = m1[i];
          m2[i] = -(rdot * zn + r * x);
          x = r * r * x + T(2) * r * rdot * zn - m3[i] / (delta * delta);
          m3[i] = x;
          return x;
        });
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        out[t0 + j] = s3[p];
        if (t0 + j < n - 1) oo[t0 + j] = s2[p];
      }
    }
    group_sync(nw);
  }
}

// K23. x_j = g_j + r_j^2 x_{j+1}, g_j = (d'_j - e'_j e_j / d_j) / (2 d_j), r_j = e_j / d_j
// (r_{n-1} = e'_{n-1} = 0); a'_j = x_j, c'_j = (e'_j - 2 e_j x_{j+1}) / d_j.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    tridiag_factor_adjoint_kernel(const T* __restrict__ d, const T* __restrict__ e, const T* __restrict__ gd,
                                  const T* __restrict__ ge, T* __restrict__ ga, T* __restrict__ gc, int n, int m) {
  using namespace scan;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int gsize = blockDim.x, nw = gsize / 32, t = threadIdx.x;
  const long chain = blockIdx.x;
  const int s = m | 1, tile = gsize * m, ntiles = (n + tile - 1) / tile;
  T* sd = reinterpret_cast<T*>(smem_raw);  // d, then a'
  T* se = sd + gsize * s;                  // e, then c'
  T* s1 = se + gsize * s;                  // d'
  T* s2 = s1 + gsize * s;                  // e'
  Affine<W>* wmaps = reinterpret_cast<Affine<W>*>(s2 + gsize * s);
  W* wstates = reinterpret_cast<W*>(wmaps + 32);
  T* slot = reinterpret_cast<T*>(wstates + 32);
  const T* dr = d + chain * n;
  const T* er = e + chain * (n - 1);
  const T* gdr = gd + chain * n;
  const T* ger = ge + chain * (n - 1);
  T* ar = ga + chain * n;
  T* cr = gc + chain * (n - 1);
  T* md = sd + t * s;
  T* me = se + t * s;
  T* m1 = s1 + t * s;
  T* m2 = s2 + t * s;
  const int r0 = t * m;
  W carry = 0;  // x_n = 0; row n-1's map ignores it
  for (int ti = ntiles - 1; ti >= 0; --ti) {
    const int t0 = ti * tile, R = min(tile, n - t0), rows = max(0, min(m, R - r0));
    const int last = n - 1 - t0 - r0;  // the chain's last row, as a row of this segment
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        const bool inner = t0 + j < n - 1;
        sd[p] = dr[t0 + j];
        se[p] = inner ? er[t0 + j] : T(0);
        s1[p] = gdr[t0 + j];
        s2[p] = inner ? ger[t0 + j] : T(0);
      }
    }
    group_sync(nw);
    reverse_tile(
        rows, r0, carry, nw, wmaps, wstates, slot,
        [&](int i, const Affine<W>& below) -> Affine<W> {
          const W dj = md[i], ej = me[i], r = i == last ? W(0) : ej / dj, a = r * r;
          return {a * below.A, a * below.B + (W(m1[i]) - W(m2[i]) * ej / dj) / (W(2) * dj)};
        },
        [&](int i, T x) {
          const T dj = md[i], ej = me[i], r = i == last ? T(0) : ej / dj;
          if (i != last) me[i] = (m2[i] - T(2) * ej * x) / dj;
          x = (m1[i] - m2[i] * ej / dj) / (T(2) * dj) + r * r * x;
          md[i] = x;
          return x;
        });
#pragma unroll
    for (int q = 0; q < kSegMax; ++q) {
      const int j = t + q * gsize;
      if (q < m && j < R) {
        const int p = seg_pos(j, m, s);
        ar[t0 + j] = sd[p];
        if (t0 + j < n - 1) cr[t0 + j] = se[p];
      }
    }
    group_sync(nw);
  }
}

// Dynamic shared memory above the 48 KB default needs the kernel's opt-in,
// asked once per device for the largest size seen (`granted`: the caller's,
// one table per kernel).
template <typename K>
int allow_smem(K kernel, size_t smem, size_t* granted) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc || dev >= 64 || granted[dev] >= smem) return rc;
  rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!rc) granted[dev] = smem;
  return rc;
}

// nw warps a block, m rows a thread (scan_launch); `arrays` tile arrays of T.
inline size_t scan_smem(int nw, int m, int arrays, size_t el) {
  return (size_t)arrays * 32 * nw * (m | 1) * el + kScratch * sizeof(W);
}

template <typename T>
int launch_factor(const T* a, const T* c, T* d, T* e, T* logdet, int B, int n, int nw, int m, void* stream) {
  if (B == 0) return 0;
  if (m < 1 || m > kSegMax || nw < 1 || 32 * nw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(nw, m, 2, sizeof(T));
  static size_t granted[64];
  int rc = allow_smem(tridiag_factor_kernel<T>, smem, granted);
  if (rc) return rc;
  tridiag_factor_kernel<T><<<B, 32 * nw, smem, (cudaStream_t)stream>>>(a, c, d, e, logdet, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const T* d, const T* e, const T* rhs, T* out, int B, int n, int k, int mode, int nw, int m,
                 void* stream) {
  const long units = (long)B * k;
  if (units == 0) return 0;
  if (m < 1 || m > kSegMax || nw < 1 || 32 * nw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(nw, m, 3, sizeof(T));
  static size_t granted[64];
  int rc = allow_smem(tridiag_solve_kernel<T>, smem, granted);
  if (rc) return rc;
  tridiag_solve_kernel<T><<<(unsigned)units, 32 * nw, smem, (cudaStream_t)stream>>>(d, e, rhs, out, n, k, mode, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_selinv(const T* d, const T* e, T* zdiag, T* zoff, int B, int n, int nw, int m, void* stream) {
  if (B == 0) return 0;
  if (m < 1 || m > kSegMax || nw < 1 || 32 * nw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(nw, m, 2, sizeof(T));
  static size_t granted[64];
  int rc = allow_smem(tridiag_selinv_kernel<T>, smem, granted);
  if (rc) return rc;
  tridiag_selinv_kernel<T><<<B, 32 * nw, smem, (cudaStream_t)stream>>>(d, e, zdiag, zoff, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_selinv_tangent(const T* d, const T* e, const T* z, const T* da, const T* dc, T* dz, T* dzoff, int B, int n,
                          int nw, int m, void* stream) {
  if (B == 0) return 0;
  if (m < 1 || m > kSegMax || nw < 1 || 32 * nw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(nw, m, 5, sizeof(T));
  static size_t granted[64];
  int rc = allow_smem(tridiag_selinv_tangent_kernel<T>, smem, granted);
  if (rc) return rc;
  tridiag_selinv_tangent_kernel<T><<<B, 32 * nw, smem, (cudaStream_t)stream>>>(d, e, z, da, dc, dz, dzoff, n, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_factor_adjoint(const T* d, const T* e, const T* gd, const T* ge, T* ga, T* gc, int B, int n, int nw, int m,
                          void* stream) {
  if (B == 0) return 0;
  if (m < 1 || m > kSegMax || nw < 1 || 32 * nw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = scan_smem(nw, m, 4, sizeof(T));
  static size_t granted[64];
  int rc = allow_smem(tridiag_factor_adjoint_kernel<T>, smem, granted);
  if (rc) return rc;
  tridiag_factor_adjoint_kernel<T><<<B, 32 * nw, smem, (cudaStream_t)stream>>>(d, e, gd, ge, ga, gc, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_TRIDIAG_ENTRY(SUF, T)                                                                  \
  int tg_tridiag_factor_##SUF(const T* a, const T* c, T* d, T* e, T* logdet, int B, int n, int nw, \
                              int m, void* stream) {                                              \
    return launch_factor<T>(a, c, d, e, logdet, B, n, nw, m, stream);                             \
  }                                                                                               \
  int tg_tridiag_solve_##SUF(const T* d, const T* e, const T* rhs, T* out, int B, int n, int k,   \
                             int mode, int nw, int m, void* stream) {                             \
    return launch_solve<T>(d, e, rhs, out, B, n, k, mode, nw, m, stream);                         \
  }                                                                                               \
  int tg_tridiag_selinv_##SUF(const T* d, const T* e, T* zdiag, T* zoff, int B, int n, int nw,     \
                              int m, void* stream) {                                              \
    return launch_selinv<T>(d, e, zdiag, zoff, B, n, nw, m, stream);                              \
  }                                                                                               \
  int tg_tridiag_selinv_tangent_##SUF(const T* d, const T* e, const T* z, const T* da, const T* dc, \
                                      T* dz, T* dzoff, int B, int n, int nw, int m, void* stream) { \
    return launch_selinv_tangent<T>(d, e, z, da, dc, dz, dzoff, B, n, nw, m, stream);             \
  }                                                                                               \
  int tg_tridiag_factor_adjoint_##SUF(const T* d, const T* e, const T* gd, const T* ge, T* ga,     \
                                      T* gc, int B, int n, int nw, int m, void* stream) {         \
    return launch_factor_adjoint<T>(d, e, gd, ge, ga, gc, B, n, nw, m, stream);                   \
  }

TG_TRIDIAG_ENTRY(f32, float)
TG_TRIDIAG_ENTRY(f64, double)

#undef TG_TRIDIAG_ENTRY

const char* tg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
