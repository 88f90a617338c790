// K11 bt_factor, K12 bt_trsv and K13 bt_matvec (with its second entry
// bt_sqrt): the RCM block-tridiagonal Cholesky of B chains, its block
// substitutions, and the products with block-tridiagonal storage.
//
// Replaces (JAX reference, tpu_gmrf/solvers/banded.py):
//   K11 :354-388 `banded_factorize`: symmetrize Q (when its pattern is
//       symmetric), scatter it through the plan's d_idx / e_idx into the
//       diagonal blocks D_k and the sub-diagonal blocks E_k (s x s; a unit
//       diagonal on the padding rows), then the scan `step` (:376):
//       L_k = chol_boosted(D_k - U_{k-1}), M_k = E_k L_k^-T, U_k = M_k M_k^T,
//       with supernodal.py:775 `_chol_boosted` semantics (breakdown at a
//       non-finite pivot or one <= 30 eps; retry + delta I, delta = 2e-6 s;
//       then + (Gershgorin bound + delta) I), plus the logdet (:204-206);
//   K12 :145 `forward_solve_blocks` and :162 `backward_solve_blocks` with
//       the permutation and padding of :135-202 (`_to_blocks`,
//       `_from_blocks`): y_k = L_k^-1 (b_k - M_{k-1} y_{k-1}),
//       x_k = L_k^-T (y_k - M_k^T x_{k+1}).
//   K13 :297-315 `BlockTridiagMV.__call__`: y_k = D_k x_k + E_{k-1} x_{k-1} +
//       E_k^T x_{k+1} over the dense diagonal blocks D (K, s, s; both
//       triangles stored) and sub-diagonal blocks E (K-1, s, s), with the RCM
//       permutation of x and y; and, as `bt_sqrt`, :272-280
//       `BandedFactor.sqrt_matvec`: y_k = L_k z_k + M_{k-1} z_{k-1} on K11's
//       panels (L_k lower triangular: its upper triangle is not read).
//   K22 bt_factor_tangent: JAX's AD of :209 `_sigma_blocks`'s input, the
//       factorization `step` (:376), in a direction Q' (the reference has no
//       kernel for it): L'_k = L_k F, F = Phi(L_k^-1 D'_k L_k^-T) with
//       D'_k = Q'_kk - U'_{k-1}, M'_k = Q'_{k+1,k} L_k^-T - M_k F^T,
//       U'_k = M'_k M_k^T + M_k M'_k^T; a cluster per chain walks the K
//       blocks, each step csrc/tangent.cuh's `panel_tangent` (float64
//       products on a workspace, their 64-row tiles dealt out over the
//       cluster on the float64 tensor cores, L_k^-1 = L_k^T A_k with A_k
//       from K8's first entry). Bound by the float64 tensor-core rate of
//       the cluster's SMs.
//   K24 bt_factor_adjoint: JAX's AD (reverse mode) of the same `step`, as
//       `jax.grad` of a sample, a block triangular solve (:145-202) or
//       :272 `sqrt_matvec` reaches it: from the factor's cotangent (L'_k, M'_k
//       in P's layout) the cotangent of Q's blocks; a cluster per chain walks
//       the K blocks backwards, each step tangent.cuh's `panel_adjoint`
//       (E'_k = M'_k L_k^-1 with M'_k less (A'_{k+1} + A'_{k+1}^T) M_k, then
//       the Cholesky adjoint of L_k), on K22's workspace and tiles. Bound,
//       like K22, by the float64 tensor-core rate of the cluster's SMs.
//   K13's second entry has a transpose mode (`bt_sqrt_t`): y_k = L_k^T z_k
//       + M_k^T z_{k+1}, the z-cotangent of sqrt_matvec. It must read L_k's
//       lower triangle and M_k once (B (K s (s + 1) / 2 + (K - 1) s^2)
//       values) and z and y once: bound by those bytes (n = 5741, B = 4,
//       K = 12, s = 512: 71 MB in f32, 0.022 ms; 143 MB in f64, 0.044 ms),
//       k flops per value. One launch: a unit is a slab of rows of a panel
//       [L_k; M_k] by 128 columns, streamed by cp.async through a ring in
//       shared memory and used by all k <= 16 right-hand sides of its chain,
//       so P is read once (beyond 16, each pass of 16 streams it again);
//       the rows above L_k's diagonal are skipped; the slabs of one column
//       tile are a cluster of up to 4, which adds their partials in rank
//       order in distributed shared memory and writes y through the
//       permutation, z gathered through it a window of rows at a time: no
//       rows_in, no rows_out, no workspace. float32 sums in float32, float64
//       in float64, each in a fixed order. In practice (an H100) the ring's
//       streaming at two blocks an SM bounds it (at k = 1 P streams at
//       1.8 TB/s in f32, 2.2 in f64), then the products at k = 16 (details
//       at bt_sqrt_t_kernel).
//   K11 and K12 have a block entry each, for the SPIKE solve
//   (tpu_gmrf/parallel/pbtridiag.py): `bt_factor_blocks` is :53 `_bt_chol`,
//   L_k = chol(D_k - M_{k-1} M_{k-1}^T), M_k = E_k L_k^-T, on blocks D, E
//   given as they are (D_k symmetrized, as jnp.linalg.cholesky does; no
//   pivot boost: a block that is not positive definite gives a NaN logdet),
//   and `bt_trsv_blocks` is :76 `_bt_solve_factored` on (B, K, s, k)
//   right-hand sides with no permutation. The first is K11's factorization
//   with the scatter swapped for the block layout; the second is a kernel of
//   its own. Both run on the cluster routines of tiles.cuh (shared with K18,
//   csrc/spike.cu).
//
// What bounds them on the card. K11 does about K s^3 (7/3) flops per chain
// (f64 at phase 17's shape, B = 4, K = 31, s = 450: 2.6e10, 0.38 ms at the
// f64 tensor-core rate; n = 5741, s = 512, K = 12, B = 4: 1.5e10) on K 2 s^2
// values, in a chain of K ceil(s / 64) dependent 64 x 64 diagonal tiles
// (248 at phase 17's shape), each a Cholesky of 64 pivots in sequence: bound
// by the latency of that chain. Its design: one launch, a thread-block
// cluster of up to 16 blocks per chain (kernels/banded.py factor_cluster
// picks the size: the fewest waves of clusters, then the largest), chain
// b's factor one array P[b] of K panels (2s x s each, rows 0..s the
// diagonal block, rows s..2s the sub-diagonal block below it) that the
// cluster factors in place, column tile by column tile (bt_chol_kernel):
// block 0 factors each diagonal tile (its update fused in, pivots by warp
// shuffles) while the other 15 blocks solve the panel below it by
// substitution (float64, a warp per 8 rows) and do the products, on the f64
// tensor cores (float32 on the FMA units; its diagonal tiles and panel
// solves in float64), two cluster barriers per column tile. The pivot boost
// is decided as the reference decides it, per chain and block: the cluster
// pass factors every chain without boost and flags breakdowns; one flag
// readback follows; the chains that broke down (rare: f32 at extreme
// conditioning) are redone from the scatter on, block by block, each block
// retried as `_chol_boosted` does, on the blocked panel Cholesky of
// dense_blocks.cuh (one block per chain and tile).
// K12 and its block entry do 2 s^2 k flops per block step and direction for
// each of B chains (f64, B = 4, K = 31, s = 450, k = 901: 1.3e11 flops, bound
// 2 ms at the f64 tensor-core rate), in a chain of 2 K dependent block
// steps: bound by the latency of that chain where k is small (K12 on the
// Newton solves: k = 1, B = 4, K = 12, s = 512; its bound, L and M read
// once, 0.043 ms in f64), by the products where it is large. One design
// serves both: a block step is the coupling W = b_k - M_{k-1} y_{k-1}, one
// product, then y_k = L_k^-1 W by row tiles of 64, right-looking: the
// diagonal tile by substitution (tile_subst, float64, a warp per 8
// right-hand sides), the tiles below it less its product (backward, M_k^T
// and L_k^-T). It solves by substitution and never multiplies by an
// inverse: the residual of a product with L_k^-1 grows with L_k's condition
// (example 04's space-time joint, L_k's condition up to 1.5e6: relative
// residual 7.5e-11 against 5.4e-16 by substitution, chip_smoke.py phase 26).
// A work unit is one chain and one column tile of 64 right-hand sides (8
// when k <= 8), a cluster of up to 8 blocks, each owning row tiles (tiles i
// and ntiles - 1 - i together when a block owns two, which evens the depths
// of the triangular updates), f64 on the tensor cores; a cluster barrier
// follows each row tile's substitution. The clusters of one chain walk the
// blocks in step, so a step's L_k and M_k (3.2 MB at s = 450) are read from
// L2 by all the chain's column tiles. K12 adds its rows' permutation and
// padding around it (rows_in gathers b into the block layout (B, K, s, k),
// rows_out scatters the solution back) and its modes: the forward sweep
// alone, the backward alone, or both.
// K13 streams (2K-1) s^2 values against 2 (3K-2) s^2 flops per vector: with
// a handful of vectors it is bound by that stream (the blocks are 30-100x
// the sparse values, most of them zeros), 87 MB in float32 at n = 14058
// (0.026 ms at 3.35 TB/s). Its design keeps that stream in flight and reads
// every block once: a unit (bt_matvec_kernel) is 64 rows of one block row
// of one chain and up to 8 vectors; it streams its rows of D_k and E_{k-1}
// (contiguous) through registers, coalesced, several rows of loads in flight
// per thread, with little shared memory (several units per SM), and from
// the same values forms both the row terms (D_k x_k + E_{k-1} x_{k-1}, rows
// of y_k) and the column term E_{k-1}^T x_k (a partial of y_{k-1} over the
// unit's rows). The units of one block row are grouped in clusters of up to
// 8, which add their column partials through distributed shared memory, so
// a partial or two per block row reach global memory; x is gathered
// through the permutation once (rows_in) into rows the units read from L2,
// and rows_out adds the partials and scatters y. Every sum is taken in a
// fixed order: nothing is atomic, and a product is the same bit for bit
// from run to run.

#include "dense_blocks.cuh"
#include "tangent.cuh"
#include "tiles.cuh"

namespace {

using namespace tgdense;

__device__ __forceinline__ int cdiv_dev(int a, int b) { return (a + b - 1) / b; }

// P[b][dst[e]] = Q's value at src[e] (averaged with its transpose when
// tperm is given), or 1 where src[e] < 0 (padding diagonal). The host has
// checked that dst holds no position twice.
template <typename T>
__global__ void bt_scatter_kernel(const T* data, long long ds, const int* src, const int* dst, int ntab,
                                  const int* tperm, T* P, long long pstride, const int* active) {
  const long long b = blockIdx.y;
  if (active && !active[b]) return;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= ntab) return;
  const int p = src[e];
  T v = T(1);
  if (p >= 0) {
    const T* d = data + b * ds;
    v = tperm ? T(0.5) * (d[p] + d[tperm[p]]) : d[p];
  }
  P[b * pstride + dst[e]] = v;
}

// dst[b][0:count] = src[b][0:count] (rows of s), plus (delta + dom[b]) on
// the diagonal (dom may be null), for the chains in `active`.
template <typename T>
__global__ void copy_shift_kernel(T* dst, long long dstride, const T* src, long long sstride, long long count, int s,
                                  T delta, const T* dom, const int* active) {
  const long long b = blockIdx.y;
  if (!active[b]) return;
  const T shift = dom ? dom[b] + delta : delta;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    T v = src[b * sstride + i];
    if (i / s == i % s) v += shift;
    dst[b * dstride + i] = v;
  }
}

template <typename T>
int copy_shift(T* dst, long long dstride, const T* src, long long sstride, long long count, int s, T delta,
               const T* dom, const int* active, int B, cudaStream_t st) {
  const long long want = (count + kThreads - 1) / kThreads;
  copy_shift_kernel<T><<<dim3(want < 1024 ? (int)want : 1024, B), kThreads, 0, st>>>(dst, dstride, src, sstride,
                                                                                       count, s, delta, dom, active);
  return (int)cudaGetLastError();
}

// Gershgorin bound of the symmetric s x s block stored as its lower
// triangle: the largest absolute row sum (NaN if any entry is NaN).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bt_dom_kernel(const T* W, long long wstride, int s, T* dom, const int* active) {
  __shared__ T red[kThreads];
  const long long b = blockIdx.x;
  if (!active[b]) return;
  const T* D = W + b * wstride;
  T m = T(0);
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc += fabs(D[(long long)i * s + j]);
    for (int j = i + 1; j < s; ++j) acc += fabs(D[(long long)j * s + i]);
    m = (acc > m || isnan(acc)) ? acc : m;
  }
  red[threadIdx.x] = m;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) {
      const T o = red[threadIdx.x + off];
      if (o > red[threadIdx.x] || isnan(o)) red[threadIdx.x] = o;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) dom[b] = red[0];
}

// Chain b's factor from its blocks (the block entry of K11): rows 0..s of
// panel k the lower triangle of (D_k + D_k^T) / 2, rows s..2s E_k (zero in the
// last panel); the whole panel is written.
template <typename T>
__global__ void bt_blocks_load_kernel(const T* D, const T* E, T* P, int K, int s) {
  const long long b = blockIdx.y;
  const long long panel = 2LL * s * s, per = panel * K, ss = (long long)s * s;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    const long long k = e / panel, rem = e % panel;
    const int r = (int)(rem / s), c = (int)(rem % s);
    T v = T(0);
    if (r < s) {
      if (c <= r) {
        const T* Dk = D + (b * K + k) * ss;
        v = T(0.5) * (Dk[(long long)r * s + c] + Dk[(long long)c * s + r]);
      }
    } else if (k < K - 1) {
      v = E[(b * (K - 1) + k) * ss + (long long)(r - s) * s + c];
    }
    P[b * per + e] = v;
  }
}

// logdet[b] = 2 sum log diag L_k; NaN for a chain whose fail flag is set
// (fail may be null).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bt_logdet_kernel(const T* P, long long pstride, int K, int s, T* logdet, const int* fail) {
  __shared__ T red[kThreads];
  const long long b = blockIdx.x;
  const long long panel = 2LL * s * s;
  T acc = T(0);
  for (int e = threadIdx.x; e < K * s; e += blockDim.x) {
    const int k = e / s, i = e % s;
    acc += log(P[b * pstride + k * panel + (long long)i * s + i]);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) logdet[b] = (fail && fail[b]) ? T(NAN) : T(2) * red[0];
}

// ---- K11: the factorization on a thread-block cluster per chain ---------------

// A cluster barrier in two halves: what a block wrote before its arrival
// (release, at cluster scope) is seen by every block of the cluster after
// its wait (acquire); the operands are read from L2 (ld.global.cg).
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// C (Mr x Nc, both <= 64) -= A B^T (`sub`) or = A B^T, A Mr x Kd and B Nc x
// Kd row-major (row strides lda, ldb): every product of the factorization
// has both operands contiguous along the summed index. Each 32-deep slice
// of A and B is staged as it lies (rows of kLdK values: the stores and the
// mma fragment loads are free of bank conflicts), the next slice loaded
// into registers while the current one is multiplied; the accumulators and
// the fragments are tiles.cuh's (Acc, Cfg<64>, tile_io). Every thread of
// the block calls it; it ends with a block barrier.
constexpr int kLdK = tgtile::kKS + 4;
template <typename T>
__device__ __noinline__ void chol_gemm(T* C, long long ldc, const T* A, long long lda, const T* B, long long ldb,
                                       int Mr, int Nc, int Kd, bool sub, T* sm) {
  using namespace tgtile;
  using Cf = Cfg<64>;
  constexpr int V = kT * kKS / kThr;  // values of A (and of B) a thread stages per slice
  // steps of a slice unrolled: float64 two (fragments of two steps in flight; more spill), float32 all
  constexpr int kUnroll = sizeof(T) == 8 ? 2 : kKS / 4;
  T* As = sm;                         // [2][kT][kLdK]
  T* Bs = sm + 2 * kT * kLdK;         // [2][kT][kLdK]
  const int tid = threadIdx.x, p = tid % kKS, r0 = tid / kKS;  // row r0 + 8 u, column p of a slice
  Acc<T, 64> acc;
  if (sub)
    tile_io<T, 64, true>(acc, C, ldc, Mr, Nc);
  else
    acc.zero();
  T ra[V], rb[V];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int r = r0 + u * (kThr / kKS);
      const bool in = k0 + p < Kd;
      ra[u] = in && r < Mr ? ldcg(A + r * lda + k0 + p) : T(0);
      rb[u] = in && r < Nc ? ldcg(B + r * ldb + k0 + p) : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int at = (buf * kT + r0 + u * (kThr / kKS)) * kLdK + p;
      As[at] = sub ? -ra[u] : ra[u];
      Bs[at] = rb[u];
    }
  };
  const int lane = tid & 31, warp = tid >> 5, wm = warp % Cf::WM, wn = warp / Cf::WM;
  const int g = lane >> 2, q = lane & 3, m0 = wm * (kT / Cf::WM), n0 = wn * (64 / Cf::WN);
  const int slices = (Kd + kKS - 1) / kKS;
  if (slices > 0) {
    load(0);
    store(0);
    __syncthreads();
  }
  for (int sl = 0; sl < slices; ++sl) {
    if (sl + 1 < slices) load((sl + 1) * kKS);
    const T* a_s = As + (sl & 1) * kT * kLdK;
    const T* b_s = Bs + (sl & 1) * kT * kLdK;
#pragma unroll kUnroll
    for (int kk = 0; kk < kKS; kk += 4) {
      if constexpr (sizeof(T) == 8) {  // mma.sync m16n8k4, A(m, k) at a_s[m][k], B(k, n) at b_s[n][k]
        double a[Cf::MT / 2][2], b[Cf::NTT];
#pragma unroll
        for (int i = 0; i < Cf::MT / 2; ++i) {
          a[i][0] = a_s[(m0 + 16 * i + g) * kLdK + kk + q];
          a[i][1] = a_s[(m0 + 16 * i + 8 + g) * kLdK + kk + q];
        }
#pragma unroll
        for (int j = 0; j < Cf::NTT; ++j) b[j] = b_s[(n0 + 8 * j + g) * kLdK + kk + q];
#pragma unroll
        for (int i = 0; i < Cf::MT / 2; ++i)
#pragma unroll
          for (int j = 0; j < Cf::NTT; ++j)
            asm volatile(
                "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                : "+d"(acc.v[2 * i][j][0]), "+d"(acc.v[2 * i][j][1]), "+d"(acc.v[2 * i + 1][j][0]),
                  "+d"(acc.v[2 * i + 1][j][1])
                : "d"(a[i][0]), "d"(a[i][1]), "d"(b[j]));
      } else {  // the FMA units
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          T a[Cf::MT], b[Cf::NTT][2];
#pragma unroll
          for (int i = 0; i < Cf::MT; ++i) a[i] = a_s[(m0 + 8 * i + g) * kLdK + kk + e];
#pragma unroll
          for (int j = 0; j < Cf::NTT; ++j) {
            b[j][0] = b_s[(n0 + 8 * j + 2 * q) * kLdK + kk + e];
            b[j][1] = b_s[(n0 + 8 * j + 2 * q + 1) * kLdK + kk + e];
          }
#pragma unroll
          for (int i = 0; i < Cf::MT; ++i)
#pragma unroll
            for (int j = 0; j < Cf::NTT; ++j) {
              acc.v[i][j][0] += a[i] * b[j][0];
              acc.v[i][j][1] += a[i] * b[j][1];
            }
        }
      }
    }
    if (sl + 1 < slices) store((sl + 1) & 1);
    __syncthreads();
  }
  tile_io<T, 64, false>(acc, C, ldc, Mr, Nc);
  __syncthreads();
}

// Substitution with the lower t x t tile L (t <= 64, row stride ld, read
// from L2): out = L^-1 in, or L^-T in with `trans`, for nr <= NR right-hand
// sides, element j of right-hand side c at in[j se + c sr] (and out's), in
// float64 and rounded once. L and its pivots' reciprocals are staged in
// shared memory (sm: 64 kLdS + 64 doubles); warp w takes right-hand sides
// w + 8 u, lane l their elements l and l + 32, and each pivot's solution
// value passes to the other lanes by a shuffle (K7's diagonal step). Unlike a
// product with an inverted tile, its residual does not grow with L's
// condition. in and out may be one array. Every thread of the block calls
// it; it ends with a block barrier.
template <typename T, int NR>
__device__ __noinline__ void tile_subst(const T* L, long long ld, int t, bool trans, const T* in, T* out,
                                        long long se, long long sr, int nr, double* sm) {
  using namespace tgtile;
  constexpr int CPW = NR / 8;
  double* Ls = sm;
  double* rd = sm + kT * kLdS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < kTT; e += kThr) {
    const int r = e / kT, c = e % kT;
    Ls[r * kLdS + c] = (r < t && c <= r) ? double(ldcg(L + r * ld + c)) : 0.0;
  }
  if (tid < kT) rd[tid] = tid < t ? 1.0 / double(ldcg(L + tid * (ld + 1))) : 0.0;
  double v0[CPW], v1[CPW];
#pragma unroll
  for (int u = 0; u < CPW; ++u) {
    const int c = warp + 8 * u;
    v0[u] = c < nr && lane < t ? double(ldcg(in + lane * se + c * sr)) : 0.0;
    v1[u] = c < nr && lane + 32 < t ? double(ldcg(in + (lane + 32) * se + c * sr)) : 0.0;
  }
  __syncthreads();
  if (!trans) {
#pragma unroll 4
    for (int jj = 0; jj < t; ++jj) {
      const double l0 = Ls[lane * kLdS + jj], l1 = Ls[(lane + 32) * kLdS + jj], r = rd[jj];
#pragma unroll
      for (int u = 0; u < CPW; ++u) {
        const double yj = __shfl_sync(0xffffffffu, jj < 32 ? v0[u] : v1[u], jj & 31) * r;
        if (jj < 32) {
          v0[u] = lane == jj ? yj : v0[u] - l0 * yj;  // L[lane][jj] = 0 above the diagonal
          v1[u] -= l1 * yj;
        } else {
          v1[u] = lane + 32 == jj ? yj : v1[u] - l1 * yj;
        }
      }
    }
  } else {
#pragma unroll 4
    for (int jj = t - 1; jj >= 0; --jj) {
      const double l0 = Ls[jj * kLdS + lane], l1 = Ls[jj * kLdS + lane + 32], r = rd[jj];
#pragma unroll
      for (int u = 0; u < CPW; ++u) {
        const double yj = __shfl_sync(0xffffffffu, jj < 32 ? v0[u] : v1[u], jj & 31) * r;
        if (jj < 32) {
          v0[u] = lane == jj ? yj : v0[u] - l0 * yj;  // L[jj][lane] = 0 right of the diagonal
        } else {
          v1[u] = lane + 32 == jj ? yj : v1[u] - l1 * yj;
          v0[u] -= l0 * yj;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < CPW; ++u) {
    const int c = warp + 8 * u;
    if (c < nr && lane < t) out[lane * se + c * sr] = T(v0[u]);
    if (c < nr && lane + 32 < t) out[(lane + 32) * se + c * sr] = T(v1[u]);
  }
  __syncthreads();
}

template <typename T>
struct TileWork {
  using type = T;
};
template <>
struct TileWork<float> {
  using type = double;
};
template <typename T>
__device__ __noinline__ void chol_tile(T* D, long long ld, int t, int* bad, T* sm, T tiny, const T* U = nullptr,
                                       long long ldu = 0, int du = 0) {
  tgtile::factor_tile(D, ld, t, (T*)nullptr, bad, reinterpret_cast<typename TileWork<T>::type*>(sm), tiny, U, ldu,
                      du);
}

// The blocked Cholesky of chain blockIdx.y's block-tridiagonal matrix, held
// in P as its K panels (A_k's lower triangle in rows 0..s of panel k, E_k in
// rows s..2s; zeros above the diagonal), in place: L_k and M_k. Block step k
// walks L_k's column tiles of 64, j = 0 .. nt - 1 (nt = ceil(s / 64)), each
// in two phases:
//   the panel: L_k's row tiles below the diagonal tile j and M_k's row tiles
//     solved by substitution with the diagonal tile (L(a, j) = A(a, j)
//     L_jj^-T, tile_subst: a product with L_jj's inverse would leave a
//     backward error that grows with L_jj's condition), dealt out over the
//     cluster; block 0's first tile is the row tile of the next
//     diagonal tile. Its barrier is split: block 0 arrives, then factors the
//     next diagonal tile (L(j + 1, j + 1), or A_{k+1}(0, 0) after the last
//     column tile; its update by column tile j fused in), then waits. The
//     tile factors are the chain's critical path, and this takes each one
//     off the path of the panel and its barrier.
//   the update, ended by a cluster barrier: the other blocks share M_k's
//     tiles of column j + 1 (left-looking: all of M_k's finished columns at
//     once, so an M tile is summed in registers and rounded once), the lower
//     tiles of A_{k+1} = D_{k+1} - M_k M_k^T (two column tiles of M_k at a
//     time, spread over the updates, so that U_k's products fill the time
//     of the tile factors) and L_k's trailing tiles (right-looking).
// Block 0 factors the diagonal tiles (tiles.cuh factor_tile; a float32 tile
// in float64) in place. *bad is set for a pivot that is not finite and above
// tiny; the chain goes on.
template <typename T>
__global__ void __launch_bounds__(tgtile::kThr, 1)
    bt_chol_kernel(T* P, int K, int s, T tiny, int* bad) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x;  // the grid is (cluster size, B)
  const long long panel = 2LL * s * s, ss = (long long)s * s;
  T* Pb = P + blockIdx.y * panel * K;
  int* flag = bad + blockIdx.y;
  const int nt = ntiles(s);
  // U_k's chunks of two column tiles of M_k spread over the updates before the last; the rest at the last
  const int spread = nt >= 4 ? (nt - 2) / 2 : 0, u_last = 2 * spread * kT;
  // an update's products go to blocks 1 .. cs - 1 (all to block 0 in a cluster of one) in snake order, the
  // deepest first, so that each block's share takes about as long
  const int W = cs - 1;
  int pos = 0, fwd = 1;
  auto mine = [&]() {  // the owner of the next product
    if (W == 0) return true;
    const bool own = 1 + (fwd ? pos : W - 1 - pos) == rank;
    if (++pos == W) pos = 0, fwd ^= 1;
    return own;
  };
  auto rows = [&](int i) { return min(kT, s - i * kT); };  // height of row tile i
  if (rank == 0) chol_tile(Pb, s, rows(0), flag, sm, tiny);
  cluster_barrier();
  for (int k = 0; k < K; ++k) {
    T* L = Pb + k * panel;  // L_k, then M_k (E_k until it is solved) s rows below
    T* M = L + ss;
    T* A = L + panel;  // D_{k+1}, then A_{k+1}
    const bool more = k < K - 1;
    for (int j = 0; j < nt; ++j) {
      const int j0 = j * kT, tj = rows(j), below = nt - 1 - j;
      if (!more && below == 0) break;  // the last column tile of the last block
      const bool last = below == 0;
      const int n1 = j0 + kT, t1 = rows(last ? 0 : j + 1);
      // the panel; block 0's first row tile is the one the next diagonal tile's update needs
      for (int a = rank; a < below + (more ? nt : 0); a += cs) {
        T* C = a < below ? L + (long long)(j + 1 + a) * kT * s + j0 : M + (long long)(a - below) * kT * s + j0;
        tile_subst<T, 64>(L + (long long)j0 * s + j0, s, tj, false, C, C, 1, s, rows(a < below ? j + 1 + a : a - below),
                          reinterpret_cast<double*>(sm));
      }
      // the panel barrier, split: block 0 factors the next diagonal tile (L(j + 1, j + 1), or A_{k+1}(0, 0)
      // after the last column tile) between its arrival and its wait, its update by column tile j fused in,
      // while the other blocks go on with the update
      cluster_arrive();
      if (rank == 0) {
        if (last)
          chol_tile(A, s, t1, flag, sm, tiny, (const T*)M + u_last, s, s - u_last);
        else
          chol_tile(L + (long long)n1 * s + n1, s, t1, flag, sm, tiny, (const T*)L + (long long)n1 * s + j0, s, tj);
      }
      cluster_wait();
      // the update (none of it block 0's, unless the cluster is one block): M_k's tiles of column j + 1
      // (left-looking, the deepest products), U_k's products into A_{k+1}'s lower tiles and L_k's trailing tiles
      pos = 0, fwd = 1;
      for (int a = 0; (rank > 0 || W == 0) && more && !last && a < nt; ++a)  // M(a, j+1) -= M(a, :n1) L(j+1, :n1)^T
        if (mine())
          chol_gemm<T>(M + (long long)a * kT * s + n1, s, M + (long long)a * kT * s, s, L + (long long)n1 * s, s,
                       rows(a), t1, n1, true, sm);
      // A_{k+1}(a, b) -= M(a, q) M(b, q)^T over M's columns q in chunks: the chunk of column tiles 2h, 2h + 1
      // (h < spread) in the updates of column tiles 2h + 1 and 2h + 2, half of the tiles in each; the rest,
      // from column u_last on, after the last column tile
      const int h = (j - 1) / 2, q0 = last ? u_last : 2 * h * kT;
      const bool chunk = more && (last || (j >= 1 && h < spread));
      int u = 0;
      for (int a = 0; (rank > 0 || W == 0) && chunk && a < nt; ++a)
        for (int b = 0; b <= a; ++b, ++u)
          if (last ? a > 0 : u % 2 == (j - 1) % 2)
            if (mine())
              chol_gemm<T>(A + (long long)a * kT * s + b * kT, s, M + (long long)a * kT * s + q0, s,
                           M + (long long)b * kT * s + q0, s, rows(a), rows(b), last ? s - q0 : 2 * kT, true, sm);
      for (int a = j + 2; (rank > 0 || W == 0) && a < nt; ++a)  // L(a, b) -= L(a, j) L(b, j)^T, j < b <= a
        for (int b = j + 1; b <= a; ++b)
          if (mine())
            chol_gemm<T>(L + (long long)a * kT * s + b * kT, s, L + (long long)a * kT * s + j0, s,
                         L + (long long)b * kT * s + j0, s, rows(a), rows(b), tj, true, sm);
      cluster_barrier();
    }
  }
}

// Shared memory of the cluster factorization: what the products and the
// tile factor need, raised above half an SM's so that no two blocks share an SM.
template <typename T>
size_t chol_smem() {
  using namespace tgtile;
  const size_t prod = sizeof(T) * 4 * kT * kLdK;
  const size_t tile = sizeof(double) * (2 * kT * kLdS + kT + 2 * kT * (kKS + 4));  // + sub_gram's staging
  const size_t need = prod > tile ? prod : tile, one = 116 * 1024;
  return need > one ? need : one;
}

// How many clusters of cs blocks of the factorization the card holds at once
// (0 for a cluster size it refuses).
template <typename T>
int chol_fit(int cs, int* count) {
  return tgtile::cluster_fit(bt_chol_kernel<T>, cs, chol_smem<T>(), count);
}

template <typename T>
int launch_chol(T* P, int K, int s, T tiny, int* bad, int cs, int B, cudaStream_t st) {
  return tgtile::launch_cluster(bt_chol_kernel<T>, dim3(cs, B), cs, chol_smem<T>(), st, P, K, s, tiny, bad);
}

// K11: scatter, the cluster factorization of every chain with no boost
// (breakdown at l <= 30 eps), one flag readback; the chains that broke down
// are redone from the scatter on, block by block, each block retried as
// `_chol_boosted` does (the blocked panel Cholesky of dense_blocks.cuh on
// the chains in `redo`).
template <typename T>
int launch_factor(const T* data, long long ds, const int* src, const int* dst, int ntab, const int* tperm, T* P,
                  int K, int s, T* ws, T* dom, int* boost, T* logdet, int* flags, int cs, int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int* fail = flags;
  int* redo = flags + B;
  int* r1 = flags + 2 * B;
  int* r2 = flags + 3 * B;
  const long long panel = 2LL * s * s, pstride = panel * K;
  const T tiny = T(30) * Eps<T>::v, delta = T(2e-6 * s);
  const dim3 sgrid(cdiv(ntab, kThreads), B);
  int rc = (int)cudaMemsetAsync(fail, 0, sizeof(int) * B, st);
  if (!rc) rc = (int)cudaMemsetAsync(boost, 0, sizeof(int) * B, st);
  if (!rc) rc = (int)cudaMemsetAsync(P, 0, sizeof(T) * pstride * B, st);
  if (rc) return rc;
  // fast pass: every chain, every block, no boost
  bt_scatter_kernel<T><<<sgrid, kThreads, 0, st>>>(data, ds, src, dst, ntab, tperm, P, pstride, nullptr);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = launch_chol<T>(P, K, s, tiny, fail, cs, B, st))) return rc;
  bool any;
  if ((rc = any_failed(fail, B, st, &any))) return rc;
  if (any) {
    if ((rc = take_failed(nullptr, fail, redo, nullptr, B, st))) return rc;
    if ((rc = fill<T>(P, pstride, pstride, T(0), redo, B, st))) return rc;
    bt_scatter_kernel<T><<<sgrid, kThreads, 0, st>>>(data, ds, src, dst, ntab, tperm, P, pstride, redo);
    if ((rc = (int)cudaGetLastError())) return rc;
    for (int k = 0; k < K; ++k) {
      T* Pk = P + k * panel;
      const int H = k < K - 1 ? 2 * s : s;
      const long long count = (long long)H * s;
      if ((rc = copy_shift<T>(ws, panel, Pk, pstride, count, s, T(0), nullptr, redo, B, st))) return rc;
      if ((rc = factor_panels<T>(Pk, pstride, s, H, s, tiny, redo, fail, B, st))) return rc;
      if ((rc = any_failed(fail, B, st, &any))) return rc;
      if (any) {
        if ((rc = take_failed(redo, fail, r1, boost, B, st))) return rc;
        if ((rc = copy_shift<T>(Pk, pstride, ws, panel, count, s, delta, nullptr, r1, B, st))) return rc;
        if ((rc = factor_panels<T>(Pk, pstride, s, H, s, tiny, r1, fail, B, st))) return rc;
        if ((rc = any_failed(fail, B, st, &any))) return rc;
        if (any) {
          // the last attempt is PD by Gershgorin; it is not checked
          if ((rc = take_failed(r1, fail, r2, nullptr, B, st))) return rc;
          bt_dom_kernel<T><<<B, kThreads, 0, st>>>(ws, panel, s, dom, r2);
          if ((rc = (int)cudaGetLastError())) return rc;
          if ((rc = copy_shift<T>(Pk, pstride, ws, panel, count, s, delta, dom, r2, B, st))) return rc;
          if ((rc = factor_panels<T>(Pk, pstride, s, H, s, tiny, r2, fail, B, st))) return rc;
          if ((rc = (int)cudaMemsetAsync(fail, 0, sizeof(int) * B, st))) return rc;
        }
      }
      if (k < K - 1) {  // D_{k+1} -= M_k M_k^T
        syrk_lower_kernel<T><<<dim3(cdiv(s, kGB), cdiv(s, kGB), B), kThreads, 0, st>>>(
            Pk + panel, pstride, s, Pk + (long long)s * s, pstride, s, s, s, s, redo);
        if ((rc = (int)cudaGetLastError())) return rc;
      }
    }
  }
  bt_logdet_kernel<T><<<B, kThreads, 0, st>>>(P, pstride, K, s, logdet, nullptr);
  return (int)cudaGetLastError();
}

// The block entry of K11: the factor of the blocks D (B, K, s, s), E (B, K-1,
// s, s): the panels loaded (D_k symmetrized), then the cluster factorization
// with no boost. A pivot that is not finite and positive is left as it
// comes (NaN for a negative one) and sets the chain's flag, whose logdet is
// then NaN, as an unboosted Cholesky gives.
template <typename T>
int launch_factor_blocks(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, int cs, int B,
                         void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long pstride = 2LL * s * s * K;
  const long long want = (pstride + kThreads - 1) / kThreads;
  int rc = (int)cudaMemsetAsync(flags, 0, sizeof(int) * B, st);
  if (rc) return rc;
  bt_blocks_load_kernel<T><<<dim3(want < 1024 ? (int)want : 1024, B), kThreads, 0, st>>>(D, E, P, K, s);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = launch_chol<T>(P, K, s, T(0), flags, cs, B, st))) return rc;
  bt_logdet_kernel<T><<<B, kThreads, 0, st>>>(P, pstride, K, s, logdet, flags);
  return (int)cudaGetLastError();
}

// Rows of right-hand sides (B k, n), chain-major, into a block layout and
// back: rows_in writes dst(b, c, g) = x[(b k + c) n + perm[g]] for g < n and
// c < k, zero for n <= g < Ks and for k <= c < kp, at dst + b sb + c sc + g
// sg (the permutation and the padding of K12 and K13); rows_out writes
// out[(b k + c) n + perm[g]] = src(b, c, g) (same strides) for g < n and
// c < k, plus, where part is given, the P partial column sums of K13 at
// part[(((b kp + c) (K - 1) + g / s) P + p) s + g % s] for g < (K - 1) s,
// added in the order p = 0, 1, ...
template <typename T>
__global__ void bt_rows_in_kernel(const T* __restrict__ x, const int* __restrict__ perm, int n, int k, int kp,
                                  long long Ks, long long total, T* __restrict__ dst, long long sb, long long sc,
                                  long long sg) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e % Ks, bc = e / Ks, b = bc / kp;
    const int c = (int)(bc % kp);
    dst[b * sb + c * sc + g * sg] = g < n && c < k ? x[(b * k + c) * n + perm[g]] : T(0);
  }
}

template <typename T>
__global__ void bt_rows_out_kernel(const T* __restrict__ src, long long sb, long long sc, long long sg,
                                   const int* __restrict__ perm, int n, int k, int kp, long long total,
                                   T* __restrict__ out, const T* __restrict__ part, int P, int K, int s) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long g = e % n, bc = e / n, b = bc / k;
    const int c = (int)(bc % k);
    T v = src[b * sb + c * sc + g * sg];
    const int kb = (int)(g / s);
    if (part && kb < K - 1) {
      const T* pt = part + (((b * kp + c) * (K - 1) + kb) * P) * (long long)s + g % s;
      for (int p = 0; p < P; ++p) v += pt[(long long)p * s];
    }
    out[(b * k + c) * n + perm[g]] = v;
  }
}

inline int stream_grid(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return want < 4096 ? (int)(want > 0 ? want : 1) : 4096;
}

template <typename T>
int rows_in(const T* x, const int* perm, int n, int k, int kp, int B, long long Ks, T* dst, long long sb,
            long long sc, long long sg, cudaStream_t st) {
  const long long total = (long long)B * kp * Ks;
  bt_rows_in_kernel<T><<<stream_grid(total), kThreads, 0, st>>>(x, perm, n, k, kp, Ks, total, dst, sb, sc, sg);
  return (int)cudaGetLastError();
}

template <typename T>
int rows_out(const T* src, long long sb, long long sc, long long sg, const int* perm, int n, int k, int kp, int B,
             T* out, const T* part, int P, int K, int s, cudaStream_t st) {
  const long long total = (long long)B * k * n;
  bt_rows_out_kernel<T><<<stream_grid(total), kThreads, 0, st>>>(src, sb, sc, sg, perm, n, k, kp, total, out, part,
                                                                 P, K, s);
  return (int)cudaGetLastError();
}

// Whether block `rank` of a cluster of cs owns row tile i of nt: i % cs, or,
// with at least two tiles per block, i and nt - 1 - i together (the
// forward and backward updates of tile i are i and nt - 1 - i tiles deep).
__device__ __forceinline__ bool owns(int i, int nt, int rank, int cs) {
  return (2 * cs <= nt ? (i < nt - 1 - i ? i : nt - 1 - i) : i) % cs == rank;
}

// Shared memory of K12's cluster at column tile NT: the products' staging,
// or a diagonal tile and its pivots' reciprocals in float64 (tile_subst).
template <typename T, int NT>
constexpr size_t trsv_smem() {
  using namespace tgtile;
  return sizeof(T) * 2 * kKS * (Cfg<NT>::LDA + Cfg<NT>::LDB) > sizeof(double) * (kT * kLdS + kT)
             ? sizeof(T) * 2 * kKS * (Cfg<NT>::LDA + Cfg<NT>::LDB)
             : sizeof(double) * (kT * kLdS + kT);
}

// K12 and its block entry: cluster (col, chain) solves columns NT col .. NT
// col + q of its chain's right-hand sides Bin (B, K, s, k) into X (Bin may
// be X), forward (mode 0), backward (mode 1) or both (mode 2). Block `rank`
// of the cluster owns the row tiles of `owns`. A block step is the
// coupling, W_i = X_i - M_{k-1}[i, :] y_{k-1} (or X_i - M_k[:, i]^T x_{k+1};
// Bin_i in place of X_i going forward) into the scratch W (B, s, k) for
// every owned tile at once, then the block substitution with L_k by row
// tiles, right-looking: the owner of tile i solves it with the diagonal
// tile (tile_subst), a cluster barrier publishes it, and every block
// subtracts its contribution from the tiles it owns further on (L_k[i', i]
// X_i forward, L_k[i, i']^T X_i backward), the next tile's owner first.
// The backward sweep alone starts from Bin.
template <typename T, int NT>
__global__ void __launch_bounds__(tgtile::kThr, 2)
    bt_trsv_blocks_kernel(const T* P, int K, int s, const T* Bin, T* X, T* W, int k, int mode) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  double* dsm = reinterpret_cast<double*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, nt = ntiles(s);
  const int c0 = blockIdx.y * NT, q = min(NT, k - c0);
  const long long panel = 2LL * s * s, ss = (long long)s * s, rows = (long long)s * k;  // rows: one block row of X
  const T* Pb = P + blockIdx.z * panel * K;
  const T* Bb = Bin + blockIdx.z * rows * K + c0;
  T* Xb = X + blockIdx.z * rows * K + c0;
  T* Wb = W + blockIdx.z * rows + c0;
  auto height = [&](int i) { return min(kT, s - i * kT); };
  for (int blk = 0; mode != 1 && blk < K; ++blk) {
    T* V = Xb + blk * rows;
    const T* Lk = Pb + blk * panel;
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const T* Mi = blk ? Pb + (blk - 1) * panel + ss + i0 * s : Pb;  // no coupling into block 0
      gemm_rows<T, NT>(Wb + i0 * k, k, Mi, s, 1, blk ? V - rows : V, k, 1, height(i), q, blk ? s : 0, true, sm,
                       Bb + blk * rows + i0 * k);
    }
    for (int i = 0; i < nt; ++i) {
      const long long i0 = (long long)i * kT;
      if (owns(i, nt, rank, cs)) tile_subst<T, NT>(Lk + i0 * s + i0, s, height(i), false, Wb + i0 * k, V + i0 * k, k, 1, q, dsm);
      csync();
      for (int a = i + 1; a < nt; ++a)  // W_a -= L_k[a, i] X_i
        if (owns(a, nt, rank, cs))
          gemm_rows<T, NT>(Wb + (long long)a * kT * k, k, Lk + (long long)a * kT * s + i0, s, 1, V + i0 * k, k, 1,
                           height(a), q, height(i), true, sm);
    }
  }
  for (int blk = K - 1; mode != 0 && blk >= 0; --blk) {
    T* V = Xb + blk * rows;
    const T* Lk = Pb + blk * panel;
    const T* U = mode == 1 ? Bb + blk * rows : V;  // the right-hand side of this block step
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const bool last = blk == K - 1;  // no coupling out of the last block
      gemm_rows<T, NT>(Wb + i0 * k, k, Lk + ss + i0, 1, s, last ? V : V + rows, k, 1, height(i), q, last ? 0 : s, true,
                       sm, U + i0 * k);
    }
    for (int i = nt - 1; i >= 0; --i) {
      const long long i0 = (long long)i * kT;
      if (owns(i, nt, rank, cs)) tile_subst<T, NT>(Lk + i0 * s + i0, s, height(i), true, Wb + i0 * k, V + i0 * k, k, 1, q, dsm);
      csync();
      for (int a = i - 1; a >= 0; --a)  // W_a -= L_k[i, a]^T X_i
        if (owns(a, nt, rank, cs))
          gemm_rows<T, NT>(Wb + (long long)a * kT * k, k, Lk + i0 * s + (long long)a * kT, 1, s, V + i0 * k, k, 1,
                           height(a), q, height(i), true, sm);
    }
  }
}

// K12's solve on blocks (both entries): one cluster of up to 8 blocks (one
// per row tile) per chain and column tile of 64 right-hand sides (8 when
// k <= 8). b and out may be one array. work: W (B s k).
template <typename T>
int launch_trsv_blocks(const T* P, int K, int s, const T* b, T* out, int k, int B, T* W, int mode, cudaStream_t st) {
  using namespace tgtile;
  if (B == 0 || k == 0 || K == 0) return 0;
  const int nt = ntiles(s);
  const size_t smem64 = trsv_smem<T, 64>();
  // a block per row tile (up to 8), or a block per two when that fits all the clusters on the card at once
  const int nt2 = cdiv(nt, 2);
  int cs = nt < 8 ? nt : 8, fit = 0;
  if (k <= 8)
    return launch_cluster(bt_trsv_blocks_kernel<T, 8>, dim3(cs, cdiv(k, 8), B), cs, trsv_smem<T, 8>(), st, P, K, s, b,
                          out, W, k, mode);
  const int clusters = cdiv(k, 64) * B;
  if (nt2 > 1 && nt2 < cs && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(nt2, cdiv(k, 64), B), nt2, smem64, &fit) &&
      fit >= clusters && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, &fit) &&
      fit < clusters)
    cs = nt2;
  cudaGetLastError();
  return launch_cluster(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, st, P, K, s, b, out, W, k,
                        mode);
}

// K12: rows b (B k, n), chain-major, gathered through perm and padded into
// X (B, K, s, k), solved there in place (mode 0 L, 1 L^T, 2 both;
// launch_trsv_blocks), scattered back into out. work: X, then the block
// entry's workspace.
template <typename T>
int launch_trsv(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, int B,
                T* work, void* stream) {
  if (B == 0 || k == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long Ks = (long long)K * s;
  T* X = work;
  int rc = rows_in<T>(b, perm, n, k, k, B, Ks, X, Ks * k, 1, k, st);
  if (!rc) rc = launch_trsv_blocks<T>(P, K, s, X, X, k, B, X + B * Ks * k, mode, st);
  if (!rc) rc = rows_out<T>(X, Ks * k, 1, k, perm, n, k, k, B, out, nullptr, 0, K, s, st);
  return rc;
}

// ---- K13 ------------------------------------------------------------------

constexpr int kMvR = 64;        // rows of a matrix block per unit (a strip)
constexpr int kMvMaxThr = 512;  // threads of a unit, at most
constexpr int kMvG = 4;         // rows of loads per stage (two stages in flight)

// The sums over a warp's 32 lanes of NV values (a power of two) held in a
// lane-dependent order: slot i of lane l holds vector i ^ vec_of(l), where
// vec_of(l) reverses the low log2 NV bits of l (a bijection on the lanes
// below NV). Halving: each step (H = NV / 2, ..., 1, lane bit NV / 2H)
// adds the partner's slot i + H, which holds the vector of the lane's own
// slot i, to slot i (NV - 1 shuffles, no selects), then the butterfly over
// the lanes left (5 - log2 NV). Lane l returns the sum of vector vec_of(l).
template <int NV>
__device__ __forceinline__ int vec_of(int lane) {
  int v = 0;
#pragma unroll
  for (int bit = 1, h = NV / 2; bit < NV; bit *= 2, h /= 2)
    if (lane & bit) v += h;
  return v;
}
template <typename T, int NV, int H>
__device__ __forceinline__ void halve(T (&a)[NV]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int i = 0; i < H; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i + H], NV / (2 * H));
    halve<T, NV, H / 2>(a);
  }
}
template <typename T, int NV>
__device__ __forceinline__ T warp_sums(T (&a)[NV]) {
  halve<T, NV, NV / 2>(a);
  T r = a[0];
#pragma unroll
  for (int bit = NV; bit < 32; bit *= 2) r += __shfl_xor_sync(0xffffffffu, r, bit);
  return r;
}

// NV values at p (16-byte aligned when NV fills 16 bytes), by 16-byte loads.
template <typename T, int NV>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[NV]) {
  constexpr int per = 16 / sizeof(T);
  if constexpr (NV % per == 0) {
    struct alignas(16) V { T v[per]; };
#pragma unroll
    for (int q = 0; q < NV / per; ++q) {
      const V t = reinterpret_cast<const V*>(p)[q];
#pragma unroll
      for (int u = 0; u < per; ++u) out[q * per + u] = t.v[u];
    }
  } else {
#pragma unroll
    for (int v = 0; v < NV; ++v) out[v] = p[v];
  }
}

// One unit of K13: rows i0 .. i0 + kMvR of block row k of chain cb / chunks
// (grid (strips, K, B chunks)), NV vectors at once, blockDim.x threads (a
// multiple of 32, at most 512). It streams its rows of D_k and E_{k-1}
// (row-major, contiguous: kMvR s values of each) once, through registers:
// a pass covers W = blockDim.x CPL columns (thread t the columns
// c0 + t + blockDim.x m, coalesced), kMvG rows of loads at a time with the
// next kMvG rows' loads in flight, and for each row
//   the row terms D_k[r, :] x_k + E_{k-1}[r, :] x_{k-1}: each thread's
//     products summed over its columns, then over the warp (warp_sums) into
//     the warp's row sum in shared memory, then over the warps in order:
//     rows of y_k, written whole to yb;
//   with UPPER, the column term E_{k-1}^T x_k: each thread adds
//     E_{k-1}[r, j] x_k[i0 + r] into its columns' sums (registers), which
//     cover the unit's rows; at the end of the pass the cluster (the cs units
//     of consecutive strips of block row k) adds its units' sums in rank
//     order through distributed shared memory, each block a share of the
//     columns, into one partial of y_{k-1} (part, P per block row), which
//     rows_out adds.
// x comes permuted and padded, (B chunks NV, K s) rows of xp (rows_in);
// lower: only j <= i of the diagonal block is read (bt_sqrt's L_k). Every
// sum is taken in a fixed order: nothing is atomic, and a product is the
// same bit for bit from run to run.
template <typename T, int NV, int CPL, bool UPPER>
__global__ void __launch_bounds__(kMvMaxThr)
    bt_matvec_kernel(const T* __restrict__ diag, long long diag_k, long long diag_b, const T* __restrict__ sub,
                     long long sub_k, long long sub_b, int K, int s, int lower, int chunks, int P,
                     const T* __restrict__ xp, T* __restrict__ yb, T* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = blockDim.x, W = nthr * CPL, warps = nthr >> 5;
  constexpr int R = kMvR;
  T* xr = reinterpret_cast<T*>(smem_raw);  // [R][NV]: x_k at the unit's rows
  T* rs = xr + NV * R;                     // [warp][R][NV]: each warp's row sums
  T* ts = rs + warps * R * NV;             // [NV][W]: the unit's column sums of a pass (UPPER)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.y;
  const long long cb = blockIdx.z, b = cb / chunks, Ks = (long long)K * s;
  const int i0 = blockIdx.x * R, rows = min(R, s - i0);  // rows <= 0: a cluster's padding unit
  const bool has_e = k > 0;
  const T* xv = xp + cb * NV * Ks;
  const T* Dk = diag + b * diag_b + k * diag_k + (long long)i0 * s;
  const T* Em = has_e ? sub + b * sub_b + (long long)(k - 1) * sub_k + (long long)i0 * s : sub;
  for (int e = tid; e < NV * R; e += nthr) {
    const int r = e / NV, v = e % NV;
    xr[e] = r < rows ? xv[v * Ks + (long long)k * s + i0 + r] : T(0);
  }
  for (int e = tid; e < warps * R * NV; e += nthr) rs[e] = T(0);
  __syncthreads();
  // every unit of a cluster makes the same passes (UPPER has no `lower`); with `lower`, the columns beyond the
  // unit's last row are still E's
  const int cend = UPPER ? s : (rows > 0 ? (lower && !has_e ? min(s, i0 + rows) : s) : 0);
  const int myv = vec_of<NV>(lane);
  for (int c0 = 0; c0 < cend; c0 += W) {
    T xk[CPL][NV], xm[CPL][NV], tc[CPL][NV];
#pragma unroll
    for (int m = 0; m < CPL; ++m) {  // xk, xm in warp_sums' order: slot i holds vector i ^ myv
      const int j = c0 + tid + m * nthr;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const long long at = (i ^ myv) * Ks + j;
        xk[m][i] = j < s ? xv[at + (long long)k * s] : T(0);
        xm[m][i] = has_e && j < s ? xv[at + (long long)(k - 1) * s] : T(0);
        tc[m][i] = T(0);
      }
    }
    auto load = [&](T (&d)[kMvG][CPL], T (&e)[kMvG][CPL], int r0) {
#pragma unroll
      for (int g = 0; g < kMvG; ++g)
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const int r = r0 + g, j = c0 + tid + m * nthr;
          const bool in = r < rows && j < s;
          d[g][m] = in && (!lower || j <= i0 + r) ? __ldcs(Dk + (long long)r * s + j) : T(0);
          e[g][m] = in && has_e ? __ldcs(Em + (long long)r * s + j) : T(0);
        }
    };
    auto use = [&](const T (&d)[kMvG][CPL], const T (&e)[kMvG][CPL], int r0) {
      T sum[kMvG];
#pragma unroll
      for (int g = 0; g < kMvG; ++g) {
        T acc[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          T a = T(0);
#pragma unroll
          for (int m = 0; m < CPL; ++m) {
            a += d[g][m] * xk[m][i];
            a += e[g][m] * xm[m][i];
          }
          acc[i] = a;
        }
        if constexpr (UPPER) {
          T xrv[NV];
          load_vec<T, NV>(xr + (r0 + g) * NV, xrv);
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int m = 0; m < CPL; ++m) tc[m][v] += e[g][m] * xrv[v];
        }
        sum[g] = warp_sums<T, NV>(acc);
      }
      if (lane < NV)  // the group's row sums after its reductions, which thus overlap
#pragma unroll
        for (int g = 0; g < kMvG; ++g)
          if (r0 + g < rows) rs[(warp * R + r0 + g) * NV + myv] += sum[g];
    };
    T d0[kMvG][CPL], e0[kMvG][CPL], d1[kMvG][CPL], e1[kMvG][CPL];
    if (rows > 0) load(d0, e0, 0);
    for (int r0 = 0; r0 < rows; r0 += 2 * kMvG) {  // two stages: the next rows' loads go out before this use
      if (r0 + kMvG < rows) load(d1, e1, r0 + kMvG);
      use(d0, e0, r0);
      if (r0 + kMvG < rows) {
        if (r0 + 2 * kMvG < rows) load(d0, e0, r0 + 2 * kMvG);
        use(d1, e1, r0 + kMvG);
      }
    }
    if constexpr (UPPER) {
      if (has_e) {  // the cluster adds its units' column sums into partial blockIdx.x / cs of y_{k-1}
#pragma unroll
        for (int m = 0; m < CPL; ++m)
#pragma unroll
          for (int v = 0; v < NV; ++v) ts[v * W + tid + m * nthr] = tc[m][v];
        namespace cg = cooperative_groups;
        cg::cluster_group cl = cg::this_cluster();
        cl.sync();
        const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
        const int share = (W + cs - 1) / cs, span = min(W, s - c0);
        for (int e = tid; e < NV * share; e += nthr) {
          const int v = e / share, jj = rank * share + e % share;
          if (jj >= span) continue;
          T sum = T(0);
          for (int q = 0; q < cs; ++q) sum += cl.map_shared_rank(ts, q)[v * W + jj];
          part[(((cb * NV + v) * (K - 1) + k - 1) * P + blockIdx.x / cs) * s + c0 + jj] = sum;
        }
        cl.sync();
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < NV * rows; e += nthr) {
    const int v = e / rows, r = e % rows;
    T sum = T(0);
    for (int w = 0; w < warps; ++w) sum += rs[(w * R + r) * NV + v];
    yb[(cb * NV + v) * Ks + (long long)k * s + i0 + r] = sum;
  }
}

// Launch the units in clusters of cs with nthr threads each; the card's
// cluster occupancy is asked once per kernel and cluster size (a product
// is short, and the query costs host time on every call).
template <typename T, int NV, int CPL, bool UPPER>
int launch_matvec_units(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k,
                        long long sub_b, int K, int s, int lower, int chunks, int P, const T* xp, T* yb, T* part,
                        dim3 grid, int cs, int nthr, cudaStream_t st) {
  static int fits[9][kMvMaxThr / 32 + 1];  // per cluster size and warps: 0 unknown, 1 fits, -1 refused
  auto kernel = bt_matvec_kernel<T, NV, CPL, UPPER>;
  if (cs < 1 || cs > 8 || nthr < 32 || nthr > kMvMaxThr || nthr % 32) return (int)cudaErrorInvalidValue;
  const int warps = nthr / 32;
  const size_t smem = sizeof(T) * ((size_t)NV * kMvR * (1 + warps) + (UPPER ? (size_t)NV * nthr * CPL : 0));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nthr);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int& fit = fits[cs][warps];
  if (fit == 0) {
    int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)(sizeof(T) * ((size_t)NV * kMvR * (1 + kMvMaxThr / 32) +
                                                          (UPPER ? (size_t)NV * kMvMaxThr * CPL : 0))));
    int count = 0;
    if (!rc) rc = (int)cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (rc) return rc;
    fit = count > 0 ? 1 : -1;
  }
  if (fit < 0) return (int)cudaErrorInvalidConfiguration;
  const int rc = (int)cudaLaunchKernelEx(&cfg, kernel, diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P,
                                         xp, yb, part);
  return rc ? rc : (int)cudaGetLastError();
}

template <typename T, int NV>
int launch_matvec_nv(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k, long long sub_b,
                     int K, int s, int lower, int chunks, int P, const T* xp, T* yb, T* part, dim3 grid, int cs,
                     int cpl, int nthr, int upper, cudaStream_t st) {
  if constexpr (sizeof(T) == 4) {
    if (cpl == 2)
      return upper ? launch_matvec_units<T, NV, 2, true>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks,
                                                         P, xp, yb, part, grid, cs, nthr, st)
                   : launch_matvec_units<T, NV, 2, false>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower,
                                                          chunks, P, xp, yb, part, grid, cs, nthr, st);
  }
  if (cpl != 1) return (int)cudaErrorInvalidValue;
  return upper ? launch_matvec_units<T, NV, 1, true>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P,
                                                     xp, yb, part, grid, cs, nthr, st)
               : launch_matvec_units<T, NV, 1, false>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P,
                                                      xp, yb, part, grid, cs, nthr, st);
}

// K13 and bt_sqrt: y (B kk, n) rows = the product with the block-tridiagonal
// matrix of chain b (diag block k at diag + b diag_b + k diag_k; sub-diagonal
// block k, rows of block row k + 1, at sub + b sub_b + k sub_k) of the rows x
// (B kk, n), chain-major, in the original numbering. Three launches:
// rows_in gathers x through perm into xp (B kp, K s), kp = chunks NV; the
// units (bt_matvec_kernel) on a grid of (strips, K, B chunks) in clusters of
// cs; rows_out adds the P column partials per block row (upper) and
// scatters through perm. work: xp, yb (B kp K s each), part (B kp (K-1) P s).
template <typename T>
int launch_matvec(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k, long long sub_b,
                  int K, int s, int n, const int* perm, const T* x, T* y, int kk, int B, int nv, int chunks,
                  int strips, int cs, int P, int cpl, int nthr, int lower, int upper, T* work, void* stream) {
  if (B == 0 || kk == 0 || n == 0) return 0;
  if ((upper && (lower || K < 2 || P * cs != strips)) || (!upper && cs != 1) || strips * kMvR < s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int kp = chunks * nv;
  const long long Ks = (long long)K * s;
  T* xp = work;
  T* yb = xp + (long long)B * kp * Ks;
  T* part = yb + (long long)B * kp * Ks;
  int rc = rows_in<T>(x, perm, n, kk, kp, B, Ks, xp, kp * Ks, Ks, 1, st);
  if (rc) return rc;
  const dim3 grid(strips, K, B * chunks);
  switch (nv) {
    case 1: rc = launch_matvec_nv<T, 1>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P, xp, yb, part,
                                        grid, cs, cpl, nthr, upper, st); break;
    case 4: rc = launch_matvec_nv<T, 4>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P, xp, yb, part,
                                        grid, cs, cpl, nthr, upper, st); break;
    case 8: rc = launch_matvec_nv<T, 8>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, lower, chunks, P, xp, yb, part,
                                        grid, cs, cpl, nthr, upper, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return rows_out<T>(yb, kp * Ks, Ks, 1, perm, n, kk, kp, B, y, upper ? part : nullptr, P, K, s, st);
}


// K22: a cluster walks chain blockIdx.x / cluster size's K blocks. dP holds the blocks' Q' (lower triangle of
// each diagonal block, then the block below) and is overwritten with L'_k, M'_k; A_k = L_k^-T L_k^-1 (lower) in
// rows 0..s of pre's panels.
template <typename T>
__global__ void __launch_bounds__(tgt::kThreads)
    bt_factor_tangent_kernel(const T* __restrict__ P, const T* __restrict__ pre, T* dP, long long ps, int K, int s,
                             double* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const tgt::Team t = tgt::cluster_team();
  const int b = blockIdx.x / t.size, ss = s * s;
  const long panel = 2L * ss;
  tgt::Slots sl(work + b * tgt::tangent_slice(s, s), s, s);
  double *Ld = sl.w[0], *A = sl.w[1], *dD = sl.w[2], *dL = sl.w[6], *Mk = sl.m[0], *dE = sl.m[1], *dM = sl.m[2];
  double* dU = sl.q[0];  // U'_{k-1}, then U'_k
  const T* Pb = P + b * K * panel;
  const T* prb = pre + b * ps;
  T* db = dP + b * ps;
  for (int k = 0; k < K; ++k) {
    const long o = k * panel;
    const bool below = k < K - 1;
    for (int e = tgt::first(t); e < ss; e += tgt::stride(t)) {
      const int i = e / s, j = e % s;
      Ld[e] = double(Pb[o + e]);
      A[e] = i >= j ? double(prb[o + e]) : 0.0;
      dD[e] = i >= j ? double(db[o + e]) - (k > 0 ? tgt::ld(dU + e) : 0.0) : 0.0;
      Mk[e] = double(Pb[o + ss + e]);
      dE[e] = double(db[o + ss + e]);
    }
    tgt::team_sync();
    tgt::symmetrize(t, A, s);
    tgt::symmetrize(t, dD, s);  // U'_{k-1} is symmetric: its lower triangle, taken off, leaves Q'_kk - U'_{k-1}
    tgt::panel_tangent(t, s, below ? s : 0, Ld, Mk, A, dD, dE, sl.w[3], sl.w[4], sl.w[5], dL, dM, dU, true, smem);
    for (int e = tgt::first(t); e < ss; e += tgt::stride(t)) {
      db[o + e] = T(e / s >= e % s ? tgt::ld(dL + e) : 0.0);
      db[o + ss + e] = T(below ? tgt::ld(dM + e) : 0.0);
    }
    tgt::team_sync();
  }
}

template <typename T>
int launch_factor_tangent(const T* P, const T* pre, T* dP, long long ps, int K, int s, double* work, int B, int cs,
                          void* stream) {
  if (B == 0 || K == 0) return 0;
  if (cs < 1 || cs > tgt::kTeamMax) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(bt_factor_tangent_kernel<T>, dim3(B * cs), cs, tgt::kSmemBytes, (cudaStream_t)stream,
                                P, pre, dP, ps, K, s, work);
}

// How many clusters of cs blocks of K22 the card holds at once.
template <typename T>
int factor_tangent_fit(int cs, int* count) {
  return tgtile::cluster_fit(bt_factor_tangent_kernel<T>, cs, tgt::kSmemBytes, count);
}

// K24: a cluster walks chain blockIdx.x / cluster size's K blocks backwards. G holds the cotangent of the factor
// (L'_k's lower triangle in rows 0..s of panel k, M'_k in rows s..2s) and is overwritten with that of Q's blocks
// (A'_k's lower entries, E'_k); A_k = L_k^-T L_k^-1 (lower) in rows 0..s of pre's panels. Block k reads A'_{k+1},
// written by the cluster in the step before.
template <typename T>
__global__ void __launch_bounds__(tgt::kThreads)
    bt_factor_adjoint_kernel(const T* __restrict__ P, const T* __restrict__ pre, T* G, long long ps, int K, int s,
                             double* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const tgt::Team t = tgt::cluster_team();
  const int b = blockIdx.x / t.size, ss = s * s;
  const long panel = 2L * ss;
  tgt::Slots sl(work + b * tgt::tangent_slice(s, s), s, s);
  double *Ld = sl.w[0], *A = sl.w[1], *gLd = sl.w[2], *gAjj = sl.w[6], *Lb = sl.m[0], *gLb = sl.m[1];
  double *gArj = sl.m[2], *Sr = sl.q[0];
  const T* Pb = P + b * K * panel;
  const T* prb = pre + b * ps;
  T* gb = G + b * ps;
  for (int k = K - 1; k >= 0; --k) {
    const long o = k * panel;
    const bool below = k < K - 1;
    for (int e = tgt::first(t); e < ss; e += tgt::stride(t)) {
      const int i = e / s, j = e % s;
      Ld[e] = i >= j ? double(Pb[o + e]) : 0.0;
      A[e] = i >= j ? double(prb[o + e]) : 0.0;
      gLd[e] = i >= j ? double(__ldcg(gb + o + e)) : 0.0;
      Lb[e] = below ? double(Pb[o + ss + e]) : 0.0;
      gLb[e] = below ? double(__ldcg(gb + o + ss + e)) : 0.0;
      Sr[e] = below && i >= j ? double(__ldcg(gb + o + panel + e)) : 0.0;  // A'_{k+1}
    }
    tgt::team_sync();
    tgt::symmetrize(t, A, s);
    tgt::panel_adjoint(t, s, below ? s : 0, Ld, Lb, A, gLd, gLb, Sr, sl.w[3], sl.w[4], sl.w[5], sl.q[1], gAjj, gArj,
                       smem);
    for (int e = tgt::first(t); e < ss; e += tgt::stride(t)) {
      gb[o + e] = T(e / s >= e % s ? tgt::ld(gAjj + e) : 0.0);
      gb[o + ss + e] = T(below ? tgt::ld(gArj + e) : 0.0);
    }
    tgt::team_sync();
  }
}

template <typename T>
int launch_factor_adjoint(const T* P, const T* pre, T* G, long long ps, int K, int s, double* work, int B, int cs,
                          void* stream) {
  if (B == 0 || K == 0) return 0;
  if (cs < 1 || cs > tgt::kTeamMax) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(bt_factor_adjoint_kernel<T>, dim3(B * cs), cs, tgt::kSmemBytes, (cudaStream_t)stream,
                                P, pre, G, ps, K, s, work);
}

// How many clusters of cs blocks of K24 the card holds at once.
template <typename T>
int factor_adjoint_fit(int cs, int* count) {
  return tgtile::cluster_fit(bt_factor_adjoint_kernel<T>, cs, tgt::kSmemBytes, count);
}

// ---- K13's second entry, transpose mode ----------------------------------------
//
// y_k = L_k^T z_k + M_k^T z_{k+1} = [L_k; M_k]^T w_k with w_k(r) = zp(k s + r), r < 2s: panel k of a chain, its
// 2s rows row-major (L_k's s rows, then M_k's), meets the permuted, padded z at k s + r, one window per block.
// A unit is (slab, column tile, chain and block): rows r0 .. r0 + R of panel k (s rows only in the last panel,
// whose M is zero) against columns j0 .. j0 + 128. The cs = ceil(2s / R) <= 4 slabs of a tile (column tile,
// chain, block) are the ranks of a thread-block cluster (small clusters: the card holds few of 8 or 16). A
// unit reads its rows from j0 on (above, L_k's rows hold nothing for the tile's columns); a slab wholly above
// reads nothing and only takes its share of the cluster's sum.
//
// A unit streams its rows through a ring of 4 stages of 16 KB (32 rows of float32, 16 of float64, by 128
// columns) in shared memory, filled by cp.async (16 bytes a copy where the rows allow, else a value a copy;
// columns past s zero-filled): 3 stages' copies are in flight while one is used. It takes its rows in windows of
// WS stages (the whole slab at every phase's s): a window's w is gathered through perm by cp.async with its
// first stage (each unit of a tile's 128 columns gathers them, so a chain's z is read s / 128 times per block,
// from L2), its stages streamed, and the ring drained before the next window's w; so shared memory does not
// grow with R, and no s is too large. Thread (CPT columns, VPT right-hand sides, row group) sums its rows in
// order, in T (float32 sums in float32), masking only the rows that meet L_k's diagonal; the row groups'
// partials are added in order in shared memory (over the ring, once it is spent); the cluster then adds its
// slabs' partials in rank order through distributed shared memory, each block a share of the tile's outputs,
// written straight through perm into y (no row permutation of its own, no workspace). All k <= 16 right-hand
// sides of a chain share each pass, so P is read once; for k > 16 the passes of 16 stream the slab again (a
// slab kept resident for them held one block an SM and was slower at k = 40 in float32). Nothing is atomic: a
// product is the same bit for bit from run to run.

constexpr int kSqtCols = 128;          // columns of a unit
constexpr int kSqtStageBytes = 16384;  // bytes of a ring stage: 32 rows of float32, 16 of float64
constexpr int kSqtRing = 4;            // stages of the ring
constexpr int kSqtMaxCluster = 4;      // slabs of a cluster, at most

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// Thread t of a unit: column group t % CG (CPT columns, one 16-byte load), right-hand sides VPT (t / CG % VG) ..,
// row group t / (CG VG).
template <typename T, int NV>
struct SqtShape {
  static constexpr int ROWS = kSqtStageBytes / (kSqtCols * (int)sizeof(T));  // rows of a ring stage
  static constexpr int CPT = 16 / (int)sizeof(T);                            // columns a thread
  static constexpr int CG = kSqtCols / CPT;                                  // groups of them
  static constexpr int VPT = NV < 8 ? NV : 8;                                // right-hand sides a thread
  static constexpr int VG = NV / VPT;                                        // groups of them
  static constexpr int RG = tgtile::kThr / (CG * VG);                        // row groups
};

// Dynamic shared memory of a unit taking windows of WS stages: the ring, a window's w (WS ROWS x NV), and the
// row groups' partials (RG NV 128), which take the ring's place once it is spent.
template <typename T, int NV>
__host__ __device__ constexpr size_t sqrt_t_smem(int WS) {
  using Sh = SqtShape<T, NV>;
  const size_t ring = (size_t)kSqtRing * kSqtStageBytes, red = sizeof(T) * Sh::RG * NV * kSqtCols;
  return (ring > red ? ring : red) + sizeof(T) * (size_t)WS * Sh::ROWS * NV;
}

// The rows of panel k that slab q of R rows streams for the column tile at j0: lo .. hi (none: lo >= hi). Its
// rows end at min(r0 + R, rmax); every L_k row r < j0 is above the diagonal for the tile's columns.
__device__ __forceinline__ int2 slab_rows(int q, int R, int rmax, int j0) {
  const int r0 = q * R;
  return make_int2(max(r0, j0), min(r0 + R, rmax));
}

template <typename T, int NV>
__global__ void __launch_bounds__(tgtile::kThr, 2)
    bt_sqrt_t_kernel(const T* __restrict__ P, int K, int s, int n, int R, int WS, const int* __restrict__ perm,
                     const T* __restrict__ z, T* __restrict__ y, int kk, int vec) {
  using Sh = SqtShape<T, NV>;
  constexpr int ROWS = Sh::ROWS, CPT = Sh::CPT, CG = Sh::CG, VPT = Sh::VPT, VG = Sh::VG, RG = Sh::RG;
  constexpr int kThr = tgtile::kThr, S = kSqtRing;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [S][ROWS][128]
  const size_t ring_vals = (size_t)S * ROWS * kSqtCols, red_vals = (size_t)RG * NV * kSqtCols;
  T* const red = ring;  // [RG][NV][128]; slot 0 then the unit's partial
  T* const w = ring + (ring_vals > red_vals ? ring_vals : red_vals);  // [WS ROWS][NV]
  const int tid = threadIdx.x, cgi = tid % CG, vg = (tid / CG) % VG, rg = tid / (CG * VG);
  const int j0 = blockIdx.y * kSqtCols, cols = min(kSqtCols, s - j0);
  const long long bk = blockIdx.z, b = bk / K;
  const int k = (int)(bk % K), rmax = k < K - 1 ? 2 * s : s;
  const int2 span = slab_rows(rank, R, rmax, j0);
  const int lo = span.x, rows = span.y - span.x;  // rows <= 0: nothing to read
  const int stages = rows > 0 ? (rows + ROWS - 1) / ROWS : 0;
  const T* src = P + (bk * 2 * s + lo) * (long long)s + j0;
  // rows lo + ROWS st .. of the slab into ring slot st % S (none at or past `end`), then a commit
  auto copy_stage = [&](int st, int end) {
    if (st < end) {
      T* dst = ring + (size_t)(st % S) * ROWS * kSqtCols;
      const int rn = min(ROWS, rows - st * ROWS);
      const T* from = src + (long long)st * ROWS * s;
      if (vec) {  // 16-byte copies: s and the columns' start are multiples of 16 bytes
        constexpr int per = 16 / sizeof(T), chunks = kSqtCols / per;
        for (int e = tid; e < rn * chunks; e += kThr) {
          const int r = e / chunks, c = (e % chunks) * per;
          const bool ok = c < cols;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst + r * kSqtCols + c)),
                       "l"(from + (long long)r * s + (ok ? c : 0)), "r"(ok ? 16 : 0)
                       : "memory");
        }
      } else {
        for (int e = tid; e < rn * kSqtCols; e += kThr) {
          const int r = e / kSqtCols, c = e % kSqtCols;
          const bool ok = c < cols;
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst + r * kSqtCols + c)),
                       "l"(from + (long long)r * s + (ok ? c : 0)), "n"(sizeof(T)), "r"(ok ? (int)sizeof(T) : 0)
                       : "memory");
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int c0 = 0; c0 < kk; c0 += NV) {
    if (rows > 0) {
      T acc[CPT][VPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e)
#pragma unroll
        for (int v = 0; v < VPT; ++v) acc[e][v] = T(0);
      const int j = j0 + CPT * cgi;  // the thread's first column; L_k's row gr meets column c where gr >= c
      for (int w0 = 0; w0 < stages; w0 += WS) {  // a window of stages w0 .. wend
        const int wend = min(stages, w0 + WS), wrows = min(rows, wend * ROWS) - w0 * ROWS;
        // w(r, v) = zp(k s + lo + w0 ROWS + r) of right-hand side c0 + v: z's value at perm, zero past n and kk;
        // by cp.async in the first stage's group
        const long long pos0 = (long long)k * s + lo + w0 * ROWS;
        for (int e = tid; e < wrows * NV; e += kThr) {
          const long long pos = pos0 + e / NV;
          const bool ok = pos < n && c0 + e % NV < kk;
          asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(w + e)),
                       "l"(ok ? z + (b * kk + c0 + e % NV) * (long long)n + perm[pos] : z), "n"(sizeof(T)),
                       "r"(ok ? (int)sizeof(T) : 0)
                       : "memory");
        }
        for (int st = w0; st < w0 + S; ++st) copy_stage(st, wend);  // S groups in flight (the first with w)
        for (int st = w0; st < wend; ++st) {
          asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1) : "memory");  // stage st has arrived
          __syncthreads();
          const T* stg = ring + (size_t)(st % S) * ROWS * kSqtCols;
          const int rn = min(ROWS, rows - st * ROWS);
          for (int r = rg; r < rn; r += RG) {
            const int gr = lo + st * ROWS + r;
            T p[CPT];
            load_vec<T, CPT>(stg + r * kSqtCols + CPT * cgi, p);
            if (gr < s && gr < j0 + kSqtCols) {  // a row that meets L_k's diagonal: its lower triangle only
#pragma unroll
              for (int e = 0; e < CPT; ++e) p[e] = gr >= j + e ? p[e] : T(0);
            }
            T wv[VPT];
            load_vec<T, VPT>(w + ((st - w0) * ROWS + r) * NV + vg * VPT, wv);
#pragma unroll
            for (int e = 0; e < CPT; ++e)
#pragma unroll
              for (int v = 0; v < VPT; ++v) acc[e][v] += p[e] * wv[v];
          }
          __syncthreads();           // every thread is done with slot st % S
          copy_stage(st + S, wend);  // its next rows (an empty group past the window)
        }
        // nothing may still land in the ring or w: the next window's w, or the partials, take their place
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
      }
#pragma unroll
      for (int v = 0; v < VPT; ++v)
#pragma unroll
        for (int e = 0; e < CPT; ++e)
          red[((size_t)rg * NV + vg * VPT + v) * kSqtCols + CPT * cgi + e] = acc[e][v];
      __syncthreads();
      for (int o = tid; o < NV * kSqtCols; o += kThr) {  // the row groups in order, into slot 0
        T sum = red[o];
        for (int g = 1; g < RG; ++g) sum += red[(size_t)g * NV * kSqtCols + o];
        red[o] = sum;
      }
    }
    cl.sync();
    const int share = (NV * kSqtCols + cs - 1) / cs;
    for (int e = tid; e < share; e += kThr) {  // this block's share of the tile's outputs
      const int o = rank * share + e, v = o / kSqtCols, jj = o % kSqtCols;
      const long long pos = (long long)k * s + j0 + jj;
      if (o >= NV * kSqtCols || jj >= cols || pos >= n || c0 + v >= kk) continue;
      T part[kSqtMaxCluster];
#pragma unroll
      for (int q = 0; q < kSqtMaxCluster; ++q) {  // every slab's partial requested before any is added
        const int2 sq = slab_rows(q, R, rmax, j0);
        part[q] = q < cs && sq.y > sq.x ? cl.map_shared_rank(red, q)[o] : T(0);
      }
      T sum = part[0];
#pragma unroll
      for (int q = 1; q < kSqtMaxCluster; ++q) sum += part[q];  // in rank order (a slab with no rows adds +0)
      y[(b * kk + c0 + v) * (long long)n + perm[pos]] = sum;
    }
    cl.sync();
  }
}

// bt_sqrt's transpose mode: y (B kk, n) rows = L^T z of K11's factor P (B, K, 2s, s) on rows z (B kk, n),
// chain-major, in the original numbering; slabs of R rows taken in windows of WS stages, nv right-hand sides a
// pass (1, 4, 8 or 16).
template <typename T, int NV>
int launch_sqrt_t_nv(const T* P, int K, int s, int n, int R, int WS, const int* perm, const T* z, T* y, int kk,
                     int B, cudaStream_t st) {
  const int cs = (2 * s + R - 1) / R;
  const int vec = (s * sizeof(T)) % 16 == 0 && reinterpret_cast<unsigned long long>(P) % 16 == 0;
  return tgtile::launch_cluster(bt_sqrt_t_kernel<T, NV>, dim3(cs, (s + kSqtCols - 1) / kSqtCols, B * K), cs,
                                sqrt_t_smem<T, NV>(WS), st, P, K, s, n, R, WS, perm, z, y, kk, vec);
}

template <typename T>
int launch_sqrt_t(const T* P, int K, int s, int n, int R, int WS, const int* perm, const T* z, T* y, int kk, int B,
                  int nv, void* stream) {
  if (B == 0 || kk == 0 || n == 0) return 0;
  const int rows = kSqtStageBytes / (kSqtCols * (int)sizeof(T));
  if (R < rows || R % rows || (2 * s + R - 1) / R > kSqtMaxCluster || WS < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nv) {
    case 1: return launch_sqrt_t_nv<T, 1>(P, K, s, n, R, WS, perm, z, y, kk, B, st);
    case 4: return launch_sqrt_t_nv<T, 4>(P, K, s, n, R, WS, perm, z, y, kk, B, st);
    case 8: return launch_sqrt_t_nv<T, 8>(P, K, s, n, R, WS, perm, z, y, kk, B, st);
    case 16: return launch_sqrt_t_nv<T, 16>(P, K, s, n, R, WS, perm, z, y, kk, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of cs units (windows of WS stages, nv right-hand sides a pass) the card holds at once.
template <typename T>
int sqrt_t_fit(int cs, int WS, int nv, int* count) {
  switch (nv) {
    case 1: return tgtile::cluster_fit(bt_sqrt_t_kernel<T, 1>, cs, sqrt_t_smem<T, 1>(WS), count);
    case 4: return tgtile::cluster_fit(bt_sqrt_t_kernel<T, 4>, cs, sqrt_t_smem<T, 4>(WS), count);
    case 8: return tgtile::cluster_fit(bt_sqrt_t_kernel<T, 8>, cs, sqrt_t_smem<T, 8>(WS), count);
    case 16: return tgtile::cluster_fit(bt_sqrt_t_kernel<T, 16>, cs, sqrt_t_smem<T, 16>(WS), count);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define TG_BT_ENTRY(SUF, T)                                                                                     \
  int tg_bt_factor_##SUF(const T* data, long long ds, const int* src, const int* dst, int ntab,               \
                         const int* tperm, T* P, int K, int s, T* ws, T* dom, int* boost, T* logdet,          \
                         int* flags, int cs, int B, void* stream) {                                           \
    return launch_factor<T>(data, ds, src, dst, ntab, tperm, P, K, s, ws, dom, boost, logdet, flags, cs, B,   \
                            stream);                                                                          \
  }                                                                                                           \
  int tg_bt_factor_fit_##SUF(int cs, int* count) { return chol_fit<T>(cs, count); }                           \
  int tg_bt_trsv_##SUF(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, \
                       int B, T* work, void* stream) {                                                        \
    return launch_trsv<T>(P, K, s, n, perm, b, out, k, mode, B, work, stream);                               \
  }                                                                                                           \
  int tg_bt_factor_blocks_##SUF(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, int cs,    \
                                int B, void* stream) {                                                        \
    return launch_factor_blocks<T>(D, E, P, K, s, logdet, flags, cs, B, stream);                              \
  }                                                                                                           \
  int tg_bt_trsv_blocks_##SUF(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work,           \
                              void* stream) {                                                                 \
    return launch_trsv_blocks<T>(P, K, s, b, out, k, B, work, 2, (cudaStream_t)stream);                       \
  }                                                                                                           \
  int tg_bt_matvec_##SUF(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k,    \
                         long long sub_b, int K, int s, int n, const int* perm, const T* x, T* y, int kk,     \
                         int B, int nv, int chunks, int strips, int cs, int P, int cpl, int nthr, int lower,  \
                         int upper, T* work, void* stream) {                                                  \
    return launch_matvec<T>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm, x, y, kk, B, nv, chunks,  \
                            strips, cs, P, cpl, nthr, lower, upper, work, stream);                            \
  }                                                                                                           \
  int tg_bt_factor_tangent_##SUF(const T* P, const T* pre, T* dP, long long ps, int K, int s, double* work,   \
                                 int B, int cs, void* stream) {                                               \
    return launch_factor_tangent<T>(P, pre, dP, ps, K, s, work, B, cs, stream);                               \
  }                                                                                                           \
  int tg_bt_factor_tangent_fit_##SUF(int cs, int* count) { return factor_tangent_fit<T>(cs, count); }         \
  int tg_bt_factor_adjoint_##SUF(const T* P, const T* pre, T* G, long long ps, int K, int s, double* work,    \
                                 int B, int cs, void* stream) {                                               \
    return launch_factor_adjoint<T>(P, pre, G, ps, K, s, work, B, cs, stream);                                \
  }                                                                                                           \
  int tg_bt_factor_adjoint_fit_##SUF(int cs, int* count) { return factor_adjoint_fit<T>(cs, count); }         \
  int tg_bt_sqrt_t_##SUF(const T* P, int K, int s, int n, int R, int WS, const int* perm, const T* z, T* y,   \
                         int kk, int B, int nv, void* stream) {                                               \
    return launch_sqrt_t<T>(P, K, s, n, R, WS, perm, z, y, kk, B, nv, stream);                                \
  }                                                                                                           \
  int tg_bt_sqrt_t_fit_##SUF(int cs, int WS, int nv, int* count) { return sqrt_t_fit<T>(cs, WS, nv, count); }

TG_BT_ENTRY(f32, float)
TG_BT_ENTRY(f64, double)

#undef TG_BT_ENTRY

}  // extern "C"
