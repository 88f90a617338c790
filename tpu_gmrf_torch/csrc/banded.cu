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
// shuffles, the inverse by blocks of 16) while the other 15 blocks do the
// products, on the f64 tensor cores (float32 on the FMA units; its diagonal
// tiles in float64), two cluster barriers per column tile. The pivot boost
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
// serves both: every L_k is inverted first (invert_blocks: the inverted
// 64 x 64 diagonal tiles of tiles.cuh, then invert_blocks_kernel, a block
// per chain, block and column tile, left-looking over the row tiles; 1/3 s^3
// flops per block, all of them independent), so a block step is two
// products and no substitution: the coupling W = b_k - M_{k-1} y_{k-1} and
// y_k = L_k^-1 W (backward, M_k^T and L_k^-T). A work unit is one chain and
// one column tile of 64 right-hand sides (8 when k <= 8), a cluster of up to
// 8 blocks, each owning row tiles of both products (tiles i and ntiles - 1 -
// i together when a block owns two, which evens the depths of the
// triangular products), f64 on the tensor cores; a cluster barrier follows
// each product. The clusters of one chain walk the blocks in step, so a
// step's L_k^-1 and M_k (3.2 MB at s = 450) are read from L2 by all the
// chain's column tiles. K12 adds its rows' permutation and padding around
// it (rows_in gathers b into the block layout (B, K, s, k), rows_out
// scatters the solution back) and its modes: the forward sweep alone, the
// backward alone, or both. The explicit inverses hold the f64 limit of
// chip_smoke.py's phases 3c and 3f (1e-12 against substitution): the
// diagonal blocks of the SPIKE shapes and of the n = 5741 Laplace posterior
// (condition of L_k about 320) are well conditioned.
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
template <typename T>
struct TileWork {
  using type = T;
};
template <>
struct TileWork<float> {
  using type = double;
};
template <typename T>
__device__ __noinline__ void chol_tile(T* D, long long ld, int t, T* Dinv, int* bad, T* sm, T tiny,
                                       const T* U = nullptr, long long ldu = 0, int du = 0) {
  tgtile::factor_tile(D, ld, t, Dinv, bad, reinterpret_cast<typename TileWork<T>::type*>(sm), tiny, U, ldu, du);
}

// The blocked Cholesky of chain blockIdx.y's block-tridiagonal matrix, held
// in P as its K panels (A_k's lower triangle in rows 0..s of panel k, E_k in
// rows s..2s; zeros above the diagonal), in place: L_k and M_k. Block step k
// walks L_k's column tiles of 64, j = 0 .. nt - 1 (nt = ceil(s / 64)), each
// in two phases:
//   the panel: L_k's row tiles below the diagonal tile j and M_k's row tiles
//     times the inverted diagonal tile (L(a, j) = A(a, j) L_jj^-T), dealt
//     out over the cluster; block 0's first tile is the row tile of the next
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
// Block 0 factors and inverts the diagonal tiles (tiles.cuh factor_tile; a
// float32 tile in float64, so that the inverse that multiplies every panel
// tile carries no float32 bias into the pivots that follow) into the chain's
// two slots of Dinv in turn (the panel reads one while the next is
// written). *bad is set for a pivot that is not finite and above tiny; the
// chain goes on.
template <typename T>
__global__ void __launch_bounds__(tgtile::kThr, 1)
    bt_chol_kernel(T* P, int K, int s, T tiny, T* Dinv, int* bad) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x;  // the grid is (cluster size, B)
  const long long panel = 2LL * s * s, ss = (long long)s * s;
  T* Pb = P + blockIdx.y * panel * K;
  T* Dv = Dinv + blockIdx.y * 2LL * kTT;  // two slots: column tile c's inverted diagonal tile in slot c % 2
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
  if (rank == 0) chol_tile(Pb, s, rows(0), Dv, flag, sm, tiny);
  cluster_barrier();
  for (int k = 0, c = 0; k < K; ++k) {
    T* L = Pb + k * panel;  // L_k, then M_k (E_k until it is solved) s rows below
    T* M = L + ss;
    T* A = L + panel;  // D_{k+1}, then A_{k+1}
    const bool more = k < K - 1;
    for (int j = 0; j < nt; ++j, ++c) {
      const int j0 = j * kT, tj = rows(j), below = nt - 1 - j;
      if (!more && below == 0) break;  // the last column tile of the last block
      const bool last = below == 0;
      const int n1 = j0 + kT, t1 = rows(last ? 0 : j + 1);
      const T* Dj = Dv + (c % 2) * kTT;
      T* Dn = Dv + ((c + 1) % 2) * kTT;
      // the panel; block 0's first row tile is the one the next diagonal tile's update needs
      for (int a = rank; a < below + (more ? nt : 0); a += cs) {
        T* C = a < below ? L + (long long)(j + 1 + a) * kT * s + j0 : M + (long long)(a - below) * kT * s + j0;
        chol_gemm<T>(C, s, C, s, Dj, kT, rows(a < below ? j + 1 + a : a - below), tj, tj, false, sm);
      }
      // the panel barrier, split: block 0 factors the next diagonal tile (L(j + 1, j + 1), or A_{k+1}(0, 0)
      // after the last column tile) between its arrival and its wait, its update by column tile j fused in,
      // while the other blocks go on with the update
      cluster_arrive();
      if (rank == 0) {
        if (last)
          chol_tile(A, s, t1, Dn, flag, sm, tiny, (const T*)M + u_last, s, s - u_last);
        else
          chol_tile(L + (long long)n1 * s + n1, s, t1, Dn, flag, sm, tiny, (const T*)L + (long long)n1 * s + j0, s, tj);
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
  if (tgtile::max_clusters(bt_chol_kernel<T>, dim3(cs), cs, chol_smem<T>(), count)) {
    cudaGetLastError();
    *count = 0;
  }
  return 0;
}

template <typename T>
int launch_chol(T* P, int K, int s, T tiny, T* Dinv, int* bad, int cs, int B, cudaStream_t st) {
  return tgtile::launch_cluster(bt_chol_kernel<T>, dim3(cs, B), cs, chol_smem<T>(), st, P, K, s, tiny, Dinv, bad);
}

// K11: scatter, the cluster factorization of every chain with no boost
// (breakdown at l <= 30 eps), one flag readback; the chains that broke down
// are redone from the scatter on, block by block, each block retried as
// `_chol_boosted` does (the blocked panel Cholesky of dense_blocks.cuh on
// the chains in `redo`). Dinv: B x 2 inverted tiles of 64 x 64 (scratch).
template <typename T>
int launch_factor(const T* data, long long ds, const int* src, const int* dst, int ntab, const int* tperm, T* P,
                  int K, int s, T* ws, T* dom, int* boost, T* logdet, int* flags, T* Dinv, int cs, int B,
                  void* stream) {
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
  if ((rc = launch_chol<T>(P, K, s, tiny, Dinv, fail, cs, B, st))) return rc;
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
int launch_factor_blocks(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, T* Dinv, int cs, int B,
                         void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long pstride = 2LL * s * s * K;
  const long long want = (pstride + kThreads - 1) / kThreads;
  int rc = (int)cudaMemsetAsync(flags, 0, sizeof(int) * B, st);
  if (rc) return rc;
  bt_blocks_load_kernel<T><<<dim3(want < 1024 ? (int)want : 1024, B), kThreads, 0, st>>>(D, E, P, K, s);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = launch_chol<T>(P, K, s, T(0), Dinv, flags, cs, B, st))) return rc;
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

// L_k^-1 of every block of every chain into Linv (B, K, s, s), lower with
// zeros above the diagonal: block (ct, k, b) solves L_k X = I for the
// columns of tile ct, left-looking from row tile ct down, with the inverted
// diagonal tiles Dinv (B, K, ntiles(s), 64, 64).
template <typename T>
__global__ void __launch_bounds__(tgtile::kThr, 2)
    invert_blocks_kernel(const T* P, int K, int s, const T* Dinv, T* Linv) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ct = blockIdx.x, nt = ntiles(s), c0 = ct * kT, q = min(kT, s - c0);
  const long long m = (long long)blockIdx.z * K + blockIdx.y;  // chain b, block k
  const T* L = P + m * 2LL * s * s;
  const T* D = Dinv + m * nt * kTT;
  T* X = Linv + m * s * s + c0;
  for (long long e = threadIdx.x; e < (long long)s * q; e += blockDim.x) {  // the columns of I
    const int r = (int)(e / q), c = (int)(e % q);
    X[(long long)r * s + c] = r == c0 + c ? T(1) : T(0);
  }
  __syncthreads();
  for (int j = ct; j < nt; ++j) {
    const int j0 = j * kT, tj = min(kT, s - j0);
    T* Xj = X + (long long)j0 * s;
    if (j > ct)
      gemm_rows<T, 64>(Xj, s, L + (long long)j0 * s + c0, s, 1, X + (long long)c0 * s, s, 1, tj, q, j0 - c0, true,
                       sm);
    gemm_rows<T, 64>(Xj, s, D + (long long)j * kTT, kT, 1, Xj, s, 1, tj, q, tj, false, sm);
  }
}

// Whether block `rank` of a cluster of cs owns row tile i of nt: i % cs, or,
// with at least two tiles per block, i and nt - 1 - i together (the forward
// and backward products of tile i are i + 1 and nt - i tiles deep).
__device__ __forceinline__ bool owns(int i, int nt, int rank, int cs) {
  return (2 * cs <= nt ? (i < nt - 1 - i ? i : nt - 1 - i) : i) % cs == rank;
}

// K12 and its block entry: cluster (col, chain) solves columns NT col .. NT
// col + q of its chain's right-hand sides Bin (B, K, s, k) into X (Bin may
// be X), forward (mode 0), backward (mode 1) or both (mode 2), with the
// inverses Linv of the diagonal blocks. Block `rank` of the cluster owns
// the row tiles of `owns`. A block step is two products with a cluster
// barrier after each: the coupling, W_i = X_i - M_{k-1}[i, :] y_{k-1} (or
// X_i - M_k[:, i]^T x_{k+1}; Bin_i in place of X_i going forward) into the
// scratch W (B, s, k), then X_i = Linv_k[i, :] W (or Linv_k[:, i]^T W).
// The backward sweep alone starts from Bin.
template <typename T, int NT>
__global__ void __launch_bounds__(tgtile::kThr, 2)
    bt_trsv_blocks_kernel(const T* P, int K, int s, const T* Linv, const T* Bin, T* X, T* W, int k, int mode) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, nt = ntiles(s);
  const int c0 = blockIdx.y * NT, q = min(NT, k - c0);
  const long long panel = 2LL * s * s, ss = (long long)s * s, rows = (long long)s * k;  // rows: one block row of X
  const T* Pb = P + blockIdx.z * panel * K;
  const T* Gb = Linv + blockIdx.z * ss * K;
  const T* Bb = Bin + blockIdx.z * rows * K + c0;
  T* Xb = X + blockIdx.z * rows * K + c0;
  T* Wb = W + blockIdx.z * rows + c0;
  for (int blk = 0; mode != 1 && blk < K; ++blk) {
    T* V = Xb + blk * rows;
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const T* Mi = blk ? Pb + (blk - 1) * panel + ss + i0 * s : Pb;  // no coupling into block 0
      gemm_rows<T, NT>(Wb + i0 * k, k, Mi, s, 1, blk ? V - rows : V, k, 1, min(kT, s - i * kT), q, blk ? s : 0, true,
                       sm, Bb + blk * rows + i0 * k);
    }
    csync();
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const int ti = min(kT, s - i * kT);
      gemm_rows<T, NT>(V + i0 * k, k, Gb + blk * ss + i0 * s, s, 1, Wb, k, 1, ti, q, (int)i0 + ti, false, sm);
    }
    csync();
  }
  for (int blk = K - 1; mode != 0 && blk >= 0; --blk) {
    T* V = Xb + blk * rows;
    const T* U = mode == 1 ? Bb + blk * rows : V;  // the right-hand side of this block step
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const bool last = blk == K - 1;  // no coupling out of the last block
      gemm_rows<T, NT>(Wb + i0 * k, k, Pb + blk * panel + ss + i0, 1, s, last ? V : V + rows, k, 1,
                       min(kT, s - i * kT), q, last ? 0 : s, true, sm, U + i0 * k);
    }
    csync();
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      gemm_rows<T, NT>(V + i0 * k, k, Gb + blk * ss + i0 * s + i0, 1, s, Wb + i0 * k, k, 1, min(kT, s - i * kT), q,
                       s - (int)i0, false, sm);
    }
    csync();
  }
}

// The inverted diagonal tiles of every L_k into Dinv (B K ntiles(s) 64 64),
// then every L_k^-1 into Linv (B K s s).
template <typename T>
int invert_blocks(const T* P, int K, int s, int B, T* Dinv, T* Linv, cudaStream_t st) {
  using namespace tgtile;
  const int nt = ntiles(s);
  int rc = invert_diag<T>(P, 2LL * s * s, s, s, B * K, Dinv, st);
  const size_t smem64 = sizeof(T) * 2 * kKS * (Cfg<64>::LDA + Cfg<64>::LDB);
  if (!rc) rc = set_smem(invert_blocks_kernel<T>, smem64);
  if (rc) return rc;
  invert_blocks_kernel<T><<<dim3(nt, K, B), kThr, smem64, st>>>(P, K, s, Dinv, Linv);
  return (int)cudaGetLastError();
}

// K12's solve on blocks (both entries): every L_k inverted (invert_blocks),
// then one cluster of up to 8 blocks (one per row tile) per chain and column
// tile of 64 right-hand sides (8 when k <= 8). b and out may be one array.
// work: Dinv (B K ntiles(s) 64 64), Linv (B K s s), W (B s k).
template <typename T>
int launch_trsv_blocks(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work, int mode,
                       cudaStream_t st) {
  using namespace tgtile;
  if (B == 0 || k == 0 || K == 0) return 0;
  const int nt = ntiles(s);
  T* Dinv = work;
  T* Linv = Dinv + (long long)B * K * nt * kTT;
  T* W = Linv + (long long)B * K * s * s;
  int rc = invert_blocks<T>(P, K, s, B, Dinv, Linv, st);
  if (rc) return rc;
  const size_t smem64 = sizeof(T) * 2 * kKS * (Cfg<64>::LDA + Cfg<64>::LDB);
  // a block per row tile (up to 8), or a block per two when that fits all the clusters on the card at once
  const int nt2 = cdiv(nt, 2);
  int cs = nt < 8 ? nt : 8, fit = 0;
  if (k <= 8)
    return launch_cluster(bt_trsv_blocks_kernel<T, 8>, dim3(cs, cdiv(k, 8), B), cs,
                          sizeof(T) * 2 * kKS * (Cfg<8>::LDA + Cfg<8>::LDB), st, P, K, s, (const T*)Linv, b, out, W,
                          k, mode);
  const int clusters = cdiv(k, 64) * B;
  if (nt2 > 1 && nt2 < cs && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(nt2, cdiv(k, 64), B), nt2, smem64, &fit) &&
      fit >= clusters && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, &fit) &&
      fit < clusters)
    cs = nt2;
  cudaGetLastError();
  return launch_cluster(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, st, P, K, s,
                        (const T*)Linv, b, out, W, k, mode);
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

}  // namespace

extern "C" {

#define TG_BT_ENTRY(SUF, T)                                                                                     \
  int tg_bt_factor_##SUF(const T* data, long long ds, const int* src, const int* dst, int ntab,               \
                         const int* tperm, T* P, int K, int s, T* ws, T* dom, int* boost, T* logdet,          \
                         int* flags, T* work, int cs, int B, void* stream) {                                  \
    return launch_factor<T>(data, ds, src, dst, ntab, tperm, P, K, s, ws, dom, boost, logdet, flags, work, cs, \
                            B, stream);                                                                       \
  }                                                                                                           \
  int tg_bt_factor_fit_##SUF(int cs, int* count) { return chol_fit<T>(cs, count); }                           \
  int tg_bt_trsv_##SUF(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, \
                       int B, T* work, void* stream) {                                                        \
    return launch_trsv<T>(P, K, s, n, perm, b, out, k, mode, B, work, stream);                               \
  }                                                                                                           \
  int tg_bt_invert_##SUF(const T* P, int K, int s, int B, T* Dinv, T* Linv, void* stream) {                   \
    return B == 0 ? 0 : invert_blocks<T>(P, K, s, B, Dinv, Linv, (cudaStream_t)stream);                       \
  }                                                                                                           \
  int tg_bt_factor_blocks_##SUF(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, T* work,    \
                                int cs, int B, void* stream) {                                                \
    return launch_factor_blocks<T>(D, E, P, K, s, logdet, flags, work, cs, B, stream);                        \
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
  }

TG_BT_ENTRY(f32, float)
TG_BT_ENTRY(f64, double)

#undef TG_BT_ENTRY

}  // extern "C"
