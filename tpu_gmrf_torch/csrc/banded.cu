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
// K12 reads L and M once per direction: bound by that read from one block
// per right-hand side. It runs one block per (chain, right-hand side) with
// the whole permuted vector in shared memory, or, when it does not fit
// (npad above ~25k in float64), in a global workspace row. Its block entry
// does 2 s^2 k flops per block step and direction for each of B chains
// (f64, B = 4, K = 31, s = 450, k = 901: 1.3e11 flops, bound 2 ms at the f64
// tensor-core rate), in a chain of 2 K dependent block steps: bound by the
// latency of that chain where k is small, by the products where it is
// large. Its design: every L_k is inverted first (invert_blocks_kernel: a
// block per chain, block and column tile, left-looking over the row tiles
// with the inverted diagonal tiles of tiles.cuh; 1/3 s^3 flops per block,
// all of them independent), so a block step is two products and no
// substitution: the coupling W = b_k - M_{k-1} y_{k-1} and y_k = L_k^-1 W
// (backward, M_k^T and L_k^-T). A work unit is one chain and one column tile
// of 64 right-hand sides (8 when k <= 8), a cluster of up to 8 blocks, each
// owning row tiles of both products (tiles i and ntiles - 1 - i together
// when a block owns two, which evens the depths of the triangular
// products), f64 on the tensor cores; a cluster barrier follows each
// product. The clusters of one chain walk the blocks in step, so a step's
// L_k^-1 and M_k (3.2 MB at s = 450) are read from L2 by all the chain's
// column tiles. The explicit inverses hold the f64 limit of chip_smoke.py's
// phase 3f at the SPIKE shapes, whose diagonal blocks are well conditioned.
// K13 streams (2K-1) s^2 values against 2 (3K-2) s^2 flops per vector: with
// a handful of vectors it is bound by that stream (the blocks are 30-100x
// the sparse values, most of them zeros). One block of threads owns 64 rows
// of one block row and up to 8 vectors, so a row of y has one owner and
// nothing is atomic. It gathers the three x blocks it needs through the
// permutation into shared memory; the terms that read rows of a matrix
// block (D_k, E_{k-1}; L_k, M_{k-1}) run one warp per row, lanes along the
// row (coalesced), with a shuffle reduction; the E_k^T term reads E_k by
// columns: there the lanes run along the 64 output rows, so a warp reads 32
// neighbouring values of one row of E_k (coalesced too), and the 8 warps
// split the rows of E_k and add up through shared memory in a fixed order.
// E is thus read twice per product (once as E_{k-1}, once as E_k^T); the
// bound counts it once. The result is scattered through the permutation.

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

// One block per (chain, right-hand side) row of b / out (R, n), chain-major:
// v = b permuted and padded (in shared memory, or in row `row` of the
// (R, K s) workspace when one is given), forward (mode 0), backward (mode 1)
// or both (mode 2) block substitution, out = v unpermuted.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
    bt_trsv_kernel(const T* P, long long pstride, int K, int s, int n, const int* perm, const T* b, T* out, int k,
                   int mode, T* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = work ? work + (long long)blockIdx.x * K * s : reinterpret_cast<T*>(smem_raw);  // K s
  __shared__ T red[kVecThreads];
  const long long row = blockIdx.x;
  const T* Pb = P + (row / k) * pstride;
  const long long panel = 2LL * s * s;
  for (int j = threadIdx.x; j < K * s; j += blockDim.x) v[j] = j < n ? b[row * n + perm[j]] : T(0);
  __syncthreads();
  if (mode != 1) {
    for (int blk = 0; blk < K; ++blk) {
      T* vb = v + (long long)blk * s;
      if (blk) sub_matvec(vb, Pb + (blk - 1) * panel + (long long)s * s, s, vb - s, s, s);
      __syncthreads();
      tri_lower_solve(Pb + blk * panel, s, vb, s);
    }
  }
  if (mode != 0) {
    for (int blk = K - 1; blk >= 0; --blk) {
      T* vb = v + (long long)blk * s;
      if (blk < K - 1) sub_matvec_t(vb, Pb + blk * panel + (long long)s * s, s, vb + s, s, s, red);
      __syncthreads();
      tri_lower_t_solve(Pb + blk * panel, s, vb, s, red);
    }
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[row * n + perm[j]] = v[j];
}

template <typename T>
int launch_trsv(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, int R,
                T* work, void* stream) {
  if (R == 0) return 0;
  const size_t smem = work ? 0 : sizeof(T) * (size_t)K * s;
  int rc = set_smem(bt_trsv_kernel<T>, smem);
  if (rc) return rc;
  bt_trsv_kernel<T><<<R, kVecThreads, smem, (cudaStream_t)stream>>>(P, 2LL * s * s * K, K, s, n, perm, b, out, k,
                                                                   mode, work);
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

// The block entry of K12: cluster (col, chain) solves columns NT col .. NT
// col + q of its chain's right-hand sides Bin (B, K, s, k) into X, forward
// then backward, with the inverses Linv of the diagonal blocks. Block `rank`
// of the cluster owns the row tiles of `owns`. A block step is
// two products with a cluster barrier after each: the coupling, W_i = X_i -
// M_{k-1}[i, :] y_{k-1} (or X_i - M_k[:, i]^T x_{k+1}; Bin_i in place of X_i
// going forward) into the scratch W (B,
// s, k), then X_i = Linv_k[i, :] W (or Linv_k[:, i]^T W).
template <typename T, int NT>
__global__ void __launch_bounds__(tgtile::kThr, 2)
    bt_trsv_blocks_kernel(const T* P, int K, int s, const T* Linv, const T* Bin, T* X, T* W, int k) {
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
  for (int blk = 0; blk < K; ++blk) {
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
  for (int blk = K - 1; blk >= 0; --blk) {
    T* V = Xb + blk * rows;
    for (int i = 0; i < nt; ++i) {
      if (!owns(i, nt, rank, cs)) continue;
      const long long i0 = (long long)i * kT;
      const bool last = blk == K - 1;  // no coupling out of the last block
      gemm_rows<T, NT>(Wb + i0 * k, k, Pb + blk * panel + ss + i0, 1, s, last ? V : V + rows, k, 1,
                       min(kT, s - i * kT), q, last ? 0 : s, true, sm, V + i0 * k);
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

// The block entry of K12: the inverted diagonal tiles of every L_k into
// Dinv, then every L_k^-1 into Linv; then one cluster of up to 8 blocks (one
// per row tile) per chain and column tile of 64 right-hand sides (8 when
// k <= 8). work: Dinv (B K ntiles(s) 64 64), Linv (B K s s), W (B s k).
template <typename T>
int launch_trsv_blocks(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work, void* stream) {
  using namespace tgtile;
  if (B == 0 || k == 0 || K == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = ntiles(s);
  T* Dinv = work;
  T* Linv = Dinv + (long long)B * K * nt * kTT;
  T* W = Linv + (long long)B * K * s * s;
  int rc = invert_diag<T>(P, 2LL * s * s, s, s, B * K, Dinv, st);
  const size_t smem64 = sizeof(T) * 2 * kKS * (Cfg<64>::LDA + Cfg<64>::LDB);
  if (!rc) rc = set_smem(invert_blocks_kernel<T>, smem64);
  if (rc) return rc;
  invert_blocks_kernel<T><<<dim3(nt, K, B), kThr, smem64, st>>>(P, K, s, Dinv, Linv);
  if ((rc = (int)cudaGetLastError())) return rc;
  // a block per row tile (up to 8), or a block per two when that fits all the clusters on the card at once
  const int nt2 = cdiv(nt, 2);
  int cs = nt < 8 ? nt : 8, fit = 0;
  if (k <= 8)
    return launch_cluster(bt_trsv_blocks_kernel<T, 8>, dim3(cs, cdiv(k, 8), B), cs,
                          sizeof(T) * 2 * kKS * (Cfg<8>::LDA + Cfg<8>::LDB), st, P, K, s, (const T*)Linv, b, out, W,
                          k);
  const int clusters = cdiv(k, 64) * B;
  if (nt2 > 1 && nt2 < cs && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(nt2, cdiv(k, 64), B), nt2, smem64, &fit) &&
      fit >= clusters && !max_clusters(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, &fit) &&
      fit < clusters)
    cs = nt2;
  cudaGetLastError();
  return launch_cluster(bt_trsv_blocks_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, smem64, st, P, K, s,
                        (const T*)Linv, b, out, W, k);
}

// ---- K13 ------------------------------------------------------------------

constexpr int kMvRows = 64;  // rows of y per block
constexpr int kMvVecs = 8;   // vectors per block (accumulators in registers)
constexpr int kMvWarps = kThreads / 32;

// Block (k, tile) x (chain, vector chunk). Matrix block k of chain b is at
// diag + b diag_b + k diag_k (s x s, row-major); sub-diagonal block k (rows of
// block row k+1, columns of block row k) at sub + b sub_b + k sub_k. x and y
// are (B kk, n) rows, chain-major; a chunk is rc <= kMvVecs rows of one chain.
// lower: only j <= i of the diagonal block is read; upper: the sub^T term.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bt_matvec_kernel(const T* __restrict__ diag, long long diag_k, long long diag_b, const T* __restrict__ sub,
                     long long sub_k, long long sub_b, int K, int s, int n, const int* __restrict__ perm,
                     const T* __restrict__ x, T* __restrict__ y, int kk, int rc, int lower, int upper) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);              // [3][rc][s]: x of block rows k-1, k, k+1
  T* red = xs + 3LL * rc * s;                          // [warps][rc][kMvRows]: partial sums of the E_k^T term
  T* yacc = red + (long long)kMvWarps * rc * kMvRows;  // [rc][kMvRows]: the row terms
  const int tiles = cdiv_dev(s, kMvRows);
  const int k = blockIdx.x / tiles, i0 = (blockIdx.x % tiles) * kMvRows;
  const int chunks = cdiv_dev(kk, rc);
  const long long b = blockIdx.y / chunks;
  const int c0 = (blockIdx.y % chunks) * rc;
  const int nc = min(rc, kk - c0);
  const long long row0 = b * kk + c0;
  const int rows = min(kMvRows, s - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (long long e = threadIdx.x; e < 3LL * rc * s; e += blockDim.x) {
    const int which = (int)(e / ((long long)rc * s)), c = (int)((e / s) % rc), j = (int)(e % s);
    const int kb = k - 1 + which;
    const long long g = (long long)kb * s + j;
    T v = T(0);
    if (kb >= 0 && kb < K && c < nc && g < n && (which < 2 || upper)) v = x[(row0 + c) * n + perm[g]];
    xs[e] = v;
  }
  __syncthreads();
  const T* xprev = xs;
  const T* xcur = xs + (long long)rc * s;
  const T* xnext = xs + 2LL * rc * s;

  // the terms that read matrix rows: one warp per row, lanes along the row
  for (int ii = warp; ii < rows; ii += kMvWarps) {
    const int i = i0 + ii;
    T acc[kMvVecs];
#pragma unroll
    for (int c = 0; c < kMvVecs; ++c) acc[c] = T(0);
    const T* drow = diag + b * diag_b + k * diag_k + (long long)i * s;
    const int jend = lower ? i + 1 : s;
    for (int j = lane; j < jend; j += 32) {
      const T v = drow[j];
#pragma unroll
      for (int c = 0; c < kMvVecs; ++c)
        if (c < rc) acc[c] += v * xcur[(long long)c * s + j];
    }
    if (k > 0) {
      const T* srow = sub + b * sub_b + (k - 1) * sub_k + (long long)i * s;
      for (int j = lane; j < s; j += 32) {
        const T v = srow[j];
#pragma unroll
        for (int c = 0; c < kMvVecs; ++c)
          if (c < rc) acc[c] += v * xprev[(long long)c * s + j];
      }
    }
#pragma unroll
    for (int c = 0; c < kMvVecs; ++c) {
      if (c < rc) {
        T a = acc[c];
        for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
        if (lane == 0) yacc[c * kMvRows + ii] = a;
      }
    }
  }

  // the E_k^T term: lanes along the output rows, the warps split E_k's rows
  const bool up = upper && k < K - 1;
  if (up) {
    const T* eblk = sub + b * sub_b + k * sub_k;
    T a0[kMvVecs], a1[kMvVecs];
#pragma unroll
    for (int c = 0; c < kMvVecs; ++c) a0[c] = a1[c] = T(0);
    const bool in0 = lane < rows, in1 = lane + 32 < rows;
    for (int j = warp; j < s; j += kMvWarps) {
      const T* erow = eblk + (long long)j * s + i0;
      const T v0 = in0 ? erow[lane] : T(0);
      const T v1 = in1 ? erow[lane + 32] : T(0);
#pragma unroll
      for (int c = 0; c < kMvVecs; ++c) {
        if (c < rc) {
          const T xv = xnext[(long long)c * s + j];
          a0[c] += v0 * xv;
          a1[c] += v1 * xv;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMvVecs; ++c) {
      if (c < rc) {
        red[((long long)warp * rc + c) * kMvRows + lane] = a0[c];
        red[((long long)warp * rc + c) * kMvRows + lane + 32] = a1[c];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nc * kMvRows; e += blockDim.x) {
    const int c = e / kMvRows, ii = e % kMvRows;
    const long long g = (long long)k * s + i0 + ii;
    if (ii >= rows || g >= n) continue;
    T v = yacc[c * kMvRows + ii];
    if (up)
      for (int w = 0; w < kMvWarps; ++w) v += red[((long long)w * rc + c) * kMvRows + ii];
    y[(row0 + c) * n + perm[g]] = v;
  }
}

template <typename T>
int launch_matvec(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k, long long sub_b,
                  int K, int s, int n, const int* perm, const T* x, T* y, int kk, int B, int rc, int lower,
                  int upper, void* stream) {
  if (B == 0 || kk == 0 || n == 0) return 0;
  if (rc < 1 || rc > kMvVecs) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * ((size_t)3 * rc * s + (size_t)(kMvWarps + 1) * rc * kMvRows);
  const int err = set_smem(bt_matvec_kernel<T>, smem);
  if (err) return err;
  const dim3 grid(K * cdiv(s, kMvRows), B * cdiv(kk, rc));
  bt_matvec_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s,
                                                                      n, perm, x, y, kk, rc, lower, upper);
  return (int)cudaGetLastError();
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
                       int R, T* work, void* stream) {                                                        \
    return launch_trsv<T>(P, K, s, n, perm, b, out, k, mode, R, work, stream);                         \
  }                                                                                                           \
  int tg_bt_factor_blocks_##SUF(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, T* work,    \
                                int cs, int B, void* stream) {                                                \
    return launch_factor_blocks<T>(D, E, P, K, s, logdet, flags, work, cs, B, stream);                        \
  }                                                                                                           \
  int tg_bt_trsv_blocks_##SUF(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work,           \
                              void* stream) {                                                                 \
    return launch_trsv_blocks<T>(P, K, s, b, out, k, B, work, stream);                                        \
  }                                                                                                           \
  int tg_bt_matvec_##SUF(const T* diag, long long diag_k, long long diag_b, const T* sub, long long sub_k,    \
                         long long sub_b, int K, int s, int n, const int* perm, const T* x, T* y, int kk,     \
                         int B, int rc, int lower, int upper, void* stream) {                                 \
    return launch_matvec<T>(diag, diag_k, diag_b, sub, sub_k, sub_b, K, s, n, perm, x, y, kk, B, rc, lower,   \
                            upper, stream);                                                                   \
  }

TG_BT_ENTRY(f32, float)
TG_BT_ENTRY(f64, double)

#undef TG_BT_ENTRY

}  // extern "C"
