// K16 kl_columns: the per-column dense solves of the KL-optimal sparse
// Cholesky factor (Schäfer, Katzfuss & Owhadi), written straight into L's
// data.
//
// Replaces (JAX reference, tpu_gmrf/): kl_cholesky.py:116-134 inside
// `sparse_approximate_cholesky` (:85): per bucket of columns padded to a
// common size cap, Theta[S,S] (from the user's cov_fn) is masked, given
// jitter on the diagonal and decoupled identity rows on the padding, factored
// by jnp.linalg.cholesky, solved against e_last by solve_triangular, and
// scatter-added into L's data at entry_pos. jnp.linalg.cholesky symmetrizes
// its input ((A + A^T) / 2, both triangles read), so the kernel factors
// (Theta + Theta^T) / 2 + jitter I as well. Padding is at the front and
// decoupled, so the kernel works on the trailing N x N block only and never
// reads a padded entry (a cov_fn that gives NaN there cannot poison a column).
//
// For column k with N valid rows, A = sym(Theta_valid) + jitter I = L L^T,
// and the column is x = L^-T e_last (U = L^T in the reference's notation,
// x = U^-1 e_last), which is the last row of L^-1. A pivot that is not > 0
// (or NaN) makes its column NaN throughout, as LAPACK's failed Cholesky
// makes the reference's. Every entry of L belongs to exactly one column: no
// atomics.
//
// What bounds it on the card: N^3/3 + N^2 flops on N^2 values per column. At
// rho = 3 (N <= 32) a column is 8 KB of Theta and ~11k flops; at rho = 6
// (N <= 128, ~0.7M flops per column, thousands of columns) the bytes of
// Theta bound it at 0.11 ms in f64 at n = 10,000. What a column costs is the
// latency of its chain of N dependent pivots, so the design keeps many
// columns in flight and takes each pivot fast.
//
// Design: three paths, chosen by the wrapper from cap (kernels/kl.py
// kl_path).
//   warp (cap <= 32): one warp per column, four columns per block, the
//     column's matrix in the warp's slice of shared memory, __syncwarp
//     between steps; arithmetic rounded per operation (rn_ops.cuh), so the
//     plain version on the same inputs gives the same bits.
//   tile (32 < cap <= 128): one block per column, its tiles of 64 in shared
//     memory in float64 (also for float32 Theta: the symmetrized, jittered
//     matrix is formed in the input's type, as the plain version forms it,
//     then factored in float64). The diagonal tile is factored and inverted
//     by tiles.cuh factor_tile_smem (pivots passed by warp shuffles); with a
//     second tile, L10 = A10 X00^T, A11 - L10 L10^T and G = L10 X00 are
//     products from shared memory on the FMA units (the operands are there
//     already; a 64 x 64 x 64 product from shared memory costs about what
//     it costs on the tensor cores from global memory), then the second tile
//     is factored and inverted. No substitution: the last row of L^-1 is
//     X00's last row (one tile), or [-y^T G, y^T] with y^T the last row of
//     X11. Three tile buffers (100 KB): two blocks per SM; one tile: three.
//   cluster (cap > 128): a thread-block cluster per column (kernels/kl.py
//     kl_cluster picks its size: the fewest waves, then the largest) on a
//     workspace the wrapper allocates (Theta is the caller's and is not
//     written): the cluster writes the symmetrized, jittered matrix there,
//     factors it with tiles.cuh chol_rows (diagonal tiles by block 0 in
//     float64, panels and trailing updates as tiles over the cluster, f64 on
//     the tensor cores, f32 on the FMA units) and solves L^T x = e_N with
//     trsm_rows on the inverted diagonal tiles; the breakdown flag is read
//     by every block after a cluster barrier.
// The tile and cluster paths round in another order than the plain version
// (fused multiply-adds, products by inverted tiles); chip_smoke.py holds
// them to it by backward error and by distance, against the library's order.

#include "rn_ops.cuh"
#include "tiles.cuh"

namespace {

using tgrn::Rn;
using namespace tgtile;

// ---- the warp path -----------------------------------------------------------

// One column on one warp. th: this column's (cap, cap) Theta; pos: its (cap,)
// entry positions (the first cap - N are padding); A (lda >= N), dg (N), x
// (N): the warp's slice of shared memory. Right-looking Cholesky in place
// (lower triangle), then L^T x = e_last from the last row up.
template <typename T>
__device__ void kl_column_warp(const T* __restrict__ th, int cap, int N, T jitter, const int* __restrict__ pos,
                               T* __restrict__ out, T* A, int lda, T* dg, T* x, int lane) {
  using O = Rn<T>;
  const int off = cap - N;
  for (int e = lane; e < N * N; e += 32) {
    const int i = e / N, k = e - (e / N) * N;
    if (k > i) continue;
    const T a = th[(long long)(off + i) * cap + off + k];
    if (i == k) {
      A[i * lda + k] = O::add(a, jitter);
    } else {
      const T b = th[(long long)(off + k) * cap + off + i];
      A[i * lda + k] = O::mul(O::add(a, b), T(0.5));
    }
  }
  for (int i = lane; i < N; i += 32) x[i] = (i == N - 1) ? T(1) : T(0);
  __syncwarp();
  for (int j = 0; j < N; ++j) {
    const T d = A[j * lda + j];
    const T ljj = d > T(0) ? O::sqrt(d) : O::nan();
    for (int i = j + 1 + lane; i < N; i += 32) A[i * lda + j] = O::div(A[i * lda + j], ljj);
    if (lane == 0) dg[j] = ljj;
    __syncwarp();
    const int M = N - j - 1;
    for (int e = lane; e < M * M; e += 32) {
      const int i = j + 1 + e / M, k = j + 1 + (e - (e / M) * M);
      if (k <= i) A[i * lda + k] = O::sub(A[i * lda + k], O::mul(A[i * lda + j], A[k * lda + j]));
    }
    __syncwarp();
  }
  // L^T x = e_last, from the last row up: x_i /= L_ii, then x_r -= L_ir x_i for r < i
  for (int i = N - 1; i >= 0; --i) {
    const T xi = O::div(x[i], dg[i]);
    for (int r = lane; r < i; r += 32) x[r] = O::sub(x[r], O::mul(A[i * lda + r], xi));
    if (lane == 0) out[pos[off + i]] = xi;
    __syncwarp();
  }
}

constexpr int kWarpsPerBlock = 4;
constexpr int kWarpLda = 33;
constexpr int kWarpSlice = 32 * kWarpLda + 64;  // A, dg, x of one warp

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    kl_warp_kernel(const T* __restrict__ theta, const int* __restrict__ pos, const int* __restrict__ count, int cap,
                   T jitter, T* __restrict__ out, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // the whole warp: only __syncwarp is used below
  T* A = reinterpret_cast<T*>(smem_raw) + warp * kWarpSlice;
  kl_column_warp<T>(theta + b * cap * cap, cap, count[b], jitter, pos + b * cap, out, A, kWarpLda,
                    A + 32 * kWarpLda, A + 32 * kWarpLda + 32, lane);
}

// ---- the tile path -------------------------------------------------------------

constexpr int kBuf = kT * kLdS;  // values of one 64 x 64 tile buffer (row stride kLdS)

// S (64 x 64) = the rows x cols corner of the matrix at th (row stride ldt), zero elsewhere; coalesced.
template <typename T>
__device__ __forceinline__ void load_square(const T* th, long long ldt, int rows, int cols, double* S) {
#pragma unroll 4
  for (int u = 0; u < kTT / kThr; ++u) {
    const int e = threadIdx.x + u * kThr, r = e / kT, c = e % kT;
    S[r * kLdS + c] = r < rows && c < cols ? double(th[r * ldt + c]) : 0.0;
  }
}

// Entry (r, c) of the lower tile sym(S) + jitter I for t valid rows, formed in T as the plain version forms it
// ((a + b) * 0.5, a + jitter), the identity beyond t, zero above the diagonal.
template <typename T>
__device__ __forceinline__ double sym_lower(const double* S, int r, int c, int t, T jitter) {
  if (r >= t || c >= t) return r == c ? 1.0 : 0.0;
  if (c > r) return 0.0;
  if (c == r) return double(T(S[r * kLdS + r]) + jitter);
  return double((T(S[r * kLdS + c]) + T(S[c * kLdS + r])) * T(0.5));
}

// acc[i][j] += sum_{k < kd} A(r, k) B(c, k) at (r, c) = (ty + 16 i, tx + 16 j), (tx, ty) = (tid % 16,
// tid / 16): A(r, k) = A[r kLdS + k], B(c, k) = Bm[c sbc + k sbk], both in shared memory. A warp reads two
// rows of A (broadcast) and 16 entries of B that fall in distinct banks.
__device__ __forceinline__ void smem_prod(double (&acc)[4][4], const double* A, const double* Bm, int sbc, int sbk,
                                          int kd) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < kd; ++k) {
    double a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * kLdS + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * sbc + k * sbk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// f(i, j, r, c) for the thread's 4 x 4 entries (r, c) = (ty + 16 i, tx + 16 j) of a 64 x 64 tile, as smem_prod
// lays them out.
template <typename F>
__device__ __forceinline__ void each_entry(F f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) f(i, j, (threadIdx.x >> 4) + 16 * i, (threadIdx.x & 15) + 16 * j);
}

// One column per block (NT = 1: cap <= 64; NT = 2: cap <= 128). Shared memory: NT + 1 tile buffers of float64,
// rinv (64) and, for NT = 2, 256 partial sums.
template <typename T, int NT>
__global__ void __launch_bounds__(kThr, 2)
    kl_tile_kernel(const T* __restrict__ theta, const int* __restrict__ pos, const int* __restrict__ count, int cap,
                   T jitter, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  double* B0 = reinterpret_cast<double*>(smem_raw);  // the tile being factored
  double* B1 = B0 + kBuf;                            // its inverse
  double* B2 = B1 + kBuf;                            // NT = 2: A10, L10, then G = L10 X00
  double* rinv = B0 + (NT + 1) * kBuf;
  double* red = rinv + kT;
  const long long b = blockIdx.x;
  const int N = count[b], off = cap - N, tid = threadIdx.x;
  if (N <= 0) return;  // the whole block
  const T* th = theta + b * cap * cap + (long long)off * cap + off;
  const int* pb = pos + b * cap + off;
  const int t0 = min(kT, N), t1 = N - t0;  // t1 > 0 only for NT = 2
  if (tid == 0) bad = 0;
  if (tid < kT) rinv[tid] = 1.0;
  load_square(th, cap, t0, t0, B0);
  if constexpr (NT == 2) {
    if (t1 > 0) {
      load_square(th + (long long)kT * cap, cap, t1, kT, B2);  // Theta_10
      load_square(th + kT, cap, kT, t1, B1);                   // Theta_01
    }
  }
  __syncthreads();
  {  // A00 (lower, jittered) in B0; A10 = (Theta_10 + Theta_01^T) / 2 in B2; B1 cleared for the inverse
    double v[4][4], w[4][4];
    each_entry([&](int i, int j, int r, int c) {
      v[i][j] = sym_lower<T>(B0, r, c, t0, jitter);
      if constexpr (NT == 2)
        w[i][j] = t1 > 0 && r < t1 ? double((T(B2[r * kLdS + c]) + T(B1[c * kLdS + r])) * T(0.5)) : 0.0;
    });
    __syncthreads();
    each_entry([&](int i, int j, int r, int c) {
      B0[r * kLdS + c] = v[i][j];
      B1[r * kLdS + c] = 0.0;
      if constexpr (NT == 2) B2[r * kLdS + c] = w[i][j];
    });
    __syncthreads();
  }
  factor_tile_smem(B0, B1, rinv, t0, &bad, 0.0, [] {});
  if (NT == 1 || t1 == 0) {  // x^T = the last row of X00
    const bool nan = bad != 0;
    for (int i = tid; i < t0; i += kThr) out[pb[i]] = nan ? T(NAN) : T(B1[(t0 - 1) * kLdS + i]);
    return;
  }
  if constexpr (NT == 2) {
    double acc[4][4];
    // L10 = A10 L00^-T = A10 X00^T (X00 is zero above its diagonal), in place in B2
    each_entry([&](int i, int j, int, int) { acc[i][j] = 0.0; });
    smem_prod(acc, B2, B1, kLdS, 1, kT);
    __syncthreads();
    each_entry([&](int i, int j, int r, int c) { B2[r * kLdS + c] = acc[i][j]; });
    // A11 = sym(Theta_11) + jitter I - L10 L10^T in B0 (L00 is no longer needed)
    load_square(th + (long long)kT * cap + kT, cap, t1, t1, B0);
    __syncthreads();
    each_entry([&](int i, int j, int, int) { acc[i][j] = 0.0; });
    smem_prod(acc, B2, B2, kLdS, 1, kT);
    each_entry([&](int i, int j, int r, int c) {
      acc[i][j] = sym_lower<T>(B0, r, c, t1, jitter) - (c <= r ? acc[i][j] : 0.0);
    });
    __syncthreads();
    each_entry([&](int i, int j, int r, int c) { B0[r * kLdS + c] = acc[i][j]; });
    // G = L10 X00 in place in B2 (after it X00 is not needed)
    each_entry([&](int i, int j, int, int) { acc[i][j] = 0.0; });
    smem_prod(acc, B2, B1, 1, kLdS, kT);
    __syncthreads();
    each_entry([&](int i, int j, int r, int c) { B2[r * kLdS + c] = acc[i][j]; });
    __syncthreads();
    factor_tile_smem(B0, B1, rinv, t1, &bad, 0.0, [] {});
    // the last row of L^-1: [-y^T G, y^T], y^T the last row of X11
    const double* y = B1 + (t1 - 1) * kLdS;
    double part = 0.0;
    for (int r = tid >> 6; r < t1; r += kThr / kT) part = fma(B2[r * kLdS + (tid & 63)], y[r], part);
    red[tid] = part;
    __syncthreads();
    const bool nan = bad != 0;
    if (tid < kT)
      out[pb[tid]] = nan ? T(NAN) : T(-(red[tid] + red[tid + 64] + red[tid + 128] + red[tid + 192]));
    else if (tid < kT + t1)
      out[pb[tid]] = nan ? T(NAN) : T(y[tid - kT]);
  }
}

template <int NT>
constexpr size_t tile_smem() {
  return sizeof(double) * ((NT + 1) * kBuf + kT + (NT == 2 ? kThr : 0));
}

// ---- the cluster path ----------------------------------------------------------

// The values of one column's workspace: its matrix (cap x cap), its inverted diagonal tiles and x.
__host__ __device__ inline long long cluster_work(int cap) { return (long long)cap * cap + (long long)ntiles(cap) * kTT + cap; }

// Column blockIdx.y on a cluster of gridDim.x blocks: the symmetrized, jittered matrix written into the
// column's workspace (row stride N), chol_rows, then L^T x = e_N by trsm_rows; flags[b]: the column's
// breakdown flag.
template <typename T>
__global__ void __launch_bounds__(kThr)
    kl_cluster_kernel(const T* __restrict__ theta, const int* __restrict__ pos, const int* __restrict__ count,
                      int cap, T jitter, T* __restrict__ out, T* work, int* flags) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  double* wsm = reinterpret_cast<double*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x;
  const long long b = blockIdx.y;
  const int N = count[b], off = cap - N;
  if (N <= 0) return;  // the whole cluster
  const T* th = theta + b * cap * cap + (long long)off * cap + off;
  const int* pb = pos + b * cap + off;
  T* A = work + b * cluster_work(cap);
  T* Dinv = A + (long long)cap * cap;
  T* x = Dinv + (long long)ntiles(cap) * kTT;
  int* bad = flags + b;
  if (rank == 0 && threadIdx.x == 0) *bad = 0;
  const int g0 = rank * kThr + threadIdx.x, gs = cs * kThr;
  for (int e = g0; e < N * N; e += gs) {
    const int r = e / N, c = e - r * N;
    T a = T(0);
    if (c == r)
      a = th[(long long)r * cap + r] + jitter;
    else if (c < r)
      a = (th[(long long)r * cap + c] + th[(long long)c * cap + r]) * T(0.5);
    A[e] = a;
  }
  for (int i = g0; i < N; i += gs) x[i] = i == N - 1 ? T(1) : T(0);
  csync();
  chol_rows(A, N, Dinv, bad, rank, cs, sm, wsm, false, [](int, int, int) {});
  trsm_rows<T, 8>(A, N, Dinv, N, x, 1, 1, true, rank, cs, sm);
  const bool nan = ldcg(bad) != 0;
  for (int i = g0; i < N; i += gs) out[pb[i]] = nan ? T(NAN) : ldcg(x + i);
}

// How many clusters of cs blocks of the cluster path the card holds at once (0 for a size it refuses).
template <typename T>
int kl_fit(int cs, int* count) {
  return cluster_fit(kl_cluster_kernel<T>, cs, chol_rows_smem<T>(), count);
}

// cap <= 32: the warp path; cap <= 128: the tile path; else the cluster path in clusters of cs blocks, on
// `work` (B cluster_work(cap) values) and `flags` (B ints).
template <typename T>
int launch_kl(const T* theta, const int* pos, const int* count, int cap, double jitter, T* out, T* work, int* flags,
              int cs, int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cap <= 32) {
    const size_t smem = sizeof(T) * kWarpsPerBlock * kWarpSlice;
    const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kl_warp_kernel<T><<<grid, 32 * kWarpsPerBlock, smem, st>>>(theta, pos, count, cap, (T)jitter, out, B);
    return (int)cudaGetLastError();
  }
  if (cap <= 2 * kT) {
    auto kernel = cap <= kT ? kl_tile_kernel<T, 1> : kl_tile_kernel<T, 2>;
    const size_t smem = cap <= kT ? tile_smem<1>() : tile_smem<2>();
    int rc = tgrn::set_smem(kernel, smem);
    if (rc) return rc;
    kernel<<<B, kThr, smem, st>>>(theta, pos, count, cap, (T)jitter, out);
    return (int)cudaGetLastError();
  }
  return launch_cluster(kl_cluster_kernel<T>, dim3(cs, B), cs, chol_rows_smem<T>(), st, theta, pos, count, cap,
                        (T)jitter, out, work, flags);
}

}  // namespace

extern "C" {

int tg_kl_columns_f32(const float* theta, const int* pos, const int* count, int cap, double jitter, float* out,
                      float* work, int* flags, int cs, int B, void* stream) {
  return launch_kl<float>(theta, pos, count, cap, jitter, out, work, flags, cs, B, stream);
}
int tg_kl_columns_f64(const double* theta, const int* pos, const int* count, int cap, double jitter, double* out,
                      double* work, int* flags, int cs, int B, void* stream) {
  return launch_kl<double>(theta, pos, count, cap, jitter, out, work, flags, cs, B, stream);
}
int tg_kl_fit_f32(int cs, int* count) { return kl_fit<float>(cs, count); }
int tg_kl_fit_f64(int cs, int* count) { return kl_fit<double>(cs, count); }

}  // extern "C"
