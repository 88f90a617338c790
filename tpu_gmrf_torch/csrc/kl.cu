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
// For column k with N valid rows, A = sym(Theta_valid) + jitter I = L L^T
// (right-looking Cholesky, in place, lower triangle), and the column is
// x = L^-T e_last (U = L^T in the reference's notation, x = U^-1 e_last),
// solved column by column from the last row up. A pivot that is not > 0
// (or NaN) makes its column NaN throughout, as LAPACK's failed Cholesky makes
// the reference's. Every entry of L belongs to exactly one column: no atomics.
//
// What bounds it on the card: N^3/3 + N^2 flops on N^2 values per column. At
// rho = 3 (N <= 32) a column is 8 KB of Theta and ~11k flops: bound by the
// bytes of the padded Theta buckets the cov_fn writes, and by the latency of
// the N dependent steps. At rho = 6 (N <= 128) the flops grow to ~0.7M per
// column and the N steps of 2 barriers each bound a block.
//
// Design: three paths, chosen by the wrapper from cap and the dtype.
//   cap <= 32: one warp per column, four columns per block, the column's
//     matrix in the warp's slice of shared memory, __syncwarp between steps;
//   cap up to the shared-memory limit (f64: 168): one block per column with
//     the matrix in shared memory (opt-in above 48 KB);
//   beyond: the same block code on a global-memory workspace (B, cap (cap+1)
//     + 2 cap) that the wrapper allocates. No path refuses a size.
// Arithmetic is rounded per operation (rn_ops.cuh), so the plain version on
// the same inputs gives the same bits, breakdowns included.

#include "rn_ops.cuh"

namespace {

using tgrn::Rn;

template <bool kWarp>
__device__ __forceinline__ void step_sync() {
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One column. th: this column's (cap, cap) Theta; pos: its (cap,) entry
// positions (the first cap - N are padding); A (lda >= N), dg (N), x (N):
// workspace in shared or global memory; tid / nthr: this thread among the
// column's threads.
template <typename T, bool kWarp>
__device__ void kl_column(const T* __restrict__ th, int cap, int N, T jitter, const int* __restrict__ pos,
                          T* __restrict__ out, T* A, int lda, T* dg, T* x, int tid, int nthr) {
  using O = Rn<T>;
  const int off = cap - N;
  for (int e = tid; e < N * N; e += nthr) {
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
  for (int i = tid; i < N; i += nthr) x[i] = (i == N - 1) ? T(1) : T(0);
  step_sync<kWarp>();
  for (int j = 0; j < N; ++j) {
    const T d = A[j * lda + j];
    const T ljj = d > T(0) ? O::sqrt(d) : O::nan();
    for (int i = j + 1 + tid; i < N; i += nthr) A[i * lda + j] = O::div(A[i * lda + j], ljj);
    if (tid == 0) dg[j] = ljj;
    step_sync<kWarp>();
    const int M = N - j - 1;
    for (int e = tid; e < M * M; e += nthr) {
      const int i = j + 1 + e / M, k = j + 1 + (e - (e / M) * M);
      if (k <= i) A[i * lda + k] = O::sub(A[i * lda + k], O::mul(A[i * lda + j], A[k * lda + j]));
    }
    step_sync<kWarp>();
  }
  // L^T x = e_last, from the last row up: x_i /= L_ii, then x_r -= L_ir x_i for r < i
  for (int i = N - 1; i >= 0; --i) {
    const T xi = O::div(x[i], dg[i]);
    for (int r = tid; r < i; r += nthr) x[r] = O::sub(x[r], O::mul(A[i * lda + r], xi));
    if (tid == 0) out[pos[off + i]] = xi;
    step_sync<kWarp>();
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
  kl_column<T, true>(theta + b * cap * cap, cap, count[b], jitter, pos + b * cap, out, A, kWarpLda,
                     A + 32 * kWarpLda, A + 32 * kWarpLda + 32, lane, 32);
}

// kGlobal: the workspace is the column's slice of `work` (cap (cap+1) + 2 cap
// values), else dynamic shared memory of the same layout.
template <typename T, bool kGlobal>
__global__ void kl_block_kernel(const T* __restrict__ theta, const int* __restrict__ pos, const int* __restrict__ count,
                                int cap, T jitter, T* __restrict__ out, T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int lda = cap + 1;
  T* A = kGlobal ? work + b * ((long long)cap * lda + 2 * cap) : reinterpret_cast<T*>(smem_raw);
  kl_column<T, false>(theta + b * cap * cap, cap, count[b], jitter, pos + b * cap, out, A, lda, A + cap * lda,
                      A + cap * lda + cap, threadIdx.x, blockDim.x);
}

// cap <= 32: the warp path; else the block path, in shared memory when
// `work` is null, else in `work`.
template <typename T>
int launch_kl(const T* theta, const int* pos, const int* count, int cap, double jitter, T* out, T* work, int B,
              void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cap <= 32) {
    const size_t smem = sizeof(T) * kWarpsPerBlock * kWarpSlice;
    const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kl_warp_kernel<T><<<grid, 32 * kWarpsPerBlock, smem, st>>>(theta, pos, count, cap, (T)jitter, out, B);
    return (int)cudaGetLastError();
  }
  const int threads = cap <= 128 ? 128 : 256;
  if (work == nullptr) {
    const size_t smem = sizeof(T) * ((size_t)cap * (cap + 1) + 2 * (size_t)cap);
    int rc = tgrn::set_smem(kl_block_kernel<T, false>, smem);
    if (rc) return rc;
    kl_block_kernel<T, false><<<B, threads, smem, st>>>(theta, pos, count, cap, (T)jitter, out, nullptr);
  } else {
    kl_block_kernel<T, true><<<B, threads, 0, st>>>(theta, pos, count, cap, (T)jitter, out, work);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tg_kl_columns_f32(const float* theta, const int* pos, const int* count, int cap, double jitter, float* out,
                      float* work, int B, void* stream) {
  return launch_kl<float>(theta, pos, count, cap, jitter, out, work, B, stream);
}
int tg_kl_columns_f64(const double* theta, const int* pos, const int* count, int cap, double jitter, double* out,
                      double* work, int B, void* stream) {
  return launch_kl<double>(theta, pos, count, cap, jitter, out, work, B, stream);
}

}  // extern "C"
