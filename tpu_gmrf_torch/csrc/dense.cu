// K9 dense_chol and K10 dense_trsv: the dense Cholesky backend of B chains.
//
// Replaces (JAX reference, tpu_gmrf/):
//   K9  solvers/dense.py:102-132 `dense_factorize`, with sparse/matrix.py:44
//       `todense`: densify Q, Jacobi-equilibrate (s = rsqrt(d) where d > 0,
//       else 1), Cholesky of S Q S, and the ridge rescue: a chain whose
//       factor breaks down (a pivot <= 0 or non-finite, where LAPACK's
//       Cholesky gives NaN) is refactored as S Q S + delta I with
//       delta = 2e-6 n, then + 500 delta I; if that breaks down too its
//       factor stays NaN. No Gershgorin step. The reference decides per
//       chain (its batch-wide lax.cond is a shortcut), and so does K9;
//       plus the logdet of solvers/dense.py:69-72.
//   K10 solvers/dense.py:47-62 `solve`, `forward_solve`, `backward_solve`
//       (L y = s.b, L^T z = y, x = s.z); its second entry `dense_selinv`
//       replaces :74-98 `_inv`, `selinv_diag`, `selinv`, `selinv_dot`:
//       Sigma = Q^-1 = X X^T with X = S L^-T, at the wanted entries only
//       (the reference forms all of Q^-1 and gathers).
//
// What bounds them on the card. K9 does n^3/3 flops per chain on n^2
// values (n <= 4096, B chains): at the path's shape (n = 450, B = 8) it is
// bound by the latency of its ~24 dependent launches and of the diagonal
// tiles; at n = 4096 by the FMA rate of the trailing updates. K10 reads
// L (n^2/2 values) once per right-hand side: bound by that read.
// Design: the factor lives in global memory (B, n, n), lower triangle. K9
// scatters the symmetrized, equilibrated Q into it and runs the blocked
// panel Cholesky of dense_blocks.cuh over (chain, tile) blocks; the rescue
// is decided on the host after one flag readback, and only the chains that
// broke down are refactored. K10 runs one block per (chain, right-hand
// side) with the vector in shared memory; `dense_selinv` solves for X the
// same way, one block per (chain, column), into a global workspace, then
// dots pairs of X's rows, one warp per wanted entry.

#include "dense_blocks.cuh"

namespace {

using namespace tgdense;

// L[b][r][c] = s_r (d_p + d_tperm(p)) / 2 s_c (+ shift on the diagonal),
// lower triangle only; s[b][i] = rsqrt(Q_ii) where Q_ii > 0, else 1 (written
// when s is given).
template <typename T>
__global__ void dense_scatter_kernel(const T* data, long long ds, const int* rows, const int* cols, const int* tperm,
                                     const int* diag_pos, int nnz, int n, T* L, T* s, T shift, const int* active) {
  const long long b = blockIdx.y;
  if (active && !active[b]) return;
  const T* d = data + b * ds;
  auto scale = [&](int i) -> T {
    const int p = diag_pos[i];
    const T v = p >= 0 ? d[p] : T(0);
    return v > T(0) ? T(1) / sqrt(v) : T(1);
  };
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (s && e < n) s[b * n + e] = scale(e);
  if (e >= nnz) return;
  const int r = rows[e], c = cols[e];
  if (c > r) return;
  T v = T(0.5) * (d[e] + d[tperm[e]]) * scale(r) * scale(c);
  if (r == c) v += shift;
  L[b * (long long)n * n + (long long)r * n + c] = v;
}

// A chain whose last attempt broke down gets a NaN factor and logdet; the
// others logdet = 2 sum log L_ii - 2 sum log s_i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_finish_kernel(T* L, const T* s, const int* fail, T* logdet, int n) {
  __shared__ T red[kThreads];
  const long long b = blockIdx.x;
  T* Lb = L + b * (long long)n * n;
  if (fail[b]) {
    for (long long i = threadIdx.x; i < (long long)n * n; i += blockDim.x) Lb[i] = T(NAN);
    if (threadIdx.x == 0) logdet[b] = T(NAN);
    return;
  }
  T acc = T(0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += log(Lb[(long long)i * n + i]) - log(s[b * n + i]);
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) logdet[b] = T(2) * red[0];
}

template <typename T>
int launch_chol(const T* data, long long ds, const int* rows, const int* cols, const int* tperm, const int* diag_pos,
                int nnz, int n, T* L, T* s, int* level, T* logdet, int* flags, int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int* fail = flags;
  int* retry = flags + B;
  const long long nn = (long long)n * n;
  int rc = (int)cudaMemsetAsync(fail, 0, sizeof(int) * B, st);
  if (!rc) rc = (int)cudaMemsetAsync(level, 0, sizeof(int) * B, st);
  if (!rc) rc = (int)cudaMemsetAsync(L, 0, sizeof(T) * nn * B, st);
  if (rc) return rc;
  const dim3 grid(cdiv(nnz > n ? nnz : n, kThreads), B);
  dense_scatter_kernel<T><<<grid, kThreads, 0, st>>>(data, ds, rows, cols, tperm, diag_pos, nnz, n, L, s, T(0),
                                                     nullptr);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = factor_panels<T>(L, nn, n, n, n, T(0), nullptr, fail, B, st))) return rc;
  const T delta = T(2e-6 * n);
  for (int attempt = 1; attempt <= 2; ++attempt) {
    bool any;
    if ((rc = any_failed(fail, B, st, &any))) return rc;
    if (!any) break;
    // the chains that broke down (and only they) retry with a larger ridge
    if ((rc = take_failed(nullptr, fail, retry, level, B, st))) return rc;
    if ((rc = fill<T>(L, nn, nn, T(0), retry, B, st))) return rc;
    const T shift = attempt == 1 ? delta : T(500) * delta;
    dense_scatter_kernel<T><<<grid, kThreads, 0, st>>>(data, ds, rows, cols, tperm, diag_pos, nnz, n, L, nullptr,
                                                       shift, retry);
    if ((rc = (int)cudaGetLastError())) return rc;
    if ((rc = factor_panels<T>(L, nn, n, n, n, T(0), retry, fail, B, st))) return rc;
  }
  dense_finish_kernel<T><<<B, kThreads, 0, st>>>(L, s, fail, logdet, n);
  return (int)cudaGetLastError();
}

// One block per (chain, right-hand side): mode 0 y = L^-1 (s.b), mode 1
// x = s.(L^-T b), mode 2 both. b and out are (B, n, k).
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
    dense_trsv_kernel(const T* L, const T* s, const T* b, T* out, int n, int k, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);  // n
  __shared__ T red[kVecThreads];
  const long long chain = blockIdx.x / k;
  const int col = blockIdx.x % k;
  const T* Lb = L + chain * (long long)n * n;
  const T* sb = s + chain * n;
  const T* bb = b + chain * (long long)n * k + col;
  T* ob = out + chain * (long long)n * k + col;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = (mode != 1 ? sb[i] : T(1)) * bb[(long long)i * k];
  __syncthreads();
  if (mode != 1) tri_lower_solve(Lb, n, v, n);
  if (mode != 0) tri_lower_t_solve(Lb, n, v, n, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) ob[(long long)i * k] = (mode != 0 ? sb[i] : T(1)) * v[i];
}

template <typename T>
int launch_trsv(const T* L, const T* s, const T* b, T* out, int n, int k, int mode, int B, void* stream) {
  if (B == 0 || k == 0) return 0;
  const size_t smem = sizeof(T) * (size_t)n;
  int rc = set_smem(dense_trsv_kernel<T>, smem);
  if (rc) return rc;
  dense_trsv_kernel<T><<<B * k, kVecThreads, smem, (cudaStream_t)stream>>>(L, s, b, out, n, k, mode);
  return (int)cudaGetLastError();
}

// K10's second entry, the selected inverse: X = S L^-T (upper triangular),
// one block per (chain, column col). L^T z = e_col has z_i = 0 for i > col,
// so only the leading col + 1 rows are solved: n^3 / 3 flops per chain.
template <typename T>
__global__ void __launch_bounds__(kVecThreads) dense_linv_t_kernel(const T* L, const T* s, T* X, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = reinterpret_cast<T*>(smem_raw);  // n
  __shared__ T red[kVecThreads];
  const long long chain = blockIdx.x / n;
  const int col = blockIdx.x % n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = i == col ? T(1) : T(0);
  __syncthreads();
  tri_lower_t_solve(L + chain * (long long)n * n, n, v, col + 1, red);
  T* xb = X + chain * (long long)n * n + col;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xb[(long long)i * n] = s[chain * n + i] * v[i];
}

// out[b][p] = Sigma at (rows[p], cols[p]) = X_i . X_j over the rows of X,
// from k = max(i, j) on (X is upper triangular): one warp per entry, lanes
// along the two (contiguous) rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_gram_kernel(const T* X, int n, const int* rows, const int* cols, int m, T* out) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (p >= m) return;  // the whole warp
  const long long b = blockIdx.y;
  const int i = rows[p], j = cols[p];
  const T* xi = X + b * (long long)n * n + (long long)i * n;
  const T* xj = X + b * (long long)n * n + (long long)j * n;
  T acc = T(0);
  for (int k = max(i, j) + lane; k < n; k += 32) acc += xi[k] * xj[k];
  for (int o = 16; o; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) out[b * m + p] = acc;
}

template <typename T>
int launch_selinv(const T* L, const T* s, T* X, const int* rows, const int* cols, int m, int n, T* out, int B,
                  void* stream) {
  if (B == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = sizeof(T) * (size_t)n;
  int rc = set_smem(dense_linv_t_kernel<T>, smem);
  if (rc) return rc;
  dense_linv_t_kernel<T><<<B * n, kVecThreads, smem, st>>>(L, s, X, n);
  if ((rc = (int)cudaGetLastError()) || m == 0) return rc;
  dense_gram_kernel<T><<<dim3(cdiv(m, kThreads / 32), B), kThreads, 0, st>>>(X, n, rows, cols, m, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_DENSE_ENTRY(SUF, T)                                                                                   \
  int tg_dense_chol_##SUF(const T* data, long long ds, const int* rows, const int* cols, const int* tperm,       \
                          const int* diag_pos, int nnz, int n, T* L, T* s, int* level, T* logdet, int* flags,    \
                          int B, void* stream) {                                                                 \
    return launch_chol<T>(data, ds, rows, cols, tperm, diag_pos, nnz, n, L, s, level, logdet, flags, B, stream); \
  }                                                                                                              \
  int tg_dense_trsv_##SUF(const T* L, const T* s, const T* b, T* out, int n, int k, int mode, int B,            \
                          void* stream) {                                                                        \
    return launch_trsv<T>(L, s, b, out, n, k, mode, B, stream);                                                  \
  }                                                                                                              \
  int tg_dense_selinv_##SUF(const T* L, const T* s, T* X, const int* rows, const int* cols, int m, int n, T* out, \
                            int B, void* stream) {                                                               \
    return launch_selinv<T>(L, s, X, rows, cols, m, n, out, B, stream);                                          \
  }

TG_DENSE_ENTRY(f32, float)
TG_DENSE_ENTRY(f64, double)

#undef TG_DENSE_ENTRY

}  // extern "C"
