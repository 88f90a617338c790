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
// values (n <= 4096, B chains): at the NUTS path's shape (n = 450, B = 8)
// it is bound by the latency of its chain of ceil(n / 64) dependent 64 x 64
// diagonal tiles, each a Cholesky of 64 pivots in sequence; at n = 4096 by
// the rate of the trailing updates. K10 reads L (n^2/2 values) once per
// right-hand side: bound by that read.
// Design. K9 is one launch (dense_chol_kernel): a thread-block cluster per
// chain (kernels/banded.py factor_cluster picks its size: the fewest waves
// of clusters, then the largest; at n = 450, B = 8, eight clusters of 16),
// one block per SM. The cluster writes the chain's factor in place in L
// (B, n, n): its blocks zero their share of the lower 64 x 64 tiles (the
// shift on the diagonal), then scatter the symmetrized, equilibrated
// entries; tiles.cuh chol_rows factors it (block 0 factors and inverts each
// diagonal tile, in float64 also for float32, while the panel and the
// trailing update run as tiles over the cluster, f64 on the tensor cores,
// f32 on the FMA units) and zeroes the upper tiles. The ridge rescue is
// decided in the cluster: after chol_rows' last cluster barrier every block
// reads the attempt's breakdown flag, and a chain that broke down is
// rescattered from its data with the next shift and refactored, twice at
// most; then block 0 writes the level and the logdet, and every block of a
// chain whose last attempt broke down writes NaN over its factor. No flag
// goes to the host and nothing waits on the stream. K10 runs one block per
// (chain, right-hand side) with the vector in shared memory; `dense_selinv`
// solves for X the same way, one block per (chain, column), into a global
// workspace, then dots pairs of X's rows, one warp per wanted entry.

#include "dense_blocks.cuh"
#include "tiles.cuh"

namespace {

using namespace tgdense;

// K9 for chain blockIdx.y on a cluster of gridDim.x blocks: s[b][i] = rsqrt(Q_ii) where Q_ii > 0, else 1; the
// lower triangle of L[b] = S ((d_p + d_tperm(p)) / 2) S (+ shift I), factored by chol_rows, with the shift 0,
// then delta, then 500 delta while it breaks down (flags[3 b + attempt]); Dinv: the chain's inverted diagonal
// tiles (scratch).
template <typename T>
__global__ void __launch_bounds__(tgtile::kThr, 1)
    dense_chol_kernel(const T* __restrict__ data, long long ds, const int* __restrict__ rows,
                      const int* __restrict__ cols, const int* __restrict__ tperm, const int* __restrict__ diag_pos,
                      int nnz, int n, T* L, T* s, int* level, T* logdet, T* Dinv, int* flags) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  double* wsm = reinterpret_cast<double*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, tid = threadIdx.x, nt = ntiles(n);
  const long long b = blockIdx.y;
  const T* d = data + b * ds;
  T* Lb = L + b * (long long)n * n;
  T* Dv = Dinv + b * nt * (long long)kTT;
  int* fail = flags + 3 * b;
  auto scale = [&](int i) -> T {
    const int p = diag_pos[i];
    const T v = p >= 0 ? d[p] : T(0);
    return v > T(0) ? T(1) / sqrt(v) : T(1);
  };
  const int g0 = rank * kThr + tid, gs = cs * kThr;
  if (g0 < 3) fail[g0] = 0;
  for (int i = g0; i < n; i += gs) s[b * n + i] = scale(i);
  const T delta = T(2e-6 * n);
  int attempt = 0;
  for (;; ++attempt) {
    const T shift = attempt == 0 ? T(0) : attempt == 1 ? delta : T(500) * delta;
    int idx = 0;  // the lower tiles: zero, the shift on the diagonal
    for (int I = 0; I < nt; ++I)
      for (int J = 0; J <= I; ++J, ++idx) {
        if (idx % cs != rank) continue;
#pragma unroll 4
        for (int u = 0; u < kTT / kThr; ++u) {
          const int e = tid + u * kThr, r = I * kT + e / kT, c = J * kT + e % kT;
          if (r < n && c < n) Lb[(long long)r * n + c] = r == c ? shift : T(0);
        }
      }
    csync();
    for (int e = g0; e < nnz; e += gs) {  // the pattern's entries in the lower triangle
      const int r = rows[e], c = cols[e];
      if (c > r) continue;
      T v = T(0.5) * (d[e] + d[tperm[e]]) * scale(r) * scale(c);
      if (r == c) v += shift;
      Lb[(long long)r * n + c] = v;
    }
    csync();
    chol_rows(Lb, n, Dv, fail + attempt, rank, cs, sm, wsm, false, [](int, int, int) {});
    if (attempt == 2 || ldcg(fail + attempt) == 0) break;  // every block reads the flag after the same barrier
  }
  const bool broken = ldcg(fail + attempt) != 0;
  if (broken)
    for (long long e = g0; e < (long long)n * n; e += gs) Lb[e] = T(NAN);
  if (rank != 0) return;
  // logdet = 2 sum log L_ii - 2 sum log s_i, by block 0 (its reads of L's diagonal precede any NaN fill of
  // its own tiles; a broken chain's logdet is NaN whatever they read)
  T acc = T(0);
  for (int i = tid; i < n; i += kThr) acc += log(ldcg(Lb + (long long)i * n + i)) - log(scale(i));
  T* red = sm;
  red[tid] = acc;
  __syncthreads();
  for (int off = kThr / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    logdet[b] = broken ? T(NAN) : T(2) * red[0];
    level[b] = attempt;
  }
}

// Shared memory of K9's cluster: chol_rows' need, raised above half an SM's so that no two blocks share an SM.
template <typename T>
size_t chol_smem() {
  const size_t need = tgtile::chol_rows_smem<T>(), one = 116 * 1024;
  return need > one ? need : one;
}

// How many clusters of cs blocks of K9 the card holds at once (0 for a cluster size it refuses).
template <typename T>
int chol_fit(int cs, int* count) {
  return tgtile::cluster_fit(dense_chol_kernel<T>, cs, chol_smem<T>(), count);
}

// K9: one cluster launch of cs blocks per chain; flags: 3 B ints, Dinv: B ceil(n / 64) inverted tiles (scratch).
template <typename T>
int launch_chol(const T* data, long long ds, const int* rows, const int* cols, const int* tperm, const int* diag_pos,
                int nnz, int n, T* L, T* s, int* level, T* logdet, int* flags, T* Dinv, int cs, int B, void* stream) {
  if (B == 0) return 0;
  return tgtile::launch_cluster(dense_chol_kernel<T>, dim3(cs, B), cs, chol_smem<T>(), (cudaStream_t)stream, data,
                                ds, rows, cols, tperm, diag_pos, nnz, n, L, s, level, logdet, Dinv, flags);
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
                          T* work, int cs, int B, void* stream) {                                                \
    return launch_chol<T>(data, ds, rows, cols, tperm, diag_pos, nnz, n, L, s, level, logdet, flags, work, cs,   \
                          B, stream);                                                                            \
  }                                                                                                              \
  int tg_dense_chol_fit_##SUF(int cs, int* count) { return chol_fit<T>(cs, count); }                           \
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
