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
// right-hand side group: at B = 8, n = 450 by the latency of its chain of
// 2 ceil(n / 64) dependent tile steps.
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
// goes to the host and nothing waits on the stream. K9 keeps the inverted
// diagonal tiles (Dinv) for K10, which solves by them: a cluster per chain
// and group of 8 or 64 right-hand sides (kernels/dense.py sizes it, at most a
// block per 64-row tile), tiles.cuh trsm_rows forward and then backward, so
// each diagonal step is a product (f64 on the tensor cores, f32 on the FMA
// units) followed by one cluster barrier. `dense_selinv` solves for X with
// the same kernel on the identity into a global workspace, then dots pairs
// of X's rows, one warp per wanted entry.

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

// K9: one cluster launch of cs blocks per chain; flags: 3 B ints, Dinv: B ceil(n / 64) inverted tiles.
template <typename T>
int launch_chol(const T* data, long long ds, const int* rows, const int* cols, const int* tperm, const int* diag_pos,
                int nnz, int n, T* L, T* s, int* level, T* logdet, int* flags, T* Dinv, int cs, int B, void* stream) {
  if (B == 0) return 0;
  return tgtile::launch_cluster(dense_chol_kernel<T>, dim3(cs, B), cs, chol_smem<T>(), (cudaStream_t)stream, data,
                                ds, rows, cols, tperm, diag_pos, nnz, n, L, s, level, logdet, Dinv, flags);
}

// K10: cluster (rank, group, chain) solves columns NT group .. NT group + q of
// its chain's right-hand sides b (B, n, k) into out by K9's inverted 64 x 64
// diagonal tiles Dinv (B, ntiles(n) 64 64): mode 0 out = L^-1 (s.b), mode 1
// out = s.(L^-T b), mode 2 both; b == nullptr stands for the identity (k = n:
// K10's second entry solves X = S L^-T so). Row tile i belongs to block
// i % cs throughout (tiles.cuh trsm_rows), so only its owner writes it; a
// cluster barrier publishes the scaled right-hand sides, and after
// trsm_rows' last one every tile is final.
template <typename T, int NT>
__global__ void __launch_bounds__(tgtile::kThr)
    dense_trsv_kernel(const T* L, const T* s, const T* Dinv, const T* b, T* out, int n, int k, int mode) {
  using namespace tgtile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, nt = ntiles(n);
  const int c0 = blockIdx.y * NT, q = min(NT, k - c0);
  const long long chain = blockIdx.z;
  const T* Lb = L + chain * n * n;
  const T* sb = s + chain * n;
  const T* Db = Dinv + chain * nt * kTT;
  const T* bb = b ? b + chain * n * k + c0 : nullptr;
  T* X = out + chain * n * k + c0;
  // each block's row tiles of X: e = (row, column) within the tile, for every thread
  auto own = [&](auto f) {
    for (int i = rank; i < nt; i += cs)
      for (int e = threadIdx.x; e < min(kT, n - i * kT) * q; e += kThr) f((long long)i * kT + e / q, e % q);
  };
  own([&](long long r, int c) {
    const T v = bb ? bb[r * k + c] : T(r == c0 + c);
    X[r * k + c] = mode != 1 ? sb[r] * v : v;
  });
  csync();
  if (mode != 1) trsm_rows<T, NT>(Lb, n, Db, n, X, k, q, false, rank, cs, sm);
  if (mode == 0) return;
  trsm_rows<T, NT>(Lb, n, Db, n, X, k, q, true, rank, cs, sm);
  own([&](long long r, int c) { X[r * k + c] *= sb[r]; });
}

// Shared memory of K10: the staging of tiles.cuh's products with NT columns.
template <typename T, int NT>
size_t trsv_smem() {
  using C = tgtile::Cfg<NT>;
  return sizeof(T) * 2 * tgtile::kKS * (C::LDA + C::LDB);
}

// How many clusters of cs blocks of K10 (64 columns with `wide`, else 8) the card holds at once.
template <typename T>
int trsv_fit(int cs, int wide, int* count) {
  return wide ? tgtile::cluster_fit(dense_trsv_kernel<T, 64>, cs, trsv_smem<T, 64>(), count)
              : tgtile::cluster_fit(dense_trsv_kernel<T, 8>, cs, trsv_smem<T, 8>(), count);
}

// K10: one cluster of cs blocks per chain and group of 8 right-hand sides (k <= 8) or 64.
template <typename T>
int launch_trsv(const T* L, const T* s, const T* Dinv, const T* b, T* out, int n, int k, int mode, int cs, int B,
                void* stream) {
  if (B == 0 || k == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8)
    return tgtile::launch_cluster(dense_trsv_kernel<T, 8>, dim3(cs, 1, B), cs, trsv_smem<T, 8>(), st, L, s, Dinv, b,
                                  out, n, k, mode);
  return tgtile::launch_cluster(dense_trsv_kernel<T, 64>, dim3(cs, cdiv(k, 64), B), cs, trsv_smem<T, 64>(), st, L, s,
                                Dinv, b, out, n, k, mode);
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

// K10's second entry, the selected inverse: X = S L^-T (upper triangular) by
// K10 in mode 1 on the identity, into the workspace X (B, n, n), then the
// dots of pairs of its rows.
template <typename T>
int launch_selinv(const T* L, const T* s, const T* Dinv, T* X, const int* rows, const int* cols, int m, int n,
                  T* out, int cs, int B, void* stream) {
  if (B == 0 || n == 0) return 0;
  int rc = launch_trsv<T>(L, s, Dinv, nullptr, X, n, n, 1, cs, B, stream);
  if (rc || m == 0) return rc;
  dense_gram_kernel<T><<<dim3(cdiv(m, kThreads / 32), B), kThreads, 0, (cudaStream_t)stream>>>(X, n, rows, cols, m,
                                                                                               out);
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
  int tg_dense_trsv_##SUF(const T* L, const T* s, const T* Dinv, const T* b, T* out, int n, int k, int mode,   \
                          int cs, int B, void* stream) {                                                         \
    return launch_trsv<T>(L, s, Dinv, b, out, n, k, mode, cs, B, stream);                                        \
  }                                                                                                              \
  int tg_dense_trsv_fit_##SUF(int cs, int wide, int* count) { return trsv_fit<T>(cs, wide, count); }            \
  int tg_dense_selinv_##SUF(const T* L, const T* s, const T* Dinv, T* X, const int* rows, const int* cols, int m, \
                            int n, T* out, int cs, int B, void* stream) {                                        \
    return launch_selinv<T>(L, s, Dinv, X, rows, cols, m, n, out, cs, B, stream);                                \
  }

TG_DENSE_ENTRY(f32, float)
TG_DENSE_ENTRY(f64, double)

#undef TG_DENSE_ENTRY

}  // extern "C"
