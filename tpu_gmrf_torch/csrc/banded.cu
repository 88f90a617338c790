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
//   right-hand sides with no permutation. The first is K11's fast pass with
//   the scatter swapped for the block layout; the second is K12's
//   substitution with the permutation swapped for the block layout while its
//   B k right-hand sides fit a few waves of blocks on the card, and beyond
//   that (the SPIKE solve has 1 + 2 s of them) solves column tiles of up to
//   kNB right-hand sides at a time on block_gemm and blk_trsm of
//   dense_blocks.cuh.
//
// What bounds them on the card. K11 does about K s^3 (7/3) flops per chain
// (n = 5741, s = 512, K = 12, B = 4: ~1.5e10) on K 2 s^2 values: bound by
// the FMA rate of the trailing updates and, at B = 4, by the latency of the
// dependent diagonal tiles (K s / 64 of them per factorization, one block
// per chain each). K12 reads L and M once per direction: bound by that read
// from one block per right-hand side. Its block entry's tiles read them once
// per direction and 64 right-hand sides; each tile is a chain of K dependent
// block steps whose products run at one block's latency, ~4.5x one
// right-hand side's block (f64, s = 450, K = 31: ~100 and ~22 ms), so the
// tiles pay off only past four waves of right-hand sides.
// Design: chain b's factor is one array P[b] of K panels (2s x s each, rows
// 0..s the diagonal block, rows s..2s the sub-diagonal block below it); a
// panel is factored by the blocked panel Cholesky of dense_blocks.cuh, so
// L_k and M_k come out of one pass, and U_k is applied to the next panel's
// diagonal block as it stands (one trailing update). The pivot boost is
// decided as the reference decides it, per chain and block: a fast pass
// factors every chain without boost and flags breakdowns; one flag readback
// follows; the chains that broke down (rare: f32 at extreme conditioning)
// are redone from the scatter on, block by block, each block retried as
// `_chol_boosted` does. K12 runs one block per (chain, right-hand side)
// with the whole permuted vector in shared memory, or, when it does not
// fit (npad above ~25k in float64), in a global workspace row.
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

// Panel k of the chains in `active`: factor it; then, if a next block
// exists, D_{k+1} -= M_k M_k^T.
template <typename T>
int factor_block(T* P, long long pstride, int k, int K, int s, T tiny, const int* active, int* fail, int B,
                 cudaStream_t st) {
  const long long panel = 2LL * s * s;
  T* Pk = P + k * panel;
  int rc = factor_panels<T>(Pk, pstride, s, k < K - 1 ? 2 * s : s, s, tiny, active, fail, B, st);
  if (rc || k == K - 1) return rc;
  syrk_lower_kernel<T><<<dim3(cdiv(s, kGB), cdiv(s, kGB), B), kThreads, 0, st>>>(
      Pk + panel, pstride, s, Pk + (long long)s * s, pstride, s, s, s, s, active);
  return (int)cudaGetLastError();
}

// Every block of every chain (in `active`, all when null), in order, no boost.
template <typename T>
int factor_pass(T* P, long long pstride, int K, int s, T tiny, int* fail, int B, cudaStream_t st) {
  int rc = 0;
  for (int k = 0; k < K && !rc; ++k) rc = factor_block<T>(P, pstride, k, K, s, tiny, nullptr, fail, B, st);
  return rc;
}

template <typename T>
int launch_factor(const T* data, long long ds, const int* src, const int* dst, int ntab, const int* tperm, T* P,
                  int K, int s, T* ws, T* dom, int* boost, T* logdet, int* flags, int B, void* stream) {
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
  if ((rc = factor_pass<T>(P, pstride, K, s, tiny, fail, B, st))) return rc;
  bool any;
  if (rc || (rc = any_failed(fail, B, st, &any))) return rc;
  if (any) {
    // the chains that broke down are redone block by block with the boost
    if ((rc = take_failed(nullptr, fail, redo, nullptr, B, st))) return rc;
    if ((rc = fill<T>(P, pstride, pstride, T(0), redo, B, st))) return rc;
    bt_scatter_kernel<T><<<sgrid, kThreads, 0, st>>>(data, ds, src, dst, ntab, tperm, P, pstride, redo);
    if ((rc = (int)cudaGetLastError())) return rc;
    for (int k = 0; k < K; ++k) {
      T* Pk = P + k * panel;
      const long long count = (long long)(k < K - 1 ? 2 * s : s) * s;
      if ((rc = copy_shift<T>(ws, panel, Pk, pstride, count, s, T(0), nullptr, redo, B, st))) return rc;
      if ((rc = factor_panels<T>(Pk, pstride, s, k < K - 1 ? 2 * s : s, s, tiny, redo, fail, B, st))) return rc;
      if ((rc = any_failed(fail, B, st, &any))) return rc;
      if (any) {
        if ((rc = take_failed(redo, fail, r1, boost, B, st))) return rc;
        if ((rc = copy_shift<T>(Pk, pstride, ws, panel, count, s, delta, nullptr, r1, B, st))) return rc;
        if ((rc = factor_panels<T>(Pk, pstride, s, k < K - 1 ? 2 * s : s, s, tiny, r1, fail, B, st))) return rc;
        if ((rc = any_failed(fail, B, st, &any))) return rc;
        if (any) {
          // the last attempt is PD by Gershgorin; it is not checked
          if ((rc = take_failed(r1, fail, r2, nullptr, B, st))) return rc;
          bt_dom_kernel<T><<<B, kThreads, 0, st>>>(ws, panel, s, dom, r2);
          if ((rc = (int)cudaGetLastError())) return rc;
          if ((rc = copy_shift<T>(Pk, pstride, ws, panel, count, s, delta, dom, r2, B, st))) return rc;
          if ((rc = factor_panels<T>(Pk, pstride, s, k < K - 1 ? 2 * s : s, s, tiny, r2, fail, B, st))) return rc;
          if ((rc = (int)cudaMemsetAsync(fail, 0, sizeof(int) * B, st))) return rc;
        }
      }
      if (k < K - 1) {
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
// s, s), the fast pass of `launch_factor` with no boost. A pivot that is not
// finite and positive is left as it comes (NaN for a negative one) and sets
// the chain's flag, whose logdet is then NaN, as an unboosted Cholesky gives.
template <typename T>
int launch_factor_blocks(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, int B, void* stream) {
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long pstride = 2LL * s * s * K;
  const long long want = (pstride + kThreads - 1) / kThreads;
  int rc = (int)cudaMemsetAsync(flags, 0, sizeof(int) * B, st);
  if (rc) return rc;
  bt_blocks_load_kernel<T><<<dim3(want < 1024 ? (int)want : 1024, B), kThreads, 0, st>>>(D, E, P, K, s);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = factor_pass<T>(P, pstride, K, s, T(0), flags, B, st))) return rc;
  bt_logdet_kernel<T><<<B, kThreads, 0, st>>>(P, pstride, K, s, logdet, flags);
  return (int)cudaGetLastError();
}

// One block per (chain, right-hand side) row of b / out (R, n), chain-major:
// v = b permuted and padded (in shared memory, or in row `row` of the
// (R, K s) workspace when one is given), forward (mode 0), backward (mode 1)
// or both (mode 2) block substitution, out = v unpermuted. kBlocks (the
// block entry of K12): b and out are blocks (B, K, s, k), column row % k of
// chain row / k, with no permutation (n = K s, perm unused): the path of
// the block entry while its right-hand sides fit a few waves of blocks.
template <typename T, bool kBlocks>
__global__ void __launch_bounds__(kVecThreads)
    bt_trsv_kernel(const T* P, long long pstride, int K, int s, int n, const int* perm, const T* b, T* out, int k,
                   int mode, T* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v = work ? work + (long long)blockIdx.x * K * s : reinterpret_cast<T*>(smem_raw);  // K s
  __shared__ T red[kVecThreads];
  const long long row = blockIdx.x;
  const T* Pb = P + (row / k) * pstride;
  const long long panel = 2LL * s * s;
  // element j of the row: at base + j * step (blocks) or base + perm[j] (rows)
  const long long base = kBlocks ? (row / k) * (long long)K * s * k + row % k : row * n;
  const long long step = kBlocks ? k : 1;
  for (int j = threadIdx.x; j < K * s; j += blockDim.x)
    v[j] = kBlocks ? b[base + j * step] : (j < n ? b[base + perm[j]] : T(0));
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
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[kBlocks ? base + j * step : base + perm[j]] = v[j];
}

template <typename T, bool kBlocks>
int launch_trsv(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, int R,
                T* work, void* stream) {
  if (R == 0) return 0;
  const size_t smem = work ? 0 : sizeof(T) * (size_t)K * s;
  int rc = set_smem(bt_trsv_kernel<T, kBlocks>, smem);
  if (rc) return rc;
  bt_trsv_kernel<T, kBlocks><<<R, kVecThreads, smem, (cudaStream_t)stream>>>(P, 2LL * s * s * K, K, s, n, perm, b,
                                                                             out, k, mode, work);
  return (int)cudaGetLastError();
}

// The block entry of K12, by column tiles: block (tile, chain) solves columns
// kNB tile .. kNB tile + q of its chain's right-hand sides X (B, K, s, k) in
// place, forward then backward; per block row, the coupling (M_{k-1} y_{k-1},
// or M_k^T x_{k+1}) by block_gemm, then the diagonal block by blk_trsm. A
// tile reads its chain's factor once per direction for up to kNB columns.
template <typename T>
__global__ void __launch_bounds__(kThreads) bt_trsv_tiles_kernel(const T* P, int K, int s, T* X, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // kNB x (kNB + 1)
  __shared__ T As[kGK * kLd], Bs[kGK * kLd];
  const int c0 = blockIdx.x * kNB, q = min(kNB, k - c0);
  const long long panel = 2LL * s * s, ss = (long long)s * s, rows = (long long)s * k;  // rows: one block row of X
  const T* Pb = P + blockIdx.y * panel * K;
  T* Xb = X + blockIdx.y * rows * K + c0;
  for (int blk = 0; blk < K; ++blk) {
    T* V = Xb + blk * rows;
    if (blk) {
      block_gemm(V, k, Pb + (blk - 1) * panel + ss, s, 1, V - rows, k, 1, s, q, s, T(-1), T(1), false, As, Bs);
      __syncthreads();
    }
    blk_trsm(Pb + blk * panel, s, s, V, k, q, false, S, As, Bs);
  }
  for (int blk = K - 1; blk >= 0; --blk) {
    T* V = Xb + blk * rows;
    if (blk < K - 1) {
      block_gemm(V, k, Pb + blk * panel + ss, 1, s, V + rows, k, 1, s, q, s, T(-1), T(1), false, As, Bs);
      __syncthreads();
    }
    blk_trsm(Pb + blk * panel, s, s, V, k, q, true, S, As, Bs);
  }
}

// The block entry of K12 by column tiles (`tiles`), or one block per right-hand
// side (work: a (B k, K s) workspace when K s values do not fit shared memory).
template <typename T>
int launch_trsv_blocks(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work, int tiles,
                       void* stream) {
  if (!tiles) return launch_trsv<T, true>(P, K, s, K * s, nullptr, b, out, k, 2, B * k, work, stream);
  if (B == 0 || k == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaMemcpyAsync(out, b, sizeof(T) * (size_t)B * K * s * k, cudaMemcpyDeviceToDevice, st);
  if (rc) return rc;
  const size_t smem = sizeof(T) * (size_t)kNB * (kNB + 1);
  if ((rc = set_smem(bt_trsv_tiles_kernel<T>, smem))) return rc;
  bt_trsv_tiles_kernel<T><<<dim3(cdiv(k, kNB), B), kThreads, smem, st>>>(P, K, s, out, k);
  return (int)cudaGetLastError();
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
                         int* flags, int B, void* stream) {                                                   \
    return launch_factor<T>(data, ds, src, dst, ntab, tperm, P, K, s, ws, dom, boost, logdet, flags, B,       \
                            stream);                                                                          \
  }                                                                                                           \
  int tg_bt_trsv_##SUF(const T* P, int K, int s, int n, const int* perm, const T* b, T* out, int k, int mode, \
                       int R, T* work, void* stream) {                                                        \
    return launch_trsv<T, false>(P, K, s, n, perm, b, out, k, mode, R, work, stream);                         \
  }                                                                                                           \
  int tg_bt_factor_blocks_##SUF(const T* D, const T* E, T* P, int K, int s, T* logdet, int* flags, int B,      \
                                void* stream) {                                                               \
    return launch_factor_blocks<T>(D, E, P, K, s, logdet, flags, B, stream);                                  \
  }                                                                                                           \
  int tg_bt_trsv_blocks_##SUF(const T* P, int K, int s, const T* b, T* out, int k, int B, T* work, int tiles, \
                              void* stream) {                                                                 \
    return launch_trsv_blocks<T>(P, K, s, b, out, k, B, work, tiles, stream);                                 \
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
