// K6 sn_panel, K7 sn_trsv and K8 sn_takahashi: one size-class batch of one
// level of the supernodal Cholesky schedule, per chain.
//
// Replaces (JAX reference, tpu_gmrf/solvers/supernodal.py):
//   K6: :907 `_panel_math` with :775 `_chol_boosted`, :899 `_set_unique` and
//       :987 `_plain_step` (gather panel, boosted diagonal Cholesky,
//       Lb = Bm Ld^-T, U = Lb Lb^T, unique write-back), plus the pivots that
//       :1339 `logdet` gathers;
//   K7: :1171 `_forward` / :1214 `_backward` (`fwd_step`, `bwd_step`), and,
//       as mode 2, :1296 `sqrt_step` of `sqrt_matvec` (out[cols] += Ld z[cols],
//       Lb z[cols] into the level's update buffer);
//   K8: :1000 `_sig_step` (block Takahashi: Sigma_RJ = -Sigma_RR C,
//       Sigma_JJ = Ld^-T Ld^-1 + C^T Sigma_RR C with C = Lb Ld^-1).
//
// Layout. `vals` / `sig` hold, per chain, the flat CSC values of L / Sigma on
// the amalgamated fill pattern plus one DUMMY slot (index nnzL). A class
// batch is P supernodes with padded width W and padded row count M:
// panel_idx (P, W+M, W), cols_idx (P, W), rows_idx (P, M), schur_idx
// (P, M, M), padded with DUMMY / NDUMMY. Live columns and rows are a prefix:
// ns = #live columns, m = #live rows.
//
// Padding and the DUMMY race. The reference lets padded slots write DUMMY
// and resets it after every scatter; inside one launch that would race with
// another block's gather. These kernels never write a padded position and
// never read one: a DUMMY / NDUMMY index is a zero, and every loop runs over
// the live prefix (ns, m) only. Padded columns of the reference factor as
// identity and padded rows as zeros, so skipping them changes nothing.
//
// What bounds them on the card. Per block (one chain, one supernode) the
// work is O((ns+m) ns^2) for K6, O((ns+m) ns) for K7 and O(m^2 ns + ns^3)
// for K8, over a gathered panel. Scan-level classes (ns <= 128, m <= 512)
// are many small blocks: bound by the random gathers and by the per-column
// __syncthreads of the column loop. The top separators (up to W = 1024,
// M = 1024) are one block each: bound by that block's FMA rate against L2.
// Design: one block per (supernode, chain). K6 is a right-looking column
// Cholesky over the whole (ns+m) x ns panel, so Lb comes out of the same
// loop; a panel that fits lives in dynamic shared memory, a larger one (the
// top separators) in a global workspace slice of the block, factored by
// column tiles held in shared memory with the rank-tile update of the
// trailing columns and of U fused (`factor_tiled`). K8 keeps its operands
// in shared memory or in a workspace slice the same way and does its
// products with the shared-memory tiled block GEMM `block_gemm` of
// dense_blocks.cuh (the tile K9-K12's trailing updates use). The pivot
// boost of the reference is decided per block, exactly as the reference
// decides it per batch element. No tensor cores: wgmma tiling and a
// multi-block path for the few top separators are later work.

#include "dense_blocks.cuh"

namespace {

using namespace tgdense;  // kThreads, Eps, set_smem, the tiled block product block_gemm

// Live width ns (diagonal of the D block present) and live row count m
// (column 0 of the Bm block present) of one panel.
__device__ void live_dims(const int* pidx, int W, int M, int dummy, int* s_ns, int* s_m) {
  if (threadIdx.x == 0) {
    int ns = 0;
    while (ns < W && pidx[(long long)ns * W + ns] != dummy) ++ns;
    int m = 0;
    if (ns > 0)
      while (m < M && pidx[(long long)(W + m) * W] != dummy) ++m;
    *s_ns = ns;
    *s_m = m;
  }
  __syncthreads();
}

// ---- K6 -------------------------------------------------------------------

constexpr int kTile = 32;  // widest column tile of the large-panel path

// Large-panel path of K6: right-looking Cholesky of the H x ns panel F (global
// workspace) by column tiles of width `tile` held in shared memory (S, H x
// tile): factor the tile's columns inside shared memory, write them back,
// then apply the rank-`tile` update to the trailing columns of F and, fused,
// to U = Lb Lb^T (lower, row stride M), each read-modify-written once per
// tile. Lanes run along columns, so the global updates are coalesced and the
// tile rows are shared-memory broadcasts. Returns with *s_fail set on a
// pivot breakdown (at once when `stop`).
template <typename T>
__device__ void factor_tiled(T* F, int ns, int H, T* ub, int M, T* S, int tile, T tiny, bool stop,
                             int* s_fail, T* s_piv) {
  const int m = H - ns;
  for (long long e = threadIdx.x; e < (long long)m * m; e += blockDim.x) {
    const int i = (int)(e / m), j = (int)(e % m);
    if (j <= i) ub[(long long)i * M + j] = T(0);
  }
  for (int k0 = 0; k0 < ns; k0 += tile) {
    const int t = min(tile, ns - k0), R = H - k0, ld = t + 1;  // odd stride: no bank conflicts
    for (long long e = threadIdx.x; e < (long long)R * t; e += blockDim.x)
      S[(e / t) * ld + e % t] = F[(long long)(k0 + e / t) * ns + k0 + e % t];
    __syncthreads();
    for (int j = 0; j < t; ++j) {
      if (threadIdx.x == 0) {
        const T l = sqrt(S[j * ld + j]);
        if (!(isfinite(l) && l > tiny)) *s_fail = 1;
        S[j * ld + j] = l;
        *s_piv = l;
      }
      __syncthreads();
      if (*s_fail && stop) return;
      const T inv = T(1) / *s_piv;
      for (int i = j + 1 + threadIdx.x; i < R; i += blockDim.x) S[(long long)i * ld + j] *= inv;
      __syncthreads();
      for (int i = j + 1 + threadIdx.x; i < R; i += blockDim.x) {
        T* Si = S + (long long)i * ld;
        const T lij = Si[j];
        const int qend = i < t ? i : t - 1;
        for (int q = j + 1; q <= qend; ++q) Si[q] -= lij * S[(long long)q * ld + j];
      }
      __syncthreads();
    }
    for (long long e = threadIdx.x; e < (long long)R * t; e += blockDim.x)
      F[(long long)(k0 + e / t) * ns + k0 + e % t] = S[(e / t) * ld + e % t];
    const int nrem = ns - k0 - t, ncols = nrem + m;
    for (int c0 = 0; c0 < ncols; c0 += blockDim.x) {
      const int cc = c0 + threadIdx.x;
      const bool active = cc < ncols;
      const int ic = !active ? R : (cc < nrem ? t + cc : ns - k0 + (cc - nrem));  // tile row of the column
      T sc[kTile];
#pragma unroll
      for (int q = 0; q < kTile; ++q) sc[q] = (active && q < t) ? S[(long long)ic * ld + q] : T(0);
      for (int i = t; i < R; ++i) {
        if (i < ic) continue;  // lower triangle only
        const T* Si = S + (long long)i * ld;
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < kTile; ++q)
          if (q < t) acc += Si[q] * sc[q];
        if (cc < nrem)
          F[(long long)(k0 + i) * ns + k0 + t + cc] -= acc;
        else
          ub[(long long)(i - (ns - k0)) * M + (cc - nrem)] += acc;
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_panel_kernel(T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx,
                    const int* __restrict__ cols_idx, int W, int M, int dummy, T* __restrict__ u,
                    long long us, long long ubase, T* __restrict__ logpiv, int n,
                    int* __restrict__ boost, T* __restrict__ work, int tile, T delta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m, s_fail;
  __shared__ T s_piv;
  __shared__ T s_red[kThreads];
  __shared__ T As[kGK * kLd], Bs[kGK * kLd];
  const int p = blockIdx.x;
  const long long b = blockIdx.y;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  const int* cidx = cols_idx + (long long)p * W;
  T* vb = vals + b * vs;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m, H = ns + m;
  if (ns == 0) return;
  // H x ns, row-major, row stride ld: in shared memory (odd stride, free of
  // bank conflicts), or (large panels, tile > 0) in the block's workspace
  // slice with a column tile in shared memory
  T* F = tile ? work + ((long long)b * gridDim.x + p) * (long long)(W + M) * W
              : reinterpret_cast<T*>(smem_raw);
  const int ld = tile ? ns : ns + 1;
  T* ub = m ? u + b * us + ubase + (long long)p * M * M : nullptr;
  const T tiny = T(30) * Eps<T>::v;
  auto prow = [&](int r) { return r < ns ? r : W + (r - ns); };

  for (int attempt = 0; attempt < 3; ++attempt) {
    for (long long e = threadIdx.x; e < (long long)H * ns; e += blockDim.x) {
      const int r = (int)(e / ns), c = (int)(e % ns);
      const int idx = (r < ns && c > r) ? dummy : pidx[(long long)prow(r) * W + c];
      F[(long long)r * ld + c] = idx != dummy ? vb[idx] : T(0);
    }
    if (threadIdx.x == 0) s_fail = 0;
    __syncthreads();
    if (attempt > 0) {
      T shift = delta;
      if (attempt == 2) {
        // Gershgorin bound of the mirrored block, padded diagonal ones included
        T dom = ns < W ? T(1) : T(0);
        for (int i = threadIdx.x; i < ns; i += blockDim.x) {
          T s = T(0);
          for (int j = 0; j <= i; ++j) s += fabs(F[(long long)i * ld + j]);
          for (int j = i + 1; j < ns; ++j) s += fabs(F[(long long)j * ld + i]);
          dom = s > dom ? s : dom;
        }
        s_red[threadIdx.x] = dom;
        __syncthreads();
        for (int off = blockDim.x / 2; off > 0; off >>= 1) {
          if (threadIdx.x < off && s_red[threadIdx.x + off] > s_red[threadIdx.x])
            s_red[threadIdx.x] = s_red[threadIdx.x + off];
          __syncthreads();
        }
        shift = s_red[0] + delta;
        __syncthreads();
      }
      for (int i = threadIdx.x; i < ns; i += blockDim.x) F[(long long)i * ld + i] += shift;
      __syncthreads();
    }
    if (tile) {
      factor_tiled(F, ns, H, ub, M, reinterpret_cast<T*>(smem_raw), tile, tiny, attempt < 2, &s_fail,
                   &s_piv);
      __syncthreads();
    }
    for (int j = 0; j < ns && !tile; ++j) {
      if (threadIdx.x == 0) {
        const T l = sqrt(F[(long long)j * ld + j]);
        if (!(isfinite(l) && l > tiny)) s_fail = 1;
        F[(long long)j * ld + j] = l;
        s_piv = l;
      }
      __syncthreads();
      if (s_fail && attempt < 2) break;
      const T inv = T(1) / s_piv;
      for (int r = j + 1 + threadIdx.x; r < H; r += blockDim.x) F[(long long)r * ld + j] *= inv;
      __syncthreads();
      for (int r = j + 1 + threadIdx.x; r < H; r += blockDim.x) {
        T* Fr = F + (long long)r * ld;
        const T lrj = Fr[j];
        const int cend = r < ns ? r : ns - 1;
        for (int c = j + 1; c <= cend; ++c) Fr[c] -= lrj * F[(long long)c * ld + j];
      }
      __syncthreads();
    }
    const int failed = s_fail;
    __syncthreads();
    if (attempt == 0 && failed && threadIdx.x == 0) atomicAdd(boost + b, 1);
    if (!failed) break;
  }

  // write-back of the live positions, log pivots
  for (long long e = threadIdx.x; e < (long long)H * ns; e += blockDim.x) {
    const int r = (int)(e / ns), c = (int)(e % ns);
    if (r < ns && c > r) continue;
    vb[pidx[(long long)prow(r) * W + c]] = F[(long long)r * ld + c];
  }
  for (int c = threadIdx.x; c < ns; c += blockDim.x)
    logpiv[b * n + cidx[c]] = log(F[(long long)c * ld + c]);
  // U = Lb Lb^T, lower triangle, into this supernode's slot of the level's
  // buffer (the large-panel path has accumulated it already)
  if (m == 0 || tile) return;
  const T* Lb = F + (long long)ns * ld;
  block_gemm(ub, M, Lb, ld, 1, Lb, 1, ld, m, m, ns, T(1), T(0), true, As, Bs);
}

// ---- K7 -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_trsv_kernel(const T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx,
                   const int* __restrict__ cols_idx, const int* __restrict__ rows_idx, int W, int M,
                   int ndummy, T* __restrict__ x, long long xs, int k, T* __restrict__ u, long long us,
                   long long ubase, int mode, const T* __restrict__ z) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  __shared__ T s_y;
  T* yc = reinterpret_cast<T*>(smem_raw);  // W
  T* xr = yc + W;                          // M
  const int p = blockIdx.x;
  const long long bx = blockIdx.y;  // right-hand side row
  const long long bv = bx / k;      // chain of the factor
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  const int* cidx = cols_idx + (long long)p * W;
  const int* ridx = rows_idx + (long long)p * M;
  const T* vb = vals + bv * vs;
  T* xb = x + bx * xs;
  if (threadIdx.x == 0) {
    int ns = 0, m = 0;
    while (ns < W && cidx[ns] != ndummy) ++ns;
    while (m < M && ridx[m] != ndummy) ++m;
    s_ns = ns;
    s_m = m;
  }
  __syncthreads();
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;
  auto L = [&](int r, int c) { return vb[pidx[(long long)r * W + c]]; };
  if (mode == 2) {
    // the product, not a solve: x[cols] += Ld z[cols] (lower triangle, live
    // columns only: a padded column of the reference multiplies a zero),
    // u = Lb z[cols]; a column of x has one owner, so the sum needs no atomics
    const T* zb = z + bx * xs;
    for (int c = threadIdx.x; c < ns; c += blockDim.x) yc[c] = zb[cidx[c]];
    __syncthreads();
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      T s = T(0);
      for (int j = 0; j <= i; ++j) s += L(i, j) * yc[j];
      xb[cidx[i]] += s;
    }
    T* ub = u + bx * us + ubase + (long long)p * M;
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      T s = T(0);
      for (int c = 0; c < ns; ++c) s += L(W + r, c) * yc[c];
      ub[r] = s;
    }
    return;
  }
  for (int c = threadIdx.x; c < ns; c += blockDim.x) yc[c] = xb[cidx[c]];
  if (mode == 0) {
    __syncthreads();
    for (int j = 0; j < ns; ++j) {
      if (threadIdx.x == 0) {
        s_y = yc[j] / L(j, j);
        yc[j] = s_y;
      }
      __syncthreads();
      const T yj = s_y;
      for (int i = j + 1 + threadIdx.x; i < ns; i += blockDim.x) yc[i] -= L(i, j) * yj;
      __syncthreads();
    }
    for (int c = threadIdx.x; c < ns; c += blockDim.x) xb[cidx[c]] = yc[c];
    T* ub = u + bx * us + ubase + (long long)p * M;
    for (int r = threadIdx.x; r < m; r += blockDim.x) {
      T s = T(0);
      for (int c = 0; c < ns; ++c) s += L(W + r, c) * yc[c];
      ub[r] = s;
    }
  } else {
    for (int r = threadIdx.x; r < m; r += blockDim.x) xr[r] = xb[ridx[r]];
    __syncthreads();
    for (int c = threadIdx.x; c < ns; c += blockDim.x) {
      T s = yc[c];
      for (int r = 0; r < m; ++r) s -= L(W + r, c) * xr[r];
      yc[c] = s;
    }
    __syncthreads();
    for (int j = ns - 1; j >= 0; --j) {
      if (threadIdx.x == 0) {
        s_y = yc[j] / L(j, j);
        yc[j] = s_y;
      }
      __syncthreads();
      const T yj = s_y;
      for (int i = threadIdx.x; i < j; i += blockDim.x) yc[i] -= L(j, i) * yj;
      __syncthreads();
    }
    for (int c = threadIdx.x; c < ns; c += blockDim.x) xb[cidx[c]] = yc[c];
  }
}

// ---- K8 -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sn_takahashi_kernel(const T* __restrict__ vals, long long vs, T* __restrict__ sig, long long ss,
                        const int* __restrict__ panel_idx, const int* __restrict__ schur_idx, int W,
                        int M, int dummy, T* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  __shared__ T As[kGK * kLd], Bs[kGK * kLd];
  const int p = blockIdx.x;
  const long long b = blockIdx.y;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  const int* sidx = schur_idx + (long long)p * M * M;
  const T* vb = vals + b * vs;
  T* sb = sig + b * ss;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;
  const long long per_block = 2LL * W * W + 2LL * M * W + (long long)M * M;
  T* L = work ? work + ((long long)b * gridDim.x + p) * per_block : reinterpret_cast<T*>(smem_raw);
  T* Li = L + (long long)ns * ns;   // ns x ns, Ld^-1 (lower, zeros above)
  T* C = Li + (long long)ns * ns;   // m x ns, C = Lb Ld^-1
  T* R = C + (long long)m * ns;     // m x ns, Lb, then Sigma_RJ
  T* S = R + (long long)m * ns;     // m x m, Sigma_RR (mirrored)

  for (long long e = threadIdx.x; e < (long long)ns * ns; e += blockDim.x) {
    const int r = (int)(e / ns), c = (int)(e % ns);
    L[e] = c <= r ? vb[pidx[(long long)r * W + c]] : T(0);
    Li[e] = r == c ? T(1) : T(0);
  }
  for (long long e = threadIdx.x; e < (long long)m * ns; e += blockDim.x) {
    const int r = (int)(e / ns), c = (int)(e % ns);
    R[e] = vb[pidx[(long long)(W + r) * W + c]];
  }
  for (long long e = threadIdx.x; e < (long long)m * m; e += blockDim.x) {
    const int r = (int)(e / m), c = (int)(e % m);
    const int idx = r >= c ? sidx[(long long)r * M + c] : sidx[(long long)c * M + r];
    S[e] = idx != dummy ? sb[idx] : T(0);
  }
  __syncthreads();
  // Li = Ld^-1, blocked forward substitution on the identity: for each block
  // of rows, subtract Ld[k, :k0] Li[:k0, :] (block GEMM; Li[:k0, c] is zero
  // for c >= k0), then substitute within the diagonal block
  for (int k0 = 0; k0 < ns; k0 += kGB) {  // row blocks as tall as block_gemm's output tile
    const int t = min(kGB, ns - k0);
    if (k0) {
      block_gemm(Li + (long long)k0 * ns, ns, L + (long long)k0 * ns, ns, 1, Li, ns, 1, t, k0, k0, T(-1),
                 T(1), false, As, Bs);
      __syncthreads();
    }
    for (int j = k0; j < k0 + t; ++j) {
      const T inv = T(1) / L[(long long)j * ns + j];
      for (int c = threadIdx.x; c <= j; c += blockDim.x) Li[(long long)j * ns + c] *= inv;
      __syncthreads();
      const long long pairs = (long long)(k0 + t - j - 1) * (j + 1);
      for (long long e = threadIdx.x; e < pairs; e += blockDim.x) {
        const int i = j + 1 + (int)(e / (j + 1)), c = (int)(e % (j + 1));
        Li[(long long)i * ns + c] -= L[(long long)i * ns + j] * Li[(long long)j * ns + c];
      }
      __syncthreads();
    }
  }
  if (m) {
    // C = Lb Ld^-1, then Sigma_RJ = -Sigma_RR C (written out as it stands)
    block_gemm(C, ns, R, ns, 1, Li, ns, 1, m, ns, ns, T(1), T(0), false, As, Bs);
    __syncthreads();
    block_gemm(R, ns, S, m, 1, C, ns, 1, m, ns, m, T(-1), T(0), false, As, Bs);
    __syncthreads();
    for (long long e = threadIdx.x; e < (long long)m * ns; e += blockDim.x) {
      const int r = (int)(e / ns), c = (int)(e % ns);
      sb[pidx[(long long)(W + r) * W + c]] = R[e];
    }
  }
  // Sigma_JJ = Li^T Li - C^T Sigma_RJ, lower triangle, into L's buffer
  block_gemm(L, ns, Li, 1, ns, Li, ns, 1, ns, ns, ns, T(1), T(0), true, As, Bs);
  __syncthreads();
  if (m) {
    block_gemm(L, ns, C, 1, ns, R, ns, 1, ns, ns, m, T(-1), T(1), true, As, Bs);
    __syncthreads();
  }
  for (long long e = threadIdx.x; e < (long long)ns * ns; e += blockDim.x) {
    const int i = (int)(e / ns), j = (int)(e % ns);
    if (j <= i) sb[pidx[(long long)i * W + j]] = L[e];
  }
}

template <typename T>
int launch_panel(T* vals, long long vs, const int* panel_idx, const int* cols_idx, int P, int W,
                 int M, int dummy, int /*ndummy*/, T* u, long long us, long long ubase, T* logpiv,
                 int n, int* boost, T* work, int tile, double delta, int B, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (tile < 0 || tile > kTile || (tile > 0) != (work != nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (size_t)(W + M) * ((tile ? tile : W) + 1);
  int rc = set_smem(sn_panel_kernel<T>, smem);
  if (rc) return rc;
  sn_panel_kernel<T><<<dim3(P, B), kThreads, smem, (cudaStream_t)stream>>>(
      vals, vs, panel_idx, cols_idx, W, M, dummy, u, us, ubase, logpiv, n, boost, work, tile,
      (T)delta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_trsv(const T* vals, long long vs, const int* panel_idx, const int* cols_idx,
                const int* rows_idx, int P, int W, int M, int ndummy, T* x, long long xs, int k, T* u,
                long long us, long long ubase, int mode, int B, const T* z, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (mode == 2 && z == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * (size_t)(W + M);
  int rc = set_smem(sn_trsv_kernel<T>, smem);
  if (rc) return rc;
  sn_trsv_kernel<T><<<dim3(P, B), kThreads, smem, (cudaStream_t)stream>>>(
      vals, vs, panel_idx, cols_idx, rows_idx, W, M, ndummy, x, xs, k, u, us, ubase, mode, z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_takahashi(const T* vals, long long vs, T* sig, long long ss, const int* panel_idx,
                     const int* schur_idx, int P, int W, int M, int dummy, T* work, int B,
                     void* stream) {
  if (P == 0 || B == 0) return 0;
  const size_t smem =
      work ? 0 : sizeof(T) * (size_t)(2LL * W * W + 2LL * M * W + (long long)M * M);
  int rc = set_smem(sn_takahashi_kernel<T>, smem);
  if (rc) return rc;
  sn_takahashi_kernel<T><<<dim3(P, B), kThreads, smem, (cudaStream_t)stream>>>(
      vals, vs, sig, ss, panel_idx, schur_idx, W, M, dummy, work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_SN_ENTRY(SUF, T)                                                                        \
  int tg_sn_panel_##SUF(T* vals, long long vs, const int* panel_idx, const int* cols_idx, int P,   \
                        int W, int M, int dummy, int ndummy, T* u, long long us, long long ubase,  \
                        T* logpiv, int n, int* boost, T* work, int tile, double delta, int B,     \
                        void* stream) {                                                            \
    return launch_panel<T>(vals, vs, panel_idx, cols_idx, P, W, M, dummy, ndummy, u, us, ubase,    \
                           logpiv, n, boost, work, tile, delta, B, stream);                        \
  }                                                                                                \
  int tg_sn_trsv_##SUF(const T* vals, long long vs, const int* panel_idx, const int* cols_idx,     \
                       const int* rows_idx, int P, int W, int M, int ndummy, T* x, long long xs,   \
                       int k, T* u, long long us, long long ubase, int mode, int B, const T* z,    \
                       void* stream) {                                                             \
    return launch_trsv<T>(vals, vs, panel_idx, cols_idx, rows_idx, P, W, M, ndummy, x, xs, k, u,   \
                          us, ubase, mode, B, z, stream);                                          \
  }                                                                                                \
  int tg_sn_takahashi_##SUF(const T* vals, long long vs, T* sig, long long ss,                     \
                            const int* panel_idx, const int* schur_idx, int P, int W, int M,       \
                            int dummy, T* work, int B, void* stream) {                             \
    return launch_takahashi<T>(vals, vs, sig, ss, panel_idx, schur_idx, P, W, M, dummy, work, B,   \
                               stream);                                                            \
  }

TG_SN_ENTRY(f32, float)
TG_SN_ENTRY(f64, double)

#undef TG_SN_ENTRY

}  // extern "C"
