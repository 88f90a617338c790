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
#include "tiles.cuh"

namespace {

using namespace tgdense;  // kThreads, Eps, set_smem, the tiled block product block_gemm

// Live width ns (diagonal of the D block present) and live row count m
// (column 0 of the Bm block present) of one panel. Live columns and rows are
// a prefix, so each is a count, taken by all threads at once (a scan by one
// thread would chain up to W + M dependent loads).
__device__ void live_dims(const int* pidx, int W, int M, int dummy, int* s_ns, int* s_m) {
  if (threadIdx.x == 0) *s_ns = *s_m = 0;
  __syncthreads();
  int ns = 0, m = 0;
  for (int i = threadIdx.x; i < W; i += blockDim.x) ns += pidx[(long long)i * W + i] != dummy;
  for (int i = threadIdx.x; i < M; i += blockDim.x) m += pidx[(long long)(W + i) * W] != dummy;
  if (ns) atomicAdd(s_ns, ns);
  if (m) atomicAdd(s_m, m);
  __syncthreads();
  if (*s_ns == 0 && threadIdx.x == 0) *s_m = 0;  // an all-padding panel
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
//
// The step Sigma_RJ = -Sigma_RR C, Sigma_JJ = A - C^T Sigma_RJ with C = Lb Ld^-1
// and A = Ld^-T Ld^-1 is split in two entries. `sn_takahashi_prep` forms C (in
// Lb's positions) and A (lower, in Ld's positions) of every supernode into a
// buffer laid out like vals, one more (B, nnzL+1) buffer per sweep: none of it
// depends on Sigma, so one launch covers every supernode of a size class on
// every level. `sn_takahashi` then does only the Sigma-dependent products, level
// by level. All products run in float64 on the tensor cores (tgtile's
// mma_slice, m16n8k4) from operands gathered through the panel and Schur index
// tables as they are staged into shared memory, so a float32 factor is inverted
// and multiplied in float64 and rounded once on the way out.

namespace k8 {

using tgtile::Acc;
using tgtile::Cfg;
using tgtile::kKS;
using tgtile::kLdS;
using tgtile::kT;
using tgtile::kThr;
using tgtile::kTT;

// float64 values of the two staged operand slices of a 64 x NT product
template <int NT>
constexpr int stage_values() {
  return 2 * kKS * (Cfg<NT>::LDA + Cfg<NT>::LDB);
}

// acc (64 x NT, float64) += sum_{p < Kd} a(i, p) b(p, j) over i < Mr, j < Nc
// (zeros outside), on the float64 tensor cores. The operands are functors
// returning float64 (a gather through an index table, a transposed read, a
// tile in shared memory), staged 32 deep into shared memory, the next slice
// loaded into registers while the current one is multiplied. a_by_rows(k0)
// says for the slice at depth k0 whether neighbouring threads load
// neighbouring rows i of A (true) or neighbouring depths p (false): whichever
// keeps the reads of that slice contiguous. Every thread of the block calls
// it; it ends with a block barrier.
template <int NT, typename FA, typename FB, typename AR>
__device__ void gather_mma(Acc<double, NT>& acc, FA a, FB b, int Mr, int Nc, int Kd, AR a_by_rows, double* sm) {
  using C = Cfg<NT>;
  double* As = sm;                     // [2][kKS][LDA]
  double* Bs = sm + 2 * kKS * C::LDA;  // [2][kKS][LDB]
  const int tid = threadIdx.x;
  double ra[C::AV], rb[C::BV];
  bool rows = true;
  // the u-th A value of a thread: (tid % 64, tid / 64 + 4u) by rows, (tid / 32 + 8u, tid % 32) by depths
  auto ai = [&](int u) { return rows ? tid % kT : tid / kKS + u * (kThr / kKS); };
  auto ap = [&](int u) { return rows ? tid / kT + u * (kThr / kT) : tid % kKS; };
  auto load = [&](int k0) {
    rows = a_by_rows(k0);
#pragma unroll
    for (int u = 0; u < C::AV; ++u) {
      const int i = ai(u), p = k0 + ap(u);
      ra[u] = (i < Mr && p < Kd) ? a(i, p) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < C::BV; ++u) {
      const int j = tid % NT, p = k0 + tid / NT + u * (kThr / NT);
      rb[u] = (j < Nc && p < Kd) ? b(p, j) : 0.0;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < C::AV; ++u) As[(buf * kKS + ap(u)) * C::LDA + ai(u)] = ra[u];
#pragma unroll
    for (int u = 0; u < C::BV; ++u) Bs[(buf * kKS + tid / NT + u * (kThr / NT)) * C::LDB + tid % NT] = rb[u];
  };
  const int slices = (Kd + kKS - 1) / kKS;
  if (slices == 0) return;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load((s + 1) * kKS);
    tgtile::mma_slice<double, NT>(acc, As + (s & 1) * kKS * C::LDA, Bs + (s & 1) * kKS * C::LDB);
    if (s + 1 < slices) store((s + 1) & 1);
    __syncthreads();
  }
}

// f(r, c, v) for every accumulator v (a reference) of the 64 x NT tile, at
// its row r and column c (the layout of tgtile::tile_io).
template <int NT, typename F>
__device__ __forceinline__ void acc_each(Acc<double, NT>& acc, F f) {
  using C = Cfg<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = wm * (kT / C::WM) + (lane >> 2), c0 = wn * (NT / C::WN) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NTT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(r0 + 8 * i, c0 + 8 * j + e, acc.v[i][j][e]);
}

// Whether a panel's column runs down consecutive positions (CSC, the
// supernodal factor) rather than along a row (the banded factor's row-major
// blocks): it decides how the gathers of L, C and Sigma_RJ are spread over
// the threads.
__device__ __forceinline__ bool rows_contiguous(const int* pidx, int W, int ns) {
  return ns > 1 && pidx[W] == pidx[0] + 1;
}

// K8's first entry, a panel of width W <= 64: block (t, p, b) inverts Ld in
// shared memory (tgtile::invert_blocked, blocks of 16) and forms A (t = 0) or
// the 64-row tile t - 1 of C, with X = Ld^-1 read from shared memory.
template <typename T, int NT>
__global__ void __launch_bounds__(kThr)
    sn_prep_tile_kernel(const T* __restrict__ vals, long long vs, T* __restrict__ pre, long long ps,
                        const int* __restrict__ panel_idx, int W, int M, int dummy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* X = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS: Ld^-1
  double* rinv = X + kT * kLdS;                     // 64
  double* st = rinv + kT;                           // Ld while it is inverted, then the products' staging
  const int t = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0 || (t > 0 && (t - 1) * kT >= m)) return;
  const T* vb = vals + b * vs;
  T* pb = pre + b * ps;
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // Ld in float64, the identity beyond ns
    const int r = e / kT, c = e % kT;
    st[r * kLdS + c] = (r < ns && c <= r) ? double(vb[pidx[r * W + c]]) : (r == c ? 1.0 : 0.0);
  }
  __syncthreads();
  if (threadIdx.x < kT) rinv[threadIdx.x] = 1.0 / st[threadIdx.x * (kLdS + 1)];
  __syncthreads();
  tgtile::invert_blocked(st, rinv, X);
  auto x_at = [&](int r, int c) { return c <= r ? X[r * kLdS + c] : 0.0; };
  Acc<double, NT> acc;
  acc.zero();
  if (t == 0) {  // A = X^T X, lower
    gather_mma<NT>(
        acc, [&](int i, int q) { return x_at(q, i); }, [&](int q, int j) { return x_at(q, j); }, ns, ns, ns,
        [](int) { return true; }, st);
    acc_each<NT>(acc, [&](int r, int c, double& v) {
      if (r < ns && c <= r) pb[pidx[r * W + c]] = T(v);
    });
    return;
  }
  const int r0 = (t - 1) * kT;  // C = Lb X, rows r0 .. r0 + 63
  const bool by_rows = rows_contiguous(pidx, W, ns);
  gather_mma<NT>(
      acc, [&](int i, int q) { return double(vb[pidx[(W + r0 + i) * W + q]]); },
      [&](int q, int j) { return x_at(q, j); }, min(kT, m - r0), ns, ns, [&](int) { return by_rows; }, st);
  acc_each<NT>(acc, [&](int r, int c, double& v) {
    if (r0 + r < m && c < ns) pb[pidx[(W + r0 + r) * W + c]] = T(v);
  });
}

// K8's first entry, a panel of width W > 64: three launches over a float64
// workspace slice per (supernode, chain), X = Ld^-1 (W x W, row stride W),
// then Ld's inverted diagonal tiles (ntiles(W) x 64 x 64). Nothing in them
// waits on another block, so every launch spreads over the whole card.
//   1. sn_prep_dinv_kernel, block (j, p, b): diagonal tile j of Ld, inverted
//      in shared memory by blocks of 16 (tgtile::invert_blocked);
//   2. sn_prep_inverse_kernel, block (J, p, b): column tile J of X by forward
//      substitution down the tile rows, X_JJ = D_J^-1 and, for i > J,
//      X_iJ = -D_i^-1 sum_{J <= k < i} L_ik X_kJ;
//   3. sn_prep_product_kernel, block (t, p, b): one 64 x 64 tile of C = Lb X
//      or of A = X^T X (lower), X's zeros above the diagonal skipped in the
//      depth.
__device__ __forceinline__ long long prep_slice(int W) {
  return (long long)W * W + (long long)tgtile::ntiles(W) * kTT;
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_dinv_kernel(const T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx, int W, int M,
                        int dummy, double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* S = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS
  double* X = S + kT * kLdS;                        // 64 x kLdS
  double* rinv = X + kT * kLdS;                     // 64
  const int j = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, j0 = j * kT, t = min(kT, ns - j0);
  if (t <= 0) return;
  const T* vb = vals + b * vs;
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // the identity beyond t
    const int r = e / kT, c = e % kT;
    S[r * kLdS + c] = (r < t && c <= r) ? double(vb[pidx[(j0 + r) * W + j0 + c]]) : (r == c ? 1.0 : 0.0);
  }
  __syncthreads();
  if (threadIdx.x < kT) rinv[threadIdx.x] = 1.0 / S[threadIdx.x * (kLdS + 1)];
  __syncthreads();
  tgtile::invert_blocked(S, rinv, X);
  double* D = work + (b * gridDim.y + p) * prep_slice(W) + (long long)W * W + (long long)j * kTT;
  tgtile::store_lower(X, t, D);
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_inverse_kernel(const T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx, int W,
                           int M, int dummy, double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* Tt = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS: sum_k L_ik X_kJ
  double* st = Tt + kT * kLdS;                        // the products' staging
  const int J = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, J0 = J * kT, tj = min(kT, ns - J0);
  if (tj <= 0) return;
  const T* vb = vals + b * vs;
  double* X = work + (b * gridDim.y + p) * prep_slice(W);
  const double* Dinv = X + (long long)W * W;
  const bool by_rows = rows_contiguous(pidx, W, ns);
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // X_JJ = D_J^-1
    const int r = e / kT, c = e % kT;
    if (r < tj && c < tj) X[(long long)(J0 + r) * W + J0 + c] = __ldcg(Dinv + (long long)J * kTT + e);
  }
  __syncthreads();
  for (int i = J + 1; i * kT < ns; ++i) {
    const int i0 = i * kT, ti = min(kT, ns - i0);
    Acc<double, 64> acc;
    acc.zero();
    gather_mma<64>(
        acc, [&](int r, int q) { return double(vb[pidx[(i0 + r) * W + J0 + q]]); },
        [&](int q, int c) { return __ldcg(X + (long long)(J0 + q) * W + J0 + c); }, ti, tj, i0 - J0,
        [&](int) { return by_rows; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) { Tt[r * kLdS + c] = v; });
    __syncthreads();
    acc.zero();
    gather_mma<64>(
        acc, [&](int r, int q) { return q <= r ? -__ldcg(Dinv + (long long)i * kTT + r * kT + q) : 0.0; },
        [&](int q, int c) { return Tt[q * kLdS + c]; }, ti, tj, ti, [](int) { return true; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) {
      if (r < ti && c < tj) X[(long long)(i0 + r) * W + J0 + c] = v;
    });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_product_kernel(const T* __restrict__ vals, long long vs, T* __restrict__ pre, long long ps,
                           const int* __restrict__ panel_idx, int W, int M, int dummy,
                           const double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* st = reinterpret_cast<double*>(smem_raw);
  const int p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m, nt = tgtile::ntiles(ns), ct = (m + kT - 1) / kT;
  int t = blockIdx.x;
  if (ns == 0 || t >= ct * nt + nt * (nt + 1) / 2) return;
  const T* vb = vals + b * vs;
  T* pb = pre + b * ps;
  const double* X = work + (b * gridDim.y + p) * prep_slice(W);
  auto xg = [&](int r, int c) { return __ldcg(X + (long long)r * W + c); };
  Acc<double, 64> acc;
  acc.zero();
  if (t < ct * nt) {  // C's tile (I, J): the depth from J's first column
    const int r0 = t / nt * kT, c0 = t % nt * kT;
    const bool by_rows = rows_contiguous(pidx, W, ns);
    gather_mma<64>(
        acc, [&](int i, int q) { return double(vb[pidx[(W + r0 + i) * W + c0 + q]]); },
        [&](int q, int j) { return xg(c0 + q, c0 + j); }, min(kT, m - r0), min(kT, ns - c0), ns - c0,
        [&](int) { return by_rows; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) {
      if (r0 + r < m && c0 + c < ns) pb[pidx[(W + r0 + r) * W + c0 + c]] = T(v);
    });
    return;
  }
  t -= ct * nt;  // A's tile (I, J), J <= I, the depth from I's first row
  int I = 0;
  while (t > I) t -= ++I;
  const int r0 = I * kT, c0 = t * kT;
  gather_mma<64>(
      acc, [&](int i, int q) { return xg(r0 + q, r0 + i); }, [&](int q, int j) { return xg(r0 + q, c0 + j); },
      min(kT, ns - r0), min(kT, ns - c0), ns - r0, [](int) { return true; }, st);
  acc_each<64>(acc, [&](int r, int c, double& v) {
    if (r0 + r < ns && c0 + c <= r0 + r) pb[pidx[(r0 + r) * W + c0 + c]] = T(v);
  });
}

// K8: one class batch of one level. Sigma_RJ = -Sigma_RR C by 64 x NT tiles
// (Sigma_RR gathered through the Schur table, mirrored; C from pre), then
// Sigma_JJ = A - C^T Sigma_RJ by its lower tiles (A and C from pre, Sigma_RJ
// read back from sig). Phase 0: a cluster of cs = gridDim.x blocks per
// (supernode, chain) deals out the tiles of both products, with a cluster
// barrier between them (the many small supernodes of the scan levels).
// Phases 1 and 2: one launch per product, a block per tile, for batches of
// few supernodes whose tiles outnumber a cluster (the top separators, the
// banded steps), so that the tiles spread over the whole card.
template <typename T, int NT>
__global__ void __launch_bounds__(kThr)
    sn_takahashi_kernel(const T* __restrict__ pre, long long ps, T* __restrict__ sig, long long ss,
                        const int* __restrict__ panel_idx, const int* __restrict__ schur_idx, int W, int M,
                        int dummy, int phase) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  const int* sidx = schur_idx + (long long)p * M * M;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;  // the whole cluster
  const T* pb = pre + b * ps;
  T* sb = sig + b * ss;
  const bool by_rows = rows_contiguous(pidx, W, ns);
  auto below = [&](const T* v, int r, int c) { return double(__ldcg(v + pidx[(W + r) * W + c])); };
  const int ncol = (ns + NT - 1) / NT;
  int idx = 0;
  if (m && phase != 2) {
    for (int I = 0; I < (m + kT - 1) / kT; ++I)
      for (int J = 0; J < ncol; ++J, ++idx) {
        if (idx % cs != rank) continue;
        const int r0 = I * kT, c0 = J * NT;
        Acc<double, NT> acc;
        acc.zero();
        gather_mma<NT>(
            acc,
            [&](int i, int q) {
              const int r = r0 + i, id = r >= q ? sidx[r * M + q] : sidx[q * M + r];
              return id != dummy ? -double(__ldcg(sb + id)) : 0.0;
            },
            [&](int q, int j) { return below(pb, q, c0 + j); }, min(kT, m - r0), min(NT, ns - c0), m,
            [&](int k0) { return k0 + kKS > r0; }, sm);  // a slice below the diagonal reads Schur rows
        acc_each<NT>(acc, [&](int r, int c, double& v) {
          if (r0 + r < m && c0 + c < ns) sb[pidx[(W + r0 + r) * W + c0 + c]] = T(v);
        });
      }
    if (phase == 0) tgtile::csync();
  }
  if (phase == 1) return;
  idx = 0;
  for (int I = 0; I < (ns + kT - 1) / kT; ++I)
    for (int J = 0; J < ncol && J * NT < (I + 1) * kT; ++J, ++idx) {
      if (idx % cs != rank) continue;
      const int r0 = I * kT, c0 = J * NT;
      Acc<double, NT> acc;
      acc_each<NT>(acc, [&](int r, int c, double& v) {
        const int rr = r0 + r, cc = c0 + c;
        v = (rr < ns && cc <= rr) ? double(pb[pidx[rr * W + cc]]) : 0.0;
      });
      gather_mma<NT>(
          acc, [&](int i, int q) { return -below(pb, q, r0 + i); }, [&](int q, int j) { return below(sb, q, c0 + j); },
          min(kT, ns - r0), min(NT, ns - c0), m, [&](int) { return !by_rows; }, sm);
      acc_each<NT>(acc, [&](int r, int c, double& v) {
        const int rr = r0 + r, cc = c0 + c;
        if (rr < ns && cc <= rr) sb[pidx[rr * W + cc]] = T(v);
      });
    }
}

}  // namespace k8

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

// Dynamic shared memory of K8's first entry's tile path: X = Ld^-1 beside
// the staged products (Ld while it is inverted).
template <int NT>
constexpr size_t prep_tile_smem() {
  return sizeof(double) * (k8::kT * k8::kLdS + k8::kT +
                           (k8::stage_values<NT>() > k8::kT * k8::kLdS ? k8::stage_values<NT>() : k8::kT * k8::kLdS));
}

template <typename T, int NT>
int launch_prep_tile(const T* vals, long long vs, T* pre, long long ps, const int* panel_idx, int P, int W, int M,
                     int dummy, int B, cudaStream_t st) {
  const size_t smem = prep_tile_smem<NT>();
  int rc = tgtile::smem_attr(k8::sn_prep_tile_kernel<T, NT>, smem);
  if (rc) return rc;
  k8::sn_prep_tile_kernel<T, NT><<<dim3(1 + (M + k8::kT - 1) / k8::kT, P, B), k8::kThr, smem, st>>>(
      vals, vs, pre, ps, panel_idx, W, M, dummy);
  return (int)cudaGetLastError();
}

// K8's first entry: W <= 64 on the tile path (no workspace), else the three
// launches of the wide path on `work` (float64, B P (W^2 + ntiles(W) 64^2)).
template <typename T>
int launch_takahashi_prep(const T* vals, long long vs, T* pre, long long ps, const int* panel_idx, int P, int W,
                          int M, int dummy, double* work, int B, void* stream) {
  if (P == 0 || B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 8) return launch_prep_tile<T, 8>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, B, st);
  if (W <= k8::kT) return launch_prep_tile<T, 64>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, B, st);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  using k8::kLdS;
  using k8::kT;
  const int nt = tgtile::ntiles(W);
  const size_t s1 = sizeof(double) * (2 * kT * kLdS + kT), s2 = sizeof(double) * (kT * kLdS + k8::stage_values<64>()),
               s3 = sizeof(double) * k8::stage_values<64>();
  int rc = tgtile::smem_attr(k8::sn_prep_dinv_kernel<T>, s1);
  if (!rc) rc = tgtile::smem_attr(k8::sn_prep_inverse_kernel<T>, s2);
  if (!rc) rc = tgtile::smem_attr(k8::sn_prep_product_kernel<T>, s3);
  if (rc) return rc;
  k8::sn_prep_dinv_kernel<T><<<dim3(nt, P, B), k8::kThr, s1, st>>>(vals, vs, panel_idx, W, M, dummy, work);
  k8::sn_prep_inverse_kernel<T><<<dim3(nt, P, B), k8::kThr, s2, st>>>(vals, vs, panel_idx, W, M, dummy, work);
  k8::sn_prep_product_kernel<T><<<dim3((M + kT - 1) / kT * nt + nt * (nt + 1) / 2, P, B), k8::kThr, s3, st>>>(
      vals, vs, pre, ps, panel_idx, W, M, dummy, work);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_sweep(const T* pre, long long ps, T* sig, long long ss, const int* panel_idx, const int* schur_idx, int P,
                 int W, int M, int dummy, int cs, int t1, int t2, int B, cudaStream_t st) {
  const size_t smem = sizeof(double) * k8::stage_values<NT>();
  if (cs > 0)  // phase 0: a cluster of cs per supernode and chain
    return tgtile::launch_cluster(k8::sn_takahashi_kernel<T, NT>, dim3(cs, P, B), cs, smem, st, pre, ps, sig, ss,
                                  panel_idx, schur_idx, W, M, dummy, 0);
  int rc = tgtile::smem_attr(k8::sn_takahashi_kernel<T, NT>, smem);
  for (int phase = t1 > 0 ? 1 : 2; phase <= 2 && !rc; ++phase) {  // no rows below: Sigma_JJ = A alone
    k8::sn_takahashi_kernel<T, NT><<<dim3(phase == 1 ? t1 : t2, P, B), k8::kThr, smem, st>>>(
        pre, ps, sig, ss, panel_idx, schur_idx, W, M, dummy, phase);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// K8: cs > 0 runs phase 0 in clusters of cs (t1, t2 unused); cs == 0 runs
// phases 1 and 2, over t1 and t2 blocks per supernode and chain (at least the
// batch's tile counts; t1 = 0 when no rows lie below).
template <typename T>
int launch_takahashi(const T* pre, long long ps, T* sig, long long ss, const int* panel_idx, const int* schur_idx,
                     int P, int W, int M, int dummy, int cs, int t1, int t2, int B, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (cs < 0 || (cs == 0 && (t1 < 0 || t2 < 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 8) return launch_sweep<T, 8>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, B, st);
  return launch_sweep<T, 64>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, B, st);
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
  int tg_sn_takahashi_prep_##SUF(const T* vals, long long vs, T* pre, long long ps,                 \
                                 const int* panel_idx, int P, int W, int M, int dummy, double* work, \
                                 int B, void* stream) {                                            \
    return launch_takahashi_prep<T>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, work, B, stream); \
  }                                                                                                \
  int tg_sn_takahashi_##SUF(const T* pre, long long ps, T* sig, long long ss,                      \
                            const int* panel_idx, const int* schur_idx, int P, int W, int M,       \
                            int dummy, int cs, int t1, int t2, int B, void* stream) {              \
    return launch_takahashi<T>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, \
                               B, stream);                                                         \
  }

TG_SN_ENTRY(f32, float)
TG_SN_ENTRY(f64, double)

#undef TG_SN_ENTRY

}  // extern "C"
