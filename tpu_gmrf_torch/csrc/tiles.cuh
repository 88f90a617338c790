// The device routines of the cluster kernels: products, triangular solves
// and tile Cholesky factors spread over the blocks of a thread-block cluster
// (K11's factorization and K12's block entry `bt_trsv_blocks` in
// csrc/banded.cu, K18 `spike_reduced` in csrc/spike.cu, K9 `dense_chol` and
// K10 `dense_trsv` in csrc/dense.cu, K16 `kl_columns`' tile and cluster paths
// in csrc/kl.cu),
// and the cluster launch.
//
// Every operand lives in global memory (at the SPIKE shapes a step's blocks
// sit in L2); a block stages operand tiles in shared memory and keeps its
// output tile in registers. The pieces:
//   tile_mma / gemm_rows  C (up to 64 rows) op= A B with A, B given by
//       strides (transposes are strides), 32 deep per stage, the next stage
//       loaded into registers while the current one is multiplied. float64
//       multiplies on the tensor cores (mma.sync m16n8k4; the older m8n8k4
//       runs at half its rate on this card and serves only warp tiles of 8
//       rows); float32 on the FMA units (TF32 stays off). Output tiles are
//       64 x NT, NT = 64 for many right-hand sides and 8 for a few.
//   invert_tile  the inverse of a lower-triangular tile of up to 64 rows,
//       by blocks of 16 (a warp per diagonal block): the solves multiply by
//       inverted 64 x 64 diagonal tiles (formed once per factor), so a
//       diagonal step is a product, not a substitution.
//   factor_tile  the Cholesky of a diagonal tile of up to 64 rows and its
//       inverse, by blocks of 16 columns, each block's 16 pivots passed
//       between the lanes of one warp; optionally after subtracting U U^T
//       (sub_gram), and in a wider type than the tile's (K9, K11 and K16
//       factor their float32 tiles in float64). Its core, factor_tile_smem,
//       works on a tile already in shared memory (K16's tile path).
//   trsm_rows  X <- L^-1 X or L^-T X with L's row tiles spread over the
//       blocks of a cluster (tile j belongs to block j % cluster size): the
//       owner of tile j multiplies it by its inverted diagonal tile, a
//       cluster barrier publishes it, and every block subtracts its
//       contribution from its own tiles (right-looking).
//   chol_rows  the Cholesky of an n x n matrix over a cluster: diagonal tile
//       by block 0 (in a wider type where asked), the panel below it and the
//       trailing update as tiles spread over the cluster, three cluster
//       barriers per tile column;
//       while block 0 factors a diagonal tile, the other blocks may run a
//       side task that needs the factor's finished rows (K18 solves with it).
// A cluster barrier is preceded by __threadfence(), and operands are loaded
// with ld.global.cg (L2, not L1), so what one block wrote is what another
// reads after the barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

namespace {
namespace tgtile {

namespace cg = cooperative_groups;

constexpr int kT = 64;         // row tile of the products and the triangular factors
constexpr int kKS = 32;        // depth of a staged operand slice
constexpr int kThr = 256;      // threads of every block (8 warps)
constexpr int kTT = kT * kT;   // values of one stored inverted diagonal tile
constexpr int kLdS = kT + 1;   // row stride of a tile kept whole in shared memory

__host__ __device__ inline int ntiles(int n) { return (n + kT - 1) / kT; }

// Warp layout of a 64 x NT output tile (NT = 8 or 64): WM x WN warps, each MT x NTT tiles of 8 x 8.
template <int NT>
struct Cfg {
  static_assert(NT == 8 || NT == 64, "column tiles of 8 or 64");
  static constexpr int WN = NT == 64 ? 4 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int MT = kT / WM / 8;
  static constexpr int NTT = NT / WN / 8;
  static constexpr int LDA = kT + 4;                 // padded rows of the staged slices:
  static constexpr int LDB = NT == 8 ? 20 : NT + 4;  // conflict-free fragment loads in float64
  static constexpr int AV = kT * kKS / kThr;         // A values per thread and slice
  static constexpr int BV = NT * kKS / kThr;         // B values per thread and slice
};

// Shared memory (values of T) that the products and the tile routines need.
constexpr int kSmemValues = 2 * kKS * (Cfg<64>::LDA + Cfg<64>::LDB) > 2 * kT * kLdS + kT
                                ? 2 * kKS * (Cfg<64>::LDA + Cfg<64>::LDB)
                                : 2 * kT * kLdS + kT;

template <typename T>
__device__ __forceinline__ T ldcg(const T* p) {
  return __ldcg(p);
}

// 1 / sqrt(p): float64 from the hardware estimate r (rsqrt.approx.f64,
// good to about 20 bits) and one third-order step, r (1 + e / 2 + 3 e^2 / 8)
// with e = 1 - p r^2 (the next term, 5 e^3 / 16, is below 2^-60): four
// dependent float64 operations (the float64 rsqrt is a long dependent
// sequence, and a tile Cholesky chains 64 of them).
__device__ __forceinline__ double rsqrt_fast(double p) {
  if (!(p > 1e-30 && p < 1e30)) return rsqrt(p);
  double r;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(p));
  const double e = fma(-p * r, r, 1.0);
  return fma(r * e, fma(0.375, e, 0.5), r);
}
__device__ __forceinline__ float rsqrt_fast(float p) { return rsqrtf(p); }

// A pivot l = sqrt(p) and r = 1 / l: l = p r from rsqrt_fast, or, with
// Exact, a float32 pivot correctly rounded (sqrtf, then a division), as a
// float32 Cholesky of the reference computes it: the approximate rsqrtf
// moves K6's float32 factor of an ill-conditioned matrix away from the
// reference's by more than its own rounding does (n = 14058, chip_smoke.py
// phase 6). Float64 pivots are the same either way.
template <bool Exact, typename W>
__device__ __forceinline__ void pivot(W p, W& r, W& l) {
  if constexpr (Exact && sizeof(W) == 4) {
    l = sqrtf(p);
    r = 1.0f / l;
  } else {
    r = rsqrt_fast(p);
    l = p * r;
  }
}

__device__ __forceinline__ void csync() {
  __threadfence();
  cg::this_cluster().sync();
}

// acc[mi][ni][e]: row wm * (64 / WM) + 8 mi + lane / 4, column wn * (NT / WN) + 8 ni + 2 (lane % 4) + e.
template <typename T, int NT>
struct Acc {
  T v[Cfg<NT>::MT][Cfg<NT>::NTT][2];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < Cfg<NT>::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg<NT>::NTT; ++j) v[i][j][0] = v[i][j][1] = T(0);
  }
};

// One staged slice (kKS deep) into the accumulators.
template <typename T, int NT>
__device__ __forceinline__ void mma_slice(Acc<T, NT>& acc, const T* As, const T* Bs) {
  using C = Cfg<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, q = lane & 3;
  const int r0 = wm * (kT / C::WM), c0 = wn * (NT / C::WN);
#pragma unroll 2  // fragments of two steps in flight, not the whole slice's (registers)
  for (int kk = 0; kk < kKS; kk += 4) {
    if constexpr (sizeof(T) == 8 && C::MT % 2 == 0) {  // m16n8k4: the full f64 tensor-core rate
      double a[C::MT / 2][2], b[C::NTT];
#pragma unroll
      for (int i = 0; i < C::MT / 2; ++i) {
        a[i][0] = As[(kk + q) * C::LDA + r0 + 16 * i + g];
        a[i][1] = As[(kk + q) * C::LDA + r0 + 16 * i + 8 + g];
      }
#pragma unroll
      for (int j = 0; j < C::NTT; ++j) b[j] = Bs[(kk + q) * C::LDB + c0 + 8 * j + g];
#pragma unroll
      for (int i = 0; i < C::MT / 2; ++i)
#pragma unroll
        for (int j = 0; j < C::NTT; ++j)
          asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                       : "+d"(acc.v[2 * i][j][0]), "+d"(acc.v[2 * i][j][1]), "+d"(acc.v[2 * i + 1][j][0]),
                         "+d"(acc.v[2 * i + 1][j][1])
                       : "d"(a[i][0]), "d"(a[i][1]), "d"(b[j]));
    } else if constexpr (sizeof(T) == 8) {  // m8n8k4 (half the rate) for warp tiles of 8 rows
      double a[C::MT], b[C::NTT];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) a[i] = As[(kk + q) * C::LDA + r0 + 8 * i + g];
#pragma unroll
      for (int j = 0; j < C::NTT; ++j) b[j] = Bs[(kk + q) * C::LDB + c0 + 8 * j + g];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NTT; ++j)
          asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                       : "+d"(acc.v[i][j][0]), "+d"(acc.v[i][j][1])
                       : "d"(a[i]), "d"(b[j]));
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        T a[C::MT], b[C::NTT][2];
#pragma unroll
        for (int i = 0; i < C::MT; ++i) a[i] = As[(kk + p) * C::LDA + r0 + 8 * i + g];
#pragma unroll
        for (int j = 0; j < C::NTT; ++j) {
          b[j][0] = Bs[(kk + p) * C::LDB + c0 + 8 * j + 2 * q];
          b[j][1] = Bs[(kk + p) * C::LDB + c0 + 8 * j + 2 * q + 1];
        }
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NTT; ++j) {
            acc.v[i][j][0] += a[i] * b[j][0];
            acc.v[i][j][1] += a[i] * b[j][1];
          }
      }
    }
  }
}

// acc += A B (acc -= A B with `neg`: A is negated as it is staged) over one
// 64 x NT tile: A(i, p) = A[i sai + p sak] for i < Mr, B(p, j) = B[p sbk +
// j sbj] for j < Nc, p < Kd; zeros outside. Every thread of the block calls
// it; it ends with a block barrier.
template <typename T, int NT>
__device__ void tile_mma(Acc<T, NT>& acc, const T* A, long long sai, long long sak, const T* B, long long sbk,
                         long long sbj, int Mr, int Nc, int Kd, bool neg, T* sm) {
  using C = Cfg<NT>;
  T* As = sm;                     // [2][kKS][LDA]
  T* Bs = sm + 2 * kKS * C::LDA;  // [2][kKS][LDB]
  // the u-th value a thread stages per slice sits at (m0 + u dm, p0 + u dp) of A and (p0 + u dp, j0 + u dj)
  // of B, neighbouring threads along the operand's unit stride (coalesced)
  const int tid = threadIdx.x;
  const bool a_m = sai == 1, b_j = sbj == 1;
  const int am0 = a_m ? tid % kT : tid / kKS, ap0 = a_m ? tid / kT : tid % kKS;
  const int adm = a_m ? 0 : kThr / kKS, adp = a_m ? kThr / kT : 0;
  const int bj0 = b_j ? tid % NT : tid / kKS, bp0 = b_j ? tid / NT : tid % kKS;
  const int bdj = b_j ? 0 : kThr / kKS, bdp = b_j ? kThr / NT : 0;
  const T* pa = A + am0 * sai + ap0 * sak;
  const T* pb = B + bp0 * sbk + bj0 * sbj;
  const long long ua = adm * sai + adp * sak, ub = bdp * sbk + bdj * sbj;
  T ra[C::AV], rb[C::BV];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < C::AV; ++u)
      ra[u] = (am0 + u * adm < Mr && k0 + ap0 + u * adp < Kd) ? ldcg(pa + u * ua + k0 * sak) : T(0);
#pragma unroll
    for (int u = 0; u < C::BV; ++u)
      rb[u] = (bj0 + u * bdj < Nc && k0 + bp0 + u * bdp < Kd) ? ldcg(pb + u * ub + k0 * sbk) : T(0);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < C::AV; ++u) As[(buf * kKS + ap0 + u * adp) * C::LDA + am0 + u * adm] = neg ? -ra[u] : ra[u];
#pragma unroll
    for (int u = 0; u < C::BV; ++u) Bs[(buf * kKS + bp0 + u * bdp) * C::LDB + bj0 + u * bdj] = rb[u];
  };
  const int slices = (Kd + kKS - 1) / kKS;
  if (slices == 0) return;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load((s + 1) * kKS);
    mma_slice<T, NT>(acc, As + (s & 1) * kKS * C::LDA, Bs + (s & 1) * kKS * C::LDB);
    if (s + 1 < slices) store((s + 1) & 1);
    __syncthreads();
  }
}

// The accumulators' C[i][j] for i < Mr, j < Nc: load (zero outside) or store.
template <typename T, int NT, bool kLoad>
__device__ void tile_io(Acc<T, NT>& acc, T* Cm, long long ldc, int Mr, int Nc) {
  using C = Cfg<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = wm * (kT / C::WM) + (lane >> 2), c0 = wn * (NT / C::WN) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NTT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * i, c = c0 + 8 * j + e;
        const bool in = r < Mr && c < Nc;
        if (kLoad)
          acc.v[i][j][e] = in ? ldcg(Cm + r * ldc + c) : T(0);
        else if (in)
          Cm[r * ldc + c] = acc.v[i][j][e];
      }
}

// C (Mr <= 64 rows, Nc columns) -= A B (`sub`; the accumulators start from C,
// or from Cin (same strides) when given, loaded while the first operands
// are) or = A B, column tiles of NT; ends with a block barrier.
template <typename T, int NT>
__device__ void gemm_rows(T* Cm, long long ldc, const T* A, long long sai, long long sak, const T* B, long long sbk,
                          long long sbj, int Mr, int Nc, int Kd, bool sub, T* sm, const T* Cin = nullptr) {
  for (int j0 = 0; j0 < Nc; j0 += NT) {
    Acc<T, NT> acc;
    if (sub)
      tile_io<T, NT, true>(acc, const_cast<T*>(Cin ? Cin : Cm) + j0, ldc, Mr, min(NT, Nc - j0));
    else
      acc.zero();
    tile_mma<T, NT>(acc, A, sai, sak, B + j0 * sbj, sbk, sbj, Mr, min(NT, Nc - j0), Kd, sub, sm);
    tile_io<T, NT, false>(acc, Cm + j0, ldc, Mr, min(NT, Nc - j0));
    __syncthreads();
  }
}

// The tile routines below keep a 64 x 64 tile in shared memory (row stride
// kLdS, odd, so a warp reading down a column touches 32 banks) and work on
// it in blocks of 16: a 16 x 16 diagonal block by one warp with shuffles, a
// thread per row or per entry for the rest, a barrier per block step.

// X (64 x 64, lower, row stride kLdS) = L^-1 for the lower tile L (row
// stride kLdS, the identity beyond row t) given the reciprocals rinv of its
// diagonal: the four 16 x 16 diagonal blocks inverted at once by four warps
// (a lane per column, substitution down the rows), then block row i of X
// from X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj, one block row per step.
template <typename T>
__device__ void invert_blocked(const T* L, const T* rinv, T* X) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp < 4) {
    const int b = 16 * warp, c = lane & 15;
    T x[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      T v = r == c ? T(1) : T(0);
#pragma unroll
      for (int q = 0; q < r; ++q) v -= L[(b + r) * kLdS + b + q] * x[q];
      x[r] = v * rinv[b + r];  // zero above the diagonal: x[q] = 0 for q < c
    }
    if (lane < 16)
#pragma unroll
      for (int r = 0; r < 16; ++r) X[(b + r) * kLdS + b + c] = x[r];
  }
  __syncthreads();
  const int r = tid >> 4, c = tid & 15;
  for (int bi = 1; bi < 4; ++bi) {
    T v[3];
#pragma unroll
    for (int bj = 0; bj < 3; ++bj) {  // T_ij = sum_k L_ik X_kj, entry (r, c)
      v[bj] = T(0);
      if (bj < bi)
        for (int q = 16 * bj; q < 16 * bi; ++q) v[bj] += L[(16 * bi + r) * kLdS + q] * X[q * kLdS + 16 * bj + c];
    }
#pragma unroll
    for (int bj = 0; bj < 3; ++bj)
      if (bj < bi) X[(16 * bi + r) * kLdS + 16 * bj + c] = v[bj];
    __syncthreads();
#pragma unroll
    for (int bj = 0; bj < 3; ++bj) {  // X_ij = -X_ii T_ij
      if (bj < bi) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          acc -= X[(16 * bi + r) * kLdS + 16 * bi + q] * X[(16 * bi + q) * kLdS + 16 * bj + c];
        v[bj] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int bj = 0; bj < 3; ++bj)
      if (bj < bi) X[(16 * bi + r) * kLdS + 16 * bj + c] = v[bj];
    __syncthreads();
  }
}

// out (64 x 64, row-major) = the t x t lower part of X, zero elsewhere.
template <typename W, typename T>
__device__ void store_lower(const W* X, int t, T* out) {
#pragma unroll
  for (int u = 0; u < kTT / kThr; ++u) {
    const int e = threadIdx.x + u * kThr, r = e / kT, c = e % kT;
    out[e] = (r < t && c <= r) ? T(X[r * kLdS + c]) : T(0);
  }
}

// Load the lower t x t tile at D (row stride ld) into S, the identity beyond row t.
template <typename T, typename W>
__device__ void load_tile(const T* D, long long ld, int t, W* S) {
#pragma unroll
  for (int u = 0; u < kTT / kThr; ++u) {
    const int e = threadIdx.x + u * kThr, r = e / kT, c = e % kT;
    S[r * kLdS + c] = (r < t && c <= r) ? W(ldcg(D + r * ld + c)) : (r == c ? W(1) : W(0));
  }
  __syncthreads();
}

// out = the inverse of the lower t x t tile at D (row stride ld).
template <typename T>
__device__ void invert_tile(const T* D, long long ld, int t, T* out, T* sm) {
  T* S = sm;
  T* X = sm + kT * kLdS;
  T* rinv = X + kT * kLdS;
  load_tile(D, ld, t, S);
  if (threadIdx.x < kT) rinv[threadIdx.x] = T(1) / S[threadIdx.x * (kLdS + 1)];
  __syncthreads();
  invert_blocked(S, rinv, X);
  store_lower(X, t, out);
  __syncthreads();
}

// The inverse X of the lower tile L (row stride kLdS, in shared memory), a
// block row of 16 at a time, for factor_tile: diagonal block b0 (16 x 16)
// by one warp, a lane per column, substitution down the rows ...
template <typename W>
__device__ void invert_diag16(const W* L, const W* rinv, W* X, int b0, int lane) {
  const int c = lane & 15;
  W x[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    W v = r == c ? W(1) : W(0);
#pragma unroll
    for (int q = 0; q < r; ++q) v -= L[(b0 + r) * kLdS + b0 + q] * x[q];
    x[r] = v * rinv[b0 + r];  // zero above the diagonal: x[q] = 0 for q < c
  }
  if (lane < 16)
#pragma unroll
    for (int r = 0; r < 16; ++r) X[(b0 + r) * kLdS + b0 + c] = x[r];
}

// ... and the rest of block row bi once its diagonal block is in X:
// X_ij = -X_ii sum_{k=j}^{i-1} L_ik X_kj for j < i, by threads id = 0 .. n - 1
// meeting at sync() (T_ij = sum L_ik X_kj is staged in X_ij's place).
template <typename W, typename Sync>
__device__ void invert_row16(const W* L, W* X, int bi, int id, int n, Sync sync) {
  const int i0 = 16 * bi;
  for (int e = id; e < bi * 256; e += n) {
    const int j0 = 16 * (e >> 8), r = (e >> 4) & 15, c = e & 15;
    W v = W(0);
    for (int q = j0; q < i0; ++q) v += L[(i0 + r) * kLdS + q] * X[q * kLdS + j0 + c];
    X[(i0 + r) * kLdS + j0 + c] = v;
  }
  sync();
  W out[4];  // bi * 256 <= 768 entries over at least 224 threads
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = id + u * n, j0 = 16 * (e >> 8), r = (e >> 4) & 15, c = e & 15;
    out[u] = W(0);
    if (e < bi * 256)
#pragma unroll
      for (int q = 0; q < 16; ++q) out[u] -= X[(i0 + r) * kLdS + i0 + q] * X[(i0 + q) * kLdS + j0 + c];
  }
  sync();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = id + u * n;
    if (e < bi * 256) X[(i0 + ((e >> 4) & 15)) * kLdS + 16 * (e >> 8) + (e & 15)] = out[u];
  }
}

// S (the t x t lower tile, row stride kLdS, float64 in shared memory) -=
// U U^T, U t x du at U (row stride ldu), on the float64 tensor cores: U's
// 32-deep slices staged in float64 in st (two buffers of 64 x (kKS + 4),
// the next slice loaded into registers while the current one is
// multiplied), one 64 x 64 accumulator tile (Acc, Cfg<64>), its lower part
// then subtracted from S. Every thread of the block calls it; it ends with
// a block barrier.
template <typename T>
__device__ void sub_gram(double* S, int t, const T* U, long long ldu, int du, double* st) {
  using C = Cfg<64>;
  constexpr int LD = kKS + 4, V = kT * kKS / kThr;
  const int tid = threadIdx.x, p = tid % kKS, r0 = tid / kKS;  // row r0 + 8 u, column p of a slice
  const int lane = tid & 31, warp = tid >> 5, wm = warp % C::WM, wn = warp / C::WM;
  const int g = lane >> 2, q = lane & 3, m0 = wm * (kT / C::WM), n0 = wn * (64 / C::WN);
  Acc<double, 64> acc;
  acc.zero();
  double ru[V];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int r = r0 + u * (kThr / kKS);
      ru[u] = r < t && k0 + p < du ? double(ldcg(U + r * ldu + k0 + p)) : 0.0;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < V; ++u) st[(buf * kT + r0 + u * (kThr / kKS)) * LD + p] = ru[u];
  };
  const int slices = (du + kKS - 1) / kKS;
  load(0);
  store(0);
  __syncthreads();
  for (int sl = 0; sl < slices; ++sl) {
    if (sl + 1 < slices) load((sl + 1) * kKS);
    const double* s_ = st + (sl & 1) * kT * LD;
#pragma unroll 2
    for (int kk = 0; kk < kKS; kk += 4) {  // A(m, k) = U[m][k], B(k, n) = U[n][k]
      double a[C::MT / 2][2], b[C::NTT];
#pragma unroll
      for (int i = 0; i < C::MT / 2; ++i) {
        a[i][0] = s_[(m0 + 16 * i + g) * LD + kk + q];
        a[i][1] = s_[(m0 + 16 * i + 8 + g) * LD + kk + q];
      }
#pragma unroll
      for (int j = 0; j < C::NTT; ++j) b[j] = s_[(n0 + 8 * j + g) * LD + kk + q];
#pragma unroll
      for (int i = 0; i < C::MT / 2; ++i)
#pragma unroll
        for (int j = 0; j < C::NTT; ++j)
          asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                       : "+d"(acc.v[2 * i][j][0]), "+d"(acc.v[2 * i][j][1]), "+d"(acc.v[2 * i + 1][j][0]),
                         "+d"(acc.v[2 * i + 1][j][1])
                       : "d"(a[i][0]), "d"(a[i][1]), "d"(b[j]));
    }
    if (sl + 1 < slices) store((sl + 1) & 1);
    __syncthreads();
  }
  const int rr = m0 + g, cc = n0 + 2 * q;  // acc.v[i][j][e] is (rr + 8 i, cc + 8 j + e)
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NTT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = rr + 8 * i, c = cc + 8 * j + e;
        if (c <= r && r < t) S[r * kLdS + c] -= acc.v[i][j][e];
      }
  __syncthreads();
}

// The Cholesky of the lower tile S (t x t, row stride kLdS, W in shared
// memory; the identity beyond row t, zeros above the diagonal) in place, and
// its inverse into X (the blocks on and below the diagonal; what is above
// them is left as it was); rinv gets the reciprocals of the pivots; *bad set
// for a pivot l = sqrt(p) that is not finite and above tiny. By blocks of
// 16 columns: the diagonal block by warp 0, a lane per row, its pivots
// passed by shuffles (`pivot<Exact>`; the lane of the next pivot
// forms it from its own row, so one shuffle per pivot is on the dependent
// chain); the rows below it by a thread each; then the next diagonal
// block's update, by a thread per entry. The rest of that block column's
// update and the inverse's block row run on warps 1-7 while warp 0 factors
// the next diagonal block (the pivots are the tile's critical path).
// during() runs on every thread while warp 1 inverts the last diagonal
// block (the factor is final then). Every thread of the block calls it; it
// ends with a block barrier.
template <bool Exact = false, typename W, typename During>
__device__ void factor_tile_smem(W* S, W* X, W* rinv, int t, int* bad, W tiny, During during) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int nb = (t + 15) / 16, warp = tid >> 5;
  for (int b = 0; b < nb; ++b) {
    const int b0 = 16 * b;
    if (warp == 0) {  // the diagonal block: lane l (and l + 16) holds its row l
      const int l = lane & 15;
      W row[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) row[q] = S[(b0 + l) * kLdS + b0 + q];
      W p = __shfl_sync(0xffffffffu, row[0], 0), myr = W(1), mypiv = W(1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        W r, piv;
        pivot<Exact>(p, r, piv);
        if (l == j) myr = r, mypiv = piv;
        row[j] = l == j ? piv : (l > j ? row[j] * r : W(0));
        if (j < 15) {
          const W next = row[j + 1] - row[j] * row[j];  // lane j + 1's next pivot
#pragma unroll
          for (int q = j + 1; q < 16; ++q) {
            const W lq = __shfl_sync(0xffffffffu, row[j], q);  // L[q][j]
            if (l >= q) row[q] -= row[j] * lq;
          }
          p = __shfl_sync(0xffffffffu, next, j + 1);
        }
      }
      if (lane < 16) {
        rinv[b0 + l] = myr;
        if (b0 + l < t && !(mypiv > tiny && isfinite(mypiv))) *bad = 1;
#pragma unroll
        for (int q = 0; q < 16; ++q) S[(b0 + l) * kLdS + b0 + q] = q <= l ? row[q] : W(0);
      }
    } else if (b > 0) {  // meanwhile warps 1-7: what the previous block column left
      const int id = tid - 32, n = kThr - 32, m_c = kT - b0;
      auto helpers_sync = [] { asm volatile("bar.sync 1, 224;" ::: "memory"); };
      // its update of the rows below block b (block b's own was done before these pivots)
      for (int e = id; e < (kT - 16 - b0) * m_c; e += n) {
        const int i = b0 + 16 + e / m_c, c = b0 + e % m_c;
        if (c <= i) {
          W acc = S[i * kLdS + c];
#pragma unroll
          for (int q = 0; q < 16; ++q) acc -= S[i * kLdS + b0 - 16 + q] * S[c * kLdS + b0 - 16 + q];
          S[i * kLdS + c] = acc;
        }
      }
      // block row b - 1 of the inverse
      if (warp == 1) invert_diag16(S, rinv, X, b0 - 16, lane);
      helpers_sync();
      invert_row16(S, X, b - 1, id, n, helpers_sync);
    }
    __syncthreads();
    if (tid < kT - 16 - b0) {  // row i below: S[i][b0:b0+16] <- S[i][b0:b0+16] L^-T
      const int i = b0 + 16 + tid;
      W x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        W v = S[i * kLdS + b0 + j];
#pragma unroll
        for (int q = 0; q < j; ++q) v -= x[q] * S[(b0 + j) * kLdS + b0 + q];
        x[j] = v * rinv[b0 + j];
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) S[i * kLdS + b0 + j] = x[j];
    }
    __syncthreads();
    if (b + 1 < nb) {  // the next diagonal block's update by this block column, before its pivots
      const int r = tid >> 4, c = tid & 15, i = b0 + 16 + r;
      if (c <= r) {
        W acc = S[i * kLdS + b0 + 16 + c];
#pragma unroll
        for (int q = 0; q < 16; ++q) acc -= S[i * kLdS + b0 + q] * S[(b0 + 16 + c) * kLdS + b0 + q];
        S[i * kLdS + b0 + 16 + c] = acc;
      }
      __syncthreads();
    }
  }
  // during(), while warp 1 inverts the last diagonal block; then the last block row of the inverse
  if (warp == 1) invert_diag16(S, rinv, X, 16 * (nb - 1), lane);
  during();
  __syncthreads();
  invert_row16(S, X, nb - 1, tid, kThr, [] { __syncthreads(); });
  __syncthreads();
}

// Cholesky of the t x t diagonal tile at D (lower triangle read; the factor
// written back with zeros above the diagonal) and its inverse into Dinv (not
// stored where Dinv is null),
// both computed in W (the type of the shared memory sm: T, or float64 for a
// float32 tile whose inverse must not bias what it multiplies), by
// factor_tile_smem; *bad set for a pivot l = sqrt(p) that is not finite and
// above tiny. With du > 0 the tile is first updated, D - U U^T, U t x du at
// U (sub_gram, so W must be float64; its staging follows the tile's shared
// memory).
template <bool Exact = false, typename T, typename W>
__device__ void factor_tile(T* D, long long ld, int t, T* Dinv, int* bad, W* sm, T tiny = T(0),
                            const T* U = nullptr, long long ldu = 0, int du = 0) {
  W* S = sm;
  W* X = sm + kT * kLdS;
  W* rinv = X + kT * kLdS;
  const int tid = threadIdx.x;
  if (tid < kT) rinv[tid] = W(1);  // the identity beyond t
  load_tile(D, ld, t, S);
  if constexpr (sizeof(W) == 8) {
    if (du > 0) sub_gram(S, t, U, ldu, du, rinv + kT);
  }
  factor_tile_smem<Exact>(S, X, rinv, t, bad, W(tiny), [&] {  // the factor back
#pragma unroll
    for (int u = 0; u < kTT / kThr; ++u) {
      const int e = tid + u * kThr, r = e / kT, c = e % kT;
      if (r < t && c < t) D[r * ld + c] = c <= r ? T(S[r * kLdS + c]) : T(0);
    }
  });
  if (Dinv) store_lower(X, t, Dinv);
  __syncthreads();
}

// X (n x ncols, row stride ldx) <- L^-1 X (trans: L^-T X), L lower n x n
// (row stride ld) with its inverted diagonal tiles Dinv (ntiles(n) x 64 x
// 64). Row tile j of X belongs to block j % cs of the cluster (`rank`).
// Every block of the cluster calls it; it ends with a cluster barrier.
template <typename T, int NT>
__device__ void trsm_rows(const T* L, long long ld, const T* Dinv, int n, T* X, long long ldx, int ncols, bool trans,
                          int rank, int cs, T* sm) {
  const int nt = ntiles(n);
  for (int it = 0; it < nt; ++it) {
    const int j = trans ? nt - 1 - it : it, j0 = j * kT, tj = min(kT, n - j0);
    T* Xj = X + (long long)j0 * ldx;
    if (j % cs == rank)  // X_j <- D_j^-1 X_j (D_j^-T X_j)
      gemm_rows<T, NT>(Xj, ldx, Dinv + (long long)j * kTT, trans ? 1 : kT, trans ? kT : 1, Xj, ldx, 1, tj, ncols, tj,
                       false, sm);
    csync();
    for (int i = trans ? j - 1 : j + 1; trans ? i >= 0 : i < nt; i += trans ? -1 : 1) {
      if (i % cs != rank) continue;
      const int i0 = i * kT, ti = min(kT, n - i0);
      if (!trans)  // X_i -= L[i, j] X_j
        gemm_rows<T, NT>(X + (long long)i0 * ldx, ldx, L + (long long)i0 * ld + j0, ld, 1, Xj, ldx, 1, ti, ncols, tj,
                         true, sm);
      else  // X_i -= L[j, i]^T X_j
        gemm_rows<T, NT>(X + (long long)i0 * ldx, ldx, L + (long long)j0 * ld + i0, 1, ld, Xj, ldx, 1, ti, ncols, tj,
                         true, sm);
    }
  }
}

// dst(e) = src(e) for e < count, spread over the cluster (`rank` of cs
// blocks), eight loads in flight per thread.
template <typename T, typename Src, typename Dst>
__device__ void cluster_copy(long long count, int rank, int cs, Src src, Dst dst) {
  const long long g0 = (long long)rank * kThr + threadIdx.x, gs = (long long)cs * kThr;
  for (long long e0 = g0; e0 < count; e0 += 8 * gs) {
    T v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = e0 + u * gs < count ? src(e0 + u * gs) : T(0);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (e0 + u * gs < count) dst(e0 + u * gs, v[u]);
  }
}

// The lower triangle of the n x n matrix A (row stride n) <- that of (A + A^T) / 2, by 64 x 64 tiles dealt out
// over the cluster, the transposed tile staged in shared memory (both reads coalesced). Ends with a cluster
// barrier.
template <typename T>
__device__ void symmetrize(T* A, int n, int rank, int cs, T* sm) {
  const int nt = ntiles(n);
  int idx = 0;
  for (int I = 0; I < nt; ++I)
    for (int J = 0; J <= I; ++J, ++idx) {
      if (idx % cs != rank) continue;
      const int i0 = I * kT, j0 = J * kT, ti = min(kT, n - i0), tj = min(kT, n - j0);
#pragma unroll
      for (int u = 0; u < kTT / kThr; ++u) {  // sm[c][r] = A[j0 + c][i0 + r]
        const int e = threadIdx.x + u * kThr, c = e / kT, r = e % kT;
        if (c < tj && r < ti) sm[c * kLdS + r] = ldcg(A + (long long)(j0 + c) * n + i0 + r);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kTT / kThr; ++u) {
        const int e = threadIdx.x + u * kThr, r = e / kT, c = e % kT;
        if (r < ti && c < tj && (I > J || c < r)) {
          T* o = A + (long long)(i0 + r) * n + j0 + c;
          *o = T(0.5) * (ldcg(o) + sm[c * kLdS + r]);
        }
      }
      __syncthreads();
    }
  csync();
}

// Lower Cholesky in place of the n x n matrix A (row stride n; lower
// triangle read, upper set to zero) over the cluster, with its inverted
// diagonal tiles into Dinv; *bad set for a pivot that is not finite and
// positive. Block 0 factors the diagonal tiles, in W (wsm: the same shared
// memory as sm, seen as W; float64 for a float32 matrix whose inverted tiles
// must not bias the pivots that follow); with `with_side`, while it
// factors tile j + 1 the other blocks (all of it in a cluster of one) run
// side(j, worker, workers), which may read the factor's tile rows 0..j and
// their inverted diagonal tiles; side(nt - 1, ...) runs after the last
// tile. Ends with a cluster barrier.
template <typename T, typename W, typename Side>
__device__ void chol_rows(T* A, int n, T* Dinv, int* bad, int rank, int cs, T* sm, W* wsm, bool with_side, Side side) {
  const int nt = ntiles(n);
  const bool worker = with_side && (cs == 1 || rank != 0);
  const int wid = cs == 1 ? 0 : rank - 1, workers = cs == 1 ? 1 : cs - 1;
  for (int j = 0; j < nt; ++j) {
    const int j0 = j * kT, tj = min(kT, n - j0);
    if (rank == 0) factor_tile(A + (long long)j0 * n + j0, n, tj, Dinv + (long long)j * kTT, bad, wsm);
    if (worker && j > 0) side(j - 1, wid, workers);
    csync();
    for (int i = j + 1 + rank; i < nt; i += cs) {  // the panel: A_ij <- A_ij L_jj^-T
      const int i0 = i * kT;
      T* Aij = A + (long long)i0 * n + j0;
      gemm_rows<T, 64>(Aij, n, Aij, n, 1, Dinv + (long long)j * kTT, 1, kT, min(kT, n - i0), tj, tj, false, sm);
    }
    csync();
    // the trailing update: A_il -= L_ij L_lj^T for j < l <= i, tiles dealt out over the cluster
    int idx = 0;
    for (int i = j + 1; i < nt; ++i)
      for (int l = j + 1; l <= i; ++l, ++idx) {
        if (idx % cs != rank) continue;
        const int i0 = i * kT, l0 = l * kT;
        gemm_rows<T, 64>(A + (long long)i0 * n + l0, n, A + (long long)i0 * n + j0, n, 1, A + (long long)l0 * n + j0,
                         1, n, min(kT, n - i0), min(kT, n - l0), tj, true, sm);
      }
    csync();
  }
  if (worker) side(nt - 1, wid, workers);
  // zero the tiles above the diagonal (the diagonal tiles' upper parts are zero already)
  int idx = 0;
  for (int I = 0; I < nt; ++I)
    for (int J = I + 1; J < nt; ++J, ++idx) {
      if (idx % cs != rank) continue;
#pragma unroll
      for (int u = 0; u < kTT / kThr; ++u) {
        const int e = threadIdx.x + u * kThr, r = I * kT + e / kT, c = J * kT + e % kT;
        if (r < n && c < n) A[(long long)r * n + c] = T(0);
      }
    }
  csync();
}

// gemm_rows / trsm_rows with the column tile that suits Nc columns: 8 for a
// few right-hand sides, else 64.
template <typename T>
__device__ void gemm_k(T* Cm, long long ldc, const T* A, long long sai, long long sak, const T* B, long long sbk,
                       long long sbj, int Mr, int Nc, int Kd, bool sub, T* sm) {
  if (Nc <= 8)
    gemm_rows<T, 8>(Cm, ldc, A, sai, sak, B, sbk, sbj, Mr, Nc, Kd, sub, sm);
  else
    gemm_rows<T, 64>(Cm, ldc, A, sai, sak, B, sbk, sbj, Mr, Nc, Kd, sub, sm);
}

template <typename T>
__device__ void trsm_k(const T* L, long long ld, const T* Dinv, int n, T* X, long long ldx, int ncols, bool trans,
                       int rank, int cs, T* sm) {
  if (ncols <= 8)
    trsm_rows<T, 8>(L, ld, Dinv, n, X, ldx, ncols, trans, rank, cs, sm);
  else
    trsm_rows<T, 64>(L, ld, Dinv, n, X, ldx, ncols, trans, rank, cs, sm);
}

// The host's answers per kernel, cached so that a launch asks the runtime
// nothing it has asked before (cudaFuncSetAttribute and
// cudaOccupancyMaxActiveClusters cost tens of microseconds of host time each):
// per (kernel, device) the largest dynamic shared memory opted in so far, and
// per (kernel, device, cluster size, shared memory) the number of such
// clusters the card holds. A fixed table under a mutex (the wrapper's ctypes
// call releases the GIL); a full table stops caching, it does not fail.
struct FitEntry {
  const void* fn;
  int dev, cs;
  size_t smem;
  int count;  // -1: only the shared-memory opt-in is recorded
};
constexpr int kFitSlots = 256;
inline FitEntry g_fit[kFitSlots];
inline int g_fit_used = 0;
inline std::mutex g_fit_mutex;

// The opt-in of `kernel` to `smem` bytes of dynamic shared memory (never
// lowered below an earlier launch's), once per kernel, device and size.
template <typename K>
int smem_attr_locked(K kernel, int dev, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  size_t most = 0;
  for (int i = 0; i < g_fit_used; ++i)
    if (g_fit[i].fn == fn && g_fit[i].dev == dev) {
      if (g_fit[i].smem == smem) return 0;
      most = g_fit[i].smem > most ? g_fit[i].smem : most;
    }
  int rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(smem > most ? smem : most));
  if (!rc && g_fit_used < kFitSlots) g_fit[g_fit_used++] = FitEntry{fn, dev, 0, smem, -1};
  return rc;
}

template <typename K>
int smem_attr(K kernel, size_t smem) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  std::lock_guard<std::mutex> lock(g_fit_mutex);
  return smem_attr_locked(kernel, dev, smem);
}

// The launch configuration of `kernel` on `grid` in clusters of cs blocks
// along x with `smem` bytes of dynamic shared memory, and how many such
// clusters the card can hold at once (*count), asked of the runtime once per
// kernel, device, cluster size and shared memory.
template <typename... KArgs>
int cluster_config(void (*kernel)(KArgs...), dim3 grid, int cs, size_t smem, cudaStream_t st,
                   cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int* count) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(kThr);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  *count = 0;
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(g_fit_mutex);
  for (int i = 0; i < g_fit_used; ++i)
    if (g_fit[i].fn == fn && g_fit[i].dev == dev && g_fit[i].cs == cs && g_fit[i].smem == smem && g_fit[i].count >= 0) {
      *count = g_fit[i].count;
      return 0;
    }
  rc = smem_attr_locked(kernel, dev, smem);
  if (!rc && cs > 8) rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  rc = (int)cudaOccupancyMaxActiveClusters(count, kernel, cfg);
  if (!rc && g_fit_used < kFitSlots) g_fit[g_fit_used++] = FitEntry{fn, dev, cs, smem, *count};
  return rc;
}

template <typename... KArgs>
int max_clusters(void (*kernel)(KArgs...), dim3 grid, int cs, size_t smem, int* count) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return cluster_config(kernel, grid, cs, smem, nullptr, &cfg, &attr, count);
}

// How many clusters of cs blocks of `kernel` with `smem` bytes the card
// holds at once (0 for a cluster size it refuses), for the host's choice of
// cluster size (kernels/banded.py factor_cluster).
template <typename... KArgs>
int cluster_fit(void (*kernel)(KArgs...), int cs, size_t smem, int* count) {
  if (max_clusters(kernel, dim3(cs), cs, smem, count)) {
    cudaGetLastError();
    *count = 0;
  }
  return 0;
}

// Shared memory of a kernel on chol_rows and trsm_rows: the products'
// staging (T) or a tile factor in float64, whichever is larger.
template <typename T>
size_t chol_rows_smem() {
  const size_t prod = sizeof(T) * kSmemValues, tile = sizeof(double) * (2 * kT * kLdS + kT);
  return prod > tile ? prod : tile;
}

// Launch `kernel` in clusters of cs blocks; cudaErrorInvalidConfiguration
// when not even one such cluster fits the card.
template <typename... KArgs, typename... Args>
int launch_cluster(void (*kernel)(KArgs...), dim3 grid, int cs, size_t smem, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int count = 0;
  int rc = cluster_config(kernel, grid, cs, smem, st, &cfg, &attr, &count);
  if (rc) return rc;
  if (count < 1) return (int)cudaErrorInvalidConfiguration;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc ? rc : (int)cudaGetLastError();
}

}  // namespace tgtile
}  // namespace
