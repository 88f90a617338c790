// Building blocks of the dense kernels K9-K12 (csrc/dense.cu, csrc/banded.cu):
// a batched blocked right-looking Cholesky of tall panels, spread over
// (chain, tile) thread blocks, block-level triangular solves of one vector,
// and one of many (`blk_trsm`, also K18's, csrc/spike.cu). The tiled block
// product (`gemm_tile`, `block_gemm`), `Eps` and `set_smem` are shared with
// K6/K8 (csrc/supernodal.cu).
//
// Layout. Chain b's matrix starts at A + b * stride, row-major with leading
// dimension ld. A panel is H x W (H >= W): its top W x W part is factored
// (lower triangle; the upper triangle is never read or written), the rows
// below get X = A L^-T. `active` (may be null) selects the chains that take
// part: blocks of other chains return at once. A pivot l = sqrt(p) with
// !(isfinite(l) && l > tiny) sets fail[b]; the factorization of that chain
// goes on with whatever values result, and the caller decides what to redo.
//
// Launches per panel: for each column tile of width kNB, one diagonal-tile
// Cholesky (one block per chain), one row-panel solve (chain x 128-row
// blocks) and one trailing update (chain x 64x64 lower tiles).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Internal linkage: each source that includes this gets its own copy.
namespace {
namespace tgdense {

constexpr int kNB = 64;        // column tile of the blocked Cholesky
constexpr int kThreads = 256;  // threads of the tile Cholesky, the updates and the vector solves
constexpr int kRT = 128;       // rows per block of the panel solve (one thread each)
constexpr int kGB = 64, kGK = 16;  // output tile and depth step of the trailing update
constexpr int kVecThreads = 1024;  // threads of a vector solve: 32 warps keep loads in flight

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float v = 1.1920928955078125e-07f;
};
template <>
struct Eps<double> {
  static constexpr double v = 2.220446049250313e-16;
};

// Opt in to the dynamic shared memory of a launch (the 48 KB default bounds
// static + dynamic together).
template <typename K>
inline int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- the blocked panel Cholesky ----------------------------------------------

// Cholesky of the t x t diagonal tile at (c0, c0), in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    potrf_tile_kernel(T* A, long long stride, int ld, int c0, int t, T tiny, const int* active, int* fail) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // t x (t + 1), odd row stride
  __shared__ T s_piv;
  const long long b = blockIdx.x;
  if (active && !active[b]) return;
  T* Ab = A + b * stride + (long long)c0 * ld + c0;
  const int ls = t + 1;
  for (int e = threadIdx.x; e < t * t; e += blockDim.x) {
    const int r = e / t, c = e % t;
    S[r * ls + c] = c <= r ? Ab[(long long)r * ld + c] : T(0);
  }
  __syncthreads();
  bool bad = false;  // thread 0's view
  for (int j = 0; j < t; ++j) {
    if (threadIdx.x == 0) {
      const T l = sqrt(S[j * ls + j]);
      if (!(isfinite(l) && l > tiny)) bad = true;
      S[j * ls + j] = l;
      s_piv = l;
    }
    __syncthreads();
    const T inv = T(1) / s_piv;
    for (int i = j + 1 + threadIdx.x; i < t; i += blockDim.x) S[i * ls + j] *= inv;
    __syncthreads();
    const int m = t - j - 1;
    for (int e = threadIdx.x; e < m * m; e += blockDim.x) {
      const int i = j + 1 + e / m, q = j + 1 + e % m;
      if (q <= i) S[i * ls + q] -= S[i * ls + j] * S[q * ls + j];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && bad) fail[b] = 1;
  for (int e = threadIdx.x; e < t * t; e += blockDim.x) {
    const int r = e / t, c = e % t;
    if (c <= r) Ab[(long long)r * ld + c] = S[r * ls + c];
  }
}

// Rows r0 + 128 blockIdx.y ... of the panel, columns c0..c0+t:
// X = A L11^-T with L11 the factored diagonal tile; one thread per row.
template <typename T>
__global__ void __launch_bounds__(kRT)
    trsm_rows_kernel(T* A, long long stride, int ld, int c0, int t, int r0, int H, const int* active) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ls = t + 1;
  T* L = reinterpret_cast<T*>(smem_raw);  // t x ls
  T* X = L + t * ls;                       // kRT x ls
  const long long b = blockIdx.x;
  if (active && !active[b]) return;
  T* Ab = A + b * stride;
  const int rbase = r0 + blockIdx.y * kRT;
  const int nr = min(kRT, H - rbase);
  for (int e = threadIdx.x; e < t * t; e += blockDim.x) {
    const int r = e / t, c = e % t;
    L[r * ls + c] = c <= r ? Ab[(long long)(c0 + r) * ld + c0 + c] : T(0);
  }
  for (int e = threadIdx.x; e < nr * t; e += blockDim.x) {
    const int r = e / t, c = e % t;
    X[r * ls + c] = Ab[(long long)(rbase + r) * ld + c0 + c];
  }
  __syncthreads();
  if ((int)threadIdx.x < nr) {
    T* x = X + threadIdx.x * ls;
    for (int j = 0; j < t; ++j) {
      T v = x[j];
      for (int q = 0; q < j; ++q) v -= x[q] * L[j * ls + q];
      x[j] = v / L[j * ls + j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * t; e += blockDim.x) {
    const int r = e / t, c = e % t;
    Ab[(long long)(rbase + r) * ld + c0 + c] = X[r * ls + c];
  }
}

// ---- the tiled block product (also K6/K8's, csrc/supernodal.cu) ---------------

constexpr int kLd = kGB + 1;  // padded row of the staged operand tiles (no bank conflicts)

// One 64 x 64 output tile at (i0, j0) of Cm = beta Cm + alpha A B, with
// A(i,k) = A[i sai + k sak] and B(k,j) = B[k sbk + j sbj] (transposes are
// strides), i < Mr, j < Nc, k < Kd: operands staged in shared memory 16 deep
// (As, Bs: kGK x kLd each), 4 x 4 outputs per thread in registers (kThreads
// threads). `lower` writes only j <= i.
template <typename T>
__device__ void gemm_tile(T* Cm, long long ldc, const T* A, long long sai, long long sak, const T* B, long long sbk,
                          long long sbj, int Mr, int Nc, int Kd, T alpha, T beta, bool lower, T* As, T* Bs, int i0,
                          int j0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = T(0);
  for (int k0 = 0; k0 < Kd; k0 += kGK) {
    // neighbouring lanes load along each operand's unit stride (coalesced)
    for (int e = threadIdx.x; e < kGB * kGK; e += blockDim.x) {
      const int ii = sai == 1 ? e % kGB : e / kGK, ka = sai == 1 ? e / kGB : e % kGK;
      const int jj = sbk == 1 ? e / kGK : e % kGB, kb = sbk == 1 ? e % kGK : e / kGB;
      const int gi = i0 + ii, gka = k0 + ka, gkb = k0 + kb, gj = j0 + jj;
      As[ka * kLd + ii] = (gi < Mr && gka < Kd) ? A[gi * sai + gka * sak] : T(0);
      Bs[kb * kLd + jj] = (gkb < Kd && gj < Nc) ? B[gkb * sbk + gj * sbj] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kGK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk * kLd + ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk * kLd + tx * 4 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += a[r] * b[c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gi = i0 + ty * 4 + r, gj = j0 + tx * 4 + c;
      if (gi < Mr && gj < Nc && (!lower || gj <= gi)) {
        T* o = Cm + gi * ldc + gj;
        *o = beta == T(0) ? alpha * acc[r][c] : beta * *o + alpha * acc[r][c];
      }
    }
}

// The whole product over one thread block, tile after tile.
template <typename T>
__device__ void block_gemm(T* Cm, long long ldc, const T* A, long long sai, long long sak, const T* B,
                           long long sbk, long long sbj, int Mr, int Nc, int Kd, T alpha, T beta, bool lower, T* As,
                           T* Bs) {
  for (int i0 = 0; i0 < Mr; i0 += kGB)
    for (int j0 = 0; j0 < Nc; j0 += kGB)
      if (!lower || j0 <= i0 + kGB - 1)
        gemm_tile(Cm, ldc, A, sai, sak, B, sbk, sbj, Mr, Nc, Kd, alpha, beta, lower, As, Bs, i0, j0);
}

// X (m x q, ldx) <- L^-1 X, or L^-T X with `trans`; L lower m x m (ld), S
// shared memory of kNB x (kNB + 1). Tile by tile (from the top, or from the
// bottom with `trans`): the solved rows' contribution by block_gemm, then the
// diagonal tile, staged in S, by substitution, one thread per column of X.
// Shared by K12's block entry (csrc/banded.cu) and K18 (csrc/spike.cu).
template <typename T>
__device__ void blk_trsm(const T* L, int ld, int m, T* X, int ldx, int q, bool trans, T* S, T* As, T* Bs) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int tiles = (m + kNB - 1) / kNB;
  for (int it = 0; it < tiles; ++it) {
    const int i0 = (trans ? tiles - 1 - it : it) * kNB, t = min(kNB, m - i0), ls = t + 1;
    if (!trans && i0 > 0)  // X[i0:i0+t] -= L[i0:i0+t, 0:i0] X[0:i0]
      block_gemm(X + (long long)i0 * ldx, ldx, L + (long long)i0 * ld, ld, 1, X, ldx, 1, t, q, i0, T(-1), T(1),
                 false, As, Bs);
    if (trans && i0 + t < m)  // X[i0:i0+t] -= L[i0+t:m, i0:i0+t]^T X[i0+t:m]
      block_gemm(X + (long long)i0 * ldx, ldx, L + (long long)(i0 + t) * ld + i0, 1, ld, X + (long long)(i0 + t) * ldx,
                 ldx, 1, t, q, m - i0 - t, T(-1), T(1), false, As, Bs);
    for (int e = tid; e < t * t; e += nt) {
      const int r = e / t, c = e % t;
      S[r * ls + c] = c <= r ? L[(long long)(i0 + r) * ld + i0 + c] : T(0);
    }
    __syncthreads();
    for (int c = tid; c < q; c += nt) {
      T* x = X + (long long)i0 * ldx + c;
      if (!trans) {
        for (int j = 0; j < t; ++j) {
          T v = x[(long long)j * ldx];
          for (int p = 0; p < j; ++p) v -= S[j * ls + p] * x[(long long)p * ldx];
          x[(long long)j * ldx] = v / S[j * ls + j];
        }
      } else {
        for (int j = t - 1; j >= 0; --j) {
          T v = x[(long long)j * ldx];
          for (int p = j + 1; p < t; ++p) v -= S[p * ls + j] * x[(long long)p * ldx];
          x[(long long)j * ldx] = v / S[j * ls + j];
        }
      }
    }
    __syncthreads();
  }
}

// C(i, j) -= sum_k X(i, k) X(j, k) for j <= i, i < R, j < N, k < depth: one
// gemm_tile per thread block (grid x: row tiles, y: column tiles, z: chains).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    syrk_lower_kernel(T* C, long long cstride, int ldc, const T* X, long long xstride, int ldx, int R, int N,
                      int depth, const int* active) {
  __shared__ T As[kGK * kLd], Bs[kGK * kLd];
  const long long b = blockIdx.z;
  if (active && !active[b]) return;
  const int i0 = blockIdx.x * kGB, j0 = blockIdx.y * kGB;
  if (j0 > i0 + kGB - 1) return;  // above the diagonal
  const T* Xb = X + b * xstride;
  gemm_tile(C + b * cstride, ldc, Xb, ldx, 1, Xb, 1, ldx, R, N, depth, T(-1), T(1), true, As, Bs, i0, j0);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Blocked right-looking Cholesky of the H x W panels at A (one per chain).
template <typename T>
int factor_panels(T* A, long long stride, int ld, int H, int W, T tiny, const int* active, int* fail, int B,
                  cudaStream_t st) {
  const size_t smem_tile = sizeof(T) * (size_t)kNB * (kNB + 1);
  const size_t smem_trsm = sizeof(T) * (size_t)(kNB + kRT) * (kNB + 1);
  int rc = set_smem(potrf_tile_kernel<T>, smem_tile);
  if (!rc) rc = set_smem(trsm_rows_kernel<T>, smem_trsm);
  if (rc) return rc;
  for (int c0 = 0; c0 < W; c0 += kNB) {
    const int t = W - c0 < kNB ? W - c0 : kNB, r0 = c0 + t;
    potrf_tile_kernel<T><<<B, kThreads, sizeof(T) * (size_t)t * (t + 1), st>>>(A, stride, ld, c0, t, tiny,
                                                                              active, fail);
    if (r0 >= H) continue;
    trsm_rows_kernel<T><<<dim3(B, cdiv(H - r0, kRT)), kRT, sizeof(T) * (size_t)(t + kRT) * (t + 1), st>>>(
        A, stride, ld, c0, t, r0, H, active);
    if (r0 < W)
      syrk_lower_kernel<T><<<dim3(cdiv(H - r0, kGB), cdiv(W - r0, kGB), B), kThreads, 0, st>>>(
          A + (long long)r0 * ld + r0, stride, ld, A + (long long)r0 * ld + c0, stride, ld, H - r0, W - r0, t,
          active);
  }
  return (int)cudaGetLastError();
}

// ---- per-chain helpers ------------------------------------------------------------

// a[b][0:count] = value for the chains in `active` (all when null).
template <typename T>
__global__ void fill_kernel(T* a, long long stride, long long count, T value, const int* active) {
  const long long b = blockIdx.y;
  if (active && !active[b]) return;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < count; i += (long long)gridDim.x * blockDim.x)
    a[b * stride + i] = value;
}

template <typename T>
int fill(T* a, long long stride, long long count, T value, const int* active, int B, cudaStream_t st) {
  const long long want = (count + kThreads - 1) / kThreads;
  const int blocks = want < 1024 ? (int)(want > 0 ? want : 1) : 1024;
  fill_kernel<T><<<dim3(blocks, B), kThreads, 0, st>>>(a, stride, count, value, active);
  return (int)cudaGetLastError();
}

// out[b] = (within[b] or 1) && fail[b]; fail[b] = 0; count[b] += out[b].
__global__ void take_failed_kernel(const int* within, int* fail, int* out, int* count, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int f = (within ? within[b] : 1) && fail[b];
  out[b] = f;
  fail[b] = 0;
  if (count && f) count[b] += 1;
}

inline int take_failed(const int* within, int* fail, int* out, int* count, int B, cudaStream_t st) {
  take_failed_kernel<<<cdiv(B, kThreads), kThreads, 0, st>>>(within, fail, out, count, B);
  return (int)cudaGetLastError();
}

// Whether any chain has fail[b] set: copies the flags to the host and waits
// for the stream (the rescue paths are rare and decided on the host).
inline int any_failed(const int* fail, int B, cudaStream_t st, bool* any) {
  int* host = new int[B];
  int rc = (int)cudaMemcpyAsync(host, fail, sizeof(int) * B, cudaMemcpyDeviceToHost, st);
  if (!rc) rc = (int)cudaStreamSynchronize(st);
  *any = false;
  for (int b = 0; b < B && !rc; ++b) *any = *any || host[b] != 0;
  delete[] host;
  return rc;
}

// ---- vector solves of one block ------------------------------------------------------

// v[0:R] -= M[0:R, 0:C] u[0:C], M row-major (ld); one warp per row. v and u
// must not overlap.
template <typename T>
__device__ void sub_matvec(T* v, const T* M, long long ld, const T* u, int R, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = warp; i < R; i += nw) {
    const T* row = M + (long long)i * ld;
    T acc = T(0);
#pragma unroll 8  // several loads in flight per lane: these loops are latency-bound
    for (int j = lane; j < C; j += 32) acc += row[j] * u[j];
    for (int o = 16; o; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) v[i] -= acc;
  }
}

// v[0:C] -= M[0:R, 0:C]^T u[0:R]: lanes over columns (coalesced rows of M),
// warps over rows, the warps' partial sums reduced in red (blockDim.x entries).
// Every thread of the block must call it.
template <typename T>
__device__ void sub_matvec_t(T* v, const T* M, long long ld, const T* u, int R, int C, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    T acc = T(0);
    if (c < C)
#pragma unroll 8
      for (int j = warp; j < R; j += nw) acc += M[(long long)j * ld + c] * u[j];
    red[threadIdx.x] = acc;
    __syncthreads();
    if (warp == 0 && c < C) {
      T s = T(0);
      for (int w = 0; w < nw; ++w) s += red[w * 32 + lane];
      v[c] -= s;
    }
    __syncthreads();
  }
}

// v[0:m] <- L^-1 v with L lower (row-major, ld): 32-row tiles; the rows of
// a tile first subtract the solved part (warp per row), then warp 0 solves
// the tile's diagonal block. Every thread of the block must call it.
template <typename T>
__device__ void tri_lower_solve(const T* L, long long ld, T* v, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = 0; i0 < m; i0 += 32) {
    const int t = min(32, m - i0);
    if (i0) sub_matvec(v + i0, L + (long long)i0 * ld, ld, v, t, i0);
    __syncthreads();
    if (warp == 0) {
      const T* Lt = L + (long long)i0 * ld + i0;
      T vi = lane < t ? v[i0 + lane] : T(0);
      for (int j = 0; j < t; ++j) {
        if (lane == j) vi = vi / Lt[(long long)j * ld + j];
        const T vj = __shfl_sync(0xffffffffu, vi, j);
        if (lane > j && lane < t) vi -= Lt[(long long)lane * ld + j] * vj;
      }
      if (lane < t) v[i0 + lane] = vi;
    }
    __syncthreads();
  }
}

// v[0:m] <- L^-T v, the same tiles from the bottom up.
template <typename T>
__device__ void tri_lower_t_solve(const T* L, long long ld, T* v, int m, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = ((m - 1) / 32) * 32; i0 >= 0; i0 -= 32) {
    const int t = min(32, m - i0), i1 = i0 + t;
    if (i1 < m) sub_matvec_t(v + i0, L + (long long)i1 * ld + i0, ld, v + i1, m - i1, t, red);
    __syncthreads();
    if (warp == 0) {
      const T* Lt = L + (long long)i0 * ld + i0;
      T vi = lane < t ? v[i0 + lane] : T(0);
      for (int j = t - 1; j >= 0; --j) {
        if (lane == j) vi = vi / Lt[(long long)j * ld + j];
        const T vj = __shfl_sync(0xffffffffu, vi, j);
        if (lane < j) vi -= Lt[(long long)j * ld + lane] * vj;
      }
      if (lane < t) v[i0 + lane] = vi;
    }
    __syncthreads();
  }
}

}  // namespace tgdense
}  // namespace
