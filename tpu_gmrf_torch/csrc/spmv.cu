// K4 csr_spmv: batched CSR sparse matrix-vector product y = A x over one
// static pattern, with the quadratic form x^T A x fused in.
//
// Replaces (JAX reference, tpu_gmrf/): sparse/matrix.py:58-65
// `SparseMatrix.matvec` (a COO gather + segment-sum, for any shape) and
// sparse/matrix.py:81-84 `SparseMatrix.quad` (a gather-product-sum over the
// entries, square patterns only).
//
// What bounds it on the card: 2 flops per stored entry against 8-16 bytes of
// data per entry plus the x gathers, i.e. far below the ridge point; it is a
// memory-bound stream of the (B, nnz) data. At the flagship shape (B=256,
// n=500, nnz=1498) that stream is 1.5-3 MB, so one launch is dominated by its
// fixed latency rather than by HBM bandwidth.
//
// Design: CUDA rather than Triton, so that all four kernels share one nvcc
// build and one loading path. A is n_r x n_c: y has n_r rows and x n_c. One
// block per chain: the block stages the chain's x row (n_c) into shared memory
// (coalesced), so the column gathers of every row hit shared memory instead of
// global memory; each thread owns rows r = tid, tid + blockDim, ... < n_r and
// walks its CSR row segment. Rows are already sorted because the COO pattern
// is canonically (row, col) sorted, so the canonical data order is the CSR
// order and no permutation is needed. data is either shared by all chains
// (data_stride = 0) or one row per chain. With the quadratic form (template
// parameter kQuad, so the plain product carries no branch and no x_r read for
// it) the block also reduces x_r * y_r over its rows (warp shuffles, then one
// value per warp in shared memory) and writes one x^T A x per chain; no
// atomics, so the result is deterministic. The quadratic form needs a square
// pattern (n_r = n_c); the wrapper refuses any other.
//
// A chain's x that does not fit the 48 KB of shared memory a launch gets
// without an opt-in, or a batch of too few chains to fill the card, takes the
// tiled path instead: the grid runs over (row tile of the n_r rows, chain), one
// thread per row, x read from global memory (it stays in L2: one chain's x is
// at most a few hundred KB). The quadratic form is then reduced in two passes,
// still without atomics: each block writes its partial sum, and a second small
// kernel adds a chain's partials in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool kQuad>
__global__ void csr_spmv_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                                const T* __restrict__ data, long long data_stride,
                                const T* __restrict__ x, T* __restrict__ y,
                                T* __restrict__ quad, int n_r, int n_c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // n_c
  T* swarp = sx + n_c;                     // kThreads / 32
  const long long b = blockIdx.x;
  const T* xb = x + b * n_c;
  for (int i = threadIdx.x; i < n_c; i += blockDim.x) sx[i] = xb[i];
  __syncthreads();
  const T* db = data + b * data_stride;
  T acc = T(0);
  for (int r = threadIdx.x; r < n_r; r += blockDim.x) {
    T s = T(0);
    const int end = row_ptr[r + 1];
    for (int p = row_ptr[r]; p < end; ++p) s += db[p] * sx[col[p]];
    y[b * n_r + r] = s;
    if (kQuad) acc += sx[r] * s;
  }
  if (!kQuad) return;
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) swarp[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += swarp[w];
    quad[b] = total;
  }
}

// The tiled path: block (tile, chain) owns rows tile * kThreads ..., one
// thread per row; partial[chain * tiles + tile] = sum of x_r y_r over the tile.
template <typename T, bool kQuad>
__global__ void __launch_bounds__(kThreads)
    csr_spmv_tiled_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                          const T* __restrict__ data, long long data_stride, const T* __restrict__ x,
                          T* __restrict__ y, T* __restrict__ partial, int n_r, int n_c) {
  __shared__ T swarp[kThreads / 32];
  const long long b = blockIdx.y;
  const T* xb = x + b * n_c;
  const T* db = data + b * data_stride;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  T acc = T(0);
  if (r < n_r) {
    T s = T(0);
    const int end = row_ptr[r + 1];
    for (int p = row_ptr[r]; p < end; ++p) s += db[p] * xb[col[p]];
    y[b * n_r + r] = s;
    if (kQuad) acc = xb[r] * s;
  }
  if (!kQuad) return;
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
    for (int w = 0; w < kThreads / 32; ++w) total += swarp[w];
    partial[b * gridDim.x + blockIdx.x] = total;
  }
}

// quad[chain] = sum of the chain's `tiles` partials, in order (one warp per chain).
template <typename T>
__global__ void quad_sum_kernel(const T* __restrict__ partial, T* __restrict__ quad, int tiles) {
  const long long b = blockIdx.x;
  T acc = T(0);
  for (int t = threadIdx.x; t < tiles; t += 32) acc += partial[b * tiles + t];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (threadIdx.x == 0) quad[b] = acc;
}

template <typename T, bool kQuad>
int launch_paths(const int* row_ptr, const int* col, const T* data, long long data_stride, const T* x, T* y,
                 T* quad, int B, int n_r, int n_c, int tiled, T* partial, cudaStream_t st) {
  if (!tiled) {
    size_t smem = sizeof(T) * ((size_t)n_c + kThreads / 32);
    csr_spmv_kernel<T, kQuad><<<B, kThreads, smem, st>>>(row_ptr, col, data, data_stride, x, y, quad, n_r, n_c);
    return (int)cudaGetLastError();
  }
  const int tiles = (n_r + kThreads - 1) / kThreads;
  csr_spmv_tiled_kernel<T, kQuad><<<dim3(tiles, B), kThreads, 0, st>>>(row_ptr, col, data, data_stride, x, y,
                                                                       partial, n_r, n_c);
  int rc = (int)cudaGetLastError();
  if (rc || !kQuad) return rc;
  quad_sum_kernel<T><<<B, 32, 0, st>>>(partial, quad, tiles);
  return (int)cudaGetLastError();
}

// `tiled` != 0 takes the tiled path; `partial` is then its (B, tiles)
// workspace, tiles = ceil(n_r / kThreads), needed only with quad. quad needs
// n_r == n_c.
template <typename T>
int launch_spmv(const int* row_ptr, const int* col, const T* data, long long data_stride, const T* x,
                T* y, T* quad, int B, int n_r, int n_c, int tiled, T* partial, void* stream) {
  if (B == 0 || n_r == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (quad == nullptr)
    return launch_paths<T, false>(row_ptr, col, data, data_stride, x, y, nullptr, B, n_r, n_c, tiled, nullptr, st);
  if (n_r != n_c || (tiled && partial == nullptr)) return (int)cudaErrorInvalidValue;
  return launch_paths<T, true>(row_ptr, col, data, data_stride, x, y, quad, B, n_r, n_c, tiled, partial, st);
}

}  // namespace

extern "C" {

int tg_csr_spmv_f32(const int* row_ptr, const int* col, const float* data, long long data_stride,
                    const float* x, float* y, float* quad, int B, int n_r, int n_c, int tiled, float* partial,
                    void* stream) {
  return launch_spmv<float>(row_ptr, col, data, data_stride, x, y, quad, B, n_r, n_c, tiled, partial, stream);
}
int tg_csr_spmv_f64(const int* row_ptr, const int* col, const double* data, long long data_stride,
                    const double* x, double* y, double* quad, int B, int n_r, int n_c, int tiled, double* partial,
                    void* stream) {
  return launch_spmv<double>(row_ptr, col, data, data_stride, x, y, quad, B, n_r, n_c, tiled, partial, stream);
}

}  // extern "C"
