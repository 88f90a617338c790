// K4 csr_spmv: batched CSR sparse matrix-vector product y = A x over one
// static pattern, with the quadratic form x^T A x fused in.
//
// Replaces (JAX reference, tpu_gmrf/): sparse/matrix.py:58-65
// `SparseMatrix.matvec` (a COO gather + segment-sum) and sparse/matrix.py:81-84
// `SparseMatrix.quad` (a gather-product-sum over the entries).
//
// What bounds it on the card: 2 flops per stored entry against 8-16 bytes of
// data per entry plus the x gathers, i.e. far below the ridge point; it is a
// memory-bound stream of the (B, nnz) data. At the flagship shape (B=256,
// n=500, nnz=1498) that stream is 1.5-3 MB, so one launch is dominated by its
// fixed latency rather than by HBM bandwidth.
//
// Design: CUDA rather than Triton, so that all four kernels share one nvcc
// build and one loading path. One block per chain: the block stages the
// chain's x row into shared memory (coalesced), so the column gathers of
// every row hit shared memory instead of global memory; each thread owns
// rows r = tid, tid + blockDim, ... and walks its CSR row segment. Rows are
// already sorted because the COO pattern is canonically (row, col) sorted,
// so the canonical data order is the CSR order and no permutation is
// needed. data is either shared by all chains (data_stride = 0) or one row
// per chain. With quad != nullptr the block also reduces x_r * y_r over its
// rows (warp shuffles, then one value per warp in shared memory) and writes
// one x^T A x per chain; no atomics, so the result is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void csr_spmv_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                                const T* __restrict__ data, long long data_stride,
                                const T* __restrict__ x, T* __restrict__ y,
                                T* __restrict__ quad, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);  // n
  T* swarp = sx + n;                       // kThreads / 32
  const long b = blockIdx.x;
  const T* xb = x + b * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) sx[i] = xb[i];
  __syncthreads();
  const T* db = data + b * data_stride;
  T acc = T(0);
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    T s = T(0);
    const int end = row_ptr[r + 1];
    for (int p = row_ptr[r]; p < end; ++p) s += db[p] * sx[col[p]];
    y[b * n + r] = s;
    acc += sx[r] * s;
  }
  if (quad == nullptr) return;
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

template <typename T>
int launch_spmv(const int* row_ptr, const int* col, const T* data, long long data_stride, const T* x,
                T* y, T* quad, int B, int n, void* stream) {
  size_t smem = sizeof(T) * ((size_t)n + kThreads / 32);
  csr_spmv_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(row_ptr, col, data,
                                                                  data_stride, x, y, quad, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tg_csr_spmv_f32(const int* row_ptr, const int* col, const float* data, long long data_stride,
                    const float* x, float* y, float* quad, int B, int n, void* stream) {
  return launch_spmv<float>(row_ptr, col, data, data_stride, x, y, quad, B, n, stream);
}
int tg_csr_spmv_f64(const int* row_ptr, const int* col, const double* data, long long data_stride,
                    const double* x, double* y, double* quad, int B, int n, void* stream) {
  return launch_spmv<double>(row_ptr, col, data, data_stride, x, y, quad, B, n, stream);
}

}  // extern "C"
