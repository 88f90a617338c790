// K14 bsr_spmm and K15 bsr_outer: the block-sparse-row product y = A x with
// several vectors, its transposed form, and the gradient of the blocks.
//
// Replaces (JAX reference, tpu_gmrf/kernels/bsr_spmv.py):
//   K14 :182-189 `_spmv_reference` as called by :197-208 `_spmv_impl` /
//       `bsr_spmv` (pad x, gather the column blocks of x, one batched
//       (bs, bs) x (bs, k) product per stored block, segment-sum over block
//       rows, trim y), and the dX = A^T g half of :215-219 `_spmv_bwd` (the
//       same product over the transposed plan on permuted, transposed
//       blocks);
//   K15 the other half of `_spmv_bwd`, :220-228: dBlocks[b] =
//       g[rowblock(b)] x[colblock(b)]^T summed over the vectors.
//
// Layout. blocks (nblocks, bs, bs) row-major, stored in block-row order with
// `rowptr` (nb+1) and `bcols` (nblocks); bs is 8, 16 or 32. Vectors are rows:
// x and y are (R, n), one vector per row. blocks may be shared by all rows
// (block_stride = 0) or one set per row (one matrix per chain). n need not be
// a multiple of bs: columns beyond n read as zero and rows beyond n are not
// written, so x is not padded and y is not trimmed.
//
// What bounds them on the card. 2 bs^2 R flops per stored block against
// bs^2 values: with R <= 8 vectors K14 is a stream of the blocks plus
// gathers of bs-long pieces of x; bound by bytes. K15 writes bs^2 values per
// block from 2 bs R reads: bound by that write.
// Design. K14: one thread per output element (block row, vector, row in
// block), walking the block row's stored blocks and accumulating in a
// register; a row of y has one owner, so there are no atomics, no
// segment-sum pass, and the result is deterministic. The threads of a warp
// share a block row, so the block's values and the x piece come through L1.
// With `tperm` the product is with A^T: the tables are the transposed
// plan's, stored block p of that plan is blocks[tperm[p]] read transposed,
// so no permuted, transposed copy of the blocks is made. K15: one block of
// threads per stored block, one thread per entry, summing over the vectors
// (or, with one matrix per chain, one product per chain).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(const T* __restrict__ blocks, long long block_stride, const int* __restrict__ rowptr,
                    const int* __restrict__ bcols, const int* __restrict__ tperm, int bs, int nb, int n,
                    const T* __restrict__ x, T* __restrict__ y, int R) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_row = (long long)bs * R;
  if (e >= per_row * nb) return;
  const int br = (int)(e / per_row);
  const int c = (int)((e % per_row) / bs), i = (int)(e % bs);
  const int row = br * bs + i;
  if (row >= n) return;
  const T* blk0 = blocks + c * block_stride;
  const T* xc = x + (long long)c * n;
  T acc = T(0);
  const int end = rowptr[br + 1];
  for (int p = rowptr[br]; p < end; ++p) {
    const int col0 = bcols[p] * bs;
    const int jn = min(bs, n - col0);
    if (tperm) {
      const T* blk = blk0 + (long long)tperm[p] * bs * bs + i;
      for (int j = 0; j < jn; ++j) acc += blk[(long long)j * bs] * xc[col0 + j];
    } else {
      const T* blk = blk0 + ((long long)p * bs + i) * bs;
      for (int j = 0; j < jn; ++j) acc += blk[j] * xc[col0 + j];
    }
  }
  y[(long long)c * n + row] = acc;
}

// dblocks[b][i][j] = sum over the R rows c of g[c][rb bs + i] x[c][cb bs + j]
// (per_chain == 0), or, per chain c = blockIdx.y, that one product
// (dblocks (R, nblocks, bs, bs)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bsr_outer_kernel(const int* __restrict__ brows, const int* __restrict__ bcols, int bs, int n,
                     const T* __restrict__ g, const T* __restrict__ x, int R, int per_chain,
                     T* __restrict__ dblocks) {
  const long long b = blockIdx.x;
  const int r0 = brows[b] * bs, c0 = bcols[b] * bs;
  const int first = per_chain ? blockIdx.y : 0, last = per_chain ? blockIdx.y + 1 : R;
  T* out = dblocks + ((per_chain ? (long long)blockIdx.y * gridDim.x : 0) + b) * bs * bs;
  for (int e = threadIdx.x; e < bs * bs; e += blockDim.x) {
    const int gi = r0 + e / bs, xj = c0 + e % bs;
    T acc = T(0);
    if (gi < n && xj < n)
      for (int c = first; c < last; ++c) acc += g[(long long)c * n + gi] * x[(long long)c * n + xj];
    out[e] = acc;
  }
}

template <typename T>
int launch_spmm(const T* blocks, long long block_stride, const int* rowptr, const int* bcols, const int* tperm,
                int bs, int nb, int n, const T* x, T* y, int R, void* stream) {
  const long long total = (long long)bs * R * nb;
  if (total == 0) return 0;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  bsr_spmm_kernel<T><<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(blocks, block_stride, rowptr, bcols,
                                                                            tperm, bs, nb, n, x, y, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_outer(const int* brows, const int* bcols, int nblocks, int bs, int n, const T* g, const T* x, int R,
                 int per_chain, T* dblocks, void* stream) {
  if (nblocks == 0 || R == 0) return 0;
  if (per_chain && R > 65535) return (int)cudaErrorInvalidValue;
  bsr_outer_kernel<T><<<dim3(nblocks, per_chain ? R : 1), kThreads, 0, (cudaStream_t)stream>>>(
      brows, bcols, bs, n, g, x, R, per_chain, dblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_BSR_ENTRY(SUF, T)                                                                                  \
  int tg_bsr_spmm_##SUF(const T* blocks, long long block_stride, const int* rowptr, const int* bcols,         \
                        const int* tperm, int bs, int nb, int n, const T* x, T* y, int R, void* stream) {     \
    return launch_spmm<T>(blocks, block_stride, rowptr, bcols, tperm, bs, nb, n, x, y, R, stream);            \
  }                                                                                                           \
  int tg_bsr_outer_##SUF(const int* brows, const int* bcols, int nblocks, int bs, int n, const T* g,          \
                         const T* x, int R, int per_chain, T* dblocks, void* stream) {                        \
    return launch_outer<T>(brows, bcols, nblocks, bs, n, g, x, R, per_chain, dblocks, stream);                \
  }

TG_BSR_ENTRY(f32, float)
TG_BSR_ENTRY(f64, double)

#undef TG_BSR_ENTRY

}  // extern "C"
