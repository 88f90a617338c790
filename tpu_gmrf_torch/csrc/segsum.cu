// K5 gather_segsum: batched gather-product segment sum over a static plan,
//
//   out[b, t[r]] (= or +=) alpha * sum_{k in [ptr[r], ptr[r+1])} x[b, xi[k]] * (y[b, yi[k]] or 1)
//                                                                           * (z[b, zi[k]] or 1)
//
// with t[r] = r when t == nullptr.
//
// Replaces (JAX reference, tpu_gmrf/): sparse/matrix.py:114 `pad_to`,
// :158 `sp_add` and :173 `sp_matmul` (gather-product + segment_sum, and its
// AD transpose); solvers/supernodal.py:848 `_ell_apply` / :871
// `_ell_apply_exact` (the two-tier ELL Schur and forward-solve reductions),
// and the permutation, logdet and selected-inverse gathers with the Jacobi
// scaling undone of :1068, :1073, :1339, :1356 and :1386 (the scaling s
// enters as the y and z factors).
//
// K5's second entry, fct_init, replaces solvers/supernodal.py:931
// `_fct_init`: symmetrize the stored triangles, Jacobi-equilibrate and
// scatter A's lower entries onto the fill pattern, per chain b:
//
//   s[b, i]         = d_i > 0 ? 1 / sqrt(d_i) : 1,  d_i = (a[diag[i]] + a[tperm[diag[i]]]) / 2
//   nls[b, i]       = -log s[b, i]                  (the logdet's share of s)
//   vals[b, dst[k]] = (a[src[k]] + a[tperm[src[k]]]) / 2 * s[rows[src[k]]] * s[cols[src[k]]]
//
// Every thread recomputes the two scalings it needs from the diagonal, so
// one launch does all three and no thread waits on another.
//
// What bounds it on the card: one to three gathered loads per term and one
// store per row, far below the ridge point; on the solver's paths a call
// moves a few MB, so what it costs is its launch. The design keeps every
// write unique: a plan groups the terms of one output by row on the host,
// once per pattern (a supernodal level's two ELL tiers are one ragged plan,
// a row per target), so no value is written by atomics and the result is
// deterministic; a row may come in two parts applied in turn (a level's
// tier-1 and tier-2 contributions keep the reference's rounding). The
// plan's rows come in two runs (kernels/segsum.py BLOCK_TERMS sorts them):
//   rows of < 256 terms (every row of the supernodal levels, the SpGEMMs,
//       `sp_add` and the gathers): a thread per row, summing in the
//       output's type in the plain version's order (summed in float64
//       instead, phase 7's f32 value+grad took one more Newton iteration
//       on the H100);
//   rows of >= 256 terms (the logdet's 2n terms, selinv_dot's nnz): chunks
//       of at most 2048 terms (CHUNK_TERMS there) within one part, a block
//       each, the threads along the terms, each warp's sums reduced by
//       shuffles and the warps' sums added in their order into a partial
//       per chunk, in float64; the row's last chunk to finish (a ticket per
//       row, the only atomic) adds the row's partials in chunk order and
//       rounds the sum once, as the plain version does, so a long row
//       spreads over the card and the sum is the same on every run.
// A thread carries a group of up to kGroup chains in registers, so each
// row's ptr, t and index entries are read once per group, not once per
// chain. A chain stride of 0 broadcasts x, y or z over the chains.
// fct_init groups its chains the same way, a thread per entry.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;  // chains per thread

// The plan's device tables (kernels/segsum.py packs them once per plan and
// device): rows [0, r_block) a thread each, [r_block, rows) in chunks. With
// `mid`, row r's terms are two parts, [ptr[r], mid[r]) and [mid[r],
// ptr[r+1]), applied in turn: out = (out + alpha sum_1) + alpha sum_2 (a
// supernodal level's tier 1 and tier 2, in the reference's order). Chunk c
// holds the terms [ck[c], ck[c+1]) of long row r_block + crow[c]; long row j
// has the chunks [cptr[j], cptr[j+1]), its second part from cmid[j]. part
// (chain groups x chunks x kGroup) and count (chain groups x long rows,
// zero between launches) are the chunks' scratch.
struct Plan {
  const int* t;
  const int* ptr;
  const int* xi;
  const int* yi;
  const int* zi;
  const int* mid;
  const int* ck;
  const int* crow;
  const int* cptr;
  const int* cmid;
  double* part;
  int* count;
  int r_block, rows, chunks;
};

// One call's operands, offset to the chain group's first chain; F factors per term (x, x y or x y z).
template <typename T, int F>
struct Terms {
  const int *xi, *yi, *zi;
  const T *x, *y, *z;
  long long xs, ys, zs;
  int nb;  // chains in this group

  // acc[g] = the sum of the terms k0, k0 + step, ... below k1 for chain g, in type A
  template <typename A>
  __device__ __forceinline__ void sum(long long k0, long long k1, int step, A (&acc)[kGroup]) const {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc[g] = A(0);
    for (long long k = k0; k < k1; k += step) {
      const int a = xi[k];
      const int b = F > 1 ? yi[k] : 0, c = F > 2 ? zi[k] : 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (g < nb) {
          T v = x[g * xs + a];
          if (F > 1) v *= y[g * ys + b];
          if (F > 2) v *= z[g * zs + c];
          acc[g] += A(v);
        }
    }
  }
};

template <typename T, int F>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(Plan p, T* __restrict__ out, long long os, Terms<T, F> tm, T alpha, int accumulate, int B) {
  const int b0 = blockIdx.y * kGroup, tid = threadIdx.x, lane = tid & 31;
  tm.nb = min(kGroup, B - b0);
  tm.x += b0 * tm.xs;
  if (F > 1) tm.y += b0 * tm.ys;
  if (F > 2) tm.z += b0 * tm.zs;
  out += b0 * os;
  const int nthread = (p.r_block + kThreads - 1) / kThreads;
  if ((int)blockIdx.x < nthread) {  // a thread per row, holding its chains' outputs in v
    const int r = blockIdx.x * kThreads + tid;
    if (r >= p.r_block) return;
    const int tr = p.t ? p.t[r] : r;
    const long long k0 = p.ptr[r], k2 = p.ptr[r + 1], k1 = p.mid ? p.mid[r] : k2;
    T v[kGroup], acc[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) v[g] = accumulate && g < tm.nb ? out[g * os + tr] : T(0);
    tm.sum(k0, k1, 1, acc);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) v[g] = v[g] + alpha * acc[g];
    if (k1 < k2) {
      tm.sum(k1, k2, 1, acc);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) v[g] = v[g] + alpha * acc[g];
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < tm.nb) out[g * os + tr] = v[g];
    return;
  }
  // a block per chunk of a long row: thread g < kGroup ends with chain g's partial, kept in p.part
  const int c = blockIdx.x - nthread, j = p.crow[c], nlong = p.rows - p.r_block;
  __shared__ double red[kWarps][kGroup];
  __shared__ int last;
  double acc[kGroup];
  tm.sum(p.ck[c] + tid, p.ck[c + 1], kThreads, acc);
#pragma unroll
  for (int h = 0; h < kGroup; ++h) {
#pragma unroll
    for (int o = 16; o; o >>= 1) acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], o);
    if (lane == 0) red[tid >> 5][h] = acc[h];
  }
  __syncthreads();
  double* part = p.part + (long long)blockIdx.y * p.chunks * kGroup;
  if (tid < kGroup) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    part[c * kGroup + tid] = s;
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  const int c0 = p.cptr[j], c2 = p.cptr[j + 1], c1 = p.cmid ? p.cmid[j] : c2;
  int* ticket = p.count + (long long)blockIdx.y * nlong + j;
  if (tid == 0) last = atomicAdd(ticket, 1) == c2 - c0 - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < tm.nb) {  // the row's last chunk: its parts' partials in chunk order
    const int r = p.r_block + j, tr = p.t ? p.t[r] : r;
    T v = accumulate ? out[tid * os + tr] : T(0);
    double s = 0.0;
    for (int i = c0; i < c1; ++i) s += __ldcg(part + i * kGroup + tid);
    v = v + alpha * T(s);
    if (c1 < c2) {
      s = 0.0;
      for (int i = c1; i < c2; ++i) s += __ldcg(part + i * kGroup + tid);
      v = v + alpha * T(s);
    }
    out[tid * os + tr] = v;
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

template <typename T>
__device__ __forceinline__ T jacobi(const T* __restrict__ ab, const int* __restrict__ diag,
                                    const int* __restrict__ tperm, int i) {
  const int p = diag[i];
  const T d = T(0.5) * (ab[p] + ab[tperm[p]]);
  return d > T(0) ? T(1) / sqrt(d) : T(1);
}

// A thread per entry r, for the chain group's up to kGroup chains: its index entries are read once.
template <typename T>
__global__ void fct_init_kernel(T* __restrict__ vals, long long vals_stride, T* __restrict__ s,
                                T* __restrict__ nls, long long nls_stride, const T* __restrict__ a,
                                long long a_stride, const int* __restrict__ tperm,
                                const int* __restrict__ diag, const int* __restrict__ rows,
                                const int* __restrict__ cols, const int* __restrict__ src,
                                const int* __restrict__ dst, int n, int m, int B) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b0 = blockIdx.y * kGroup;
  const int nb = min(kGroup, B - (int)b0);
  if (r < n) {
    const int p = diag[r], pt = tperm[p];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < nb) {
        const T* ab = a + (b0 + g) * a_stride;
        const T d = T(0.5) * (ab[p] + ab[pt]);
        const T si = d > T(0) ? T(1) / sqrt(d) : T(1);
        s[(b0 + g) * n + r] = si;
        nls[(b0 + g) * nls_stride + r] = -log(si);
      }
  }
  if (r < m) {
    const int p = src[r], pt = tperm[p], q = dst[r], i = rows[p], j = cols[p];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (g < nb) {
        const T* ab = a + (b0 + g) * a_stride;
        const T v = T(0.5) * (ab[p] + ab[pt]);
        vals[(b0 + g) * vals_stride + q] = v * jacobi(ab, diag, tperm, i) * jacobi(ab, diag, tperm, j);
      }
  }
}

template <typename T, int F>
int launch_f(const Plan& p, T* out, long long os, const T* x, long long xs, const T* y, long long ys, const T* z,
             long long zs, double alpha, int accumulate, int B, cudaStream_t st) {
  const int blocks = (p.r_block + kThreads - 1) / kThreads + p.chunks;
  Terms<T, F> tm{p.xi, p.yi, p.zi, x, y, z, xs, ys, zs, 0};
  segsum_kernel<T, F><<<dim3(blocks, (B + kGroup - 1) / kGroup), kThreads, 0, st>>>(p, out, os, tm, (T)alpha,
                                                                                    accumulate, B);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* plan, T* out, long long os, const T* x, long long xs, const T* y, long long ys, const T* z,
           long long zs, double alpha, int accumulate, int B, void* stream) {
  const Plan* p = static_cast<const Plan*>(plan);
  if (p->rows == 0 || B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (z) return launch_f<T, 3>(*p, out, os, x, xs, y, ys, z, zs, alpha, accumulate, B, st);
  if (y) return launch_f<T, 2>(*p, out, os, x, xs, y, ys, z, zs, alpha, accumulate, B, st);
  return launch_f<T, 1>(*p, out, os, x, xs, y, ys, z, zs, alpha, accumulate, B, st);
}

template <typename T>
int launch_fct_init(T* vals, long long vals_stride, T* s, T* nls, long long nls_stride, const T* a,
                    long long a_stride, const int* tperm, const int* diag, const int* rows,
                    const int* cols, const int* src, const int* dst, int n, int m, int B,
                    void* stream) {
  const int R = n > m ? n : m;
  if (R == 0 || B == 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads, (B + kGroup - 1) / kGroup);
  fct_init_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      vals, vals_stride, s, nls, nls_stride, a, a_stride, tperm, diag, rows, cols, src, dst, n, m, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_SEGSUM(SUFFIX, T)                                                                       \
  int tg_gather_segsum_##SUFFIX(const void* plan, T* out, long long out_stride, const T* x,        \
                                long long x_stride, const T* y, long long y_stride, const T* z,    \
                                long long z_stride, double alpha, int accumulate, int B,           \
                                void* stream) {                                                    \
    return launch<T>(plan, out, out_stride, x, x_stride, y, y_stride, z, z_stride, alpha,          \
                     accumulate, B, stream);                                                       \
  }                                                                                                \
  int tg_fct_init_##SUFFIX(T* vals, long long vals_stride, T* s, T* nls, long long nls_stride,     \
                           const T* a, long long a_stride, const int* tperm, const int* diag,      \
                           const int* rows, const int* cols, const int* src, const int* dst,       \
                           int n, int m, int B, void* stream) {                                    \
    return launch_fct_init<T>(vals, vals_stride, s, nls, nls_stride, a, a_stride, tperm, diag,     \
                              rows, cols, src, dst, n, m, B, stream);                              \
  }

TG_SEGSUM(f32, float)
TG_SEGSUM(f64, double)

#undef TG_SEGSUM

}  // extern "C"
