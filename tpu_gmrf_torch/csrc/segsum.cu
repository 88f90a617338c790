// K5 gather_segsum: batched gather-product segment sum over a static plan,
//
//   out[b, t[r]] (= or +=) alpha * sum_{k in seg(r)} x[b, xi[k]] * (y[b, yi[k]] or 1)
//                                                                * (z[b, zi[k]] or 1)
//
// with seg(r) = [ptr[r], ptr[r+1]) (CSR segments) or [r*w, (r+1)*w) (fixed
// width ELL rows, ptr == nullptr), and t[r] = r when t == nullptr.
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
// store per row: a pure memory stream with random gathers, far below the
// ridge point. The design keeps every write unique: a plan groups the terms
// of one output by row on the host, once per pattern, so no atomics are
// needed and the result is deterministic. One thread per (row, chain);
// rows run along x so neighbouring threads read neighbouring index entries
// (coalesced plan reads); the gathers of x, y and z are the random part.
// A chain stride of 0 broadcasts x, y or z over the chains.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void segsum_kernel(T* __restrict__ out, long long out_stride, const int* __restrict__ t,
                              const int* __restrict__ ptr, int width, const int* __restrict__ xi,
                              const T* __restrict__ x, long long x_stride, const int* __restrict__ yi,
                              const T* __restrict__ y, long long y_stride, const int* __restrict__ zi,
                              const T* __restrict__ z, long long z_stride, T alpha, int accumulate,
                              int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long b = blockIdx.y;
  const long long k0 = ptr ? ptr[r] : (long long)r * width;
  const long long k1 = ptr ? ptr[r + 1] : k0 + width;
  const T* xb = x + b * x_stride;
  T s = T(0);
  if (z) {
    const T* yb = y + b * y_stride;
    const T* zb = z + b * z_stride;
    for (long long k = k0; k < k1; ++k) s += xb[xi[k]] * yb[yi[k]] * zb[zi[k]];
  } else if (y) {
    const T* yb = y + b * y_stride;
    for (long long k = k0; k < k1; ++k) s += xb[xi[k]] * yb[yi[k]];
  } else {
    for (long long k = k0; k < k1; ++k) s += xb[xi[k]];
  }
  T* o = out + b * out_stride + (t ? t[r] : r);
  *o = accumulate ? *o + alpha * s : alpha * s;
}

template <typename T>
__device__ __forceinline__ T jacobi(const T* __restrict__ ab, const int* __restrict__ diag,
                                    const int* __restrict__ tperm, int i) {
  const int p = diag[i];
  const T d = T(0.5) * (ab[p] + ab[tperm[p]]);
  return d > T(0) ? T(1) / sqrt(d) : T(1);
}

template <typename T>
__global__ void fct_init_kernel(T* __restrict__ vals, long long vals_stride, T* __restrict__ s,
                                T* __restrict__ nls, long long nls_stride, const T* __restrict__ a,
                                long long a_stride, const int* __restrict__ tperm,
                                const int* __restrict__ diag, const int* __restrict__ rows,
                                const int* __restrict__ cols, const int* __restrict__ src,
                                const int* __restrict__ dst, int n, int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = blockIdx.y;
  const T* ab = a + b * a_stride;
  if (r < n) {
    const T si = jacobi(ab, diag, tperm, r);
    s[b * n + r] = si;
    nls[b * nls_stride + r] = -log(si);
  }
  if (r < m) {
    const int p = src[r];
    const T v = T(0.5) * (ab[p] + ab[tperm[p]]);
    vals[b * vals_stride + dst[r]] = v * jacobi(ab, diag, tperm, rows[p]) * jacobi(ab, diag, tperm, cols[p]);
  }
}

template <typename T>
int launch(T* out, long long out_stride, const int* t, const int* ptr, int width, const int* xi,
           const T* x, long long x_stride, const int* yi, const T* y, long long y_stride,
           const int* zi, const T* z, long long z_stride, double alpha, int accumulate, int R, int B,
           void* stream) {
  if (R == 0 || B == 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads, B);
  segsum_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      out, out_stride, t, ptr, width, xi, x, x_stride, yi, y, y_stride, zi, z, z_stride, (T)alpha,
      accumulate, R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fct_init(T* vals, long long vals_stride, T* s, T* nls, long long nls_stride, const T* a,
                    long long a_stride, const int* tperm, const int* diag, const int* rows,
                    const int* cols, const int* src, const int* dst, int n, int m, int B,
                    void* stream) {
  const int R = n > m ? n : m;
  if (R == 0 || B == 0) return 0;
  dim3 grid((R + kThreads - 1) / kThreads, B);
  fct_init_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      vals, vals_stride, s, nls, nls_stride, a, a_stride, tperm, diag, rows, cols, src, dst, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_SEGSUM(SUFFIX, T)                                                                       \
  int tg_gather_segsum_##SUFFIX(T* out, long long out_stride, const int* t, const int* ptr,        \
                                int width, const int* xi, const T* x, long long x_stride,          \
                                const int* yi, const T* y, long long y_stride, const int* zi,      \
                                const T* z, long long z_stride, double alpha, int accumulate,      \
                                int R, int B, void* stream) {                                      \
    return launch<T>(out, out_stride, t, ptr, width, xi, x, x_stride, yi, y, y_stride, zi, z,      \
                     z_stride, alpha, accumulate, R, B, stream);                                   \
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
