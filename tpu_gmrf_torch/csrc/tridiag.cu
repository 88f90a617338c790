// Batched tridiagonal kernels K1-K3: bidiagonal Cholesky with logdet,
// triangular solves, and the Takahashi selected inverse.
//
// Replaces (JAX reference, tpu_gmrf/):
//   K1 tridiag_factor  solvers/prefix.py:53 `mobius_recurrence` as used by
//                      solvers/tridiag.py:102-129 `tridiag_factorize`, and
//                      solvers/tridiag.py:67-68 `TridiagFactor.logdet`.
//   K2 tridiag_solve   solvers/prefix.py:33 `linear_recurrence` as used by
//                      solvers/tridiag.py:44-59 (forward/backward/solve).
//   K3 tridiag_selinv  solvers/tridiag.py:70-81 `selinv_tridiag`, the
//                      reverse `linear_recurrence`.
//
// What bounds them on the card: each chain is a length-n first-order
// recurrence, so the work per chain is O(n) flops on a strictly sequential
// dependency chain. At the flagship shape (B=256 chains, n=500) the whole
// batch moves ~1-3 MB, i.e. well under a microsecond of HBM time; the bound
// is the latency of n dependent divide/sqrt steps in one thread plus the
// launch itself. The TPU reference traded that latency for O(n log n) work
// through associative scans because its vector unit is wide and in order.
//
// Design: one block per chain. The block stages the chain's rows into shared
// memory with coalesced loads, one thread runs the recurrence out of shared
// memory (no global-memory latency inside the dependent chain), and the
// block writes the results back coalesced. 256 chains give 256 blocks, about
// two per SM. Nothing is allocated here; the wrapper allocates every output
// and checks that the rows fit the 48 KB of static-launch shared memory.
// Each entry point launches on the given stream and returns
// cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

template <typename T>
__device__ __forceinline__ T dev_sqrt(T x);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T dev_log(T x);
template <>
__device__ __forceinline__ float dev_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double dev_log<double>(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ void load_row(T* dst, const T* src, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

template <typename T>
__device__ __forceinline__ void store_row(T* dst, const T* src, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// K1. Pivots delta_k = a_k - c_{k-1}^2 / delta_{k-1}, d = sqrt(delta),
// e_k = c_k / d_k, logdet = 2 sum log d. A non-positive pivot gives a NaN
// (or -inf) logdet exactly as the reference does: no clamping, because a
// NaN is how a chain rejects downstream.
template <typename T>
__global__ void tridiag_factor_kernel(const T* __restrict__ a, const T* __restrict__ c,
                                      T* __restrict__ d, T* __restrict__ e,
                                      T* __restrict__ logdet, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sa = reinterpret_cast<T*>(smem_raw);  // a, overwritten by d
  T* sc = sa + n;                          // c, overwritten by e
  const long b = blockIdx.x;
  load_row(sa, a + b * n, n);
  load_row(sc, c + b * (n - 1), n - 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    T delta = sa[0];
    T dk = dev_sqrt(delta);
    T acc = dev_log(dk);
    sa[0] = dk;
    for (int k = 1; k < n; ++k) {
      const T ck = sc[k - 1];
      delta = sa[k] - ck * ck / delta;
      sc[k - 1] = ck / dk;
      dk = dev_sqrt(delta);
      sa[k] = dk;
      acc += dev_log(dk);
    }
    logdet[b] = T(2) * acc;
  }
  __syncthreads();
  store_row(d + b * n, sa, n);
  store_row(e + b * (n - 1), sc, n - 1);
}

// K2. mode 0: L y = b; mode 1: L^T x = b; mode 2: both (Q x = b) fused.
// b is (n, k) per chain, row-major; thread j < k runs column j.
template <typename T>
__global__ void tridiag_solve_kernel(const T* __restrict__ d, const T* __restrict__ e,
                                     const T* __restrict__ rhs, T* __restrict__ out,
                                     int n, int k, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sd = reinterpret_cast<T*>(smem_raw);
  T* se = sd + n;
  T* sb = se + (n - 1);  // n*k
  const long b = blockIdx.x;
  load_row(sd, d + b * n, n);
  load_row(se, e + b * (n - 1), n - 1);
  load_row(sb, rhs + b * (long)n * k, n * k);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    if (mode != 1) {  // forward: y_i = (b_i - e_{i-1} y_{i-1}) / d_i
      T y = sb[j] / sd[0];
      sb[j] = y;
      for (int i = 1; i < n; ++i) {
        y = (sb[i * k + j] - se[i - 1] * y) / sd[i];
        sb[i * k + j] = y;
      }
    }
    if (mode != 0) {  // backward: x_i = (z_i - e_i x_{i+1}) / d_i
      T x = sb[(n - 1) * k + j] / sd[n - 1];
      sb[(n - 1) * k + j] = x;
      for (int i = n - 2; i >= 0; --i) {
        x = (sb[i * k + j] - se[i] * x) / sd[i];
        sb[i * k + j] = x;
      }
    }
  }
  __syncthreads();
  store_row(out + b * (long)n * k, sb, n * k);
}

// K3. Takahashi: z_{n-1} = 1/d_{n-1}^2; z_j = 1/d_j^2 + r_j^2 z_{j+1};
// zoff_j = -r_j z_{j+1}, with r_j = e_j / d_j.
template <typename T>
__global__ void tridiag_selinv_kernel(const T* __restrict__ d, const T* __restrict__ e,
                                      T* __restrict__ zdiag, T* __restrict__ zoff, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sd = reinterpret_cast<T*>(smem_raw);  // d, overwritten by zdiag
  T* se = sd + n;                          // e, overwritten by zoff
  const long b = blockIdx.x;
  load_row(sd, d + b * n, n);
  load_row(se, e + b * (n - 1), n - 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    T dn = sd[n - 1];
    T z = T(1) / (dn * dn);
    sd[n - 1] = z;
    for (int j = n - 2; j >= 0; --j) {
      const T dj = sd[j];
      const T r = se[j] / dj;
      se[j] = -r * z;
      z = T(1) / (dj * dj) + r * r * z;
      sd[j] = z;
    }
  }
  __syncthreads();
  store_row(zdiag + b * n, sd, n);
  store_row(zoff + b * (n - 1), se, n - 1);
}

constexpr int kThreads = 128;

template <typename T>
int launch_factor(const T* a, const T* c, T* d, T* e, T* logdet, int B, int n, void* stream) {
  size_t smem = sizeof(T) * (2 * (size_t)n - 1);
  tridiag_factor_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(a, c, d, e, logdet, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_solve(const T* d, const T* e, const T* rhs, T* out, int B, int n, int k, int mode,
                 void* stream) {
  size_t smem = sizeof(T) * (2 * (size_t)n - 1 + (size_t)n * k);
  int threads = ((k + 31) / 32) * 32;
  if (threads < kThreads) threads = kThreads;
  if (threads > 1024) threads = 1024;
  tridiag_solve_kernel<T><<<B, threads, smem, (cudaStream_t)stream>>>(d, e, rhs, out, n, k, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_selinv(const T* d, const T* e, T* zdiag, T* zoff, int B, int n, void* stream) {
  size_t smem = sizeof(T) * (2 * (size_t)n - 1);
  tridiag_selinv_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(d, e, zdiag, zoff, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tg_tridiag_factor_f32(const float* a, const float* c, float* d, float* e, float* logdet,
                          int B, int n, void* stream) {
  return launch_factor<float>(a, c, d, e, logdet, B, n, stream);
}
int tg_tridiag_factor_f64(const double* a, const double* c, double* d, double* e,
                          double* logdet, int B, int n, void* stream) {
  return launch_factor<double>(a, c, d, e, logdet, B, n, stream);
}

int tg_tridiag_solve_f32(const float* d, const float* e, const float* rhs, float* out, int B,
                         int n, int k, int mode, void* stream) {
  return launch_solve<float>(d, e, rhs, out, B, n, k, mode, stream);
}
int tg_tridiag_solve_f64(const double* d, const double* e, const double* rhs, double* out,
                         int B, int n, int k, int mode, void* stream) {
  return launch_solve<double>(d, e, rhs, out, B, n, k, mode, stream);
}

int tg_tridiag_selinv_f32(const float* d, const float* e, float* zdiag, float* zoff, int B,
                          int n, void* stream) {
  return launch_selinv<float>(d, e, zdiag, zoff, B, n, stream);
}
int tg_tridiag_selinv_f64(const double* d, const double* e, double* zdiag, double* zoff, int B,
                          int n, void* stream) {
  return launch_selinv<double>(d, e, zdiag, zoff, B, n, stream);
}

const char* tg_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
