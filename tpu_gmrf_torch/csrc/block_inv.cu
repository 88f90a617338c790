// K17 block_inv: the signed inverses of the clique and separator blocks of the
// graphical lasso's max-det completion, in one ragged launch.
//
// Replaces (JAX reference, tpu_gmrf/): graphical_lasso.py:150-151 inside
// `_batched_embed_inverses` (:142): per bucket of sets of one size, the
// blocks C[s, s] are gathered and inverted by jnp.linalg.inv (LU with partial
// pivoting), then scatter-added with sign +1 (cliques) or -1 (separators)
// into the cover's data (:157). Here one launch inverts every set, whatever
// its size, and writes sign * inv(C[s, s]) row-major into a flat buffer at
// the set's offset; K5 (gather_segsum) then sums that buffer into the cover's
// data over a host plan, in a fixed order (duplicates across cliques and
// separators are the rule), with no atomics.
//
// Inversion: Gauss-Jordan in place with partial pivoting (the pivot of
// column k is the first row i >= k of largest |A[i][k]|, NaN counting as
// largest), then the column interchanges undone in reverse order. Not a
// Cholesky inverse: a soft-thresholded covariance block need not be positive
// definite. A singular block gives non-finite values (a zero pivot divides),
// as the reference's LU inverse does; the loop always ends.
//
// What bounds it on the card: 2 s^3 flops on s^2 values per set. At the
// graphical lasso's n = 1000 (871 cliques of mean size 21, max 86) the sets
// are small: bound by the s dependent steps of ~6 barriers each per block.
//
// Design: one block of 256 threads per set. A set whose block fits the
// launch's dynamic shared memory (f64: s <= 169 in the 227 KB a block may
// use) is gathered into shared memory, inverted there and written out with
// its sign; a larger set is gathered into its slice of the output buffer and
// inverted in place, with its pivot column and interchanges in a global
// workspace (`goff` >= 0 gives its offset there). No size is refused.
// Arithmetic is rounded per operation (rn_ops.cuh), as the plain version's.

#include "rn_ops.cuh"

namespace {

using tgrn::Rn;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  const bool nv = isnan(v), nb = isnan(bv);
  if (nv != nb) return nv;
  if (!nv && v != bv) return v > bv;
  return i < bi;
}

// In-place Gauss-Jordan inverse of the s x s matrix A (row stride lda) by the
// block's threads; f (s values) and perm (s ints) are workspace.
template <typename T>
__device__ void gj_invert(T* A, int lda, int s, T* f, int* perm) {
  using O = Rn<T>;
  __shared__ T red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int piv_row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < s; ++k) {
    T bv = T(0);
    int bi = s;  // none yet
    for (int i = k + tid; i < s; i += kThreads) {
      const T v = O::abs(A[i * lda + k]);
      if (bi == s || better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (oi < s && (bi == s || better(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      T v = red_v[0];
      int p = red_i[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        if (red_i[w] < s && (p == s || better(red_v[w], red_i[w], v, p))) {
          v = red_v[w];
          p = red_i[w];
        }
      }
      piv_row = p;
      perm[k] = p;
    }
    __syncthreads();
    const int p = piv_row;
    if (p != k) {
      for (int j = tid; j < s; j += kThreads) {
        const T t = A[k * lda + j];
        A[k * lda + j] = A[p * lda + j];
        A[p * lda + j] = t;
      }
      __syncthreads();
    }
    for (int i = tid; i < s; i += kThreads) f[i] = A[i * lda + k];
    __syncthreads();
    const T piv = f[k];
    for (int j = tid; j < s; j += kThreads) A[k * lda + j] = O::div(j == k ? T(1) : A[k * lda + j], piv);
    __syncthreads();
    for (int e = tid; e < s * s; e += kThreads) {
      const int i = e / s, j = e - (e / s) * s;
      if (i == k) continue;
      A[i * lda + j] = O::sub(j == k ? T(0) : A[i * lda + j], O::mul(f[i], A[k * lda + j]));
    }
    __syncthreads();
  }
  for (int k = s - 1; k >= 0; --k) {
    const int p = perm[k];
    if (p != k) {
      for (int i = tid; i < s; i += kThreads) {
        const T t = A[i * lda + k];
        A[i * lda + k] = A[i * lda + p];
        A[i * lda + p] = t;
      }
    }
    __syncthreads();
  }
}

// Block b inverts set b: rows idx[ptr[b] .. ptr[b+1]) of the dense n x n C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_inv_kernel(const T* __restrict__ C, int n, const int* __restrict__ idx, const long long* __restrict__ ptr,
                     const long long* __restrict__ out_off, const T* __restrict__ sign, T* __restrict__ out,
                     const long long* __restrict__ goff, T* __restrict__ gf, int* __restrict__ gperm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int* set = idx + ptr[b];
  const int s = (int)(ptr[b + 1] - ptr[b]);
  T* o = out + out_off[b];
  const bool global = goff[b] >= 0;
  T* A = global ? o : reinterpret_cast<T*>(smem_raw);
  T* f = global ? gf + goff[b] : A + (long long)s * s;
  int* perm = global ? gperm + goff[b] : reinterpret_cast<int*>(f + s);
  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int a = e / s, c = e - (e / s) * s;
    A[e] = C[(long long)set[a] * n + set[c]];
  }
  __syncthreads();
  gj_invert<T>(A, s, s, f, perm);
  const T sg = sign[b];
  for (int e = threadIdx.x; e < s * s; e += kThreads) o[e] = Rn<T>::mul(sg, A[e]);
}

template <typename T>
int launch_block_inv(const T* C, int n, const int* idx, const long long* ptr, const long long* out_off, const T* sign,
                     T* out, const long long* goff, T* gf, int* gperm, int nsets, int smax, void* stream) {
  if (nsets == 0) return 0;
  const size_t smem = sizeof(T) * ((size_t)smax * smax + smax) + sizeof(int) * (size_t)smax;
  int rc = tgrn::set_smem(block_inv_kernel<T>, smem);
  if (rc) return rc;
  block_inv_kernel<T><<<nsets, kThreads, smem, (cudaStream_t)stream>>>(C, n, idx, ptr, out_off, sign, out, goff, gf,
                                                                       gperm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// smax: the largest set taking the shared-memory path (sizes the launch's
// dynamic shared memory); goff[b] >= 0 sends set b to the global path.
int tg_block_inv_f32(const float* C, int n, const int* idx, const long long* ptr, const long long* out_off,
                     const float* sign, float* out, const long long* goff, float* gf, int* gperm, int nsets, int smax,
                     void* stream) {
  return launch_block_inv<float>(C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, nsets, smax, stream);
}
int tg_block_inv_f64(const double* C, int n, const int* idx, const long long* ptr, const long long* out_off,
                     const double* sign, double* out, const long long* goff, double* gf, int* gperm, int nsets,
                     int smax, void* stream) {
  return launch_block_inv<double>(C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, nsets, smax, stream);
}

}  // extern "C"
