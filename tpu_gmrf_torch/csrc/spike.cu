// K18 spike_reduced: the P-block tridiagonal interface system of the SPIKE
// solve, eliminated and solved by one block of threads.
//
// Replaces (JAX reference, tpu_gmrf/parallel/pbtridiag.py):
//   :100-145 `_reduced_solve`: rows d = 0..P-1 of
//       alpha_d s_{d-1} + beta_d s_d + gamma_d s_{d+1} = r_d
//   (ns x ns blocks, alpha_0 and gamma_{P-1} unused), forward elimination
//       C_0 = beta_0,  C_d = beta_d - alpha_d C_{d-1}^-1 gamma_{d-1},
//       y_0 = r_0,     y_d = r_d - alpha_d C_{d-1}^-1 y_{d-1},
//   back substitution s_{P-1} = C_{P-1}^-1 y_{P-1},
//   s_d = C_d^-1 (y_d - gamma_d s_{d+1}), and logdet = 2 sum log diag chol(C_d).
//   The reference runs it redundantly on every device after an all_gather.
//
// Design. One block of kThreads threads per system: the recursion is
// sequential over d, and one system is what a SPIKE solve has. Every matrix
// lives in global memory (at the main shape, ns = 450 in float64, one block
// is 1.6 MB; smaller systems sit in L2): the factors L_d = chol(C_d) in the
// (P, ns, ns) array Lr, kept for the backward solve of a gradient, and a
// workspace of V = L_{d-1}^-1 alpha_d^T, Z = L_{d-1}^-1 gamma_{d-1} and
// W = C_{d-1}^-1 y_{d-1}. C_d = beta_d - V^T Z. The Cholesky (blk_potrf) and
// the triangular solves (blk_trsm of dense_blocks.cuh, shared with K12's
// block entry) are blocked by 64: a 64 x 64 diagonal tile in shared memory,
// solved by substitution, and the rest of the work in the tiled product
// block_gemm of dense_blocks.cuh (shared with K6/K8/K9/K11). C_d is
// symmetrized before its Cholesky, as jnp.linalg.cholesky does; a pivot that
// is not finite and positive makes the logdet NaN.
// `factored`: Lr holds the factors of an earlier call on the same system
// (beta is not read, the logdet is not written), and only the right-hand
// sides are eliminated: the second solve of a gradient.
//
// What bounds it on the card: one SM. Per row, two triangular solves with ns
// right-hand sides, one product of 2 ns^3 flops and a Cholesky of ns^3/3,
// about 4.3 ns^3 flops: at ns = 450, P = 4, 1.6e9 flops on the FMA units of
// one SM. Spreading a row's products over the card (and `wgmma`) is later work.

#include "dense_blocks.cuh"

namespace {

using namespace tgdense;

constexpr int kTile = kNB;  // 64: diagonal tiles of the Cholesky and the solves

// Lower Cholesky in place of the m x m matrix A (ld): the diagonal tile in
// shared memory S (kTile x (kTile + 1)), the rows below it by substitution
// (one thread per row), the trailing update by block_gemm. The upper
// triangle is zeroed. *bad is set for a pivot that is not finite and positive.
template <typename T>
__device__ void blk_potrf(T* A, int ld, int m, T* S, T* As, T* Bs, int* bad) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int c0 = 0; c0 < m; c0 += kTile) {
    const int t = min(kTile, m - c0), ls = t + 1;
    T* D = A + (long long)c0 * ld + c0;
    for (int e = tid; e < t * t; e += nt) {
      const int r = e / t, c = e % t;
      S[r * ls + c] = c <= r ? D[(long long)r * ld + c] : T(0);
    }
    __syncthreads();
    for (int j = 0; j < t; ++j) {
      if (tid == 0) {
        const T l = sqrt(S[j * ls + j]);
        if (!(isfinite(l) && l > T(0))) *bad = 1;
        S[j * ls + j] = l;
      }
      __syncthreads();
      const T inv = T(1) / S[j * ls + j];
      for (int i = j + 1 + tid; i < t; i += nt) S[i * ls + j] *= inv;
      __syncthreads();
      const int mm = t - j - 1;
      for (int e = tid; e < mm * mm; e += nt) {
        const int i = j + 1 + e / mm, q = j + 1 + e % mm;
        if (q <= i) S[i * ls + q] -= S[i * ls + j] * S[q * ls + j];
      }
      __syncthreads();
    }
    for (int e = tid; e < t * t; e += nt) {
      const int r = e / t, c = e % t;
      D[(long long)r * ld + c] = c <= r ? S[r * ls + c] : T(0);
    }
    // the rows below the tile: X = A[c0+t:m, c0:c0+t] L_tile^-T
    for (int r = c0 + t + tid; r < m; r += nt) {
      T* x = A + (long long)r * ld + c0;
      for (int j = 0; j < t; ++j) {
        T v = x[j];
        for (int q = 0; q < j; ++q) v -= x[q] * S[j * ls + q];
        x[j] = v / S[j * ls + j];
      }
    }
    __syncthreads();
    if (c0 + t < m) {
      const T* X = A + (long long)(c0 + t) * ld + c0;
      block_gemm(A + (long long)(c0 + t) * ld + c0 + t, ld, X, ld, 1, X, 1, ld, m - c0 - t, m - c0 - t, t, T(-1),
                 T(1), true, As, Bs);
    }
    __syncthreads();
  }
  for (long long e = tid; e < (long long)m * m; e += nt) {
    const int r = (int)(e / m), c = (int)(e % m);
    if (c > r) A[(long long)r * ld + c] = T(0);
  }
  __syncthreads();
}

template <typename T>
__device__ void copy_block(T* dst, const T* src, long long count) {
  for (long long e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
}

// The system: alpha, beta, gamma (P, ns, ns), r (P, ns, k) in; s (P, ns, k)
// out (it holds y_d until the back substitution overwrites it), Lr (P, ns,
// ns) the factors (out, or in with `factored`), logdet (1,) out; work holds
// 2 ns^2 + ns k values.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spike_reduced_kernel(const T* __restrict__ alpha, const T* __restrict__ beta, const T* __restrict__ gamma,
                         const T* __restrict__ r, int P, int ns, int k, T* Lr, int factored, T* s, T* work,
                         T* logdet) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);  // kTile x (kTile + 1)
  __shared__ T As[kGK * kLd], Bs[kGK * kLd];
  __shared__ T red[kThreads];
  __shared__ int bad;
  const int tid = threadIdx.x;
  const long long nn = (long long)ns * ns, nk = (long long)ns * k;
  T* V = work;
  T* Z = work + nn;
  T* W = work + 2 * nn;
  if (tid == 0) bad = 0;
  for (int d = 0; d < P; ++d) {
    T* C = Lr + d * nn;
    T* Y = s + d * nk;
    copy_block(Y, r + d * nk, nk);
    if (!factored) copy_block(C, beta + d * nn, nn);
    __syncthreads();
    if (d > 0) {
      const T* Lp = Lr + (d - 1) * nn;
      const T* a = alpha + d * nn;
      if (!factored) {
        const T* g = gamma + (d - 1) * nn;
        for (long long e = tid; e < nn; e += blockDim.x) {
          const long long i = e / ns, j = e % ns;
          V[e] = a[j * ns + i];  // alpha_d^T
          Z[e] = g[e];
        }
        __syncthreads();
        blk_trsm(Lp, ns, ns, V, ns, ns, false, S, As, Bs);
        blk_trsm(Lp, ns, ns, Z, ns, ns, false, S, As, Bs);
        block_gemm(C, ns, V, 1, ns, Z, ns, 1, ns, ns, ns, T(-1), T(1), false, As, Bs);  // C -= V^T Z
      }
      copy_block(W, s + (d - 1) * nk, nk);
      __syncthreads();
      blk_trsm(Lp, ns, ns, W, k, k, false, S, As, Bs);
      blk_trsm(Lp, ns, ns, W, k, k, true, S, As, Bs);
      block_gemm(Y, k, a, ns, 1, W, k, 1, ns, k, ns, T(-1), T(1), false, As, Bs);  // Y -= alpha_d W
      __syncthreads();
    }
    if (!factored) {
      for (long long e = tid; e < nn; e += blockDim.x) {
        const long long i = e / ns, j = e % ns;
        if (j < i) C[e] = T(0.5) * (C[e] + C[j * ns + i]);
      }
      __syncthreads();
      blk_potrf(C, ns, ns, S, As, Bs, &bad);
    }
  }
  for (int d = P - 1; d >= 0; --d) {
    T* Y = s + d * nk;
    const T* Ld = Lr + d * nn;
    if (d < P - 1) {  // Y -= gamma_d s_{d+1}
      block_gemm(Y, k, gamma + d * nn, ns, 1, s + (d + 1) * nk, k, 1, ns, k, ns, T(-1), T(1), false, As, Bs);
      __syncthreads();
    }
    blk_trsm(Ld, ns, ns, Y, k, k, false, S, As, Bs);
    blk_trsm(Ld, ns, ns, Y, k, k, true, S, As, Bs);
  }
  if (factored) return;
  T acc = T(0);
  for (long long e = tid; e < (long long)P * ns; e += blockDim.x) {
    const long long d = e / ns, i = e % ns;
    acc += log(Lr[d * nn + i * ns + i]);
  }
  red[tid] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) logdet[0] = bad ? T(NAN) : T(2) * red[0];
}

template <typename T>
int launch_reduced(const T* alpha, const T* beta, const T* gamma, const T* r, int P, int ns, int k, T* Lr,
                   int factored, T* s, T* work, T* logdet, void* stream) {
  if (P == 0 || ns == 0 || k == 0) return 0;
  const size_t smem = sizeof(T) * (size_t)kTile * (kTile + 1);
  int rc = set_smem(spike_reduced_kernel<T>, smem);
  if (rc) return rc;
  spike_reduced_kernel<T><<<1, kThreads, smem, (cudaStream_t)stream>>>(alpha, beta, gamma, r, P, ns, k, Lr, factored,
                                                                      s, work, logdet);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define TG_SPIKE_ENTRY(SUF, T)                                                                                  \
  int tg_spike_reduced_##SUF(const T* alpha, const T* beta, const T* gamma, const T* r, int P, int ns, int k,  \
                             T* Lr, int factored, T* s, T* work, T* logdet, void* stream) {                    \
    return launch_reduced<T>(alpha, beta, gamma, r, P, ns, k, Lr, factored, s, work, logdet, stream);         \
  }

TG_SPIKE_ENTRY(f32, float)
TG_SPIKE_ENTRY(f64, double)

#undef TG_SPIKE_ENTRY

}  // extern "C"
