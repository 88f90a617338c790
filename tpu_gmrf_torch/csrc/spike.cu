// K18 spike_reduced: the P-block tridiagonal interface system of the SPIKE
// solve, eliminated and solved by one thread-block cluster.
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
// What bounds it on the card. Per row, one triangular solve of 2 ns + k
// right-hand sides, one product of 2 ns^2 (ns + k) flops and a Cholesky of
// ns^3 / 3: at ns = 450, P = 4, k = 1 about 1.6e9 flops (bound 0.024 ms at
// the f64 tensor-core rate). The rows are sequential, and so are the row
// tiles of each solve and Cholesky: the kernel is bound by the latency of
// that chain of dependent tile steps, each of which is small.
//
// Design. One cluster of up to 16 blocks (8 where the card refuses 16)
// holds the whole system; every matrix lives in global memory (at the main
// shape one block is 1.6 MB, in L2) and the blocks meet at cluster barriers
// (csrc/tiles.cuh). Per row d:
//   [C_d | y_d] -= V^T [Z | W_y] (d > 0), 64 x 64 tiles dealt out over the
//       blocks, f64 on the tensor cores, where W = [V | Z | W_y] =
//       L_{d-1}^-1 [alpha_d^T | gamma_{d-1} | y_{d-1}] (one solve over
//       2 ns + k columns);
//   C_d symmetrized, as jnp.linalg.cholesky does, and factored by chol_rows:
//       each 64-wide diagonal tile by block 0 (a warp per 16 pivots, then
//       inverted), the panel below it and the trailing update as tiles over
//       the cluster. A pivot that is not finite and positive makes the
//       logdet NaN;
//   the next row's W is solved with L_d during that Cholesky: while block 0
//       factors diagonal tile j + 1, the other blocks take W's row tile j
//       down their column tiles (left-looking, a product with L's finished
//       tile row and one with the inverted diagonal tile), so the solve
//       hides behind the factorization's dependent tile steps.
// Back substitution: y_d -= gamma_d s_{d+1} by row tiles, then L_d^-1 and
// L_d^-T with the rows spread over the cluster (trsm_rows).
// `factored`: Lr holds the factors of an earlier call on the same system
// (beta is not read, the logdet is not written; their diagonal tiles are
// inverted first), and only the right-hand sides are eliminated: y_d -=
// alpha_d C_{d-1}^-1 y_{d-1} by two row-spread solves and a product. The
// second solve of a gradient.

#include "tiles.cuh"

namespace {

using namespace tgtile;

// W[i][c] = a[c][i] for i, c < n (W's row stride ldw, a's n), by 64 x 64
// tiles dealt out over the cluster, staged in shared memory so that both
// the reads and the writes are coalesced.
template <typename T>
__device__ void transpose_into(T* W, int ldw, const T* a, int n, int rank, int cs, T* sm) {
  const int nt = ntiles(n);
  for (int e = rank; e < nt * nt; e += cs) {
    const int r0 = (e / nt) * kT, c0 = (e % nt) * kT;  // the tile of a at (r0, c0)
#pragma unroll
    for (int u = 0; u < kTT / kThr; ++u) {
      const int f = threadIdx.x + u * kThr, r = f / kT, c = f % kT;
      if (r0 + r < n && c0 + c < n) sm[c * kLdS + r] = a[(long long)(r0 + r) * n + c0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTT / kThr; ++u) {
      const int f = threadIdx.x + u * kThr, c = f / kT, r = f % kT;
      if (r0 + r < n && c0 + c < n) W[(long long)(c0 + c) * ldw + r0 + r] = sm[c * kLdS + r];
    }
    __syncthreads();
  }
}

// The system: alpha, beta, gamma (P, ns, ns), r (P, ns, k) in; s (P, ns, k)
// out (it holds y_d until the back substitution overwrites it), Lr (P, ns,
// ns) the factors (out, or in with `factored`), logdet (1,) out; W holds
// ns (2 ns + k) values (ns k with `factored`), Dinv P ntiles(ns) 64 x 64;
// *bad is zero on entry.
template <typename T>
__global__ void __launch_bounds__(kThr, 1)
    spike_reduced_kernel(const T* __restrict__ alpha, const T* __restrict__ beta, const T* __restrict__ gamma,
                         const T* __restrict__ r, int P, int ns, int k, T* Lr, int factored, T* s, T* W, T* Dinv,
                         int* bad, T* logdet) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  __shared__ T red[kThr];
  const int tid = threadIdx.x, rank = blockIdx.x, cs = gridDim.x;  // the grid is one cluster
  const int nt = ntiles(ns);
  const long long nn = (long long)ns * ns, nk = (long long)ns * k;
  const int ldw = factored ? k : 2 * ns + k;
  if (factored) {
    for (int e = rank; e < P * nt; e += cs) {
      const int d = e / nt, j0 = (e % nt) * kT, t = min(kT, ns - j0);
      invert_tile(Lr + d * nn + (long long)j0 * ns + j0, ns, t, Dinv + (long long)e * kTT, sm);
    }
  }
  for (int d = 0; d < P; ++d) {
    T* C = Lr + d * nn;
    T* Y = s + d * nk;
    const T* rd = r + d * nk;
    cluster_copy<T>(nk, rank, cs, [&](long long e) { return rd[e]; }, [&](long long e, T v) { Y[e] = v; });
    if (!factored) {
      const T* bd = beta + d * nn;
      cluster_copy<T>(nn, rank, cs, [&](long long e) { return bd[e]; }, [&](long long e, T v) { C[e] = v; });
    }
    if (factored && d > 0) {  // W = y_{d-1}
      const T* yp = s + (d - 1) * nk;
      cluster_copy<T>(nk, rank, cs, [&](long long e) { return ldcg(yp + e); }, [&](long long e, T v) { W[e] = v; });
    }
    csync();
    if (d > 0) {
      if (!factored) {  // [C_d | y_d] -= V^T [Z | W_y], W solved during the Cholesky of C_{d-1}: V^T(i, p) = W[p][i]
        const int ctiles = nt + 1;  // nt column tiles of C_d, then y_d
        for (int e = rank; e < nt * ctiles; e += cs) {
          const int i0 = (e / ctiles) * kT, ct = e % ctiles, ti = min(kT, ns - i0);
          if (ct < nt)
            gemm_rows<T, 64>(C + (long long)i0 * ns + ct * kT, ns, W + i0, 1, ldw, W + ns + ct * kT, ldw, 1, ti,
                             min(kT, ns - ct * kT), ns, true, sm);
          else
            gemm_k<T>(Y + (long long)i0 * k, k, W + i0, 1, ldw, W + 2 * ns, ldw, 1, ti, k, ns, true, sm);
        }
      } else {  // W_y <- C_{d-1}^-1 y_{d-1}; y_d -= alpha_d W_y
        const T* Lp = Lr + (d - 1) * nn;
        const T* Dp = Dinv + (long long)(d - 1) * nt * kTT;
        trsm_k<T>(Lp, ns, Dp, ns, W, k, k, false, rank, cs, sm);
        trsm_k<T>(Lp, ns, Dp, ns, W, k, k, true, rank, cs, sm);
        for (int i = rank; i < nt; i += cs)
          gemm_k<T>(Y + (long long)i * kT * k, k, alpha + d * nn + (long long)i * kT * ns, ns, 1, W, k, 1,
                    min(kT, ns - i * kT), k, ns, true, sm);
      }
      csync();
    }
    if (!factored) {
      const bool next = d + 1 < P;
      if (next) {  // W = [alpha_{d+1}^T | gamma_d | y_d], solved with L_d during its Cholesky; reads coalesced
        const T* ad = alpha + (d + 1) * nn;
        const T* gd = gamma + d * nn;
        transpose_into(W, ldw, ad, ns, rank, cs, sm);
        cluster_copy<T>(nn, rank, cs, [&](long long e) { return gd[e]; },
                        [&](long long e, T v) { W[(e / ns) * ldw + ns + e % ns] = v; });
        cluster_copy<T>(nk, rank, cs, [&](long long e) { return ldcg(Y + e); },
                        [&](long long e, T v) { W[(e / k) * ldw + 2 * ns + e % k] = v; });
      }
      symmetrize(C, ns, rank, cs, sm);  // as jnp.linalg.cholesky reads C
      const T* Dd = Dinv + (long long)d * nt * kTT;
      // row tile j of W <- L_jj^-1 (W_j - L[j, :j] W[:j]) on the worker's column tiles, once L's tile row j is done
      auto solve_step = [&](int j, int worker, int workers) {
        const int j0 = j * kT, tj = min(kT, ns - j0);
        for (int ct = worker; ct * kT < ldw; ct += workers) {
          T* X = W + ct * kT;
          const int q = min(kT, ldw - ct * kT);
          if (j0) gemm_rows<T, 64>(X + (long long)j0 * ldw, ldw, C + (long long)j0 * ns, ns, 1, X, ldw, 1, tj, q, j0, true, sm);
          gemm_rows<T, 64>(X + (long long)j0 * ldw, ldw, Dd + (long long)j * kTT, kT, 1, X + (long long)j0 * ldw, ldw, 1,
                           tj, q, tj, false, sm);
        }
      };
      chol_rows(C, ns, Dinv + (long long)d * nt * kTT, bad, rank, cs, sm, sm, next, solve_step);
    }
  }
  for (int d = P - 1; d >= 0; --d) {
    T* Y = s + d * nk;
    if (d < P - 1) {  // Y -= gamma_d s_{d+1}
      for (int i = rank; i < nt; i += cs)
        gemm_k<T>(Y + (long long)i * kT * k, k, gamma + d * nn + (long long)i * kT * ns, ns, 1, s + (d + 1) * nk, k,
                  1, min(kT, ns - i * kT), k, ns, true, sm);
      csync();
    }
    const T* Dd = Dinv + (long long)d * nt * kTT;
    trsm_k<T>(Lr + d * nn, ns, Dd, ns, Y, k, k, false, rank, cs, sm);
    trsm_k<T>(Lr + d * nn, ns, Dd, ns, Y, k, k, true, rank, cs, sm);
  }
  if (factored || rank != 0) return;
  T acc = T(0);
  for (long long e = tid; e < (long long)P * ns; e += blockDim.x) {
    const long long d = e / ns, i = e % ns;
    acc += log(ldcg(Lr + d * nn + i * ns + i));
  }
  red[tid] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) logdet[0] = ldcg(bad) ? T(NAN) : T(2) * red[0];
}

template <typename T>
int launch_reduced(const T* alpha, const T* beta, const T* gamma, const T* r, int P, int ns, int k, T* Lr,
                   int factored, T* s, T* work, int* bad, T* logdet, void* stream) {
  if (P == 0 || ns == 0 || k == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(bad, 0, sizeof(int), st);
  if (rc) return rc;
  T* W = work;
  T* Dinv = work + (long long)ns * (2 * ns + k);
  const size_t smem = sizeof(T) * kSmemValues;
  // 16 blocks where a cluster of 16 fits the card, else the portable 8; fewer for a small ns
  int cs = ntiles(ns) == 1 ? 1 : (2 * ntiles(ns) < 16 ? 2 * ntiles(ns) : 16);
  if (cs > 8) {
    int count = 0;
    if (max_clusters(spike_reduced_kernel<T>, dim3(cs), cs, smem, &count) || count < 1) {
      cudaGetLastError();
      cs = 8;
    }
  }
  return launch_cluster(spike_reduced_kernel<T>, dim3(cs), cs, smem, st, alpha, beta, gamma, r, P, ns, k, Lr,
                        factored, s, W, Dinv, bad, logdet);
}

}  // namespace

extern "C" {

#define TG_SPIKE_ENTRY(SUF, T)                                                                                  \
  int tg_spike_reduced_##SUF(const T* alpha, const T* beta, const T* gamma, const T* r, int P, int ns, int k,  \
                             T* Lr, int factored, T* s, T* work, int* bad, T* logdet, void* stream) {          \
    return launch_reduced<T>(alpha, beta, gamma, r, P, ns, k, Lr, factored, s, work, bad, logdet, stream);    \
  }

TG_SPIKE_ENTRY(f32, float)
TG_SPIKE_ENTRY(f64, double)

#undef TG_SPIKE_ENTRY

}  // extern "C"
