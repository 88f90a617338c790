// K6 sn_panel, K7 sn_trsv and K8 sn_takahashi: the size-class batches of one
// level of the supernodal Cholesky schedule, per chain.
//
// Replaces (JAX reference, tpu_gmrf/solvers/supernodal.py):
//   K6: :907 `_panel_math` with :775 `_chol_boosted`, :899 `_set_unique` and
//       :987 `_plain_step` (gather panel, boosted diagonal Cholesky,
//       Lb = Bm Ld^-T, U = Lb Lb^T, unique write-back), plus the pivots that
//       :1339 `logdet` gathers;
//   K7: :1171 `_forward` / :1214 `_backward` (`fwd_step`, `bwd_step`), and,
//       as mode 2, :1296 `sqrt_step` of `sqrt_matvec` (out[cols] += Ld z[cols],
//       Lb z[cols] into the level's update buffer);
//   K8: :1000 `_sig_step` (block Takahashi: Sigma_RJ = -Sigma_RR C,
//       Sigma_JJ = Ld^-T Ld^-1 + C^T Sigma_RR C with C = Lb Ld^-1).
//   K20 sn_panel_tangent and K21 sn_takahashi_tangent: JAX's AD of :1345
//       `selinv` through the factorization and `_sig_step` (the reference
//       has no kernel of its own for them): the tangent of K6's panel step
//       and of K8's step, for the selected inverse's derivative
//       Sigma' = -Sigma Q' Sigma (csrc/tangent.cuh: a cluster per
//       (supernode, chain), the products in float64 on a workspace, on
//       tgtile's float64 tensor-core tiles).
//   K25 sn_panel_adjoint: JAX's AD (reverse mode) of :1345's factorization,
//       as `jax.grad` of :1270-1290 (forward_solve, backward_solve,
//       sqrt_matvec) reaches it: K6's panel step walked backwards over the
//       level schedule, a class batch per launch, from the factor's
//       cotangent on vals' layout to that of the equilibrated Q on the fill
//       (csrc/tangent.cuh `panel_adjoint`, a cluster per (supernode, chain)
//       as K20); the Schur update's adjoint is read through the Schur table
//       (the ancestors' cotangents, final when the levels run descending).
//   K7's mode 3, the transpose product (`sn_multiply`, transpose):
//       x[cols] = Ld^T z[cols] + Lb^T z[rows] per supernode, the z-cotangent
//       of :1287 `sqrt_matvec`; each supernode writes only its own columns.
//
// Layout. `vals` / `sig` hold, per chain, the flat CSC values of L / Sigma on
// the amalgamated fill pattern plus one DUMMY slot (index nnzL). A class
// batch is P supernodes with padded width W and padded row count M:
// panel_idx (P, W+M, W), cols_idx (P, W), rows_idx (P, M), schur_idx
// (P, M, M), padded with DUMMY / NDUMMY. Live columns and rows are a prefix:
// ns = #live columns, m = #live rows.
//
// Padding and the DUMMY race. The reference lets padded slots write DUMMY
// and resets it after every scatter; inside one launch that would race with
// another block's gather. These kernels never write a padded position and
// never read one: a DUMMY / NDUMMY index is a zero, and every loop runs over
// the live prefix (ns, m) only. Padded columns of the reference factor as
// identity and padded rows as zeros, so skipping them changes nothing.
//
// What bounds them on the card. Per (supernode, chain) the work is
// O((ns+m) ns^2 + m^2 ns) for K6, O((ns+m) ns k) for K7 and O(m^2 ns + ns^3)
// for K8, over a gathered panel. The scan levels are many small panels
// (W <= 64): bound by the gathers and by the latency of the dependent
// pivots. The top separators (up to W = 1024, M = 1024) are a few panels
// each: bound by the chain of 64-wide diagonal tiles. At n = 5741 a level's
// device work is tens of microseconds, so the host's launches matter too.
// Design. The products run on tgtile's mma_slice from operands staged in
// shared memory: float64 on the tensor cores (m16n8k4), float32 on the FMA
// units. K6 computes a factor in its own type, as the reference does, with
// correctly rounded float32 pivots (tgtile::pivot<true>): its float32 factor
// of an ill-conditioned prior (n = 14058) is 1e-2 from the float64 one, and
// only such a float32 computation keeps the kernel within 1e-3 of the
// reference's float32 path (chip_smoke.py phases 3b and 6). K7 and K8
// compute in float64 and round once on the way out. The columns of a
// supernode are consecutive in vals (CSC: column c's live rows run down
// from its diagonal, then the rows below), so L(r, c) is one load at
// base[c] + r - c. The class batches of a level do not depend on each
// other: K7 takes them all in one launch and K6 in one launch per path, a
// table of `Batch` descriptors telling each block its batch. K6 has two
// paths (kernels/supernodal.py panel_launch):
//   - one block per (supernode, chain) for panels W <= 64 where the batch
//     fills the card or has at most 64 rows below: the diagonal block in
//     shared memory, factored with tgtile::factor_tile_smem (16-column warp
//     blocks, no barrier per column) beside its inverse, Lb = Bm Ld^-T by a
//     product with that inverse, U = Lb Lb^T by 64 x 64 tiles;
//   - a cluster per (supernode, chain) for the rest (the top separators): the
//     panel in a workspace, tgtile's Cholesky steps over the cluster
//     (diagonal tile by block 0 with factor_tile, the rows below and the
//     trailing update as tiles dealt out over the blocks), then U's tiles.
// The pivot boost is the reference's, decided per (supernode, chain); on the
// cluster path every block reads the attempt's flag after the same cluster
// barrier, so the cluster retries together. K7 runs one block per
// (supernode, chain, up to 8 or 64 right-hand sides): the columns' values in
// shared memory, the diagonal block by 64-row tiles (the off-diagonal
// products, then each tile's substitution by warps, one right-hand side per
// warp, no block barrier per column), Lb y or Lb^T x as products over the
// panel, which a block reads once: a chain's panel is read once per block
// of its right-hand sides, so once for k <= 8, else ceil(k / 8) times, or
// ceil(k / 64) on a level (W <= 128) whose 8-column blocks would crowd the
// card (kernels/supernodal.py trsv_launch). K8 keeps its operands in shared memory
// or in a workspace and gathers them through the panel and Schur tables.

#include "dense_blocks.cuh"
#include "tangent.cuh"
#include "tiles.cuh"

namespace {

using tgdense::Eps;

// Live width ns (diagonal of the D block present) and live row count m
// (column 0 of the Bm block present) of one panel. Live columns and rows are
// a prefix, so each is a count, taken by all threads at once (a scan by one
// thread would chain up to W + M dependent loads).
__device__ void live_dims(const int* pidx, int W, int M, int dummy, int* s_ns, int* s_m) {
  if (threadIdx.x == 0) *s_ns = *s_m = 0;
  __syncthreads();
  int ns = 0, m = 0;
  for (int i = threadIdx.x; i < W; i += blockDim.x) ns += pidx[(long long)i * W + i] != dummy;
  for (int i = threadIdx.x; i < M; i += blockDim.x) m += pidx[(long long)(W + i) * W] != dummy;
  if (ns) atomicAdd(s_ns, ns);
  if (m) atomicAdd(s_m, m);
  __syncthreads();
  if (*s_ns == 0 && threadIdx.x == 0) *s_m = 0;  // an all-padding panel
  __syncthreads();
}

// One class batch of a K6 or K7 launch, which may cover all the batches of a
// level (kernels/supernodal.py `_descriptors`): its tables, its shape, its
// first block, the offsets of its slots in the level's update buffers and
// (K6's cluster path) of its slice of the workspace.
struct Batch {
  const int* panel;
  const int* cols;
  const int* rows;
  long long W, M, P, first, ubase, fbase, work;
};

// The batch of block `x` of a launch over ng batches (their blocks in order).
__device__ __forceinline__ const Batch& batch_of(const Batch* bt, int ng, int x) {
  int g = 0;
  while (g + 1 < ng && x >= bt[g + 1].first) ++g;
  return bt[g];
}

// ---- the products, shared by K6-K8 -------------------------------------------

namespace sn {

using tgtile::Acc;
using tgtile::Cfg;
using tgtile::kKS;
using tgtile::kLdS;
using tgtile::kT;
using tgtile::kThr;
using tgtile::kTT;

// values of the two staged operand slices of a 64 x NT product
template <int NT>
__host__ __device__ constexpr int stage_values() {
  return 2 * kKS * (Cfg<NT>::LDA + Cfg<NT>::LDB);
}

// acc (64 x NT) += sum_{p < Kd} a(i, p) b(p, j) over i < Mr, j < Nc (zeros
// outside), in the accumulators' type V: float64 on the tensor cores,
// float32 on the FMA units (tgtile::mma_slice). The operands are functors
// (a gather through an index table, a transposed read, a tile in shared
// memory) whose values are staged as V 32 deep into shared memory, the next slice
// loaded into registers while the current one is multiplied. a_by_rows(k0)
// says for the slice at depth k0 whether neighbouring threads load
// neighbouring rows i of A (true) or neighbouring depths p (false): whichever
// keeps the reads of that slice contiguous. Every thread of the block calls
// it; it ends with a block barrier.
template <int NT, typename V, typename FA, typename FB, typename AR>
__device__ void gather_mma(Acc<V, NT>& acc, FA a, FB b, int Mr, int Nc, int Kd, AR a_by_rows, V* sm) {
  using C = Cfg<NT>;
  V* As = sm;                     // [2][kKS][LDA]
  V* Bs = sm + 2 * kKS * C::LDA;  // [2][kKS][LDB]
  const int tid = threadIdx.x;
  V ra[C::AV], rb[C::BV];
  bool rows = true;
  // the u-th A value of a thread: (tid % 64, tid / 64 + 4u) by rows, (tid / 32 + 8u, tid % 32) by depths
  auto ai = [&](int u) { return rows ? tid % kT : tid / kKS + u * (kThr / kKS); };
  auto ap = [&](int u) { return rows ? tid / kT + u * (kThr / kT) : tid % kKS; };
  auto load = [&](int k0) {
    rows = a_by_rows(k0);
#pragma unroll
    for (int u = 0; u < C::AV; ++u) {
      const int i = ai(u), p = k0 + ap(u);
      ra[u] = (i < Mr && p < Kd) ? V(a(i, p)) : V(0);
    }
#pragma unroll
    for (int u = 0; u < C::BV; ++u) {
      const int j = tid % NT, p = k0 + tid / NT + u * (kThr / NT);
      rb[u] = (j < Nc && p < Kd) ? V(b(p, j)) : V(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < C::AV; ++u) As[(buf * kKS + ap(u)) * C::LDA + ai(u)] = ra[u];
#pragma unroll
    for (int u = 0; u < C::BV; ++u) Bs[(buf * kKS + tid / NT + u * (kThr / NT)) * C::LDB + tid % NT] = rb[u];
  };
  const int slices = (Kd + kKS - 1) / kKS;
  if (slices == 0) return;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) load((s + 1) * kKS);
    tgtile::mma_slice<V, NT>(acc, As + (s & 1) * kKS * C::LDA, Bs + (s & 1) * kKS * C::LDB);
    if (s + 1 < slices) store((s + 1) & 1);
    __syncthreads();
  }
}

// f(r, c, v) for every accumulator v (a reference) of the 64 x NT tile, at
// its row r and column c (the layout of tgtile::tile_io).
template <int NT, typename V, typename F>
__device__ __forceinline__ void acc_each(Acc<V, NT>& acc, F f) {
  using C = Cfg<NT>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % C::WM, wn = warp / C::WM;
  const int r0 = wm * (kT / C::WM) + (lane >> 2), c0 = wn * (NT / C::WN) + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NTT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) f(r0 + 8 * i, c0 + 8 * j + e, acc.v[i][j][e]);
}

// Whether a panel's column runs down consecutive positions (CSC, the
// supernodal factor) rather than along a row (the banded factor's row-major
// blocks): it decides how K8's gathers of L, C and Sigma_RJ are spread over
// the threads.
__device__ __forceinline__ bool rows_contiguous(const int* pidx, int W, int ns) {
  return ns > 1 && pidx[W] == pidx[0] + 1;
}

}  // namespace sn

// ---- K6 -------------------------------------------------------------------

using sn::Acc;
using sn::kLdS;
using sn::kT;
using sn::kThr;
using sn::kTT;

constexpr double kTiny = 30.0;  // a pivot must exceed kTiny eps of the factor's type (the reference's test)

// The largest row sum of |D| over the mirrored live block (lower(i, j) =
// D(i, j) for j <= i), at least 1 when padded columns add their unit
// diagonal: the reference's Gershgorin shift before the last attempt. Every
// thread of the block calls it and gets the bound; red: kThr doubles.
template <typename F>
__device__ double gershgorin(F lower, int ns, int W, double* red) {
  double dom = ns < W ? 1.0 : 0.0;
  for (int i = threadIdx.x; i < ns; i += kThr) {
    double s = 0.0;
    for (int j = 0; j <= i; ++j) s += fabs(lower(i, j));
    for (int j = i + 1; j < ns; ++j) s += fabs(lower(j, i));
    dom = s > dom ? s : dom;
  }
  red[threadIdx.x] = dom;
  __syncthreads();
  for (int off = kThr / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off && red[threadIdx.x + off] > red[threadIdx.x]) red[threadIdx.x] = red[threadIdx.x + off];
    __syncthreads();
  }
  dom = red[0];
  __syncthreads();
  return dom;
}

// Shared memory of the one-block path, in float64 values (a float32 factor uses half): Ld^-1 (64 x kLdS), the
// pivots' reciprocals (64), then the diagonal block (64 x kLdS) while it is factored and the products' staging after.
constexpr int kPanelTileValues = kT * kLdS + kT + sn::stage_values<64>();

constexpr double kBoost = 2e-6;  // the reference's first boost, delta = 2e-6 W (`_boost_delta`)

// K6 for panels W <= 64, block (x, b): supernode x - first of its batch, chain b.
template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_panel_tile_kernel(T* __restrict__ vals, long long vs, const Batch* __restrict__ bt, int ng, int dummy,
                         T* __restrict__ u, long long us, T* __restrict__ logpiv, int n, int* __restrict__ boost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m, s_bad, base[kT];
  __shared__ double red[kThr];
  T* X = reinterpret_cast<T*>(smem_raw);  // Ld^-1
  T* rinv = X + kT * kLdS;
  T* stage = rinv + kT;  // the products' staging (16-byte aligned)
  T* S = stage;          // the diagonal block until then
  const Batch& bat = batch_of(bt, ng, blockIdx.x);
  const int W = (int)bat.W, M = (int)bat.M, p = blockIdx.x - (int)bat.first, tid = threadIdx.x;
  const long long b = blockIdx.y, ubase = bat.ubase;
  const double delta = kBoost * W;
  const int* pidx = bat.panel + (long long)p * (W + M) * W;
  const int* cols_idx = bat.cols;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;
  T* vb = vals + b * vs;
  if (tid < ns) base[tid] = pidx[tid * W + tid];
  __syncthreads();
  auto at = [&](int r, int c) { return vb + base[c] + r - c; };  // live row r (the rows below from ns on), c <= r
  int attempt = 0;
  for (;; ++attempt) {
    for (int e = tid; e < kTT; e += kThr) {  // by columns: a column's rows are consecutive in vals
      const int c = e / kT, r = e % kT;
      S[r * kLdS + c] = (r < ns && c <= r) ? *at(r, c) : T(r == c ? 1 : 0);
    }
    if (tid == 0) s_bad = 0;
    __syncthreads();
    if (attempt > 0) {
      double shift = delta;
      if (attempt == 2) shift += gershgorin([&](int i, int j) { return double(S[i * kLdS + j]); }, ns, W, red);
      if (tid < ns) S[tid * (kLdS + 1)] += T(shift);
      __syncthreads();
    }
    tgtile::factor_tile_smem<true>(S, X, rinv, ns, &s_bad, T(kTiny * Eps<T>::v), [] {});
    const int bad = s_bad;
    __syncthreads();  // every thread has read the flag before the next attempt resets it
    if (!bad || attempt == 2) break;
  }
  if (attempt > 0 && tid == 0) atomicAdd(boost + b, 1);
  for (int e = tid; e < kTT; e += kThr) {
    const int c = e / kT, r = e % kT;
    if (r < ns && c <= r) *at(r, c) = S[r * kLdS + c];
  }
  if (tid < ns) logpiv[b * n + cols_idx[(long long)p * W + tid]] = T(log(double(S[tid * (kLdS + 1)])));
  if (m == 0) return;
  __syncthreads();  // S becomes the staging
  for (int r0 = 0; r0 < m; r0 += kT) {  // Lb = Bm Ld^-T, 64 rows at a time
    Acc<T, 64> acc;
    acc.zero();
    sn::gather_mma<64>(
        acc, [&](int i, int q) { return *at(ns + r0 + i, q); }, [&](int q, int j) { return q <= j ? X[j * kLdS + q] : T(0); },
        min(kT, m - r0), ns, ns, [](int) { return true; }, stage);
    sn::acc_each<64>(acc, [&](int r, int c, T& v) {
      if (r0 + r < m && c < ns) *at(ns + r0 + r, c) = v;
    });
  }
  __syncthreads();  // Lb is in vals
  T* ub = u + b * us + ubase + (long long)p * M * M;
  for (int I = 0; I * kT < m; ++I)  // U = Lb Lb^T, lower, by 64 x 64 tiles
    for (int J = 0; J <= I; ++J) {
      const int r0 = I * kT, c0 = J * kT;
      Acc<T, 64> acc;
      acc.zero();
      sn::gather_mma<64>(
          acc, [&](int i, int q) { return __ldcg(at(ns + r0 + i, q)); }, [&](int q, int j) { return __ldcg(at(ns + c0 + j, q)); },
          min(kT, m - r0), min(kT, m - c0), ns, [](int) { return true; }, stage);
      sn::acc_each<64>(acc, [&](int r, int c, T& v) {
        if (r0 + r < m && c0 + c <= r0 + r) ub[(long long)(r0 + r) * M + c0 + c] = v;
      });
    }
}

// The first ntiles(ns) column tiles of the Cholesky of the H x H matrix whose
// lower part is F (row stride ld), on the cluster: tgtile::chol_rows' steps
// (the diagonal tile by block 0 in factor_tile, its last one ns - j0 wide;
// the tiles below it times its inverse; the trailing update dealt out over
// the cluster), the trailing update kept to those columns: what it would add
// below and right of them is -U, formed after from the finished rows. *bad
// set for a pivot that is not finite and above tiny. Ends with a cluster
// barrier.
template <typename T>
__device__ void chol_panel(T* F, long long ld, int H, int ns, T* Dinv, int* bad, int rank, int cs, T* sm, T tiny) {
  using namespace tgtile;
  const int nt = ntiles(H), ntf = ntiles(ns);
  for (int j = 0; j < ntf; ++j) {
    const int j0 = j * kT;
    if (rank == 0) factor_tile<true>(F + j0 * ld + j0, ld, min(kT, ns - j0), Dinv + (long long)j * kTT, bad, sm, tiny);
    csync();
    for (int i = j + 1 + rank; i < nt; i += cs) {  // F_ij <- F_ij L_jj^-T
      T* Fij = F + (long long)i * kT * ld + j0;
      gemm_rows<T, 64>(Fij, ld, Fij, ld, 1, Dinv + (long long)j * kTT, 1, kT, min(kT, H - i * kT), kT, kT, false, sm);
    }
    csync();
    int idx = 0;  // F_il -= L_ij L_lj^T for j < l <= i, l < ntf
    for (int i = j + 1; i < nt; ++i)
      for (int l = j + 1; l <= i && l < ntf; ++l, ++idx) {
        if (idx % cs != rank) continue;
        const long long i0 = (long long)i * kT, l0 = (long long)l * kT;
        gemm_rows<T, 64>(F + i0 * ld + l0, ld, F + i0 * ld + j0, ld, 1, F + l0 * ld + j0, 1, ld, min(kT, H - (int)i0),
                         kT, kT, true, sm);
      }
    csync();
  }
}

// The workspace (values of the factor's type) of one (supernode, chain) of
// K6's cluster path: the panel (Wq + M) x Wq, Wq = 64 ntiles(W), then its
// inverted diagonal tiles.
__host__ __device__ inline long long panel_slice(long long W, long long M) {
  const long long Wq = tgtile::ntiles((int)W) * (long long)kT;
  return (Wq + M) * Wq + tgtile::ntiles((int)W) * (long long)kTT;
}

// K6 on a cluster of cs = gridDim.x blocks per (supernode y - first of its
// batch, chain b). The panel lives in the unit's workspace F (row stride
// Wq): rows 0..Wp-1 the diagonal block (the identity beyond ns), rows
// Wp..Wp+m-1 the rows below (zero beyond column ns), Wp = 64 ntiles(ns); its
// inverted diagonal tiles follow. flags: three breakdown flags per unit, one
// per attempt.
template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_panel_cluster_kernel(T* __restrict__ vals, long long vs, const Batch* __restrict__ bt, int ng, int dummy,
                            T* __restrict__ u, long long us, T* __restrict__ logpiv, int n, int* __restrict__ boost,
                            T* work, int* flags) {
  using tgtile::csync;
  using tgtile::ldcg;
  using tgtile::ntiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const Batch& bat = batch_of(bt, ng, blockIdx.y);
  const int W = (int)bat.W, M = (int)bat.M, rank = blockIdx.x, cs = gridDim.x, p = blockIdx.y - (int)bat.first;
  const int tid = threadIdx.x;
  const long long b = blockIdx.z, ubase = bat.ubase;
  const double delta = kBoost * W;
  const int* pidx = bat.panel + (long long)p * (W + M) * W;
  const int* cols_idx = bat.cols;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;  // the whole cluster
  const int Wq = ntiles(W) * kT, ntf = ntiles(ns), Wp = ntf * kT, H = Wp + m;
  T* F = work + bat.work + (b * bat.P + p) * panel_slice(W, M);
  T* Dv = F + (long long)(Wq + M) * Wq;
  int* fail = flags + 3 * (b * gridDim.y + blockIdx.y);
  T* vb = vals + b * vs;
  auto at = [&](int r, int c) { return vb + __ldg(pidx + (long long)c * W + c) + r - c; };
  // f(i0, j0) for the 64 x 64 tiles of F's lower part in the first Wp columns, dealt out over the cluster
  auto each_tile = [&](auto f) {
    int idx = 0;
    for (int I = 0; I < ntiles(H); ++I)
      for (int J = 0; J < ntf && (I >= ntf || J <= I); ++J, ++idx)
        if (idx % cs == rank) f(I * kT, J * kT);
  };
  if (rank == 0 && tid < 3) fail[tid] = 0;  // read after the cluster barriers below
  int attempt = 0;
  for (;; ++attempt) {
    double shift = attempt == 0 ? 0.0 : delta;
    if (attempt == 2)
      shift += gershgorin([&](int i, int j) { return double(*at(i, j)); }, ns, W, reinterpret_cast<double*>(sm));
    each_tile([&](int i0, int j0) {  // the tile through shared memory: vals read down columns, F written along rows
#pragma unroll 4
      for (int v = 0; v < kTT / kThr; ++v) {
        const int e = tid + v * kThr, c = e / kT, r = e % kT, gr = i0 + r, gc = j0 + c;
        T x = T(0);
        if (gr < Wp)
          x = (gr < ns && gc <= gr) ? *at(gr, gc) + (gr == gc ? T(shift) : T(0)) : T(gr == gc ? 1 : 0);
        else if (gr < H && gc < ns)
          x = *at(ns + gr - Wp, gc);
        sm[c * kLdS + r] = x;
      }
      __syncthreads();
#pragma unroll 4
      for (int v = 0; v < kTT / kThr; ++v) {
        const int e = tid + v * kThr, r = e / kT, c = e % kT;
        if (i0 + r < H) F[(long long)(i0 + r) * Wq + j0 + c] = sm[c * kLdS + r];
      }
      __syncthreads();
    });
    csync();
    chol_panel(F, Wq, H, ns, Dv, fail + attempt, rank, cs, sm, T(kTiny * Eps<T>::v));
    if (attempt == 2 || ldcg(fail + attempt) == 0) break;  // every block reads the flag after the same barrier
  }
  if (attempt > 0 && rank == 0 && tid == 0) atomicAdd(boost + b, 1);
  each_tile([&](int i0, int j0) {  // the factor back: F read along rows, vals written down columns
#pragma unroll 4
    for (int v = 0; v < kTT / kThr; ++v) {
      const int e = tid + v * kThr, r = e / kT, c = e % kT;
      sm[c * kLdS + r] = i0 + r < H ? ldcg(F + (long long)(i0 + r) * Wq + j0 + c) : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int v = 0; v < kTT / kThr; ++v) {
      const int e = tid + v * kThr, c = e / kT, r = e % kT, gr = i0 + r, gc = j0 + c;
      if (gc < ns && gr < ns && gc <= gr)
        *at(gr, gc) = sm[c * kLdS + r];
      else if (gc < ns && gr >= Wp && gr < H)
        *at(ns + gr - Wp, gc) = sm[c * kLdS + r];
    }
    __syncthreads();
  });
  for (int c = rank * kThr + tid; c < ns; c += cs * kThr)
    logpiv[b * n + cols_idx[(long long)p * W + c]] = T(log(double(ldcg(F + (long long)c * Wq + c))));
  T* ub = u + b * us + ubase + (long long)p * M * M;
  int idx = 0;  // U = Lb Lb^T, lower, by 64 x 64 tiles dealt out over the cluster
  for (int I = 0; I * kT < m; ++I)
    for (int J = 0; J <= I; ++J, ++idx) {
      if (idx % cs != rank) continue;
      const int r0 = I * kT, c0 = J * kT;
      Acc<T, 64> acc;
      acc.zero();
      tgtile::tile_mma<T, 64>(acc, F + (long long)(Wp + r0) * Wq, Wq, 1, F + (long long)(Wp + c0) * Wq, 1, Wq,
                              min(kT, m - r0), min(kT, m - c0), ns, false, sm);
      sn::acc_each<64>(acc, [&](int r, int c, T& v) {
        if (r0 + r < m && c0 + c <= r0 + r) ub[(long long)(r0 + r) * M + c0 + c] = v;
      });
    }
}

// ---- K7 -------------------------------------------------------------------

// Shared memory (float64 values) of K7 at column tile NT: the products'
// staging, or the diagonal tile (64 x kLdS) and its pivots' reciprocals;
// then the columns' values Y (64 ntiles(W) x (NT + 1)); then W int bases.
template <int NT>
__host__ __device__ constexpr int trsv_stage() {
  return sn::stage_values<NT>() > kT * kLdS + kT ? sn::stage_values<NT>() : kT * kLdS + kT;
}

template <int NT>
size_t trsv_smem(int Wmax) {
  return sizeof(double) * (trsv_stage<NT>() + (size_t)tgtile::ntiles(Wmax) * kT * (NT + 1)) + sizeof(int) * Wmax;
}

// K7, block (x, b, chunk): supernode x - first of its batch (Wmax: the
// widest batch of the launch), chain b, its right-hand sides chunk NT ..
// chunk NT + kc - 1 (rows b k + ... of x, z and u). Mode 0: L y = x
// (forward, u = Lb y); 1: L^T y = x with x's rows below known (backward);
// 2: x[cols] += Ld z[cols], u = Lb z[cols] (the product, not a solve);
// 3: x[cols] = Ld^T z[cols] + Lb^T z[rows] (the transpose product).
template <typename T, int NT>
__global__ void __launch_bounds__(kThr)
    sn_trsv_kernel(const T* __restrict__ vals, long long vs, const Batch* __restrict__ bt, int ng, int Wmax,
                   int dummy, T* __restrict__ x, long long xs, int k, T* __restrict__ u, long long us, int mode,
                   const T* __restrict__ z) {
  constexpr int LY = NT + 1, CPW = NT / 8;  // Y's row stride (odd); right-hand sides per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* st = reinterpret_cast<double*>(smem_raw);  // the staging, or the diagonal tile Ls and rd
  double* Ls = st;
  double* rd = st + kT * kLdS;
  double* Y = st + trsv_stage<NT>();
  int* base = reinterpret_cast<int*>(Y + tgtile::ntiles(Wmax) * kT * LY);
  const Batch& bat = batch_of(bt, ng, blockIdx.x);
  const int W = (int)bat.W, M = (int)bat.M, p = blockIdx.x - (int)bat.first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.y, ubase = bat.fbase;
  const int k0 = blockIdx.z * NT, kc = min(NT, k - k0);
  const long long row0 = b * k + k0;  // the first right-hand side's row
  const int* pidx = bat.panel + (long long)p * (W + M) * W;
  const int* cidx = bat.cols + (long long)p * W;
  const int* ridx = bat.rows + (long long)p * M;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;
  const T* vb = vals + b * vs;
  for (int c = tid; c < ns; c += kThr) base[c] = pidx[(long long)c * W + c];
  const T* src = mode >= 2 ? z : x;
  for (int e = tid; e < ns * NT; e += kThr) {  // Y = x[cols] (z[cols]); the columns are consecutive in x
    const int j = e / ns, r = e % ns;
    Y[r * LY + j] = j < kc ? double(src[(row0 + j) * xs + cidx[r]]) : 0.0;
  }
  __syncthreads();
  auto L = [&](int r, int c) { return double(vb[base[c] + r - c]); };  // live row r (below rows from ns on), c <= r
  auto y_at = [&](int q, int c) { return Y[q * LY + c]; };
  auto load_acc = [&](Acc<double, NT>& acc, int r0) {
    sn::acc_each<NT>(acc, [&](int r, int c, double& v) { v = r0 + r < ns ? Y[(r0 + r) * LY + c] : 0.0; });
  };
  auto store_acc = [&](Acc<double, NT>& acc, int r0) {
    sn::acc_each<NT>(acc, [&](int r, int c, double& v) {
      if (r0 + r < ns) Y[(r0 + r) * LY + c] = v;
    });
  };
  // the diagonal tile at j0 (tj rows) into Ls, zero above its diagonal, and its pivots' reciprocals into rd
  auto load_diag = [&](int j0, int tj) {
    for (int e = tid; e < kTT; e += kThr) {
      const int c = e / kT, r = e % kT;
      Ls[r * kLdS + c] = (r < tj && c <= r) ? L(j0 + r, j0 + c) : 0.0;
    }
    if (tid < tj) rd[tid] = 1.0 / L(j0 + tid, j0 + tid);
    __syncthreads();
  };
  const int nt = tgtile::ntiles(ns);
  if (mode == 0) {
    for (int J = 0; J < nt; ++J) {  // Y_J <- L_JJ^-1 (Y_J - sum_{K < J} L_JK Y_K)
      const int j0 = J * kT, tj = min(kT, ns - j0);
      if (J > 0) {
        Acc<double, NT> acc;
        load_acc(acc, j0);
        sn::gather_mma<NT>(acc, [&](int i, int q) { return -L(j0 + i, q); }, y_at, tj, kc, j0, [](int) { return true; },
                           st);
        store_acc(acc, j0);
      }
      load_diag(j0, tj);
      // warp w: right-hand sides w + 8 q; lane l holds rows l and l + 32 of the tile
      double v0[CPW], v1[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        v0[q] = Y[(j0 + lane) * LY + warp + 8 * q];
        v1[q] = lane + 32 < tj ? Y[(j0 + lane + 32) * LY + warp + 8 * q] : 0.0;
      }
#pragma unroll 4
      for (int jj = 0; jj < tj; ++jj) {
        const double l0 = Ls[lane * kLdS + jj], l1 = Ls[(lane + 32) * kLdS + jj], r = rd[jj];
#pragma unroll
        for (int q = 0; q < CPW; ++q) {
          const double yj = __shfl_sync(0xffffffffu, jj < 32 ? v0[q] : v1[q], jj & 31) * r;
          if (jj < 32) {
            v0[q] = lane == jj ? yj : v0[q] - l0 * yj;  // L[lane][jj] = 0 above the diagonal
            v1[q] -= l1 * yj;
          } else {
            v1[q] = lane + 32 == jj ? yj : v1[q] - l1 * yj;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        if (lane < tj) Y[(j0 + lane) * LY + warp + 8 * q] = v0[q];
        if (lane + 32 < tj) Y[(j0 + lane + 32) * LY + warp + 8 * q] = v1[q];
      }
      __syncthreads();
    }
  } else if (mode == 1) {
    for (int I = 0; I < nt && m > 0; ++I) {  // Y <- Y - Lb^T x[rows]
      const int i0 = I * kT;
      Acc<double, NT> acc;
      load_acc(acc, i0);
      sn::gather_mma<NT>(
          acc, [&](int i, int q) { return -L(ns + q, i0 + i); },
          [&](int q, int c) { return double(x[(row0 + c) * xs + ridx[q]]); }, min(kT, ns - i0), kc, m,
          [](int) { return false; }, st);
      store_acc(acc, i0);
    }
    __syncthreads();
    for (int J = nt - 1; J >= 0; --J) {  // Y_J <- L_JJ^-T (Y_J - sum_{K > J} L_KJ^T Y_K)
      const int j0 = J * kT, tj = min(kT, ns - j0);
      if (J < nt - 1) {
        Acc<double, NT> acc;
        load_acc(acc, j0);
        sn::gather_mma<NT>(
            acc, [&](int i, int q) { return -L(j0 + kT + q, j0 + i); },
            [&](int q, int c) { return Y[(j0 + kT + q) * LY + c]; }, tj, kc, ns - j0 - kT, [](int) { return false; },
            st);
        store_acc(acc, j0);
      }
      load_diag(j0, tj);
      double v0[CPW], v1[CPW];
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        v0[q] = Y[(j0 + lane) * LY + warp + 8 * q];
        v1[q] = lane + 32 < tj ? Y[(j0 + lane + 32) * LY + warp + 8 * q] : 0.0;
      }
#pragma unroll 4
      for (int jj = tj - 1; jj >= 0; --jj) {
        const double l0 = Ls[jj * kLdS + lane], l1 = Ls[jj * kLdS + lane + 32], r = rd[jj];
#pragma unroll
        for (int q = 0; q < CPW; ++q) {
          const double yj = __shfl_sync(0xffffffffu, jj < 32 ? v0[q] : v1[q], jj & 31) * r;
          if (jj < 32) {
            v0[q] = lane == jj ? yj : v0[q] - l0 * yj;  // L[jj][lane] = 0 right of the diagonal
          } else {
            v1[q] = lane + 32 == jj ? yj : v1[q] - l1 * yj;
            v0[q] -= l0 * yj;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < CPW; ++q) {
        if (lane < tj) Y[(j0 + lane) * LY + warp + 8 * q] = v0[q];
        if (lane + 32 < tj) Y[(j0 + lane + 32) * LY + warp + 8 * q] = v1[q];
      }
      __syncthreads();
    }
  } else if (mode == 3) {
    for (int J = 0; J < nt; ++J) {  // x[cols]_J = sum_{q >= j0 + i} L(q, j0 + i) z_q + Lb^T z[rows]
      const int j0 = J * kT, tj = min(kT, ns - j0);
      Acc<double, NT> acc;
      acc.zero();
      sn::gather_mma<NT>(
          acc, [&](int i, int q) { return q >= i ? L(j0 + q, j0 + i) : 0.0; },
          [&](int q, int c) { return Y[(j0 + q) * LY + c]; }, tj, kc, ns - j0, [](int) { return false; }, st);
      if (m > 0)
        sn::gather_mma<NT>(
            acc, [&](int i, int q) { return L(ns + q, j0 + i); },
            [&](int q, int c) { return double(z[(row0 + c) * xs + ridx[q]]); }, tj, kc, m, [](int) { return false; },
            st);
      sn::acc_each<NT>(acc, [&](int r, int c, double& v) {
        if (r < tj && c < kc) x[(row0 + c) * xs + cidx[j0 + r]] = T(v);
      });
    }
  } else {
    for (int J = 0; J < nt; ++J) {  // x[cols]_J += sum_{q <= j0 + i} L(j0 + i, q) z_q
      const int j0 = J * kT, tj = min(kT, ns - j0);
      Acc<double, NT> acc;
      acc.zero();
      sn::gather_mma<NT>(
          acc, [&](int i, int q) { return q <= j0 + i ? L(j0 + i, q) : 0.0; }, y_at, tj, kc, j0 + tj,
          [](int) { return true; }, st);
      sn::acc_each<NT>(acc, [&](int r, int c, double& v) {
        if (r < tj && c < kc) x[(row0 + c) * xs + cidx[j0 + r]] += T(v);
      });
    }
  }
  if (mode < 2)
    for (int e = tid; e < ns * NT; e += kThr) {
      const int j = e / ns, r = e % ns;
      if (j < kc) x[(row0 + j) * xs + cidx[r]] = T(Y[r * LY + j]);
    }
  if (mode == 1 || mode == 3 || m == 0) return;
  for (int r0 = 0; r0 < m; r0 += kT) {  // u = Lb y (Lb z)
    Acc<double, NT> acc;
    acc.zero();
    sn::gather_mma<NT>(acc, [&](int i, int q) { return L(ns + r0 + i, q); }, y_at, min(kT, m - r0), kc, ns,
                       [](int) { return true; }, st);
    sn::acc_each<NT>(acc, [&](int r, int c, double& v) {
      if (r0 + r < m && c < kc) u[(row0 + c) * us + ubase + (long long)p * M + r0 + r] = T(v);
    });
  }
}

// ---- K8 -------------------------------------------------------------------
//
// The step Sigma_RJ = -Sigma_RR C, Sigma_JJ = A - C^T Sigma_RJ with C = Lb Ld^-1
// and A = Ld^-T Ld^-1 is split in two entries. `sn_takahashi_prep` forms C (in
// Lb's positions) and A (lower, in Ld's positions) of every supernode into a
// buffer laid out like vals, one more (B, nnzL+1) buffer per sweep: none of it
// depends on Sigma, so one launch covers every supernode of a size class on
// every level. `sn_takahashi` then does only the Sigma-dependent products, level
// by level. All products run in float64 on the tensor cores (tgtile's
// mma_slice, m16n8k4) from operands gathered through the panel and Schur index
// tables as they are staged into shared memory, so a float32 factor is inverted
// and multiplied in float64 and rounded once on the way out.

namespace k8 {

using sn::acc_each;
using sn::gather_mma;
using sn::rows_contiguous;
using sn::stage_values;
using tgtile::Acc;
using tgtile::Cfg;
using tgtile::kKS;
using tgtile::kLdS;
using tgtile::kT;
using tgtile::kThr;
using tgtile::kTT;

// K8's first entry, a panel of width W <= 64: block (t, p, b) inverts Ld in
// shared memory (tgtile::invert_blocked, blocks of 16) and forms A (t = 0) or
// the 64-row tile t - 1 of C, with X = Ld^-1 read from shared memory.
template <typename T, int NT>
__global__ void __launch_bounds__(kThr)
    sn_prep_tile_kernel(const T* __restrict__ vals, long long vs, T* __restrict__ pre, long long ps,
                        const int* __restrict__ panel_idx, int W, int M, int dummy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* X = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS: Ld^-1
  double* rinv = X + kT * kLdS;                     // 64
  double* st = rinv + kT;                           // Ld while it is inverted, then the products' staging
  const int t = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0 || (t > 0 && (t - 1) * kT >= m)) return;
  const T* vb = vals + b * vs;
  T* pb = pre + b * ps;
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // Ld in float64, the identity beyond ns
    const int r = e / kT, c = e % kT;
    st[r * kLdS + c] = (r < ns && c <= r) ? double(vb[pidx[r * W + c]]) : (r == c ? 1.0 : 0.0);
  }
  __syncthreads();
  if (threadIdx.x < kT) rinv[threadIdx.x] = 1.0 / st[threadIdx.x * (kLdS + 1)];
  __syncthreads();
  tgtile::invert_blocked(st, rinv, X);
  auto x_at = [&](int r, int c) { return c <= r ? X[r * kLdS + c] : 0.0; };
  Acc<double, NT> acc;
  acc.zero();
  if (t == 0) {  // A = X^T X, lower
    gather_mma<NT>(
        acc, [&](int i, int q) { return x_at(q, i); }, [&](int q, int j) { return x_at(q, j); }, ns, ns, ns,
        [](int) { return true; }, st);
    acc_each<NT>(acc, [&](int r, int c, double& v) {
      if (r < ns && c <= r) pb[pidx[r * W + c]] = T(v);
    });
    return;
  }
  const int r0 = (t - 1) * kT;  // C = Lb X, rows r0 .. r0 + 63
  const bool by_rows = rows_contiguous(pidx, W, ns);
  gather_mma<NT>(
      acc, [&](int i, int q) { return double(vb[pidx[(W + r0 + i) * W + q]]); },
      [&](int q, int j) { return x_at(q, j); }, min(kT, m - r0), ns, ns, [&](int) { return by_rows; }, st);
  acc_each<NT>(acc, [&](int r, int c, double& v) {
    if (r0 + r < m && c < ns) pb[pidx[(W + r0 + r) * W + c]] = T(v);
  });
}

// K8's first entry, a panel of width W > 64: three launches over a float64
// workspace slice per (supernode, chain), X = Ld^-1 (W x W, row stride W),
// then Ld's inverted diagonal tiles (ntiles(W) x 64 x 64). Nothing in them
// waits on another block, so every launch spreads over the whole card.
//   1. sn_prep_dinv_kernel, block (j, p, b): diagonal tile j of Ld, inverted
//      in shared memory by blocks of 16 (tgtile::invert_blocked);
//   2. sn_prep_inverse_kernel, block (J, p, b): column tile J of X by forward
//      substitution down the tile rows, X_JJ = D_J^-1 and, for i > J,
//      X_iJ = -D_i^-1 sum_{J <= k < i} L_ik X_kJ;
//   3. sn_prep_product_kernel, block (t, p, b): one 64 x 64 tile of C = Lb X
//      or of A = X^T X (lower), X's zeros above the diagonal skipped in the
//      depth.
__device__ __forceinline__ long long prep_slice(int W) {
  return (long long)W * W + (long long)tgtile::ntiles(W) * kTT;
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_dinv_kernel(const T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx, int W, int M,
                        int dummy, double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* S = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS
  double* X = S + kT * kLdS;                        // 64 x kLdS
  double* rinv = X + kT * kLdS;                     // 64
  const int j = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, j0 = j * kT, t = min(kT, ns - j0);
  if (t <= 0) return;
  const T* vb = vals + b * vs;
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // the identity beyond t
    const int r = e / kT, c = e % kT;
    S[r * kLdS + c] = (r < t && c <= r) ? double(vb[pidx[(j0 + r) * W + j0 + c]]) : (r == c ? 1.0 : 0.0);
  }
  __syncthreads();
  if (threadIdx.x < kT) rinv[threadIdx.x] = 1.0 / S[threadIdx.x * (kLdS + 1)];
  __syncthreads();
  tgtile::invert_blocked(S, rinv, X);
  double* D = work + (b * gridDim.y + p) * prep_slice(W) + (long long)W * W + (long long)j * kTT;
  tgtile::store_lower(X, t, D);
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_inverse_kernel(const T* __restrict__ vals, long long vs, const int* __restrict__ panel_idx, int W,
                           int M, int dummy, double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* Tt = reinterpret_cast<double*>(smem_raw);  // 64 x kLdS: sum_k L_ik X_kJ
  double* st = Tt + kT * kLdS;                        // the products' staging
  const int J = blockIdx.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, J0 = J * kT, tj = min(kT, ns - J0);
  if (tj <= 0) return;
  const T* vb = vals + b * vs;
  double* X = work + (b * gridDim.y + p) * prep_slice(W);
  const double* Dinv = X + (long long)W * W;
  const bool by_rows = rows_contiguous(pidx, W, ns);
  for (int e = threadIdx.x; e < kTT; e += kThr) {  // X_JJ = D_J^-1
    const int r = e / kT, c = e % kT;
    if (r < tj && c < tj) X[(long long)(J0 + r) * W + J0 + c] = __ldcg(Dinv + (long long)J * kTT + e);
  }
  __syncthreads();
  for (int i = J + 1; i * kT < ns; ++i) {
    const int i0 = i * kT, ti = min(kT, ns - i0);
    Acc<double, 64> acc;
    acc.zero();
    gather_mma<64>(
        acc, [&](int r, int q) { return double(vb[pidx[(i0 + r) * W + J0 + q]]); },
        [&](int q, int c) { return __ldcg(X + (long long)(J0 + q) * W + J0 + c); }, ti, tj, i0 - J0,
        [&](int) { return by_rows; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) { Tt[r * kLdS + c] = v; });
    __syncthreads();
    acc.zero();
    gather_mma<64>(
        acc, [&](int r, int q) { return q <= r ? -__ldcg(Dinv + (long long)i * kTT + r * kT + q) : 0.0; },
        [&](int q, int c) { return Tt[q * kLdS + c]; }, ti, tj, ti, [](int) { return true; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) {
      if (r < ti && c < tj) X[(long long)(i0 + r) * W + J0 + c] = v;
    });
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThr)
    sn_prep_product_kernel(const T* __restrict__ vals, long long vs, T* __restrict__ pre, long long ps,
                           const int* __restrict__ panel_idx, int W, int M, int dummy,
                           const double* __restrict__ work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* st = reinterpret_cast<double*>(smem_raw);
  const int p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m, nt = tgtile::ntiles(ns), ct = (m + kT - 1) / kT;
  int t = blockIdx.x;
  if (ns == 0 || t >= ct * nt + nt * (nt + 1) / 2) return;
  const T* vb = vals + b * vs;
  T* pb = pre + b * ps;
  const double* X = work + (b * gridDim.y + p) * prep_slice(W);
  auto xg = [&](int r, int c) { return __ldcg(X + (long long)r * W + c); };
  Acc<double, 64> acc;
  acc.zero();
  if (t < ct * nt) {  // C's tile (I, J): the depth from J's first column
    const int r0 = t / nt * kT, c0 = t % nt * kT;
    const bool by_rows = rows_contiguous(pidx, W, ns);
    gather_mma<64>(
        acc, [&](int i, int q) { return double(vb[pidx[(W + r0 + i) * W + c0 + q]]); },
        [&](int q, int j) { return xg(c0 + q, c0 + j); }, min(kT, m - r0), min(kT, ns - c0), ns - c0,
        [&](int) { return by_rows; }, st);
    acc_each<64>(acc, [&](int r, int c, double& v) {
      if (r0 + r < m && c0 + c < ns) pb[pidx[(W + r0 + r) * W + c0 + c]] = T(v);
    });
    return;
  }
  t -= ct * nt;  // A's tile (I, J), J <= I, the depth from I's first row
  int I = 0;
  while (t > I) t -= ++I;
  const int r0 = I * kT, c0 = t * kT;
  gather_mma<64>(
      acc, [&](int i, int q) { return xg(r0 + q, r0 + i); }, [&](int q, int j) { return xg(r0 + q, c0 + j); },
      min(kT, ns - r0), min(kT, ns - c0), ns - r0, [](int) { return true; }, st);
  acc_each<64>(acc, [&](int r, int c, double& v) {
    if (r0 + r < ns && c0 + c <= r0 + r) pb[pidx[(r0 + r) * W + c0 + c]] = T(v);
  });
}

// K8: one class batch of one level. Sigma_RJ = -Sigma_RR C by 64 x NT tiles
// (Sigma_RR gathered through the Schur table, mirrored; C from pre), then
// Sigma_JJ = A - C^T Sigma_RJ by its lower tiles (A and C from pre, Sigma_RJ
// read back from sig). Phase 0: a cluster of cs = gridDim.x blocks per
// (supernode, chain) deals out the tiles of both products, with a cluster
// barrier between them (the many small supernodes of the scan levels).
// Phases 1 and 2: one launch per product, a block per tile, for batches of
// few supernodes whose tiles outnumber a cluster (the top separators, the
// banded steps), so that the tiles spread over the whole card.
template <typename T, int NT>
__global__ void __launch_bounds__(kThr)
    sn_takahashi_kernel(const T* __restrict__ pre, long long ps, T* __restrict__ sig, long long ss,
                        const int* __restrict__ panel_idx, const int* __restrict__ schur_idx, int W, int M,
                        int dummy, int phase) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ns, s_m;
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int rank = blockIdx.x, cs = gridDim.x, p = blockIdx.y;
  const long long b = blockIdx.z;
  const int* pidx = panel_idx + (long long)p * (W + M) * W;
  const int* sidx = schur_idx + (long long)p * M * M;
  live_dims(pidx, W, M, dummy, &s_ns, &s_m);
  const int ns = s_ns, m = s_m;
  if (ns == 0) return;  // the whole cluster
  const T* pb = pre + b * ps;
  T* sb = sig + b * ss;
  const bool by_rows = rows_contiguous(pidx, W, ns);
  auto below = [&](const T* v, int r, int c) { return double(__ldcg(v + pidx[(W + r) * W + c])); };
  const int ncol = (ns + NT - 1) / NT;
  int idx = 0;
  if (m && phase != 2) {
    for (int I = 0; I < (m + kT - 1) / kT; ++I)
      for (int J = 0; J < ncol; ++J, ++idx) {
        if (idx % cs != rank) continue;
        const int r0 = I * kT, c0 = J * NT;
        Acc<double, NT> acc;
        acc.zero();
        gather_mma<NT>(
            acc,
            [&](int i, int q) {
              const int r = r0 + i, id = r >= q ? sidx[r * M + q] : sidx[q * M + r];
              return id != dummy ? -double(__ldcg(sb + id)) : 0.0;
            },
            [&](int q, int j) { return below(pb, q, c0 + j); }, min(kT, m - r0), min(NT, ns - c0), m,
            [&](int k0) { return k0 + kKS > r0; }, sm);  // a slice below the diagonal reads Schur rows
        acc_each<NT>(acc, [&](int r, int c, double& v) {
          if (r0 + r < m && c0 + c < ns) sb[pidx[(W + r0 + r) * W + c0 + c]] = T(v);
        });
      }
    if (phase == 0) tgtile::csync();
  }
  if (phase == 1) return;
  idx = 0;
  for (int I = 0; I < (ns + kT - 1) / kT; ++I)
    for (int J = 0; J < ncol && J * NT < (I + 1) * kT; ++J, ++idx) {
      if (idx % cs != rank) continue;
      const int r0 = I * kT, c0 = J * NT;
      Acc<double, NT> acc;
      acc_each<NT>(acc, [&](int r, int c, double& v) {
        const int rr = r0 + r, cc = c0 + c;
        v = (rr < ns && cc <= rr) ? double(pb[pidx[rr * W + cc]]) : 0.0;
      });
      gather_mma<NT>(
          acc, [&](int i, int q) { return -below(pb, q, r0 + i); }, [&](int q, int j) { return below(sb, q, c0 + j); },
          min(kT, ns - r0), min(NT, ns - c0), m, [&](int) { return !by_rows; }, sm);
      acc_each<NT>(acc, [&](int r, int c, double& v) {
        const int rr = r0 + r, cc = c0 + c;
        if (rr < ns && cc <= rr) sb[pidx[rr * W + cc]] = T(v);
      });
    }
}

}  // namespace k8

// K6 on ng class batches (descriptors bt on the card) of `units` supernodes
// in all, widest Wmax: cs == 0 runs the one-block path (Wmax <= 64), cs > 0
// the cluster path in clusters of cs, on the workspace (each batch's slices
// at its offset) and 3 B units int flags.
template <typename T>
int launch_panel(T* vals, long long vs, const Batch* bt, int ng, int units, int Wmax, int dummy, T* u, long long us,
                 T* logpiv, int n, int* boost, T* work, int* flags, int cs, int B, void* stream) {
  if (units == 0 || B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (cs == 0) {
    if (Wmax > kT) return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(double) * kPanelTileValues;
    int rc = tgtile::smem_attr(sn_panel_tile_kernel<T>, smem);
    if (rc) return rc;
    sn_panel_tile_kernel<T><<<dim3(units, B), kThr, smem, st>>>(vals, vs, bt, ng, dummy, u, us, logpiv, n, boost);
    return (int)cudaGetLastError();
  }
  if (work == nullptr || flags == nullptr) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(sn_panel_cluster_kernel<T>, dim3(cs, units, B), cs, tgtile::chol_rows_smem<T>(), st,
                                vals, vs, bt, ng, dummy, u, us, logpiv, n, boost, work, flags);
}

// How many clusters of cs blocks of K6's cluster path the card holds at once (0 for a cluster size it refuses).
template <typename T>
int panel_fit(int cs, int* count) {
  return tgtile::cluster_fit(sn_panel_cluster_kernel<T>, cs, tgtile::chol_rows_smem<T>(), count);
}

template <typename T, int NT>
int launch_trsv_nt(const T* vals, long long vs, const Batch* bt, int ng, int units, int Wmax, int dummy, T* x,
                   long long xs, int k, T* u, long long us, int mode, int B, const T* z, cudaStream_t st) {
  const size_t smem = trsv_smem<NT>(Wmax);
  int rc = tgtile::smem_attr(sn_trsv_kernel<T, NT>, smem);
  if (rc) return rc;
  sn_trsv_kernel<T, NT><<<dim3(units, B, (k + NT - 1) / NT), kThr, smem, st>>>(vals, vs, bt, ng, Wmax, dummy, x, xs,
                                                                              k, u, us, mode, z);
  return (int)cudaGetLastError();
}

// K7 on ng class batches (descriptors bt on the card) of `units` supernodes in
// all, widest Wmax, for B chains of k right-hand sides each, nt (8 or 64) of
// them per block.
template <typename T>
int launch_trsv(const T* vals, long long vs, const Batch* bt, int ng, int units, int Wmax, int dummy, T* x,
                long long xs, int k, T* u, long long us, int mode, int B, const T* z, int nt, void* stream) {
  if (units == 0 || B == 0 || k == 0) return 0;
  if ((mode >= 2 && z == nullptr) || mode > 3 || (nt != 8 && nt != 64)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nt == 8) return launch_trsv_nt<T, 8>(vals, vs, bt, ng, units, Wmax, dummy, x, xs, k, u, us, mode, B, z, st);
  return launch_trsv_nt<T, 64>(vals, vs, bt, ng, units, Wmax, dummy, x, xs, k, u, us, mode, B, z, st);
}

// Dynamic shared memory of K8's first entry's tile path: X = Ld^-1 beside
// the staged products (Ld while it is inverted).
template <int NT>
constexpr size_t prep_tile_smem() {
  return sizeof(double) * (k8::kT * k8::kLdS + k8::kT +
                           (k8::stage_values<NT>() > k8::kT * k8::kLdS ? k8::stage_values<NT>() : k8::kT * k8::kLdS));
}

template <typename T, int NT>
int launch_prep_tile(const T* vals, long long vs, T* pre, long long ps, const int* panel_idx, int P, int W, int M,
                     int dummy, int B, cudaStream_t st) {
  const size_t smem = prep_tile_smem<NT>();
  int rc = tgtile::smem_attr(k8::sn_prep_tile_kernel<T, NT>, smem);
  if (rc) return rc;
  k8::sn_prep_tile_kernel<T, NT><<<dim3(1 + (M + k8::kT - 1) / k8::kT, P, B), k8::kThr, smem, st>>>(
      vals, vs, pre, ps, panel_idx, W, M, dummy);
  return (int)cudaGetLastError();
}

// K8's first entry: W <= 64 on the tile path (no workspace), else the three
// launches of the wide path on `work` (float64, B P (W^2 + ntiles(W) 64^2)).
template <typename T>
int launch_takahashi_prep(const T* vals, long long vs, T* pre, long long ps, const int* panel_idx, int P, int W,
                          int M, int dummy, double* work, int B, void* stream) {
  if (P == 0 || B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 8) return launch_prep_tile<T, 8>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, B, st);
  if (W <= k8::kT) return launch_prep_tile<T, 64>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, B, st);
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  using k8::kLdS;
  using k8::kT;
  const int nt = tgtile::ntiles(W);
  const size_t s1 = sizeof(double) * (2 * kT * kLdS + kT), s2 = sizeof(double) * (kT * kLdS + k8::stage_values<64>()),
               s3 = sizeof(double) * k8::stage_values<64>();
  int rc = tgtile::smem_attr(k8::sn_prep_dinv_kernel<T>, s1);
  if (!rc) rc = tgtile::smem_attr(k8::sn_prep_inverse_kernel<T>, s2);
  if (!rc) rc = tgtile::smem_attr(k8::sn_prep_product_kernel<T>, s3);
  if (rc) return rc;
  k8::sn_prep_dinv_kernel<T><<<dim3(nt, P, B), k8::kThr, s1, st>>>(vals, vs, panel_idx, W, M, dummy, work);
  k8::sn_prep_inverse_kernel<T><<<dim3(nt, P, B), k8::kThr, s2, st>>>(vals, vs, panel_idx, W, M, dummy, work);
  k8::sn_prep_product_kernel<T><<<dim3((M + kT - 1) / kT * nt + nt * (nt + 1) / 2, P, B), k8::kThr, s3, st>>>(
      vals, vs, pre, ps, panel_idx, W, M, dummy, work);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_sweep(const T* pre, long long ps, T* sig, long long ss, const int* panel_idx, const int* schur_idx, int P,
                 int W, int M, int dummy, int cs, int t1, int t2, int B, cudaStream_t st) {
  const size_t smem = sizeof(double) * k8::stage_values<NT>();
  if (cs > 0)  // phase 0: a cluster of cs per supernode and chain
    return tgtile::launch_cluster(k8::sn_takahashi_kernel<T, NT>, dim3(cs, P, B), cs, smem, st, pre, ps, sig, ss,
                                  panel_idx, schur_idx, W, M, dummy, 0);
  int rc = tgtile::smem_attr(k8::sn_takahashi_kernel<T, NT>, smem);
  for (int phase = t1 > 0 ? 1 : 2; phase <= 2 && !rc; ++phase) {  // no rows below: Sigma_JJ = A alone
    k8::sn_takahashi_kernel<T, NT><<<dim3(phase == 1 ? t1 : t2, P, B), k8::kThr, smem, st>>>(
        pre, ps, sig, ss, panel_idx, schur_idx, W, M, dummy, phase);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

// K8: cs > 0 runs phase 0 in clusters of cs (t1, t2 unused); cs == 0 runs
// phases 1 and 2, over t1 and t2 blocks per supernode and chain (at least the
// batch's tile counts; t1 = 0 when no rows lie below).
template <typename T>
int launch_takahashi(const T* pre, long long ps, T* sig, long long ss, const int* panel_idx, const int* schur_idx,
                     int P, int W, int M, int dummy, int cs, int t1, int t2, int B, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (cs < 0 || (cs == 0 && (t1 < 0 || t2 < 1))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (W <= 8) return launch_sweep<T, 8>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, B, st);
  return launch_sweep<T, 64>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, B, st);
}


// ---- K20 and K21: the tangents (csrc/tangent.cuh) -------------------------------------------------

namespace tk {

// Gathers panel p's (W + M) x W values of one chain: rows < W into the W x W
// slot `top` (a padded column, whose diagonal position is DUMMY, gets
// `pad` on its diagonal), rows >= W into the M x W slot `below`.
template <typename T>
__device__ void gather_panel(const tgt::Team& team, const T* src, const int* pidx, int W, int M, int dummy,
                             double pad, double* top, double* below) {
  for (int e = tgt::first(team); e < (W + M) * W; e += tgt::stride(team)) {
    const int pos = pidx[e], i = e / W, j = e % W;
    const double v = pos != dummy ? double(src[pos]) : (i == j ? pad : 0.0);
    if (i < W)
      top[e] = v;
    else
      below[e - W * W] = v;
  }
}

template <typename T>
__device__ void gather_square(const tgt::Team& team, const T* src, const int* idx, int M, int dummy, double* out) {
  for (int e = tgt::first(team); e < M * M; e += tgt::stride(team)) {
    const int pos = idx[e];
    out[e] = pos != dummy ? double(src[pos]) : 0.0;
  }
}

// Writes panel p's live positions: the lower triangle of `top` (zero above
// it) and `below`.
template <typename T>
__device__ void scatter_panel(const tgt::Team& team, T* dst, const int* pidx, int W, int M, int dummy,
                              const double* top, const double* below) {
  for (int e = tgt::first(team); e < (W + M) * W; e += tgt::stride(team)) {
    const int pos = pidx[e], i = e / W, j = e % W;
    if (pos == dummy) continue;
    dst[pos] = T(i < W ? (i >= j ? tgt::ld(top + e) : 0.0) : tgt::ld(below + e - W * W));
  }
}

// K20: supernode blockIdx.x / cluster size of the batch on chain blockIdx.y, on one cluster.
template <typename T>
__global__ void __launch_bounds__(tgt::kThreads)
    sn_panel_tangent_kernel(const T* __restrict__ vals, long long vs, const T* __restrict__ pre, T* dvals,
                            long long ps, T* __restrict__ du, long long us, long long ubase,
                            const int* __restrict__ panel_idx, int P, int W, int M, int dummy, double* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const tgt::Team t = tgt::cluster_team();
  const int p = blockIdx.x / t.size, b = blockIdx.y;
  const int* pidx = panel_idx + (long)p * (W + M) * W;
  tgt::Slots sl(work + ((long)b * P + p) * tgt::tangent_slice(W, M), W, M);
  gather_panel(t, vals + b * vs, pidx, W, M, dummy, 1.0, sl.w[0], sl.m[0]);  // Ld, Lb
  gather_panel(t, pre + b * ps, pidx, W, M, dummy, 0.0, sl.w[1], sl.m[3]);   // A (C unused)
  gather_panel(t, dvals + b * ps, pidx, W, M, dummy, 0.0, sl.w[2], sl.m[1]);  // dAjj, dArj
  tgt::team_sync();
  tgt::symmetrize(t, sl.w[1], W);
  tgt::symmetrize(t, sl.w[2], W);
  tgt::panel_tangent(t, W, M, sl.w[0], sl.m[0], sl.w[1], sl.w[2], sl.m[1], sl.w[3], sl.w[4], sl.w[5], sl.w[6],
                     sl.m[2], sl.q[0], false, smem);
  scatter_panel(t, dvals + b * ps, pidx, W, M, dummy, sl.w[6], sl.m[2]);
  if (M) {
    T* u = du + b * us + ubase + (long)p * M * M;
    for (int e = tgt::first(t); e < M * M; e += tgt::stride(t)) u[e] = T(tgt::ld(sl.q[0] + e));
  }
}

// K21: supernode blockIdx.x / cluster size of the batch on chain blockIdx.y, on one cluster.
template <typename T>
__global__ void __launch_bounds__(tgt::kThreads)
    sn_takahashi_tangent_kernel(const T* __restrict__ vals, long long vs, const T* __restrict__ pre,
                                const T* __restrict__ dvals, const T* __restrict__ sig, T* dsig, long long ps,
                                const int* __restrict__ panel_idx, const int* __restrict__ schur_idx, int P, int W,
                                int M, int dummy, double* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const tgt::Team t = tgt::cluster_team();
  const int p = blockIdx.x / t.size, b = blockIdx.y;
  const int* pidx = panel_idx + (long)p * (W + M) * W;
  const int* sidx = schur_idx + (long)p * M * M;
  tgt::Slots sl(work + ((long)b * P + p) * tgt::tangent_slice(W, M), W, M);
  double *Ld = sl.w[0], *A = sl.w[1], *dLd = sl.w[2], *dSjj = sl.w[6];
  double *C = sl.m[0], *dLb = sl.m[1], *Srj = sl.m[2], *dSrj = sl.m[5];
  gather_panel(t, vals + b * vs, pidx, W, M, dummy, 1.0, Ld, sl.m[3]);  // Ld (Lb unused)
  gather_panel(t, pre + b * ps, pidx, W, M, dummy, 0.0, A, C);
  gather_panel(t, dvals + b * ps, pidx, W, M, dummy, 0.0, dLd, dLb);
  gather_panel(t, sig + b * ps, pidx, W, M, dummy, 0.0, sl.w[3], Srj);  // (Sigma_JJ unused)
  gather_square(t, sig + b * ps, sidx, M, dummy, sl.q[0]);
  gather_square(t, dsig + b * ps, sidx, M, dummy, sl.q[1]);
  tgt::team_sync();
  tgt::symmetrize(t, A, W);
  tgt::symmetrize(t, sl.q[0], M);
  tgt::symmetrize(t, sl.q[1], M);
  tgt::takahashi_tangent(t, W, M, Ld, A, C, dLd, dLb, sl.q[0], sl.q[1], Srj, sl.w[3], sl.w[4], sl.w[5], sl.m[3],
                         sl.m[4], dSjj, dSrj, smem);
  scatter_panel(t, dsig + b * ps, pidx, W, M, dummy, dSjj, dSrj);
}

template <typename T>
int launch_panel_tangent(const T* vals, long long vs, const T* pre, T* dvals, long long ps, T* du, long long us,
                         long long ubase, const int* panel_idx, int P, int W, int M, int dummy, double* work, int B,
                         int cs, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (B > 65535 || cs < 1 || cs > tgt::kTeamMax) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(sn_panel_tangent_kernel<T>, dim3(P * cs, B), cs, tgt::kSmemBytes,
                                (cudaStream_t)stream, vals, vs, pre, dvals, ps, du, us, ubase, panel_idx, P, W, M,
                                dummy, work);
}

template <typename T>
int launch_takahashi_tangent(const T* vals, long long vs, const T* pre, const T* dvals, const T* sig, T* dsig,
                             long long ps, const int* panel_idx, const int* schur_idx, int P, int W, int M,
                             int dummy, double* work, int B, int cs, void* stream) {
  if (P == 0 || B == 0) return 0;
  if (B > 65535 || cs < 1 || cs > tgt::kTeamMax) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(sn_takahashi_tangent_kernel<T>, dim3(P * cs, B), cs, tgt::kSmemBytes,
                                (cudaStream_t)stream, vals, vs, pre, dvals, sig, dsig, ps, panel_idx, schur_idx, P,
                                W, M, dummy, work);
}

// K25: supernode blockIdx.x / cluster size of the batch on chain blockIdx.y, on one cluster. gvals holds the
// factor's cotangent on vals' layout; the batch's panels are overwritten with the cotangent of their (updated)
// inputs, after those of every ancestor (the levels descending), which the Schur table reads.
template <typename T>
__global__ void __launch_bounds__(tgt::kThreads)
    sn_panel_adjoint_kernel(const T* __restrict__ vals, long long vs, const T* __restrict__ pre, T* gvals,
                            long long ps, const int* __restrict__ panel_idx, const int* __restrict__ schur_idx, int P,
                            int W, int M, int dummy, double* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const tgt::Team t = tgt::cluster_team();
  const int p = blockIdx.x / t.size, b = blockIdx.y;
  const int* pidx = panel_idx + (long)p * (W + M) * W;
  tgt::Slots sl(work + ((long)b * P + p) * tgt::tangent_slice(W, M), W, M);
  double *Ld = sl.w[0], *A = sl.w[1], *gLd = sl.w[2], *gAjj = sl.w[6];
  double *Lb = sl.m[0], *gLb = sl.m[1], *gArj = sl.m[2];
  gather_panel(t, vals + b * vs, pidx, W, M, dummy, 1.0, Ld, Lb);
  gather_panel(t, pre + b * ps, pidx, W, M, dummy, 0.0, A, sl.m[3]);  // A (C unused)
  gather_panel(t, gvals + b * ps, pidx, W, M, dummy, 0.0, gLd, gLb);
  if (M) gather_square(t, gvals + b * ps, schur_idx + (long)p * M * M, M, dummy, sl.q[0]);
  tgt::team_sync();
  tgt::symmetrize(t, A, W);
  tgt::panel_adjoint(t, W, M, Ld, Lb, A, gLd, gLb, sl.q[0], sl.w[3], sl.w[4], sl.w[5], sl.q[1], gAjj, gArj, smem);
  scatter_panel(t, gvals + b * ps, pidx, W, M, dummy, gAjj, gArj);
}

template <typename T>
int launch_panel_adjoint(const T* vals, long long vs, const T* pre, T* gvals, long long ps, const int* panel_idx,
                         const int* schur_idx, int P, int W, int M, int dummy, double* work, int B, int cs,
                         void* stream) {
  if (P == 0 || B == 0) return 0;
  if (B > 65535 || cs < 1 || cs > tgt::kTeamMax) return (int)cudaErrorInvalidValue;
  return tgtile::launch_cluster(sn_panel_adjoint_kernel<T>, dim3(P * cs, B), cs, tgt::kSmemBytes,
                                (cudaStream_t)stream, vals, vs, pre, gvals, ps, panel_idx, schur_idx, P, W, M, dummy,
                                work);
}

// How many clusters of cs blocks of K20 (which = 0), K21 (1) or K25 (2) the card holds at once.
template <typename T>
int tangent_fit(int cs, int which, int* count) {
  if (which == 2) return tgtile::cluster_fit(sn_panel_adjoint_kernel<T>, cs, tgt::kSmemBytes, count);
  return which ? tgtile::cluster_fit(sn_takahashi_tangent_kernel<T>, cs, tgt::kSmemBytes, count)
               : tgtile::cluster_fit(sn_panel_tangent_kernel<T>, cs, tgt::kSmemBytes, count);
}

}  // namespace tk

}  // namespace

extern "C" {

#define TG_SN_ENTRY(SUF, T)                                                                                      \
  int tg_sn_panel_##SUF(T* vals, long long vs, const void* batches, int ng, int units, int Wmax, int dummy, T* u, \
                        long long us, T* logpiv, int n, int* boost, T* work, int* flags, int cs, int B,           \
                        void* stream) {                                                                          \
    return launch_panel<T>(vals, vs, static_cast<const Batch*>(batches), ng, units, Wmax, dummy, u, us, logpiv,   \
                           n, boost, work, flags, cs, B, stream);                                                \
  }                                                                                                              \
  int tg_sn_panel_fit_##SUF(int cs, int* count) { return panel_fit<T>(cs, count); }                             \
  int tg_sn_trsv_##SUF(const T* vals, long long vs, const void* batches, int ng, int units, int Wmax, int dummy,   \
                       T* x, long long xs, int k, T* u, long long us, int mode, int B, const T* z, int nt,       \
                       void* stream) {                                                                           \
    return launch_trsv<T>(vals, vs, static_cast<const Batch*>(batches), ng, units, Wmax, dummy, x, xs, k, u, us,   \
                          mode, B, z, nt, stream);                                                               \
  }                                                                                                              \
  int tg_sn_takahashi_prep_##SUF(const T* vals, long long vs, T* pre, long long ps,                 \
                                 const int* panel_idx, int P, int W, int M, int dummy, double* work, \
                                 int B, void* stream) {                                            \
    return launch_takahashi_prep<T>(vals, vs, pre, ps, panel_idx, P, W, M, dummy, work, B, stream); \
  }                                                                                                \
  int tg_sn_takahashi_##SUF(const T* pre, long long ps, T* sig, long long ss,                      \
                            const int* panel_idx, const int* schur_idx, int P, int W, int M,       \
                            int dummy, int cs, int t1, int t2, int B, void* stream) {              \
    return launch_takahashi<T>(pre, ps, sig, ss, panel_idx, schur_idx, P, W, M, dummy, cs, t1, t2, \
                               B, stream);                                                         \
  }                                                                                                \
  int tg_sn_panel_tangent_##SUF(const T* vals, long long vs, const T* pre, T* dvals, long long ps, \
                                T* du, long long us, long long ubase, const int* panel_idx, int P, \
                                int W, int M, int dummy, double* work, int B, int cs,              \
                                void* stream) {                                                    \
    return tk::launch_panel_tangent<T>(vals, vs, pre, dvals, ps, du, us, ubase, panel_idx, P, W, M, \
                                       dummy, work, B, cs, stream);                                \
  }                                                                                                \
  int tg_sn_takahashi_tangent_##SUF(const T* vals, long long vs, const T* pre, const T* dvals,     \
                                    const T* sig, T* dsig, long long ps, const int* panel_idx,     \
                                    const int* schur_idx, int P, int W, int M, int dummy,          \
                                    double* work, int B, int cs, void* stream) {                   \
    return tk::launch_takahashi_tangent<T>(vals, vs, pre, dvals, sig, dsig, ps, panel_idx,         \
                                           schur_idx, P, W, M, dummy, work, B, cs, stream);        \
  }                                                                                                \
  int tg_sn_tangent_fit_##SUF(int cs, int which, int* count) {                                     \
    return tk::tangent_fit<T>(cs, which, count);                                                   \
  }                                                                                                \
  int tg_sn_panel_adjoint_##SUF(const T* vals, long long vs, const T* pre, T* gvals, long long ps, \
                                const int* panel_idx, const int* schur_idx, int P, int W, int M,   \
                                int dummy, double* work, int B, int cs, void* stream) {            \
    return tk::launch_panel_adjoint<T>(vals, vs, pre, gvals, ps, panel_idx, schur_idx, P, W, M,    \
                                       dummy, work, B, cs, stream);                                \
  }

TG_SN_ENTRY(f32, float)
TG_SN_ENTRY(f64, double)

#undef TG_SN_ENTRY

}  // extern "C"
