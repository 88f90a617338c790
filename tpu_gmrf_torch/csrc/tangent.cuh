// The tangents of the supernodal and banded Cholesky and of the block
// Takahashi step, one panel per thread-block cluster, for K20
// sn_panel_tangent, K21 sn_takahashi_tangent (csrc/supernodal.cu) and K22
// bt_factor_tangent (csrc/banded.cu): the derivative of the selected inverse,
// Sigma' = -Sigma Q' Sigma on the fill, in a direction Q' that lies on the
// fill. And the adjoint of the panel's Cholesky, for K24 bt_factor_adjoint
// and K25 sn_panel_adjoint: the cotangent of Q on the fill from that of the
// factor L (the derivative of a sample, a triangular solve or L z).
//
// A panel's operands are gathered from the flat value buffers into a float64
// workspace of its own (row-major, W x W, M x W, M x M), every product runs
// there in float64 (also for float32 chains), and the results are rounded
// once on the way out. Ld^-1 is never solved for: it is Ld^T A with
// A = Ld^-T Ld^-1 from K8's first entry, so every step is a product.
//
// What bounds them. Per panel the work is O(W^3 + M W^2 + M^2 W) flops over
// operands of O(W^2 + M W + M^2) values: at the top separators and the banded
// blocks (W, M up to a few hundred) the float64 tensor-core rate of the SMs
// that run the panel; at the scan levels' many small panels the gathers.
// Design: a panel takes a cluster of `size` blocks (one where the launch has
// enough panels to fill the card; up to 16 for the few wide ones,
// kernels/banded.py tangent_cluster), the 64 x NT output tiles of each
// product dealt out over the cluster and computed by tgtile's tile_mma
// (csrc/tiles.cuh: mma.sync m16n8k4 on the float64 tensor cores, 32-deep
// operand slices double-buffered in shared memory), a cluster barrier
// between products. The workspace is read past L1 (ld.global.cg): another
// block of the cluster may have written it since.
#pragma once

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {
namespace tgt {

namespace cg = cooperative_groups;

constexpr int kThreads = tgtile::kThr;
// The largest cluster a panel takes (kernels/banded.py MAX_CLUSTER).
constexpr int kTeamMax = 16;
// Dynamic shared memory of a tangent kernel: tile_mma's staged slices.
constexpr size_t kSmemBytes = sizeof(double) * tgtile::kSmemValues;

// The blocks of this block's cluster, which share one panel: this block's rank and their number.
struct Team {
  int rank, size;
};

__device__ inline Team cluster_team() {
  const cg::cluster_group c = cg::this_cluster();
  return {int(c.block_rank()), int(c.num_blocks())};
}

// A barrier of the whole cluster, its writes made visible first.
__device__ inline void team_sync() { tgtile::csync(); }

// This thread's first element and the team's stride, for loops over a matrix.
__device__ inline int first(const Team& t) { return t.rank * kThreads + threadIdx.x; }
__device__ inline int stride(const Team& t) { return t.size * kThreads; }

// A workspace value, read past L1.
__device__ inline double ld(const double* p) { return __ldcg(p); }

// How a product meets its output: C = AB, C += AB, C -= AB, C = -AB.
enum Mode { SET, ADD, SUB, NEG };
// What a product may skip: op(A) or op(B) lower (zero above its diagonal) or
// upper (zero below it), which bounds each output tile's depth; LOWER_OUT,
// only the output tiles that reach the diagonal or below it are computed
// (the others are left as they were).
enum Shape { FULL = 0, A_LOWER = 1, A_UPPER = 2, B_LOWER = 4, B_UPPER = 8, LOWER_OUT = 16 };

template <int NT>
__device__ void gemm_tiles(const Team& team, int m, int n, int k, Mode mode, int shape, const double* A,
                           long long sai, long long sak, const double* B, long long sbk, long long sbj, double* C,
                           int ldc, double* smem) {
  const int tj = (n + NT - 1) / NT, tiles = tgtile::ntiles(m) * tj;
  int rank = 0;  // the tiles that remain, dealt out over the cluster in turn
  for (int tile = 0; tile < tiles; ++tile) {
    const int i0 = (tile / tj) * tgtile::kT, j0 = (tile % tj) * NT;
    const int Mr = min(tgtile::kT, m - i0), Nc = min(NT, n - j0);
    if ((shape & LOWER_OUT) && j0 >= i0 + Mr) continue;
    if (rank++ % team.size != team.rank) continue;
    int k0 = 0, k1 = k;
    if (shape & A_LOWER) k1 = min(k1, i0 + Mr);
    if (shape & A_UPPER) k0 = max(k0, i0);
    if (shape & B_LOWER) k0 = max(k0, j0);
    if (shape & B_UPPER) k1 = min(k1, j0 + Nc);
    double* Ct = C + (long long)i0 * ldc + j0;
    tgtile::Acc<double, NT> acc;
    if (mode == ADD || mode == SUB)
      tgtile::tile_io<double, NT, true>(acc, Ct, ldc, Mr, Nc);
    else
      acc.zero();
    if (k1 > k0)
      tgtile::tile_mma<double, NT>(acc, A + i0 * sai + k0 * sak, sai, sak, B + j0 * sbj + k0 * sbk, sbk, sbj, Mr,
                                   Nc, k1 - k0, mode == SUB || mode == NEG, smem);
    tgtile::tile_io<double, NT, false>(acc, Ct, ldc, Mr, Nc);
  }
}

// C (m x n, ldc) <mode> op(A) op(B) for op(A) m x k and op(B) k x n,
// row-major float64 (op(X) = X^T where the flag is set), the output tiles
// dealt out over the cluster; 8-column tiles for n <= 8. `shape` (Shape
// flags) says which tiles and depths the operands' zeros let it skip. C must
// not overlap A or B. Ends with a cluster barrier.
__device__ inline void gemm(const Team& team, int m, int n, int k, Mode mode, int shape, const double* A, int lda,
                            bool ta, const double* B, int ldb, bool tb, double* C, int ldc, double* smem) {
  const long long sai = ta ? 1 : lda, sak = ta ? lda : 1, sbk = tb ? 1 : ldb, sbj = tb ? ldb : 1;
  if (n <= 8)
    gemm_tiles<8>(team, m, n, k, mode, shape, A, sai, sak, B, sbk, sbj, C, ldc, smem);
  else
    gemm_tiles<64>(team, m, n, k, mode, shape, A, sai, sak, B, sbk, sbj, C, ldc, smem);
  team_sync();
}

// Ld^-1 = Ld^T A into Linv (W x W), its lower triangle only: the product's
// tiles above the diagonal are not computed, and the rounding it leaves
// above the diagonal inside the diagonal tiles is set to zero, so that the
// products that follow may skip Linv's upper triangle.
__device__ inline void lower_inverse(const Team& team, int W, const double* Ld, const double* A, double* Linv,
                                     double* smem) {
  gemm(team, W, W, W, SET, A_UPPER | LOWER_OUT, Ld, W, true, A, W, false, Linv, W, smem);
  for (int e = first(team); e < W * W; e += stride(team))
    if (e / W < e % W) Linv[e] = 0.0;
  team_sync();
}

// The symmetric W x W matrix whose lower triangle G holds (upper ignored), in place.
__device__ inline void symmetrize(const Team& team, double* G, int W) {
  for (int e = first(team); e < W * W; e += stride(team)) {
    const int i = e / W, j = e % W;
    if (i < j) G[e] = ld(G + j * W + i);
  }
  team_sync();
}

// Workspace doubles of one panel (W wide, M rows below): the slots below.
__host__ __device__ inline long tangent_slice(int W, int M) {
  return 8L * W * W + 6L * M * W + 2L * M * M;
}

// A panel's workspace: W x W slots w[0..8), M x W slots m[0..6), M x M slots q[0..2).
struct Slots {
  double* w[8];
  double* m[6];
  double* q[2];
  __device__ Slots(double* base, int W, int M) {
    for (int i = 0; i < 8; ++i) w[i] = base + (long)i * W * W;
    for (int i = 0; i < 6; ++i) m[i] = base + 8L * W * W + (long)i * M * W;
    for (int i = 0; i < 2; ++i) q[i] = base + 8L * W * W + 6L * M * W + (long)i * M * M;
  }
};

// The tangent of one panel's Cholesky. In: Ld (W x W lower, padded columns
// with a unit pivot), Lb (M x W), A = Ld^-T Ld^-1 (symmetric), dAjj
// (symmetric) and dArj (M x W), the panel's accumulated Q'. Out: dLd = Ld F
// (its lower triangle; zero above it), F = Phi(Ld^-1 dAjj Ld^-T) (lower,
// half diagonal), dLb = dArj Ld^-T - Lb F^T, and dU = dLb Lb^T + Lb dLb^T
// (symmetric: its lower tiles only where `u_lower`). Ld^-1 = Ld^T A, its
// lower triangle (lower_inverse). Scratch: Linv, H, F.
__device__ inline void panel_tangent(const Team& team, int W, int M, const double* Ld, const double* Lb,
                                     const double* A, const double* dAjj, const double* dArj, double* Linv, double* H,
                                     double* F, double* dLd, double* dLb, double* dU, bool u_lower, double* smem) {
  lower_inverse(team, W, Ld, A, Linv, smem);
  gemm(team, W, W, W, SET, B_UPPER, dAjj, W, false, Linv, W, true, H, W, smem);
  gemm(team, W, W, W, SET, A_LOWER | LOWER_OUT, Linv, W, false, H, W, false, F, W, smem);
  for (int e = first(team); e < W * W; e += stride(team)) {
    const int i = e / W, j = e % W;
    F[e] = i > j ? ld(F + e) : i == j ? 0.5 * ld(F + e) : 0.0;
  }
  team_sync();
  gemm(team, W, W, W, SET, A_LOWER | B_LOWER | LOWER_OUT, Ld, W, false, F, W, false, dLd, W, smem);
  if (M == 0) return;
  gemm(team, M, W, W, SET, B_UPPER, dArj, W, false, Linv, W, true, dLb, W, smem);
  gemm(team, M, W, W, SUB, B_UPPER, Lb, W, false, F, W, true, dLb, W, smem);
  const int out = u_lower ? LOWER_OUT : FULL;
  gemm(team, M, M, W, SET, out, dLb, W, false, Lb, W, true, dU, M, smem);
  gemm(team, M, M, W, ADD, out, Lb, W, false, dLb, W, true, dU, M, smem);
}

// The tangent of one block Takahashi step. In: Ld, A, C = Lb Ld^-1, dLd
// (lower), dLb, Srr and dSrr (symmetric), Srj. Out: dSjj = dA - dC^T Srj -
// C^T dSrj (its lower tiles) and dSrj = -dSrr C - Srr dC, with
// dC = (dLb - C dLd) Ld^-1 and dA = -Ld^-T (Y + Y^T) Ld^-1, Y = Ld^-1 dLd
// (lower). Scratch: Linv, T1, T2 (W x W), X, dC (M x W).
__device__ inline void takahashi_tangent(const Team& team, int W, int M, const double* Ld, const double* A,
                                         const double* C, const double* dLd, const double* dLb, const double* Srr,
                                         const double* dSrr, const double* Srj, double* Linv, double* T1, double* T2,
                                         double* X, double* dC, double* dSjj, double* dSrj, double* smem) {
  lower_inverse(team, W, Ld, A, Linv, smem);
  gemm(team, W, W, W, SET, A_LOWER | B_LOWER | LOWER_OUT, Linv, W, false, dLd, W, false, T1, W, smem);
  for (int e = first(team); e < W * W; e += stride(team)) {  // Y + Y^T from Y's lower triangle
    const int i = e / W, j = e % W;
    T2[e] = i > j ? ld(T1 + e) : i < j ? ld(T1 + j * W + i) : 2.0 * ld(T1 + e);
  }
  team_sync();
  gemm(team, W, W, W, SET, B_LOWER, T2, W, false, Linv, W, false, T1, W, smem);
  gemm(team, W, W, W, NEG, A_UPPER | LOWER_OUT, Linv, W, true, T1, W, false, dSjj, W, smem);
  if (M == 0) return;
  for (int e = first(team); e < M * W; e += stride(team)) X[e] = ld(dLb + e);
  team_sync();
  gemm(team, M, W, W, SUB, B_LOWER, C, W, false, dLd, W, false, X, W, smem);
  gemm(team, M, W, W, SET, B_LOWER, X, W, false, Linv, W, false, dC, W, smem);
  gemm(team, M, W, M, NEG, FULL, dSrr, M, false, C, W, false, dSrj, W, smem);
  gemm(team, M, W, M, SUB, FULL, Srr, M, false, dC, W, false, dSrj, W, smem);
  gemm(team, W, W, M, SUB, LOWER_OUT, dC, W, true, Srj, W, false, dSjj, W, smem);
  gemm(team, W, W, M, SUB, LOWER_OUT, C, W, true, dSrj, W, false, dSjj, W, smem);
}

// The adjoint of one panel's Cholesky, the reverse of K6's step Ld = chol(Ajj),
// Lb = Arj Ld^-T, U = Lb Lb^T (U subtracted from the ancestors' lower entries).
// In: Ld (W x W lower, padded columns with a unit pivot), Lb (M x W),
// A = Ld^-T Ld^-1 (symmetric), gLd (the cotangent of Ld's lower triangle; its
// upper triangle is ignored and overwritten), gLb (M x W, overwritten), Sr
// (M x M, its lower triangle: the cotangent of the ancestors' lower entries
// that U is subtracted from). Out: gArj = gLb' Ld^-1 with
// gLb' = gLb - (Sr + Sr^T) Lb, and gAjj (lower, the cotangent of Ajj's lower
// entries) = tril(Ld^-T (X + X^T) Ld^-1), its diagonal halved, with
// X = Phi(Ld^T gLd'), gLd' = tril(gLd - gArj^T Lb): the reverse sweep of the
// factorization (Murray 2016, Cholesky adjoint by blocks). Ld^-1 = Ld^T A, its
// lower triangle (lower_inverse). Scratch: Linv, T1, T2 (W x W), Sf (M x M).
__device__ inline void panel_adjoint(const Team& team, int W, int M, const double* Ld, const double* Lb,
                                     const double* A, double* gLd, double* gLb, const double* Sr, double* Linv,
                                     double* T1, double* T2, double* Sf, double* gAjj, double* gArj, double* smem) {
  lower_inverse(team, W, Ld, A, Linv, smem);
  if (M > 0) {
    for (int e = first(team); e < M * M; e += stride(team)) {  // Sr + Sr^T from Sr's lower triangle
      const int i = e / M, j = e % M;
      Sf[e] = i > j ? ld(Sr + e) : i < j ? ld(Sr + j * M + i) : 2.0 * ld(Sr + e);
    }
    team_sync();
    gemm(team, M, W, M, SUB, FULL, Sf, M, false, Lb, W, false, gLb, W, smem);
    gemm(team, M, W, W, SET, B_LOWER, gLb, W, false, Linv, W, false, gArj, W, smem);
    gemm(team, W, W, M, SUB, LOWER_OUT, gArj, W, true, Lb, W, false, gLd, W, smem);
  }
  for (int e = first(team); e < W * W; e += stride(team))
    if (e / W < e % W) gLd[e] = 0.0;
  team_sync();
  gemm(team, W, W, W, SET, A_UPPER | B_LOWER | LOWER_OUT, Ld, W, true, gLd, W, false, T1, W, smem);
  for (int e = first(team); e < W * W; e += stride(team)) {  // X + X^T, X = Phi(T1): the diagonal once
    const int i = e / W, j = e % W;
    T2[e] = i >= j ? ld(T1 + e) : ld(T1 + j * W + i);
  }
  team_sync();
  gemm(team, W, W, W, SET, B_LOWER, T2, W, false, Linv, W, false, T1, W, smem);
  gemm(team, W, W, W, SET, A_UPPER | LOWER_OUT, Linv, W, true, T1, W, false, gAjj, W, smem);
  for (int e = first(team); e < W * W; e += stride(team)) {
    const int i = e / W, j = e % W;
    if (i <= j) gAjj[e] = i == j ? 0.5 * ld(gAjj + e) : 0.0;
  }
  team_sync();
}

}  // namespace tgt
}  // namespace
