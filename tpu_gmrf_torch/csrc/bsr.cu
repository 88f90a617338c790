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
//
// Design. K14 streams each stored block through shared memory once for the
// vectors of a launch row (up to 8; gridDim.y takes them in eights, and one
// set of blocks per row takes one row a launch row). A group of P warps
// walks a run of consecutive block rows (as many as one wave of groups on
// the card leaves to each; their stored blocks are one run of the plan) and
// stages their stored blocks, S at a time and row by row, into a ring of D
// stages of its own, with the bs-long pieces of the vectors at each block's
// column beside them, all by `cp.async` (16 bytes a copy where the blocks
// and the vectors' rows lie on 16 bytes, else narrower; zero past n). The
// tables (block columns, and the source blocks of the transposed product)
// are read 32 blocks at a time, the next 32 ahead, and the ring runs on from
// one block row into the next, so the group waits for memory once, at its
// start. One barrier of the group a stage: every thread
// waits for the stage, meets the others, refills the slot the group
// finished with and then multiplies. A lane owns one row i of the block row
// and accumulates its products with all the launch row's vectors in
// registers, so a staged block is read from shared memory once; the
// P · 32 / bs lane groups of the group take the stage's blocks in turn. At
// the end of a block row their partial sums are added in a fixed order (a
// shuffle tree within a warp, then the warps' sums in warp order through
// shared memory), so a row of y has one owner, no atomics, and the same bits
// on every launch. The forward product reads row i of a staged block, each
// lane starting at its own 16-byte piece of the row so that the lanes' reads
// fall in distinct banks; the transposed one reads its column i: with
// `tperm` the tables are the transposed plan's and stored block p of that
// plan is blocks[tperm[p]], read transposed where it lies. Consecutive
// staged blocks start in different banks so that the lane groups' column
// reads do not meet. The tensor cores have no part: at 8 vectors the
// arithmetic per byte is far below what would need them. The wrapper gives
// the warps a group, the ring's depth and the shared bytes a group and a CTA
// may take (kernels/bsr_spmv.py::spmm_launch); the launcher sizes the stages
// and the CTA from them, and the rows a group walks from the card's
// occupancy. K15 writes each block once: a warp walks a run of consecutive
// stored blocks (as many as one wave of warps on the card leaves to each; the
// blocks of a block row are consecutive), holds its lanes' g values of the
// block row in registers while the row lasts, loads each block's x pieces
// (one load of V elements a lane and vector), forms its bs^2 / 32 entries a
// lane over the vectors in their order (with one matrix per chain, one
// product) and writes them with 16-byte (at bs=8 in f32, 8-byte) streaming
// stores: no lane idles, and the launch moves the output once plus g and x.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // K15: threads a CTA
constexpr int kMaxWarps = 8;   // K14: warps a CTA
constexpr int kVecs = 8;       // K14: vectors a launch row
constexpr int kMaxStage = 32;  // K14: blocks a stage (a stage's tables lie in two chunks of 32)

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// N bytes, or N zeros where `valid` is false (src is then not read).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(N),
               "r"(valid ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most `pending` of this thread's newest copy groups are in flight.
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// The barrier of one group of `threads` threads (id >= 1; 0 is __syncthreads').
__device__ __forceinline__ void group_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 16 bytes of T: one vector load of shared memory.
template <typename T>
struct __align__(16) Piece {
  T v[16 / sizeof(T)];
};

// Shared bytes of one staged block: its bs rows, plus one lane group's column (bs elements) modulo 128, so
// that consecutive blocks start in different banks.
__host__ __device__ inline int spmm_ablock(int bs, int el) { return bs * bs * el + bs * el % 128; }

// Shared bytes of one group of P warps: its ring (D stages of S blocks, then their vectors' pieces), the
// stages' headers (block row, blocks; 16 bytes each, so that the next group's ring starts on 16 bytes) and,
// with P > 1 warps, the warps' partial sums of a block row.
__host__ __device__ inline int spmm_group_bytes(int bs, int el, int vecs, int P, int S, int D) {
  return D * S * (spmm_ablock(bs, el) + vecs * bs * el) + 16 * D + (P > 1 ? P * vecs * bs * el : 0);
}

template <typename T, int BS, bool Trans>
__global__ void __launch_bounds__(32 * kMaxWarps)
    bsr_spmm_kernel(const T* __restrict__ blocks, long long block_stride, const int* __restrict__ rowptr,
                    const int* __restrict__ bcols, const int* __restrict__ tperm, int nb, int n,
                    const T* __restrict__ x, T* __restrict__ y, int R, int vecs, int P, int S, int D, int rows,
                    int aw, int xw) {
  constexpr int G = 32 / BS;         // lane groups of a warp
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte piece
  constexpr int CPR = BS / V;        // 16-byte pieces a block row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = warp / P, wg = warp % P, tg = wg * 32 + lane, gsize = 32 * P;
  const int r0 = (blockIdx.x * (blockDim.x / gsize) + grp) * rows;  // this group's block rows: [r0, r1)
  if (r0 >= nb) return;                                              // the whole group
  const int r1 = min(nb, r0 + rows);
  const int g = lane / BS, i = lane % BS, lg = wg * G + g, NL = P * G;  // lane group lg of NL
  // this lane's first piece of a row: the rows of a quarter warp start in distinct banks
  const int rot = CPR >= 8 ? (i & 7) % CPR : (i * CPR >> 3) % CPR;
  const int c0 = blockIdx.y * vecs, vc = min(vecs, R - c0);
  const T* blk = blocks + c0 * block_stride;  // block_stride != 0: vecs = 1, vector c0's own blocks
  const int ab = spmm_ablock(BS, sizeof(T)), xb = vecs * BS * sizeof(T);
  unsigned char* ring = smem_raw + (size_t)grp * spmm_group_bytes(BS, sizeof(T), vecs, P, S, D);
  unsigned char* xring = ring + (size_t)D * S * ab;
  int* hdr = reinterpret_cast<int*>(xring + (size_t)D * S * xb);
  T* part = reinterpret_cast<T*>(hdr + 4 * D);  // (P, vecs, BS)
  // blocks in pieces of aw bytes, 2^la a block; x pieces: xw bytes (pe elements) each, ppv = 2^lp a vector's
  // bs; vectors padded to 2^lv
  const int la = __ffs(BS * BS * sizeof(T) / aw) - 1;
  const int pe = xw / sizeof(T), lp = __ffs(BS / pe) - 1;
  const int lv = vc > 4 ? 3 : vc > 2 ? 2 : vc - 1;
  auto owns = [&](int c) { return c < vc && c % P == wg && (c / P) % G == g; };  // who stores vector c

  // The tables of the run's blocks [q0, q1), 32 at a time: lane l holds block 32 h + l of chunk h (cb, sb) and
  // of the chunk after it (cbn, sbn), loaded ahead.
  const int q0 = rowptr[r0], q1 = rowptr[r1];
  int cb = 0, sb = 0, cbn = 0, sbn = 0, held = 0;
  auto fetch = [&](int h, int& c, int& b) {
    const int q = q0 + 32 * h + lane;
    if (q < q1) {
      c = bcols[q];
      b = Trans ? tperm[q] : q;
    }
  };
  fetch(0, cb, sb);
  if (q1 - q0 > 32) fetch(1, cbn, sbn);
  auto table = [&](int a, int an, int q) {  // block q's entry (within chunks held, held + 1); all lanes call
    const int l = (q - q0) & 31;
    const int lo = __shfl_sync(kFull, a, l), hi = __shfl_sync(kFull, an, l);
    return (q - q0) >> 5 == held ? lo : hi;
  };

  // The producer: the next stage is blocks [pq, pq + S) of block row pr, clipped at the row's end pe1.
  int pr = r0, pe1 = rowptr[r0 + 1], pe2 = r0 + 2 <= nb ? rowptr[min(r0 + 2, nb)] : 0, pq = q0, issued = 0;
  auto issue = [&]() -> bool {
    while (pq >= pe1 && pr < r1) {  // to the next block row that has blocks (rowptr one row ahead)
      ++pr;
      pe1 = pe2;
      if (pr + 2 <= nb) pe2 = rowptr[pr + 2];
    }
    if (pr >= r1) return false;
    const int nk = min(S, pe1 - pq);
    while ((pq - q0) >> 5 != held) {  // the next chunk of the tables: take it, and load the one after
      cb = cbn;
      sb = sbn;
      if (q0 + 32 * (++held + 1) < q1) fetch(held + 1, cbn, sbn);
    }
    const int sl = issued % D;
    unsigned char* abase = ring + (size_t)sl * S * ab;
    unsigned char* xbase = xring + (size_t)sl * S * xb;
    if (tg == 0) {
      hdr[4 * sl] = pr;
      hdr[4 * sl + 1] = nk;
    }
    for (int u0 = 0; u0 < nk << la; u0 += gsize) {  // the blocks; all lanes take the table
      const int u = u0 + tg, k = min(u >> la, nk - 1), w = (u & ((1 << la) - 1)) * aw;
      const int src = Trans ? table(sb, sbn, pq + k) : pq + k;
      if (u < nk << la) {
        unsigned char* dst = abase + k * ab + w;
        const void* from = reinterpret_cast<const unsigned char*>(blk + (long long)src * BS * BS) + w;
        if (aw == 16)
          cp_async<16>(dst, from);
        else
          cp_async<sizeof(T)>(dst, from);
      }
    }
    const int lb = lv + lp, items = nk << lb;
    const int colk = table(cb, cbn, pq + min(lane, nk - 1)) * BS;  // lane k: the first column of block k
    for (int u0 = 0; u0 < items; u0 += gsize) {
      const int u = u0 + tg, k = min(u >> lb, nk - 1), w = u & ((1 << lb) - 1), c = w >> lp;
      const int j = (w & ((1 << lp) - 1)) * pe, col = __shfl_sync(kFull, colk, k) + j;
      if (u < items && c < vc) {
        T* dst = reinterpret_cast<T*>(xbase + k * xb) + c * BS + j;
        const bool ok = col < n;
        const T* src = ok ? x + (long long)(c0 + c) * n + col : x;
        if (xw == 16)
          cp_async<16>(dst, src, ok);
        else if (xw == 8)
          cp_async<8>(dst, src, ok);
        else
          cp_async<sizeof(T)>(dst, src, ok);
      }
    }
    pq += nk;
    ++issued;
    return true;
  };

  T acc[kVecs];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) acc[c] = T(0);
  // The consumer: block row `open` takes the stages' products; at its end the lane groups' and warps' sums
  // are added and stored, and block rows without blocks get zeros.
  auto finish = [&](int row) {
#pragma unroll
    for (int c = 0; c < kVecs; ++c)
#pragma unroll
      for (int o = BS; o < 32; o <<= 1) acc[c] += __shfl_xor_sync(kFull, acc[c], o);
    if (P > 1) {
      group_bar(1 + grp, gsize);  // the previous block row's sums are read
#pragma unroll
      for (int c = 0; c < kVecs; ++c)
        if (c < vc && c % G == g) part[(wg * vecs + c) * BS + i] = acc[c];
      group_bar(1 + grp, gsize);
#pragma unroll
      for (int c = 0; c < kVecs; ++c)
        if (owns(c)) {
          T s = T(0);
          for (int w = 0; w < P; ++w) s += part[(w * vecs + c) * BS + i];
          acc[c] = s;
        }
    }
    if (row * BS + i < n)
#pragma unroll
      for (int c = 0; c < kVecs; ++c)
        if (owns(c)) y[(long long)(c0 + c) * n + row * BS + i] = acc[c];
#pragma unroll
    for (int c = 0; c < kVecs; ++c) acc[c] = T(0);
  };
  auto zeros = [&](int from, int to) {  // block rows [from, to) have no stored blocks
    for (int row = from; row < to; ++row)
      if (row * BS + i < n)
#pragma unroll
        for (int c = 0; c < kVecs; ++c)
          if (owns(c)) y[(long long)(c0 + c) * n + row * BS + i] = T(0);
  };

  for (int st = 0; st < D - 1; ++st) {
    issue();
    cp_commit();
  }
  int open = r0 - 1;
  for (int st = 0; st < issued; ++st) {
    const int sl = st % D;
    cp_wait(D - 2);             // this thread's copies of stage st
    group_bar(1 + grp, gsize);  // everyone's; and stage st - 1 is done with
    issue();                    // into stage st - 1's slot
    cp_commit();
    const int row = hdr[4 * sl], nk = hdr[4 * sl + 1];
    if (row != open) {
      if (open >= r0) finish(open);
      zeros(open + 1, row);
      open = row;
    }
    const unsigned char* abase = ring + (size_t)sl * S * ab;
    const unsigned char* xbase = xring + (size_t)sl * S * xb;
    for (int k = lg; k < nk; k += NL) {
      const T* sa = reinterpret_cast<const T*>(abase + k * ab);
      const T* sx = reinterpret_cast<const T*>(xbase + k * xb);
#pragma unroll
      for (int pp = 0; pp < CPR; ++pp) {
        const int j0 = (Trans ? pp : (pp + rot) % CPR) * V;
        Piece<T> a;
        if (Trans) {
#pragma unroll
          for (int v = 0; v < V; ++v) a.v[v] = sa[(j0 + v) * BS + i];
        } else {
          a = *reinterpret_cast<const Piece<T>*>(sa + i * BS + j0);
        }
#pragma unroll
        for (int c = 0; c < kVecs; ++c)
          if (c < vc) {
            const Piece<T> xv = *reinterpret_cast<const Piece<T>*>(sx + c * BS + j0);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[c] += a.v[v] * xv.v[v];
          }
      }
    }
  }
  if (open >= r0) finish(open);
  zeros(open + 1, r1);
}

// 16-byte (or 8-byte) pieces of V elements: loads, and stores that stream past the caches.
template <typename T, int V>
struct __align__(V * sizeof(T)) Vec {
  T v[V];
};

__device__ __forceinline__ void store_cs(float* p, const Vec<float, 2>& a) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a.v[0], a.v[1]));
}
__device__ __forceinline__ void store_cs(float* p, const Vec<float, 4>& a) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
}
__device__ __forceinline__ void store_cs(double* p, const Vec<double, 2>& a) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(a.v[0], a.v[1]));
}

// K15: dblocks[b][i][j] = sum over the vectors c of g[c][rb bs + i] x[c][cb bs + j] (PC false), or, per chain
// c = blockIdx.y, that one product (PC true; dblocks (R, nblocks, bs, bs)); zero past n. A warp walks a run of
// `run` consecutive stored blocks (block-row order), the tables read 32 blocks at a time, UB blocks a batch. Lane l
// owns NR runs of V consecutive entries of every block: entries (l + 32 t) V .. + V, t < NR, that is rows
// row0 + RS t and the columns j0 .. j0 + V (the same for every t). Its g values of the block row stay in registers
// while the block row lasts (CH vectors at a time; with more vectors they are reloaded a block); its x pieces are
// one V-element load a vector and block, a batch's loads all sent before its products, so that a warp waits for
// memory once a batch (unpredicated where the batch is whole). The sum over the vectors runs in their order. On an
// H100 at bs=8 the kernel is bound by its instructions more than by latency: batches of 4 blocks (spills), a
// register bound for more warps, and prefetches of the next batch into L1 or L2 were all slower.
template <typename T, int BS, bool PC>
__global__ void __launch_bounds__(kThreads)
    bsr_outer_kernel(const int* __restrict__ brows, const int* __restrict__ bcols, int nblocks, int n,
                     const T* __restrict__ g, const T* __restrict__ x, int R, int run, int xvec,
                     T* __restrict__ dblocks) {
  constexpr int V = 16 / (int)sizeof(T) < BS * BS / 32 ? 16 / (int)sizeof(T) : BS * BS / 32;
  constexpr int NR = BS * BS / (32 * V), RS = 32 * V / BS;
  constexpr int CH = PC ? 1 : NR <= 2 ? 8 : NR <= 4 ? 4 : 1;  // vectors whose g values a lane holds
  constexpr int UB = PC ? (NR < 8 ? 8 / NR : 1) : NR == 1 && sizeof(T) == 4 ? 2 : 1;  // blocks a batch (divides 32)
  const int lane = threadIdx.x & 31;
  const long long q0 = ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * run;
  if (q0 >= nblocks) return;  // the whole warp
  const int q1 = (int)min((long long)nblocks, q0 + run);
  const int c_lo = PC ? blockIdx.y : 0, c_hi = PC ? c_lo + 1 : R;
  T* out = dblocks + (PC ? (long long)c_lo * nblocks : 0) * BS * BS;
  const int row0 = lane * V / BS, j0 = lane * V % BS;
  T gr[CH][NR];
  int held = -1, rb_t = 0, cb_t = 0;  // the block row whose g values gr holds; this lane's table entries
  for (int q = (int)q0; q < q1; q += UB) {
    const int u0 = (q - (int)q0) & 31;
    if (u0 == 0 && q + lane < q1) {
      rb_t = brows[q + lane];
      cb_t = bcols[q + lane];
    }
    int rb[UB], col[UB];
#pragma unroll
    for (int u = 0; u < UB; ++u) {
      rb[u] = __shfl_sync(kFull, rb_t, u0 + u);
      col[u] = __shfl_sync(kFull, cb_t, u0 + u) * BS + j0;
    }
    Vec<T, V> acc[UB][NR];
#pragma unroll
    for (int u = 0; u < UB; ++u)
#pragma unroll
      for (int t = 0; t < NR; ++t)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][t].v[v] = T(0);
    for (int c0 = c_lo; c0 < c_hi; c0 += CH) {
      Vec<T, V> xv[UB][CH];  // all the batch's loads first, then the products
      bool whole = c_hi - c0 >= CH && q + UB <= q1;  // every piece in range and on V elements: no predicates
#pragma unroll
      for (int u = 0; u < UB; ++u) whole = whole && xvec && col[u] + V <= n;
      if (whole) {
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const T* xr = x + (long long)c0 * n + col[u];
#pragma unroll
          for (int cc = 0; cc < CH; ++cc) xv[u][cc] = *reinterpret_cast<const Vec<T, V>*>(xr + (long long)cc * n);
        }
      } else {
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const T* xr = x + (long long)c0 * n + col[u];
          const bool vec = xvec && col[u] + V <= n;
#pragma unroll
          for (int cc = 0; cc < CH; ++cc, xr += n) {
            const bool ok = q + u < q1 && c0 + cc < c_hi;
            if (ok && vec) {
              xv[u][cc] = *reinterpret_cast<const Vec<T, V>*>(xr);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) xv[u][cc].v[v] = ok && col[u] + v < n ? xr[v] : T(0);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        if (q + u >= q1) break;
        if (rb[u] != held || c_hi - c_lo > CH) {
#pragma unroll
          for (int cc = 0; cc < CH; ++cc)
#pragma unroll
            for (int t = 0; t < NR; ++t) {
              const int r = rb[u] * BS + row0 + RS * t;
              gr[cc][t] = c0 + cc < c_hi && r < n ? g[(long long)(c0 + cc) * n + r] : T(0);
            }
          held = rb[u];
        }
#pragma unroll
        for (int cc = 0; cc < CH; ++cc) {
          if (c0 + cc >= c_hi) break;
#pragma unroll
          for (int t = 0; t < NR; ++t)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u][t].v[v] = fma(gr[cc][t], xv[u][cc].v[v], acc[u][t].v[v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UB; ++u)
      if (q + u < q1) {
        T* ob = out + (long long)(q + u) * BS * BS + row0 * BS + j0;
#pragma unroll
        for (int t = 0; t < NR; ++t) store_cs(ob + RS * t * BS, acc[u][t]);
      }
  }
}

// Items (block rows of K14, stored blocks of K15) a group walks: enough groups for one wave on the card, no more
// (the occupancy, asked once per kernel, device and shape).
template <typename K>
int wave_rows(K kernel, int threads, size_t smem, int groups, int nb, int chunks, int* rows) {
  struct Seen {
    const void* kernel;
    int dev, threads;
    size_t smem;
    int resident;
  };
  static Seen seen[64];
  static int nseen = 0;
  int dev = 0, rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  int resident = 0;
  for (int s = 0; s < nseen; ++s)
    if (seen[s].kernel == (const void*)kernel && seen[s].dev == dev && seen[s].threads == threads &&
        seen[s].smem == smem)
      resident = seen[s].resident;
  if (!resident) {
    int per_sm = 0, sms = 0;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (!rc) rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc) return rc;
    resident = max(1, per_sm * sms);
    if (nseen < 64) seen[nseen++] = {(const void*)kernel, dev, threads, smem, resident};
  }
  const long long wave = (long long)resident * groups;  // groups of one wave, over the vectors' launch rows
  *rows = (int)max(1LL, ((long long)nb * chunks + wave - 1) / wave);
  return 0;
}

template <typename T, int BS, bool Trans>
int launch_spmm_bs(const T* blocks, long long block_stride, const int* rowptr, const int* bcols, const int* tperm,
                   int nb, int n, const T* x, T* y, int R, int vecs, int warps, int P, int S, int D, int aw, int xw,
                   size_t smem, cudaStream_t stream) {
  static size_t granted[64];  // the shared-memory opt-in, per device, for the largest size asked
  const auto kernel = bsr_spmm_kernel<T, BS, Trans>;
  if (smem > 48 * 1024) {
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc || dev >= 64) return rc ? rc : (int)cudaErrorInvalidDevice;
    if (granted[dev] < smem) {
      rc = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (rc) return rc;
      granted[dev] = smem;
    }
  }
  const int groups = warps / P, chunks = (R + vecs - 1) / vecs;
  int rows = 1;
  int rc = wave_rows(kernel, 32 * warps, smem, groups, nb, chunks, &rows);
  if (rc) return rc;
  const dim3 grid((unsigned)((nb + groups * rows - 1) / (groups * rows)), (unsigned)chunks);
  kernel<<<grid, 32 * warps, smem, stream>>>(blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, P, S, D,
                                             rows, aw, xw);
  return (int)cudaGetLastError();
}

template <typename T, bool Trans>
int launch_spmm_t(int bs, const T* blocks, long long block_stride, const int* rowptr, const int* bcols,
                  const int* tperm, int nb, int n, const T* x, T* y, int R, int vecs, int warps, int P, int S, int D,
                  int aw, int xw, size_t smem, cudaStream_t stream) {
  switch (bs) {
    case 8:
      return launch_spmm_bs<T, 8, Trans>(blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, warps, P,
                                         S, D, aw, xw, smem, stream);
    case 16:
      return launch_spmm_bs<T, 16, Trans>(blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, warps, P,
                                          S, D, aw, xw, smem, stream);
    case 32:
      return launch_spmm_bs<T, 32, Trans>(blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, warps, P,
                                          S, D, aw, xw, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The split: P warps a group, a ring of D stages, each of the most blocks (a power of two, 4 to 32) that keep
// the group within `group_bytes`, and as many groups a CTA (up to 8 warps) as `cta_bytes` holds
// (kernels/bsr_spmv.py::spmm_launch).
template <typename T>
int launch_spmm(const T* blocks, long long block_stride, const int* rowptr, const int* bcols, const int* tperm,
                int bs, int nb, int n, const T* x, T* y, int R, int P, int D, int group_bytes, int cta_bytes,
                void* stream) {
  if (R == 0 || nb == 0) return 0;
  if (P < 1 || kMaxWarps % P || D < 2 || D > 4) return (int)cudaErrorInvalidValue;
  const int vecs = block_stride ? 1 : min(R, kVecs);
  if ((R + vecs - 1) / vecs > 65535) return (int)cudaErrorInvalidValue;
  int S = 4;
  while (S < kMaxStage && spmm_group_bytes(bs, sizeof(T), vecs, P, 2 * S, D) <= group_bytes) S *= 2;
  const int gb = spmm_group_bytes(bs, sizeof(T), vecs, P, S, D);
  const int warps = P * max(1, min(kMaxWarps / P, cta_bytes / gb));
  const size_t smem = (size_t)(warps / P) * gb;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // 16-byte copies of the blocks where every block starts on 16 bytes; the vectors' pieces as wide as their
  // rows' alignment allows (a piece never straddles n: n is a multiple of its elements)
  const unsigned long long xa = (unsigned long long)x | ((unsigned long long)n * sizeof(T));
  const int aw = (unsigned long long)blocks % 16 == 0 ? 16 : (int)sizeof(T);
  const int xw = xa % 16 == 0 ? 16 : xa % 8 == 0 ? 8 : (int)sizeof(T);
  const cudaStream_t st = (cudaStream_t)stream;
  return tperm ? launch_spmm_t<T, true>(bs, blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, warps,
                                        P, S, D, aw, xw, smem, st)
               : launch_spmm_t<T, false>(bs, blocks, block_stride, rowptr, bcols, tperm, nb, n, x, y, R, vecs, warps,
                                         P, S, D, aw, xw, smem, st);
}

template <typename T, int BS, bool PC>
int launch_outer_bs(const int* brows, const int* bcols, int nblocks, int n, const T* g, const T* x, int R, T* dblocks,
                    cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(T) < BS * BS / 32 ? 16 / (int)sizeof(T) : BS * BS / 32;
  const auto kernel = bsr_outer_kernel<T, BS, PC>;
  const int chains = PC ? R : 1;
  int run = 1;
  int rc = wave_rows(kernel, kThreads, 0, kThreads / 32, nblocks, chains, &run);
  if (rc) return rc;
  // V-element loads of x where its rows lie on V elements
  const int xvec = ((unsigned long long)x | ((unsigned long long)n * sizeof(T))) % (V * sizeof(T)) == 0;
  const long long warps = (nblocks + run - 1) / run;
  const dim3 grid((unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32)), (unsigned)chains);
  kernel<<<grid, kThreads, 0, stream>>>(brows, bcols, nblocks, n, g, x, R, run, xvec, dblocks);
  return (int)cudaGetLastError();
}

template <typename T, int BS>
int launch_outer_mode(const int* brows, const int* bcols, int nblocks, int n, const T* g, const T* x, int R,
                      int per_chain, T* dblocks, cudaStream_t stream) {
  return per_chain ? launch_outer_bs<T, BS, true>(brows, bcols, nblocks, n, g, x, R, dblocks, stream)
                   : launch_outer_bs<T, BS, false>(brows, bcols, nblocks, n, g, x, R, dblocks, stream);
}

template <typename T>
int launch_outer(const int* brows, const int* bcols, int nblocks, int bs, int n, const T* g, const T* x, int R,
                 int per_chain, T* dblocks, void* stream) {
  if (nblocks == 0 || R == 0) return 0;
  if (per_chain && R > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (bs) {
    case 8:
      return launch_outer_mode<T, 8>(brows, bcols, nblocks, n, g, x, R, per_chain, dblocks, st);
    case 16:
      return launch_outer_mode<T, 16>(brows, bcols, nblocks, n, g, x, R, per_chain, dblocks, st);
    case 32:
      return launch_outer_mode<T, 32>(brows, bcols, nblocks, n, g, x, R, per_chain, dblocks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#define TG_BSR_ENTRY(SUF, T)                                                                                  \
  int tg_bsr_spmm_##SUF(const T* blocks, long long block_stride, const int* rowptr, const int* bcols,         \
                        const int* tperm, int bs, int nb, int n, const T* x, T* y, int R, int P, int D,       \
                        int group_bytes, int cta_bytes, void* stream) {                                       \
    return launch_spmm<T>(blocks, block_stride, rowptr, bcols, tperm, bs, nb, n, x, y, R, P, D, group_bytes,  \
                          cta_bytes, stream);                                                                 \
  }                                                                                                           \
  int tg_bsr_outer_##SUF(const int* brows, const int* bcols, int nblocks, int bs, int n, const T* g,          \
                         const T* x, int R, int per_chain, T* dblocks, void* stream) {                        \
    return launch_outer<T>(brows, bcols, nblocks, bs, n, g, x, R, per_chain, dblocks, stream);                \
  }

TG_BSR_ENTRY(f32, float)
TG_BSR_ENTRY(f64, double)

#undef TG_BSR_ENTRY

}  // extern "C"
