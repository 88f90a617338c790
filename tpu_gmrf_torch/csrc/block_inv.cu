// K17 block_inv: the signed inverses of the clique and separator blocks of the
// graphical lasso's max-det completion.
//
// Replaces (JAX reference, tpu_gmrf/): graphical_lasso.py:150-151 inside
// `_batched_embed_inverses` (:142): per bucket of sets of one size, the
// blocks C[s, s] are gathered and inverted by jnp.linalg.inv (LU with partial
// pivoting), then scatter-added with sign +1 (cliques) or -1 (separators)
// into the cover's data (:157). Here every set, whatever its size, is
// inverted and written as sign * inv(C[s, s]) row-major into a flat buffer at
// the set's offset; K5 (gather_segsum) then sums that buffer into the cover's
// data over a host plan, in a fixed order (duplicates across cliques and
// separators are the rule), with no atomics.
//
// Inversion: Gauss-Jordan with partial pivoting (the pivot of column k is the
// first row i >= k of largest |A[i][k]|, NaN counting as largest; the pivot
// row is scaled by one division; A[i][j] = sub(A[i][j], mul(f[i], row[j]))),
// then the column interchanges undone in reverse order. Not a Cholesky
// inverse: a soft-thresholded covariance block need not be positive definite.
// A singular block gives non-finite values (a zero pivot divides), as the
// reference's LU inverse does; the loop always ends. Every operation is
// rounded once (rn_ops.cuh), in the plain version's order, so the kernel and
// the plain version agree to the bit.
//
// What bounds it on the card: 2 s^3 flops on s^2 values per set, and s
// dependent column steps. At the graphical lasso's n = 1000 there are 1,673
// sets (median size 3, largest 93); the 436 above 32 rows hold 99% of the
// flops. So the launch lasts as long as the largest set's 93 steps plus the
// sets that find no room in the first wave: the cost of one step and the
// residency set the time, not the bytes.
//
// Design: the host (kernels/block_inv.py, BlockSets.on) orders the sets
// largest first and cuts them into classes by size; the classes are
// contiguous in that order.
// - warp class (s <= 32): a warp per set, 8 sets a block of threads. Lane i
//   holds row i in registers (8, 16 or 32 columns); the pivot search is a
//   shuffle argmax, the pivot row goes through the warp's slice of shared
//   memory, and the only barriers are the warp's own.
// - tile class (32 < s <= 96): a block of 256 threads per set, a 16 x 16 grid;
//   thread (tx, ty) holds rows ty + 16a and columns tx + 16b (a, b < 4 up to
//   64 rows, < 6 beyond) as a register tile indexed only at compile time. Only
//   the scaled pivot row and the pivot column go through shared memory, and
//   the half-warp that updates column k + 1 chooses its pivot right away: two
//   barriers a step.
// In both, rows are never moved: each physical row carries its logical index
// (`lab`), and an interchange swaps two labels; the final column permutation
// is applied as the result is written. Pivots are compared as integer keys
// (piv_key). These two classes and the global one share one launch, with
// little shared memory, largest sets first: 3 blocks of threads an SM in f32,
// 2 in f64 (its tile alone takes 72 of a thread's 128 registers).
// - shared class (96 < s <= 169 in f64, 239 in f32): a block per set, the set
//   gathered into dynamic shared memory sized by the class's largest set, in a
//   launch of its own (gj_invert: six barriers a step).
// - global class (larger): gj_invert in place in the set's slice of the output
//   buffer, with its pivot column and interchanges in a global workspace
//   (`goff` gives its offset there). No size is refused.
//
// Learned on an H100 (clock64 stamps per phase of a step, and variants built
// apart; f64, a set of 93): loops over the register tile with early exits and
// floating-point compares made its loads and products one dependent chain
// (~7,900 cycles a step, 4,700 of them the update); a branch that put the
// pivot row back into a run-time slot merged six copies of the tile and spilled
// it; six divisions on one thread per column were 45% of a step in f32. Each
// is gone: integer keys, branch-free loops, selects, one division a lane.

#include <climits>

#include "rn_ops.cuh"

namespace {

using tgrn::Rn;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMax = 32;  // the warp class: s <= 32 (kernels/block_inv.py WARP_MAX)
constexpr int kRT = 6;  // the tile class's register tile: at most 6 x 6, so s <= 16 kRT (kernels/block_inv.py TILE_MAX)
constexpr int kNone = INT_MAX;  // no pivot candidate

template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  const bool nv = isnan(v), nb = isnan(bv);
  if (nv != nb) return nv;
  if (!nv && v != bv) return v > bv;
  return i < bi;
}

// The pivot order of the warp and tile classes in integer compares: a value's key is the bits of |v|
// (monotone for non-negative floats), every NaN above +inf; a larger key wins, then the smaller index. A
// row that is no candidate offers key 0 and index kNone, which any candidate beats.
__device__ __forceinline__ unsigned long long piv_key(double v) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(v) & 0x7fffffffffffffffull;
  return b > 0x7ff0000000000000ull ? ~0ull : b;
}
__device__ __forceinline__ unsigned piv_key(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b > 0x7f800000u ? ~0u : b;
}
template <typename K>
__device__ __forceinline__ bool wins(K key, int i, K bkey, int bi) {
  return key > bkey || (key == bkey && i < bi);
}

// In-place Gauss-Jordan inverse of the s x s matrix A (row stride lda) by the
// block's threads; f (s values) and perm (s ints) are workspace.
template <typename T>
__device__ void gj_invert(T* A, int lda, int s, T* f, int* perm) {
  using O = Rn<T>;
  __shared__ T red_v[kWarps];
  __shared__ int red_i[kWarps];
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
      const T ov = __shfl_down_sync(kFull, bv, o);
      const int oi = __shfl_down_sync(kFull, bi, o);
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
      for (int w = 1; w < kWarps; ++w) {
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

// The shared and global classes: gather C[set, set] into A (row-major), invert it there, write sign * A to o.
template <typename T>
__device__ void invert_dense(const T* __restrict__ C, int n, const int* __restrict__ set, int s, T sg, T* A, T* f,
                             int* perm, T* __restrict__ o) {
  for (int e = threadIdx.x; e < s * s; e += kThreads) {
    const int a = e / s, c = e - (e / s) * s;
    A[e] = C[(long long)set[a] * n + set[c]];
  }
  __syncthreads();
  gj_invert<T>(A, s, s, f, perm);
  for (int e = threadIdx.x; e < s * s; e += kThreads) o[e] = Rn<T>::mul(sg, A[e]);
}

// The warp class: one set of s <= W rows on one warp (W = 8, 16 or 32). Lane i holds row i; lab is its logical
// index. The pivot row goes through the warp's slice sr of shared memory (32 values): its lane writes it, lane j
// divides element j. The column loop is not unrolled; the loops over a row's W columns are, and have no exit,
// so that their loads and products overlap (columns past s carry values that nothing reads).
template <typename T, int W>
__device__ void gj_warp(const T* __restrict__ C, int n, const int* __restrict__ set, int s, T sg, T* sr,
                        T* __restrict__ o) {
  using O = Rn<T>;
  using K = decltype(piv_key(T(0)));
  const int lane = threadIdx.x & 31;
  const int mine = lane < s ? set[lane] : 0;
  const long long row = (long long)mine * n;
  T A[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int cj = __shfl_sync(kFull, mine, j);
    A[j] = lane < s && j < s ? C[row + cj] : T(0);
  }
  int lab = lane < s ? lane : -1, swap = 0;  // lane k: the logical row interchanged with k at step k
#pragma unroll 1
  for (int k = 0; k < s; ++k) {
    T f = T(0);  // this row's element of column k
#pragma unroll
    for (int j = 0; j < W; ++j)
      if (j == k) f = A[j];
    // the pivot: a butterfly argmax over the candidates (logical rows >= k), so every lane holds it
    K bk = lab >= k ? piv_key(f) : K(0);
    int bi = lab >= k ? lab : kNone, by = lane;
#pragma unroll
    for (int m = W / 2; m > 0; m >>= 1) {
      const K ok = __shfl_xor_sync(kFull, bk, m);
      const int oi = __shfl_xor_sync(kFull, bi, m), oy = __shfl_xor_sync(kFull, by, m);
      if (wins(ok, oi, bk, bi)) {
        bk = ok;
        bi = oi;
        by = oy;
      }
    }
    bi = __shfl_sync(kFull, bi, 0);  // lanes past W hold no row: they take the winner of lanes 0 .. W - 1
    by = __shfl_sync(kFull, by, 0);
    if (lane == by) {
#pragma unroll
      for (int j = 0; j < W; ++j) sr[j] = A[j];
    }
    __syncwarp();
    const T rj = O::div(lane == k ? T(1) : sr[lane], sr[k]);  // lane j: element j of the scaled pivot row
    __syncwarp();
    sr[lane] = rj;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const T r = sr[j];
      A[j] = lane == by ? r : O::sub(j == k ? T(0) : A[j], O::mul(f, r));
    }
    __syncwarp();
    if (lane == by)
      lab = k;
    else if (lab == k)
      lab = bi;
    if (lane == k) swap = bi;
  }
  // the column interchanges undone in reverse: source column `lane` lands in output column pos
  int pos = lane;
#pragma unroll 1
  for (int k = s - 1; k >= 0; --k) {
    const int p = __shfl_sync(kFull, swap, k);
    pos = pos == k ? p : pos == p ? k : pos;
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int oc = __shfl_sync(kFull, pos, j);
    if (lane < s && j < s) o[(long long)lab * s + oc] = O::mul(sg, A[j]);
  }
}

// The tile class: one set of 32 < s <= 16 RT rows on the block's 16 x 16 threads, (tx, ty) = (tid / 16, tid % 16)
// holding A[ty + 16a][tx + 16b] in A[a][b] (RT = 4 up to 64 rows, 6 up to 96): a half-warp holds the columns
// tx + 16b, its lanes the rows. The column loop runs as RT unrolled slots kb of 16 steps kk each, so a column's
// slot is known at compile time and the tile is indexed at compile time only; the pivot row's slot, known at run
// time only, is reached by predicated moves. A step:
// - the pivot (one word in shared memory) was chosen by the half-warp of its column, a shuffle argmax;
// - the pivot row's lane of each half-warp hands its RT elements to RT lanes of its half-warp, which divide one
//   each into the scaled row in shared memory (one division on the critical path);
// - after one barrier, every thread updates its slots: one product, one difference and one select a slot (the
//   pivot row takes the scaled row), with no exit or branch, so that the loads and products overlap (rows and
//   columns past s carry values that nothing reads);
// - the half-warp of the next column stores it, zeroes it in place (the update then gives sub(0, mul(f, row[k]))
//   there) and chooses its pivot; a second barrier.
template <typename T, int RT>
__device__ void gj_tile(const T* __restrict__ C, int n, const int* __restrict__ set, int s, T sg,
                        T* __restrict__ o) {
  using O = Rn<T>;
  using K = decltype(piv_key(T(0)));
  __shared__ T rowk[16 * RT];     // the pivot row, scaled
  __shared__ T colk[2][16 * RT];  // the pivot column by physical row, by step parity
  __shared__ int pivot;           // the pivot: (logical row) * 128 + physical row
  __shared__ int swap[16 * RT];    // step k: the logical row interchanged with k
  __shared__ int outcol[16 * RT];  // source column -> output column
  __shared__ int lab[16 * RT];     // physical row -> logical row (-1 past s)
  __shared__ int phys[16 * RT];    // logical row -> physical row
  const int tid = threadIdx.x, tx = tid >> 4, ty = tid & 15, lane = tid & 31;
  const unsigned half = 0xffffu << (lane & 16);  // this half-warp's lanes
  T A[RT][RT];
  if (tid < 16 * RT) {
    lab[tid] = tid < s ? tid : -1;
    phys[tid] = tid;
  }
  {
    int cidx[RT];
#pragma unroll
    for (int b = 0; b < RT; ++b) cidx[b] = tx + 16 * b < s ? set[tx + 16 * b] : 0;
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const int i = ty + 16 * a;
      const long long row = i < s ? (long long)set[i] * n : 0;
#pragma unroll
      for (int b = 0; b < RT; ++b) A[a][b] = i < s && tx + 16 * b < s ? C[row + cidx[b]] : T(0);
    }
  }
  // The half-warp of column k (tx == k % 16; its values in slot b, k / 16, known at every call site) stores the
  // column for the update of step k, zeroes it in place and chooses its pivot among the logical rows >= k.
  // Logical rows are unique among the candidates, so (logical row) * 128 + (physical row) orders them as the
  // logical row does.
  auto offer = [&](int k, int b) {
    if (tx != (k & 15)) return;
    K key = K(0);
    int bp = kNone;
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const T c = A[a][b];
      const int la = lab[ty + 16 * a];
      const bool cand = la >= k;
      const K ck = cand ? piv_key(c) : K(0);
      const int cp = cand ? la * 128 + ty + 16 * a : kNone;
      if (wins(ck, cp, key, bp)) {
        key = ck;
        bp = cp;
      }
      colk[k & 1][ty + 16 * a] = c;
      A[a][b] = T(0);
    }
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      const K ok = __shfl_xor_sync(half, key, m);
      const int op = __shfl_xor_sync(half, bp, m);
      if (wins(ok, op, key, bp)) {
        key = ok;
        bp = op;
      }
    }
    if (ty == 0) pivot = bp;
  };
  __syncthreads();  // the labels
  offer(0, 0);
  __syncthreads();
#pragma unroll
  for (int kb = 0; kb < RT; ++kb) {
#pragma unroll 1
    for (int kk = 0; kk < 16; ++kk) {
      const int k = 16 * kb + kk;
      if (k >= s) break;
      const int pk = pivot, p = pk >> 7, y = pk & 127, ay = y >> 4;
      {  // the pivot row: its lane of each half-warp hands element b to lane b, which divides it
        const T piv = colk[k & 1][y];
        T v[RT];
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int b = 0; b < RT; ++b)
            if (a == ay) v[b] = A[a][b];
        const int src = (lane & 16) | (y & 15);
        T mine = T(0);
#pragma unroll
        for (int b = 0; b < RT; ++b) {
          const T t = __shfl_sync(kFull, v[b], src);
          if (ty == b) mine = t;
        }
        if (ty < RT) rowk[tx + 16 * ty] = O::div(tx + 16 * ty == k ? T(1) : mine, piv);
      }
      if (tid == 0) {  // physical rows y (logical p) and phys[k] (logical k) swap their labels
        const int x = phys[k];
        lab[x] = p;
        phys[p] = x;
        lab[y] = k;
        phys[k] = y;
        swap[k] = p;
      }
      __syncthreads();
      const T* fk = colk[k & 1];
      T r[RT];
#pragma unroll
      for (int b = 0; b < RT; ++b) r[b] = rowk[tx + 16 * b];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const T f = fk[ty + 16 * a];
#pragma unroll
        for (int b = 0; b < RT; ++b) {
          const T u = O::sub(A[a][b], O::mul(f, r[b]));
          A[a][b] = ty + 16 * a != y ? u : r[b];
        }
      }
      if (k + 1 < s) {
        if (kk < 15)
          offer(k + 1, kb);
        else
          offer(k + 1, kb + 1 < RT ? kb + 1 : kb);
      }
      __syncthreads();
    }
  }
  // the column interchanges undone in reverse, as a map from source to output column
  if (tid < s) {
    int pos = tid;
    for (int k = s - 1; k >= 0; --k) {
      const int q = swap[k];
      pos = pos == k ? q : pos == q ? k : pos;
    }
    outcol[tid] = pos;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int b = 0; b < RT; ++b)
      if (ty + 16 * a < s && tx + 16 * b < s)
        o[(long long)lab[ty + 16 * a] * s + outcol[tx + 16 * b]] = O::mul(sg, A[a][b]);
}

// The global, tile and warp classes in one launch: blocks [0, nglob) take order_glob's sets in turn, the next
// ntile blocks order_rest's first ntile sets, the others its nwarp sets after them, 8 a block.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 2)
    block_inv_kernel(const T* __restrict__ C, int n, const int* __restrict__ idx, const long long* __restrict__ ptr,
                     const long long* __restrict__ out_off, const T* __restrict__ sign, T* __restrict__ out,
                     const long long* __restrict__ goff, T* __restrict__ gf, int* __restrict__ gperm,
                     const int* __restrict__ order_glob, int nglob, const int* __restrict__ order_rest, int ntile,
                     int nwarp) {
  int b = blockIdx.x, q;
  if (b < nglob) {
    q = order_glob[b];
    const int s = (int)(ptr[q + 1] - ptr[q]);
    T* o = out + out_off[q];
    invert_dense<T>(C, n, idx + ptr[q], s, sign[q], o, gf + goff[q], gperm + goff[q], o);
    return;
  }
  b -= nglob;
  if (b < ntile) {
    q = order_rest[b];
  } else {
    const int w = ntile + (b - ntile) * kWarps + (threadIdx.x >> 5);
    if (w >= ntile + nwarp) return;  // the whole warp
    q = order_rest[w];
  }
  const int s = (int)(ptr[q + 1] - ptr[q]);
  __shared__ T rows[kWarps][kWarpMax];  // the warp class: a warp's pivot row
  T* sr = rows[threadIdx.x >> 5];
  if (b < ntile && s <= 16 * 4)
    gj_tile<T, 4>(C, n, idx + ptr[q], s, sign[q], out + out_off[q]);
  else if (b < ntile)
    gj_tile<T, kRT>(C, n, idx + ptr[q], s, sign[q], out + out_off[q]);
  else if (s <= 8)
    gj_warp<T, 8>(C, n, idx + ptr[q], s, sign[q], sr, out + out_off[q]);
  else if (s <= 16)
    gj_warp<T, 16>(C, n, idx + ptr[q], s, sign[q], sr, out + out_off[q]);
  else
    gj_warp<T, kWarpMax>(C, n, idx + ptr[q], s, sign[q], sr, out + out_off[q]);
}

// The shared class: block b takes order[b]'s set into dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_inv_smem_kernel(const T* __restrict__ C, int n, const int* __restrict__ idx,
                          const long long* __restrict__ ptr, const long long* __restrict__ out_off,
                          const T* __restrict__ sign, T* __restrict__ out, const int* __restrict__ order) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = order[blockIdx.x];
  const int s = (int)(ptr[q + 1] - ptr[q]);
  T* A = reinterpret_cast<T*>(smem_raw);
  T* f = A + (long long)s * s;
  invert_dense<T>(C, n, idx + ptr[q], s, sign[q], A, f, reinterpret_cast<int*>(f + s), out + out_off[q]);
}

template <typename T>
int launch_block_inv(const T* C, int n, const int* idx, const long long* ptr, const long long* out_off, const T* sign,
                     T* out, const long long* goff, T* gf, int* gperm, const int* order, int nglob, int nsmem,
                     int ntile, int nwarp, int smem_s, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (nsmem) {
    const size_t smem = sizeof(T) * ((size_t)smem_s * smem_s + smem_s) + sizeof(int) * (size_t)smem_s;
    int rc = tgrn::set_smem(block_inv_smem_kernel<T>, smem);
    if (rc) return rc;
    block_inv_smem_kernel<T><<<nsmem, kThreads, smem, st>>>(C, n, idx, ptr, out_off, sign, out, order + nglob);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const int blocks = nglob + ntile + (nwarp + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  block_inv_kernel<T><<<blocks, kThreads, 0, st>>>(C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, order, nglob,
                                                   order + nglob + nsmem, ntile, nwarp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// order: the sets largest first, as the classes global (nglob), shared (nsmem; smem_s the largest, which sizes
// the launch's dynamic shared memory), tile (ntile) and warp (nwarp); goff[q] is a global set's offset into the
// workspaces gf and gperm.
int tg_block_inv_f32(const float* C, int n, const int* idx, const long long* ptr, const long long* out_off,
                     const float* sign, float* out, const long long* goff, float* gf, int* gperm, const int* order,
                     int nglob, int nsmem, int ntile, int nwarp, int smem_s, void* stream) {
  return launch_block_inv<float>(C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, order, nglob, nsmem, ntile,
                                 nwarp, smem_s, stream);
}
int tg_block_inv_f64(const double* C, int n, const int* idx, const long long* ptr, const long long* out_off,
                     const double* sign, double* out, const long long* goff, double* gf, int* gperm,
                     const int* order, int nglob, int nsmem, int ntile, int nwarp, int smem_s, void* stream) {
  return launch_block_inv<double>(C, n, idx, ptr, out_off, sign, out, goff, gf, gperm, order, nglob, nsmem, ntile,
                                  nwarp, smem_s, stream);
}

}  // extern "C"
