// Segmented scans of first-order recurrences over a warp or a block, for the
// tridiagonal kernels (csrc/tridiag.cu: K1 and K2).
//
// A chain of rows is cut into segments of m consecutive rows, one segment per
// thread. Each thread composes the step maps of its own segment (compose), the
// threads' maps are scanned across the warp by shuffles and, where a chain
// spans several warps, the warps' totals across the block through shared
// memory (scan), and each thread applies its exclusive prefix to the state
// entering the tile, which gives the state entering its segment. The kernel
// then runs the sequential recurrence over the segment's rows from that state
// (replay), so every value but the segments' carry-ins is rounded as the
// sequential loop rounds it.
//
// Two kinds of map, each with its state:
//   Mobius  x -> (a x + b) / (c x + d), a 2x2 matrix acting on the projective
//           pair (p, q) with x = p / q. Every product is multiplied by the
//           power of two that brings its largest entry into [1, 2): the
//           ratio is unchanged, float32 stays in range for any n, and the
//           scaling itself rounds nothing (the reference divides by the
//           largest entry instead, tpu_gmrf/solvers/prefix.py:63-79).
//   Affine  y -> A y + B, acting on y.
// A map `after(l, e)` is e first, then l. "Forward" scans take the threads in
// order (thread 0's segment first), backward scans the other way round.
#pragma once

#include <cuda_runtime.h>

namespace scan {

template <typename T>
struct Mobius {
  T a, b, c, d;
};
template <typename T>
struct Proj {
  T p, q;
};
template <typename T>
struct Affine {
  T A, B;
};

__device__ __forceinline__ float amax(float x, float y) { return fmaxf(x, y); }
__device__ __forceinline__ double amax(double x, double y) { return fmax(x, y); }
__device__ __forceinline__ float aabs(float x) { return fabsf(x); }
__device__ __forceinline__ double aabs(double x) { return fabs(x); }

// 2^-e for s in [2^e, 2^(e+1)), e clamped so that the factor stays a normal
// number (zero, subnormal, inf and NaN keep what they are under it).
__device__ __forceinline__ float pow2_inv(float s) {
  int e = (__float_as_int(s) >> 23) & 0xff;
  e = min(max(e, 1), 253);
  return __int_as_float((254 - e) << 23);
}
__device__ __forceinline__ double pow2_inv(double s) {
  long long e = (__double_as_longlong(s) >> 52) & 0x7ff;
  e = min(max(e, 1LL), 2045LL);
  return __longlong_as_double((2046 - e) << 52);
}

template <typename T>
__device__ __forceinline__ Mobius<T> normalized(T a, T b, T c, T d) {
  const T s = pow2_inv(amax(amax(aabs(a), aabs(b)), amax(aabs(c), aabs(d))));
  return {a * s, b * s, c * s, d * s};
}

template <typename M>
__device__ __forceinline__ M identity();
template <>
__device__ __forceinline__ Mobius<float> identity<Mobius<float>>() { return {1.f, 0.f, 0.f, 1.f}; }
template <>
__device__ __forceinline__ Mobius<double> identity<Mobius<double>>() { return {1.0, 0.0, 0.0, 1.0}; }
template <>
__device__ __forceinline__ Affine<float> identity<Affine<float>>() { return {1.f, 0.f}; }
template <>
__device__ __forceinline__ Affine<double> identity<Affine<double>>() { return {1.0, 0.0}; }

template <typename T>
__device__ __forceinline__ Mobius<T> after(const Mobius<T>& l, const Mobius<T>& e) {
  return normalized(l.a * e.a + l.b * e.c, l.a * e.b + l.b * e.d, l.c * e.a + l.d * e.c, l.c * e.b + l.d * e.d);
}
template <typename T>
__device__ __forceinline__ Affine<T> after(const Affine<T>& l, const Affine<T>& e) {
  return {l.A * e.A, l.A * e.B + l.B};
}

template <typename T>
__device__ __forceinline__ Proj<T> apply(const Mobius<T>& m, const Proj<T>& x) {
  const T p = m.a * x.p + m.b * x.q, q = m.c * x.p + m.d * x.q;
  const T s = pow2_inv(amax(aabs(p), aabs(q)));
  return {p * s, q * s};
}
template <typename T>
__device__ __forceinline__ T apply(const Affine<T>& m, T y) {
  return m.A * y + m.B;
}

constexpr unsigned kFull = 0xffffffffu;

template <bool Up, typename T>
__device__ __forceinline__ T shfl(T v, int s) {
  if constexpr (Up)
    return __shfl_up_sync(kFull, v, s);
  else
    return __shfl_down_sync(kFull, v, s);
}
template <bool Up, typename T>
__device__ __forceinline__ Mobius<T> shfl(const Mobius<T>& m, int s) {
  return {shfl<Up>(m.a, s), shfl<Up>(m.b, s), shfl<Up>(m.c, s), shfl<Up>(m.d, s)};
}
template <bool Up, typename T>
__device__ __forceinline__ Affine<T> shfl(const Affine<T>& m, int s) {
  return {shfl<Up>(m.A, s), shfl<Up>(m.B, s)};
}

// Inclusive scan of the lanes' maps in segment order: 5 shuffle steps.
template <bool Forward, typename M>
__device__ __forceinline__ M warp_inclusive(M x, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const M y = shfl<Forward>(x, s);
    if (Forward ? lane >= s : lane + s < 32) x = after(x, y);
  }
  return x;
}

// The composition of the lanes before this one in segment order.
template <bool Forward, typename M>
__device__ __forceinline__ M warp_exclusive(const M& inclusive, int lane) {
  const M y = shfl<Forward>(inclusive, 1);
  return (Forward ? lane == 0 : lane == 31) ? identity<M>() : y;
}

// The state entering this thread's segment: the maps of the segments before
// it in the block (of nwarps warps) applied to `carry`, the state entering
// the tile. With nwarps > 1 every thread of the block calls it: the warps'
// totals meet in shared memory (wmaps, wstates: 32 entries each), where warp
// 0 scans them.
template <bool Forward, typename M, typename S>
__device__ __forceinline__ S entry_state(const M& mine, const S& carry, int nwarps, M* wmaps, S* wstates) {
  const int lane = threadIdx.x & 31;
  const M inc = warp_inclusive<Forward>(mine, lane);
  const M exc = warp_exclusive<Forward>(inc, lane);
  S at = carry;
  if (nwarps > 1) {
    const int warp = threadIdx.x >> 5;
    if (lane == (Forward ? 31 : 0)) wmaps[warp] = inc;
    __syncthreads();
    if (warp == 0) {
      const M wi = warp_inclusive<Forward>(lane < nwarps ? wmaps[lane] : identity<M>(), lane);
      const M we = warp_exclusive<Forward>(wi, lane);
      if (lane < nwarps) wstates[lane] = apply(we, carry);
    }
    __syncthreads();
    at = wstates[warp];
  }
  return apply(exc, at);
}

// Sum of v over the block in a fixed order (a shuffle tree, then the warps'
// sums in warp order); the result is thread 0's. `red`: 32 shared entries.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int nwarps, T* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (nwarps > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? red[lane] : T(0);
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    }
  }
  return v;
}

// The block's barrier; a one-warp block needs only the warp's.
__device__ __forceinline__ void group_sync(int nwarps) {
  if (nwarps > 1)
    __syncthreads();
  else
    __syncwarp();
}

// Shared-memory position of a tile's row j where rows sit in segments of m
// per thread at an odd stride s = m | 1: the threads' reads of their i-th
// rows fall in distinct banks, and the coalesced loads stay nearly so.
__device__ __forceinline__ int seg_pos(int j, int m, int s) { return j + (j / m) * (s - m); }

}  // namespace scan
