// Arithmetic rounded once per operation, with no fused multiply-add: the
// kernels that include this (K16 kl_columns, K17 block_inv) repeat their
// plain PyTorch versions operation for operation, and PyTorch rounds the
// product and the difference of `a - b * c` separately. So kernel and plain
// version give the same bits, and a column that breaks down in one breaks
// down in the other.
#pragma once

#include <cuda_runtime.h>

namespace tgrn {

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
  __device__ static float sqrt(float a) { return __fsqrt_rn(a); }
  __device__ static float abs(float a) { return fabsf(a); }
  __device__ static float nan() { return __int_as_float(0x7fc00000); }
};

template <>
struct Rn<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
  __device__ static double sqrt(double a) { return __dsqrt_rn(a); }
  __device__ static double abs(double a) { return ::fabs(a); }
  __device__ static double nan() { return __longlong_as_double(0x7ff8000000000000LL); }
};

// Opt in to the dynamic shared memory of a launch (the 48 KB default bounds
// static + dynamic together).
template <typename K>
inline int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tgrn
