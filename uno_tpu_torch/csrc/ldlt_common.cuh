// Device arithmetic shared by the LDL^T kernels (ldlt.cu, ldlt_column.cu):
// correctly rounded operations, each fused multiply-add written out (the
// compiler contracts nothing), the correctly rounded division by a pivot
// from its reciprocal, the pivot clamp and NaN rule of the plain versions
// (uno_tpu_torch/linalg/ldlt.py's _safe and _inertia), and 16-byte vector
// accesses.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

// a / b correctly rounded, given y = rcp_rn(b): Markstein's correction
// q0 = a y, r = a - b q0 (exact with a fused multiply-add), q = q0 + r y
// gives the correctly rounded quotient when nothing over- or underflows; the
// other cases take the division itself.
template <typename T> struct FastRange;  // |a| and |a/b| inside (1/big, big)
template <> struct FastRange<float> { static constexpr float big = 0x1p100f, small = 0x1p-100f; };
template <> struct FastRange<double> { static constexpr double big = 0x1p900, small = 0x1p-900; };

template <typename T>
__device__ __forceinline__ T div_by(T a, T b, T y) {
  const T q0 = mul_rn(a, y);
  const T aq = fabs(q0), aa = fabs(a);
  if (aq < FastRange<T>::big && aq > FastRange<T>::small &&
      aa < FastRange<T>::big && aa > FastRange<T>::small)
    return fma_rn(fma_rn(-q0, b, a), y, q0);
  if (a == T(0)) return q0;           // a zero of the quotient's sign
  return div_rn(a, b);
}

// div_by's fast path without a branch: the quotient where that path holds
// or a is zero; elsewhere `slow` is set and a / b is left to the caller
template <typename T>
__device__ __forceinline__ T div_by_fast(T a, T b, T y, bool& slow) {
  const T q0 = mul_rn(a, y);
  const T aq = fabs(q0), aa = fabs(a);
  const bool fast = aq < FastRange<T>::big && aq > FastRange<T>::small &&
                    aa < FastRange<T>::big && aa > FastRange<T>::small;
  slow = !fast && a != T(0);
  return fast ? fma_rn(fma_rn(-q0, b, a), y, q0) : q0;
}

template <typename T>
__device__ __forceinline__ T safe_pivot(T dj) {
  const T tiny = T(1e-35);
  return (dj < tiny && dj > -tiny) ? (dj < T(0) ? -tiny : tiny) : dj;
}

// max that returns NaN if either argument is NaN, as torch.amax/maximum do
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// 16-byte vector loads and stores of 16 / sizeof(T) elements
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the inertia class of pivot di (`live`: a real pivot, not padding)
template <typename T>
__device__ __forceinline__ void classify(T di, bool live, T thresh, bool& p,
                                         bool& n, bool& z) {
  const bool small = fabs(di) <= thresh;
  z = live && small;
  p = live && !small && di > T(0);
  n = live && !small && di < T(0);
}

}  // namespace
