// The two operand types of the kernels: fp32, and bf16 for the bf16 trunk
// (the TPU kernels' compute_dtype=bfloat16 branch). Every kernel computes in
// fp32; a bf16 operand is widened exactly on load, a bf16 output is rounded
// to nearest even on store (as JAX's astype), and a value that feeds a
// product is rounded to bf16 first (rnd<bf16>), so that each product is one
// of bf16 operands summed in fp32: what a bf16 tensor-core MMA computes, up
// to the order of the sum. For T = float every helper is the identity, and
// the fp32 kernels compute exactly as before.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the operand type T (the identity for fp32).
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// A read-only element widened to fp32.
template <typename T>
__device__ __forceinline__ float ldf(const T* p) { return to_f(__ldg(p)); }

// Four consecutive elements (16-byte aligned for fp32, 8-byte for bf16).
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Two consecutive elements (8-byte aligned for fp32, 4-byte for bf16),
// widened; and two stored, rounded to the type.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace
