// What the message kernels share: the exact erf GELU and its derivative,
// and the mode codes. Every message kernel (the forward walk of
// message_tile.cuh: message_table.cu, fused_layers.cu, message_mlp.cu; the
// backward walk of message_bwd_tile.cuh: message_table_bwd.cu,
// message_mlp_bwd.cu) computes GELU with these, since a backward recomputes
// or resumes from its forward's pre-GELU x; their products run on the
// tensor cores (mma.cuh).
#pragma once
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int kEncNode = 0, kEncEdge = 1, kDec = 2;

__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// Phi(x), so that gelu(x) = x * Phi(x) (the same fp32 value: halving is
// exact).
__device__ __forceinline__ float gelu_cdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

// Phi(x) + x * phi(x), the exact derivative of gelu (cdf = Phi(x)).
__device__ __forceinline__ float gelu_grad(float x, float cdf) {
  return cdf + x * 0.39894228040143268f * expf(-0.5f * x * x);
}
__device__ __forceinline__ float gelu_grad(float x) {
  return gelu_grad(x, gelu_cdf(x));
}

}  // namespace
