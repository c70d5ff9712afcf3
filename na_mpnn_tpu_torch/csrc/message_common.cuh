// What the message kernels share: the exact erf GELU and its derivative
// and the mode codes (the message-table forward and backward,
// message_table.cu and message_table_bwd.cu: the backward resumes from the
// forward's pre-GELU x, so both must compute GELU alike), and the tiling
// and tile-by-weight product of the message MLP kernels and the fused layer
// updates (message_mlp*.cu, fused_layers.cu).
// The weights of a product are fp32 or bf16 (precision.cuh); the tile's
// activations are fp32 in shared memory, already rounded to bf16 where the
// bf16 trunk feeds them to a product.
#pragma once
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // edge rows per tile: 8 warps x 8 rows
constexpr int kKC = 32;    // weight rows per shared-memory chunk
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

// acc[i][c] = sum_k As[ty + 8i][k] * W[k][tx*CPT + c]; W is [H, H] ([in, out]),
// fp32 or bf16. The weight streams through Ws (fp32) in chunks of kKC rows;
// ends on a barrier.
template <int H, typename TW>
__device__ __forceinline__ void gemm(const float* As,
                                     const TW* __restrict__ W, float* Ws,
                                     float (&acc)[8][H / 32]) {
  constexpr int CPT = H / 32;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kKC) {
    for (int idx = tid; idx < kKC * H; idx += kThreads)
      Ws[idx] = ldf(W + (size_t)k0 * H + idx);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float b[CPT];
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int c4 = 0; c4 < CPT / 4; ++c4) {
          float4 v = reinterpret_cast<const float4*>(Ws + kk * H + tx * CPT)[c4];
          b[4 * c4] = v.x;
          b[4 * c4 + 1] = v.y;
          b[4 * c4 + 2] = v.z;
          b[4 * c4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) b[c] = Ws[kk * H + tx * CPT + c];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = As[(ty + 8 * i) * H + k0 + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a, b[c], acc[i][c]);
      }
    }
    __syncthreads();
  }
}

}  // namespace
