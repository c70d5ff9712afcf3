// Warp-level tensor-core products for Hopper (sm_90a), shared by the
// message MLP's forward and backward walks (message_tile.cuh,
// message_bwd_tile.cuh: the message table and its backward, the fused layer
// updates, the pre-gathered message MLP and its backward) and the RBF
// projections' walks (rbf_tile.cuh: the classed and the dense forward
// and their weight gradients).
//
// bf16: mma.sync m16n8k16, bf16 operands, fp32 accumulators; what each
// product of the bf16 trunk computes (bf16 operands summed in fp32).
// fp32: 3xTF32 on mma.sync m16n8k8: each operand x splits into big = x
// rounded to tf32 and small = x - big truncated to tf32, and a product adds
// small*big + big*small + big*big in fp32 (the small*small term, below
// 2^-22 of the product, is dropped; small's truncation, below 2^-21): fp32
// accuracy on the tensor cores. The split is a few integer operations, not
// two cvt.rna conversions, because every warp that reads a weight element
// splits it again: its cost is paid once per product, not once per weight.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// ".m16n8k8"), with g = lane / 4 and t = lane % 4:
//   bf16 A 16x16: a0 = A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..],
//                 a3 = A[g+8][2t+8..];  B 16x8: b0 = B[2t..2t+1][g],
//                 b1 = B[2t+8..2t+9][g]
//   tf32 A 16x8:  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
//                 a3 = A[g+8][t+4];  B 8x8: b0 = B[t][g], b1 = B[t+4][g]
//   C 16x8 (both): c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "precision.cuh"

namespace {

// Row stride (elements) of an operand W wide in shared memory: conflict-free
// fragment loads for each type (ld/2 = 4 mod 32 words for bf16, ld = 4 mod
// 32 for fp32).
template <typename T>
__host__ __device__ constexpr int lda(int W) { return sizeof(T) == 2 ? W + 8 : W + 4; }

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small: big = x to 10 mantissa bits (ties away from zero), and
// small = x - big (exact in fp32) truncated to tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// An fp32 A fragment (a0..a3 in the tf32 layout) split once for every
// n-tile it meets.
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], big[i], small[i]);
  }
};

// c += a * b in 3xTF32 (b0, b1 fp32, in the tf32 B layout).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(c, a.small, bb0, bb1);
  mma_tf32(c, a.big, bs0, bs1);
  mma_tf32(c, a.big, bb0, bb1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// Two bf16 elements at p (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 A fragment of the 16x16 block at (m0, k0) of A, row-major in shared
// memory with row stride ld (elements; ld/2 = 4 mod 32 words keeps the
// loads free of bank conflicts).
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4],
                                            const __nv_bfloat16* A, int ld,
                                            int m0, int k0) {
  const int g = lane_g(), t = lane_t();
  const __nv_bfloat16* p = A + (m0 + g) * ld + k0 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * ld);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * ld + 8);
}

// bf16 A fragment of the 16x16 block at (m0, k0) of A = S^T, S [k][m]
// row-major in shared memory (row stride ld, 16-byte aligned rows).
__device__ __forceinline__ void frag_a_bf16_trans(uint32_t (&a)[4],
                                                  const __nv_bfloat16* S,
                                                  int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, j = lane & 7;
  ldmatrix_x4_trans(a, S + (k0 + j + ((mat >> 1) << 3)) * ld + m0 +
                           ((mat & 1) << 3));
}

// bf16 B fragments of two n-tiles (n0 and n0 + 8) at k0 from S [k][n]
// row-major in shared memory: b[0], b[1] for n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void frag_b2_bf16_trans(uint32_t (&b)[4],
                                                   const __nv_bfloat16* S,
                                                   int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mat = lane >> 3, j = lane & 7;
  ldmatrix_x4_trans(b, S + (k0 + j + ((mat & 1) << 3)) * ld + n0 +
                           ((mat >> 1) << 3));
}

// bf16 B fragment of the n-tile n0 at k0 from S [k][n] row-major in shared
// memory (row stride ld, 16-byte aligned rows).
__device__ __forceinline__ void frag_b_bf16_trans(uint32_t (&b)[2],
                                                  const __nv_bfloat16* S,
                                                  int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, mat = (lane >> 3) & 1, j = lane & 7;
  ldmatrix_x2_trans(b, S + (k0 + j + (mat << 3)) * ld + n0);
}

// acc[j] = A[16 rb .. +16, :] @ B[:, cb + 8j .. +8] for a warp's NT n-tiles,
// with A [rows][lda<bf16>(H)] and the weight Bs [n][k] (row stride H + 8) in
// shared memory.
template <int H, int NT>
__device__ __forceinline__ void product(const bf16* A, const bf16* Bs, int rb,
                                        int cb, float (&acc)[NT][4]) {
  constexpr int LA = lda<bf16>(H), LB = H + 8;
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t a[4];
    frag_a_bf16(a, A, LA, 16 * rb, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* b = Bs + (cb + 8 * j + g) * LB + k0 + 2 * t;
      mma_bf16(acc[j], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

// The same with the weight B [k][n] (row stride H + 8) in shared memory, as
// cp.async copies it from a row-major [in, out] weight.
template <int H, int NT>
__device__ __forceinline__ void product_kn(const bf16* A, const bf16* B, int rb,
                                           int cb, float (&acc)[NT][4]) {
  constexpr int LA = lda<bf16>(H), LB = H + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t a[4];
    frag_a_bf16(a, A, LA, 16 * rb, k0);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b[2];
      frag_b_bf16_trans(b, B, LB, cb + 8 * j, k0);
      mma_bf16(acc[j], a, b[0], b[1]);
    }
  }
}

// The same in 3xTF32 with A [rows][lda<float>(H)] and the weight W [H, H]
// in shared memory read as B[k][n] = W[k][n] (nk false, row stride H + 8)
// or W[n][k] (nk true, row stride H + 4).
template <int H, int NT>
__device__ __forceinline__ void product(const float* A, const float* W, bool nk,
                                        int rb, int cb, float (&acc)[NT][4]) {
  constexpr int LA = lda<float>(H);
  const int g = lane_g(), t = lane_t();
  const int sk = nk ? 1 : H + 8, sn = nk ? H + 4 : 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < H; k0 += 8) {
    const float* pa = A + (16 * rb + g) * LA + k0 + t;
    const float af[4] = {pa[0], pa[8 * LA], pa[4], pa[8 * LA + 4]};
    SplitA a;
    a.set(af);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* b = W + (k0 + t) * sk + (cb + 8 * j + g) * sn;
      mma_3xtf32(acc[j], a, b[0], b[4 * sk]);
    }
  }
}

}  // namespace
