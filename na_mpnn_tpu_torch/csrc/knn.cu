// Masked exact k-nearest-neighbour graph for Hopper (sm_90a).
//
// Replaces the TPU kernel na_mpnn_tpu/ops/knn.py::knn_graph_pallas (_kernel,
// knn.py:26), which gives each grid step a [256, L] tile of the distance
// matrix in VMEM and runs K min/argmin sweeps over it.
//
// Semantics (those of the plain version, ops/knn.py::knn_graph_plain):
//   D[i,j] = m_i*m_j * sqrt(dx*dx + dy*dy + dz*dz + eps)
//   invalid pairs get the row max added (they sort last)
//   the k smallest, ascending, ties to the lowest index.
// E_idx must equal the plain version exactly, so the distance is built with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsqrt_rn) in the
// plain version's order: no multiply-add is contracted into an FMA.
//
// What bounds it on the card: the B*L*L distances and the k passes over
// each row (operations, with a few bytes per row in and k*12 bytes out).
// Design: one block of 256 threads per query row. The row's L distances
// live in shared memory (4*L bytes, 24.6 KB at L = 6144), so each of the k
// argmin passes reads shared memory only; a pass is a per-thread scan, a warp
// shuffle reduction on (value, index) and one across the 8 warps.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void keep_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ float pair_dist(const float* xi, const float* xj,
                                           float m2, float eps) {
  float dx = __fsub_rn(xi[0], xj[0]);
  float dy = __fsub_rn(xi[1], xj[1]);
  float dz = __fsub_rn(xi[2], xj[2]);
  float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz));
  return __fmul_rn(m2, __fsqrt_rn(__fadd_rn(s, eps)));
}

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ X, const float* __restrict__ mask, int L,
           int k, float eps, float* __restrict__ D_out,
           long long* __restrict__ E_out) {
  extern __shared__ float dist[];  // [L]
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float row_max;

  const int row = blockIdx.x;  // b*L + i
  const int b = row / L;
  const float* Xb = X + (size_t)b * L * 3;
  const float* mb = mask + (size_t)b * L;
  const float xi[3] = {X[(size_t)row * 3], X[(size_t)row * 3 + 1],
                       X[(size_t)row * 3 + 2]};
  const float mi = mask[row];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float local_max = -CUDART_INF_F;
  for (int j = tid; j < L; j += kThreads) {
    float d = pair_dist(xi, Xb + 3 * (size_t)j, __fmul_rn(mb[j], mi), eps);
    dist[j] = d;
    local_max = fmaxf(local_max, d);
  }
  for (int off = 16; off > 0; off >>= 1)
    local_max = fmaxf(local_max, __shfl_down_sync(0xffffffffu, local_max, off));
  if (lane == 0) red_v[warp] = local_max;
  __syncthreads();
  if (tid == 0) {
    float m = red_v[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_v[w]);
    row_max = m;
  }
  __syncthreads();
  const float dmax = row_max;
  // D + (1 - m2) * D_max, as the plain version writes it.
  for (int j = tid; j < L; j += kThreads) {
    float m2 = __fmul_rn(mb[j], mi);
    dist[j] = __fadd_rn(dist[j], __fmul_rn(__fsub_rn(1.0f, m2), dmax));
  }
  __syncthreads();

  for (int s = 0; s < k; ++s) {
    float bv = CUDART_INF_F;
    int bi = L;
    for (int j = tid; j < L; j += kThreads) keep_min(bv, bi, dist[j], j);
    for (int off = 16; off > 0; off >>= 1) {
      float v2 = __shfl_down_sync(0xffffffffu, bv, off);
      int i2 = __shfl_down_sync(0xffffffffu, bi, off);
      keep_min(bv, bi, v2, i2);
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) keep_min(bv, bi, red_v[w], red_i[w]);
      D_out[(size_t)row * k + s] = bv;
      E_out[(size_t)row * k + s] = bi;
      if (bi < L) dist[bi] = CUDART_INF_F;  // bi == L only for NaN distances
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int knn_forward(const float* X, const float* mask, int B, int L,
                           int k, float eps, float* D_out, long long* E_out,
                           cudaStream_t stream) {
  size_t smem = (size_t)L * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<<<B * L, kThreads, smem, stream>>>(X, mask, L, k, eps, D_out,
                                                E_out);
  return (int)cudaGetLastError();
}
