// Masked exact k-nearest-neighbour graph for Hopper (sm_90a), in two entry
// points over one kernel:
//   knn_forward     replaces na_mpnn_tpu/ops/knn.py::knn_graph_pallas
//                   (knn.py:106): the L rows of a structure against each other;
//   knn_qk_forward  replaces knn_graph_pallas_qk (knn.py:54): Lq query rows
//                   against Lk key rows (the graph-parallel forward: a shard's
//                   rows against the all-gathered structure).
// Both TPU kernels (_kernel, knn.py:26) give each grid step a [256, Lk] tile
// of the distance matrix in VMEM and run K min/argmin sweeps over it.
//
// Semantics (those of the plain version, ops/knn.py::knn_graph_qk_plain):
//   D[i,j] = m_i*m_j * sqrt(dx*dx + dy*dy + dz*dz + eps), j over the Lk keys
//   invalid pairs get the row max added (they sort last)
//   the k smallest, ascending, ties to the lowest key index.
// E_idx must equal the plain version exactly, so the distance is built with
// the round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsqrt_rn) in the
// plain version's order: no multiply-add is contracted into an FMA.
//
// What bounds it on the card: the B*Lq*Lk distances and the k passes over
// each row (operations, with a few bytes per row in and k*12 bytes out).
// Design: one block of 256 threads per query row. The row's Lk distances
// live in shared memory (4*Lk bytes, 24.6 KB at Lk = 6144), so each of the k
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
knn_kernel(const float* __restrict__ Xq, const float* __restrict__ mask_q,
           const float* __restrict__ Xk, const float* __restrict__ mask_k,
           int Lq, int L, int k, float eps, float* __restrict__ D_out,
           long long* __restrict__ E_out) {
  extern __shared__ float dist[];  // [L]: this row's distances to the L keys
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float row_max;

  const int row = blockIdx.x;  // b*Lq + i
  const int b = row / Lq;
  const float* Xb = Xk + (size_t)b * L * 3;
  const float* mb = mask_k + (size_t)b * L;
  const float xi[3] = {Xq[(size_t)row * 3], Xq[(size_t)row * 3 + 1],
                       Xq[(size_t)row * 3 + 2]};
  const float mi = mask_q[row];
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

int launch(const float* Xq, const float* mask_q, const float* Xk,
           const float* mask_k, int B, int Lq, int Lk, int k, float eps,
           float* D_out, long long* E_out, cudaStream_t stream) {
  if (B < 1 || Lq < 1 || k < 1 || k > Lk) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)Lk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  knn_kernel<<<B * Lq, kThreads, smem, stream>>>(Xq, mask_q, Xk, mask_k, Lq,
                                                 Lk, k, eps, D_out, E_out);
  return (int)cudaGetLastError();
}

}  // namespace

// X [B, L, 3], mask [B, L] -> D_out [B, L, k], E_out [B, L, k].
extern "C" int knn_forward(const float* X, const float* mask, int B, int L,
                           int k, float eps, float* D_out, long long* E_out,
                           cudaStream_t stream) {
  return launch(X, mask, X, mask, B, L, L, k, eps, D_out, E_out, stream);
}

// Xq [B, Lq, 3], mask_q [B, Lq], Xk [B, Lk, 3], mask_k [B, Lk]
// -> D_out [B, Lq, k], E_out [B, Lq, k] (key indices).
extern "C" int knn_qk_forward(const float* Xq, const float* mask_q,
                              const float* Xk, const float* mask_k, int B,
                              int Lq, int Lk, int k, float eps, float* D_out,
                              long long* E_out, cudaStream_t stream) {
  return launch(Xq, mask_q, Xk, mask_k, B, Lq, Lk, k, eps, D_out, E_out,
                stream);
}
