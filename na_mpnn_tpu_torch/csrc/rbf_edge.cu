// Dense all-pair-atom RBF edge features fused with their projection, for
// Hopper (sm_90a), rbf_mode="dense"; fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_edge.py::rbf_edge_embed
// (_kernel, rbf_edge.py:38). Per edge (query row i -> key row j): the
// distances between all 18 x 18 augmented atom pairs (a of i, b of j), 16
// Gaussian bins each, masked by atom presence on both ends (rbf_common.cuh),
// times the projection W [18*18*16, H] in the reference row order
// (a*18 + b)*16 + r. The TPU kernel permutes W to a bin-major order for its
// one-hot expansion matmuls; nothing here needs that, so W is read as the
// model stores it. The function is the class-specialised kernel's
// (rbf_classed.cu); this one computes every atom pair instead of the
// populated class blocks.
//
// bf16 (rbf_edge_forward_bf16; the TPU kernel's bf16 branch,
// rbf_edge.py:63-76): the bins are the fp32 kernel's exact exp bins, each
// masked bin rounded to bf16, W arrives as bf16(W), and the products of the
// two sum in fp32 into the fp32 output. (The damped recursive bins belong
// to the classed kernel's bf16 branch only.)
//
// What bounds it on the card: operations, 2*H multiply-adds per atom pair and
// bin of every edge (2 * 5184 * H = 1.3 MFLOP per edge at H = 128), against
// about 1.3 KB of coordinates, masks, index and output per edge.
// Design: one block of 128 threads per tile of 32 edges, as rbf_classed.cu:
// the block gathers its edges' query and key rows, computes one bin for all
// 324 atom pairs of its 32 edges into shared memory ([324][32], 41 KB), and
// each thread accumulates 32 edges x (H/128) output columns in registers
// while the 324 weight rows of that bin stream through L2.
#include "rbf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kAA = kA * kA;

constexpr int smem_floats() { return 2 * kTE * 3 * kA + 2 * kTE * kA + kAA * kTE; }

template <int HC, typename TW>
__global__ void __launch_bounds__(kThreads)
rbf_edge_kernel(const float* __restrict__ Xq, const float* __restrict__ Mq,
                const float* __restrict__ Xk, const float* __restrict__ Mk,
                const long long* __restrict__ nbr, int E, int K, int H,
                const TW* __restrict__ W, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* bins = smem;                  // [kAA][kTE]
  float* qx = bins + kAA * kTE;        // [kTE][3A]
  float* nx = qx + kTE * 3 * kA;       // [kTE][3A]
  float* qm = nx + kTE * 3 * kA;       // [kTE][A]
  float* nm = qm + kTE * kA;           // [kTE][A]
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kTE;
  load_edge_tile(Xq, Mq, Xk, Mk, nbr, E, K, e0, qx, nx, qm, nm);
  __syncthreads();

  float acc[HC][kTE];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int e = 0; e < kTE; ++e) acc[c][e] = 0.f;

  for (int r = 0; r < kR; ++r) {
    const float mu = bin_mu(r);
    for (int idx = tid; idx < kAA * kTE; idx += kThreads) {
      const int a = idx / kTE, e = idx % kTE;
      bins[idx] = rnd<TW>(rbf_bin(qx, nx, qm, nm, e, a / kA, a % kA, mu));
    }
    __syncthreads();
    for (int a = 0; a < kAA; ++a) {
      const TW* Wr = W + ((size_t)a * kR + r) * H;
      float w[HC];
#pragma unroll
      for (int c = 0; c < HC; ++c) {
        const int h = tid + c * kThreads;
        w[c] = h < H ? ldf(Wr + h) : 0.f;
      }
      const float4* brow = reinterpret_cast<const float4*>(bins + a * kTE);
#pragma unroll
      for (int e4 = 0; e4 < kTE / 4; ++e4) {
        const float4 bv = brow[e4];
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          acc[c][4 * e4 + 0] = fmaf(bv.x, w[c], acc[c][4 * e4 + 0]);
          acc[c][4 * e4 + 1] = fmaf(bv.y, w[c], acc[c][4 * e4 + 1]);
          acc[c][4 * e4 + 2] = fmaf(bv.z, w[c], acc[c][4 * e4 + 2]);
          acc[c][4 * e4 + 3] = fmaf(bv.w, w[c], acc[c][4 * e4 + 3]);
        }
      }
    }
    __syncthreads();  // bins consumed before the next bin overwrites them
  }

#pragma unroll
  for (int c = 0; c < HC; ++c) {
    const int h = tid + c * kThreads;
    if (h >= H) continue;
#pragma unroll
    for (int e = 0; e < kTE; ++e)
      if (e0 + e < E) out[(size_t)(e0 + e) * H + h] = acc[c][e];
  }
}

template <int HC, typename TW>
int launch(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
           const long long* nbr, int E, int K, int H, const TW* W,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rbf_edge_kernel<HC, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rbf_edge_kernel<HC, TW><<<(E + kTE - 1) / kTE, kThreads, smem, stream>>>(
      Xq, Mq, Xk, Mk, nbr, E, K, H, W, out);
  return (int)cudaGetLastError();
}

template <typename TW>
int forward(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
            const long long* nbr, int E, int K, int H, const TW* W, float* out,
            cudaStream_t stream) {
  if (E < 1 || K < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (H <= kThreads) return launch<1>(Xq, Mq, Xk, Mk, nbr, E, K, H, W, out, stream);
  if (H <= 2 * kThreads) return launch<2>(Xq, Mq, Xk, Mk, nbr, E, K, H, W, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, reference atom
// order), Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each
// edge; the query row of edge e is e / K), W [5184, H] (reference row
// order); out [E, H].
extern "C" int rbf_edge_forward(const float* Xq, const float* Mq,
                                const float* Xk, const float* Mk,
                                const long long* nbr, int E, int K, int H,
                                const float* W, float* out,
                                cudaStream_t stream) {
  return forward<float>(Xq, Mq, Xk, Mk, nbr, E, K, H, W, out, stream);
}

// The bf16 trunk's function: bf16-rounded exact bins against bf16(W);
// coordinates, masks and out fp32.
extern "C" int rbf_edge_forward_bf16(const float* Xq, const float* Mq,
                                     const float* Xk, const float* Mk,
                                     const long long* nbr, int E, int K,
                                     int H, const bf16* W, float* out,
                                     cudaStream_t stream) {
  return forward<bf16>(Xq, Mq, Xk, Mk, nbr, E, K, H, W, out, stream);
}
