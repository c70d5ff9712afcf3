// Weight gradient of the dense RBF projection, for Hopper (sm_90a); fp32, and
// bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_edge.py::rbf_edge_embed_dw
// (_bwd_kernel, rbf_edge.py:151). For the cotangent g [E, H] of the
// projection out = bins @ W (rbf_edge.cu), dW[(a*18 + b)*16 + r][h] =
// sum_e bin(e, a, b, r) * g[e][h], with the forward's bins (rbf_common.cuh),
// written straight in the reference row order of W. The TPU kernel keeps the
// whole [5184, H] block in VMEM and adds every grid step into it; blocks on
// Hopper run in no order, so:
//
// Two launches:
// 1. accumulate: a block owns a slice of 128 rows of the 5184 and one of
//    kSplit edge chunks. It walks the chunk's tiles of 32 edges, recomputes
//    its rows' bins for the tile in shared memory, and adds bins^T @ g_tile
//    into 128 x H accumulators in registers (rbf_common.cuh::dw_tile_product).
//    It writes them to its chunk's partial [kSplit][5184][H]. No atomics.
// 2. reduce: dW[row] = sum over the kSplit partials, in order.
// The result is deterministic: two identical launches agree bitwise.
//
// bf16 (rbf_edge_dw_bf16; the TPU kernel's bf16 branch, rbf_edge.py:179-186):
// the forward's exact bins and g both enter rounded to bf16, and their
// products sum in fp32 in the same fixed order into the fp32 dW.
//
// What bounds it on the card: operations, 2*H multiply-adds per atom pair and
// bin of every edge (as the forward), against the edge operands and g (about
// 1 KB per edge). The cost of this design: g and the tile operands are read
// once per slice (41 slices), mostly from L2.
#include "rbf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSliceRows = 128;
constexpr int kSplit = 16;                 // edge chunks
constexpr int kTotalRows = kR * kA * kA;   // 5184
constexpr int kSlices = (kTotalRows + kSliceRows - 1) / kSliceRows;  // 41

template <int H>
constexpr int acc_smem_floats() {
  return 2 * kTE * 3 * kA + 2 * kTE * kA + kSliceRows * kTE + kTE * H;
}

template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
rbf_edge_dw_accumulate(const float* __restrict__ Xq,
                       const float* __restrict__ Mq,
                       const float* __restrict__ Xk,
                       const float* __restrict__ Mk,
                       const long long* __restrict__ nbr,
                       const float* __restrict__ g, int E, int K,
                       float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* bins = smem;                   // [kSliceRows][kTE]
  float* gs = bins + kSliceRows * kTE;  // [kTE][H]
  float* qx = gs + kTE * H;             // [kTE][3A]
  float* nx = qx + kTE * 3 * kA;        // [kTE][3A]
  float* qm = nx + kTE * 3 * kA;        // [kTE][A]
  float* nm = qm + kTE * kA;            // [kTE][A]
  constexpr int CPT = H / 32;
  constexpr int NI = kSliceRows / 8;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int row0 = blockIdx.x * kSliceRows;
  const int nrows = min(kSliceRows, kTotalRows - row0);
  const int ntiles = (E + kTE - 1) / kTE;
  const int t_begin = (int)((long long)blockIdx.y * ntiles / kSplit);
  const int t_end = (int)((long long)(blockIdx.y + 1) * ntiles / kSplit);

  float acc[NI][CPT];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int e0 = t * kTE;
    load_edge_tile(Xq, Mq, Xk, Mk, nbr, E, K, e0, qx, nx, qm, nm);
    for (int idx = tid; idx < kTE * H; idx += kThreads) {
      const int e = idx / H;
      gs[idx] = e0 + e < E ? rnd<T>(g[(size_t)e0 * H + idx]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < kSliceRows * kTE; idx += kThreads) {
      const int i = idx / kTE, e = idx % kTE;
      float v = 0.f;
      if (i < nrows) {
        const int rho = row0 + i, pair = rho / kR, r = rho % kR;
        v = rnd<T>(rbf_bin(qx, nx, qm, nm, e, pair / kA, pair % kA, bin_mu(r)));
      }
      bins[idx] = v;
    }
    __syncthreads();
    dw_tile_product<H, NI>(bins, gs, acc);
    __syncthreads();  // the tile's buffers are consumed before the next load
  }

  float* out = part + ((size_t)blockIdx.y * kTotalRows + row0) * H;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = ty + 8 * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[(size_t)row * H + tx + 32 * c] = acc[i][c];
  }
}

template <int H, typename T>
int launch(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
           const long long* nbr, const float* g, int E, int K, float* part,
           float* dW, cudaStream_t stream) {
  const size_t smem = acc_smem_floats<H>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rbf_edge_dw_accumulate<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rbf_edge_dw_accumulate<H, T><<<dim3(kSlices, kSplit), kThreads, smem, stream>>>(
      Xq, Mq, Xk, Mk, nbr, g, E, K, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)kTotalRows * H;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, kSplit, nullptr, kTotalRows, H, dW);
  return (int)cudaGetLastError();
}

// T: the operand type the bins and g are rounded to (float: none).
template <typename T>
int dw(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
       const long long* nbr, const float* g, int E, int K, int H, float* part,
       float* dW, cudaStream_t stream) {
  if (E < 1 || K < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 32: return launch<32, T>(Xq, Mq, Xk, Mk, nbr, g, E, K, part, dW, stream);
    case 64: return launch<64, T>(Xq, Mq, Xk, Mk, nbr, g, E, K, part, dW, stream);
    case 128: return launch<128, T>(Xq, Mq, Xk, Mk, nbr, g, E, K, part, dW, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbf_edge_dw_splits() { return kSplit; }

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, reference atom
// order), Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each
// edge), g [E, H]; scratch part [kSplit, 5184, H]; dW [5184, H] in the
// reference row order.
extern "C" int rbf_edge_dw(const float* Xq, const float* Mq, const float* Xk,
                           const float* Mk, const long long* nbr,
                           const float* g, int E, int K, int H, float* part,
                           float* dW, cudaStream_t stream) {
  return dw<float>(Xq, Mq, Xk, Mk, nbr, g, E, K, H, part, dW, stream);
}

// The bf16 trunk's weight gradient (same operands, fp32 g and dW).
extern "C" int rbf_edge_dw_bf16(const float* Xq, const float* Mq,
                                const float* Xk, const float* Mk,
                                const long long* nbr, const float* g, int E,
                                int K, int H, float* part, float* dW,
                                cudaStream_t stream) {
  return dw<bf16>(Xq, Mq, Xk, Mk, nbr, g, E, K, H, part, dW, stream);
}
