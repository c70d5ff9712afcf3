// Message MLP on a pre-gathered neighbour operand, for Hopper (sm_90a),
// forward; fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_fwd_call (_fwd_kernel, message_kernels.py:89). Per edge row
// e = (node n, neighbour slot k):
//   x = h_V[n]@Wa + G[e] + b1 + (contract_e ? e_in[e]@Wb : e_in[e])
//   m = W3 . gelu(W2 . gelu(x) + b2) + b3            (exact erf GELU)
//   aggregate:  out[n] = sum_k mask_att[e]*m / 30     -> [N, H]
//   otherwise:  out[e] = m                            -> [N*K, H]
// The neighbour term G arrives gathered ([N*K, H], one row per edge), so the
// kernel takes any N; the TPU kernel pads N to its 32-node tile. The JAX
// training decoder at L % 32 != 0 calls it with contract_e = false,
// aggregate = true: e_in is the gathered causal context, G the edge term
// (models/mpnn.py:383-387).
//
// bf16 (message_mlp_forward_bf16; the TPU kernel's compute_dtype=bfloat16
// branch, message_kernels.py:77-100 with _dotp, fused_layers.py:55-60):
// every operand, weight and the output are bf16. x is summed in fp32 on the
// widened inputs, gelu(x) and gelu(m) are computed in fp32 and rounded to
// bf16 only as product operands, each product sums exact bf16 x bf16
// products in fp32, the masked K-sum / 30 runs in fp32, and the output is
// rounded once.
//
// What bounds it on the card: operations. Per edge the W2 product and, with
// contract_e, e_in@Wb (2 H^2 multiply-adds' worth each, 33 kFLOP at
// H = 128), against 1 KB per edge of e_in and G (fp32, outside the tensor
// cores in this first version). Design: message_table.cu's, with the table
// row replaced by row e of G: one block of 256 threads per tile of tn = 64/K
// nodes (64 edge rows); the tile's activations stay in shared memory
// ([64, H], 32 KB at H = 128) through all three products; the weights stream
// through shared memory in chunks of 32 rows; each thread owns 8 rows x H/32
// columns of every product in registers. h_V@Wa is computed once per node
// and added to its K rows; with aggregate the K edges of a node are summed in
// the block in fp32 and the node's row is written once (no atomics).
#include "message_common.cuh"

namespace {

template <typename T>
struct Params {
  const T* h_V;
  const T* e_in;
  const T* G;
  const T* m_att;
  const T* wa;
  const T* wb;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* w3;
  const T* b3;
  T* out;
  int N, K, tn, contract_e, aggregate;  // tn: nodes per tile
};

template <int H, typename T>
__global__ void __launch_bounds__(kThreads) message_mlp_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;               // [kRows][H] activations
  float* Ws = Xs + kRows * H;     // [kKC][H] weight chunk
  float* AI = Ws + kKC * H;       // [tn][H] h_V @ Wa of the tile's nodes
  float* HV = AI + p.tn * H;      // [tn][H] h_V of the tile's nodes
  constexpr int CPT = H / 32;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * p.tn;
  const int nodes = min(p.tn, p.N - n0);
  const int rows = nodes * p.K;
  const size_t e0 = (size_t)n0 * p.K;

  for (int idx = tid; idx < p.tn * H; idx += kThreads)
    HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)n0 * H + idx]) : 0.f;
  if (p.contract_e)
    for (int idx = tid; idx < kRows * H; idx += kThreads)
      Xs[idx] = idx < rows * H ? to_f(p.e_in[e0 * H + idx]) : 0.f;
  __syncthreads();
  for (int idx = tid; idx < p.tn * H; idx += kThreads) {
    const int t = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(HV[t * H + k], ldf(p.wa + k * H + h), s);
    AI[idx] = s;
  }

  float acc[8][CPT];
  if (p.contract_e) {
    gemm<H>(Xs, p.wb, Ws, acc);  // e_in @ Wb (its first barrier publishes AI)
  } else {
    __syncthreads();  // publishes AI
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) Xs[r * H + tx * CPT + c] = 0.f;
      continue;
    }
    const size_t e = e0 + r;
    const int t = r / p.K;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      const float edge = p.contract_e ? acc[i][c] : to_f(p.e_in[e * H + h]);
      const float x = AI[t * H + h] + to_f(p.G[e * H + h]) + to_f(p.b1[h]) + edge;
      Xs[r * H + h] = rnd<T>(gelu(x));
    }
  }
  __syncthreads();
  gemm<H>(Xs, p.w2, Ws, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      Xs[r * H + h] = rnd<T>(gelu(acc[i][c] + to_f(p.b2[h])));
    }
  }
  __syncthreads();
  gemm<H>(Xs, p.w3, Ws, acc);

  if (!p.aggregate) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        p.out[(e0 + r) * H + h] = from_f<T>(acc[i][c] + to_f(p.b3[h]));
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const float w = r >= rows ? 0.f : to_f(p.m_att[e0 + r]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      Xs[r * H + h] = (acc[i][c] + to_f(p.b3[h])) * w;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nodes * H; idx += kThreads) {
    const int t = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < p.K; ++k) s += Xs[(t * p.K + k) * H + h];
    p.out[(size_t)(n0 + t) * H + h] = from_f<T>(s / 30.0f);
  }
}

template <int H, typename T>
int launch(const Params<T>& p, cudaStream_t stream) {
  const size_t smem = (size_t)(kRows + kKC + 2 * p.tn) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      message_mlp_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.N + p.tn - 1) / p.tn;
  message_mlp_kernel<H, T><<<blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const T* h_V, const T* e_in, const T* G, const T* m_att,
            const T* wa, const T* wb, const T* b1, const T* w2, const T* b2,
            const T* w3, const T* b3, T* out, int N, int K, int H,
            int contract_e, int aggregate, cudaStream_t stream) {
  if (K < 1 || K > kRows || N < 1) return (int)cudaErrorInvalidValue;
  Params<T> p{h_V, e_in, G,   m_att, wa,         wb,        b1,
              w2,  b2,   w3,  b3,    out,        N,         K,
              kRows / K, contract_e, aggregate};
  switch (H) {
    case 32: return launch<32>(p, stream);
    case 64: return launch<64>(p, stream);
    case 128: return launch<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out is [N, H] with aggregate, else [N*K, H]; wb is read only with
// contract_e and m_att only with aggregate.
extern "C" int message_mlp_forward(
    const float* h_V, const float* e_in, const float* G, const float* m_att,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out, int N,
    int K, int H, int contract_e, int aggregate, cudaStream_t stream) {
  return forward<float>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, b3, out,
                        N, K, H, contract_e, aggregate, stream);
}

// The same with every operand and the output bf16.
extern "C" int message_mlp_forward_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* G, const bf16* m_att,
    const bf16* wa, const bf16* wb, const bf16* b1, const bf16* w2,
    const bf16* b2, const bf16* w3, const bf16* b3, bf16* out, int N, int K,
    int H, int contract_e, int aggregate, cudaStream_t stream) {
  return forward<bf16>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, b3, out,
                       N, K, H, contract_e, aggregate, stream);
}
