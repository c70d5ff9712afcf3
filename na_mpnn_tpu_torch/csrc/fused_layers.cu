// Fused inference layer updates for Hopper (sm_90a): the whole node update
// of an encoder or parallel-decoder layer, and the encoder's edge update,
// each in one launch; fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernels na_mpnn_tpu/ops/fused_layers.py::
// fused_node_update (:152, _node_update_kernel) and fused_edge_update (:187,
// _edge_update_kernel). The TPU kernels read a pre-gathered neighbour operand
// G [N*K, H] that XLA builds before every call; these read the node table by
// global row (n / L) * Lk + eidx[e] inside the kernel, as message_table.cu
// does, so they take any L and the graph-parallel route's all-gathered
// table (Lk key rows against a shard's L query rows).
//
// Per edge row e = (node n, slot k), with t = table row of eidx[e]:
//   enc: x = h_V[n]@Wa + e_in[e]@Wb + table[t] + b1                (C = H)
//   dec: x = h_V[n]@Wa + m1d[e]*(e_in[e]@Wb) + mbw[e]*A[t] + m1d[e]*B[t] + b1
//        with table = [A | B]                                        (C = 2H)
//   m = W3 . gelu(W2 . gelu(x) + b2) + b3                (exact erf GELU)
// node update (enc, dec):
//   dh = sum_k w_e * m / 30   (w = mask_att in enc, 1 in dec)
//   h = LN1(h_V + dh); h = LN2(h + W_out . gelu(W_in . h + b_in) + b_out)
//   out[n] = mask[n] * h                                      -> [N, H]
// edge update (enc): out[e] = LN3(e_in[e] + m)               -> [N*K, H]
// LayerNorm: eps 1e-5, biased variance, statistics in fp32, two passes over
// the row held in registers.
//
// bf16 (fused_node_update_bf16, fused_edge_update_bf16; the TPU kernels'
// bf16 branch, fused_layers.py:47-59, :80-117): operands, parameters and
// outputs bf16; every product on bf16-rounded operands (gelu(x), gelu(y),
// LN1's output as the FFN input, the FFN hidden) summed in fp32; the message
// sum, both LayerNorms with their statistics and residuals in fp32; the
// output rounded once.
//
// What bounds it on the card: operations. The message MLP is three H x H
// products per edge (98 kFLOP at H = 128) against about 1 KB per edge moved;
// the feed-forward block adds 16 H^2 per node (the K edges of a node cost
// 6 K H^2, so the block is 8% of the node update at K = 32). fp32, outside
// the tensor cores, in this first version.
//
// Design. The message part is message_table.cu's: 256 threads, 64 edge rows
// (a chunk of 64 / K nodes) whose activations stay in shared memory through
// the three products, weights streamed in chunks of 32 rows, each warp
// owning 8 whole rows. The edge update's LayerNorm is then a warp-shuffle
// reduction in the epilogue, on the rows the warp already holds. The node
// update needs the K-reduced dh of whole nodes before LN1, so a block owns
// TN nodes, runs the message part over them in chunks of 64 edge rows,
// keeps dh [TN, H] and the FFN hidden [TN, 4H] in shared memory, and reads
// W_in and W_out (2 x 4H x H) once per block from L2. A larger TN divides
// that weight traffic by TN but leaves fewer blocks; on the H100 the weight
// traffic (L2-resident) is not what bounds the time, filling the SMs is. So
// TN is 2 or 4: the wrapper takes 4 where that still gives every SM a
// block, else 2 (ops/fused_layers.py::node_tile).
#include "message_common.cuh"

namespace {

constexpr float kLnEps = 1e-5f;

template <typename T>
struct Msg {
  const T* h_V;
  const T* e_in;
  const T* table;
  const long long* eidx;
  const T* m_att;
  const T* mbw;
  const T* wa;
  const T* wb;
  const T* b1;
  const T* w2;
  const T* b2;
  const T* w3;
  const T* b3;
  int N, K, L, Lk;
};

template <typename T>
struct Tail {
  const T* mask;
  const T* n1s;
  const T* n1b;
  const T* w_in;
  const T* b_in;
  const T* w_out;
  const T* b_out;
  const T* n2s;
  const T* n2b;
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Mean and 1/sqrt(var + eps) of a row of 32 * CPT values spread over the
// warp's lanes (CPT each); every lane of the warp must call it.
template <int CPT>
__device__ __forceinline__ void ln_stats(const float (&v)[CPT], float& mean,
                                         float& rstd) {
  constexpr float inv = 1.0f / (32 * CPT);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) s += v[c];
  mean = warp_sum(s) * inv;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float d = v[c] - mean;
    q = fmaf(d, d, q);
  }
  rstd = rsqrtf(warp_sum(q) * inv + kLnEps);
}

// h_V @ Wa for n nodes: AI[t][h] from HV[t][:] (shared memory).
template <int H, typename T>
__device__ __forceinline__ void node_products(const float* HV,
                                              const T* __restrict__ wa,
                                              float* AI, int n) {
  for (int idx = threadIdx.x; idx < n * H; idx += kThreads) {
    const int t = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(HV[t * H + k], ldf(wa + k * H + h), s);
    AI[idx] = s;
  }
}

// The message MLP of one chunk: `rows` edge rows of the nodes n0, n0 + 1, ...
// (rows / K of them). On entry Xs holds their e_in rows (zero past `rows`)
// and AI the nodes' h_V @ Wa; both are published by the first barrier of
// the first product. On return acc holds m - b3 of rows ty + 8i (columns
// tx * CPT + c), and Xs has been reused for the activations.
template <int H, typename T>
__device__ __forceinline__ void message_chunk(const Msg<T>& p, int mode, int n0,
                                              int rows, const float* AI,
                                              float* Xs, float* Ws,
                                              float (&acc)[8][H / 32]) {
  constexpr int CPT = H / 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t e0 = (size_t)n0 * p.K;
  gemm<H>(Xs, p.wb, Ws, acc);  // e_in @ Wb
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
    const size_t grow = (size_t)((n0 + t) / p.L) * p.Lk + p.eidx[e];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      float x;
      if (mode == kDec) {
        const float m1 = to_f(p.m_att[e]), mb = to_f(p.mbw[e]);
        const T* tr = p.table + grow * 2 * H;
        x = AI[t * H + h] + m1 * acc[i][c] + mb * to_f(tr[h]) + m1 * to_f(tr[H + h]) +
            to_f(p.b1[h]);
      } else {
        x = AI[t * H + h] + acc[i][c] + to_f(p.table[grow * H + h]) + to_f(p.b1[h]);
      }
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
}

template <int H, int TN, typename T>
__global__ void __launch_bounds__(kThreads)
node_update_kernel(Msg<T> p, Tail<T> q, T* __restrict__ out, int mode, int Tc) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CPT = H / 32;
  constexpr int H4 = 4 * H;
  float* Xs = smem;             // [kRows][H] a chunk's activations
  float* Ws = Xs + kRows * H;   // [kKC][H] weight chunk
  float* HV = Ws + kKC * H;     // [TN][H] h_V of the block's nodes
  float* AI = HV + TN * H;      // [TN][H] h_V @ Wa, later the FFN output
  float* DH = AI + TN * H;      // [TN][H] sum_k m / 30, later LN1's output
  float* F = DH + TN * H;       // [TN][4H] FFN hidden
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int nb = blockIdx.x * TN;
  const int nodes = min(TN, p.N - nb);

  for (int idx = tid; idx < TN * H; idx += kThreads) {
    HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)nb * H + idx]) : 0.f;
    DH[idx] = 0.f;
  }
  __syncthreads();
  node_products<H>(HV, p.wa, AI, TN);

  float acc[8][CPT];
  for (int c0 = 0; c0 < nodes; c0 += Tc) {
    const int cn = min(Tc, nodes - c0), rows = cn * p.K;
    const size_t e0 = (size_t)(nb + c0) * p.K;
    for (int idx = tid; idx < kRows * H; idx += kThreads)
      Xs[idx] = idx < rows * H ? to_f(p.e_in[e0 * H + idx]) : 0.f;
    message_chunk<H>(p, mode, nb + c0, rows, AI + c0 * H, Xs, Ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      const float w = r >= rows ? 0.f : (mode == kEncNode ? to_f(p.m_att[e0 + r]) : 1.f);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        Xs[r * H + h] = (acc[i][c] + to_f(p.b3[h])) * w;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < cn * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      for (int k = 0; k < p.K; ++k) s += Xs[(t * p.K + k) * H + h];
      DH[(c0 + t) * H + h] = s / 30.0f;
    }
    __syncthreads();
  }

  // LN1 of h_V + dh: one warp per node, lane owns columns tx + 32c.
  for (int t = ty; t < nodes; t += kThreads / 32) {
    float v[CPT], mean, rstd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = HV[t * H + tx + 32 * c] + DH[t * H + tx + 32 * c];
    ln_stats<CPT>(v, mean, rstd);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx + 32 * c;
      DH[t * H + h] = (v[c] - mean) * rstd * to_f(q.n1s[h]) + to_f(q.n1b[h]);
    }
  }
  __syncthreads();

  // FFN hidden F = gelu(h @ W_in + b_in): thread owns columns tid + 256 j,
  // every node of the block; W_in is read once per block. h enters the
  // product rounded to the operand type, F leaves it so.
  {
    constexpr int CF = (H4 + kThreads - 1) / kThreads;
    float f[TN][CF];
#pragma unroll
    for (int t = 0; t < TN; ++t)
#pragma unroll
      for (int j = 0; j < CF; ++j) f[t][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      float w[CF];
#pragma unroll
      for (int j = 0; j < CF; ++j) {
        const int col = tid + j * kThreads;
        w[j] = col < H4 ? ldf(q.w_in + (size_t)k * H4 + col) : 0.f;
      }
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float a = rnd<T>(DH[t * H + k]);
#pragma unroll
        for (int j = 0; j < CF; ++j) f[t][j] = fmaf(a, w[j], f[t][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < CF; ++j) {
      const int col = tid + j * kThreads;
      if (col >= H4) continue;
      const float b = to_f(q.b_in[col]);
#pragma unroll
      for (int t = 0; t < TN; ++t) F[t * H4 + col] = rnd<T>(gelu(f[t][j] + b));
    }
  }
  __syncthreads();

  // FFN output F @ W_out + b_out into AI: thread owns column tid % H of the
  // nodes tid / H + G i; W_out is read once per block.
  {
    constexpr int G = kThreads / H, NPT = (TN + G - 1) / G;
    const int h = tid % H, g = tid / H;
    float o[NPT];
#pragma unroll
    for (int i = 0; i < NPT; ++i) o[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < H4; ++j) {
      const float w = ldf(q.w_out + (size_t)j * H + h);
#pragma unroll
      for (int i = 0; i < NPT; ++i) {
        const int t = g + G * i;
        if (t < TN) o[i] = fmaf(F[t * H4 + j], w, o[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < NPT; ++i) {
      const int t = g + G * i;
      if (t < TN) AI[t * H + h] = o[i] + to_f(q.b_out[h]);
    }
  }
  __syncthreads();

  // LN2 of the residual, then the node mask.
  for (int t = ty; t < nodes; t += kThreads / 32) {
    float v[CPT], mean, rstd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = DH[t * H + tx + 32 * c] + AI[t * H + tx + 32 * c];
    ln_stats<CPT>(v, mean, rstd);
    const float m = to_f(q.mask[nb + t]);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx + 32 * c;
      out[(size_t)(nb + t) * H + h] = from_f<T>(
          m * ((v[c] - mean) * rstd * to_f(q.n2s[h]) + to_f(q.n2b[h])));
    }
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
edge_update_kernel(Msg<T> p, const T* __restrict__ n3s,
                   const T* __restrict__ n3b, T* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CPT = H / 32;
  const int tn = kRows / p.K;
  float* Xs = smem;             // [kRows][H]
  float* Ws = Xs + kRows * H;   // [kKC][H]
  float* AI = Ws + kKC * H;     // [tn][H] h_V @ Wa
  float* HV = AI + tn * H;      // [tn][H] h_V
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * tn;
  const int nodes = min(tn, p.N - n0);
  const int rows = nodes * p.K;
  const size_t e0 = (size_t)n0 * p.K;

  for (int idx = tid; idx < tn * H; idx += kThreads)
    HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)n0 * H + idx]) : 0.f;
  for (int idx = tid; idx < kRows * H; idx += kThreads)
    Xs[idx] = idx < rows * H ? to_f(p.e_in[e0 * H + idx]) : 0.f;
  __syncthreads();
  node_products<H>(HV, p.wa, AI, tn);

  float acc[8][CPT];
  message_chunk<H>(p, kEncEdge, n0, rows, AI, Xs, Ws, acc);

  // LN3 of e_in + m on the rows this warp holds (the row test is uniform
  // across the warp, so every lane takes part in the shuffles).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= rows) continue;
    const size_t e = e0 + r;
    float v[CPT], mean, rstd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      v[c] = to_f(p.e_in[e * H + h]) + acc[i][c] + to_f(p.b3[h]);
    }
    ln_stats<CPT>(v, mean, rstd);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int h = tx * CPT + c;
      out[e * H + h] = from_f<T>((v[c] - mean) * rstd * to_f(n3s[h]) + to_f(n3b[h]));
    }
  }
}

template <int H, int TN, typename T>
int launch_node(const Msg<T>& p, const Tail<T>& q, T* out, int mode,
                cudaStream_t stream) {
  const int Tc = min(kRows / p.K, TN);
  const size_t smem = (size_t)(kRows + kKC + 7 * TN) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      node_update_kernel<H, TN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.N + TN - 1) / TN;
  node_update_kernel<H, TN, T><<<blocks, kThreads, smem, stream>>>(p, q, out, mode, Tc);
  return (int)cudaGetLastError();
}

template <int H, typename T>
int launch_node_tile(const Msg<T>& p, const Tail<T>& q, T* out, int mode,
                     int tile, cudaStream_t stream) {
  switch (tile) {
    case 2: return launch_node<H, 2>(p, q, out, mode, stream);
    case 4: return launch_node<H, 4>(p, q, out, mode, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H, typename T>
int launch_edge(const Msg<T>& p, const T* n3s, const T* n3b, T* out,
                cudaStream_t stream) {
  const int tn = kRows / p.K;
  const size_t smem = (size_t)(kRows + kKC + 2 * tn) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      edge_update_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.N + tn - 1) / tn;
  edge_update_kernel<H, T><<<blocks, kThreads, smem, stream>>>(p, n3s, n3b, out);
  return (int)cudaGetLastError();
}

template <typename T>
int node_update(int mode, const T* h_V, const T* e_in, const T* table,
                const long long* eidx, const T* m_att, const T* mbw,
                const T* mask, const T* wa, const T* wb, const T* b1,
                const T* w2, const T* b2, const T* w3, const T* b3,
                const T* n1s, const T* n1b, const T* w_in, const T* b_in,
                const T* w_out, const T* b_out, const T* n2s, const T* n2b,
                T* out, int N, int K, int L, int Lk, int H, int tile,
                cudaStream_t stream) {
  if (K < 1 || K > kRows || (mode != kEncNode && mode != kDec) || L < 1 ||
      Lk < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const Msg<T> p{h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1, w2, b2, w3,
                 b3, N, K, L, Lk};
  const Tail<T> q{mask, n1s, n1b, w_in, b_in, w_out, b_out, n2s, n2b};
  switch (H) {
    case 32: return launch_node_tile<32>(p, q, out, mode, tile, stream);
    case 64: return launch_node_tile<64>(p, q, out, mode, tile, stream);
    case 128: return launch_node_tile<128>(p, q, out, mode, tile, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int edge_update(const T* h_V, const T* e_in, const T* table,
                const long long* eidx, const T* wa, const T* wb, const T* b1,
                const T* w2, const T* b2, const T* w3, const T* b3,
                const T* n3s, const T* n3b, T* out, int N, int K, int L,
                int Lk, int H, cudaStream_t stream) {
  if (K < 1 || K > kRows || L < 1 || Lk < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const Msg<T> p{h_V, e_in, table, eidx, nullptr, nullptr, wa, wb, b1, w2, b2,
                 w3, b3, N, K, L, Lk};
  switch (H) {
    case 32: return launch_edge<32>(p, n3s, n3b, out, stream);
    case 64: return launch_edge<64>(p, n3s, n3b, out, stream);
    case 128: return launch_edge<128>(p, n3s, n3b, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: 0 = encoder node update (m_att masks the messages, mbw unread),
// 2 = decoder node update (m_att carries m1d). tile: nodes per block, 2 or 4.
extern "C" int fused_node_update(
    int mode, const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* mask, const float* wa, const float* wb, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* n1s, const float* n1b, const float* w_in, const float* b_in,
    const float* w_out, const float* b_out, const float* n2s, const float* n2b,
    float* out, int N, int K, int L, int Lk, int H, int tile,
    cudaStream_t stream) {
  return node_update<float>(mode, h_V, e_in, table, eidx, m_att, mbw, mask, wa,
                            wb, b1, w2, b2, w3, b3, n1s, n1b, w_in, b_in, w_out,
                            b_out, n2s, n2b, out, N, K, L, Lk, H, tile, stream);
}

// The same with every operand, parameter and the output bf16.
extern "C" int fused_node_update_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* m_att, const bf16* mbw,
    const bf16* mask, const bf16* wa, const bf16* wb, const bf16* b1,
    const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
    const bf16* n1s, const bf16* n1b, const bf16* w_in, const bf16* b_in,
    const bf16* w_out, const bf16* b_out, const bf16* n2s, const bf16* n2b,
    bf16* out, int N, int K, int L, int Lk, int H, int tile,
    cudaStream_t stream) {
  return node_update<bf16>(mode, h_V, e_in, table, eidx, m_att, mbw, mask, wa,
                           wb, b1, w2, b2, w3, b3, n1s, n1b, w_in, b_in, w_out,
                           b_out, n2s, n2b, out, N, K, L, Lk, H, tile, stream);
}

extern "C" int fused_edge_update(
    const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* wa, const float* wb, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* n3s, const float* n3b, float* out, int N, int K, int L,
    int Lk, int H, cudaStream_t stream) {
  return edge_update<float>(h_V, e_in, table, eidx, wa, wb, b1, w2, b2, w3, b3,
                            n3s, n3b, out, N, K, L, Lk, H, stream);
}

extern "C" int fused_edge_update_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* wa, const bf16* wb, const bf16* b1,
    const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
    const bf16* n3s, const bf16* n3b, bf16* out, int N, int K, int L,
    int Lk, int H, cudaStream_t stream) {
  return edge_update<bf16>(h_V, e_in, table, eidx, wa, wb, b1, w2, b2, w3, b3,
                           n3s, n3b, out, N, K, L, Lk, H, stream);
}
