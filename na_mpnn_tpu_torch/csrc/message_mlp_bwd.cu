// Backward of the message MLP on a pre-gathered neighbour operand
// (message_mlp.cu), for Hopper (sm_90a); fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_bwd_call (_bwd_kernel, message_kernels.py:103). Like the TPU
// kernel it recomputes the activations from the inputs (nothing was saved by
// the forward). Per edge row e (node n):
//   x = h_V[n]@Wa + G[e] + b1 + (contract_e ? e_in[e]@Wb : e_in[e])
//   u1 = gelu(x), y = u1@W2 + b2, u2 = gelu(y)
//   g_m = aggregate ? g[n]*mask_att[e]/30 : g[e]
//   dW3 += u2^T g_m, db3 += g_m, g_y = (g_m@W3^T) * gelu'(y)
//   dW2 += u1^T g_y, db2 += g_y, g_x = (g_y@W2^T) * gelu'(x), db1 += g_x
//   g_G[e] = g_x; g_ein[e] = contract_e ? g_x@Wb^T : g_x;
//   dWb += e_in^T g_x (contract_e; else dWb = 0)
//   s[n] = sum_k g_x, g_hV = s@Wa^T, dWa += h_V^T s
// with the exact GELU derivative Phi(x) + x*phi(x) (the TPU kernel uses the
// Abramowitz-Stegun erf).
//
// bf16 (message_mlp_backward_bf16; the TPU kernel's bf16 branch,
// message_kernels.py:104-160): the inputs, weights and cotangent are bf16 and
// g_hV, g_ein, g_G are written bf16. x, u1, y are recomputed as the bf16
// forward does; g_m is fp32 (with aggregate, g times bf16(mask_att / 30), as
// JAX divides the bf16 mask); every product operand is rounded to bf16
// (u2, g_m, g_y, u1, g_x, s; e_in, h_V and the weights are bf16 already)
// and summed in fp32, while gelu' works on the unrounded fp32 x and y and
// the bias sums and sum_k g_x start from unrounded fp32 values. The weight
// gradients stay fp32 here, in the same fixed order, and the caller rounds
// them once (ops/message_kernels.py), as the JAX VJP casts them to the
// weights' type.
//
// Reductions across blocks, which run in no order: every per-edge and
// per-node output is written once by the block that owns its tile, and the
// weight and bias gradients go through a persistent grid of P blocks (P = the
// SM count, at most the tile count), each summing its tiles' contributions
// into a slot of its own in `part` (P x (4H^2 + 3H) floats), and a second
// kernel that adds the P slots in a fixed order. No atomics anywhere: two
// launches on the same inputs agree bitwise.
//
// What bounds it on the card: operations. Per edge the recomputed W2 product,
// dW2 and g_x (6 H^2 multiply-adds' worth), with contract_e also e_in@Wb,
// g_ein and dWb (12 H^2), against about 2 KB of e_in, G and the two edge
// gradients (fp32, outside the tensor cores in this first version). Design:
// message_table_bwd.cu's tile of 64 edge rows and 256 threads, with the
// forward's first product in front: the tile's x, gelu(x), gelu(y),
// gelu'(y) and g_m stay in shared memory (5 x 32 KB at H = 128) through the
// products; weights taken as W^T come from a copy transposed once per launch.
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
  const T* g;
  T* g_hV;
  T* g_ein;
  T* g_G;
  float* part;
  float* wT;  // [4][H][H]: Wa^T, Wb^T, W2^T, W3^T (written per launch)
  int N, K, tn, tiles, contract_e, aggregate;  // tn: nodes per tile
};

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Four consecutive fp32 values stored as T (16-byte aligned for fp32, 8-byte
// for bf16).
__device__ __forceinline__ void st4(float* p, float4 v, float) { st4(p, v); }
__device__ __forceinline__ void st4(bf16* p, float4 v, bf16) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// slot[i][j] (+)= sum_{r < rows} A[r][i] * B[r][j]; A, B are [rows, H] in
// shared memory. Thread (ti, tj) owns rows i = ti + 16a and the float4
// column groups j = 4tj + 64b (a < H/16, b < H/64; at H = 32 half of the
// threads own no columns): B and the slot move as float4.
template <int H>
__device__ __forceinline__ void outer_acc(const float* A, const float* B,
                                          int rows, float* slot, bool first) {
  constexpr int SA = H / 16, SB = H >= 64 ? H / 64 : 1;
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  if (4 * tj >= H) return;
  float4 acc[SA][SB];
#pragma unroll
  for (int a = 0; a < SA; ++a)
#pragma unroll
    for (int b = 0; b < SB; ++b) acc[a][b] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < rows; ++r) {
    float av[SA];
    float4 bv[SB];
#pragma unroll
    for (int a = 0; a < SA; ++a) av[a] = A[r * H + ti + 16 * a];
#pragma unroll
    for (int b = 0; b < SB; ++b)
      bv[b] = *reinterpret_cast<const float4*>(B + r * H + 4 * tj + 64 * b);
#pragma unroll
    for (int a = 0; a < SA; ++a)
#pragma unroll
      for (int b = 0; b < SB; ++b) {
        acc[a][b].x = fmaf(av[a], bv[b].x, acc[a][b].x);
        acc[a][b].y = fmaf(av[a], bv[b].y, acc[a][b].y);
        acc[a][b].z = fmaf(av[a], bv[b].z, acc[a][b].z);
        acc[a][b].w = fmaf(av[a], bv[b].w, acc[a][b].w);
      }
  }
#pragma unroll
  for (int a = 0; a < SA; ++a)
#pragma unroll
    for (int b = 0; b < SB; ++b) {
      float4* o = reinterpret_cast<float4*>(slot + (ti + 16 * a) * H + 4 * tj + 64 * b);
      if (first) {
        *o = acc[a][b];
      } else {
        float4 v = *o;
        v.x += acc[a][b].x;
        v.y += acc[a][b].y;
        v.z += acc[a][b].z;
        v.w += acc[a][b].w;
        *o = v;
      }
    }
}

// slot[j] (+)= sum_{r < kRows} A[r][j]
template <int H>
__device__ __forceinline__ void col_sum(const float* A, float* slot,
                                        bool first) {
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += A[r * H + j];
    slot[j] = first ? s : slot[j] + s;
  }
}

// The bf16 trunk: a tile buffer A [kRows][H] rounded to bf16 in place,
// between barriers (after the fp32 sums that read it unrounded, before the
// products that take it as an operand). Nothing for fp32.
template <int H, typename T>
__device__ __forceinline__ void round_operand(float* A) {
  if constexpr (sizeof(T) == 2) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * H; idx += kThreads)
      A[idx] = rnd<T>(A[idx]);
    __syncthreads();
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(kThreads)
message_mlp_bwd_kernel(Params<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* XS = smem;             // x, then g_x
  float* U1 = XS + kRows * H;   // e_in, then gelu(x), then e_in
  float* U2 = U1 + kRows * H;   // gelu(y), then g_y
  float* GM = U2 + kRows * H;   // g_m
  float* DY = GM + kRows * H;   // gelu'(y)
  float* Ws = DY + kRows * H;   // [kKC][H] weight chunk
  float* HV = Ws + kKC * H;     // [tn][H] h_V of the tile's nodes
  float* AI = HV + p.tn * H;    // [tn][H] h_V @ Wa, then sum_k g_x
  constexpr int CPT = H / 32;
  constexpr int kV = kRows * H / (4 * kThreads);  // float4s per thread per tile
  constexpr size_t kSlot = 4 * H * H + 3 * H;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  float* slot = p.part + blockIdx.x * kSlot;
  float* s_dwa = slot;
  float* s_dwb = slot + H * H;
  float* s_dw2 = slot + 2 * H * H;
  float* s_dw3 = slot + 3 * H * H;
  float* s_db1 = slot + 4 * H * H;
  float* s_db2 = s_db1 + H;
  float* s_db3 = s_db2 + H;
  const float* waT = p.wT;
  const float* wbT = p.wT + H * H;
  const float* w2T = p.wT + 2 * H * H;
  const float* w3T = p.wT + 3 * H * H;
  bool first = true;
  float acc[8][CPT];

  if (!p.contract_e)
    for (int idx = tid; idx < H * H; idx += kThreads) s_dwb[idx] = 0.f;

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int n0 = tile * p.tn;
    const int nodes = min(p.tn, p.N - n0);
    const int rows = nodes * p.K;
    const size_t e0 = (size_t)n0 * p.K;

    // h_V, e_in (contract_e) and the message cotangent g_m of the tile's
    // rows (zero on rows past the last node, so they add nothing below).
    for (int idx = tid; idx < p.tn * H; idx += kThreads)
      HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)n0 * H + idx]) : 0.f;
    {
      float4 ev[kV], gv[kV];
      float wv[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads), r = idx / H, h = idx % H;
        ev[v] = gv[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        wv[v] = 1.f / 30.0f;
        if (r < rows) {
          if (p.contract_e) ev[v] = ld4(p.e_in + e0 * H + idx);
          if (p.aggregate) {
            gv[v] = ld4(p.g + (size_t)(n0 + r / p.K) * H + h);
            wv[v] = rnd<T>(to_f(p.m_att[e0 + r]) / 30.0f);
          } else {
            gv[v] = ld4(p.g + e0 * H + idx);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads);
        if (p.contract_e) st4(U1 + idx, ev[v]);
        float4 gm = gv[v];
        if (p.aggregate) {
          const float w = wv[v];
          gm.x *= w; gm.y *= w; gm.z *= w; gm.w *= w;
        }
        st4(GM + idx, gm);
      }
    }
    __syncthreads();
    for (int idx = tid; idx < p.tn * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      for (int k = 0; k < H; ++k) s = fmaf(HV[t * H + k], ldf(p.wa + k * H + h), s);
      AI[idx] = s;
    }

    // x (recomputed as the forward does), gelu(x)
    if (p.contract_e) {
      gemm<H>(U1, p.wb, Ws, acc);  // e_in @ Wb (its first barrier publishes AI)
    } else {
      __syncthreads();  // publishes AI
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        float x = 0.f;
        if (r < rows) {
          const size_t e = e0 + r;
          const float edge = p.contract_e ? acc[i][c] : to_f(p.e_in[e * H + h]);
          x = AI[(r / p.K) * H + h] + to_f(p.G[e * H + h]) + to_f(p.b1[h]) + edge;
        }
        XS[r * H + h] = x;
        U1[r * H + h] = rnd<T>(gelu(x));
      }
    }

    // y = u1@W2 + b2 (its first barrier publishes x and gelu(x))
    gemm<H>(U1, p.w2, Ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        const float y = acc[i][c] + to_f(p.b2[h]);
        U2[r * H + h] = rnd<T>(gelu(y));
        DY[r * H + h] = gelu_grad(y);
      }
    }
    __syncthreads();
    col_sum<H>(GM, s_db3, first);
    round_operand<H, T>(GM);
    outer_acc<H>(U2, GM, kRows, s_dw3, first);

    // g_y = (g_m@W3^T) * gelu'(y) over u2 (read above, before the first
    // barrier inside gemm)
    gemm<H>(GM, w3T, Ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        U2[r * H + h] = acc[i][c] * DY[r * H + h];
      }
    }
    __syncthreads();
    col_sum<H>(U2, s_db2, first);
    round_operand<H, T>(U2);
    outer_acc<H>(U1, U2, kRows, s_dw2, first);

    // g_x = (g_y@W2^T) * gelu'(x), over x in place
    gemm<H>(U2, w2T, Ws, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int h = tx * CPT + c;
        XS[r * H + h] = acc[i][c] * gelu_grad(XS[r * H + h]);
      }
    }
    __syncthreads();
    col_sum<H>(XS, s_db1, first);
    // g_G (and g_ein without contract_e), each row written once
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int idx = 4 * (tid + v * kThreads), r = idx / H;
      if (r >= rows) continue;
      const float4 gx = *reinterpret_cast<const float4*>(XS + idx);
      st4(p.g_G + e0 * H + idx, gx, T());
      if (!p.contract_e) st4(p.g_ein + e0 * H + idx, gx, T());
    }
    // AI <- s = sum_k g_x per node (a product operand only)
    for (int idx = tid; idx < p.tn * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      if (t < nodes)
        for (int k = 0; k < p.K; ++k) s += XS[(t * p.K + k) * H + h];
      AI[idx] = rnd<T>(s);
    }
    if (p.contract_e) {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads), r = idx / H;
        st4(U1 + idx, r < rows ? ld4(p.e_in + e0 * H + idx)
                               : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
    __syncthreads();
    if (p.contract_e) round_operand<H, T>(XS);  // g_x as dWb's and g_ein's operand
    if (p.contract_e) outer_acc<H>(U1, XS, kRows, s_dwb, first);
    outer_acc<H>(HV, AI, nodes, s_dwa, first);
    for (int idx = tid; idx < nodes * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      for (int k = 0; k < H; ++k) s = fmaf(AI[t * H + k], __ldg(waT + k * H + h), s);
      p.g_hV[(size_t)(n0 + t) * H + h] = from_f<T>(s);
    }
    if (p.contract_e) {
      gemm<H>(XS, wbT, Ws, acc);  // g_ein = g_x@Wb^T
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ty + 8 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          p.g_ein[(e0 + r) * H + tx * CPT + c] = from_f<T>(acc[i][c]);
      }
    }
    first = false;
    __syncthreads();  // the next tile may overwrite shared memory
  }
}

// wT[m] = W_m^T (fp32) for W_0..3 = Wa, Wb, W2, W3 ([H, H] each), so that
// every product with a transposed weight streams it row by row.
template <typename T>
__global__ void transpose_weights(const T* __restrict__ wa,
                                  const T* __restrict__ wb,
                                  const T* __restrict__ w2,
                                  const T* __restrict__ w3, int H,
                                  float* __restrict__ wT) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 4 * H * H) return;
  const int m = idx / (H * H), c = (idx / H) % H, k = idx % H;
  const T* W = m == 0 ? wa : m == 1 ? wb : m == 2 ? w2 : w3;
  wT[idx] = to_f(W[k * H + c]);
}

// out[j] = sum_b part[b][j], b in order (deterministic).
__global__ void reduce_slots(const float* __restrict__ part, int nparts,
                             int n, float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < nparts; ++b) s += part[(size_t)b * n + j];
  out[j] = s;
}

template <int H, typename T>
int launch(const Params<T>& p, int nparts, float* wgrad, cudaStream_t stream) {
  transpose_weights<T><<<(4 * H * H + 255) / 256, 256, 0, stream>>>(
      p.wa, p.wb, p.w2, p.w3, H, p.wT);
  const size_t smem = (size_t)(5 * kRows + kKC + 2 * p.tn) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      message_mlp_bwd_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  message_mlp_bwd_kernel<H, T><<<nparts, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 4 * H * H + 3 * H;
  reduce_slots<<<(n + 255) / 256, 256, 0, stream>>>(p.part, nparts, n, wgrad);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const T* h_V, const T* e_in, const T* G, const T* m_att,
             const T* wa, const T* wb, const T* b1, const T* w2, const T* b2,
             const T* w3, const T* g, T* g_hV, T* g_ein, T* g_G, float* part,
             float* wT, float* wgrad, int N, int K, int H, int contract_e,
             int aggregate, int nparts, cudaStream_t stream) {
  if (K < 1 || K > kRows || N < 1 || nparts < 1)
    return (int)cudaErrorInvalidValue;
  const int tn = kRows / K;
  const int tiles = (N + tn - 1) / tn;
  if (nparts > tiles) nparts = tiles;
  Params<T> p{h_V,  e_in,  G,    m_att, wa,  wb,   b1, w2, b2,
              w3,   g,     g_hV, g_ein, g_G, part, wT, N,  K,
              tn,   tiles, contract_e, aggregate};
  switch (H) {
    case 32: return launch<32>(p, nparts, wgrad, stream);
    case 64: return launch<64>(p, nparts, wgrad, stream);
    case 128: return launch<128>(p, nparts, wgrad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// wgrad [4H^2 + 3H] = [dWa | dWb | dW2 | dW3 | db1 | db2 | db3]; scratch
// part [nparts, 4H^2 + 3H] and wT [4H^2]. g is [N, H] with aggregate, else
// [N*K, H]; g_hV [N, H], g_ein and g_G [N*K, H].
extern "C" int message_mlp_backward(
    const float* h_V, const float* e_in, const float* G, const float* m_att,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* g, float* g_hV,
    float* g_ein, float* g_G, float* part, float* wT, float* wgrad, int N,
    int K, int H, int contract_e, int aggregate, int nparts,
    cudaStream_t stream) {
  return backward<float>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, g, g_hV,
                         g_ein, g_G, part, wT, wgrad, N, K, H, contract_e,
                         aggregate, nparts, stream);
}

// The same with bf16 inputs, weights, cotangent, g_hV, g_ein and g_G;
// wgrad and the scratch stay fp32.
extern "C" int message_mlp_backward_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* G, const bf16* m_att,
    const bf16* wa, const bf16* wb, const bf16* b1, const bf16* w2,
    const bf16* b2, const bf16* w3, const bf16* g, bf16* g_hV, bf16* g_ein,
    bf16* g_G, float* part, float* wT, float* wgrad, int N, int K, int H,
    int contract_e, int aggregate, int nparts, cudaStream_t stream) {
  return backward<bf16>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, g, g_hV,
                        g_ein, g_G, part, wT, wgrad, N, K, H, contract_e,
                        aggregate, nparts, stream);
}
