// The message MLP's backward walk on the tensor cores: one copy, shared by
// the message-table backward (message_table_bwd.cu, KIND = kBwdTable) and
// the pre-gathered message MLP's backward (message_mlp_bwd.cu, KIND =
// kBwdGathered with contract_e, kBwdGatheredE without), which differ in two
// places, both fixed by the template constant KIND:
//   where a tile's pre-GELU x comes from: kBwdTable reads the x rows the
//     forward saved; the gathered kinds recompute them in the tile,
//       x = ((h_V[n]@Wa + G[e]) + b1) + (contract_e ? e_in[e]@Wb : e_in[e])
//     with h_V@Wa once per node and e_in@Wb on the tensor cores, the sum in
//     the saved x's place (coalesced rows, in fp32, never rounded: gelu'(x)
//     takes the unrounded x at bf16 too), kept for the tile's g_x in an
//     fp32 slot of its block (xs, L2-resident);
//   where an edge's g_x goes: kBwdTable writes the table contributions
//     (tcs) for the ordered table pass; the gathered kinds write g_G[e] =
//     g_x (each G row belongs to one edge) and kBwdGatheredE also g_ein[e] =
//     g_x, with no Wb product, no copy of Wb, and dWb = 0.
// Per edge row e (node n), with g_m the message cotangent:
//   u1 = gelu(x), y = u1@W2 + b2, u2 = gelu(y)
//   dW3 = sum u2^T g_m, db3 = sum g_m, g_y = (g_m@W3^T) * gelu'(y)
//   dW2 = sum u1^T g_y, db2 = sum g_y, g_x = (g_y@W2^T) * gelu'(x),
//   db1 = sum g_x, g_ein = g_e@Wb^T, dWb = sum e_in^T g_e,
//   s[n] = sum_k g_x, g_hV = s@Wa^T, dWa = sum h_V^T s
// with g_e = g_x (m1d*g_x in the table's dec mode) and
//   table modes: g_m = g[e] (enc-edge) | g[n]*mask_att[e]/30 (enc-node) |
//                g[n]/30 (dec), in fp32;
//   gathered:    g_m = g[e] (mode kEncEdge: no aggregate) |
//                g[n]*rnd_T(mask_att[e]/30) (kEncNode: aggregate), as JAX
//                divides the mask in its own type.
// The exact GELU derivative Phi(x) + x*phi(x) (the TPU kernels use the
// Abramowitz-Stegun erf).
//
// bf16: every product takes bf16-rounded operands (gelu(x), gelu(y), g_m,
// g_y, g_e, sum_k g_x) summed in fp32, while the bias sums, the K-sum and
// the per-edge gradients start from the unrounded fp32 values; the weight
// gradients stay fp32 and the caller rounds them once.
//
// The launches, no atomics, every output the same on every launch:
// A. the tile walk (backward_tiles): a persistent grid, one block of 512
//    threads per SM, walks tiles of 128 edge rows (tn = min(128 / K, 16)
//    whole nodes). The chained products y = u1@W2, g_y = g_m@W3^T,
//    g_x = g_y@W2^T, g_ein = g_e@Wb^T and g_hV = s@Wa^T (gathered: also
//    e_in@Wb and h_V@Wa) run on the tensor cores from operands in shared
//    memory; each of 16 warps owns 16 rows x H/2 columns. The bf16 weights
//    (W2^T, W3, W2, Wb: 136 KB at H = 128) stay in shared memory for the
//    block's life (e_in@Wb reads Wb as [k][n] through ldmatrix.trans); an
//    fp32 weight is copied in (68 KB) before each product; Wa is read from
//    global memory (L2) by the node products. The walk writes g_ein, g_hV,
//    the operands of the weight gradients (u1, g_m, u2, g_y, s; rounded at
//    bf16) and the per-edge gradients to global memory, and each tile's
//    bias sums (fp32, in a fixed order over its rows) to `bpart`.
// B. the weight gradients (wgrad_split): dWa = h_V^T s, dWb = e_in^T g_e,
//    dW2 = u1^T g_y and dW3 = u2^T g_m as split-K products over fixed row
//    ranges, partials to `wpart`; the rows stream through a cp.async ring
//    of chunks in shared memory.
// C. sum_weight_partials, sum_bias_partials: the weight partials over the
//    splits and the bias sums over the tiles, each in a fixed order.
#pragma once
#include "cp_async.cuh"
#include "message_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTileRows = 128;
constexpr int kTileThreads = 512;  // 16 warps: 8 row blocks x 2 column halves
constexpr int kMaxTileNodes = 16;
constexpr int kChunk = 64;         // rows per chunk of a weight-gradient block
constexpr int kGradThreads = 512;
constexpr int kBwdTable = 0, kBwdGathered = 1, kBwdGatheredE = 2;
// chunks in flight per weight-gradient block (shared memory: 104 KB at bf16,
// 139 KB at fp32, H = 128)
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }

template <typename T>
struct Params {
  const T* h_V;
  const T* e_in;
  const T* x;  // kBwdTable: the saved pre-GELU x [E, H]
  const long long* eidx;
  const T* m_att;
  const T* mbw;
  const T* wa;
  const T* wb;
  const T* w2;
  const T* b2;
  const T* w3;
  const T* g;
  T* g_hV;
  T* g_ein;
  T* u1s;      // [E, H] gelu(x)
  T* gms;      // [E, H] g_m (the summing modes; kEncEdge reads g)
  T* u2s;      // [E, H] gelu(y)
  T* gys;      // [E, H] g_y
  T* tcs;      // kBwdTable: [E, C] table contributions; g_e = the last H columns
  T* ss;       // [N, H] sum_k g_x
  float* bpart;  // [tiles, 3H] db1 | db2 | db3 of each tile
  int N, K, L, Lk, tn, tiles, C;
  // the gathered kinds
  const T* G;    // [E, H] the gathered neighbour term
  const T* b1;
  T* g_G;        // [E, H] = g_x; also dWb's operand g_e
  float* xs;     // [grid][kTileRows][H] each block's fp32 x of its tile
};

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  st2(p, v.x, v.y);
  st2(p + 2, v.z, v.w);
}

// An fp32 weight [H, H] copied row by row into shared memory for one
// product, with the row stride that keeps its B fragments free of bank
// conflicts: H + 8 when read as B[k][n] = W[k][n], H + 4 as W[n][k].
template <int H>
__device__ __forceinline__ void stage_weight(const float* __restrict__ W,
                                             bool nk, float* Ws) {
  const int ld = nk ? H + 4 : H + 8;
  if ((reinterpret_cast<size_t>(W) & 15) == 0) {
    for (int idx = 4 * threadIdx.x; idx < H * H; idx += 4 * kTileThreads)
      *reinterpret_cast<float4*>(Ws + (idx / H) * ld + idx % H) =
          __ldg(reinterpret_cast<const float4*>(W + idx));
  } else {  // a weight that is a view at any offset of a flat buffer
    for (int idx = threadIdx.x; idx < H * H; idx += kTileThreads)
      Ws[(idx / H) * ld + idx % H] = __ldg(W + idx);
  }
}

// g_hV rows of the tile: [16 nodes] x [8 columns at n0] = sS @ Wa^T, Wa
// ([H, H], B[k][n] = Wa[n][k]) read from global memory.
template <int H>
__device__ __forceinline__ void node_product(const bf16* S, const bf16* wa,
                                             int n0, float (&acc)[4]) {
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t a[4];
    frag_a_bf16(a, S, lda<bf16>(H), 0, k0);
    const bf16* b = wa + (n0 + g) * H + k0 + 2 * t;
    mma_bf16(acc, a, __ldg(reinterpret_cast<const unsigned*>(b)),
             __ldg(reinterpret_cast<const unsigned*>(b + 8)));
  }
}

template <int H>
__device__ __forceinline__ void node_product(const float* S, const float* wa,
                                             int n0, float (&acc)[4]) {
  constexpr int LA = lda<float>(H);
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int k0 = 0; k0 < H; k0 += 8) {
    const float* pa = S + g * LA + k0 + t;
    const float af[4] = {pa[0], pa[8 * LA], pa[4], pa[8 * LA + 4]};
    SplitA a;
    a.set(af);
    const float* b = wa + (n0 + g) * H + k0 + t;
    mma_3xtf32(acc, a, __ldg(b), __ldg(b + 4));
  }
}

// The node term of the gathered x: [16 nodes] x [8 columns at n0] =
// HV @ Wa, Wa ([H, H], B[k][n] = Wa[k][n]) read from global memory.
__device__ __forceinline__ uint32_t pack_pair(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

template <int H>
__device__ __forceinline__ void node_product_kn(const bf16* HV,
                                                const bf16* __restrict__ wa,
                                                int n0, float (&acc)[4]) {
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t a[4];
    frag_a_bf16(a, HV, lda<bf16>(H), 0, k0);
    const bf16* b = wa + (size_t)(k0 + 2 * t) * H + n0 + g;
    mma_bf16(acc, a, pack_pair(__ldg(b), __ldg(b + H)),
             pack_pair(__ldg(b + 8 * H), __ldg(b + 9 * H)));
  }
}

template <int H>
__device__ __forceinline__ void node_product_kn(const float* HV,
                                                const float* __restrict__ wa,
                                                int n0, float (&acc)[4]) {
  constexpr int LA = lda<float>(H);
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < H; k0 += 8) {
    const float* pa = HV + g * LA + k0 + t;
    const float af[4] = {pa[0], pa[8 * LA], pa[4], pa[8 * LA + 4]};
    SplitA a;
    a.set(af);
    const float* b = wa + (size_t)(k0 + t) * H + n0 + g;
    mma_3xtf32(acc, a, __ldg(b), __ldg(b + 4 * H));
  }
}

// out[c] = sum over the tile's rows of the fragment values v (each warp's
// 16 rows by shuffles, then the 8 row blocks in order through red [8][H]).
template <int H, int NT>
__device__ __forceinline__ void frag_colsum(const float (&v)[NT][4], float* red,
                                            float* out, int rb, int cb) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float s0 = v[j][0] + v[j][2], s1 = v[j][1] + v[j][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (g == 0) {
      red[rb * H + cb + 8 * j + 2 * t] = s0;
      red[rb * H + cb + 8 * j + 2 * t + 1] = s1;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += kTileThreads) {
    float s = 0.f;
    for (int r = 0; r < 8; ++r) s += red[r * H + c];
    out[c] = s;
  }
  __syncthreads();
}

// The walk of block blockIdx.x over tiles blockIdx.x, + gridDim.x, ...
template <int H, int KIND, typename T>
__device__ __forceinline__ void backward_tiles(const Params<T>& p, int mode) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr bool kMlp = KIND != kBwdTable;
  constexpr bool kWithWb = KIND != kBwdGatheredE;  // the Wb product and its weight
  constexpr int LA = lda<T>(H), LF = H + 4, NT = H / 16;
  constexpr int kV = kTileRows * H / (4 * kTileThreads);
  extern __shared__ __align__(16) unsigned char smem[];
  T* SA = reinterpret_cast<T*>(smem);        // u1, then g_y
  T* SB = SA + kTileRows * LA;               // g_m, then g_e
  float* F = reinterpret_cast<float*>(smem);  // g_x (fp32), over SA and SB
  constexpr size_t kR = 2 * kTileRows * LA * sizeof(T) > kTileRows * LF * 4
                            ? 2 * kTileRows * LA * sizeof(T)
                            : kTileRows * LF * 4;
  unsigned char* rest = smem + kR;
  // bf16: W2^T, W3, W2, Wb as [n][k] for the block's life; fp32: the
  // current product's weight (stage_weight)
  bf16* Ws = reinterpret_cast<bf16*>(rest);
  float* Wf = reinterpret_cast<float*>(rest);
  rest += kLow ? 4 * H * (H + 8) * sizeof(bf16) : H * (H + 8) * sizeof(float);
  float* red = reinterpret_cast<float*>(rest);            // [2048]
  T* sS = reinterpret_cast<T*>(red + 4 * kTileThreads);   // [16][LA]

  const int tid = threadIdx.x, warp = tid >> 5, g = lane_g(), t = lane_t();
  const int rb = warp & 7, cb = (warp >> 3) * (H / 2);
  const int C = p.C;
  if constexpr (kLow) {
    constexpr int LB = H + 8;
    for (int idx = tid; idx < H * H; idx += kTileThreads) {
      const int r = idx / H, c = idx % H;  // W[r][c], r the input side
      Ws[c * LB + r] = p.w2[idx];                  // W2^T as [n][k]
      Ws[H * LB + r * LB + c] = p.w3[idx];         // W3
      Ws[2 * H * LB + r * LB + c] = p.w2[idx];     // W2
      if (kWithWb) Ws[3 * H * LB + r * LB + c] = p.wb[idx];  // Wb
    }
  }
  float acc[NT][4], dy[NT][4];

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int n0 = tile * p.tn;
    const int nodes = min(p.tn, p.N - n0);
    const int rows = nodes * p.K;
    const size_t e0 = (size_t)n0 * p.K;
    float* bp = p.bpart + (size_t)tile * 3 * H;
    float* xsl = kMlp ? p.xs + (size_t)blockIdx.x * kTileRows * H : nullptr;

    // The gathered kinds' parts of x: h_V@Wa of the tile's nodes to AI
    // (over red, [16][H]) and e_in@Wb of its rows to F (over SA and SB).
    float* AI = red;
    if constexpr (kMlp) {
      for (int idx = tid; idx < kMaxTileNodes * H; idx += kTileThreads) {
        const int n = idx / H, h = idx % H;
        sS[n * LA + h] = n < nodes ? p.h_V[(size_t)(n0 + n) * H + h] : from_f<T>(0.f);
      }
      if constexpr (kWithWb) {
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int idx = 4 * (tid + v * kTileThreads), r = idx / H;
          st4(SA + r * LA + idx % H, r < rows ? ld4(p.e_in + e0 * H + idx)
                                              : make_float4(0.f, 0.f, 0.f, 0.f));
        }
        if constexpr (!kLow) stage_weight<H>(p.wb, false, Wf);
      }
      __syncthreads();
      if (warp < H / 8) {
        float nacc[4];
        node_product_kn<H>(sS, p.wa, 8 * warp, nacc);
        st2(AI + g * H + 8 * warp + 2 * t, nacc[0], nacc[1]);
        st2(AI + (g + 8) * H + 8 * warp + 2 * t, nacc[2], nacc[3]);
      }
      if constexpr (kWithWb) {
        if constexpr (kLow) product_kn<H, NT>(SA, Ws + 3 * H * (H + 8), rb, cb, acc);
        else product<H, NT>(SA, Wf, false, rb, cb, acc);
        __syncthreads();  // SA and Wf are free
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            st2(F + (16 * rb + g + 8 * hf) * LF + cb + 8 * j + 2 * t,
                acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
      __syncthreads();
    }

    // u1 = gelu(x) and g_m of the tile's rows (zero past the last node); x
    // is the saved x (table) or ((h_V@Wa + G) + b1) + (e_in@Wb or e_in),
    // kept fp32 in the block's slot (gathered); db3 from the unrounded g_m:
    // this thread's 4 columns over its rows.
    {
      float4 xv[kV], gv[kV];
      float wv[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kTileThreads), r = idx / H, h = idx % H;
        xv[v] = gv[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        wv[v] = 1.f;
        if (r < rows) {
          if constexpr (kMlp) {
            const float4 a = *reinterpret_cast<const float4*>(AI + (r / p.K) * H + h);
            const float4 gg = ld4(p.G + e0 * H + idx);
            float4 x = make_float4(a.x + gg.x, a.y + gg.y, a.z + gg.z, a.w + gg.w);
            x.x = x.x + ldf(p.b1 + h);
            x.y = x.y + ldf(p.b1 + h + 1);
            x.z = x.z + ldf(p.b1 + h + 2);
            x.w = x.w + ldf(p.b1 + h + 3);
            float4 ee;
            if constexpr (kWithWb) ee = *reinterpret_cast<const float4*>(F + r * LF + h);
            else ee = ld4(p.e_in + e0 * H + idx);
            x.x = x.x + ee.x; x.y = x.y + ee.y; x.z = x.z + ee.z; x.w = x.w + ee.w;
            xv[v] = x;
          } else {
            xv[v] = ld4(p.x + e0 * H + idx);
          }
          if (mode == kEncEdge) {
            gv[v] = ld4(p.g + e0 * H + idx);
          } else {
            gv[v] = ld4(p.g + (size_t)(n0 + r / p.K) * H + h);
            if constexpr (kMlp) wv[v] = rnd<T>(to_f(p.m_att[e0 + r]) / 30.0f);
            else if (mode == kEncNode) wv[v] = to_f(p.m_att[e0 + r]);
          }
        }
      }
      if constexpr (kMlp) __syncthreads();  // AI and F are read
      float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kTileThreads), r = idx / H, h = idx % H;
        float4 u = xv[v], gm = gv[v];
        if constexpr (kMlp) st4(xsl + idx, u);
        u.x = gelu(u.x); u.y = gelu(u.y); u.z = gelu(u.z); u.w = gelu(u.w);
        st4(SA + r * LA + h, u);
        if (r < rows) st4(p.u1s + e0 * H + idx, u);
        if (mode != kEncEdge) {
          const float w = wv[v];
          if constexpr (kMlp) {
            gm.x *= w; gm.y *= w; gm.z *= w; gm.w *= w;
          } else {
            gm.x = gm.x * w / 30.0f; gm.y = gm.y * w / 30.0f;
            gm.z = gm.z * w / 30.0f; gm.w = gm.w * w / 30.0f;
          }
          if (r < rows) st4(p.gms + e0 * H + idx, gm);
        }
        cs.x += gm.x; cs.y += gm.y; cs.z += gm.z; cs.w += gm.w;
        st4(SB + r * LA + h, gm);
      }
      st4(red + 4 * tid, cs);  // red[4 tid + c]: column (4 tid + c) % H
    }
    if constexpr (!kLow) stage_weight<H>(p.w2, false, Wf);
    __syncthreads();
    for (int c = tid; c < H; c += kTileThreads) {
      float s = 0.f;
      for (int q = 0; q < 4 * kTileThreads / H; ++q) s += red[q * H + c];
      bp[2 * H + c] = s;
    }

    // y = u1@W2 + b2: gelu'(y) stays in registers, gelu(y) goes to scratch.
    if constexpr (kLow) product<H, NT>(SA, Ws, rb, cb, acc);
    else product<H, NT>(SA, Wf, false, rb, cb, acc);
    __syncthreads();
    if constexpr (!kLow) {
      stage_weight<H>(p.w3, true, Wf);
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        const float y0 = acc[j][2 * hf] + ldf(p.b2 + c);
        const float y1 = acc[j][2 * hf + 1] + ldf(p.b2 + c + 1);
        const float c0 = gelu_cdf(y0), c1 = gelu_cdf(y1);
        dy[j][2 * hf] = gelu_grad(y0, c0);
        dy[j][2 * hf + 1] = gelu_grad(y1, c1);
        if (r < rows) st2(p.u2s + (e0 + r) * H + c, y0 * c0, y1 * c1);
      }

    // g_y = (g_m@W3^T) * gelu'(y); db2; g_y to SA and to scratch.
    if constexpr (kLow) product<H, NT>(SB, Ws + H * (H + 8), rb, cb, acc);
    else product<H, NT>(SB, Wf, true, rb, cb, acc);
    __syncthreads();
    if constexpr (!kLow) stage_weight<H>(p.w2, true, Wf);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= dy[j][i];
    frag_colsum<H, NT>(acc, red, bp + H, rb, cb);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        st2(SA + r * LA + c, acc[j][2 * hf], acc[j][2 * hf + 1]);
        if (r < rows) st2(p.gys + (e0 + r) * H + c, acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    __syncthreads();

    // g_x = (g_y@W2^T) * gelu'(x); db1; s = sum_k g_x through F.
    if constexpr (kLow) product<H, NT>(SA, Ws + 2 * H * (H + 8), rb, cb, acc);
    else product<H, NT>(SA, Wf, true, rb, cb, acc);
    __syncthreads();
    if constexpr (!kLow && kWithWb) stage_weight<H>(p.wb, true, Wf);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        float2 xx = make_float2(0.f, 0.f);
        if (r < rows) {
          if constexpr (kMlp) xx = ld2(xsl + r * H + c);
          else xx = ld2(p.x + (e0 + r) * H + c);
        }
        acc[j][2 * hf] *= gelu_grad(xx.x);
        acc[j][2 * hf + 1] *= gelu_grad(xx.y);
      }
    frag_colsum<H, NT>(acc, red, bp, rb, cb);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        st2(F + r * LF + c, acc[j][2 * hf], acc[j][2 * hf + 1]);
      }
    __syncthreads();
    for (int idx = tid; idx < kMaxTileNodes * H; idx += kTileThreads) {
      const int n = idx / H, h = idx % H;
      float s = 0.f;
      if (n < nodes) {
        for (int k = 0; k < p.K; ++k) s += F[(n * p.K + k) * LF + h];
        p.ss[(size_t)(n0 + n) * H + h] = from_f<T>(s);
      }
      sS[n * LA + h] = from_f<T>(s);
    }
    __syncthreads();

    // the per-edge gradients (table contributions, rounded at bf16, to
    // scratch; gathered: g_G, and g_ein without contract_e); g_e to SB.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
        if (r < rows) {
          if constexpr (kMlp) {
            st2(p.g_G + (e0 + r) * H + c, v0, v1);
            if constexpr (!kWithWb) st2(p.g_ein + (e0 + r) * H + c, v0, v1);
          } else {
            T* tc = p.tcs + (e0 + r) * C + c;
            if (mode == kDec) {
              const float mb = to_f(p.mbw[e0 + r]), m1 = to_f(p.m_att[e0 + r]);
              st2(tc, mb * v0, mb * v1);
              v0 *= m1;
              v1 *= m1;
              tc += H;
            }
            st2(tc, v0, v1);
          }
        }
        if constexpr (kWithWb) st2(SB + r * LA + c, v0, v1);
      }
    __syncthreads();

    // g_ein = g_e@Wb^T and g_hV = s@Wa^T.
    if constexpr (kWithWb) {
      if constexpr (kLow) product<H, NT>(SB, Ws + 3 * H * (H + 8), rb, cb, acc);
      else product<H, NT>(SB, Wf, true, rb, cb, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          if (r < rows)
            st2(p.g_ein + (e0 + r) * H + c, acc[j][2 * hf], acc[j][2 * hf + 1]);
        }
    }
    if (warp < H / 8) {
      float nacc[4];
      node_product<H>(sS, p.wa, 8 * warp, nacc);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = g + 8 * hf;
        if (n < nodes)
          st2(p.g_hV + (size_t)(n0 + n) * H + 8 * warp + 2 * t, nacc[2 * hf],
              nacc[2 * hf + 1]);
      }
    }
    __syncthreads();  // the next tile overwrites SA, SB, sS
  }
}

// Start the copies of rows [c0, c0 + kChunk) of weight gradient w's two
// operands into Ps, Qs (rows from r_end on are zero-filled): 0 dWa (h_V, s),
// 1 dWb (e_in, g_e), 2 dW2 (gelu(x), g_y), 3 dW3 (gelu(y), g_m).
template <int H, int KIND, typename T>
__device__ __forceinline__ void issue_chunk(const Params<T>& p, int mode, int w,
                                            int c0, int r_end, T* Ps, T* Qs) {
  constexpr int LP = H + 8, EPS = 16 / (int)sizeof(T), SEG = H / EPS;
  for (int i = threadIdx.x; i < 2 * kChunk * SEG; i += kGradThreads) {
    const int q = i >= kChunk * SEG;
    const int j = i - q * kChunk * SEG, rr = j / SEG, h = (j % SEG) * EPS;
    const bool ok = c0 + rr < r_end;
    const size_t r = ok ? c0 + rr : c0;  // an address inside the operand
    const T* src;
    if (q == 0)
      src = (w == 0 ? p.h_V : w == 1 ? p.e_in : w == 2 ? p.u1s : p.u2s) + r * H + h;
    else if (w == 1)
      src = KIND == kBwdTable ? p.tcs + r * p.C + (p.C - H) + h : p.g_G + r * H + h;
    else
      src = (w == 0 ? p.ss : w == 2 ? p.gys : mode == kEncEdge ? p.g : p.gms) + r * H + h;
    async_copy16((q ? Qs : Ps) + rr * LP + h, src, ok);
  }
}

// Block (s, w): the partial of weight gradient w over the s-th of gridDim.x
// ranges of kChunk-row chunks: D = P^T Q with P, Q the row operands of
// issue_chunk, [H, H] fp32 to wpart[s][w]. 16 warps, each 16 rows x H/2
// columns of D (H = 128); a ring of stages<T>() chunks in shared memory,
// filled by cp.async that many chunks less one ahead of the tensor cores.
// kBwdGatheredE has no dWb: its blocks take no rows and write zeros.
template <int H, int KIND, typename T>
__device__ __forceinline__ void wgrad_split(const Params<T>& p, int mode,
                                            float* __restrict__ wpart) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int LP = H + 8, RB = H / 16;
  constexpr int WPR = (16 / RB < H / 16) ? 16 / RB : H / 16;
  constexpr int CW = H / WPR, NT = CW / 8;  // columns and n-tiles per warp
  constexpr int kStage = 2 * kChunk * LP;   // elements per stage
  constexpr int kStages = stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, g = lane_g(), t = lane_t();
  const int w = 3 - (int)blockIdx.y;  // the per-edge products start first
  const int R = KIND == kBwdGatheredE && w == 1 ? 0 : w == 0 ? p.N : p.N * p.K;
  const int nch = (R + kChunk - 1) / kChunk;
  const int ch0 = (int)((long long)blockIdx.x * nch / gridDim.x);
  const int ch1 = (int)((long long)(blockIdx.x + 1) * nch / gridDim.x);
  const bool active = warp < RB * WPR;
  const int m0 = 16 * (warp % RB), n0 = CW * (warp / RB);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ch0 + s < ch1) {
      T* Ps = ring + s * kStage;
      issue_chunk<H, KIND, T>(p, mode, w, (ch0 + s) * kChunk, R, Ps, Ps + kChunk * LP);
    }
    async_commit();
  }
  for (int c = ch0; c < ch1; ++c) {
    async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    const int cn = c + kStages - 1;
    if (cn < ch1) {
      T* Pn = ring + ((cn - ch0) % kStages) * kStage;
      issue_chunk<H, KIND, T>(p, mode, w, cn * kChunk, R, Pn, Pn + kChunk * LP);
    }
    async_commit();
    T* Ps = ring + ((c - ch0) % kStages) * kStage;
    T* Qs = Ps + kChunk * LP;
    if (active) {
      if constexpr (kLow) {
#pragma unroll
        for (int k0 = 0; k0 < kChunk; k0 += 16) {
          uint32_t a[4];
          frag_a_bf16_trans(a, Ps, LP, m0, k0);
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t b[4];
            frag_b2_bf16_trans(b, Qs, LP, n0 + 8 * j, k0);
            mma_bf16(acc[j], a, b[0], b[1]);
            mma_bf16(acc[j + 1], a, b[2], b[3]);
          }
        }
      } else {
#pragma unroll 2
        for (int k0 = 0; k0 < kChunk; k0 += 8) {
          const float* pa = Ps + (k0 + t) * LP + m0 + g;
          const float af[4] = {pa[0], pa[8], pa[4 * LP], pa[4 * LP + 8]};
          SplitA a;
          a.set(af);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* pb = Qs + (k0 + t) * LP + n0 + 8 * j + g;
            mma_3xtf32(acc[j], a, pb[0], pb[4 * LP]);
          }
        }
      }
    }
  }
  async_wait<0>();
  if (active) {
    float* out = wpart + ((size_t)blockIdx.x * 4 + w) * H * H;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      st2(out + (m0 + g) * H + c, acc[j][0], acc[j][1]);
      st2(out + (m0 + g + 8) * H + c, acc[j][2], acc[j][3]);
    }
  }
}

// wgrad[j] = sum over the splits of the weight partials, in order
// (j < 4H^2: [dWa | dWb | dW2 | dW3]).
__device__ __forceinline__ void sum_weight_partials(const float* __restrict__ wpart,
                                                    int splits, int n,
                                                    float* __restrict__ wgrad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < splits; ++b) s += wpart[(size_t)b * n + j];
  wgrad[j] = s;
}

// out[j] = sum over the tiles of bpart[tile][j] (j < 3H: db1 | db2 | db3):
// one warp per entry, lane l adds tiles l, l + 32, ... in order, then a
// fixed butterfly over the lanes.
__device__ __forceinline__ void sum_bias_partials(const float* __restrict__ bpart,
                                                  int tiles, int n,
                                                  float* __restrict__ out) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= n) return;
  float s = 0.f;
  for (int b = lane; b < tiles; b += 32) s += bpart[(size_t)b * n + j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[j] = s;
}

// Dynamic shared memory of the tile walk and of a weight-gradient block.
template <int H, typename T>
size_t tile_smem() {
  constexpr int LA = lda<T>(H);
  size_t r = 2 * kTileRows * LA * sizeof(T);
  if (r < (size_t)kTileRows * (H + 4) * 4) r = (size_t)kTileRows * (H + 4) * 4;
  r += sizeof(T) == 2 ? 4 * H * (H + 8) * sizeof(bf16) : H * (H + 8) * sizeof(float);
  return r + 4 * kTileThreads * sizeof(float) + kMaxTileNodes * LA * sizeof(T);
}

template <int H, typename T>
size_t wgrad_smem() {
  return (size_t)stages<T>() * 2 * kChunk * (H + 8) * sizeof(T);
}

}  // namespace
