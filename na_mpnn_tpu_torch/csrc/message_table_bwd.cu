// Backward of the message MLP with the neighbour-table gather, for Hopper
// (sm_90a), in the three modes of message_table.cu; fp32, and bf16 for the
// bf16 trunk. Products on the tensor cores (mma.cuh): bf16 mma.sync for the
// bf16 variant, 3xTF32 for fp32.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_table_bwd_call (_bwd_kernel_table, message_kernels.py:359). It
// resumes from the pre-GELU x that the forward saved (x_out of
// message_table.cu), so the gather is never recomputed. Per edge row e
// (node n, structure b = n / L, table row t = b*Lk + eidx[e]; Lk = L on one
// device, the all-gathered structure's length on the graph-parallel route):
//   u1 = gelu(x), y = u1@W2 + b2, u2 = gelu(y)
//   g_m = g[e] (enc-edge) | g[n]*mask_att[e]/30 (enc-node) | g[n]/30 (dec)
//   dW3 = sum u2^T g_m, db3 = sum g_m, g_y = (g_m@W3^T) * gelu'(y)
//   dW2 = sum u1^T g_y, db2 = sum g_y, g_x = (g_y@W2^T) * gelu'(x),
//   db1 = sum g_x
//   enc: g_table[t] += g_x; g_e = g_x
//   dec: g_table[t] += [mbw*g_x | m1d*g_x]; g_e = m1d*g_x (m1d rides
//        mask_att)
//   g_ein = g_e@Wb^T, dWb = sum e_in^T g_e
//   s[n] = sum_k g_x, g_hV = s@Wa^T, dWa = sum h_V^T s
// with the exact GELU derivative Phi(x) + x*phi(x) (the TPU kernel uses the
// Abramowitz-Stegun erf).
//
// bf16 (message_table_backward_bf16; the TPU kernel's bf16 branch,
// message_kernels.py:384-435): the inputs (x included), weights and
// cotangent are bf16 and g_hV, g_ein are written bf16. Every product takes
// bf16-rounded operands (gelu(x), gelu(y), g_m, g_y, g_e, sum_k g_x) summed
// in fp32, while the bias sums, the K-sum and the table contributions start
// from the unrounded fp32 values (taken from the fp32 accumulators before
// anything is rounded); each table contribution is rounded to bf16 and
// summed in fp32; the weight and table gradients stay fp32 here and the
// caller rounds them once (ops/message_kernels.py).
//
// Five launches, no atomics; every output is deterministic:
// A. tile_kernel: a persistent grid, one block of 512 threads per SM, walks
//    tiles of 128 edge rows (tn = min(128 / K, 16) nodes). The four chained
//    products y = u1@W2, g_y = g_m@W3^T, g_x = g_y@W2^T, g_ein = g_e@Wb^T and
//    g_hV = s@Wa^T run on the tensor cores from operands in shared memory;
//    each of 16 warps owns 16 rows x H/2 columns. The bf16 weights (W2^T,
//    W3, W2, Wb: 136 KB) stay in shared memory for the block's life; an
//    fp32 weight is copied in (68 KB) before each product. It writes g_ein,
//    g_hV, the operands of the weight gradients (u1, g_m, u2, g_y, s;
//    rounded at bf16) and each edge's table contribution to scratch, and the tile's
//    bias sums (fp32, in a fixed order over the tile's rows) to `bpart`.
// B. wgrad_kernel: dWa = h_V^T s, dWb = e_in^T g_e, dW2 = u1^T g_y and
//    dW3 = u2^T g_m as split-K products over fixed row ranges (g_e is the
//    last H columns of the table contributions), partials to `wpart`; the
//    rows stream through a cp.async ring of chunks in shared memory.
// C. table_kernel: one warp per table row sums its edges' contributions in
//    ascending edge order (order / offsets: the edges sorted stably by table
//    row, made by the caller) and writes the row once.
// D. reduce_weights, reduce_biases: the weight partials over the splits and
//    the bias sums over the tiles, each in a fixed order.
//
// What bounds it on the card: at bf16 the bytes (x, e_in, cotangent and
// outputs; the scratch adds about 0.3 GB of writes and reads), at fp32 the
// operations. Against that, the products run on the tensor cores, the
// per-tile weight-gradient updates of the first version (about 1.2 GB of
// L2 traffic per launch) became streamed split-K products, and the table
// gradient's 25-50 M float atomics became one ordered pass.
#include "message_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTileRows = 128;
constexpr int kTileThreads = 512;  // 16 warps: 8 row blocks x 2 column halves
constexpr int kMaxTileNodes = 16;
constexpr int kChunk = 64;         // rows per chunk of a weight-gradient block
constexpr int kGradThreads = 512;
// chunks in flight per weight-gradient block (shared memory: 104 KB at bf16,
// 139 KB at fp32, H = 128)
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }

// Operand row stride in shared memory (elements): conflict-free fragment
// loads for each type (mma.cuh).
template <typename T>
__host__ __device__ constexpr int lda(int H) { return sizeof(T) == 2 ? H + 8 : H + 4; }

template <typename T>
struct Params {
  const T* h_V;
  const T* e_in;
  const T* x;
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
  T* gms;      // [E, H] g_m (the summing modes; enc-edge reads g)
  T* u2s;      // [E, H] gelu(y)
  T* gys;      // [E, H] g_y
  T* tcs;      // [E, C] table contributions; g_e = the last H columns
  T* ss;       // [N, H] sum_k g_x
  float* bpart;  // [tiles, 3H] db1 | db2 | db3 of each tile
  int N, K, L, Lk, tn, tiles, C;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  st2(p, v.x, v.y);
  st2(p + 2, v.z, v.w);
}

// acc[j] = A[16 rb .. +16, :] @ B[:, cb + 8j .. +8] for the warp's NT
// n-tiles, A [rows][lda] and the weight in shared memory. bf16: Bs [n][k]
// (stride H + 8). fp32 (3xTF32): W as stage_weight left it, B[k][n] =
// W[k][n] (nk false, stride H + 8) or W[n][k] (nk true, stride H + 4).
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

template <int H, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_kernel(Params<T> p, int mode) {
  constexpr bool kLow = sizeof(T) == 2;
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
      Ws[3 * H * LB + r * LB + c] = p.wb[idx];     // Wb
    }
  }
  float acc[NT][4], dy[NT][4];

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int n0 = tile * p.tn;
    const int nodes = min(p.tn, p.N - n0);
    const int rows = nodes * p.K;
    const size_t e0 = (size_t)n0 * p.K;
    float* bp = p.bpart + (size_t)tile * 3 * H;

    // u1 = gelu(x) and g_m of the tile's rows (zero past the last node);
    // db3 from the unrounded g_m: this thread's 4 columns over its rows.
    {
      float4 xv[kV], gv[kV];
      float wv[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kTileThreads), r = idx / H, h = idx % H;
        xv[v] = gv[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        wv[v] = 1.f;
        if (r < rows) {
          xv[v] = ld4(p.x + e0 * H + idx);
          if (mode == kEncEdge) {
            gv[v] = ld4(p.g + e0 * H + idx);
          } else {
            gv[v] = ld4(p.g + (size_t)(n0 + r / p.K) * H + h);
            if (mode == kEncNode) wv[v] = to_f(p.m_att[e0 + r]);
          }
        }
      }
      float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kTileThreads), r = idx / H, h = idx % H;
        float4 u = xv[v], gm = gv[v];
        u.x = gelu(u.x); u.y = gelu(u.y); u.z = gelu(u.z); u.w = gelu(u.w);
        st4(SA + r * LA + h, u);
        if (r < rows) st4(p.u1s + e0 * H + idx, u);
        if (mode != kEncEdge) {
          const float w = wv[v];
          gm.x = gm.x * w / 30.0f; gm.y = gm.y * w / 30.0f;
          gm.z = gm.z * w / 30.0f; gm.w = gm.w * w / 30.0f;
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
    if constexpr (!kLow) stage_weight<H>(p.wb, true, Wf);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        float2 xx = make_float2(0.f, 0.f);
        if (r < rows) xx = ld2(p.x + (e0 + r) * H + c);
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

    // table contributions (rounded at bf16) to scratch; g_e to SB.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        float v0 = acc[j][2 * hf], v1 = acc[j][2 * hf + 1];
        if (r < rows) {
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
        st2(SB + r * LA + c, v0, v1);
      }
    __syncthreads();

    // g_ein = g_e@Wb^T and g_hV = s@Wa^T.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of rows [c0, c0 + kChunk) of weight gradient w's two
// operands into Ps, Qs (rows from r_end on are zero-filled): 0 dWa (h_V, s),
// 1 dWb (e_in, g_e), 2 dW2 (gelu(x), g_y), 3 dW3 (gelu(y), g_m).
template <int H, typename T>
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
      src = p.tcs + r * p.C + (p.C - H) + h;
    else
      src = (w == 0 ? p.ss : w == 2 ? p.gys : mode == kEncEdge ? p.g : p.gms) + r * H + h;
    cp_async16((q ? Qs : Ps) + rr * LP + h, src, ok);
  }
}

// Block (s, w): the partial of weight gradient w over the s-th of gridDim.x
// ranges of kChunk-row chunks: D = P^T Q with P, Q the row operands of
// issue_chunk, [H, H] fp32 to wpart[s][w]. 16 warps, each 16 rows x H/2
// columns of D (H = 128); a ring of stages<T>() chunks in shared memory,
// filled by cp.async that many chunks less one ahead of the tensor cores.
template <int H, typename T>
__global__ void __launch_bounds__(kGradThreads, 1)
wgrad_kernel(Params<T> p, int mode, float* __restrict__ wpart) {
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
  const int R = w == 0 ? p.N : p.N * p.K;
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
      issue_chunk<H, T>(p, mode, w, (ch0 + s) * kChunk, R, Ps, Ps + kChunk * LP);
    }
    cp_async_commit();
  }
  for (int c = ch0; c < ch1; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's stage is free
    const int cn = c + kStages - 1;
    if (cn < ch1) {
      T* Pn = ring + ((cn - ch0) % kStages) * kStage;
      issue_chunk<H, T>(p, mode, w, cn * kChunk, R, Pn, Pn + kChunk * LP);
    }
    cp_async_commit();
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
  cp_async_wait<0>();
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

// VPL consecutive elements of a row widened to fp32 (16-byte aligned for
// fp32, 8-byte for bf16).
template <int VPL, typename T>
__device__ __forceinline__ void ld_run(const T* p, float (&v)[VPL]) {
  if constexpr (VPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VPL; i += 4) {
      const float4 a = ld4(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPL; ++i) v[i] = ldf(p + i);
  }
}

// g_tab[row] = the sum of its edges' contributions, in ascending edge order
// (order[offsets[row] .. offsets[row + 1]]); one warp per row, each lane
// owning VPL = C / 32 consecutive columns. The warp reads 32 edge ids at a
// time and walks them in order, so loads of several edges are in flight.
template <typename T, int VPL>
__global__ void table_kernel(const T* __restrict__ tcs,
                             const long long* __restrict__ order,
                             const long long* __restrict__ offsets, int rows,
                             float* __restrict__ g_tab) {
  constexpr int C = 32 * VPL;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.f;
  const long long end = offsets[row + 1];
  for (long long q0 = offsets[row]; q0 < end; q0 += 32) {
    const int n = (int)min(32LL, end - q0);
    const long long mine = lane < n ? order[q0 + lane] : 0;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const long long e = __shfl_sync(0xffffffffu, mine, i);
      float v[VPL];
      ld_run<VPL>(tcs + e * C + lane * VPL, v);
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[c] += v[c];
    }
  }
  float* dst = g_tab + (size_t)row * C + lane * VPL;
#pragma unroll
  for (int i = 0; i < VPL; ++i) dst[i] = acc[i];
}

// wgrad[j] = sum over the splits of the weight partials, in order
// (j < 4H^2: [dWa | dWb | dW2 | dW3]).
__global__ void reduce_weights(const float* __restrict__ wpart, int splits,
                               int n, float* __restrict__ wgrad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int b = 0; b < splits; ++b) s += wpart[(size_t)b * n + j];
  wgrad[j] = s;
}

// out[j] = sum over the tiles of bpart[tile][j] (j < 3H: db1 | db2 | db3):
// one warp per entry, lane l adds tiles l, l + 32, ... in order, then a
// fixed butterfly over the lanes.
__global__ void reduce_biases(const float* __restrict__ bpart, int tiles,
                              int n, float* __restrict__ out) {
  const int j = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (j >= n) return;
  float s = 0.f;
  for (int b = lane; b < tiles; b += 32) s += bpart[(size_t)b * n + j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[j] = s;
}

template <int H, typename T>
size_t tile_smem() {
  constexpr int LA = lda<T>(H);
  size_t r = 2 * kTileRows * LA * sizeof(T);
  if (r < (size_t)kTileRows * (H + 4) * 4) r = (size_t)kTileRows * (H + 4) * 4;
  r += sizeof(T) == 2 ? 4 * H * (H + 8) * sizeof(bf16) : H * (H + 8) * sizeof(float);
  return r + 4 * kTileThreads * sizeof(float) + kMaxTileNodes * LA * sizeof(T);
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, int nblocks, int splits,
           float* wpart, const long long* order, const long long* offsets,
           float* g_tab, float* wgrad, cudaStream_t stream) {
  const size_t smem_a = tile_smem<H, T>();
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<H, T><<<nblocks < p.tiles ? nblocks : p.tiles, kTileThreads,
                      smem_a, stream>>>(p, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_b = (size_t)stages<T>() * 2 * kChunk * (H + 8) * sizeof(T);
  err = cudaFuncSetAttribute(wgrad_kernel<H, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  wgrad_kernel<H, T><<<dim3(splits, 4), kGradThreads, smem_b, stream>>>(p, mode, wpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int trows = p.N / p.L * p.Lk;
  const unsigned tgrid = (unsigned)((trows * 32 + 255) / 256);
  if (p.C == 2 * H)
    table_kernel<T, H / 16><<<tgrid, 256, 0, stream>>>(p.tcs, order, offsets, trows, g_tab);
  else
    table_kernel<T, H / 32><<<tgrid, 256, 0, stream>>>(p.tcs, order, offsets, trows, g_tab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nw = 4 * H * H;
  reduce_weights<<<(nw + 255) / 256, 256, 0, stream>>>(wpart, splits, nw, wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_biases<<<(3 * H * 32 + 255) / 256, 256, 0, stream>>>(p.bpart, p.tiles,
                                                              3 * H, wgrad + nw);
  return (int)cudaGetLastError();
}

int tile_nodes(int K) {
  const int tn = kTileRows / K;
  return tn < kMaxTileNodes ? tn : kMaxTileNodes;
}

template <typename T>
int backward(int mode, const T* h_V, const T* e_in, const T* x,
             const long long* eidx, const T* m_att, const T* mbw, const T* wa,
             const T* wb, const T* w2, const T* b2, const T* w3, const T* g,
             T* g_hV, T* g_ein, T* u1s, T* gms, T* u2s, T* gys, T* tcs, T* ss,
             float* bpart,
             float* wpart, const long long* order, const long long* offsets,
             float* g_tab, float* wgrad, int N, int K, int L, int Lk, int H,
             int nblocks, int splits, cudaStream_t stream) {
  if (K < 1 || K > kTileRows / 2 || mode < kEncNode || mode > kDec ||
      nblocks < 1 || splits < 1 || L < 1 || Lk < 1 || N % L)
    return (int)cudaErrorInvalidValue;
  const int tn = tile_nodes(K);
  const int tiles = (N + tn - 1) / tn;
  const int C = mode == kDec ? 2 * H : H;
  Params<T> p{h_V,   e_in,  x,   eidx, m_att, mbw, wa, wb, w2,    b2,
              w3,    g,     g_hV, g_ein, u1s, gms, u2s, gys, tcs, ss,
              bpart, N,     K,    L,    Lk,  tn,  tiles, C};
  switch (H) {
    case 32: return launch<32>(p, mode, nblocks, splits, wpart, order, offsets, g_tab, wgrad, stream);
    case 64: return launch<64>(p, mode, nblocks, splits, wpart, order, offsets, g_tab, wgrad, stream);
    case 128: return launch<128>(p, mode, nblocks, splits, wpart, order, offsets, g_tab, wgrad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Tiles of the tile kernel for N nodes of K neighbours (rows of bpart).
extern "C" int message_table_backward_tiles(int N, int K) {
  if (K < 1 || K > kTileRows / 2) return -1;
  const int tn = tile_nodes(K);
  return (N + tn - 1) / tn;
}

// wgrad [4H^2 + 3H] = [dWa | dWb | dW2 | dW3 | db1 | db2 | db3]; g_tab
// [(N / L) * Lk, C] (written whole). Scratch of the operands' type: u1s,
// u2s, gys and (enc-node, dec; else null) gms [N*K, H], tcs [N*K, C], ss
// [N, H]; fp32: bpart [tiles, 3H], wpart
// [splits, 4, H, H]. order [N*K] and offsets [(N / L) * Lk + 1]: the edges
// sorted stably by table row (n / L) * Lk + eidx, and where each row starts.
// nblocks: the tile kernel's grid (the SM count).
extern "C" int message_table_backward(
    int mode, const float* h_V, const float* e_in, const float* x,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* wa, const float* wb, const float* w2, const float* b2,
    const float* w3, const float* g, float* g_hV, float* g_ein, float* u1s,
    float* gms, float* u2s, float* gys, float* tcs, float* ss, float* bpart,
    float* wpart,
    const long long* order, const long long* offsets, float* g_tab,
    float* wgrad, int N, int K, int L, int Lk, int H, int nblocks, int splits,
    cudaStream_t stream) {
  return backward<float>(mode, h_V, e_in, x, eidx, m_att, mbw, wa, wb, w2, b2,
                         w3, g, g_hV, g_ein, u1s, gms, u2s, gys, tcs, ss, bpart, wpart,
                         order, offsets, g_tab, wgrad, N, K, L, Lk, H, nblocks,
                         splits, stream);
}

// The same with bf16 inputs, weights, cotangent, g_hV, g_ein and operand
// scratch; g_tab, wgrad, bpart and wpart stay fp32.
extern "C" int message_table_backward_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* x,
    const long long* eidx, const bf16* m_att, const bf16* mbw, const bf16* wa,
    const bf16* wb, const bf16* w2, const bf16* b2, const bf16* w3,
    const bf16* g, bf16* g_hV, bf16* g_ein, bf16* u1s, bf16* gms, bf16* u2s,
    bf16* gys, bf16* tcs, bf16* ss, float* bpart, float* wpart, const long long* order,
    const long long* offsets, float* g_tab, float* wgrad, int N, int K, int L,
    int Lk, int H, int nblocks, int splits, cudaStream_t stream) {
  return backward<bf16>(mode, h_V, e_in, x, eidx, m_att, mbw, wa, wb, w2, b2,
                        w3, g, g_hV, g_ein, u1s, gms, u2s, gys, tcs, ss, bpart, wpart,
                        order, offsets, g_tab, wgrad, N, K, L, Lk, H, nblocks,
                        splits, stream);
}
