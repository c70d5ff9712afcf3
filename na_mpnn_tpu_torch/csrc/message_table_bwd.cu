// Backward of the message MLP with the neighbour-table gather, for Hopper
// (sm_90a), in the three modes of message_table.cu; fp32, and bf16 for the
// bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_table_bwd_call (_bwd_kernel_table, message_kernels.py:359). It
// resumes from the pre-GELU x that the forward saved (x_out of
// message_table.cu), so the gather is never recomputed. Per edge row e
// (node n, structure b = n / L, table row t = b*Lk + eidx[e]; Lk = L on one
// device, the all-gathered structure's length on the graph-parallel route):
//   u1 = gelu(x), y = u1@W2 + b2, u2 = gelu(y)
//   g_m = g[e] (enc-edge) | g[n]*mask_att[e]/30 (enc-node) | g[n]/30 (dec)
//   dW3 += u2^T g_m, db3 += g_m, g_y = (g_m@W3^T) * gelu'(y)
//   dW2 += u1^T g_y, db2 += g_y, g_x = (g_y@W2^T) * gelu'(x), db1 += g_x
//   enc: g_table[t] += g_x; g_e = g_x
//   dec: g_table[t] += [mbw*g_x | m1d*g_x]; g_e = m1d*g_x (m1d rides
//        mask_att)
//   g_ein = g_e@Wb^T, dWb += e_in^T g_e
//   s[n] = sum_k g_x, g_hV = s@Wa^T, dWa += h_V^T s
// with the exact GELU derivative Phi(x) + x*phi(x) (the TPU kernel uses the
// Abramowitz-Stegun erf).
//
// bf16 (message_table_backward_bf16; the TPU kernel's bf16 branch,
// message_kernels.py:384-435): the inputs (x included), weights and
// cotangent are bf16 and g_hV, g_ein are written bf16. Every product takes
// bf16-rounded operands (gelu(x), gelu(y), g_m, g_y, the table-side and
// edge-side g_x terms, sum_k g_x) summed in fp32, while the bias sums, the
// K-sum and the table contributions start from the unrounded fp32 values;
// each table contribution is rounded to bf16 and added into the fp32
// table gradient; the weight and table gradients stay fp32 here and the
// caller rounds them once (ops/message_kernels.py).
//
// Reductions across blocks, which run in no order:
// * the weight and bias gradients: a persistent grid of P blocks (P = the
//   SM count, at most the tile count); block i walks tiles i, i+P, ... and
//   sums its tiles' [H,H] and [H] contributions into a slot of its own in
//   `part` (P x (4H^2 + 3H) floats, in L2 at P = 132); a second kernel adds
//   the P slots in a fixed order. No atomics: the result is deterministic.
// * the table gradient: every edge adds into the row of its neighbour, with
//   fp32 atomicAdd into g_table (zeroed by the caller). Not deterministic in
//   the last bits.
//
// What bounds it on the card: operations. Per edge about 14 H^2 (enc-edge)
// or 10 H^2 (summing modes) multiply-adds' worth of products against about
// 2 KB of x, e_in, cotangent and outputs (fp32, outside the tensor cores in
// this first version). Design: one block of 256 threads per tile of 64 edge
// rows, as the forward. The tile's x, gelu(x), gelu(y), gelu'(y) and g_m stay
// in shared memory (5 x 32 KB at H = 128) through four H x H products; the
// weights stream through shared memory in chunks of 32 rows (those taken as
// W^T from a copy transposed once per launch); each thread holds 8 rows x
// H/32 columns of a product and 8 rows x 2 float4 columns of an outer
// product. The outer products' per-tile update of the block's slot is the
// largest cost, hence float4 columns and no read on a block's first tile.
#include "message_common.cuh"

namespace {

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
  float* g_tab;
  float* part;
  float* wT;  // [4][H][H]: Wa^T, Wb^T, W2^T, W3^T (written per launch)
  int N, K, L, Lk, tn, tiles;  // tn: nodes per tile
};

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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
// between barriers (after the fp32 column sum that reads it unrounded,
// before the products that take it as an operand). Nothing for fp32.
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
message_table_bwd_kernel(Params<T> p, int mode) {
  extern __shared__ __align__(16) float smem[];
  float* XS = smem;             // x, then g_x, then g_e
  float* U1 = XS + kRows * H;   // gelu(x), then e_in
  float* U2 = U1 + kRows * H;   // gelu(y), then g_y
  float* GM = U2 + kRows * H;   // g_m
  float* DY = GM + kRows * H;   // gelu'(y)
  float* Ws = DY + kRows * H;   // [kKC][H] weight chunk
  float* HV = Ws + kKC * H;     // [tn][H] h_V of the tile's nodes
  float* SX = HV + p.tn * H;    // [tn][H] sum_k g_x
  constexpr int CPT = H / 32;
  constexpr int kV = kRows * H / (4 * kThreads);  // float4s per thread per tile
  constexpr size_t kSlot = 4 * H * H + 3 * H;
  constexpr bool kLow = sizeof(T) == 2;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int C = mode == kDec ? 2 * H : H;
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

  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int n0 = tile * p.tn;
    const int nodes = min(p.tn, p.N - n0);
    const int rows = nodes * p.K;
    const size_t e0 = (size_t)n0 * p.K;

    // x, gelu(x) and the message cotangent g_m of the tile's rows (zero on
    // rows past the last node, so they add nothing anywhere below). Each
    // thread issues all its loads before it uses one.
    {
      float4 xv[kV], gv[kV];
      float wv[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads), r = idx / H, h = idx % H;
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
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads);
        float4 u = xv[v], gm = gv[v];
        st4(XS + idx, u);
        u.x = rnd<T>(gelu(u.x)); u.y = rnd<T>(gelu(u.y));
        u.z = rnd<T>(gelu(u.z)); u.w = rnd<T>(gelu(u.w));
        st4(U1 + idx, u);
        if (mode != kEncEdge) {
          const float w = wv[v];
          gm.x = gm.x * w / 30.0f; gm.y = gm.y * w / 30.0f;
          gm.z = gm.z * w / 30.0f; gm.w = gm.w * w / 30.0f;
        }
        st4(GM + idx, gm);
      }
    }
    for (int idx = tid; idx < p.tn * H; idx += kThreads)
      HV[idx] = idx < nodes * H ? to_f(p.h_V[(size_t)n0 * H + idx]) : 0.f;

    // y = u1@W2 + b2 (its first barrier publishes the loads above)
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
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int idx = 4 * (tid + v * kThreads), r = idx / H, h = idx % H;
      if (r >= rows) continue;
      const size_t e = e0 + r;
      const size_t grow = (size_t)((n0 + r / p.K) / p.L) * p.Lk + p.eidx[e];
      const float4 gx = *reinterpret_cast<const float4*>(XS + idx);
      float* dst = p.g_tab + grow * C + h;
      if (mode == kDec) {
        const float mb = to_f(p.mbw[e]), m1 = to_f(p.m_att[e]);
        atomicAdd(dst, rnd<T>(mb * gx.x));
        atomicAdd(dst + 1, rnd<T>(mb * gx.y));
        atomicAdd(dst + 2, rnd<T>(mb * gx.z));
        atomicAdd(dst + 3, rnd<T>(mb * gx.w));
        dst += H;
        atomicAdd(dst, rnd<T>(m1 * gx.x));
        atomicAdd(dst + 1, rnd<T>(m1 * gx.y));
        atomicAdd(dst + 2, rnd<T>(m1 * gx.z));
        atomicAdd(dst + 3, rnd<T>(m1 * gx.w));
      } else {
        atomicAdd(dst, rnd<T>(gx.x));
        atomicAdd(dst + 1, rnd<T>(gx.y));
        atomicAdd(dst + 2, rnd<T>(gx.z));
        atomicAdd(dst + 3, rnd<T>(gx.w));
      }
    }
    for (int idx = tid; idx < p.tn * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      if (t < nodes)
        for (int k = 0; k < p.K; ++k) s += XS[(t * p.K + k) * H + h];
      SX[idx] = rnd<T>(s);
    }
    __syncthreads();

    // g_e (dec: m1d * g_x; rounded for the bf16 trunk) over g_x, and e_in
    // over gelu(x)
    {
      float4 ev[kV];
      float mv[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads), r = idx / H;
        ev[v] = r < rows ? ld4(p.e_in + e0 * H + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
        mv[v] = mode == kDec && r < rows ? to_f(p.m_att[e0 + r]) : 1.f;
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int idx = 4 * (tid + v * kThreads);
        st4(U1 + idx, ev[v]);
        if (mode == kDec || kLow) {
          float4 gx = *reinterpret_cast<const float4*>(XS + idx);
          if (mode == kDec) {
            gx.x *= mv[v]; gx.y *= mv[v]; gx.z *= mv[v]; gx.w *= mv[v];
          }
          gx.x = rnd<T>(gx.x); gx.y = rnd<T>(gx.y);
          gx.z = rnd<T>(gx.z); gx.w = rnd<T>(gx.w);
          st4(XS + idx, gx);
        }
      }
    }
    __syncthreads();
    outer_acc<H>(U1, XS, kRows, s_dwb, first);
    outer_acc<H>(HV, SX, nodes, s_dwa, first);
    for (int idx = tid; idx < nodes * H; idx += kThreads) {
      const int t = idx / H, h = idx % H;
      float s = 0.f;
      for (int k = 0; k < H; ++k) s = fmaf(SX[t * H + k], __ldg(waT + k * H + h), s);
      p.g_hV[(size_t)(n0 + t) * H + h] = from_f<T>(s);
    }
    gemm<H>(XS, wbT, Ws, acc);  // g_ein = g_e@Wb^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        p.g_ein[(e0 + r) * H + tx * CPT + c] = from_f<T>(acc[i][c]);
    }
    first = false;
    // gemm ended on a barrier: the next tile may overwrite shared memory.
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
int launch(const Params<T>& p, int mode, int nparts, float* wgrad,
           cudaStream_t stream) {
  transpose_weights<T><<<(4 * H * H + 255) / 256, 256, 0, stream>>>(
      p.wa, p.wb, p.w2, p.w3, H, p.wT);
  const size_t smem = (size_t)(5 * kRows + kKC + 2 * p.tn) * H * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      message_table_bwd_kernel<H, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  message_table_bwd_kernel<H, T><<<nparts, kThreads, smem, stream>>>(p, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 4 * H * H + 3 * H;
  reduce_slots<<<(n + 255) / 256, 256, 0, stream>>>(p.part, nparts, n, wgrad);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(int mode, const T* h_V, const T* e_in, const T* x,
             const long long* eidx, const T* m_att, const T* mbw, const T* wa,
             const T* wb, const T* w2, const T* b2, const T* w3, const T* g,
             T* g_hV, T* g_ein, float* g_tab, float* part, float* wT,
             float* wgrad, int N, int K, int L, int Lk, int H, int nparts,
             cudaStream_t stream) {
  if (K < 1 || K > kRows || mode < kEncNode || mode > kDec || nparts < 1 ||
      L < 1 || Lk < 1)
    return (int)cudaErrorInvalidValue;
  const int tn = kRows / K;
  const int tiles = (N + tn - 1) / tn;
  if (nparts > tiles) nparts = tiles;
  Params<T> p{h_V,  e_in,  x,     eidx, m_att, mbw, wa, wb, w2, b2, w3, g,
              g_hV, g_ein, g_tab, part, wT,    N,   K,  L,  Lk, tn, tiles};
  switch (H) {
    case 32: return launch<32>(p, mode, nparts, wgrad, stream);
    case 64: return launch<64>(p, mode, nparts, wgrad, stream);
    case 128: return launch<128>(p, mode, nparts, wgrad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// wgrad [4H^2 + 3H] = [dWa | dWb | dW2 | dW3 | db1 | db2 | db3];
// scratch part [nparts, 4H^2 + 3H] and wT [4H^2]; g_tab [(N / L) * Lk, C]
// must be zero on entry.
extern "C" int message_table_backward(
    int mode, const float* h_V, const float* e_in, const float* x,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* wa, const float* wb, const float* w2, const float* b2,
    const float* w3, const float* g, float* g_hV, float* g_ein, float* g_tab,
    float* part, float* wT, float* wgrad, int N, int K, int L, int Lk, int H,
    int nparts, cudaStream_t stream) {
  return backward<float>(mode, h_V, e_in, x, eidx, m_att, mbw, wa, wb, w2, b2,
                         w3, g, g_hV, g_ein, g_tab, part, wT, wgrad, N, K, L,
                         Lk, H, nparts, stream);
}

// The same with bf16 inputs, weights, cotangent, g_hV and g_ein; g_tab,
// wgrad and the scratch stay fp32.
extern "C" int message_table_backward_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* x,
    const long long* eidx, const bf16* m_att, const bf16* mbw, const bf16* wa,
    const bf16* wb, const bf16* w2, const bf16* b2, const bf16* w3,
    const bf16* g, bf16* g_hV, bf16* g_ein, float* g_tab, float* part,
    float* wT, float* wgrad, int N, int K, int L, int Lk, int H, int nparts,
    cudaStream_t stream) {
  return backward<bf16>(mode, h_V, e_in, x, eidx, m_att, mbw, wa, wb, w2, b2,
                        w3, g, g_hV, g_ein, g_tab, part, wT, wgrad, N, K, L,
                        Lk, H, nparts, stream);
}
