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
// Five launches, no atomics; every output is deterministic. A, B and D are
// the backward walk of message_bwd_tile.cuh (KIND kBwdTable: x read from
// the forward's x_out, each edge's table contribution written to scratch),
// one copy shared with the pre-gathered message MLP's backward
// (message_mlp_bwd.cu):
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
#include "message_bwd_tile.cuh"

namespace {

template <int H, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
tile_kernel(Params<T> p, int mode) {
  backward_tiles<H, kBwdTable>(p, mode);
}

template <int H, typename T>
__global__ void __launch_bounds__(kGradThreads, 1)
wgrad_kernel(Params<T> p, int mode, float* __restrict__ wpart) {
  wgrad_split<H, kBwdTable>(p, mode, wpart);
}

__global__ void reduce_weights(const float* __restrict__ wpart, int splits,
                               int n, float* __restrict__ wgrad) {
  sum_weight_partials(wpart, splits, n, wgrad);
}

__global__ void reduce_biases(const float* __restrict__ bpart, int tiles,
                              int n, float* __restrict__ out) {
  sum_bias_partials(bpart, tiles, n, out);
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
  const size_t smem_b = wgrad_smem<H, T>();
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

// wgrad [4H^2 + 3H] = [dWa | dWb | dW2 | dW3 | db1 | db2 | db3]; g_tab
// [(N / L) * Lk, C] (written whole). Scratch of the operands' type: u1s,
// u2s, gys and (enc-node, dec; else null) gms [N*K, H], tcs [N*K, C], ss
// [N, H]; fp32: bpart [tiles, 3H] (tiles = ceil(N / min(128 / K, 16)),
// ops/message_kernels.py::bwd_tile_nodes), wpart [splits, 4, H, H]. order
// [N*K] and offsets [(N / L) * Lk + 1]: the edges sorted stably by table
// row (n / L) * Lk + eidx, and where each row starts.
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
