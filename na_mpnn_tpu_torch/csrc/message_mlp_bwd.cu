// Backward of the message MLP on a pre-gathered neighbour operand
// (message_mlp.cu), for Hopper (sm_90a); fp32, and bf16 for the bf16 trunk.
// Products on the tensor cores (mma.cuh): bf16 mma.sync for the bf16
// variant, 3xTF32 for fp32.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_bwd_call (_bwd_kernel, message_kernels.py:103). Like the TPU
// kernel it recomputes the activations from the inputs (the forward saves
// nothing). Per edge row e (node n):
//   x = ((h_V[n]@Wa + G[e]) + b1) + (contract_e ? e_in[e]@Wb : e_in[e])
//   u1 = gelu(x), y = u1@W2 + b2, u2 = gelu(y)
//   g_m = aggregate ? g[n] * rnd(mask_att[e] / 30) : g[e]
//   dW3 = sum u2^T g_m, db3 = sum g_m, g_y = (g_m@W3^T) * gelu'(y)
//   dW2 = sum u1^T g_y, db2 = sum g_y, g_x = (g_y@W2^T) * gelu'(x),
//   db1 = sum g_x, g_G[e] = g_x
//   contract_e: g_ein[e] = g_x@Wb^T, dWb = sum e_in^T g_x
//   otherwise:  g_ein[e] = g_x, dWb = 0 (as the JAX VJP returns it)
//   s[n] = sum_k g_x, g_hV = s@Wa^T, dWa = sum h_V^T s
// with the exact GELU derivative Phi(x) + x*phi(x) (the TPU kernel uses the
// Abramowitz-Stegun erf). rnd is the operands' type: JAX divides the mask
// in its own type, so at bf16 g_m is the fp32 g times bf16(mask_att / 30),
// not (g * mask_att) / 30.
//
// bf16 (message_mlp_backward_bf16; the TPU kernel's bf16 branch,
// message_kernels.py:104-160): the inputs, weights and cotangent are bf16
// and g_hV, g_ein, g_G are written bf16. x is recomputed as the bf16
// forward does and kept fp32, unrounded; every product operand is rounded
// to bf16 (u2, g_m, g_y, u1, g_x, s) and summed in fp32, while gelu' works
// on the unrounded x and y and the bias sums and sum_k g_x start from
// unrounded fp32 values. The weight and bias gradients stay fp32 here and
// the caller rounds them once (ops/message_kernels.py), as the JAX VJP
// casts them to the weights' type.
//
// What bounds it on the card: at bf16 the bytes (h_V, e_in, G, the
// cotangent and the three gradients, about 0.8 KB per edge at H = 128; the
// scratch adds about 0.2 GB written and read back at E = 192,000), at fp32 the
// operations (the recomputed W2 product, g_y, g_x and the weight gradients
// dW2, dW3: 8 H^2 multiply-adds per edge in the decoder's variant, 12 H^2
// more with contract_e).
// Design: the backward walk of message_bwd_tile.cuh with KIND kBwdGathered
// (contract_e) or kBwdGatheredE, one copy shared with the message-table
// backward (message_table_bwd.cu): a persistent grid of 512-thread blocks
// over tiles of 128 edge rows of whole nodes, the products on the tensor
// cores with the bf16 weights resident; x recomputed in the tile (h_V@Wa
// once per node, e_in@Wb with contract_e) where the table kind reads the
// saved x, kept in an fp32 slot of the block and read back for gelu'(x);
// g_x written straight to g_G (no table pass: each G row is one edge's); then
// the split-K weight-gradient products over fixed row ranges and the
// ordered reductions of the weight and bias partials. No atomics: every
// output is the same on every launch.
#include "message_bwd_tile.cuh"

namespace {

template <int H, int KIND, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
mlp_tile_kernel(Params<T> p, int mode) {
  backward_tiles<H, KIND>(p, mode);
}

template <int H, int KIND, typename T>
__global__ void __launch_bounds__(kGradThreads, 1)
mlp_wgrad_kernel(Params<T> p, int mode, float* __restrict__ wpart) {
  wgrad_split<H, KIND>(p, mode, wpart);
}

__global__ void mlp_reduce_weights(const float* __restrict__ wpart, int splits,
                                   int n, float* __restrict__ wgrad) {
  sum_weight_partials(wpart, splits, n, wgrad);
}

__global__ void mlp_reduce_biases(const float* __restrict__ bpart, int tiles,
                                  int n, float* __restrict__ out) {
  sum_bias_partials(bpart, tiles, n, out);
}

template <int H, int KIND, typename T>
int launch(const Params<T>& p, int mode, int grid, int splits, float* wpart,
           float* wgrad, cudaStream_t stream) {
  const size_t smem_a = tile_smem<H, T>();
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tile_kernel<H, KIND, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  mlp_tile_kernel<H, KIND, T><<<grid, kTileThreads, smem_a, stream>>>(p, mode);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem_b = wgrad_smem<H, T>();
  err = cudaFuncSetAttribute(mlp_wgrad_kernel<H, KIND, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  mlp_wgrad_kernel<H, KIND, T><<<dim3(splits, 4), kGradThreads, smem_b, stream>>>(
      p, mode, wpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nw = 4 * H * H;
  mlp_reduce_weights<<<(nw + 255) / 256, 256, 0, stream>>>(wpart, splits, nw, wgrad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_reduce_biases<<<(3 * H * 32 + 255) / 256, 256, 0, stream>>>(p.bpart, p.tiles,
                                                                  3 * H, wgrad + nw);
  return (int)cudaGetLastError();
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, int contract_e, int grid, int splits,
           float* wpart, float* wgrad, cudaStream_t stream) {
  return contract_e
             ? launch<H, kBwdGathered>(p, mode, grid, splits, wpart, wgrad, stream)
             : launch<H, kBwdGatheredE>(p, mode, grid, splits, wpart, wgrad, stream);
}

template <typename T>
int backward(const T* h_V, const T* e_in, const T* G, const T* m_att,
             const T* wa, const T* wb, const T* b1, const T* w2, const T* b2,
             const T* w3, const T* g, T* g_hV, T* g_ein, T* g_G, T* u1s,
             T* gms, T* u2s, T* gys, T* ss, float* xs, float* bpart,
             float* wpart, float* wgrad, int N, int K, int H, int contract_e,
             int aggregate, int tn, int nblocks, int splits,
             cudaStream_t stream) {
  if (K < 1 || K > kTileRows / 2 || N < 1 || tn < 1 || tn > kMaxTileNodes ||
      tn * K > kTileRows || nblocks < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (N + tn - 1) / tn;
  const int mode = aggregate ? kEncNode : kEncEdge;
  Params<T> p{h_V,  e_in, nullptr, nullptr, m_att, nullptr, wa,  wb,  w2,
              b2,   w3,   g,       g_hV,    g_ein, u1s,     gms, u2s, gys,
              nullptr, ss, bpart,  N,       K,     0,       0,   tn,  tiles,
              H,    G,    b1,      g_G,     xs};
  const int grid = nblocks < tiles ? nblocks : tiles;
  switch (H) {
    case 32: return launch<32>(p, mode, contract_e, grid, splits, wpart, wgrad, stream);
    case 64: return launch<64>(p, mode, contract_e, grid, splits, wpart, wgrad, stream);
    case 128: return launch<128>(p, mode, contract_e, grid, splits, wpart, wgrad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// wgrad [4H^2 + 3H] = [dWa | dWb | dW2 | dW3 | db1 | db2 | db3] (fp32). g is
// [N, H] with aggregate, else [N*K, H]; g_hV [N, H], g_ein and g_G [N*K, H].
// Scratch of the operands' type: u1s, u2s, gys and (aggregate; else null)
// gms [N*K, H], ss [N, H]; fp32: xs [nblocks, 128, H], bpart [tiles, 3H]
// (tiles = ceil(N / tn)), wpart [splits, 4, H, H]. tn: nodes per tile
// (tn * K <= 128, tn <= 16; ops/message_kernels.py::bwd_tile_nodes);
// nblocks: the persistent grid (the SM count); splits: the weight-gradient
// row ranges. e_in, G, g and h_V 16-byte aligned.
extern "C" int message_mlp_backward(
    const float* h_V, const float* e_in, const float* G, const float* m_att,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* g, float* g_hV,
    float* g_ein, float* g_G, float* u1s, float* gms, float* u2s, float* gys,
    float* ss, float* xs, float* bpart, float* wpart, float* wgrad, int N,
    int K, int H, int contract_e, int aggregate, int tn, int nblocks,
    int splits, cudaStream_t stream) {
  return backward<float>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, g, g_hV,
                         g_ein, g_G, u1s, gms, u2s, gys, ss, xs, bpart, wpart,
                         wgrad, N, K, H, contract_e, aggregate, tn, nblocks,
                         splits, stream);
}

// The same with bf16 inputs, weights, cotangent, g_hV, g_ein, g_G and
// operand scratch; xs, bpart, wpart and wgrad stay fp32.
extern "C" int message_mlp_backward_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* G, const bf16* m_att,
    const bf16* wa, const bf16* wb, const bf16* b1, const bf16* w2,
    const bf16* b2, const bf16* w3, const bf16* g, bf16* g_hV, bf16* g_ein,
    bf16* g_G, bf16* u1s, bf16* gms, bf16* u2s, bf16* gys, bf16* ss,
    float* xs, float* bpart, float* wpart, float* wgrad, int N, int K, int H,
    int contract_e, int aggregate, int tn, int nblocks, int splits,
    cudaStream_t stream) {
  return backward<bf16>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, g, g_hV,
                        g_ein, g_G, u1s, gms, u2s, gys, ss, xs, bpart, wpart,
                        wgrad, N, K, H, contract_e, aggregate, tn, nblocks,
                        splits, stream);
}
