// Message MLP on a pre-gathered neighbour operand, for Hopper (sm_90a),
// forward; fp32, and bf16 for the bf16 trunk. Products on the tensor cores
// (mma.cuh): bf16 mma.sync for the bf16 variant, 3xTF32 for fp32.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_fwd_call (_fwd_kernel, message_kernels.py:89). Per edge row
// e = (node n, neighbour slot k):
//   x = ((h_V[n]@Wa + G[e]) + b1) + (contract_e ? e_in[e]@Wb : e_in[e])
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
// widened inputs, gelu(x) and gelu(y) are computed in fp32 and rounded to
// bf16 only as product operands, each product sums exact bf16 x bf16
// products in fp32, the masked K-sum / 30 runs in fp32 in the order
// k = 0..K-1, and the output is rounded once. Every output is the same on
// every launch (no atomics).
//
// What bounds it on the card: at bf16 the bytes (e_in, G and the output,
// about 0.5 KB per edge at H = 128), at fp32 the operations (the W2
// product and, with contract_e, e_in@Wb and, without aggregate, W3 per
// edge: 2 H^2 multiply-adds each).
// Design: the tile walk of message_tile.cuh (one copy, shared with the
// message-table forward and the fused layer updates) with the operand kind
// kOpGathered (contract_e) or kOpGatheredE: edge row r of a tile reads row
// e0 + r of G by cp.async one tile ahead, where the table kind gathers rows
// by eidx; and its kEpiTable epilogues (aggregate: the masked K-sum / 30,
// rounded once; otherwise the per-edge store). A persistent grid, one block of 512 threads per SM,
// walks tiles of 64 edge rows of whole nodes (tn = min(64 / K, 16), chosen
// by the caller); h_V@Wa once per node, then the products on the tile's
// rows on the tensor cores; the bf16 weights stay in shared memory, an fp32
// weight is staged by cp.async before each product (the caller hands over
// 16-byte aligned weights). Without contract_e the tile's e_in rows are
// added to x as they are: no Wb product, no copy of Wb.
#include "message_tile.cuh"

namespace {

template <int H, int OP, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
message_mlp_kernel(Params<T> p, int mode) {
  message_tiles<H, kEpiTable, OP>(p, mode);
}

template <int H, int OP, typename T>
int launch(const Params<T>& p, int mode, int nblocks, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<H, T>(p.C);
  cudaError_t err = cudaFuncSetAttribute(
      message_mlp_kernel<H, OP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  message_mlp_kernel<H, OP, T><<<nblocks < p.tiles ? nblocks : p.tiles,
                                 kTileThreads, smem, stream>>>(p, mode);
  return (int)cudaGetLastError();
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, int contract_e, int nblocks,
           cudaStream_t stream) {
  return contract_e ? launch<H, kOpGathered>(p, mode, nblocks, stream)
                    : launch<H, kOpGatheredE>(p, mode, nblocks, stream);
}

template <typename T>
int forward(const T* h_V, const T* e_in, const T* G, const T* m_att,
            const T* wa, const T* wb, const T* b1, const T* w2, const T* b2,
            const T* w3, const T* b3, T* out, int N, int K, int H,
            int contract_e, int aggregate, int tn, int nblocks,
            cudaStream_t stream) {
  if (K < 1 || K > kTileRows || N < 1 || tn < 1 || tn > kMaxTileNodes ||
      tn * K > kTileRows || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  Params<T> p{h_V, e_in, G, nullptr, m_att, nullptr, wa, wb, b1, w2, b2, w3,
              b3, out, nullptr, nullptr, nullptr, nullptr, N, K, 0, 0, tn,
              (N + tn - 1) / tn, H};
  const int mode = aggregate ? kEncNode : kEncEdge;
  switch (H) {
    case 32: return launch<32>(p, mode, contract_e, nblocks, stream);
    case 64: return launch<64>(p, mode, contract_e, nblocks, stream);
    case 128: return launch<128>(p, mode, contract_e, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out is [N, H] with aggregate, else [N*K, H]; wb is read only with
// contract_e and m_att only with aggregate. tn: nodes per tile (tn * K <=
// 64, tn <= 16; ops/message_kernels.py::table_tile_nodes); nblocks: the
// persistent grid (the SM count). e_in, G and, at fp32, the four weights
// 16-byte aligned.
extern "C" int message_mlp_forward(
    const float* h_V, const float* e_in, const float* G, const float* m_att,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out, int N,
    int K, int H, int contract_e, int aggregate, int tn, int nblocks,
    cudaStream_t stream) {
  return forward<float>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, b3, out,
                        N, K, H, contract_e, aggregate, tn, nblocks, stream);
}

// The same with every operand and the output bf16.
extern "C" int message_mlp_forward_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* G, const bf16* m_att,
    const bf16* wa, const bf16* wb, const bf16* b1, const bf16* w2,
    const bf16* b2, const bf16* w3, const bf16* b3, bf16* out, int N, int K,
    int H, int contract_e, int aggregate, int tn, int nblocks,
    cudaStream_t stream) {
  return forward<bf16>(h_V, e_in, G, m_att, wa, wb, b1, w2, b2, w3, b3, out,
                       N, K, H, contract_e, aggregate, tn, nblocks, stream);
}
