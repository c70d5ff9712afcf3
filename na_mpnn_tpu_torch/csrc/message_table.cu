// Message MLP with the neighbour-table gather inside, for Hopper (sm_90a),
// forward, in three modes; fp32, and bf16 for the bf16 trunk. Products on
// the tensor cores (mma.cuh): bf16 mma.sync for the bf16 variant, 3xTF32
// for fp32.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/message_kernels.py::
// _message_table_fwd_call (_fwd_kernel_table, message_kernels.py:314).
// Per edge row e = (node n, neighbour slot k), with j = eidx[e] local to the
// structure b = n / L and table row t = b*Lk + j (the table holds Lk rows per
// structure: Lk = L on one device; on the graph-parallel route the nodes are a
// shard's L rows and the table the all-gathered structure's Lk rows):
//   enc modes: x = h_V[n]@Wa + e_in[e]@Wb + table[t] + b1
//   dec mode:  x = h_V[n]@Wa + m1d[e]*(e_in[e]@Wb)
//                  + mbw[e]*A[t] + m1d[e]*B[t] + b1,   table = [A | B]
//   m = W3 . gelu(W2 . gelu(x) + b2) + b3          (exact erf GELU)
//   enc-node: out[n] = sum_k mask_att[e]*m / 30     -> [N, H]
//   enc-edge: out[e] = m                            -> [N*K, H]
//   dec:      out[n] = sum_k m / 30 (no mask)       -> [N, H]
// x_out, when not null, receives the pre-GELU x of every edge row [N*K, H]:
// the backward kernel (message_table_bwd.cu) resumes from it, as the TPU
// kernel's save_x output (message_kernels.py:553-567) does.
// The TPU kernel maps a whole structure's table into VMEM and selects rows
// with a one-hot matmul, which is why it needs L % 32 == 0. Here each block
// reads its rows by their flat global index, so any L is taken.
//
// bf16 (message_table_forward_bf16; the TPU kernel's compute_dtype=bfloat16
// branch, message_kernels.py:165, :336-356): every operand, weight and
// output is bf16; x is computed in fp32 from the fp32 fragments and saved
// rounded to bf16; gelu(x) and gelu(y) are rounded to bf16 before the next
// product; the K-sum of the summing modes runs in fp32, in the order
// k = 0..K-1, and is rounded once. Each product sums exact bf16 x bf16
// products in fp32. Every output is the same on every launch (no atomics).
//
// What bounds it on the card: at bf16 the bytes (e_in, the gathered table
// rows, x and the output, about 0.8 KB per edge at H = 128), at fp32 the
// operations (three H x H products per edge, 98 kFLOP at H = 128).
// Design: the tile walk of message_tile.cuh with its kEpiTable epilogues
// (the per-edge store, the K-sum rounded once), one copy shared with the
// fused layer updates (fused_layers.cu) and the pre-gathered message MLP
// (message_mlp.cu). A persistent grid, one block of 512
// threads per SM, walks tiles of 64 edge rows of whole nodes (tn = min(64 /
// K, 16), chosen by the caller); 64 rather than 128 rows so that the dec
// mode's [A | B] rows and the fp32 operands fit beside the weights. The
// four products run on the tensor cores; the bf16 weights stay in shared
// memory, an fp32 weight is staged by cp.async before each product (the
// caller hands over 16-byte aligned weights: a view at any offset of the
// flat parameter vector is copied first), and the next tile's e_in and
// table rows come in by cp.async while this tile's products run.
#include "message_tile.cuh"

namespace {

template <int H, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
message_table_kernel(Params<T> p, int mode) {
  message_tiles<H, kEpiTable>(p, mode);
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, int nblocks, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<H, T>(p.C);
  cudaError_t err = cudaFuncSetAttribute(
      message_table_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.tiles == 0) return 0;
  message_table_kernel<H, T><<<nblocks < p.tiles ? nblocks : p.tiles,
                               kTileThreads, smem, stream>>>(p, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(int mode, const T* h_V, const T* e_in, const T* table,
            const long long* eidx, const T* m_att, const T* mbw, const T* wa,
            const T* wb, const T* b1, const T* w2, const T* b2, const T* w3,
            const T* b3, T* out, T* x_out, int N, int K, int L, int Lk, int H,
            int tn, int nblocks, cudaStream_t stream) {
  if (K < 1 || K > kTileRows || mode < kEncNode || mode > kDec || L < 1 ||
      Lk < 1 || N < 0 || tn < 1 || tn > kMaxTileNodes || tn * K > kTileRows ||
      nblocks < 1)
    return (int)cudaErrorInvalidValue;
  const int C = mode == kDec ? 2 * H : H;
  Params<T> p{h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1, w2, b2, w3, b3,
              out, x_out, nullptr, nullptr, nullptr, N, K, L, Lk, tn,
              (N + tn - 1) / tn, C};
  switch (H) {
    case 32: return launch<32>(p, mode, nblocks, stream);
    case 64: return launch<64>(p, mode, nblocks, stream);
    case 128: return launch<128>(p, mode, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block (bytes) for table width C, for the
// report of a run.
extern "C" int message_table_forward_smem(int H, int C, int low) {
  switch (H) {
    case 32: return (int)(low ? tile_smem_bytes<32, bf16>(C) : tile_smem_bytes<32, float>(C));
    case 64: return (int)(low ? tile_smem_bytes<64, bf16>(C) : tile_smem_bytes<64, float>(C));
    case 128: return (int)(low ? tile_smem_bytes<128, bf16>(C) : tile_smem_bytes<128, float>(C));
    default: return -1;
  }
}

// tn: nodes per tile (tn * K <= 64, tn <= 16; ops/message_kernels.py::
// table_tile_nodes); nblocks: the persistent grid (the SM count). e_in,
// table and the four weights 16-byte aligned.
extern "C" int message_table_forward(
    int mode, const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* wa, const float* wb, const float* b1, const float* w2,
    const float* b2, const float* w3, const float* b3, float* out,
    float* x_out, int N, int K, int L, int Lk, int H, int tn, int nblocks,
    cudaStream_t stream) {
  return forward<float>(mode, h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1,
                        w2, b2, w3, b3, out, x_out, N, K, L, Lk, H, tn, nblocks,
                        stream);
}

// The same with every operand and output bf16.
extern "C" int message_table_forward_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* m_att, const bf16* mbw, const bf16* wa,
    const bf16* wb, const bf16* b1, const bf16* w2, const bf16* b2,
    const bf16* w3, const bf16* b3, bf16* out, bf16* x_out, int N, int K,
    int L, int Lk, int H, int tn, int nblocks, cudaStream_t stream) {
  return forward<bf16>(mode, h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1,
                       w2, b2, w3, b3, out, x_out, N, K, L, Lk, H, tn, nblocks,
                       stream);
}
