// Fused inference layer updates for Hopper (sm_90a): the node update of an
// encoder or parallel-decoder layer, and the encoder's edge update; fp32,
// and bf16 for the bf16 trunk. Products on the tensor cores (mma.cuh):
// bf16 mma.sync for the bf16 variants, 3xTF32 at fp32.
//
// Replaces the TPU kernels na_mpnn_tpu/ops/fused_layers.py::
// fused_node_update (:152, _node_update_kernel) and fused_edge_update (:187,
// _edge_update_kernel). The TPU kernels read a pre-gathered neighbour
// operand G [N*K, H] that XLA builds before every call; these read the node
// table by global row (n / L) * Lk + eidx[e] inside the kernel, as
// message_table.cu does, so they take any L and the graph-parallel route's
// all-gathered table (Lk key rows against a shard's L query rows).
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
// LayerNorm: eps 1e-5, biased variance, statistics in fp32, two passes
// (mean, then the variance of the centred row).
//
// bf16 (fused_node_update_bf16, fused_edge_update_bf16; the TPU kernels'
// bf16 branch, fused_layers.py:47-59, :80-117): operands, parameters and
// outputs bf16; every product on bf16-rounded operands (gelu(x), gelu(y),
// LN1's output as the FFN input, the FFN hidden) summed in fp32; the message
// sum, both LayerNorms with their statistics and residuals in fp32; the
// output rounded once.
//
// What bounds it on the card: at fp32 the operations (three H x H products
// per edge, 98 kFLOP at H = 128, and 16 H^2 per node for the feed-forward
// block), at bf16 the bytes (e_in, the gathered table rows and, in the
// edge update, the output: about 0.5-0.8 KB per edge).
//
// Design. The message part is message_table.cu's tile walk
// (message_tile.cuh), one copy with another epilogue: a persistent grid of
// one 512-thread block per SM over 64-row tiles of whole nodes, the four
// products on the tensor cores, bf16 weights resident in shared memory and
// fp32 weights staged per product, the next tile's e_in and table rows by
// cp.async one tile ahead.
// - The edge update's epilogue is LN3(e_in + m) from the fp32 fragments,
//   its row sums exchanged between the four column-quarter warps; the
//   residual's e_in rows are re-read from L2 (keeping them in shared memory
//   would hold the next tile's e_in prefetch back until after the epilogue;
//   PERF.md section 6 has both timed).
// - The node update runs in two launches. The first is the walk with the
//   K-sum epilogue writing dh [N, H] fp32 to scratch (the JAX kernel
//   carries dh into LN1 unrounded). A 64-row tile holds only 2 nodes at
//   K = 32, and W_in and W_out (128 KB each at bf16, H = 128) do not fit
//   beside the message weights, so the tail is a second launch over tiles
//   of TM = 16, 32 or 64 nodes (the wrapper's choice for N): LN1 from h_V +
//   dh (one warp per node), then the feed-forward block on the tensor cores
//   in four quarters of the hidden width, gelu(h @ W_in[:, q]) staged in
//   shared memory and multiplied by W_out[q, :] into fp32 accumulators that
//   stay in registers; W_in and W_out stream through a two-slot ring of
//   H x H quarters by cp.async, each quarter's copy overlapping the other
//   slot's product (and the ring runs on into the next tile); LN2 and the
//   mask from the fragments as in the edge update.
// Every output is the same on every launch (no atomics, fixed orders).
#include "message_tile.cuh"

namespace {

template <typename T>
struct Tail {
  const T* h_V;
  const float* dh;
  const T* mask;
  const T* n1s;
  const T* n1b;
  const T* w_in;
  const T* b_in;
  const T* w_out;
  const T* b_out;
  const T* n2s;
  const T* n2b;
  T* out;
  int N, tiles;
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

template <int H, int RB, typename T>
__host__ __device__ constexpr size_t tail_smem_bytes() {
  constexpr int TM = 16 * RB, CW = 16 / RB;
  return 2 * (size_t)H * (H + 8) * sizeof(T)                     // weight ring
         + (size_t)TM * (H + 4) * 4                              // h (fp32)
         + (sizeof(T) == 2 ? (size_t)TM * lda<T>(H) * sizeof(T) : 0)  // bf16(h)
         + (size_t)TM * lda<T>(H) * sizeof(T)                    // hidden quarter
         + 9 * (size_t)H * 4                                     // vectors
         + 2 * (size_t)TM * CW * 4;                              // LN2 row sums
}

// Start the copy of ring stage s into its slot (s & 1) of Wr [2][H][H + 8]:
// even stages W_in[:, qH:(q+1)H], odd ones W_out[qH:(q+1)H, :], q = s/2 % 4,
// each as [k][n].
template <int H, typename T>
__device__ __forceinline__ void stage_ffn(const Tail<T>& q, int s, T* Wr) {
  constexpr int EPS = 16 / (int)sizeof(T), SEG = H / EPS, LW = H + 8;
  const int quarter = (s >> 1) & 3;
  const bool is_out = s & 1;
  const T* src = is_out ? q.w_out + (size_t)quarter * H * H : q.w_in + quarter * H;
  const int ld = is_out ? H : 4 * H;
  T* dst = Wr + (s & 1) * H * LW;
  for (int i = threadIdx.x; i < H * SEG; i += kTileThreads) {
    const int k = i / SEG, c = (i % SEG) * EPS;
    async_copy16(dst + k * LW + c, src + (size_t)k * ld + c, true);
  }
}

// The node update's tail over tiles of TM = 16 RB nodes: 16 warps as RB row
// blocks x CW = 16 / RB column groups, NT n-tiles of 8 columns each.
template <int H, int RB, typename T>
__global__ void __launch_bounds__(kTileThreads, 1) node_tail_kernel(Tail<T> q) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int TM = 16 * RB, CW = 16 / RB, NT = H / (8 * CW), CPT = H / 32;
  constexpr int LH = H + 4, LA = lda<T>(H), LW = H + 8;
  static_assert(NT >= 1, "tail tile too small for H");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sp = smem;
  T* Wr = reinterpret_cast<T*>(sp);  // [2][H][LW] W_in | W_out quarters
  sp += 2 * H * LW * sizeof(T);
  float* Hs = reinterpret_cast<float*>(sp);  // [TM][LH] h = LN1(h_V + dh)
  sp += TM * LH * 4;
  T* As = reinterpret_cast<T*>(Hs);  // the FFN input: h (fp32), bf16(h) [TM][LA]
  if constexpr (kLow) {
    As = reinterpret_cast<T*>(sp);
    sp += TM * LA * sizeof(T);
  }
  T* Fs = reinterpret_cast<T*>(sp);  // [TM][LA] gelu(h @ W_in[:, q] + b_in)
  sp += TM * LA * sizeof(T);
  float* vec = reinterpret_cast<float*>(sp);  // b_in [4H] | b_out | n1 s, b | n2 s, b
  float* Red = vec + 9 * H;                   // [2][TM][CW]
  const float* b_in = vec;
  const float* b_out = vec + 4 * H;
  const float* n1s = vec + 5 * H;
  const float* n1b = vec + 6 * H;
  const float* n2s = vec + 7 * H;
  const float* n2b = vec + 8 * H;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane_g(), t = lane_t();
  const int rb = warp % RB, cg = warp / RB, cb = cg * (H / CW);
  for (int i = tid; i < 9 * H; i += kTileThreads) {
    const T* src = i < 4 * H   ? q.b_in + i
                   : i < 5 * H ? q.b_out + i - 4 * H
                   : i < 6 * H ? q.n1s + i - 5 * H
                   : i < 7 * H ? q.n1b + i - 6 * H
                   : i < 8 * H ? q.n2s + i - 7 * H
                               : q.n2b + i - 8 * H;
    vec[i] = ldf(src);
  }
  int s = 0;
  stage_ffn<H>(q, 0, Wr);
  async_commit();
  stage_ffn<H>(q, 1, Wr);
  async_commit();
  __syncthreads();

  for (int tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    const int n0 = tile * TM;
    // h = LN1(h_V + dh): one warp per node, lane owns columns lane + 32c
    for (int r = warp; r < TM; r += kTileThreads / 32) {
      const int n = n0 + r;
      float v[CPT];
      if (n < q.N) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const size_t i = (size_t)n * H + lane + 32 * c;
          v[c] = to_f(q.h_V[i]) + q.dh[i];
        }
        float mean, rstd;
        ln_stats<CPT>(v, mean, rstd);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int h = lane + 32 * c;
          v[c] = (v[c] - mean) * rstd * n1s[h] + n1b[h];
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c) v[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        Hs[r * LH + lane + 32 * c] = v[c];
        if constexpr (kLow) As[r * LA + lane + 32 * c] = from_f<T>(v[c]);
      }
    }

    // the feed-forward block in four quarters of the hidden width
    float o[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int qq = 0; qq < 4; ++qq) {
      float acc[NT][4];
      async_wait<1>();  // W_in quarter qq
      __syncthreads();
      if constexpr (kLow) product_kn<H, NT>(As, Wr, rb, cb, acc);
      else product<H, NT>(As, Wr, false, rb, cb, acc);
      __syncthreads();  // its slot is free
      stage_ffn<H>(q, s + 2, Wr);
      async_commit();
      ++s;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          st2(Fs + r * LA + c, gelu(acc[j][2 * hf] + b_in[qq * H + c]),
              gelu(acc[j][2 * hf + 1] + b_in[qq * H + c + 1]));
        }
      async_wait<1>();  // W_out quarter qq
      __syncthreads();
      if constexpr (kLow) product_kn<H, NT>(Fs, Wr + H * LW, rb, cb, acc);
      else product<H, NT>(Fs, Wr + H * LW, false, rb, cb, acc);
      __syncthreads();  // its slot and Fs are free
      stage_ffn<H>(q, s + 2, Wr);
      async_commit();
      ++s;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) o[j][k] += acc[j][k];
    }

    // LN2 of h + ffn, then the node mask
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        o[j][2 * hf] = Hs[r * LH + c] + (o[j][2 * hf] + b_out[c]);
        o[j][2 * hf + 1] = Hs[r * LH + c + 1] + (o[j][2 * hf + 1] + b_out[c + 1]);
      }
    frag_layer_norm<NT, CW>(o, Red, TM, 16 * rb + g, cg, cb, n2s, n2b);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + 16 * rb + g + 8 * hf;
      if (n >= q.N) continue;
      const float m = to_f(q.mask[n]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = cb + 8 * j + 2 * t;
        st2(q.out + (size_t)n * H + c, m * o[j][2 * hf], m * o[j][2 * hf + 1]);
      }
    }
  }
  async_wait<0>();
}

template <int H, int EPI, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
fused_message_kernel(Params<T> p, int mode) {
  message_tiles<H, EPI>(p, mode);
}

template <int H, int EPI, typename T>
int launch_walk(const Params<T>& p, int mode, int nblocks, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<H, T>(p.C);
  cudaError_t err = cudaFuncSetAttribute(fused_message_kernel<H, EPI, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_message_kernel<H, EPI, T><<<nblocks < p.tiles ? nblocks : p.tiles,
                                    kTileThreads, smem, stream>>>(p, mode);
  return (int)cudaGetLastError();
}

template <int H, int RB, typename T>
int launch_tail(Tail<T> q, int nblocks, cudaStream_t stream) {
  const size_t smem = tail_smem_bytes<H, RB, T>();
  cudaError_t err = cudaFuncSetAttribute(node_tail_kernel<H, RB, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  q.tiles = (q.N + 16 * RB - 1) / (16 * RB);
  node_tail_kernel<H, RB, T><<<nblocks < q.tiles ? nblocks : q.tiles, kTileThreads,
                               smem, stream>>>(q);
  return (int)cudaGetLastError();
}

// rows: the tail's nodes per tile, 16, 32 or 64 (at least 128 / H * 16).
template <int H, typename T>
int launch_tail_rows(const Tail<T>& q, int rows, int nblocks, cudaStream_t stream) {
  switch (rows) {
    case 16:
      if constexpr (H >= 128) return launch_tail<H, 1>(q, nblocks, stream);
      break;
    case 32:
      if constexpr (H >= 64) return launch_tail<H, 2>(q, nblocks, stream);
      break;
    case 64: return launch_tail<H, 4>(q, nblocks, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int H, typename T>
int node_update_h(const Params<T>& p, const Tail<T>& q, int mode, int nblocks,
                  int tail_rows, cudaStream_t stream) {
  const int err = launch_walk<H, kEpiSumF32>(p, mode, nblocks, stream);
  return err ? err : launch_tail_rows<H>(q, tail_rows, nblocks, stream);
}

bool bad_walk(int N, int K, int L, int Lk, int tn, int nblocks) {
  return K < 1 || K > kTileRows || L < 1 || Lk < 1 || N < 1 || tn < 1 ||
         tn > kMaxTileNodes || tn * K > kTileRows || nblocks < 1;
}

template <typename T>
int node_update(int mode, const T* h_V, const T* e_in, const T* table,
                const long long* eidx, const T* m_att, const T* mbw,
                const T* mask, const T* wa, const T* wb, const T* b1,
                const T* w2, const T* b2, const T* w3, const T* b3,
                const T* n1s, const T* n1b, const T* w_in, const T* b_in,
                const T* w_out, const T* b_out, const T* n2s, const T* n2b,
                float* dh, T* out, int N, int K, int L, int Lk, int H, int tn,
                int nblocks, int tail_rows, cudaStream_t stream) {
  if (bad_walk(N, K, L, Lk, tn, nblocks) || (mode != kEncNode && mode != kDec))
    return (int)cudaErrorInvalidValue;
  const int C = mode == kDec ? 2 * H : H;
  const Params<T> p{h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1, w2, b2, w3,
                    b3, nullptr, nullptr, dh, nullptr, nullptr, N, K, L, Lk, tn,
                    (N + tn - 1) / tn, C};
  const Tail<T> q{h_V, dh, mask, n1s, n1b, w_in, b_in, w_out, b_out, n2s, n2b,
                  out, N, 0};
  switch (H) {
    case 32: return node_update_h<32>(p, q, mode, nblocks, tail_rows, stream);
    case 64: return node_update_h<64>(p, q, mode, nblocks, tail_rows, stream);
    case 128: return node_update_h<128>(p, q, mode, nblocks, tail_rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int edge_update(const T* h_V, const T* e_in, const T* table,
                const long long* eidx, const T* wa, const T* wb, const T* b1,
                const T* w2, const T* b2, const T* w3, const T* b3,
                const T* n3s, const T* n3b, T* out, int N, int K, int L,
                int Lk, int H, int tn, int nblocks, cudaStream_t stream) {
  if (bad_walk(N, K, L, Lk, tn, nblocks)) return (int)cudaErrorInvalidValue;
  const Params<T> p{h_V, e_in, table, eidx, nullptr, nullptr, wa, wb, b1, w2, b2,
                    w3, b3, out, nullptr, nullptr, n3s, n3b, N, K, L, Lk, tn,
                    (N + tn - 1) / tn, H};
  switch (H) {
    case 32: return launch_walk<32, kEpiEdgeLN>(p, kEncEdge, nblocks, stream);
    case 64: return launch_walk<64, kEpiEdgeLN>(p, kEncEdge, nblocks, stream);
    case 128: return launch_walk<128, kEpiEdgeLN>(p, kEncEdge, nblocks, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H>
int tail_smem(int rows, int low) {
  switch (rows) {
    case 16:
      if constexpr (H >= 128)
        return (int)(low ? tail_smem_bytes<H, 1, bf16>() : tail_smem_bytes<H, 1, float>());
      break;
    case 32:
      if constexpr (H >= 64)
        return (int)(low ? tail_smem_bytes<H, 2, bf16>() : tail_smem_bytes<H, 2, float>());
      break;
    case 64:
      return (int)(low ? tail_smem_bytes<H, 4, bf16>() : tail_smem_bytes<H, 4, float>());
  }
  return -1;
}

}  // namespace

// Dynamic shared memory of one block of the node update's tail (bytes) at
// `rows` nodes per tile, for the report of a run (the message part's is
// message_table_forward_smem's).
extern "C" int fused_node_tail_smem(int H, int rows, int low) {
  switch (H) {
    case 32: return tail_smem<32>(rows, low);
    case 64: return tail_smem<64>(rows, low);
    case 128: return tail_smem<128>(rows, low);
    default: return -1;
  }
}

// mode: 0 = encoder node update (m_att masks the messages, mbw unread),
// 2 = decoder node update (m_att carries m1d). dh: fp32 scratch [N, H]
// between the two launches. tn: nodes per message tile (tn * K <= 64, tn
// <= 16); nblocks: the persistent grid (the SM count); tail_rows: nodes per
// tail tile (16, 32, 64). e_in, table and the six weights 16-byte aligned.
extern "C" int fused_node_update(
    int mode, const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* m_att, const float* mbw,
    const float* mask, const float* wa, const float* wb, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* n1s, const float* n1b, const float* w_in, const float* b_in,
    const float* w_out, const float* b_out, const float* n2s, const float* n2b,
    float* dh, float* out, int N, int K, int L, int Lk, int H, int tn,
    int nblocks, int tail_rows, cudaStream_t stream) {
  return node_update<float>(mode, h_V, e_in, table, eidx, m_att, mbw, mask, wa,
                            wb, b1, w2, b2, w3, b3, n1s, n1b, w_in, b_in, w_out,
                            b_out, n2s, n2b, dh, out, N, K, L, Lk, H, tn,
                            nblocks, tail_rows, stream);
}

// The same with every operand, parameter and the output bf16 (dh fp32).
extern "C" int fused_node_update_bf16(
    int mode, const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* m_att, const bf16* mbw,
    const bf16* mask, const bf16* wa, const bf16* wb, const bf16* b1,
    const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
    const bf16* n1s, const bf16* n1b, const bf16* w_in, const bf16* b_in,
    const bf16* w_out, const bf16* b_out, const bf16* n2s, const bf16* n2b,
    float* dh, bf16* out, int N, int K, int L, int Lk, int H, int tn,
    int nblocks, int tail_rows, cudaStream_t stream) {
  return node_update<bf16>(mode, h_V, e_in, table, eidx, m_att, mbw, mask, wa,
                           wb, b1, w2, b2, w3, b3, n1s, n1b, w_in, b_in, w_out,
                           b_out, n2s, n2b, dh, out, N, K, L, Lk, H, tn,
                           nblocks, tail_rows, stream);
}

extern "C" int fused_edge_update(
    const float* h_V, const float* e_in, const float* table,
    const long long* eidx, const float* wa, const float* wb, const float* b1,
    const float* w2, const float* b2, const float* w3, const float* b3,
    const float* n3s, const float* n3b, float* out, int N, int K, int L,
    int Lk, int H, int tn, int nblocks, cudaStream_t stream) {
  return edge_update<float>(h_V, e_in, table, eidx, wa, wb, b1, w2, b2, w3, b3,
                            n3s, n3b, out, N, K, L, Lk, H, tn, nblocks, stream);
}

extern "C" int fused_edge_update_bf16(
    const bf16* h_V, const bf16* e_in, const bf16* table,
    const long long* eidx, const bf16* wa, const bf16* wb, const bf16* b1,
    const bf16* w2, const bf16* b2, const bf16* w3, const bf16* b3,
    const bf16* n3s, const bf16* n3b, bf16* out, int N, int K, int L,
    int Lk, int H, int tn, int nblocks, cudaStream_t stream) {
  return edge_update<bf16>(h_V, e_in, table, eidx, wa, wb, b1, w2, b2, w3, b3,
                           n3s, n3b, out, N, K, L, Lk, H, tn, nblocks, stream);
}
