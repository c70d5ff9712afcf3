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
// Design: a persistent grid, one block of 512 threads per SM, walks tiles of
// 64 edge rows (tn = min(64 / K, 16) nodes, chosen by the caller); 64 rather
// than 128 rows so that the dec mode's [A | B] rows and the fp32 operands
// fit beside the weights. 16 warps (4 row blocks x 4 column quarters) run
// the four products on the tensor cores from operands in shared memory:
// h_V@Wa once per node (the tile's nodes padded to one 16-row block), then
// e_in@Wb, W2 and W3 on the tile's rows. The bf16 weights (Wa, Wb, W2, W3:
// 136 KB at H = 128) stay in shared memory for the block's life; an fp32
// weight (68 KB) is copied in by cp.async before each product, while the
// previous epilogue runs (the caller hands over 16-byte aligned weights: a
// view at any offset of the flat parameter vector is copied first). The
// tile's e_in rows and its gathered table rows come in by cp.async one tile
// ahead: the next tile's e_in rows once this tile's e_in@Wb is done, its
// table rows once this tile's x is (fp32) or its last product is (bf16, where
// the K-sum's staging spills over the table buffer), so each load overlaps
// products. The epilogues work from
// the fp32 fragments; the K-sum stages the fp32 messages over the free
// activation buffer (and, at bf16, the table buffer).
#include "cp_async.cuh"
#include "message_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTileRows = 64;
constexpr int kTileThreads = 512;  // 16 warps: 4 row blocks x 4 column quarters
constexpr int kMaxTileNodes = 16;

template <int H, typename T>
__host__ __device__ constexpr size_t smem_bytes(int C) {
  constexpr bool kLow = sizeof(T) == 2;
  return (kLow ? 4 * (size_t)H * (H + 8) * 2 : (size_t)H * (H + 8) * 4)  // weights
         + 2 * (size_t)kTileRows * lda<T>(H) * sizeof(T)               // e_in, u
         + (size_t)kTileRows * lda<T>(C) * sizeof(T)                   // table rows
         + (size_t)kMaxTileNodes * (H + 4) * 4                         // h_V @ Wa
         + (size_t)kMaxTileNodes * lda<T>(H) * sizeof(T)               // h_V rows
         + 3 * (size_t)H * 4                                           // b1 | b2 | b3
         + 3 * (size_t)kTileRows * 4;                                  // row masks, table rows
}

template <typename T>
struct Params {
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
  T* out;
  T* x_out;
  int N, K, L, Lk, tn, tiles, C;
};

// Start the copies of tile `tile`'s e_in rows into Es (zero past its rows).
template <int H, typename T>
__device__ __forceinline__ void start_rows(const Params<T>& p, int tile, T* Es) {
  constexpr int EPS = 16 / (int)sizeof(T), SEG = H / EPS, LA = lda<T>(H);
  const int n0 = tile * p.tn;
  const int rows = min(p.tn, p.N - n0) * p.K;
  const size_t e0 = (size_t)n0 * p.K;
  for (int i = threadIdx.x; i < kTileRows * SEG; i += kTileThreads) {
    const int r = i / SEG, h = (i % SEG) * EPS;
    const bool ok = r < rows;
    async_copy16(Es + r * LA + h, p.e_in + (ok ? e0 + r : 0) * H + h, ok);
  }
}

// Row r of tile `tile` reads table row (n / L) * Lk + eidx[e], n its node
// and e its edge row (0 past the tile's rows).
template <typename T>
__device__ __forceinline__ int table_row(const Params<T>& p, int tile, int r) {
  const int n0 = tile * p.tn;
  if (r >= min(p.tn, p.N - n0) * p.K) return 0;
  return (n0 + r / p.K) / p.L * p.Lk + (int)p.eidx[(size_t)n0 * p.K + r];
}

// Start the copies of tile `tile`'s gathered table rows (C wide) into Tab,
// trow[r] the table row of its row r (zero past its rows). A thread copies
// one 16-byte segment of every (threads / segments)-th row.
template <typename T>
__device__ __forceinline__ void start_table(const Params<T>& p, int tile,
                                            const int* trow, T* Tab) {
  constexpr int EPS = 16 / (int)sizeof(T);
  const int SEG = p.C / EPS, LT = lda<T>(p.C), h = (threadIdx.x % SEG) * EPS;
  const int rows = min(p.tn, p.N - tile * p.tn) * p.K;
  for (int r = threadIdx.x / SEG; r < kTileRows; r += kTileThreads / SEG) {
    const bool ok = r < rows;
    async_copy16(Tab + r * LT + h, p.table + (size_t)trow[r] * p.C + h, ok);
  }
}

// Start the copy of an fp32 weight [H, H] (16-byte aligned) into Wf
// [k][H + 8].
template <int H>
__device__ __forceinline__ void stage_weight(const float* __restrict__ W, float* Wf) {
  constexpr int LW = H + 8;
  for (int idx = 4 * threadIdx.x; idx < H * H; idx += 4 * kTileThreads)
    async_copy16(Wf + (idx / H) * LW + idx % H, W + idx, true);
}
template <int H>
__device__ __forceinline__ void stage_weight(const bf16*, bf16*) {}

// The node term of 16 rows (the tile's nodes, zero-padded) for the 8
// columns at n0: HV @ Wa. bf16: Wa resident [n][k]; fp32: Wa [k][n] read
// from global memory (one n-tile per warp, once per tile; the loop is
// unrolled whole, so that all its loads are in flight at once).
template <int H>
__device__ __forceinline__ void node_product(const bf16* HV, const bf16* Was,
                                             const bf16*, int n0, float (&acc)[4]) {
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t a[4];
    frag_a_bf16(a, HV, lda<bf16>(H), 0, k0);
    const bf16* b = Was + (n0 + g) * (H + 8) + k0 + 2 * t;
    mma_bf16(acc, a, ld_pair(b), ld_pair(b + 8));
  }
}

template <int H>
__device__ __forceinline__ void node_product(const float* HV, const float*,
                                             const float* __restrict__ wa, int n0,
                                             float (&acc)[4]) {
  constexpr int LA = lda<float>(H);
  const int g = lane_g(), t = lane_t();
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < H; k0 += 8) {
    const float* pa = HV + g * LA + k0 + t;
    const float af[4] = {pa[0], pa[8 * LA], pa[4], pa[8 * LA + 4]};
    SplitA a;
    a.set(af);
    const float* b = wa + (size_t)(k0 + t) * H + n0 + g;
    mma_3xtf32(acc, a, __ldg(b), __ldg(b + 4 * H));
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(kTileThreads, 1)
message_table_kernel(Params<T> p, int mode) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int LA = lda<T>(H), LF = H + 4, LW = H + 8, NT = H / 32;
  const int LT = lda<T>(p.C);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q = smem;
  T* Ws = reinterpret_cast<T*>(q);  // bf16: Wa, Wb, W2, W3 [n][k]; fp32: one [k][n]
  q += kLow ? 4 * H * LW * sizeof(T) : H * LW * sizeof(T);
  T* Es = reinterpret_cast<T*>(q);  // [64][LA] e_in rows
  q += kTileRows * LA * sizeof(T);
  T* Us = reinterpret_cast<T*>(q);  // [64][LA] gelu(x), then gelu(y)
  float* F = reinterpret_cast<float*>(q);  // [64][LF] messages, over Us (bf16: and Tab)
  q += kTileRows * LA * sizeof(T);
  T* Tab = reinterpret_cast<T*>(q);  // [64][LT] gathered table rows
  q += (size_t)kTileRows * LT * sizeof(T);
  float* AI = reinterpret_cast<float*>(q);  // [16][LF] h_V @ Wa
  q += kMaxTileNodes * LF * sizeof(float);
  T* HV = reinterpret_cast<T*>(q);  // [16][LA] h_V rows
  q += kMaxTileNodes * LA * sizeof(T);
  float* bias = reinterpret_cast<float*>(q);  // b1 | b2 | b3
  float* Mr = bias + 3 * H;  // [2][64] the tile's mask_att | mbw (0 past its rows)
  int* Tn = reinterpret_cast<int*>(Mr + 2 * kTileRows);  // [64] next table rows

  const int tid = threadIdx.x, warp = tid >> 5, g = lane_g(), t = lane_t();
  const int rb = warp & 3, cb = (warp >> 2) * (H / 4);
  const T* wsrc[4] = {p.wa, p.wb, p.w2, p.w3};
  const T* Wa_s = Ws;
  const T* Wb_s = kLow ? Ws + H * LW : Ws;
  const T* W2_s = kLow ? Ws + 2 * H * LW : Ws;
  const T* W3_s = kLow ? Ws + 3 * H * LW : Ws;

  for (int i = tid; i < 3 * H; i += kTileThreads)
    bias[i] = ldf(i < H ? p.b1 + i : i < 2 * H ? p.b2 + i - H : p.b3 + i - 2 * H);
  if constexpr (kLow) {
    for (int idx = tid; idx < H * H; idx += kTileThreads) {
      const int r = idx / H, c = idx % H;  // W[r][c], r the input side
#pragma unroll
      for (int w = 0; w < 4; ++w) Ws[w * H * LW + c * LW + r] = wsrc[w][idx];
    }
  }

  int tile = blockIdx.x;
  if (tile < p.tiles) start_rows<H>(p, tile, Es);
  async_commit();
  if (tid < kTileRows) Tn[tid] = table_row(p, tile, tid);
  __syncthreads();
  if (tile < p.tiles) start_table(p, tile, Tn, Tab);
  async_commit();
  stage_weight<H>(p.wb, Ws);
  async_commit();

  for (; tile < p.tiles; tile += gridDim.x) {
    const int n0 = tile * p.tn;
    const int nodes = min(p.tn, p.N - n0);
    const int rows = nodes * p.K;
    const size_t e0 = (size_t)n0 * p.K;
    const int next = tile + gridDim.x;

    for (int idx = tid; idx < kMaxTileNodes * H; idx += kTileThreads) {
      const int r = idx / H, h = idx % H;
      HV[r * LA + h] = r < nodes ? p.h_V[(size_t)(n0 + r) * H + h] : from_f<T>(0.f);
    }
    if (mode != kEncEdge && tid < kTileRows) {
      Mr[tid] = tid < rows ? to_f(p.m_att[e0 + tid]) : 0.f;
      Mr[kTileRows + tid] = tid < rows ? to_f(p.mbw[e0 + tid]) : 0.f;
    }
    async_wait<2>();  // this tile's e_in rows
    __syncthreads();

    // the node term, one n-tile per warp
    if (warp < H / 8) {
      float nacc[4];
      node_product<H>(HV, Wa_s, p.wa, 8 * warp, nacc);
      st2(AI + g * LF + 8 * warp + 2 * t, nacc[0], nacc[1]);
      st2(AI + (g + 8) * LF + 8 * warp + 2 * t, nacc[2], nacc[3]);
    }
    async_wait<0>();  // this tile's table rows; at fp32 Wb
    __syncthreads();

    // x = h_V@Wa + e_in@Wb + table + b1 (dec: with the masks); gelu(x) to Us
    float acc[NT][4];
    if constexpr (kLow) product<H, NT>(Es, Wb_s, rb, cb, acc);
    else product<H, NT>(Es, Wb_s, false, rb, cb, acc);
    __syncthreads();  // Es and the fp32 weight buffer are free
    stage_weight<H>(p.w2, Ws);
    async_commit();
    if (next < p.tiles) start_rows<H>(p, next, Es);
    async_commit();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        float u0 = 0.f, u1 = 0.f;
        if (r < rows) {
          const size_t e = e0 + r;
          const int nd = r / p.K;
          float x0 = AI[nd * LF + c] + bias[c], x1 = AI[nd * LF + c + 1] + bias[c + 1];
          const float2 tv = ld2(Tab + r * LT + c);
          if (mode == kDec) {
            const float m1 = Mr[r], mb = Mr[kTileRows + r];
            const float2 bv = ld2(Tab + r * LT + H + c);
            x0 = x0 + m1 * acc[j][2 * hf];
            x1 = x1 + m1 * acc[j][2 * hf + 1];
            x0 = x0 + mb * tv.x;
            x1 = x1 + mb * tv.y;
            x0 = x0 + m1 * bv.x;
            x1 = x1 + m1 * bv.y;
          } else {
            x0 = x0 + acc[j][2 * hf] + tv.x;
            x1 = x1 + acc[j][2 * hf + 1] + tv.y;
          }
          if (p.x_out) st2(p.x_out + e * H + c, x0, x1);
          u0 = gelu(x0);
          u1 = gelu(x1);
        }
        st2(Us + r * LA + c, u0, u1);
      }
    if (tid < kTileRows) Tn[tid] = table_row(p, next, tid);  // read past the barrier
    async_wait<1>();  // at fp32 W2
    __syncthreads();
    if constexpr (!kLow) {
      // at fp32 the K-sum's messages fit in Us alone, so Tab is free from
      // here: the next tile's table rows land during this tile's W2 and W3
      if (next < p.tiles) start_table(p, next, Tn, Tab);
      async_commit();
    }

    // gelu(gelu(x)@W2 + b2) to Us
    if constexpr (kLow) product<H, NT>(Us, W2_s, rb, cb, acc);
    else product<H, NT>(Us, W2_s, false, rb, cb, acc);
    __syncthreads();
    stage_weight<H>(p.w3, Ws);
    async_commit();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
        st2(Us + r * LA + c, gelu(acc[j][2 * hf] + bias[H + c]),
            gelu(acc[j][2 * hf + 1] + bias[H + c + 1]));
      }
    async_wait<0>();  // at fp32 W3 and the next tile's table rows; its e_in rows
    __syncthreads();

    // m = u2@W3 + b3
    if constexpr (kLow) product<H, NT>(Us, W3_s, rb, cb, acc);
    else product<H, NT>(Us, W3_s, false, rb, cb, acc);
    __syncthreads();  // Us and the fp32 weight buffer are free (bf16: Tab too)
    if (mode == kEncEdge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          if (r < rows)
            st2(p.out + (e0 + r) * H + c, acc[j][2 * hf] + bias[2 * H + c],
                acc[j][2 * hf + 1] + bias[2 * H + c + 1]);
        }
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * rb + g + 8 * hf;
        const float w = r >= rows ? 0.f : (mode == kEncNode ? Mr[r] : 1.f);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = cb + 8 * j + 2 * t;
          st2(F + r * LF + c, (acc[j][2 * hf] + bias[2 * H + c]) * w,
              (acc[j][2 * hf + 1] + bias[2 * H + c + 1]) * w);
        }
      }
      __syncthreads();
      for (int idx = tid; idx < nodes * H; idx += kTileThreads) {
        const int nd = idx / H, h = idx % H;
        float s = 0.f;
        for (int k = 0; k < p.K; ++k) s += F[(nd * p.K + k) * LF + h];
        p.out[(size_t)(n0 + nd) * H + h] = from_f<T>(s / 30.0f);
      }
      __syncthreads();  // F and Mr are read before they are written again
    }
    if constexpr (kLow) {
      if (next < p.tiles) start_table(p, next, Tn, Tab);
      async_commit();
    }
    stage_weight<H>(p.wb, Ws);
    async_commit();
  }
  async_wait<0>();
}

template <int H, typename T>
int launch(const Params<T>& p, int mode, int nblocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<H, T>(p.C);
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
  Params<T> p{h_V, e_in, table, eidx, m_att, mbw, wa, wb, b1, w2, b2,
              w3,  b3,   out,   x_out, N,   K,   L,  Lk, tn, (N + tn - 1) / tn, C};
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
    case 32: return (int)(low ? smem_bytes<32, bf16>(C) : smem_bytes<32, float>(C));
    case 64: return (int)(low ? smem_bytes<64, bf16>(C) : smem_bytes<64, float>(C));
    case 128: return (int)(low ? smem_bytes<128, bf16>(C) : smem_bytes<128, float>(C));
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
