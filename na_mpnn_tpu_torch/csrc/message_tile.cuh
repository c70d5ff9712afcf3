// The message MLP's tile walk on the tensor cores: one copy, shared by the
// message-table forward (message_table.cu), the fused layer updates
// (fused_layers.cu) and the pre-gathered message MLP (message_mlp.cu), which
// differ in what they do with a tile's messages (the epilogue, EPI) and in
// where an edge's neighbour term comes from (the operand kind, OP).
//
// OP = kOpTable, the neighbour-table gather inside: per edge row e = (node
// n, neighbour slot k), with j = eidx[e] local to the structure b = n / L
// and table row t = b*Lk + j:
//   enc modes: x = h_V[n]@Wa + e_in[e]@Wb + table[t] + b1
//   dec mode:  x = h_V[n]@Wa + m1d[e]*(e_in[e]@Wb)
//                  + mbw[e]*A[t] + m1d[e]*B[t] + b1,   table = [A | B]
// OP = kOpGathered (contract_e) or kOpGatheredE (without it), the neighbour
// term pre-gathered, row e of G = `table` (C = H; no eidx, no table rows), in
// the enc modes only:
//   x = ((h_V[n]@Wa + G[e]) + b1) + (contract_e ? e_in[e]@Wb : e_in[e])
// (kOpGatheredE adds the tile's e_in rows as they are and skips the Wb
// product and Wb's copy). Then, for every kind,
//   m = W3 . gelu(W2 . gelu(x) + b2) + b3          (exact erf GELU)
// x_out, when not null, receives the pre-GELU x of every edge row.
// Epilogues:
//   kEpiTable (message_table.cu): enc_edge out[e] = m; enc_node out[n] =
//     sum_k mask_att[e]*m / 30; dec out[n] = sum_k m / 30; rounded to T;
//   kEpiSumF32 (the fused node update's message part): the same K-sums of
//     enc_node and dec, kept fp32 (out_f32), as the JAX kernel carries dh
//     into LN1 unrounded;
//   kEpiEdgeLN (the fused edge update): out[e] = LN3(e_in[e] + m), the
//     residual's e_in rows re-read from global memory (L2), since the
//     tile's shared copy is overwritten by the next tile's rows during W2.
// At bf16 every operand, weight and output is bf16, x is computed in fp32
// from the fp32 fragments (saved rounded), gelu(x) and gelu(y) are rounded
// to bf16 before the next product, and the K-sums and LayerNorm run in fp32.
// Every output is the same on every launch (no atomics; the K-sum runs in
// the order k = 0..K-1, the LayerNorm's row sums in a fixed order).
//
// The walk: a persistent grid, one block of 512 threads per SM, over tiles
// of 64 edge rows (tn whole nodes, tn * K <= 64, tn <= 16, chosen by the
// caller), so a node's K-sum never leaves its tile. 16 warps (4 row blocks
// x 4 column quarters) run the four products on the tensor cores (bf16
// mma.sync; 3xTF32 at fp32) from operands in shared memory: h_V@Wa once
// per node (the tile's nodes padded to one 16-row block), then e_in@Wb, W2
// and W3 on the tile's rows. The bf16 weights (Wa, Wb, W2, W3: 136 KB at
// H = 128) stay in shared memory for the block's life; an fp32 weight (68
// KB) is copied in by cp.async before each product, while the previous
// epilogue runs (16-byte aligned weights: the callers copy a view that is
// not). The tile's e_in rows and its gathered table rows come in by
// cp.async one tile ahead: the next tile's e_in rows once this tile's
// e_in@Wb is done, its table rows once
// this tile's x is (fp32) or its last product is (bf16, where the K-sum's
// staging spills over the table buffer). The epilogues work from the fp32
// fragments; the K-sum stages the fp32 messages over the free activation
// buffer (and, at bf16, the table buffer); the LayerNorm exchanges its row
// sums between the four column-quarter warps through a [64][4] buffer.
#pragma once
#include "cp_async.cuh"
#include "message_common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTileRows = 64;
constexpr int kTileThreads = 512;  // 16 warps: 4 row blocks x 4 column quarters
constexpr int kMaxTileNodes = 16;
constexpr float kLnEps = 1e-5f;

constexpr int kEpiTable = 0, kEpiSumF32 = 1, kEpiEdgeLN = 2;
constexpr int kOpTable = 0, kOpGathered = 1, kOpGatheredE = 2;

template <int H, typename T>
__host__ __device__ constexpr size_t tile_smem_bytes(int C) {
  constexpr bool kLow = sizeof(T) == 2;
  return (kLow ? 4 * (size_t)H * (H + 8) * 2 : (size_t)H * (H + 8) * 4)  // weights
         + 2 * (size_t)kTileRows * lda<T>(H) * sizeof(T)               // e_in, u
         + (size_t)kTileRows * lda<T>(C) * sizeof(T)                   // table rows
         + (size_t)kMaxTileNodes * (H + 4) * 4                         // h_V @ Wa
         + (size_t)kMaxTileNodes * lda<T>(H) * sizeof(T)               // h_V rows
         + 5 * (size_t)H * 4                      // b1 | b2 | b3 | LN scale | shift
         + 3 * (size_t)kTileRows * 4              // row masks, table rows
         + 2 * (size_t)kTileRows * 4 * 4;         // LayerNorm row sums
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
  T* out;          // kEpiTable, kEpiEdgeLN
  T* x_out;        // kEpiTable only, may be null
  float* out_f32;  // kEpiSumF32
  const T* ln_s;   // kEpiEdgeLN: LN3 scale and shift
  const T* ln_b;
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

// Start the copies of tile `tile`'s rows of the pre-gathered operand (row e
// of `table`, C wide) into Tab (zero past its rows).
template <typename T>
__device__ __forceinline__ void start_gathered(const Params<T>& p, int tile,
                                               T* Tab) {
  constexpr int EPS = 16 / (int)sizeof(T);
  const int SEG = p.C / EPS, LT = lda<T>(p.C), h = (threadIdx.x % SEG) * EPS;
  const int n0 = tile * p.tn;
  const int rows = min(p.tn, p.N - n0) * p.K;
  const size_t e0 = (size_t)n0 * p.K;
  for (int r = threadIdx.x / SEG; r < kTileRows; r += kTileThreads / SEG) {
    const bool ok = r < rows;
    async_copy16(Tab + r * LT + h, p.table + (ok ? e0 + r : 0) * p.C + h, ok);
  }
}

// The neighbour rows of tile `tile` into Tab, by the operand kind.
template <int OP, typename T>
__device__ __forceinline__ void start_neighbours(const Params<T>& p, int tile,
                                                 const int* trow, T* Tab) {
  if constexpr (OP == kOpTable) start_table(p, tile, trow, Tab);
  else start_gathered(p, tile, Tab);
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

// LayerNorm of the rows r0 and r0 + 8 of a tile whose columns are spread
// over CW column-group warps (cg this warp's, cb its first column, NT
// n-tiles of 8 columns each), from the mma accumulator layout: v[j][0..1]
// are row r0's columns cb + 8j + 2t, +1, v[j][2..3] row r0 + 8's. Two
// passes (mean, then the biased variance of v - mean), each summed within
// the thread, over the 4 lanes of a row by shuffles, then over the CW
// warps' partials in Red [2][rows][CW] in the order 0..CW-1: the same on
// every launch. eps 1e-5; scale / shift [H] fp32. Every thread of the
// block must call it (two barriers); v returns normalised.
template <int NT, int CW>
__device__ __forceinline__ void frag_layer_norm(float (&v)[NT][4], float* Red,
                                                int rows, int r0, int cg, int cb,
                                                const float* scale,
                                                const float* shift) {
  constexpr float inv = 1.0f / (NT * 8 * CW);
  const int t = lane_t();
  float* R1 = Red;
  float* R2 = Red + rows * CW;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) s[hf] += v[j][2 * hf] + v[j][2 * hf + 1];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    s[hf] += __shfl_xor_sync(0xffffffffu, s[hf], 1);
    s[hf] += __shfl_xor_sync(0xffffffffu, s[hf], 2);
    if (t == 0) R1[(r0 + 8 * hf) * CW + cg] = s[hf];
  }
  __syncthreads();
  float mean[2], q[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float m = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) m += R1[(r0 + 8 * hf) * CW + c];
    mean[hf] = m * inv;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float d0 = v[j][2 * hf] - mean[hf], d1 = v[j][2 * hf + 1] - mean[hf];
      q[hf] = fmaf(d0, d0, q[hf]);
      q[hf] = fmaf(d1, d1, q[hf]);
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    q[hf] += __shfl_xor_sync(0xffffffffu, q[hf], 1);
    q[hf] += __shfl_xor_sync(0xffffffffu, q[hf], 2);
    if (t == 0) R2[(r0 + 8 * hf) * CW + cg] = q[hf];
  }
  __syncthreads();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) var += R2[(r0 + 8 * hf) * CW + c];
    const float rstd = rsqrtf(var * inv + kLnEps);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = cb + 8 * j + 2 * t;
      v[j][2 * hf] = (v[j][2 * hf] - mean[hf]) * rstd * scale[c] + shift[c];
      v[j][2 * hf + 1] = (v[j][2 * hf + 1] - mean[hf]) * rstd * scale[c + 1] + shift[c + 1];
    }
  }
}

// The summing modes' epilogue: w * (m) of every row staged fp32 in F
// (w = mask_att in enc_node, 1 in dec, 0 past the tile's rows), then each
// node's K rows summed in the order k = 0..K-1 and stored / 30 to out
// (rounded to its type).
template <int H, int NT, typename T, typename O>
__device__ __forceinline__ void tile_ksum(const Params<T>& p, int mode,
                                          const float (&acc)[NT][4],
                                          const float* b3, const float* Mr,
                                          float* F, O* __restrict__ out, int rb,
                                          int cb, int n0, int nodes, int rows) {
  constexpr int LF = H + 4;
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * rb + g + 8 * hf;
    const float w = r >= rows ? 0.f : (mode == kEncNode ? Mr[r] : 1.f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = cb + 8 * j + 2 * t;
      st2(F + r * LF + c, (acc[j][2 * hf] + b3[c]) * w,
          (acc[j][2 * hf + 1] + b3[c + 1]) * w);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nodes * H; idx += kTileThreads) {
    const int nd = idx / H, h = idx % H;
    float s = 0.f;
    for (int k = 0; k < p.K; ++k) s += F[(nd * p.K + k) * LF + h];
    out[(size_t)(n0 + nd) * H + h] = from_f<O>(s / 30.0f);
  }
  __syncthreads();  // F and Mr are read before they are written again
}

// The walk of block blockIdx.x over tiles blockIdx.x, + gridDim.x, ...
template <int H, int EPI, int OP = kOpTable, typename T>
__device__ __forceinline__ void message_tiles(const Params<T>& p, int mode) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr bool kLn = EPI == kEpiEdgeLN;
  constexpr bool kGathered = OP != kOpTable;
  constexpr bool kWithWb = OP != kOpGatheredE;  // the Wb product and its weight
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
  float* Ln = bias + 3 * H;                   // LN3 scale | shift
  float* Mr = Ln + 2 * H;  // [2][64] the tile's mask_att | mbw (0 past its rows)
  int* Tn = reinterpret_cast<int*>(Mr + 2 * kTileRows);  // [64] next table rows
  float* Red = reinterpret_cast<float*>(Tn + kTileRows);  // [2][64][4] row sums

  const int tid = threadIdx.x, warp = tid >> 5, g = lane_g(), t = lane_t();
  const int rb = warp & 3, cg = warp >> 2, cb = cg * (H / 4);
  const T* wsrc[4] = {p.wa, p.wb, p.w2, p.w3};
  const T* Wa_s = Ws;
  const T* Wb_s = kLow ? Ws + H * LW : Ws;
  const T* W2_s = kLow ? Ws + 2 * H * LW : Ws;
  const T* W3_s = kLow ? Ws + 3 * H * LW : Ws;

  for (int i = tid; i < 3 * H; i += kTileThreads)
    bias[i] = ldf(i < H ? p.b1 + i : i < 2 * H ? p.b2 + i - H : p.b3 + i - 2 * H);
  if constexpr (kLn) {
    for (int i = tid; i < 2 * H; i += kTileThreads)
      Ln[i] = ldf(i < H ? p.ln_s + i : p.ln_b + i - H);
  }
  if constexpr (kLow) {
    for (int idx = tid; idx < H * H; idx += kTileThreads) {
      const int r = idx / H, c = idx % H;  // W[r][c], r the input side
#pragma unroll
      for (int w = 0; w < 4; ++w)
        if (kWithWb || w != 1) Ws[w * H * LW + c * LW + r] = wsrc[w][idx];
    }
  }

  int tile = blockIdx.x;
  if (tile < p.tiles) start_rows<H>(p, tile, Es);
  async_commit();
  if constexpr (!kGathered) {
    if (tid < kTileRows) Tn[tid] = table_row(p, tile, tid);
  }
  __syncthreads();
  if (tile < p.tiles) start_neighbours<OP>(p, tile, Tn, Tab);
  async_commit();
  if constexpr (kWithWb) stage_weight<H>(p.wb, Ws);
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
      if constexpr (!kGathered)
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

    // x = h_V@Wa + e_in@Wb + table + b1 (dec: with the masks; gathered: in
    // its order, the e_in rows themselves without contract_e); gelu(x) to Us
    float acc[NT][4];
    if constexpr (kWithWb) {
      if constexpr (kLow) product<H, NT>(Es, Wb_s, rb, cb, acc);
      else product<H, NT>(Es, Wb_s, false, rb, cb, acc);
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 ev = ld2(Es + (16 * rb + g + 8 * hf) * LA + cb + 8 * j + 2 * t);
          acc[j][2 * hf] = ev.x;
          acc[j][2 * hf + 1] = ev.y;
        }
    }
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
          const float2 tv = ld2(Tab + r * LT + c);
          float x0, x1;
          if constexpr (kGathered) {
            x0 = AI[nd * LF + c] + tv.x;
            x1 = AI[nd * LF + c + 1] + tv.y;
            x0 = x0 + bias[c];
            x1 = x1 + bias[c + 1];
            x0 = x0 + acc[j][2 * hf];
            x1 = x1 + acc[j][2 * hf + 1];
          } else {
            x0 = AI[nd * LF + c] + bias[c];
            x1 = AI[nd * LF + c + 1] + bias[c + 1];
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
          }
          if (EPI == kEpiTable && p.x_out) st2(p.x_out + e * H + c, x0, x1);
          u0 = gelu(x0);
          u1 = gelu(x1);
        }
        st2(Us + r * LA + c, u0, u1);
      }
    if constexpr (!kGathered) {
      if (tid < kTileRows) Tn[tid] = table_row(p, next, tid);  // read past the barrier
    }
    async_wait<1>();  // at fp32 W2
    __syncthreads();
    if constexpr (!kLow) {
      // at fp32 the K-sum's messages fit in Us alone, so Tab is free from
      // here: the next tile's table rows land during this tile's W2 and W3
      if (next < p.tiles) start_neighbours<OP>(p, next, Tn, Tab);
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
    if constexpr (kLn) {
      // out = LN3(e_in + m), the residual re-read from L2
      float v[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          float2 ev = make_float2(0.f, 0.f);
          if (r < rows) ev = ld2(p.e_in + (e0 + r) * H + c);
          v[j][2 * hf] = ev.x + (acc[j][2 * hf] + bias[2 * H + c]);
          v[j][2 * hf + 1] = ev.y + (acc[j][2 * hf + 1] + bias[2 * H + c + 1]);
        }
      frag_layer_norm<NT, 4>(v, Red, kTileRows, 16 * rb + g, cg, cb, Ln, Ln + H);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          if (r < rows) st2(p.out + (e0 + r) * H + c, v[j][2 * hf], v[j][2 * hf + 1]);
        }
    } else if (EPI == kEpiTable && mode == kEncEdge) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = 16 * rb + g + 8 * hf, c = cb + 8 * j + 2 * t;
          if (r < rows)
            st2(p.out + (e0 + r) * H + c, acc[j][2 * hf] + bias[2 * H + c],
                acc[j][2 * hf + 1] + bias[2 * H + c + 1]);
        }
    } else if constexpr (EPI == kEpiSumF32) {
      tile_ksum<H, NT>(p, mode, acc, bias + 2 * H, Mr, F, p.out_f32, rb, cb, n0,
                       nodes, rows);
    } else {
      tile_ksum<H, NT>(p, mode, acc, bias + 2 * H, Mr, F, p.out, rb, cb, n0,
                       nodes, rows);
    }
    if (kLow && next < p.tiles) start_neighbours<OP>(p, next, Tn, Tab);
    async_commit();
    if constexpr (kWithWb) stage_weight<H>(p.wb, Ws);
    async_commit();
  }
  async_wait<0>();
}

}  // namespace
