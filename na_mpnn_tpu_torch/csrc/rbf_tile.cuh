// The tensor-core walks of the four RBF projection kernels over each edge's
// atom-pair groups: the forward walk (rbf_fwd_groups) of the classed and the
// dense projection (rbf_classed.cu, row 3; rbf_edge.cu, row 5) and the
// weight-gradient walk (rbf_dw_groups) of both (rbf_classed_dw.cu, row 4;
// rbf_edge_dw.cu, row 6). Each source instantiates a walk with its kind of
// bin (rbf_common.cuh::BinKind), which also sets the operand type: fp32
// products in 3xTF32 for kExact, bf16 mma.sync for kDamped and kExactBf16
// (mma.cuh). At fp32 rows 3 and 5 (and 4 and 6) are one instantiation, and
// on the same operands give the same bits.
//
// The function, at every kind: out[e] = bins(e) @ W over the 18 x 18 atom
// pairs x 16 bins of edge e, and dW = bins^T @ g. The atom slots are
// host-permuted (ops/rbf_common.py::PERM) so the protein block P (5 slots)
// and the nucleic block N (13 slots) are contiguous; the [18*18*16, H]
// weight splits into the four group tables PP (400 rows), PN (1040), NP
// (1040), NN (2704), one after another, each pair-major (row pair*16 + r,
// pair = q*An + n; ops/rbf_common.py::_pair_row_map). Every pair of a group
// an edge does not feed has an absent atom, so skipping the group skips
// only exact zeros: the dense function is the classed one's at fp32.
//
// Edge e feeds group g = 2*a + b for every side a of its query residue and
// b of its key residue (a residue with atoms in both blocks has both sides;
// one with no atom counts as P; ops/rbf_common.py::edge_groups).
//
// Forward (rbf_fwd_groups): the caller gives each edge its list (0-3 the one
// group it feeds, 4 several; rbf_classed.cu's classify kernel) and sorts
// the edges stably by list (edge_tile_order), so every edge lies in exactly
// one list and its output row is written exactly once, with no atomics. A
// persistent grid walks tiles of kTM listed edges (the several-group list
// and the NN list first, as they cost the most). A tile of list g < 4 runs
// group g's table only; a tile of list 4 runs every group one of its edges
// feeds, in the order 0..3, into the same fp32 sums. The K dimension of a
// tile's product is its groups' table rows, in chunks of PC atom pairs
// (16 PC rows): per chunk each thread computes one (edge, pair)'s distance
// or damped walk once and its 16 bins straight into the A operand in shared
// memory, while the chunk's table rows stream in by cp.async into a double
// buffer, one chunk ahead; the warps (4 row blocks x 2 column groups of 256
// threads at bf16, two blocks per SM; x 4 of 512 at fp32, one block per SM)
// add A @ table on the tensor cores into registers, and each edge's row is
// stored once at the end. At fp32 each chunk sums apart and is then added
// to the running sums (see the product). PC is 8 (128 rows), or 4 where two
// stages of 128 rows of the table would not fit in shared memory (fp32
// above H = 128).
//
// Weight gradient (rbf_dw_groups, then dw_reduce): the caller lists each
// group's edges in ascending order (lists [4][stride], counts [4];
// edge_group_lists). Block (slice, split) owns kPairs atom pairs (128 rows)
// of one group table and the split-th of kSplit fixed ranges of that
// group's list. Per chunk of kTE listed edges, each thread computes one
// (pair, edge)'s distance or walk once and all its 16 bins into shared
// memory, the g rows are gathered beside them (rounded to bf16 at bf16),
// and 8 warps add bins^T @ g (16 rows x H each) on the tensor cores into
// registers. The partial goes to part[split][5184][H]; dw_reduce sums the
// kSplit partials in order and writes each row through the row map into
// the reference order. No atomics: the result is deterministic.
#pragma once
#include <type_traits>

#include "cp_async.cuh"
#include "mma.cuh"
#include "rbf_common.cuh"

namespace {

constexpr int kNP = 5;        // protein block P = PERM slots [0, 5)
constexpr int kTM = 64;       // listed edges per forward tile
constexpr int kLists = 5;     // groups PP, PN, NP, NN, then several groups
// the order in which the forward's tiles of the lists are dealt out
__constant__ int kOrder[kLists] = {4, 3, 1, 2, 0};

// The operand type of a kind: fp32 for the exact bins, bf16 otherwise.
template <BinKind KIND>
using operand_t = typename std::conditional<KIND == kExact, float, bf16>::type;

__host__ __device__ constexpr int group_aq(int g) { return (g >> 1) ? kA - kNP : kNP; }
__host__ __device__ constexpr int group_an(int g) { return (g & 1) ? kA - kNP : kNP; }
__host__ __device__ constexpr int group_pairs(int g) { return group_aq(g) * group_an(g); }
// first table row of group g (the tables one after another)
__host__ __device__ constexpr int group_offset(int g) {
  return g == 0 ? 0 : group_offset(g - 1) + kR * group_pairs(g - 1);
}

// Bit g set when an edge between a query residue with masks mq and a key
// residue with masks mk feeds group g (ops/rbf_common.py::edge_groups).
__device__ __forceinline__ int member_bits(const float* mq, const float* mk) {
  bool qp = false, qn = false, kp = false, kn = false;
  for (int a = 0; a < kNP; ++a) {
    qp |= mq[a] > 0.f;
    kp |= mk[a] > 0.f;
  }
  for (int a = kNP; a < kA; ++a) {
    qn |= mq[a] > 0.f;
    kn |= mk[a] > 0.f;
  }
  const bool q0 = qp || !qn, q1 = qn, k0 = kp || !kn, k1 = kn;
  return (int)(q0 && k0) | ((int)(q0 && k1) << 1) | ((int)(q1 && k0) << 2) |
         ((int)(q1 && k1) << 3);
}

// ---------------------------------------------------------------- forward

// Threads of a block (4 row blocks x threads/128 column groups of warps)
// and blocks per SM: bf16 2 x 256, fp32 1 x 512 (the fp32 warps hold a
// chunk's partial sums beside the running ones).
template <typename T>
__host__ __device__ constexpr int threads() { return sizeof(T) == 2 ? 256 : 512; }
template <typename T>
__host__ __device__ constexpr int blocks_per_sm() { return sizeof(T) == 2 ? 2 : 1; }

// Atom pairs per chunk: 8, or 4 where a stage of the table would pass 64 KB.
template <int H, typename T>
__host__ __device__ constexpr int chunk_pairs() { return H * (int)sizeof(T) > 512 ? 4 : 8; }

template <int H, typename T>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  constexpr int KC = kR * chunk_pairs<H, T>();
  return ((size_t)kTM * lda<T>(KC) + 2 * (size_t)KC * (H + 8)) * sizeof(T);
}

__device__ __forceinline__ int next_group(int mask, int g) {
  const int m = mask & ~((2 << g) - 1);
  return m ? __ffs(m) - 1 : 4;
}

// Start the copies of the table rows of group g's pairs [p0, p0 + PC)
// into Bs [16 PC][H + 8] (rows past the group's end are zero-filled).
template <int H, typename T, int PC>
__device__ __forceinline__ void start_chunk(const T* __restrict__ table, int g,
                                            int p0, T* Bs) {
  constexpr int KC = kR * PC, EPS = 16 / (int)sizeof(T), SEG = H / EPS;
  const int r_end = kR * (group_pairs(g) - p0);
  const size_t base = (size_t)group_offset(g) + (size_t)kR * p0;
  for (int i = threadIdx.x; i < KC * SEG; i += threads<T>()) {
    const int r = i / SEG, h = (i % SEG) * EPS;
    const bool ok = r < r_end;
    async_copy16(Bs + r * (H + 8) + h, table + (ok ? base + r : 0) * H + h, ok);
  }
}

template <int H, BinKind KIND>
__global__ void __launch_bounds__(threads<operand_t<KIND>>(),
                                  blocks_per_sm<operand_t<KIND>>())
rbf_fwd_groups(const float* __restrict__ Xq, const float* __restrict__ Mq,
               const float* __restrict__ Xk, const float* __restrict__ Mk,
               const long long* __restrict__ nbr,
               const operand_t<KIND>* __restrict__ table,
               const long long* __restrict__ order,
               const long long* __restrict__ counts, int K,
               float* __restrict__ out) {
  using T = operand_t<KIND>;
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int PC = chunk_pairs<H, T>(), KC = kR * PC, LA = lda<T>(KC), LB = H + 8;
  constexpr int NTH = threads<T>(), CG = NTH / 128;
  constexpr int NT = H / (8 * CG);  // n-tiles of a warp's H / CG columns
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [kTM][LA] the chunk's bins
  T* Bs = As + kTM * LA;               // 2 x [KC][LB] the chunk's table rows
  __shared__ long long s_e[kTM], s_q[kTM], s_k[kTM];

  const int tid = threadIdx.x, warp = tid >> 5, g8 = lane_g(), t4 = lane_t();
  const int rb = warp & 3, cb = (warp >> 2) * (H / CG);
  long long cnt[kLists], start[kLists];
  int ntiles[kLists], total = 0;
#pragma unroll
  for (int l = 0; l < kLists; ++l) {
    cnt[l] = counts[l];
    start[l] = l ? start[l - 1] + cnt[l - 1] : 0;
    ntiles[l] = (int)((cnt[l] + kTM - 1) / kTM);
    total += ntiles[l];
  }

  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int l = 0, tt = tile;
    for (int o = 0; o < kLists; ++o) {
      l = kOrder[o];
      if (tt < ntiles[l]) break;
      tt -= ntiles[l];
    }
    const long long i0 = (long long)tt * kTM;
    const int n = (int)min((long long)kTM, cnt[l] - i0);
    const long long* list = order + start[l];
    int bits = 0;
    if (tid < kTM) {
      long long e = -1, q = 0, k = 0;
      if (tid < n) {
        e = list[i0 + tid];
        q = e / K;
        k = nbr[e];
        if (l == 4) bits = member_bits(Mq + q * kA, Mk + k * kA);
      }
      s_e[tid] = e;
      s_q[tid] = q;
      s_k[tid] = k;
    }
    int gmask = 0;
    if (l < 4) {
      gmask = 1 << l;
    } else {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        if (__syncthreads_or((bits >> g) & 1)) gmask |= 1 << g;
    }
    __syncthreads();
    // the output rows of this thread's fragments, read now: past the chunk
    // loop's last barrier the first warps already write the next tile's s_e
    long long erow[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) erow[hf] = s_e[16 * rb + g8 + 8 * hf];

    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    int g = __ffs(gmask) - 1, p0 = 0, s = 0;
    start_chunk<H, T, PC>(table, g, p0, Bs);
    async_commit();
    while (g < 4) {
      int gn = g, pn = p0 + PC;
      if (pn >= group_pairs(g)) {
        gn = next_group(gmask, g);
        pn = 0;
      }
      // the chunk's bins: (edge e, pair p0 + p) -> As[e][16 p .. 16 p + 15]
      const int An = group_an(g), AA = group_pairs(g);
      const int qa0 = (g >> 1) ? kNP : 0, na0 = (g & 1) ? kNP : 0;
      for (int it = tid; it < kTM * PC; it += NTH) {
        const int e = it % kTM, p = it / kTM, pi = p0 + p;
        float b[kR];
        bool present = false;
        if (e < n && pi < AA) {
          const int qa = qa0 + pi / An, na = na0 + pi % An;
          const long long q = s_q[e], k = s_k[e];
          present = Mq[q * kA + qa] != 0.f && Mk[k * kA + na] != 0.f;
          if (present) pair_bins<KIND>(Xq + q * 3 * kA, Xk + k * 3 * kA, qa, na, b);
        }
        if (!present) {
#pragma unroll
          for (int r = 0; r < kR; ++r) b[r] = 0.f;
        }
        T* dst = As + e * LA + p * kR;
        if constexpr (kLow) {
          uint4 v0, v1;
          v0.x = pack_bf16(b[0], b[1]);   v0.y = pack_bf16(b[2], b[3]);
          v0.z = pack_bf16(b[4], b[5]);   v0.w = pack_bf16(b[6], b[7]);
          v1.x = pack_bf16(b[8], b[9]);   v1.y = pack_bf16(b[10], b[11]);
          v1.z = pack_bf16(b[12], b[13]); v1.w = pack_bf16(b[14], b[15]);
          reinterpret_cast<uint4*>(dst)[0] = v0;
          reinterpret_cast<uint4*>(dst)[1] = v1;
        } else {
#pragma unroll
          for (int r = 0; r < kR; r += 4)
            *reinterpret_cast<float4*>(dst + r) = make_float4(b[r], b[r + 1], b[r + 2], b[r + 3]);
        }
      }
      if (gn < 4) start_chunk<H, T, PC>(table, gn, pn, Bs + (s ^ 1) * KC * LB);
      async_commit();
      async_wait<1>();
      __syncthreads();  // the bins and this chunk's table rows are in place
      const T* B = Bs + s * KC * LB;
      if constexpr (kLow) {
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 16) {
          uint32_t a[4];
          frag_a_bf16(a, As, LA, 16 * rb, k0);
#pragma unroll
          for (int j = 0; j < NT; j += 2) {
            uint32_t bb[4];
            frag_b2_bf16_trans(bb, B, LB, cb + 8 * j, k0);
            mma_bf16(acc[j], a, bb[0], bb[1]);
            mma_bf16(acc[j + 1], a, bb[2], bb[3]);
          }
        }
      } else {
        // the chunk's partial sums apart, then added to the running sums:
        // the tensor cores' own accumulation rounds toward zero, which over
        // a group's up to 2704 rows would drift past the fp32 tolerances
        float part[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll 2
        for (int k0 = 0; k0 < KC; k0 += 8) {
          const float* pa = As + (16 * rb + g8) * LA + k0 + t4;
          const float av[4] = {pa[0], pa[8 * LA], pa[4], pa[8 * LA + 4]};
          SplitA a;
          a.set(av);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float* pb = B + (k0 + t4) * LB + cb + 8 * j + g8;
            mma_3xtf32(part[j], a, pb[0], pb[4 * LB]);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
      }
      __syncthreads();  // As and this stage are free for the next chunk
      g = gn;
      p0 = pn;
      s ^= 1;
    }
    async_wait<0>();

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * rb + g8 + 8 * hf;
      if (r >= n) continue;
      float* dst = out + (size_t)erow[hf] * H + cb + 2 * t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
  }
}

template <int H, BinKind KIND>
int fwd_launch(const float* Xq, const float* Mq, const float* Xk,
               const float* Mk, const long long* nbr,
               const operand_t<KIND>* table, const long long* order,
               const long long* counts, int K, int sms, float* out,
               cudaStream_t stream) {
  using T = operand_t<KIND>;
  const size_t smem = fwd_smem_bytes<H, T>();
  cudaError_t err = cudaFuncSetAttribute(
      rbf_fwd_groups<H, KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rbf_fwd_groups<H, KIND><<<sms * blocks_per_sm<T>(), threads<T>(), smem, stream>>>(
      Xq, Mq, Xk, Mk, nbr, table, order, counts, K, out);
  return (int)cudaGetLastError();
}

// The forward at width H, one of the instantiated widths Hs (any other:
// cudaErrorInvalidValue). Operands as rbf_classed_forward states them.
template <BinKind KIND, int... Hs>
int group_forward(const float* Xq, const float* Mq, const float* Xk,
                  const float* Mk, const long long* nbr, int K, int H,
                  const operand_t<KIND>* table, const long long* order,
                  const long long* counts, int sms, float* out,
                  cudaStream_t stream) {
  if (K < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  (void)((H == Hs && ((err = fwd_launch<Hs, KIND>(Xq, Mq, Xk, Mk, nbr, table, order,
                                                  counts, K, sms, out, stream)),
                      true)) || ...);
  return err;
}

// Dynamic shared memory of one forward block at width H (bytes; -1 for a
// width not instantiated).
template <BinKind KIND, int... Hs>
int group_forward_smem(int H) {
  int bytes = -1;
  (void)((H == Hs && ((bytes = (int)fwd_smem_bytes<Hs, operand_t<KIND>>()), true)) || ...);
  return bytes;
}

// -------------------------------------------------------- weight gradient

constexpr int kTE = 32;       // listed edges per chunk
constexpr int kDwThreads = 256;
constexpr int kPairs = 8;     // atom pairs per block: 8 x 16 = 128 rows
constexpr int kSliceRows = kPairs * kR;
constexpr int kSplit = 32;    // fixed ranges of each group's edge list
constexpr int kTotalRows = kR * kA * kA;  // 5184

template <int H, BinKind KIND>
__global__ void __launch_bounds__(kDwThreads)
rbf_dw_groups(const float* __restrict__ Xq, const float* __restrict__ Mq,
              const float* __restrict__ Xk, const float* __restrict__ Mk,
              const long long* __restrict__ nbr, const float* __restrict__ g,
              const long long* __restrict__ lists,
              const long long* __restrict__ counts, long long stride, int K,
              float* __restrict__ part) {
  using T = operand_t<KIND>;
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int LB = kLow ? kTE + 8 : kTE + 4;  // bins [128][LB]
  constexpr int LG = H + 8;                     // g rows [32][LG]
  constexpr int NT = H / 8;
  __shared__ __align__(16) T bins[kSliceRows * LB];
  __shared__ __align__(16) T gs[kTE * LG];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane_g(), t = lane_t();

  // This block's slice: group grp, pairs [p0, p0 + kPairs) of its table.
  int s = blockIdx.x, grp = 0, goff = 0;
  for (;;) {
    const int ns = (group_pairs(grp) + kPairs - 1) / kPairs;
    if (s < ns || grp == 3) break;
    s -= ns;
    goff += kR * group_pairs(grp);
    ++grp;
  }
  const int An = group_an(grp), AA = group_pairs(grp);
  const int q0 = (grp >> 1) ? kNP : 0, n0 = (grp & 1) ? kNP : 0;
  const int p0 = s * kPairs;
  const long long cnt = counts[grp];
  const long long* list = lists + grp * stride;
  const long long i_begin = blockIdx.y * cnt / kSplit;
  const long long i_end = (blockIdx.y + 1) * cnt / kSplit;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (long long i0 = i_begin; i0 < i_end; i0 += kTE) {
    // bins of pair (p0 + warp) for edge (i0 + lane)
    {
      const int a = p0 + warp;
      float b[kR];
      bool present = false;
      if (a < AA && i0 + lane < i_end) {
        const long long e = list[i0 + lane], q = e / K, kn = nbr[e];
        const int qa = q0 + a / An, na = n0 + a % An;
        present = Mq[q * kA + qa] != 0.f && Mk[kn * kA + na] != 0.f;
        if (present) pair_bins<KIND>(Xq + q * 3 * kA, Xk + kn * 3 * kA, qa, na, b);
      }
      if (!present) {
#pragma unroll
        for (int r = 0; r < kR; ++r) b[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) bins[(warp * kR + r) * LB + lane] = from_f<T>(b[r]);
    }
    // the chunk's g rows (zero past the range)
    for (int idx = 4 * tid; idx < kTE * H; idx += 4 * kDwThreads) {
      const int e = idx / H, h = idx % H;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + e < i_end) v = ld4(g + list[i0 + e] * H + h);
      T* d = gs + e * LG + h;
      d[0] = from_f<T>(v.x);
      d[1] = from_f<T>(v.y);
      d[2] = from_f<T>(v.z);
      d[3] = from_f<T>(v.w);
    }
    __syncthreads();
    if constexpr (kLow) {
#pragma unroll
      for (int k0 = 0; k0 < kTE; k0 += 16) {
        uint32_t af[4];
        frag_a_bf16(af, bins, LB, 16 * warp, k0);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bf[4];
          frag_b2_bf16_trans(bf, gs, LG, 8 * j, k0);
          mma_bf16(acc[j], af, bf[0], bf[1]);
          mma_bf16(acc[j + 1], af, bf[2], bf[3]);
        }
      }
    } else {
#pragma unroll
      for (int k0 = 0; k0 < kTE; k0 += 8) {
        const float* pa = bins + (16 * warp + gq) * LB + k0 + t;
        const float av[4] = {pa[0], pa[8 * LB], pa[4], pa[8 * LB + 4]};
        SplitA af;
        af.set(av);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* pb = gs + (k0 + t) * LG + 8 * j + gq;
          mma_3xtf32(acc[j], af, pb[0], pb[4 * LG]);
        }
      }
    }
    __syncthreads();  // the chunk's buffers are consumed before the next one
  }

  float* out = part + ((size_t)blockIdx.y * kTotalRows + goff + p0 * kR) * H;
  const int nrows = min(kSliceRows, (AA - p0) * kR);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = 16 * warp + gq + 8 * hf;
    if (row >= nrows) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<float2*>(out + (size_t)row * H + 8 * j + 2 * t) =
          make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
}

constexpr int num_slices() {
  int n = 0;
  for (int grp = 0; grp < 4; ++grp) n += (group_pairs(grp) + kPairs - 1) / kPairs;
  return n;
}

template <int H, BinKind KIND>
int dw_launch(const float* Xq, const float* Mq, const float* Xk,
              const float* Mk, const long long* nbr, const float* g,
              const long long* lists, const long long* counts,
              long long stride, const long long* rowmap, int K, float* part,
              float* dW, cudaStream_t stream) {
  rbf_dw_groups<H, KIND><<<dim3(num_slices(), kSplit), kDwThreads, 0, stream>>>(
      Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, K, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)kTotalRows * H;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, kSplit, rowmap, kTotalRows, H, dW);
  return (int)cudaGetLastError();
}

// The weight gradient at width H, one of the instantiated widths Hs (any
// other: cudaErrorInvalidValue). Operands as rbf_classed_dw states them.
template <BinKind KIND, int... Hs>
int group_dw(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
             const long long* nbr, const float* g, const long long* lists,
             const long long* counts, long long stride, const long long* rowmap,
             int K, int H, float* part, float* dW, cudaStream_t stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  (void)((H == Hs && ((err = dw_launch<Hs, KIND>(Xq, Mq, Xk, Mk, nbr, g, lists, counts,
                                                 stride, rowmap, K, part, dW, stream)),
                      true)) || ...);
  return err;
}

}  // namespace
