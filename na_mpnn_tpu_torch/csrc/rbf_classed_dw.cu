// Weight gradient of the class-specialised RBF projection, for Hopper
// (sm_90a); fp32, and bf16 for the bf16 trunk. Products on the tensor cores
// (mma.cuh): bf16 mma.sync for the bf16 variant, 3xTF32 for fp32.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_dw
// (_bwd_kernel, rbf_classed.py:394). For the cotangent g [E, H] of the
// projection out = bins @ W (rbf_classed.cu), the gradient of each group
// table is dW_g[pair, r][h] = sum_e bins_g(e, pair, r) * g[e][h], with the
// same bins as the forward: 16 Gaussian bins of the distance between query
// atom q and neighbour atom n (pair = q*An + n), exactly 0 where either atom
// is masked, over the PERM-ordered atom blocks P (5 slots) and N (13 slots).
// The four tables are PP (400 rows), PN (1040), NP (1040), NN (2704), one
// after another; inside a table the rows are pair-major (pair*16 + r), and
// the last pass writes each row through `rowmap` into the reference order of
// the [18*18*16, H] weight.
//
// Each edge belongs to the groups its two residues allow: group
// g = 2*a + b for every side a of the query residue and b of the neighbour
// residue (a residue with atoms in both blocks has both sides; its masked
// pairs add 0). The caller lists each group's edges in ascending order
// (lists [4][stride], counts [4]; ops/rbf_classed.py::edge_group_lists), so
// an edge costs only its own groups' rows.
//
// Two launches:
// 1. accumulate: block (slice, split) owns 8 atom pairs (128 rows) of one
//    group table and the split-th of kSplit fixed ranges of that group's
//    list. Per chunk of 32 listed edges, each thread computes one (pair,
//    edge)'s distance once and all its 16 bins (the exact Gaussians; at bf16
//    the damped walk, rbf_common.cuh) into shared memory, the g rows are
//    gathered beside them, and 8 warps add bins^T @ g (16 rows x H each) on
//    the tensor cores into registers. The partial goes to
//    part[split][5184][H]. No atomics.
// 2. reduce: dW[rowmap[row]] = sum over the kSplit partials, in order
//    (rbf_common.cuh::dw_reduce). The result is deterministic.
// bf16 (rbf_classed_dw_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:407-415): the bins are the damped recursive bins of the
// bf16 forward rounded to bf16 and g enters rounded to bf16; their products
// sum in fp32, and dW (the gradient of the fold-scaled weight) is fp32.
//
// What bounds it on the card: at fp32 the operations, 16*(2H+8) per present
// atom pair of every edge; at bf16 the bytes of g and the edge operands.
// The neighbour rows are a gathered operand (Xk, Mk), as in the forward.
#include <type_traits>

#include "mma.cuh"
#include "rbf_common.cuh"

namespace {

constexpr int kNP = 5;        // protein block P = PERM slots [0, 5)
constexpr int kThreads = 256;
constexpr int kPairs = 8;     // atom pairs per block: 8 x 16 = 128 rows
constexpr int kSliceRows = kPairs * kR;
constexpr int kSplit = 32;    // fixed ranges of each group's edge list
constexpr int kTotalRows = kR * kA * kA;  // 5184

__host__ __device__ constexpr int group_aq(int g) { return (g >> 1) ? kA - kNP : kNP; }
__host__ __device__ constexpr int group_an(int g) { return (g & 1) ? kA - kNP : kNP; }

template <int H, bool kLow>
__global__ void __launch_bounds__(kThreads)
rbf_dw_groups(const float* __restrict__ Xq, const float* __restrict__ Mq,
              const float* __restrict__ Xk, const float* __restrict__ Mk,
              const long long* __restrict__ nbr, const float* __restrict__ g,
              const long long* __restrict__ lists,
              const long long* __restrict__ counts, long long stride, int K,
              float* __restrict__ part) {
  using T = typename std::conditional<kLow, bf16, float>::type;
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
    const int ns = (group_aq(grp) * group_an(grp) + kPairs - 1) / kPairs;
    if (s < ns || grp == 3) break;
    s -= ns;
    goff += kR * group_aq(grp) * group_an(grp);
    ++grp;
  }
  const int Aq = group_aq(grp), An = group_an(grp), AA = Aq * An;
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
        if (present) pair_bins<kLow>(Xq + q * 3 * kA, Xk + kn * 3 * kA, qa, na, b);
      }
      if (!present) {
#pragma unroll
        for (int r = 0; r < kR; ++r) b[r] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) bins[(warp * kR + r) * LB + lane] = from_f<T>(b[r]);
    }
    // the chunk's g rows (zero past the range)
    for (int idx = 4 * tid; idx < kTE * H; idx += 4 * kThreads) {
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
  for (int grp = 0; grp < 4; ++grp)
    n += (group_aq(grp) * group_an(grp) + kPairs - 1) / kPairs;
  return n;
}

template <int H, bool kLow>
int launch(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
           const long long* nbr, const float* g, const long long* lists,
           const long long* counts, long long stride, const long long* rowmap,
           int K, float* part, float* dW, cudaStream_t stream) {
  rbf_dw_groups<H, kLow><<<dim3(num_slices(), kSplit), kThreads, 0, stream>>>(
      Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, K, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)kTotalRows * H;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, kSplit, rowmap, kTotalRows, H, dW);
  return (int)cudaGetLastError();
}

template <bool kLow>
int dw(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
       const long long* nbr, const float* g, const long long* lists,
       const long long* counts, long long stride, const long long* rowmap,
       int K, int H, float* part, float* dW, cudaStream_t stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 32: return launch<32, kLow>(Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, rowmap, K, part, dW, stream);
    case 64: return launch<64, kLow>(Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, rowmap, K, part, dW, stream);
    case 128: return launch<128, kLow>(Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, rowmap, K, part, dW, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbf_classed_dw_splits() { return kSplit; }

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, PERM order),
// Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each edge),
// g [E, H], lists [4, stride] (group g's edges, ascending, counts[g] of
// them), rowmap [5184] (kernel-order row -> reference row); scratch part
// [kSplit, 5184, H]; dW [5184, H].
extern "C" int rbf_classed_dw(const float* Xq, const float* Mq,
                              const float* Xk, const float* Mk,
                              const long long* nbr, const float* g,
                              const long long* lists, const long long* counts,
                              long long stride, const long long* rowmap,
                              int K, int H, float* part, float* dW,
                              cudaStream_t stream) {
  return dw<false>(Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, rowmap, K,
                   H, part, dW, stream);
}

// The bf16 trunk's weight gradient (same operands, fp32 g and dW).
extern "C" int rbf_classed_dw_bf16(const float* Xq, const float* Mq,
                                   const float* Xk, const float* Mk,
                                   const long long* nbr, const float* g,
                                   const long long* lists,
                                   const long long* counts, long long stride,
                                   const long long* rowmap, int K, int H,
                                   float* part, float* dW,
                                   cudaStream_t stream) {
  return dw<true>(Xq, Mq, Xk, Mk, nbr, g, lists, counts, stride, rowmap, K,
                  H, part, dW, stream);
}
