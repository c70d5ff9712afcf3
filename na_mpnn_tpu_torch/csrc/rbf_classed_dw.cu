// Weight gradient of the class-specialised RBF projection, for Hopper
// (sm_90a); fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_dw
// (_bwd_kernel, rbf_classed.py:394). For the cotangent g [E, H] of the
// projection out = bins @ W (rbf_classed.cu), the gradient of each group
// table is dW_g[r*AA + a][h] = sum_e bins_g(e, r, a) * g[e][h], with the
// same bins as the forward: 16 Gaussian bins of the distance between query
// atom q and neighbour atom n (a = q*An + n), exactly 0 where either atom is
// masked, over the PERM-ordered atom blocks P (5 slots) and N (13 slots).
// The four tables are PP (400 rows), PN (1040), NP (1040), NN (2704), in
// kernel order; the last pass writes each row straight into the reference
// order of the [18*18*16, H] weight (rowmap), so no scatter follows.
//
// Three launches:
// 1. classify: one warp per tile of 32 edges, the same classification as the
//    forward (rbf_classed.cu, _tile_gid): code g if every query and every
//    neighbour of the tile sits in one block (group g = 2*side_q + side_n),
//    else 4 (mixed: the tile feeds all four groups, masked pairs add 0).
// 2. accumulate: a block owns a slice of up to 128 rows of one group table
//    and one of kSplit edge chunks. It walks the chunk's tiles, skips a tile
//    whose code is neither its group nor 4, recomputes its rows' bins for the
//    tile's 32 edges in shared memory, and adds bins^T @ g_tile into
//    128 x H accumulators in registers. It writes them to its chunk's partial
//    [kSplit][5184][H]. No cross-block atomics.
// 3. reduce: dW[rowmap[row]] = sum over the kSplit partials, in order.
// The result is deterministic.
// bf16 (rbf_classed_dw_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:407-415): the bins are the damped recursive bins of the
// bf16 forward and g enters rounded to bf16; both are products of bf16
// values, summed in fp32 in the same fixed order, and dW (the gradient of
// the fold-scaled weight) is fp32.
//
// What bounds it on the card: operations, 2*H multiply-adds per present atom
// pair and bin of every edge (as the forward), against the edge operands and
// g (about 1 KB per edge). The cost of this design: g and the tile operands
// are read once per slice of the tile's group (4 slices of PP, 9 of PN and
// NP, 22 of NN, 44 for a mixed tile), mostly from L2.
// The neighbour rows are a gathered operand (Xk, Mk), as in the forward.
#include "rbf_common.cuh"

namespace {

constexpr int kNP = 5;        // protein block P = PERM slots [0, 5)
constexpr int kThreads = 256;
constexpr int kSliceRows = 128;
constexpr int kSplit = 16;    // edge chunks
constexpr int kTotalRows = kR * kA * kA;  // 5184

__device__ __forceinline__ int side_code(const float* m) {
  bool has_p = false, has_n = false;
  for (int a = 0; a < kNP; ++a) has_p |= (m[a] > 0.f);
  for (int a = kNP; a < kA; ++a) has_n |= (m[a] > 0.f);
  return (int)has_n + (int)(has_n && has_p);  // 0 P/empty, 1 N, 2 mixed
}

__device__ __forceinline__ int group_aq(int g) { return (g >> 1) ? kA - kNP : kNP; }
__device__ __forceinline__ int group_an(int g) { return (g & 1) ? kA - kNP : kNP; }

__global__ void classify_tiles(const float* __restrict__ Mq,
                               const float* __restrict__ Mk,
                               const long long* __restrict__ nbr, int E, int K,
                               int ntiles, int* __restrict__ code) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (tile >= ntiles) return;
  const int ge = tile * kTE + lane;
  int q_lo = 3, q_hi = -1, n_lo = 3, n_hi = -1;
  if (ge < E) {
    q_lo = q_hi = side_code(Mq + (size_t)(ge / K) * kA);
    n_lo = n_hi = side_code(Mk + (size_t)nbr[ge] * kA);
  }
  for (int o = 16; o > 0; o >>= 1) {
    q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, o));
    q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, o));
    n_lo = min(n_lo, __shfl_xor_sync(0xffffffffu, n_lo, o));
    n_hi = max(n_hi, __shfl_xor_sync(0xffffffffu, n_hi, o));
  }
  if (lane == 0) {
    const bool pure = q_lo == q_hi && q_hi < 2 && n_lo == n_hi && n_hi < 2;
    code[tile] = pure ? 2 * q_lo + n_lo : 4;
  }
}

// Shared memory of the accumulate kernel, in floats.
template <int H>
constexpr int acc_smem_floats() {
  return 2 * kTE * 3 * kA + 2 * kTE * kA + kSliceRows * kTE + kTE * H;
}

template <int H, bool kLow>
__global__ void __launch_bounds__(kThreads)
rbf_dw_accumulate(const float* __restrict__ Xq, const float* __restrict__ Mq,
                  const float* __restrict__ Xk, const float* __restrict__ Mk,
                  const long long* __restrict__ nbr, const float* __restrict__ g,
                  const int* __restrict__ code, int E, int K, int ntiles,
                  float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* qx = smem;                    // [kTE][3A]
  float* nx = qx + kTE * 3 * kA;       // [kTE][3A]
  float* qm = nx + kTE * 3 * kA;       // [kTE][A]
  float* nm = qm + kTE * kA;           // [kTE][A]
  float* bins = nm + kTE * kA;         // [kSliceRows][kTE]
  float* gs = bins + kSliceRows * kTE; // [kTE][H]
  constexpr int CPT = H / 32;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;

  // This block's slice: group grp, rows [row0, row0 + nrows) of its table.
  int s = blockIdx.x, grp = 0, goff = 0;
  for (;;) {
    const int size = kR * group_aq(grp) * group_an(grp);
    const int ns = (size + kSliceRows - 1) / kSliceRows;
    if (s < ns || grp == 3) break;
    s -= ns;
    goff += size;
    ++grp;
  }
  const int Aq = group_aq(grp), An = group_an(grp), AA = Aq * An;
  const int q0 = (grp >> 1) ? kNP : 0, n0 = (grp & 1) ? kNP : 0;
  const int row0 = s * kSliceRows;
  const int nrows = min(kSliceRows, kR * AA - row0);
  const int t_begin = (int)((long long)blockIdx.y * ntiles / kSplit);
  const int t_end = (int)((long long)(blockIdx.y + 1) * ntiles / kSplit);

  float acc[kSliceRows / 8][CPT];
#pragma unroll
  for (int i = 0; i < kSliceRows / 8; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int cd = code[t];
    if (cd != grp && cd != 4) continue;
    const int e0 = t * kTE;
    load_edge_tile(Xq, Mq, Xk, Mk, nbr, E, K, e0, qx, nx, qm, nm);
    for (int idx = tid; idx < kTE * H; idx += kThreads) {
      const int e = idx / H;
      const float v = e0 + e < E ? g[(size_t)e0 * H + idx] : 0.f;
      gs[idx] = kLow ? rnd<bf16>(v) : v;
    }
    __syncthreads();
    for (int idx = tid; idx < kSliceRows * kTE; idx += kThreads) {
      const int i = idx / kTE, e = idx % kTE;
      float v = 0.f;
      if (i < nrows) {
        const int rho = row0 + i, r = rho / AA, a = rho % AA;
        if constexpr (kLow)
          v = rnd<bf16>(rbf_bin_damped(qx, nx, qm, nm, e, q0 + a / An, n0 + a % An, r));
        else
          v = rbf_bin(qx, nx, qm, nm, e, q0 + a / An, n0 + a % An, bin_mu(r));
      }
      bins[idx] = v;
    }
    __syncthreads();
    dw_tile_product<H, kSliceRows / 8>(bins, gs, acc);
    __syncthreads();  // the tile's buffers are consumed before the next load
  }

  float* out = part + ((size_t)blockIdx.y * kTotalRows + goff + row0) * H;
#pragma unroll
  for (int i = 0; i < kSliceRows / 8; ++i) {
    const int row = ty + 8 * i;
    if (row >= nrows) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[(size_t)row * H + tx + 32 * c] = acc[i][c];
  }
}

template <int H, bool kLow>
int launch(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
           const long long* nbr, const float* g, const long long* rowmap,
           int E, int K, int* code, float* part, float* dW,
           cudaStream_t stream) {
  const int ntiles = (E + kTE - 1) / kTE;
  classify_tiles<<<(ntiles * 32 + 255) / 256, 256, 0, stream>>>(
      Mq, Mk, nbr, E, K, ntiles, code);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = acc_smem_floats<H>() * sizeof(float);
  err = cudaFuncSetAttribute(rbf_dw_accumulate<H, kLow>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int slices = 0;
  for (int grp = 0; grp < 4; ++grp) {
    const int aq = (grp >> 1) ? kA - kNP : kNP, an = (grp & 1) ? kA - kNP : kNP;
    slices += (kR * aq * an + kSliceRows - 1) / kSliceRows;
  }
  rbf_dw_accumulate<H, kLow><<<dim3(slices, kSplit), kThreads, smem, stream>>>(
      Xq, Mq, Xk, Mk, nbr, g, code, E, K, ntiles, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)kTotalRows * H;
  dw_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, kSplit, rowmap, kTotalRows, H, dW);
  return (int)cudaGetLastError();
}

template <bool kLow>
int dw(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
       const long long* nbr, const float* g, const long long* rowmap, int E,
       int K, int H, int* code, float* part, float* dW, cudaStream_t stream) {
  switch (H) {
    case 32: return launch<32, kLow>(Xq, Mq, Xk, Mk, nbr, g, rowmap, E, K, code, part, dW, stream);
    case 64: return launch<64, kLow>(Xq, Mq, Xk, Mk, nbr, g, rowmap, E, K, code, part, dW, stream);
    case 128: return launch<128, kLow>(Xq, Mq, Xk, Mk, nbr, g, rowmap, E, K, code, part, dW, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int rbf_classed_dw_splits() { return kSplit; }

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, PERM order),
// Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each edge),
// g [E, H], rowmap [5184] (kernel-order row -> reference row); scratch
// code [ceil(E/32)] int, part [kSplit, 5184, H]; dW [5184, H].
extern "C" int rbf_classed_dw(const float* Xq, const float* Mq,
                              const float* Xk, const float* Mk,
                              const long long* nbr, const float* g,
                              const long long* rowmap, int E, int K, int H,
                              int* code, float* part, float* dW,
                              cudaStream_t stream) {
  return dw<false>(Xq, Mq, Xk, Mk, nbr, g, rowmap, E, K, H, code, part, dW,
                   stream);
}

// The bf16 trunk's weight gradient (same operands, fp32 g and dW).
extern "C" int rbf_classed_dw_bf16(const float* Xq, const float* Mq,
                                   const float* Xk, const float* Mk,
                                   const long long* nbr, const float* g,
                                   const long long* rowmap, int E, int K,
                                   int H, int* code, float* part, float* dW,
                                   cudaStream_t stream) {
  return dw<true>(Xq, Mq, Xk, Mk, nbr, g, rowmap, E, K, H, code, part, dW,
                  stream);
}
