// Polymer-class-specialised RBF edge features fused with their projection,
// for Hopper (sm_90a); fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_fwd
// (_fwd_kernel, rbf_classed.py:361). Per edge (i -> j): the distances between
// the 18 augmented atoms of i and of j, 16 Gaussian bins each
// (mu = 2..22 A, sigma = 1.25), masked by atom presence on both ends, times
// the [18*18*16, H] projection. The atom slots are host-permuted (PERM) so
// the protein block P (5 slots) and the nucleic block N (13 slots) are
// contiguous; the projection is split into the four group tables PP (400
// rows), PN (1040), NP (1040), NN (2704), row order r*(Aq*An) + q*An + n.
//
// A tile whose edges all share one (query class, neighbour class) pair runs
// only that group; a mixed tile runs all four and sums them, which equals the
// dense result because every masked pair contributes exactly 0 (explicit mask
// on the bin, exact per-bin expf: the fp32 path of the TPU kernel).
// The neighbour rows are a gathered operand (Xk, Mk, indexed by nbr): the
// query/key entry rbf_edge_features_classed_qk (rbf_classed.py:600), with a
// shard's query rows against the all-gathered structure, is the same launch.
//
// bf16 (rbf_classed_forward_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:315-321, :376): each bin is the damped recursive bin
// (rbf_common.cuh::rbf_bin_damped) rounded to bf16, the four tables arrive
// as bf16(W * fold scale), and the products of the two sum in fp32 into the
// fp32 output. The exact fp32 pair distances replace the TPU's bf16x2
// coordinate selection.
//
// What bounds it on the card: operations. Per edge the populated block costs
// 2*H*16*Aq*An multiply-adds (about 0.7 MFLOP for an NN edge at H = 128)
// against about 1.3 KB of coordinates, masks, index and output.
// Design: one block of 128 threads per tile of 32 edges. The block gathers
// its edges' query and neighbour rows itself (rbf_common.cuh), keeps
// one bin's values for the tile's atom pairs in shared memory, and each
// thread accumulates 32 edges x (H/128) output columns in registers while the
// group table streams through L2 (read once per tile, coalesced across the
// threads' columns).
#include "rbf_common.cuh"

namespace {

constexpr int kNP = 5;        // protein block P = PERM slots [0, 5)
constexpr int kThreads = 128;
constexpr int kMaxAA = 13 * 13;

template <typename TW>
struct Tables {
  const TW* w[4];
};

__device__ __forceinline__ int side_code(const float* m) {
  bool has_p = false, has_n = false;
  for (int a = 0; a < kNP; ++a) has_p |= (m[a] > 0.f);
  for (int a = kNP; a < kA; ++a) has_n |= (m[a] > 0.f);
  return (int)has_n + (int)(has_n && has_p);  // 0 P/empty, 1 N, 2 mixed
}

template <int HC, typename TW>
__global__ void __launch_bounds__(kThreads)
rbf_classed_kernel(const float* __restrict__ Xq, const float* __restrict__ Mq,
                   const float* __restrict__ Xk, const float* __restrict__ Mk,
                   const long long* __restrict__ nbr, int E, int K, int H,
                   Tables<TW> tabs, float* __restrict__ out) {
  constexpr bool kLow = sizeof(TW) == 2;
  __shared__ float qx[kTE][3 * kA], nx[kTE][3 * kA];
  __shared__ float qm[kTE][kA], nm[kTE][kA];
  __shared__ __align__(16) float bins[kMaxAA][kTE];
  __shared__ int code_lo[2], code_hi[2];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kTE;
  if (tid < 2) {
    code_lo[tid] = 3;
    code_hi[tid] = -1;
  }
  load_edge_tile(Xq, Mq, Xk, Mk, nbr, E, K, e0, &qx[0][0], &nx[0][0],
                 &qm[0][0], &nm[0][0]);
  __syncthreads();
  if (tid < kTE && e0 + tid < E) {
    int cq = side_code(qm[tid]), cn = side_code(nm[tid]);
    atomicMin(&code_lo[0], cq);
    atomicMax(&code_hi[0], cq);
    atomicMin(&code_lo[1], cn);
    atomicMax(&code_hi[1], cn);
  }
  __syncthreads();
  const bool pure = code_lo[0] == code_hi[0] && code_hi[0] < 2 &&
                    code_lo[1] == code_hi[1] && code_hi[1] < 2;
  const int g_pure = 2 * code_lo[0] + code_lo[1];

  float acc[HC][kTE];
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int e = 0; e < kTE; ++e) acc[c][e] = 0.f;

  for (int gi = 0; gi < 4; ++gi) {
    const int g = pure ? g_pure : gi;
    const int q0 = (g >> 1) ? kNP : 0, Aq = (g >> 1) ? kA - kNP : kNP;
    const int n0 = (g & 1) ? kNP : 0, An = (g & 1) ? kA - kNP : kNP;
    const int AA = Aq * An;
    const TW* W = tabs.w[g];
    for (int r = 0; r < kR; ++r) {
      const float mu = bin_mu(r);
      // Each bin recomputes its pair distances (a few operations against
      // the 2*H of the projection) so that only one [AA][32] buffer fits
      // in the 48 KB of static shared memory.
      for (int idx = tid; idx < AA * kTE; idx += kThreads) {
        const int a = idx / kTE, e = idx % kTE;
        if constexpr (kLow)
          bins[a][e] = rnd<bf16>(rbf_bin_damped(&qx[0][0], &nx[0][0], &qm[0][0],
                                                &nm[0][0], e, q0 + a / An,
                                                n0 + a % An, r));
        else
          bins[a][e] = rbf_bin(&qx[0][0], &nx[0][0], &qm[0][0], &nm[0][0], e,
                               q0 + a / An, n0 + a % An, mu);
      }
      __syncthreads();
      const TW* Wr = W + (size_t)r * AA * H;
      for (int a = 0; a < AA; ++a) {
        float w[HC];
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          int h = tid + c * kThreads;
          w[c] = h < H ? ldf(Wr + (size_t)a * H + h) : 0.f;
        }
        const float4* brow = reinterpret_cast<const float4*>(bins[a]);
#pragma unroll
        for (int e4 = 0; e4 < kTE / 4; ++e4) {
          float4 bv = brow[e4];
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            acc[c][4 * e4 + 0] = fmaf(bv.x, w[c], acc[c][4 * e4 + 0]);
            acc[c][4 * e4 + 1] = fmaf(bv.y, w[c], acc[c][4 * e4 + 1]);
            acc[c][4 * e4 + 2] = fmaf(bv.z, w[c], acc[c][4 * e4 + 2]);
            acc[c][4 * e4 + 3] = fmaf(bv.w, w[c], acc[c][4 * e4 + 3]);
          }
        }
      }
      __syncthreads();  // bins consumed before the next bin overwrites them
    }
    if (pure) break;
  }

#pragma unroll
  for (int c = 0; c < HC; ++c) {
    int h = tid + c * kThreads;
    if (h >= H) continue;
#pragma unroll
    for (int e = 0; e < kTE; ++e)
      if (e0 + e < E) out[(size_t)(e0 + e) * H + h] = acc[c][e];
  }
}

template <typename TW>
int forward(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
            const long long* nbr, int E, int K, int H, const TW* w0,
            const TW* w1, const TW* w2, const TW* w3, float* out,
            cudaStream_t stream) {
  Tables<TW> t{{w0, w1, w2, w3}};
  int blocks = (E + kTE - 1) / kTE;
  if (H <= kThreads) {
    rbf_classed_kernel<1, TW><<<blocks, kThreads, 0, stream>>>(Xq, Mq, Xk, Mk, nbr,
                                                               E, K, H, t, out);
  } else if (H <= 2 * kThreads) {
    rbf_classed_kernel<2, TW><<<blocks, kThreads, 0, stream>>>(Xq, Mq, Xk, Mk, nbr,
                                                               E, K, H, t, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows, PERM order), Xk [Nk, 3*18],
// Mk [Nk, 18] (key rows), nbr [E] (key row of each edge; the query row of
// edge e is e / K), the four group tables; out [E, H].
extern "C" int rbf_classed_forward(const float* Xq, const float* Mq,
                                   const float* Xk, const float* Mk,
                                   const long long* nbr, int E, int K, int H,
                                   const float* w0, const float* w1,
                                   const float* w2, const float* w3,
                                   float* out, cudaStream_t stream) {
  return forward<float>(Xq, Mq, Xk, Mk, nbr, E, K, H, w0, w1, w2, w3, out,
                        stream);
}

// The bf16 trunk's function: damped bf16 bins against the four tables of
// bf16(W * fold scale); coordinates, masks and out fp32.
extern "C" int rbf_classed_forward_bf16(const float* Xq, const float* Mq,
                                        const float* Xk, const float* Mk,
                                        const long long* nbr, int E, int K,
                                        int H, const bf16* w0, const bf16* w1,
                                        const bf16* w2, const bf16* w3,
                                        float* out, cudaStream_t stream) {
  return forward<bf16>(Xq, Mq, Xk, Mk, nbr, E, K, H, w0, w1, w2, w3, out,
                       stream);
}
