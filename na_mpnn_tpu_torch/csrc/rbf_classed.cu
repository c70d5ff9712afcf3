// Polymer-class-specialised RBF edge features fused with their projection,
// for Hopper (sm_90a); fp32, and bf16 for the bf16 trunk. Products on the
// tensor cores (mma.cuh): bf16 mma.sync for the bf16 variant, 3xTF32 for
// fp32 (the JAX fp32 path's Precision.HIGHEST, rbf_classed.py:328-330).
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_fwd
// (_fwd_kernel, rbf_classed.py:361). Per edge (i -> j): the distances between
// the 18 augmented atoms of i and of j, 16 Gaussian bins each
// (mu = 2..22 A, sigma = 1.25), exactly 0 where either atom is absent, times
// the [18*18*16, H] projection. The atom slots are host-permuted (PERM) so
// the protein block P (5 slots) and the nucleic block N (13 slots) are
// contiguous; the projection splits into the four group tables PP (400
// rows), PN (1040), NP (1040), NN (2704), which the caller hands over one
// after another, each pair-major (row pair*16 + r, pair = q*An + n; the row
// order of rbf_classed_dw.cu, ops/rbf_classed.py::_pair_row_map).
// The neighbour rows are a gathered operand (Xk, Mk, indexed by nbr): the
// query/key entry rbf_edge_features_classed_qk (rbf_classed.py:600), with a
// shard's query rows against the all-gathered structure, is the same launch.
//
// Each edge is classified alone, not by its tile: edge e feeds group
// g = 2*a + b for every side a of its query residue and b of its neighbour
// residue (a residue with atoms in both blocks has both sides; one with no
// atom counts as P). classify_kernel gives each edge its list: g < 4 when
// it feeds group g alone, 4 when it feeds several; the caller sorts the
// edges stably by list (ops/rbf_classed.py::edge_tile_order), so each list
// holds its edges in ascending order, every edge lies in exactly one list
// and its output row is written exactly once, with no atomics. A tile of
// list g < 4 runs group g's table only; a tile of list 4
// runs every group one of its edges feeds, in the order 0..3, into the same
// fp32 sums, so an edge of several groups gets the sum of its groups in that
// fixed order (a group an edge does not feed adds exact zeros: every one of
// its pairs has an absent atom). The output is deterministic.
//
// bf16 (rbf_classed_forward_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:315-321, :376): each bin is the damped recursive bin
// rounded to bf16, the tables arrive as bf16(W * fold scale), and their
// products sum in fp32 into the fp32 output. The exact fp32 pair distances
// replace the TPU's bf16x2 coordinate selection. Every bin, at both dtypes,
// comes from rbf_common.cuh::pair_bins, which the weight gradient
// (rbf_classed_dw.cu) recomputes bitwise.
//
// What bounds it on the card: at fp32 the operations (16*(2H+8) per present
// atom pair of every edge), at bf16 the bytes (coordinates, masks,
// neighbours and the fp32 [E, H] output).
// Design: a persistent grid walks tiles of 64 listed edges (the
// several-group list and the NN list first, as they cost the most). The K
// dimension of a tile's product is its groups' table rows, in chunks of 8
// atom pairs (128 rows): per chunk each thread computes one (edge, pair)'s
// distance or damped walk once and its 16 bins straight into the A operand
// in shared memory, while the chunk's table rows stream in by cp.async into
// a double buffer, one chunk ahead; the warps (4 row blocks x 2 column
// groups of 256 threads at bf16, two blocks per SM; x 4 of 512 at fp32, one
// block per SM) add A @ table on the tensor cores into registers, and each
// edge's row is stored once at the end. At fp32 each chunk sums apart and
// is then added to the running sums (see the product).
#include "cp_async.cuh"
#include "mma.cuh"
#include "rbf_common.cuh"

namespace {

constexpr int kNP = 5;        // protein block P = PERM slots [0, 5)
constexpr int kTM = 64;       // listed edges per tile
constexpr int kPC = 8;        // atom pairs (128 table rows) per chunk
constexpr int kLists = 5;     // groups PP, PN, NP, NN, then several groups
// the order in which the tiles of the lists are dealt out
__constant__ int kOrder[kLists] = {4, 3, 1, 2, 0};

__host__ __device__ constexpr int group_aq(int g) { return (g >> 1) ? kA - kNP : kNP; }
__host__ __device__ constexpr int group_an(int g) { return (g & 1) ? kA - kNP : kNP; }
__host__ __device__ constexpr int group_pairs(int g) { return group_aq(g) * group_an(g); }
// first table row of group g (the tables one after another)
__host__ __device__ constexpr int group_offset(int g) {
  return g == 0 ? 0 : group_offset(g - 1) + kR * group_pairs(g - 1);
}

// Threads of a block (4 row blocks x threads/128 column groups of warps)
// and blocks per SM: bf16 2 x 256, fp32 1 x 512 (the fp32 warps hold a
// chunk's partial sums beside the running ones).
template <typename T>
__host__ __device__ constexpr int threads() { return sizeof(T) == 2 ? 256 : 512; }
template <typename T>
__host__ __device__ constexpr int blocks_per_sm() { return sizeof(T) == 2 ? 2 : 1; }

template <int H, typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return ((size_t)kTM * lda<T>(kR * kPC) + 2 * (size_t)kR * kPC * (H + 8)) * sizeof(T);
}

// Bit g set when an edge between a query residue with masks mq and a key
// residue with masks mk feeds group g (ops/rbf_classed.py::edge_groups).
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

__device__ __forceinline__ int next_group(int mask, int g) {
  const int m = mask & ~((2 << g) - 1);
  return m ? __ffs(m) - 1 : 4;
}

// Start the copies of the table rows of group g's pairs [p0, p0 + kPC)
// into Bs [KC][H + 8] (rows past the group's end are zero-filled).
template <int H, typename T>
__device__ __forceinline__ void start_chunk(const T* __restrict__ table, int g,
                                            int p0, T* Bs) {
  constexpr int KC = kR * kPC, EPS = 16 / (int)sizeof(T), SEG = H / EPS;
  const int r_end = kR * (group_pairs(g) - p0);
  const size_t base = (size_t)group_offset(g) + (size_t)kR * p0;
  for (int i = threadIdx.x; i < KC * SEG; i += threads<T>()) {
    const int r = i / SEG, h = (i % SEG) * EPS;
    const bool ok = r < r_end;
    async_copy16(Bs + r * (H + 8) + h, table + (ok ? base + r : 0) * H + h, ok);
  }
}

template <int H, typename T>
__global__ void __launch_bounds__(threads<T>(), blocks_per_sm<T>())
rbf_classed_kernel(const float* __restrict__ Xq, const float* __restrict__ Mq,
                   const float* __restrict__ Xk, const float* __restrict__ Mk,
                   const long long* __restrict__ nbr, const T* __restrict__ table,
                   const long long* __restrict__ order,
                   const long long* __restrict__ counts, int K,
                   float* __restrict__ out) {
  constexpr bool kLow = sizeof(T) == 2;
  constexpr int PC = kPC, KC = kR * PC, LA = lda<T>(KC), LB = H + 8;
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
    start_chunk<H, T>(table, g, p0, Bs);
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
          if (present) pair_bins<kLow>(Xq + q * 3 * kA, Xk + k * 3 * kA, qa, na, b);
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
      if (gn < 4) start_chunk<H, T>(table, gn, pn, Bs + (s ^ 1) * KC * LB);
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

// code[e]: the list of edge e (query row e / K, key row nbr[e]).
__global__ void classify_kernel(const float* __restrict__ Mq,
                                const float* __restrict__ Mk,
                                const long long* __restrict__ nbr, long long E,
                                int K, unsigned char* __restrict__ code) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int bits = member_bits(Mq + (e / K) * kA, Mk + nbr[e] * kA);
  code[e] = (unsigned char)(__popc(bits) > 1 ? 4 : __ffs(bits) - 1);
}

template <int H, typename T>
int launch(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
           const long long* nbr, const T* table, const long long* order,
           const long long* counts, int K, int sms,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_bytes<H, T>();
  cudaError_t err = cudaFuncSetAttribute(
      rbf_classed_kernel<H, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rbf_classed_kernel<H, T><<<sms * blocks_per_sm<T>(), threads<T>(), smem, stream>>>(
      Xq, Mq, Xk, Mk, nbr, table, order, counts, K, out);
  return (int)cudaGetLastError();
}

template <typename T>
int forward(const float* Xq, const float* Mq, const float* Xk, const float* Mk,
            const long long* nbr, int K, int H, const T* table,
            const long long* order, const long long* counts, int sms,
            float* out, cudaStream_t stream) {
  if (K < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
    case 32: return launch<32, T>(Xq, Mq, Xk, Mk, nbr, table, order, counts, K, sms, out, stream);
    case 64: return launch<64, T>(Xq, Mq, Xk, Mk, nbr, table, order, counts, K, sms, out, stream);
    case 128: return launch<128, T>(Xq, Mq, Xk, Mk, nbr, table, order, counts, K, sms, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block (bytes), for the report of a run.
extern "C" int rbf_classed_forward_smem(int H, int low) {
  switch (H) {
    case 32: return (int)(low ? smem_bytes<32, bf16>() : smem_bytes<32, float>());
    case 64: return (int)(low ? smem_bytes<64, bf16>() : smem_bytes<64, float>());
    case 128: return (int)(low ? smem_bytes<128, bf16>() : smem_bytes<128, float>());
    default: return -1;
  }
}

// Mq [Nq, 18], Mk [Nk, 18] (query and key rows' masks, PERM order), nbr
// [E] -> code [E] (uint8): 0-3 the one group edge e feeds, 4 several.
extern "C" int rbf_classed_classify(const float* Mq, const float* Mk,
                                    const long long* nbr, long long E, int K,
                                    unsigned char* code, cudaStream_t stream) {
  if (K < 1 || E < 0) return (int)cudaErrorInvalidValue;
  if (E == 0) return 0;
  classify_kernel<<<(unsigned)((E + 255) / 256), 256, 0, stream>>>(Mq, Mk, nbr, E, K, code);
  return (int)cudaGetLastError();
}

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows, PERM order), Xk [Nk, 3*18],
// Mk [Nk, 18] (key rows), nbr [E] (key row of each edge; the query row of
// edge e is e / K); table [5184, H]: the four group tables, pair-major;
// order [E]: the edges sorted stably by their code, counts [5]: the edges of
// each code; sms: the SM count (the persistent grid holds as many blocks as
// fit on each); out [E, H].
extern "C" int rbf_classed_forward(const float* Xq, const float* Mq,
                                   const float* Xk, const float* Mk,
                                   const long long* nbr, int K, int H,
                                   const float* table, const long long* order,
                                   const long long* counts, int sms, float* out,
                                   cudaStream_t stream) {
  return forward<float>(Xq, Mq, Xk, Mk, nbr, K, H, table, order, counts, sms,
                        out, stream);
}

// The bf16 trunk's function: damped bf16 bins against the tables of
// bf16(W * fold scale); coordinates, masks and out fp32.
extern "C" int rbf_classed_forward_bf16(const float* Xq, const float* Mq,
                                        const float* Xk, const float* Mk,
                                        const long long* nbr, int K, int H,
                                        const bf16* table, const long long* order,
                                        const long long* counts, int sms,
                                        float* out, cudaStream_t stream) {
  return forward<bf16>(Xq, Mq, Xk, Mk, nbr, K, H, table, order, counts, sms,
                       out, stream);
}
