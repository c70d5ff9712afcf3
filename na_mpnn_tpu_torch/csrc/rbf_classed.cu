// Polymer-class-specialised RBF edge features fused with their projection,
// for Hopper (sm_90a); fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_fwd
// (_fwd_kernel, rbf_classed.py:361). Per edge (i -> j): the distances between
// the 18 augmented atoms of i and of j, 16 Gaussian bins each
// (mu = 2..22 A, sigma = 1.25), exactly 0 where either atom is absent, times
// the [18*18*16, H] projection, computed over the atom-pair groups the edge
// feeds. The neighbour rows are a gathered operand (Xk, Mk, indexed by nbr):
// the query/key entry rbf_edge_features_classed_qk (rbf_classed.py:600),
// with a shard's query rows against the all-gathered structure, is the same
// launch.
//
// The product is rbf_tile.cuh's forward walk (rbf_fwd_groups: per-edge
// lists, tiles of 64 listed edges over the pair-major group tables, one
// store per output row, no atomics) with the exact fp32 bins in 3xTF32
// (the JAX fp32 path's Precision.HIGHEST, rbf_classed.py:328-330); the
// dense forward (rbf_edge.cu) runs the same instantiation at fp32. The
// classify kernel below gives each edge its list for both.
//
// bf16 (rbf_classed_forward_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:315-321, :376): the damped recursive bins rounded to bf16
// (BinKind kDamped) against tables of bf16(W * fold scale) on bf16
// mma.sync, summed in fp32 into the fp32 output. The exact fp32 pair
// distances replace the TPU's bf16x2 coordinate selection. The weight
// gradient (rbf_classed_dw.cu) recomputes every bin bitwise.
//
// What bounds it on the card: at fp32 the operations (16*(2H+8) per present
// atom pair of every edge), at bf16 the bytes (coordinates, masks,
// neighbours and the fp32 [E, H] output).
#include "rbf_tile.cuh"

namespace {

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

}  // namespace

// Dynamic shared memory of one block (bytes), for the report of a run.
extern "C" int rbf_classed_forward_smem(int H, int low) {
  return low ? group_forward_smem<kDamped, 32, 64, 128>(H)
             : group_forward_smem<kExact, 32, 64, 128>(H);
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
// fit on each); out [E, H]. H: 32, 64 or 128.
extern "C" int rbf_classed_forward(const float* Xq, const float* Mq,
                                   const float* Xk, const float* Mk,
                                   const long long* nbr, int K, int H,
                                   const float* table, const long long* order,
                                   const long long* counts, int sms, float* out,
                                   cudaStream_t stream) {
  return group_forward<kExact, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, K, H, table,
                                            order, counts, sms, out, stream);
}

// The bf16 trunk's function: damped bf16 bins against the tables of
// bf16(W * fold scale); coordinates, masks and out fp32.
extern "C" int rbf_classed_forward_bf16(const float* Xq, const float* Mq,
                                        const float* Xk, const float* Mk,
                                        const long long* nbr, int K, int H,
                                        const bf16* table, const long long* order,
                                        const long long* counts, int sms,
                                        float* out, cudaStream_t stream) {
  return group_forward<kDamped, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, K, H, table,
                                             order, counts, sms, out, stream);
}
