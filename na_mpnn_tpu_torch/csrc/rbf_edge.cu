// Dense all-pair-atom RBF edge features fused with their projection, for
// Hopper (sm_90a), rbf_mode="dense"; fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_edge.py::rbf_edge_embed
// (_kernel, rbf_edge.py:38). Per edge (query row i -> key row j): the
// distances between all 18 x 18 augmented atom pairs (a of i, b of j), 16
// Gaussian bins each, masked by atom presence on both ends (rbf_common.cuh),
// times the projection W [18*18*16, H] (the model's reference row order
// (a*18 + b)*16 + r; the TPU kernel's bin-major permutation serves its
// one-hot expansion matmuls and is not carried over).
//
// The function is the classed forward's (rbf_classed.cu): every atom pair
// outside the groups an edge feeds has an absent atom, so computing only
// those groups skips exact zeros. So this is rbf_tile.cuh's forward walk
// (rbf_fwd_groups) too: the caller permutes the atom slots (PERM), gives
// each edge its list with rbf_classed.cu's classify kernel, sorts the
// lists (ops/rbf_common.py::edge_tile_order) and permutes W into the four
// pair-major group tables (_pair_row_map). At fp32 the walk runs the exact
// bins in 3xTF32, the instantiation of the classed fp32 forward, whose
// output it equals bit for bit on the same operands.
//
// bf16 (rbf_edge_forward_bf16; the TPU kernel's bf16 branch,
// rbf_edge.py:63-78): each masked exact bin rounded to bf16 (BinKind
// kExactBf16; the damped bins belong to the classed bf16 branch only)
// against bf16(W) with no fold scale, on bf16 mma.sync, summed in fp32 into
// the fp32 output.
//
// What bounds it on the card: at fp32 the operations, 16*(2H+8) per present
// atom pair of every edge (the walk skips the absent pairs outside an
// edge's groups; those inside it multiplies as zeros); at bf16 the bytes
// (coordinates, masks, neighbours and the fp32 [E, H] output).
// Widths: every multiple of 32 up to 256 (above 128 at fp32 the walk takes
// chunks of 4 atom pairs, so two stages of the table fit in shared memory);
// the wrapper refuses any other.
#include "rbf_tile.cuh"

#define RBF_EDGE_WIDTHS 32, 64, 96, 128, 160, 192, 224, 256

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows, PERM order), Xk [Nk, 3*18],
// Mk [Nk, 18] (key rows), nbr [E] (key row of each edge; the query row of
// edge e is e / K); table [5184, H]: W's rows in the four pair-major group
// tables; order [E], counts [5]: the edges sorted stably by their list
// (rbf_classed_classify), the edges of each list; sms: the SM count;
// out [E, H].
extern "C" int rbf_edge_forward(const float* Xq, const float* Mq,
                                const float* Xk, const float* Mk,
                                const long long* nbr, int K, int H,
                                const float* table, const long long* order,
                                const long long* counts, int sms, float* out,
                                cudaStream_t stream) {
  return group_forward<kExact, RBF_EDGE_WIDTHS>(Xq, Mq, Xk, Mk, nbr, K, H, table,
                                                order, counts, sms, out, stream);
}

// The bf16 trunk's function: bf16-rounded exact bins against the tables of
// bf16(W); coordinates, masks and out fp32.
extern "C" int rbf_edge_forward_bf16(const float* Xq, const float* Mq,
                                     const float* Xk, const float* Mk,
                                     const long long* nbr, int K, int H,
                                     const bf16* table, const long long* order,
                                     const long long* counts, int sms,
                                     float* out, cudaStream_t stream) {
  return group_forward<kExactBf16, RBF_EDGE_WIDTHS>(Xq, Mq, Xk, Mk, nbr, K, H, table,
                                                    order, counts, sms, out, stream);
}
