// Weight gradient of the dense RBF projection, for Hopper (sm_90a); fp32,
// and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_edge.py::rbf_edge_embed_dw
// (_bwd_kernel, rbf_edge.py:151). For the cotangent g [E, H] of the
// projection out = bins @ W (rbf_edge.cu), dW[(a*18 + b)*16 + r][h] =
// sum_e bin(e, a, b, r) * g[e][h], with the forward's bins, in the
// reference row order of W. The TPU kernel keeps the whole [5184, H] block
// in VMEM and adds every grid step into it; blocks on Hopper run in no
// order, so the sum goes through fixed-order partials instead.
//
// As the forward is the classed one's function, this is the classed weight
// gradient's walk (rbf_tile.cuh::rbf_dw_groups): each group table's rows
// over the edges that feed the group (ops/rbf_common.py::edge_group_lists),
// 128 rows x one of kSplit fixed edge ranges per block on the tensor cores,
// then dw_reduce adds the kSplit partials in order and writes each row
// through the pair-major row map into the reference order. No atomics: two
// identical launches agree bitwise. At fp32 it runs the exact bins in
// 3xTF32, the classed fp32 instantiation, whose result it equals bit for
// bit on the same operands.
//
// bf16 (rbf_edge_dw_bf16; the TPU kernel's bf16 branch, rbf_edge.py:179-186):
// the forward's exact bins rounded to bf16 (BinKind kExactBf16) and g
// rounded to bf16 on bf16 mma.sync; their products sum in fp32 into the
// fp32 dW.
//
// What bounds it on the card: at fp32 the operations, 16*(2H+8) per present
// atom pair of every edge (as the forward); at bf16 the bytes of g and the
// edge operands. Widths: 32, 64 and 128.
#include "rbf_tile.cuh"

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, PERM order),
// Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each edge),
// g [E, H], lists [4, stride] (group g's edges, ascending, counts[g] of
// them), rowmap [5184] (kernel-order row -> reference row); scratch part
// [kSplit, 5184, H]; dW [5184, H] in the reference row order.
extern "C" int rbf_edge_dw(const float* Xq, const float* Mq, const float* Xk,
                           const float* Mk, const long long* nbr,
                           const float* g, const long long* lists,
                           const long long* counts, long long stride,
                           const long long* rowmap, int K, int H, float* part,
                           float* dW, cudaStream_t stream) {
  return group_dw<kExact, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, g, lists, counts,
                                       stride, rowmap, K, H, part, dW, stream);
}

// The bf16 trunk's weight gradient (same operands, fp32 g and dW).
extern "C" int rbf_edge_dw_bf16(const float* Xq, const float* Mq,
                                const float* Xk, const float* Mk,
                                const long long* nbr, const float* g,
                                const long long* lists, const long long* counts,
                                long long stride, const long long* rowmap, int K,
                                int H, float* part, float* dW,
                                cudaStream_t stream) {
  return group_dw<kExactBf16, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, g, lists, counts,
                                           stride, rowmap, K, H, part, dW, stream);
}
