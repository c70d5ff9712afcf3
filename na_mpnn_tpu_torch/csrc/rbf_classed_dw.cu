// Weight gradient of the class-specialised RBF projection, for Hopper
// (sm_90a); fp32, and bf16 for the bf16 trunk.
//
// Replaces the TPU kernel na_mpnn_tpu/ops/rbf_classed.py::_classed_dw
// (_bwd_kernel, rbf_classed.py:394). For the cotangent g [E, H] of the
// projection out = bins @ W (rbf_classed.cu), dW[pair, r][h] =
// sum_e bins(e, pair, r) * g[e][h] with the forward's bins, each group
// table over the edges that feed it only (an edge's other groups hold
// absent atoms and add exact zeros).
//
// The product is rbf_tile.cuh's weight-gradient walk (rbf_dw_groups: per
// group list, 128 table rows x one of kSplit fixed edge ranges per block on
// the tensor cores, then dw_reduce sums the partials in order through the
// pair-major row map into the reference order; no atomics), with the exact
// fp32 bins in 3xTF32; the dense weight gradient (rbf_edge_dw.cu) runs the
// same instantiation at fp32.
//
// bf16 (rbf_classed_dw_bf16; the TPU kernel's bf16 branch,
// rbf_classed.py:407-415): the damped recursive bins of the bf16 forward
// rounded to bf16 (BinKind kDamped) and g rounded to bf16 on bf16 mma.sync;
// their products sum in fp32, and dW (the gradient of the fold-scaled
// weight) is fp32.
//
// What bounds it on the card: at fp32 the operations, 16*(2H+8) per present
// atom pair of every edge; at bf16 the bytes of g and the edge operands.
#include "rbf_tile.cuh"

// Xq [Nq, 3*18], Mq [Nq, 18] (query rows: x|y|z planes, PERM order),
// Xk [Nk, 3*18], Mk [Nk, 18] (key rows), nbr [E] (key row of each edge),
// g [E, H], lists [4, stride] (group g's edges, ascending, counts[g] of
// them), rowmap [5184] (kernel-order row -> reference row); scratch part
// [kSplit, 5184, H]; dW [5184, H]. H: 32, 64 or 128.
extern "C" int rbf_classed_dw(const float* Xq, const float* Mq,
                              const float* Xk, const float* Mk,
                              const long long* nbr, const float* g,
                              const long long* lists, const long long* counts,
                              long long stride, const long long* rowmap,
                              int K, int H, float* part, float* dW,
                              cudaStream_t stream) {
  return group_dw<kExact, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, g, lists, counts,
                                       stride, rowmap, K, H, part, dW, stream);
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
  return group_dw<kDamped, 32, 64, 128>(Xq, Mq, Xk, Mk, nbr, g, lists, counts,
                                        stride, rowmap, K, H, part, dW, stream);
}
