// The per-pair bins of the four RBF projection kernels: the classed forward
// (rbf_classed.cu, row 3) and the dense one (rbf_edge.cu, row 5), their
// weight gradients (rbf_classed_dw.cu, row 4; rbf_edge_dw.cu, row 6). All
// four run the tensor-core walks of rbf_tile.cuh and differ only in the kind
// of bin (BinKind) and in the caller's weight.
//
// Operands, in every one of them: query rows Xq [Nq, 3*18] (x|y|z planes)
// with atom masks Mq [Nq, 18], key rows Xk [Nk, 3*18] with masks Mk [Nk, 18],
// and for each edge e its key row nbr[e]; the query row of edge e is e / K.
// On one device the keys are the queries (Xk == Xq); on the graph-parallel
// route the queries are a shard's rows and the keys the all-gathered
// structure, so nothing here assumes the two come from one array.
//
// The exact bins are those of the plain version
// (models/features.py::all_pair_rbf): 16 Gaussians, mu = 2..22 A,
// sigma = 1.25, of the distance between query atom qa and key atom na,
// exactly 0 where either atom is absent. A dense and a class-split
// projection then agree, and every kernel computes a bin alike, so a
// backward recomputes what its forward used.
//
// The kinds:
//   kExact      the exact fp32 Gaussians (rows 3-6 at fp32);
//   kDamped     the classed bf16 branch's bins (rows 3, 4 at bf16; JAX
//               rbf_classed.py:259-303): bin r of a pair is
//               max(u_r, d_{R-1-r}), the damped two-sided geometric walk,
//               rounded to bf16, whose missing factor e^{c r (R-1-r)} the
//               weight rows carry (the fold scales);
//   kExactBf16  the dense bf16 branch's bins (rows 5, 6 at bf16; JAX
//               rbf_edge.py:63-78, :179-186): the exact Gaussian rounded to
//               bf16 (expf, not __expf: a bin within an fp32 ulp of a bf16
//               boundary must round as the plain version's does).
#pragma once
#include <cuda_runtime.h>

#include "precision.cuh"

namespace {

constexpr int kA = 18;   // augmented atom slots
constexpr int kR = 16;   // RBF bins

enum BinKind : int { kExact = 0, kDamped = 1, kExactBf16 = 2 };

__device__ __forceinline__ float bin_mu(int r) {
  return (float)(2.0 + r * (20.0 / (kR - 1)));
}

// The distance between query atom qa of row xq and key atom na of row xn
// (x|y|z planes of kA slots each), as the exact bins take it.
__device__ __forceinline__ float pair_distance(const float* xq,
                                               const float* xn, int qa,
                                               int na) {
  const float dx = xq[qa] - xn[na];
  const float dy = xq[kA + qa] - xn[kA + na];
  const float dz = xq[2 * kA + qa] - xn[2 * kA + na];
  return sqrtf(dx * dx + dy * dy + dz * dz + 1e-6f);
}

// The exact bin of centre mu at distance D.
__device__ __forceinline__ float gauss_bin(float D, float mu) {
  const float z = (D - mu) / 1.25f;
  return expf(-z * z);
}

// fp32 constants of the recursion, as the JAX package rounds them
// (sigma = 1.25, step = 20/15, c = step^2 / sigma^2, R = 16).
constexpr float kInvS2 = 0x1.47ae14p-1f;     // 1 / sigma^2
constexpr float kGen = 0x1.b4e81cp+0f;       // 2 step / sigma^2
constexpr float kDamp = 0x1.4caedep-25f;     // e^{-(R-1)c}
constexpr float kUndamp = 0x1.89fc0ep+24f;   // e^{(R-1)c}
constexpr float kTiny = 0x1.05563cp-126f;    // seeds below are flushed to 0
constexpr float kDistCap = 50.0f;

// The damped walk of the pair (query atom qa of row xq, key atom na of row
// xn): the fp32 operations of the JAX package's _bins_recursive in its
// order, with the distance rounded step by step (no contraction into FMAs),
// as the plain version computes them:
//   D = min(sqrt(dx^2 + dy^2 + dz^2 + 1e-6), 50), t0 = D - 2, t1 = D - 22,
//   f_lo = exp(-(t0 t0) / s^2), f_hi = exp(-(t1 t1) / s^2) (< kTiny: 0),
//   g = exp(kGen t0), up = g kDamp, down = kUndamp / g.
// Bin r is max(f_lo up^r, f_hi down^(R-1-r)), each power taken by repeated
// rounded multiplication. 3 exps and a division per pair.
struct DampedWalk {
  float f_lo, f_hi, up, down;
};

__device__ __forceinline__ DampedWalk damped_walk(const float* xq,
                                                  const float* xn, int qa,
                                                  int na) {
  const float dx = __fsub_rn(xq[qa], xn[na]);
  const float dy = __fsub_rn(xq[kA + qa], xn[kA + na]);
  const float dz = __fsub_rn(xq[2 * kA + qa], xn[2 * kA + na]);
  const float d2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz)),
                             1e-6f);
  const float D = fminf(sqrtf(d2), kDistCap);
  const float t0 = __fsub_rn(D, 2.0f), t1 = __fsub_rn(D, 22.0f);
  DampedWalk w;
  w.f_lo = expf(__fmul_rn(-__fmul_rn(t0, t0), kInvS2));
  w.f_hi = expf(__fmul_rn(-__fmul_rn(t1, t1), kInvS2));
  if (w.f_lo < kTiny) w.f_lo = 0.f;
  if (w.f_hi < kTiny) w.f_hi = 0.f;
  const float g = expf(__fmul_rn(kGen, t0));
  w.up = __fmul_rn(g, kDamp);
  w.down = __fdiv_rn(kUndamp, g);
  return w;
}

// All 16 bins of the pair (query atom qa of row xq, key atom na of row xn)
// of kind KIND, the distance or walk taken once. The caller handles absent
// atoms.
template <BinKind KIND>
__device__ __forceinline__ void pair_bins(const float* xq, const float* xn,
                                          int qa, int na, float (&b)[kR]) {
  if constexpr (KIND != kDamped) {
    const float D = pair_distance(xq, xn, qa, na);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float v = gauss_bin(D, bin_mu(r));
      b[r] = KIND == kExactBf16 ? rnd<bf16>(v) : v;
    }
  } else {
    const DampedWalk w = damped_walk(xq, xn, qa, na);
    float up = w.f_lo, down[kR];
    down[0] = w.f_hi;
#pragma unroll
    for (int m = 1; m < kR; ++m) down[m] = __fmul_rn(down[m - 1], w.down);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      b[r] = rnd<bf16>(fmaxf(up, down[kR - 1 - r]));
      up = __fmul_rn(up, w.up);
    }
  }
}

// dW[rowmap[row]][h] = sum_s part[s][row][h], s in order (deterministic:
// no atomics anywhere in a weight gradient).
__global__ void dw_reduce(const float* __restrict__ part, int splits,
                          const long long* __restrict__ rowmap, int rows,
                          int H, float* __restrict__ dW) {
  const size_t n = (size_t)rows * H;
  const size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int c = 0; c < splits; ++c) s += part[c * n + j];
  const size_t row = j / H, h = j % H;
  dW[(size_t)rowmap[row] * H + h] = s;
}

}  // namespace
